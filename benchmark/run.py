"""Run one cell of ``BENCHMARK.json`` once, on the card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's progress and the card's power limit on standard error,
each number that decides ``correct`` beside its limit as the last lines
there, and one JSON object as the last line of standard output.  Exits
with another code than 0, and prints no result, where CUDA is absent or
holds fewer cards than the cell asks for, where the cell's files or the
program are missing, and where the process has loaded JAX or the JAX
package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that prints
# the result, compared whole (the port's own name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "ldagibbssampling_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e.__class__.__name__})"
    return f"card (nvidia-smi name, power.limit): {out}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: this benchmark runs on the card only")
        return 2
    from benchmark import check, spec

    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards; "
            f"{torch.cuda.device_count()} visible")
        return 2
    driver = spec.driver(cell.traffic)
    result = driver.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=torch.device("cuda", 0),
                        t_start=T_START, log=log)
    log(card_line())
    bad = forbidden_loaded()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
