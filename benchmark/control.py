"""The readings that a cell's limits are set from, many seeds in one
process: the program as the configuration states it (the lower reading),
the program's own lower-precision chain in its place (the control), or the
program with a fault planted under the timed path.  The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        [--chain bfloat16] [--fault unchanged] [--sweeps 3] [--out file.jsonl]

Each seed gets its own corpus and model, ``--sweeps`` sweeps after set-up
and the judged sweep, and the numbers of
``benchmark/limits/<workload>.json``; one JSON line a seed on standard
output (and appended to ``--out``).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--chain", default=None, help="kernel_compute_dtype in the program's place")
    p.add_argument("--fault", default=None)
    p.add_argument("--sweeps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, spec

    cell = spec.load_cell(args.workload)
    driver = spec.driver(cell.traffic)
    overrides = {"kernel_compute_dtype": args.chain} if args.chain else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = faults.planted(args.fault) if args.fault else contextlib.nullcontext()
        with ctx:
            run = driver.build(cell, seed, args.device, overrides)
            driver.window(run, sweeps=args.sweeps)
            z_prev = driver.judged_sweep(run)
        values, _ = driver.judge(cell, run, seed, z_prev)
        del run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "chain": args.chain or cell.config["kernel_compute_dtype"],
                           "fault": args.fault, "values": values,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
