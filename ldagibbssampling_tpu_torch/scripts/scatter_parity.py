"""CVB0's scatter against another checkout's on the card: bitwise parity
and time.

    python -m ldagibbssampling_tpu_torch.scripts.scatter_parity --parent DIR [--rounds N]

``DIR`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive``).  The shapes are
``chip_smoke.py``'s ``[kernels] cvb0_scatter``: rung 5 at 0.2 (K = 15,
block 8,192), bench.py's corpus (T = 2^20 Zipf(1.1) tokens, V = 50,000,
M = 4,096, K = 500, block 65,536), each by document (``ndk``) and by word
(``nwk``), and one word filling a block of 65,536 at K = 500 (then a
padded block).  The ids, a table and a block of rows per shape are made
once and saved; then each side runs in a process of its own, in the order
other, this, this, other (``--rounds`` times over), each importing the
package of its own checkout and building its own plan: the scatter of the
first and the last block, whose tables must hash the same in every run,
and the first block's time per launch, the mean over ``REPS`` calls (CUDA
events over the wrapper, and the profiler's device time); per side their
mean, least and most over its runs.  Prints one JSON line; exits 1 on a
difference.  ``compare`` is the same from Python (``chip_smoke.py
--scatter-parent DIR``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
REPS = 50


def make_inputs(path: Path, seed: int) -> None:
    """Every shape's ids, table and rows, saved for both sides (this
    checkout's package builds the corpora)."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus

    rng = np.random.default_rng(seed)
    t, v, m = 1 << 20, 50_000, 4_096
    words = (rng.zipf(1.1, size=t).astype(np.int64) - 1) % v
    docs = np.arange(t, dtype=np.int64) * m // t
    rung5, _ = rung_corpus(5, 0.2)
    r5 = rung5.pad_to(8_192)
    one = np.concatenate([np.full(65_536, 7), np.full(60_536, 7), np.zeros(5_000, np.int64)])
    shapes = {}
    for label, ids, n_rows, k, block in (
            ("rung5 ndk", r5.token_doc, r5.num_docs, 15, 8_192),
            ("rung5 nwk", r5.token_word, r5.vocab_size, 15, 8_192),
            ("bench ndk", docs, m, 500, 65_536),
            ("bench nwk", words, v, 500, 65_536),
            ("one_word nwk", one, 8, 500, 65_536)):
        shapes[label] = dict(
            ids=torch.from_numpy(np.asarray(ids, np.int64)), block=block,
            table=torch.from_numpy(rng.uniform(0, 2, size=(n_rows, k)).astype(np.float32)),
            rows=torch.from_numpy((rng.random((block, k), dtype=np.float32) - 0.5)))
    torch.save(shapes, path)


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:24]


def _this_tracing():
    """This checkout's ``evaluation/tracing.py`` (torch only), whichever
    package the side imports."""
    spec = importlib.util.spec_from_file_location(
        "_scatter_parity_tracing",
        REPO / "ldagibbssampling_tpu_torch" / "evaluation" / "tracing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_side(root: Path, inputs: Path, out: Path) -> None:
    """One side: the package of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    pkg = Path(cs.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    device_ms = _this_tracing().kernel_device_ms
    res = {"package": str(pkg), "hashes": {}, "ms": {}, "device_ms": {}}
    for label, s in torch.load(inputs).items():
        plan = cs.scatter_plan(s["ids"].numpy(), s["block"], "cuda")
        table, rows = s["table"].cuda(), s["rows"].cuda()
        for b in (0, plan.num_blocks - 1):
            got = table.clone()
            cs.cvb0_scatter(got, rows, plan, b)
            torch.cuda.synchronize()
            res["hashes"][f"{label}/{b}"] = _digest(got)
        work = table.clone()

        def fn(work=work, rows=rows, plan=plan):
            cs.cvb0_scatter(work, rows, plan, 0)
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        res["ms"][label] = start.elapsed_time(end) / REPS
        res["device_ms"][label] = device_ms(fn, "cvb0_scatter", REPS)
    out.write_text(json.dumps(res))


def compare(parent: Path, seed: int = 0, rounds: int = 1) -> dict:
    """Both sides in turns (other, this, this, other) ``rounds`` times: the
    report ``main`` prints."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sides = {"other": parent.resolve(), "this": REPO}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        make_inputs(inputs, seed)
        runs = []
        for i, side in enumerate(("other", "this", "this", "other") * rounds):
            out = Path(tmp) / f"{i}_{side}.json"
            subprocess.run([sys.executable, str(HERE), "--side", str(sides[side]),
                            "--inputs", str(inputs), "--out", str(out)],
                           check=True, timeout=900, cwd=tmp)
            runs.append((side, json.loads(out.read_text())))
    ref = runs[0][1]["hashes"]
    differ = sorted({key for _, r in runs for key, h in r["hashes"].items()
                     if h != ref[key]})

    def spread(side, key, label):
        vals = [r[key][label] for s, r in runs if s == side]
        if None in vals:
            return None
        return {"mean": sum(vals) / len(vals), "min": min(vals), "max": max(vals)}

    labels = list(runs[0][1]["ms"])
    return {
        "device": smi, "equal": not differ, "differ": differ, "cases": len(ref),
        "ms": {side: {x: spread(side, "ms", x) for x in labels} for side in sides},
        "device_ms": {side: {x: spread(side, "device_ms", x) for x in labels}
                      for side in sides},
        "by_run": [(s, r["ms"], r["device_ms"]) for s, r in runs],
        "packages": [r["package"] for _, r in runs]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over the order other, this, this, other")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side is not None:
        run_side(args.side, args.inputs, args.out)
        return 0
    if args.parent is None or not (args.parent / "ldagibbssampling_tpu_torch").is_dir():
        ap.error("--parent must be the root of a checkout of this repository")
    import torch

    if not torch.cuda.is_available():
        print("scatter_parity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    res = compare(args.parent, args.seed, args.rounds)
    print(json.dumps(res), flush=True)
    return 0 if res["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
