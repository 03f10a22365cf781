"""K3 and the count move against another checkout's on the card: bitwise
parity and time.

    python -m ldagibbssampling_tpu_torch.scripts.block_parity --parent DIR [--rounds N]

``DIR`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive``).  The block is
``chip_smoke.py``'s for K3: the first 65,536 tokens of the v1-draw tier's
layout (``pad_to`` + ``sort_within_blocks``, word-sorted) of bench.py's
corpus (T = 2^20 Zipf(1.1) tokens, V = 50,000, M = 4,096, K = 500), its
state from ``init_state`` on the card.  It is made once and saved; then
each side runs in a process of its own, in the order other, this, this,
other (``--rounds`` times over), each importing the package of its own
checkout: K3 in the three
noise modes, then from each mode's draw the count move of ``nwk`` alone
(the fused tier's form) and of all three tables (the v1-draw tier's).
Every run's ``z`` and tables must hash the same as every other's.  Times,
per block and per launch, each the mean over ``REPS`` calls: K3 in internal
noise (CUDA events over the wrapper and the profiler's device time) and both
moves (the same two); per side their mean, least and most over its runs.
Prints one JSON line; exits 1 on a difference.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
T, V, M, K = 1 << 20, 50_000, 4_096, 500
BLOCK, ALPHA, BETA = 65_536, 0.5, 0.1
MODES = ("deterministic", "external", "internal")
MOVES = {"move_nwk": ("nwk",), "move_three": ("nwk", "ndk", "nk")}
REPS = 100


def make_inputs(path: Path, seed: int) -> None:
    """The block and its state, saved for both sides (this checkout's
    package builds them)."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu_torch.models.state import init_state

    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.1, size=T).astype(np.int64) - 1) % V).astype(np.int32)
    td = (np.arange(T, dtype=np.int64) * M // T).astype(np.int32)
    doc_ptr = np.zeros(M + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=M), out=doc_ptr[1:])
    pc, _ = FlatCorpus(tw, td, doc_ptr, V).pad_to(BLOCK).sort_within_blocks(BLOCK)
    st = init_state(pc.token_word, pc.token_doc, pc.token_mask, num_docs=M,
                    vocab_size=V, num_topics=K, seed=seed + 1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    blk = slice(0, BLOCK)
    torch.save({
        "nwk": st.nwk.cpu(), "ndk": st.ndk.cpu(), "nk": st.nk.cpu(),
        "z": st.z[blk].cpu(),
        **{n: torch.from_numpy(np.array(a[blk], np.int32)) for n, a in (
            ("w", pc.token_word), ("d", pc.token_doc), ("m", pc.token_mask))},
        "uniforms": (torch.rand((BLOCK, K), generator=g, device="cuda")
                     * (1 - 2e-7) + 1e-7).cpu(),
        "vbeta": float(np.float32(V) * np.float32(BETA)),
    }, path)


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:24]


def _this_tracing():
    """This checkout's ``evaluation/tracing.py`` (torch only), whichever
    package the side imports."""
    spec = importlib.util.spec_from_file_location(
        "_block_parity_tracing",
        REPO / "ldagibbssampling_tpu_torch" / "evaluation" / "tracing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_side(root: Path, inputs: Path, out: Path) -> None:
    """One side: the package of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops import sample_kernel as sk

    pkg = Path(sk.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    device_ms = _this_tracing().kernel_device_ms
    inp = {k: v.cuda() if torch.is_tensor(v) else v
           for k, v in torch.load(inputs).items()}
    hyper = dict(alpha=ALPHA, beta=BETA, vbeta=inp["vbeta"])
    z, w, d, m = inp["z"], inp["w"], inp["d"], inp["m"]
    ids = {"nwk": ("token_word", w), "ndk": ("token_doc", d), "nk": (None, None)}
    res = {"package": str(pkg), "hashes": {}, "moved": {}, "ms": {}, "device_ms": {}}

    # a K3 that reads its scalars and seed from the device takes them as
    # tensors made once; an earlier checkout's takes them by value
    tensors = "scalars" in inspect.signature(sk.sample_block).parameters
    if tensors:
        from ldagibbssampling_tpu_torch.ops._device import (
            device_values, seed_word, sweep_scalars)

        scalars = device_values(sweep_scalars(ALPHA, BETA, V, K), "cuda")
        keys = {s: device_values(np.array([seed_word(s)], np.int64), "cuda")
                for s in (4321, 7)}

    def draw(mode, seed=4321):
        if tensors:
            return sk.sample_block(inp["nwk"], inp["ndk"], inp["nk"], z, w, d,
                                   noise_mode=mode, scalars=scalars, key=keys[seed],
                                   uniforms=inp["uniforms"])
        return sk.sample_block(inp["nwk"], inp["ndk"], inp["nk"], z, w, d,
                               noise_mode=mode, seed=seed, uniforms=inp["uniforms"],
                               **hyper)

    def move(z_new, names, tables=None):
        tables = tables or {n: inp[n].clone() for n in names}
        kw = {ids[n][0]: ids[n][1] for n in names if ids[n][0]}
        fk.count_move(z, z_new, m, **kw, **tables)
        return tables

    for mode in MODES:
        zk = draw(mode)
        z_new = torch.where(m > 0, zk, z)
        res["hashes"][f"K3/{mode}"] = [_digest(zk)]
        res["moved"][f"K3/{mode}"] = int(((z_new != z) & (m > 0)).sum())
        for label, names in MOVES.items():
            tables = move(z_new, names)
            torch.cuda.synchronize()
            res["hashes"][f"{label}/{mode}"] = [_digest(tables[n]) for n in names]

    z_new = torch.where(m > 0, draw("internal", 7), z)
    timed = {"gibbs_block_sample": (lambda: draw("internal", 7), "gibbs_block_sample")}
    for label, names in MOVES.items():
        tables = {n: inp[n].clone() for n in names}
        timed[label] = (lambda names=names, tables=tables: move(z_new, names, tables),
                        "gibbs_tile_update")
    for label, (fn, kernel) in timed.items():
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        res["ms"][label] = start.elapsed_time(end) / REPS
        res["device_ms"][label] = device_ms(fn, kernel, REPS)
    out.write_text(json.dumps(res))


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
        print("block_parity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    sides = {"other": args.parent.resolve(), "this": REPO}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        make_inputs(inputs, args.seed)
        runs = []
        order = ("other", "this", "this", "other") * args.rounds
        for i, side in enumerate(order):
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

    labels = ("gibbs_block_sample", *MOVES)
    print(json.dumps({
        "device": smi, "equal": not differ, "differ": differ,
        "cases": len(ref), "moved": runs[1][1]["moved"],
        "ms": {side: {x: spread(side, "ms", x) for x in labels} for side in sides},
        "device_ms": {side: {x: spread(side, "device_ms", x) for x in labels}
                      for side in sides},
        "by_run": [(s, r["ms"], r["device_ms"]) for s, r in runs],
        "packages": [r["package"] for _, r in runs]}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
