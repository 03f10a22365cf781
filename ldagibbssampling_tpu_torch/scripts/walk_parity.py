"""K1's walk against another checkout's on the card: bitwise parity and time.

    python -m ldagibbssampling_tpu_torch.scripts.walk_parity --parent DIR

``DIR`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive``).  The block is
``chip_smoke.py``'s: the first 65,536 tokens of the deferred layout of
bench.py's corpus (T = 2^20 Zipf(1.1) tokens, V = 50,000, M = 4,096,
K = 500, row tile 512), its state from ``init_state`` on the card.  It is
made once and saved; then each side runs in a process of its own, in the
order other, this, this, other, each importing the package of its own
checkout: every K1 instantiation (the six deferred (chain, snapshot)
settings and the live int32 table) in the three noise modes from the same
state, and the time of the whole walk (draw and count move per tile,
internal noise) per block, by events and in device time (``torch.profiler``;
events time the wrapper's host work too where a walk is shorter).  Then
the same block at K = 100 (``chip_smoke``'s
``K_GENERAL``: row tile 2,048, the tiles of the deferred tier and the mesh
runtimes' deferred shards at K <= 128, which the tagged walk takes with
four of a tile's records folded a thread, an older checkout with one or two
grid barriers a tile; its state from ``init_state`` at
K = 100): the f32 chain on the bf16 snapshot in the three noise modes, and
its time.  For each walk also its fixed cost: the same walk with every
token masked, in device time per tile (``torch.profiler``), as chip_smoke
reports it.
``--rounds`` repeats the four runs (other, this, this, other) that many
times, for the spread of each side's times.  Every run's ``z``, ``ndk`` and
``nk`` must hash the same as every other's.  Prints one JSON line; exits 1
on a difference.
"""

from __future__ import annotations

import argparse
import hashlib
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
# (counter name, chain, rows): the seven instantiations of K1's walk
SETTINGS = (
    ("gibbs_tile_sample", "float32", "bfloat16"),
    ("gibbs_tile_sample_bf16", "bfloat16", "bfloat16"),
    ("gibbs_tile_sample_bf16p", "bf16p", "bfloat16"),
    ("gibbs_tile_sample_f32rows", "float32", "float32"),
    ("gibbs_tile_sample_bf16_f32rows", "bfloat16", "float32"),
    ("gibbs_tile_sample_bf16p_f32rows", "bf16p", "float32"),
    ("gibbs_tile_sample_live", "float32", "int32"),
)
# the K = 100 block: row tile 2,048
K_GENERAL = 100
REPS = 20


def make_inputs(path: Path, seed: int) -> None:
    """The block and its state, saved for both sides (this checkout's
    package builds them)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops import count_kernel as ck
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.1, size=T).astype(np.int64) - 1) % V).astype(np.int32)
    td = (np.arange(T, dtype=np.int64) * M // T).astype(np.int32)
    plan = ck.plan_deferred(tw, td, V, BLOCK)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K, seed=seed,
                    device="cuda")
    k_pad = -(-K // 128) * 128
    nwk_pad = F.pad(st.nwk, (0, k_pad - K, 0, plan.v_pad - V)).contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed)
    blk = slice(0, BLOCK)
    st100 = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                       num_docs=M, vocab_size=V, num_topics=K_GENERAL, seed=seed,
                       device="cuda")
    k100_pad = -(-K_GENERAL // 128) * 128
    nwk100 = F.pad(st100.nwk, (0, k100_pad - K_GENERAL, 0, plan.v_pad - V)).contiguous()
    torch.save({
        "k100_bfloat16": ck.cast_mirror_plain(nwk100).cpu(),
        "k100_ndk": st100.ndk.cpu(), "k100_nk": st100.nk.cpu(),
        "k100_z": st100.z[blk].cpu(),
        "k100_uniforms": (torch.rand((BLOCK, k100_pad), generator=g, device="cuda")
                          * (1 - 2e-7) + 1e-7).cpu(),
        "k100_row_tile": _pick_row_tile(BLOCK, K_GENERAL),
        "bfloat16": ck.cast_mirror_plain(nwk_pad).cpu(),
        "float32": nwk_pad.float().cpu(), "int32": st.nwk.cpu(),
        "ndk": st.ndk.cpu(), "nk": st.nk.cpu(), "z": st.z[blk].cpu(),
        **{n: torch.from_numpy(np.array(a[blk], np.int32)) for n, a in (
            ("w", plan.token_word), ("d", plan.token_doc), ("m", plan.token_mask))},
        "uniforms": (torch.rand((BLOCK, k_pad), generator=g, device="cuda")
                     * (1 - 2e-7) + 1e-7).cpu(),
        "row_tile": _pick_row_tile(BLOCK, K),
        "vbeta": float(np.float32(V) * np.float32(BETA)),
    }, path)


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:24]


def run_side(root: Path, inputs: Path, out: Path) -> None:
    """One side: the package of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from ldagibbssampling_tpu_torch.evaluation.tracing import kernel_device_ms
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

    pkg = Path(fk.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    inp = {k: v.cuda() if torch.is_tensor(v) else v
           for k, v in torch.load(inputs).items()}
    toks = (inp["w"], inp["d"], inp["m"])
    res = {"package": str(pkg), "hashes": {}, "walk_ms": {}, "moved": {},
           "walk_device_ms": {}, "fixed_us_per_tile": {}}
    # a K1 that reads its scalars and seed from the device takes them as
    # tensors made once; an earlier checkout's takes them by value
    if "scalars" in inspect.signature(fk.gibbs_tiles).parameters:
        import numpy as np

        from ldagibbssampling_tpu_torch.ops._device import (
            device_values, seed_word, sweep_scalars)

        scalars = device_values(sweep_scalars(ALPHA, BETA, V, K), "cuda")
        keys = {s: device_values(np.array([seed_word(s)], np.int64), "cuda")
                for s in (1234, 7)}
        scalars100 = device_values(sweep_scalars(ALPHA, BETA, V, K_GENERAL), "cuda")

        def values(seed, pre=""):
            return dict(scalars=scalars100 if pre else scalars, key=keys[seed])
    else:
        def values(seed, pre=""):
            return dict(alpha=ALPHA, beta=BETA, vbeta=inp["vbeta"], seed=seed)

    for name, chain, rows, pre in (*((*x, "") for x in SETTINGS),
                                   ("gibbs_tile_sample_k100", "float32", "bfloat16",
                                    "k100_")):
        ndk, nk = inp[pre + "ndk"].clone(), inp[pre + "nk"].clone()

        def walk(mode, seed, chain=chain, rows=rows, pre=pre, ndk=ndk, nk=nk):
            ndk.copy_(inp[pre + "ndk"])
            nk.copy_(inp[pre + "nk"])
            return fk.gibbs_tiles(
                inp[pre + rows], ndk, nk, inp[pre + "z"], *toks, noise_mode=mode,
                uniforms=inp[pre + "uniforms"], compute_dtype=chain,
                row_tile=inp[pre + "row_tile"], **values(seed, pre))

        for mode in MODES:
            z = walk(mode, 1234)
            torch.cuda.synchronize()
            res["hashes"][f"{name}/{mode}"] = [_digest(x) for x in (z, ndk, nk)]
            res["moved"][f"{name}/{mode}"] = int(
                ((z != inp[pre + "z"]) & (inp["m"] > 0)).sum())
        times = []
        for fn in (lambda: walk("internal", 7),
                   lambda: (ndk.copy_(inp[pre + "ndk"]), nk.copy_(inp[pre + "nk"]))):
            fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / REPS)
        res["walk_ms"][name] = times[0] - times[1]  # less the state's reset
        res["walk_device_ms"][name] = kernel_device_ms(lambda: walk("internal", 7),
                                                       "gibbs_walk")
        masked = torch.zeros_like(inp["m"])
        fixed_ms = kernel_device_ms(lambda: fk.gibbs_tiles(
            inp[pre + rows], ndk, nk, inp[pre + "z"], inp["w"], inp["d"], masked,
            noise_mode="internal", compute_dtype=chain,
            row_tile=inp[pre + "row_tile"], **values(7, pre)), "gibbs_walk")
        res["fixed_us_per_tile"][name] = (
            None if fixed_ms is None
            else fixed_ms * 1e3 * inp[pre + "row_tile"] / inp["m"].shape[0])
    out.write_text(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run other, this, this, other")
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
        print("walk_parity: needs an NVIDIA GPU", file=sys.stderr)
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
        for i, side in enumerate(("other", "this", "this", "other") * args.rounds):
            out = Path(tmp) / f"{i}_{side}.json"
            subprocess.run([sys.executable, str(HERE), "--side", str(sides[side]),
                            "--inputs", str(inputs), "--out", str(out)],
                           check=True, timeout=900, cwd=tmp)
            runs.append((side, json.loads(out.read_text())))
    ref = runs[0][1]["hashes"]
    differ = sorted({key for _, r in runs for key, h in r["hashes"].items()
                     if h != ref[key]})
    names = list(runs[0][1]["walk_ms"])
    walk_ms = {side: {name: [r["walk_ms"][name] for s, r in runs if s == side]
                      for name in names} for side in sides}
    fixed = {side: {name: [r["fixed_us_per_tile"][name] for s, r in runs
                           if s == side] for name in names} for side in sides}
    device = {side: {name: [r["walk_device_ms"][name] for s, r in runs
                            if s == side] for name in names} for side in sides}
    print(json.dumps({
        "device": smi, "equal": not differ, "differ": differ,
        "cases": len(ref), "moved": runs[1][1]["moved"],
        "walk_ms_per_block": {side: {n: sum(x) / len(x) for n, x in by.items()}
                              for side, by in walk_ms.items()},
        "walk_ms_spread": {side: {n: [min(x), max(x)] for n, x in by.items()}
                           for side, by in walk_ms.items()},
        "walk_ms_by_run": [(s, r["walk_ms"]) for s, r in runs],
        "walk_device_ms": device,
        "fixed_us_per_tile": fixed,
        "packages": [r["package"] for _, r in runs]}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
