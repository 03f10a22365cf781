#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldagibbssampling_tpu_torch``) on
one NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero and nothing is caught and turned into
success:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every kernel source under ``ldagibbssampling_tpu_torch/
   csrc`` with nvcc for sm_90a, one process per source, all at once;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: K1 (draw + count update) walked over one block of 65,536
   tokens in the deterministic (must be equal), external and internal noise
   modes (z equal on >= 99.99% of tokens, differences printed); K2 (rebuild
   + bf16 snapshot) over the whole stream (bitwise equal).  Times each kernel,
   its plain version and, where one exists, a single PyTorch library call;
4. main path: ``make_backend`` -> ``LdaModel`` -> ``run_inference`` for 10
   sweeps at bench.py's shape (T = 2^20 Zipf(1.1) tokens, V = 50,000,
   M = 4,096 documents, K = 500, block 65,536, alpha 0.5, beta 0.1), then
   ``check_counts_consistent``; every kernel must have launched and no plain
   version may have run; prints tokens/s; then profiles one more sweep
   with the port's ``trace`` (device time by kernel, busy share);
5. CLI: the port's CLI on the generated minicorpus must write the five
   reference artifacts.

Then it prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

Bounds (``bound_ms``) use the published H100 SXM peaks: 3.35 TB/s of HBM and
67 TFLOP/s of float32 outside the tensor cores, with the bytes and
operations of this run's own inputs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "ldagibbssampling_tpu_torch"

T, V, M, K = 1 << 20, 50_000, 4_096, 500
BLOCK, ALPHA, BETA, SWEEPS = 65_536, 0.5, 0.1, 10
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per (token, padded topic) of the internal-noise draw, counted
# from the kernel source: Philox4x32-10 ~25 integer ops per topic, uniform 3,
# log ~10, bf16 reciprocal ~10, the conditional ~10, its nk reciprocal ~13,
# score and argmax ~4 (all charged at the float32 rate)
SAMPLE_OPS_PER_ELEM = 75
MIN_MATCH = 0.9999


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def synth_corpus(seed: int):
    """bench.py's corpus: Zipf(1.1) word ids truncated to V, equal docs."""
    import numpy as np

    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.1, size=T).astype(np.int64) - 1) % V).astype(np.int32)
    td = (np.arange(T, dtype=np.int64) * M // T).astype(np.int32)
    doc_ptr = np.zeros(M + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=M), out=doc_ptr[1:])
    return FlatCorpus(tw, td, doc_ptr, V)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events, after
    one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(corpus, seed: int, device: str = "cuda") -> dict:
    """Phase 3: every kernel against its plain version, and their times."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops import count_kernel as ck
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

    dev = torch.device(device)
    t0 = time.perf_counter()
    plan = ck.plan_deferred(corpus.token_word, corpus.token_doc, V, BLOCK)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K, seed=seed,
                    device=dev)
    log(f"[kernels] plan + init {time.perf_counter() - t0:.2f}s: "
        f"T_pad={plan.num_tokens} v_pad={plan.v_pad}")
    k_pad, v_pad = 512, plan.v_pad
    row_tile = _pick_row_tile(BLOCK, K)
    vbeta = float(np.float32(V) * np.float32(BETA))
    hyper = dict(alpha=ALPHA, beta=BETA, vbeta=vbeta, row_tile=row_tile)

    def on_dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    tw, td, tm = (on_dev(a) for a in (plan.token_word, plan.token_doc,
                                      plan.token_mask))
    blk = slice(0, BLOCK)
    w, d, m, z = tw[blk], td[blk], tm[blk], st.z[blk].contiguous()
    real = m > 0
    n_real = int(real.sum())
    out: dict = {}

    # --- K2 cast_mirror (also makes the snapshot K1 reads)
    nwk_pad = F.pad(st.nwk, (0, k_pad - K, 0, v_pad - V)).contiguous()
    mirror = ck.cast_mirror(nwk_pad)
    mirror_p = ck.cast_mirror_plain(nwk_pad)
    torch.cuda.synchronize()
    err = float((mirror.float() - mirror_p.float()).abs().max())
    if not torch.equal(mirror, mirror_p):
        raise AssertionError(f"cast_mirror differs from its plain version: {err}")
    out["cast_mirror"] = dict(max_abs_err=err)

    # --- K1 walked over one block, per noise mode
    g = torch.Generator(device=dev).manual_seed(seed)
    uniforms = torch.rand((BLOCK, k_pad), generator=g, device=dev) * (1 - 2e-7) + 1e-7
    for mode in ("deterministic", "external", "internal"):
        res = []
        for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
            ndk, nk = st.ndk.clone(), st.nk.clone()
            zn = walk(mirror, ndk, nk, z, w, d, m, noise_mode=mode,
                      seed=seed + 1234, uniforms=uniforms, **hyper)
            torch.cuda.synchronize()
            res.append((zn, ndk, nk))
        (zk, ndk_k, nk_k), (zp, ndk_p, nk_p) = res
        diff = ((zk != zp) & real).nonzero().flatten()
        match = 1.0 - diff.numel() / n_real
        moved = float(((zk != z) & real).float().mean())
        log(f"[kernels] K1 {mode}: z equal on {match:.6f} of {n_real} tokens, "
            f"{moved:.3f} of tokens moved")
        for i in diff[:20].tolist():
            log(f"  token {i}: kernel z={int(zk[i])} plain z={int(zp[i])}")
        if mode == "deterministic":
            z_err = float((zk - zp).abs().max())
            c_err = float(max((ndk_k - ndk_p).abs().max(), (nk_k - nk_p).abs().max()))
            if diff.numel() or c_err:
                raise AssertionError(
                    f"K1 deterministic differs: z {diff.numel()} tokens, counts {c_err}")
            out["gibbs_tile_sample"] = dict(max_abs_err=z_err)
            out["gibbs_tile_update"] = dict(max_abs_err=c_err)
        elif match < MIN_MATCH:
            raise AssertionError(f"K1 {mode}: z equal on only {match:.6f}")
        else:
            out["gibbs_tile_sample"][f"z_match_{mode}"] = match

    # --- K2 rebuild over the whole stream
    nwk_k, nk_k = ck.rebuild_counts(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad)
    nwk_p, nk_p = ck.rebuild_counts_plain(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad)
    torch.cuda.synchronize()
    r_err = float(max((nwk_k - nwk_p).abs().max(), (nk_k - nk_p).abs().max()))
    if not (torch.equal(nwk_k, nwk_p) and torch.equal(nk_k, nk_p)):
        raise AssertionError(f"rebuild_counts differs from its plain version: {r_err}")
    out["rebuild_counts"] = dict(max_abs_err=r_err)
    log("[kernels] K2 rebuild_counts and cast_mirror bitwise equal to plain")

    # --- times (internal noise: the main path's mode)
    def sample_kernel():
        return fk.gibbs_tile_sample(mirror, st.ndk, st.nk, z, w, d, m,
                                    noise_mode="internal", seed=7, **hyper)

    def sample_plain():
        for s in range(0, BLOCK, row_tile):
            sl = slice(s, s + row_tile)
            fk.sample_plain(mirror, st.ndk, st.nk, z[sl], w[sl], d[sl], m[sl],
                            alpha=ALPHA, beta=BETA, vbeta=vbeta,
                            noise_mode="internal", seed=7, slot0=s)

    z_new = sample_kernel()
    ndk_c, nk_c = st.ndk.clone(), st.nk.clone()

    def update_kernel():
        fk.gibbs_tile_update(ndk_c, nk_c, z, z_new, d, m, row_tile=row_tile)

    def update_plain():
        for s in range(0, BLOCK, row_tile):
            sl = slice(s, s + row_tile)
            fk.update_plain(ndk_c, nk_c, z[sl], z_new[sl], d[sl], m[sl])

    key = (tw.long() * k_pad + st.z.long())[tm > 0]
    times = {
        "gibbs_tile_sample": (cuda_ms(sample_kernel), cuda_ms(sample_plain), None),
        "gibbs_tile_update": (cuda_ms(update_kernel), cuda_ms(update_plain), None),
        "rebuild_counts": (
            cuda_ms(lambda: ck.rebuild_counts(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad)),
            cuda_ms(lambda: ck.rebuild_counts_plain(st.z, tw, tm, v_pad=v_pad,
                                                    k_pad=k_pad)),
            cuda_ms(lambda: torch.bincount(key, minlength=v_pad * k_pad))),
        "cast_mirror": (
            cuda_ms(lambda: ck.cast_mirror(nwk_pad)),
            cuda_ms(lambda: ck.cast_mirror_plain(nwk_pad)),
            cuda_ms(lambda: nwk_pad.to(torch.bfloat16))),
    }

    # --- bounds from this run's inputs
    wb = plan.token_word[blk][plan.token_mask[blk] > 0]
    db = plan.token_doc[blk][plan.token_mask[blk] > 0]
    u_words, u_docs = np.unique(wb).size, np.unique(db).size
    moved = (z_new != z) & real
    cells = torch.unique(d[moved].long() * K + z[moved].long()).numel() + \
        torch.unique(d[moved].long() * K + z_new[moved].long()).numel()
    topics = torch.unique(torch.cat([z[moved], z_new[moved]])).numel()
    t_pad = plan.num_tokens
    bounds = {
        "gibbs_tile_sample": bound(
            u_words * k_pad * 2 + u_docs * K * 4 + K * 4 + BLOCK * 4 * 5,
            n_real * k_pad * SAMPLE_OPS_PER_ELEM),
        "gibbs_tile_update": bound(BLOCK * 4 * 4 + cells * 8 + topics * 8,
                                   4 * int(moved.sum())),
        "rebuild_counts": bound(t_pad * 12 + v_pad * k_pad * 4 + k_pad * 4,
                                2 * int(tm.sum())),
        "cast_mirror": bound(v_pad * k_pad * 6, v_pad * k_pad),
    }
    units = {
        "gibbs_tile_sample": f"one block of {BLOCK} tokens ({BLOCK // row_tile} tiles)",
        "gibbs_tile_update": f"one block of {BLOCK} tokens ({BLOCK // row_tile} tiles)",
        "rebuild_counts": f"one rebuild of {t_pad} stream slots",
        "cast_mirror": f"one [{v_pad}, {k_pad}] table",
    }
    for name, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bounds[name]
        out[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, unit=units[name])
        log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{b_ms:.4f} ms by {b_by}) per {units[name]}")
    return out


def main_path(corpus, seed: int, smi: str, device: str = "cuda"):
    """Phase 4: the entry points a user calls; returns tokens/s and the
    kernel launches of the run."""
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.ops import count_kernel as ck
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

    cfg = LdaConfig(alpha=ALPHA, beta=BETA, topic_num=K, iteration=SWEEPS,
                    block_size=BLOCK, seed=seed)
    t0 = time.perf_counter()
    model = make_backend(cfg, corpus, device=device)
    torch.cuda.synchronize()
    log(f"[main] make_backend {time.perf_counter() - t0:.2f}s "
        f"(T_pad={model.state.z.shape[0]}, row tile {model._run_sweeps.row_tile})")
    for counts in (fk.LAUNCHES, fk.PLAIN_CALLS, ck.LAUNCHES, ck.PLAIN_CALLS):
        for name in counts:
            counts[name] = 0
    t0 = time.perf_counter()
    run_inference(model, cfg, corpus)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**fk.LAUNCHES, **ck.LAUNCHES}
    plain = {**fk.PLAIN_CALLS, **ck.PLAIN_CALLS}
    log(f"[main] launches {launches}, plain calls {plain}")
    if model.sweeps_done != SWEEPS:
        raise AssertionError(f"ran {model.sweeps_done} sweeps, not {SWEEPS}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    t1 = time.perf_counter()
    model.check_counts_consistent()
    phi, theta = model.phi(), model.theta()
    import numpy as np

    if not (np.isfinite(phi).all() and np.isfinite(theta).all()):
        raise AssertionError("phi/theta not finite")
    if phi.shape != (K, V) or theta.shape != (M, K):
        raise AssertionError(f"phi {phi.shape} theta {theta.shape}")
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, rtol=1e-3)
    tok_s = SWEEPS * corpus.num_tokens / dt
    log(f"[main] {SWEEPS} sweeps of {corpus.num_tokens} tokens in {dt:.3f}s = "
        f"{tok_s:,.0f} tokens/s ({dt / SWEEPS * 1e3:.2f} ms/sweep) on {smi}; "
        f"counts consistent (check {time.perf_counter() - t1:.2f}s)")
    return tok_s, launches, model


def profile_sweep(model) -> None:
    """Phase 4b: one more sweep under the port's ``trace`` (what the CLI's
    ``--profile-dir`` runs): device time by kernel and the device's busy
    share of the sweep's wall time."""
    import torch

    from ldagibbssampling_tpu_torch.evaluation.tracing import trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            t0 = time.perf_counter()
            model.sweep(1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if not (Path(tmp) / "trace.json").stat().st_size:
            raise AssertionError("trace() wrote an empty trace")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("[profile] the profiler recorded no device time (not measured)")
        return
    by_name: dict = {}
    for e in kernels:
        short = e.name.replace("(anonymous namespace)::", "")
        key = short.removeprefix("void ").split("(")[0].strip() or repr(e.name[:80])
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    log(f"[profile] one sweep: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.3f} of wall)")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"  {key}: {n} launches, {us / 1e3:.3f} ms ({us / n:.2f} us each)")


def cli_phase() -> None:
    """Phase 5: the port's CLI writes the five artifacts on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", f"{PKG}.cli", "--generate-minicorpus",
               "--docs", f"{tmp}/docs", "--results", f"{tmp}/res", "-k", "10",
               "--iterations", "60", "--save-step", "10",
               "--begin-save-iters", "50", "--check-counts"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}:\n{proc.stderr[-3000:]}")
        tail = [ln for ln in proc.stdout.splitlines() if ln.startswith(("count", "Done"))]
        files = sorted(p.name for p in Path(tmp, "res").iterdir())
        want = sorted(f"lda_{i}.{e}" for i in (50, 60)
                      for e in ("params", "phi", "theta", "tassign", "twords"))
        if files != want:
            raise AssertionError(f"CLI artifacts {files} != {want}")
        log(f"[cli] {time.perf_counter() - t0:.1f}s, wrote {len(files)} "
            f"artifacts; {' | '.join(tail)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (REPO / PKG / "csrc").is_dir():
        return fail(f"{PKG}/ not found beside {Path(__file__).name}: run it "
                    "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from ldagibbssampling_tpu_torch.ops import _build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources built in {secs:.1f}s")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    corpus = synth_corpus(args.seed)
    kernels = check_kernels(corpus, args.seed)  # 3.
    tok_s, launches, model = main_path(corpus, args.seed, smi)  # 4.
    profile_sweep(model)                        # 4b.
    cli_phase()                                 # 5.

    src = f"{PKG}/csrc"
    meta = {
        "gibbs_tile_sample": (f"{src}/fused_kernel.cu", "ldagibbssampling_tpu/ops/pallas_gibbs.py:58"),
        "gibbs_tile_update": (f"{src}/fused_kernel.cu", "ldagibbssampling_tpu/ops/pallas_gibbs.py:58"),
        "rebuild_counts": (f"{src}/count_kernel.cu", "ldagibbssampling_tpu/ops/count_kernel.py:211"),
        "cast_mirror": (f"{src}/count_kernel.cu", "ldagibbssampling_tpu/ops/count_kernel.py:211"),
    }
    rows = []
    for kname, (source, replaces) in meta.items():
        k = kernels[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "unit": k["unit"],
            **{x: v for x, v in k.items() if x.startswith("z_match")},
        })
    print(json.dumps({"kernels": rows, "main_path_tokens_per_s": tok_s,
                      "sweeps": SWEEPS}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
