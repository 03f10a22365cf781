"""Benchmark of the PyTorch/CUDA port: tokens resampled/s on one card at K=500.

Counterpart of the repository's ``bench.py``, with its shape, its knobs and
its output, driving ``ldagibbssampling_tpu_torch`` on the card.  It runs the
blocked collapsed-Gibbs sweep over a synthetic Zipf-distributed corpus
(``synth_corpus``, bitwise ``bench.py``'s arrays), one warm-up call of
``LDA_BENCH_SWEEPS`` sweeps and then one timed call of as many, and prints
exactly one JSON line on stdout:

    {"metric": "tokens_resampled_per_s_chip_K500", "value": N,
     "unit": "tokens/s", "vs_baseline": N}

with a ``# device=...`` line, naming the card, on stderr.  ``vs_baseline``
is measured against ``bench.py``'s serial-Java estimate (2e4 tokens/s).

    python -m ldagibbssampling_tpu_torch.scripts.bench [tokens] [topics]

Knobs, as in ``bench.py``: ``LDA_BENCH_VOCAB`` (50,000), ``LDA_BENCH_DOCS``
(4,096), ``LDA_BENCH_BLOCK`` (65,536), ``LDA_BENCH_SWEEPS`` (100),
``LDA_BENCH_PALLAS`` (``deferred``; ``fused``, ``1`` = v1 draw, ``0`` = the
XLA sweep), ``LDA_BENCH_COMPUTE`` (K1's chain in the deferred tier) and
``LDA_BENCH_MIRROR`` (its snapshot's type).  ``bench.py``'s platform rule
(anything but a TPU runs the XLA sweep) is dropped: the tier asked for runs
on the card, and without a card the script raises.  ``main(device="cpu")``
runs the kernels' plain versions on the CPU, for tests at a small shape; no
number it prints says anything of the card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional, Sequence

import numpy as np

BASELINE_TOKENS_PER_S = 2e4  # bench.py's serial-Java estimate, upper end


def synth_corpus(t: int, v: int, m: int, seed: int = 0):
    """Zipf-ish synthetic corpus as flat arrays (no host ragged build at scale)."""
    rng = np.random.default_rng(seed)
    # word ids: Zipf(1.1) truncated to V — realistic skew for count gathers
    raw = rng.zipf(1.1, size=t).astype(np.int64)
    token_word = ((raw - 1) % v).astype(np.int32)
    # doc ids: contiguous equal-size docs
    token_doc = (np.arange(t, dtype=np.int64) * m // t).astype(np.int32)
    doc_lengths = np.bincount(token_doc, minlength=m).astype(np.int32)
    return token_word, token_doc, doc_lengths


def settings(argv: Sequence[str], environ=os.environ) -> dict:
    """``bench.py``'s shape and knobs (``bench.py:25-52``) from ``[tokens]
    [topics]`` and the ``LDA_BENCH_*`` variables, with its defaults and its
    refusals."""
    compute = environ.get("LDA_BENCH_COMPUTE", "float32")
    if compute not in ("float32", "bfloat16", "bf16p"):
        raise SystemExit(f"LDA_BENCH_COMPUTE={compute!r}: expected float32|bfloat16|bf16p")
    pallas = environ.get("LDA_BENCH_PALLAS", "deferred")
    use_pallas = {"0": False, "1": True, "fused": "fused", "deferred": "deferred"}[pallas]
    mirror = environ.get("LDA_BENCH_MIRROR", "bfloat16")
    if mirror not in ("bfloat16", "float32"):
        raise SystemExit(f"LDA_BENCH_MIRROR={mirror!r}: expected bfloat16|float32")
    return dict(
        num_tokens=int(argv[0]) if len(argv) > 0 else 1 << 20,
        num_topics=int(argv[1]) if len(argv) > 1 else 500,
        vocab=int(environ.get("LDA_BENCH_VOCAB", 50_000)),
        num_docs=int(environ.get("LDA_BENCH_DOCS", 4_096)),
        block_size=int(environ.get("LDA_BENCH_BLOCK", 65_536)),
        timed_sweeps=int(environ.get("LDA_BENCH_SWEEPS", 100)),
        use_pallas=use_pallas, compute_dtype=compute, mirror_dtype=mirror,
    )


def main(device: Any = "cuda", argv: Optional[Sequence[str]] = None) -> None:
    """Run the benchmark on ``device`` (``argv`` defaults to ``sys.argv[1:]``)
    and print its JSON line."""
    import torch

    from ldagibbssampling_tpu_torch.models.lda import resolve_device
    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops.count_kernel import plan_deferred
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    s = settings(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    where = f"{dev}:{torch.cuda.get_device_name(dev)}" if on_card else str(dev)
    block, k, vocab = s["block_size"], s["num_topics"], s["vocab"]
    sweeps, use_pallas = s["timed_sweeps"], s["use_pallas"]
    t = (s["num_tokens"] // block) * block
    tw, td, dl = synth_corpus(t, vocab, s["num_docs"])

    if use_pallas == "deferred":
        # the deferred layout: stripe-aligned blocks + per-sweep count rebuild
        plan = plan_deferred(tw, td, vocab, block)
        tw, td, tm = plan.token_word, plan.token_doc, plan.token_mask
    else:
        plan = None
        tm = np.ones(t, dtype=np.int32)
        # within-block word sort (PaddedCorpus.sort_within_blocks)
        for b in range(0, t, block):
            perm = np.argsort(tw[b: b + block], kind="stable")
            tw[b: b + block] = tw[b: b + block][perm]
            td[b: b + block] = td[b: b + block][perm]

    state = init_state(tw, td, tm, num_docs=s["num_docs"], vocab_size=vocab,
                       num_topics=k, seed=0, device=dev)
    gen = torch.Generator().manual_seed(state.seed)
    run = make_sweep_fn(
        tw, td, tm, dl, alpha=0.5, beta=0.1, block_size=block,
        draw_method="gumbel", num_sweeps=sweeps, use_pallas=use_pallas,
        num_topics=k, deferred_plan=plan, device=dev,
        kernel_compute_dtype=s["compute_dtype"], mirror_dtype=s["mirror_dtype"],
    )
    mirror = None

    def call(state, mirror):
        # the deferred tier carries its snapshot across calls: cast once
        if hasattr(run, "with_mirror"):
            return run.with_mirror(state, mirror=mirror, generator=gen)
        return run(state, generator=gen), None

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # warm-up (builds and loads the kernels on the first call)
    sync()
    t0 = time.perf_counter()
    state, mirror = call(state, mirror)
    sync()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, mirror = call(state, mirror)
    sync()
    dt = time.perf_counter() - t0

    tokens_per_s = sweeps * t / dt
    result = {
        "metric": f"tokens_resampled_per_s_chip_K{k}",
        "value": round(tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_baseline": round(tokens_per_s / BASELINE_TOKENS_PER_S, 2),
    }
    print(
        f"# device={where} T={t} K={k} V={vocab} block={block} "
        f"pallas={use_pallas} tier={run.kernel_tier} compute={s['compute_dtype']} "
        f"mirror={s['mirror_dtype']} compile={compile_s:.1f}s "
        f"timed={sweeps} sweeps in {dt:.2f}s",
        file=sys.stderr,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
