"""The deferred layout's planner on rung 3's training corpus, on the host.

Generates rung 3's corpus at ``--scale`` (``ladder.rung3_corpus`` with the
2^24-token floor the card's runs use, NYT-shaped, 5% of the documents held
out) and times ``ops/count_kernel.plan_deferred`` (the C++ planner,
``csrc/deferred_plan.cc``) at block 65,536 on all the process's cores and on
one thread; with ``--plain`` also the numpy planner (``plan_deferred_plain``,
the reference's), and then every field of the two plans must be equal.
Prints one JSON line.

Usage::

    python -m ldagibbssampling_tpu_torch.benchmarks.plan --scale 1.0 [--plain]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time

import numpy as np

from ldagibbssampling_tpu_torch.benchmarks import ladder
from ldagibbssampling_tpu_torch.ops import count_kernel as ck

BLOCK = 65_536


def _equal(a: ck.DeferredPlan, b: ck.DeferredPlan) -> list[str]:
    """The fields in which two plans differ (values or dtype)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (x.dtype == y.dtype and np.array_equal(x, y)
                if isinstance(x, np.ndarray) else x == y)
        if not same:
            bad.append(f.name)
    return bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--plain", action="store_true",
                    help="also time the numpy planner and compare the plans")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    corpus, _, m, v = ladder.rung3_corpus(args.scale, floor=True)
    out = {"scale": args.scale, "documents": m, "vocab": v,
           "tokens": corpus.num_tokens, "corpus_s": time.perf_counter() - t0}
    ck._plan_lib()  # built here, so that no timing below includes g++
    args_ = (corpus.token_word, corpus.token_doc, corpus.vocab_size, BLOCK)
    threads = ck._plan_threads()
    for n in sorted({threads, 1}, reverse=True):
        t0 = time.perf_counter()
        plan = ck._plan_native(*args_, v_loc=128, tile=2048, threads=n)
        out[f"native_s_threads_{n}"] = time.perf_counter() - t0
    out.update(slots=plan.num_tokens, blocks=plan.num_tokens // BLOCK,
               rebuild_slots=int(plan.w_local.shape[0]),
               max_word_freq=plan.max_word_freq)
    if args.plain:
        t0 = time.perf_counter()
        plain = ck.plan_deferred_plain(*args_)
        out["plain_s"] = time.perf_counter() - t0
        bad = _equal(plan, plain)
        if bad:
            raise AssertionError(f"the planners differ in {bad}")
        out["plans_equal"] = True
    out["peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
