"""Driver hook: one sweep step of the port's main path.

Counterpart of ``__graft_entry__.py:34-67``.  ``entry()`` returns ``(fn,
args)`` with ``fn(*args)`` one blocked collapsed-Gibbs sweep of a toy corpus
in the deferred tier (K1's walk and K2's rebuild), on the card unless
``device="cpu"`` is given, where the kernels' plain versions run.  The
multi-chip dry run waits for the port's parallel runtimes (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np


def _toy_corpus(num_docs=32, vocab=64, tokens_per_doc=24, seed=0):
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

    rng = np.random.default_rng(seed)
    ragged = [
        [int(x) for x in rng.integers(0, vocab, size=tokens_per_doc)]
        for _ in range(num_docs)
    ]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def entry(device: Any = "cuda"):
    """(fn, example_args): one deferred-tier sweep step; ``fn(*args)``
    returns the state after the sweep."""
    import torch

    from ldagibbssampling_tpu_torch.models.lda import resolve_device
    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops.count_kernel import plan_deferred
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    dev = resolve_device(device)
    corpus = _toy_corpus(num_docs=64, vocab=128, tokens_per_doc=64)
    block = 512
    plan = plan_deferred(corpus.token_word, corpus.token_doc,
                         corpus.vocab_size, block)
    tw, td, tm = plan.token_word, plan.token_doc, plan.token_mask
    state = init_state(
        tw, td, tm, num_docs=corpus.num_docs, vocab_size=corpus.vocab_size,
        num_topics=16, seed=0, device=dev,
    )
    run = make_sweep_fn(
        tw, td, tm, corpus.doc_lengths(),
        alpha=0.5, beta=0.1, block_size=block, draw_method="gumbel",
        num_sweeps=1, use_pallas="deferred", num_topics=16,
        deferred_plan=plan, device=dev,
    )
    fn = functools.partial(run, generator=torch.Generator().manual_seed(state.seed))
    fn.kernel_tier = run.kernel_tier
    return fn, (state,)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", int(out.sweep), "sweep(s) done")
