"""Driver hook: one sweep step of the port's main path.

Counterpart of ``__graft_entry__.py:34-67``.  ``entry()`` returns ``(fn,
args)`` with ``fn(*args)`` one blocked collapsed-Gibbs sweep of a toy corpus
in the deferred tier (K1's walk and K2's rebuild), on the card unless
``device="cpu"`` is given, where the kernels' plain versions run.
``dryrun_multichip(n)`` (reference ``:70-230``) runs one training step of
every parallel runtime over a mesh of ``n`` positions: the devices of
``parallel/multihost.local_devices`` in turn, so one card (or the CPU)
holds several shards.
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


def dryrun_multichip(n_devices: int, device: Any = "cuda") -> None:
    """One sweep (and its reconciliation) of every parallel runtime on a
    mesh of ``n_devices`` positions, with the reference's checks: exact
    counts after each, φ and θ rows summing to 1, a finite device LL, a
    non-power-of-two shard count, the deferred tier on each runtime, the
    grid's Minka update and checkpoint round trip, the chains × data mesh."""
    import tempfile

    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.parallel import multihost
    from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
    from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainModel
    from ldagibbssampling_tpu_torch.parallel.grid import GridLda
    from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

    local = multihost.local_devices(device)
    devs = [local[i % len(local)] for i in range(n_devices)]

    def mesh(axes: dict):
        n = int(np.prod(list(axes.values())))
        return multihost.make_mesh(axes, devs[:n])

    corpus = _toy_corpus(num_docs=4 * n_devices, vocab=48, tokens_per_doc=16)
    cfg = LdaConfig(topic_num=8, block_size=16, seed=0, use_pallas=False)
    model = ShardedLda(cfg, corpus, mesh=mesh({"data": n_devices}), device=device)
    model.sweep(1)
    model.check_counts_consistent()
    np.testing.assert_allclose(model.phi().sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(model.theta().sum(axis=1), 1.0, rtol=1e-5)
    ll = model.device_log_likelihood()
    assert np.isfinite(ll)
    print(f"dryrun_multichip ok: {n_devices} positions, {corpus.num_tokens} "
          f"tokens, counts consistent after sharded sweep, device LL {ll:.1f}")
    if n_devices >= 3:  # the partition and psum assume no power of two
        odd = 3 if n_devices % 2 == 0 else n_devices - 1
        m_odd = ShardedLda(cfg, corpus, mesh=mesh({"data": odd}), device=device)
        m_odd.sweep(1)
        m_odd.check_counts_consistent()
        print(f"dryrun_multichip ok: non-power-of-two {odd}-shard AD-LDA")
    cfg_def = LdaConfig(topic_num=8, block_size=128, seed=2, use_pallas="deferred")
    corpus_big = _toy_corpus(num_docs=4 * n_devices, vocab=48,
                             tokens_per_doc=40, seed=5)
    if n_devices >= 2:
        corpus_def = _toy_corpus(num_docs=2 * n_devices, vocab=40,
                                 tokens_per_doc=40, seed=3)
        m_def = ShardedLda(cfg_def.replace(seed=1), corpus_def,
                           mesh=mesh({"data": 2}), device=device)
        assert m_def.kernel_tier == "deferred", m_def.kernel_tier
        m_def.sweep(1)
        m_def.check_counts_consistent()
        print("dryrun_multichip ok: deferred tier, bitwise counts after psum "
              "of local rebuilds")
        pd = n_devices // 2
        grid = GridLda(cfg, corpus, mesh=mesh({"data": pd, "vocab": 2}),
                       device=device)
        grid.sweep(1)
        grid.check_counts_consistent()
        a, b = grid.optimize_hyperparameters()
        assert 0 < a < 100 and 0 < b < 100
        with tempfile.TemporaryDirectory() as ckdir:
            grid.save_checkpoint(ckdir)
            grid.sweep(1)
            z_after = grid.arrays()["z"]
            grid2 = GridLda(cfg, corpus, mesh=mesh({"data": pd, "vocab": 2}),
                            device=device)
            assert grid2.restore_checkpoint(ckdir) == 1
            grid2.sweep(1)
            np.testing.assert_array_equal(grid2.arrays()["z"], z_after)
        np.testing.assert_allclose(grid.phi().sum(axis=1), 1.0, rtol=1e-5)
        print(f"dryrun_multichip grid ok: {pd}x2 ('data','vocab') mesh, counts "
              "consistent, Minka + checkpoint/restore round trip")
        g_def = GridLda(cfg_def, corpus_big, mesh=mesh({"data": pd, "vocab": 2}),
                        device=device)
        assert g_def.kernel_tier == "deferred", g_def.kernel_tier
        g_def.sweep(1)
        g_def.check_counts_consistent()
        print(f"dryrun_multichip ok: deferred tier on the {pd}x2 grid")
    tsh = TokenShardedLda(cfg, corpus, mesh=mesh({"data": n_devices}), device=device)
    tsh.sweep(1)
    tsh.check_counts_consistent()
    assert np.isfinite(tsh.device_log_likelihood())
    print(f"dryrun_multichip ok: {n_devices}-way token sharding")
    if n_devices >= 2:
        t_def = TokenShardedLda(cfg_def, corpus_big, mesh=mesh({"data": 2}),
                                device=device)
        assert t_def.kernel_tier == "deferred", t_def.kernel_tier
        t_def.sweep(1)
        t_def.check_counts_consistent()
        print("dryrun_multichip ok: deferred tier on 2-way token sharding")
    if n_devices >= 4:
        for c_cfg, c_corpus, p in ((cfg, corpus, n_devices // 2),
                                   (cfg_def, corpus_big, 2)):
            cm = ShardedChainModel(c_cfg, c_corpus, num_chains=2,
                                   mesh=mesh({"chain": 2, "data": p}), device=device)
            cm.sweep(2)
            cm.check_counts_consistent()
            assert cm.z().shape == (c_corpus.num_tokens,)
            print(f"dryrun_multichip ok: 2x{p} ('chain','data') mesh, "
                  f"{cm.kernel_tier} tier, per-chain counts consistent")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", int(out.sweep), "sweep(s) done")
