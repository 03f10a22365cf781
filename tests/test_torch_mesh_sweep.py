"""The port's mesh runtimes (``parallel/adlda.ShardedLda``,
``parallel/grid.GridLda``, ``parallel/tokenshard.TokenShardedLda``) against
the JAX package's on its eight virtual CPU devices, in each kernel tier
(XLA, fused, deferred; the reference's kernel tiers under
``pallas_interpret=True``), over three sweeps from the reference's own
initial state (``interop.from_jax_mesh_state``), the port on a mesh of
``cpu`` positions fed each shard's noise rebuilt from the reference's key:
``fold_in(key, p)`` for shard ``p`` (the grid's cell ``(i, j)``:
``fold_in(fold_in(key, i), j + 2^16)``), then the derivation of
``ldagibbssampling_tpu/ops/gibbs.py`` (XLA: a Gumbel array per block,
``:205-207``; the kernels: ``uniform(fold_in(key, sweep), (T, k_pad),
1e-7, 1 - 1e-7)``, ``:581-589``).

Tolerances: the tables must equal the recount of the port's own ``z``
(exact, always).  ``z`` must match the reference's on at least 99.9% of
the tokens: XLA's and PyTorch's float32 ``log`` differ by one ulp on some
CPU inputs, which can flip a near-tie draw (``test_torch_xla_sweep.py``).
For the seeds below the match is exact, and then every table must equal
the reference's.  ``kernel_tier`` must equal the reference's, also where
the tier is downgraded (``tests/test_deferred_mesh.py:101-120``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from ldagibbssampling_tpu.config import LdaConfig as JaxConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.parallel.adlda import ShardedLda as JaxShardedLda
from ldagibbssampling_tpu.parallel.adlda import (
    make_sharded_sweep_fn as jax_make_sharded_sweep_fn)
from ldagibbssampling_tpu.parallel.chaingrid import ShardedChainSet as JaxChainSet
from ldagibbssampling_tpu.parallel.grid import GridLda as JaxGridLda
from ldagibbssampling_tpu.parallel.grid import make_grid_sweep_fn as jax_make_grid_sweep_fn
from ldagibbssampling_tpu.parallel.tokenshard import TokenShardedLda as JaxTokenLda
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.parallel import make_sharded_sweep_fn, multihost
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet
from ldagibbssampling_tpu_torch.parallel.grid import GridLda, make_grid_sweep_fn
from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

K = 7
V = 300
AXES = {"adlda": {"data": 2}, "grid": {"data": 2, "vocab": 2},
        "token": {"data": 2}, "chain": {"chain": 2, "data": 2}}


def mesh_corpora(seed: int = 0, num_docs: int = 60):
    """The same Zipf-worded corpus in both packages."""
    rng = np.random.default_rng(seed)
    docs = [list((rng.zipf(1.3, size=int(rng.integers(20, 120))) - 1) % V)
            for _ in range(num_docs)]
    return (JaxFlatCorpus.from_ragged(docs, vocab_size=V),
            FlatCorpus.from_ragged(docs, vocab_size=V))


def cpu_mesh(kind: str) -> multihost.Mesh:
    axes = AXES[kind]
    return multihost.make_mesh(axes, [torch.device("cpu")] * int(np.prod(list(axes.values()))))


def reference(kind: str, corpus, **cfg):
    """The reference runtime on the virtual devices (interpret mode)."""
    jcfg = JaxConfig(pallas_interpret=bool(cfg.get("use_pallas")), **cfg)
    devs = jax.devices()
    if kind == "adlda":
        return JaxShardedLda(jcfg, corpus, num_shards=2)
    if kind == "token":
        return JaxTokenLda(jcfg, corpus, num_shards=2)
    if kind == "grid":
        return JaxGridLda(jcfg, corpus, mesh=JaxMesh(
            np.array(devs[:4]).reshape(2, 2), ("data", "vocab")))
    return JaxChainSet(jcfg, corpus, num_chains=2, mesh=JaxMesh(
        np.array(devs[:4]).reshape(2, 2), ("chain", "data")))


def port(kind: str, corpus, noise_mode: str = "external", **cfg):
    cls = {"adlda": ShardedLda, "grid": GridLda, "token": TokenShardedLda,
           "chain": ShardedChainSet}[kind]
    return cls(LdaConfig(**cfg), corpus, mesh=cpu_mesh(kind), device="cpu",
               noise_mode=noise_mode)


def token_mask(kind: str, model) -> np.ndarray:
    """The port's stacked token mask (the chain mesh: per chain)."""
    if kind == "token":
        return model._tm > 0
    m = model.shards.token_mask > 0
    return np.stack([m, m]) if kind == "chain" else m


def shard_key(kind: str, ref, mesh: multihost.Mesh, p: int):
    """The reference's key of the shard at position ``p``."""
    c = mesh.coords(p)
    key = ref._key
    if kind == "grid":
        return jax.random.fold_in(jax.random.fold_in(key, c[0]), c[1] + (1 << 16))
    for x in c:
        key = jax.random.fold_in(key, x)
    return key


def reference_noise(kind: str, ref, model):
    """``noise(p, sweep)``: the reference's noise for the port's shard."""
    t = token_mask(kind, model).shape[-1]
    b = model.block_size

    def noise(p, sweep):
        sweep_key = jax.random.fold_in(shard_key(kind, ref, model.mesh, p), sweep)
        if model.kernel_tier == "xla":
            return np.concatenate([np.asarray(jax.random.gumbel(
                jax.random.fold_in(sweep_key, i), (b, K), jnp.float32))
                for i in range(t // b)])
        return np.asarray(jax.random.uniform(
            sweep_key, (t, 128), jnp.float32, minval=1e-7, maxval=1.0 - 1e-7))
    return noise


def load_reference(model, ref) -> None:
    interop.from_jax_mesh_state(model, {n: np.asarray(getattr(ref, n))
                                        for n in ("z", "ndk", "nwk", "nk")})


def assert_matches(kind, model, ref, exact=True):
    """Counts exact recounts; ``z`` ≥ 99.9% (exact here) and the tables
    equal to the reference's."""
    model.check_counts_consistent()
    a = model.arrays()
    real = token_mask(kind, model)
    z_ref = np.asarray(ref.z)
    np.testing.assert_array_equal(a["z"][~real], z_ref[~real])
    match = float((a["z"][real] == z_ref[real]).mean())
    assert match >= 0.999, match
    if exact:
        assert match == 1.0  # exact for the seeds here (module docstring)
        for name in ("ndk", "nwk", "nk"):
            np.testing.assert_array_equal(a[name], np.asarray(getattr(ref, name)),
                                          err_msg=name)


@pytest.mark.parametrize("kind,tier,block,seed", [
    ("adlda", False, 256, 3), ("adlda", "fused", 256, 4),
    ("adlda", "deferred", 512, 5),
    ("grid", False, 128, 6), ("grid", "fused", 256, 7), ("grid", "deferred", 256, 8),
    ("token", False, 128, 9), ("token", "deferred", 256, 10),
])
def test_sweeps_match_reference(kind, tier, block, seed):
    jc, pc = mesh_corpora(seed)
    cfg = dict(topic_num=K, block_size=block, seed=seed, use_pallas=tier)
    ref = reference(kind, jc, **cfg)
    model = port(kind, pc, **cfg)
    assert model.kernel_tier == ref.kernel_tier == (tier or "xla")
    load_reference(model, ref)
    ref.sweep(3)
    model.sweep(3, noise=reference_noise(kind, ref, model))
    assert model.sweeps_done == 3
    assert_matches(kind, model, ref)


@pytest.mark.parametrize("kind,cfg,tier", [
    ("adlda", dict(block_size=32, use_pallas="deferred"), "xla"),
    ("adlda", dict(draw_method="inverse_cdf", use_pallas="deferred"), "xla"),
    ("adlda", dict(use_pallas=True), "xla"),
    ("grid", dict(block_size=64, use_pallas="fused"), "xla"),
    ("token", dict(use_pallas="fused"), "xla"),
    ("token", dict(draw_method="inverse_cdf", use_pallas="deferred"), "xla"),
    ("chain", dict(use_pallas="fused"), "deferred"),
    ("chain", dict(use_pallas=True), "xla"),
])
def test_tier_resolution_matches_reference(kind, cfg, tier):
    """The reference constructors' downgrades (its platform rule aside)."""
    jc, pc = mesh_corpora(1)
    cfg = dict(topic_num=K, seed=1, **{"block_size": 256, **cfg})
    model = port(kind, pc, noise_mode="internal", **cfg)
    assert model.kernel_tier == reference(kind, jc, **cfg).kernel_tier == tier
    model.sweep(1)
    model.check_counts_consistent()


def test_inverse_cdf_xla_tier_matches_reference():
    jc, pc = mesh_corpora(2)
    cfg = dict(topic_num=K, block_size=64, seed=2, draw_method="inverse_cdf",
               use_pallas=False)
    ref, model = reference("adlda", jc, **cfg), port("adlda", pc, **cfg)
    load_reference(model, ref)
    b = model.block_size

    def noise(p, sweep):
        sweep_key = jax.random.fold_in(shard_key("adlda", ref, model.mesh, p), sweep)
        t = model.shards.tokens_per_shard
        return np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(sweep_key, i), (b,), jnp.float32))
            for i in range(t // b)])
    ref.sweep(2)
    model.sweep(2, noise=noise)
    assert_matches("adlda", model, ref)


@pytest.mark.parametrize("kind,tier", [
    ("adlda", False), ("adlda", "fused"), ("adlda", "deferred"),
    ("grid", "deferred"), ("token", "deferred"), ("chain", "deferred")])
def test_internal_noise_seeded_and_exact(kind, tier):
    """Internal noise: a seeded chain (same seed, same chain; another seed,
    another), exact counts, padding untouched, and on the CPU only the
    kernels' plain versions (one bf16 snapshot cast per sweep for the
    replica of ``nwk`` on the one device, one rebuild per shard and
    sweep)."""
    _, pc = mesh_corpora(11)
    cfg = dict(topic_num=K, block_size=256, use_pallas=tier)
    before = tracing.counters()
    a = port(kind, pc, noise_mode="internal", seed=3, **cfg)
    z0 = a.arrays()["z"]
    a.sweep(2)
    moved = {n: c - before.get(n, 0) for n, c in tracing.counters().items()
             if n.startswith(("launch.", "plain.")) and c != before.get(n, 0)}
    if tier == "deferred":
        tables = int(np.prod([a.mesh.axis_size(x) for x in a.SPEC["nwk"]]))
        assert {n: moved.get(n, 0) for n in ("plain.cast_mirror", "plain.rebuild_counts")
                } == {"plain.cast_mirror": 2 * tables,
                      "plain.rebuild_counts": 2 * a.mesh.size}
    assert not any(n.startswith("launch.") for n in moved)
    b = port(kind, pc, noise_mode="internal", seed=3, **cfg)
    b.sweep(2)
    c = port(kind, pc, noise_mode="internal", seed=4, **cfg)
    c.sweep(2)
    za, zb, zc = (m.arrays()["z"] for m in (a, b, c))
    np.testing.assert_array_equal(za, zb)
    assert not np.array_equal(za, zc)
    real = token_mask(kind, a)
    np.testing.assert_array_equal(za[~real], z0[~real])
    assert (za[real] != z0[real]).any()
    a.check_counts_consistent()


def test_one_position_and_shard_padding():
    """``num_shards`` beyond the positions gives fewer shards, as the
    reference's ``Mesh(devs[:n])``; padding documents drop out of θ."""
    _, pc = mesh_corpora(12, num_docs=7)
    cfg = LdaConfig(topic_num=K, block_size=128, seed=0)
    one = ShardedLda(cfg, pc, num_shards=4, device="cpu")
    assert one.mesh.size == 1
    three = ShardedLda(cfg, pc, mesh=multihost.make_mesh(
        {"data": 3}, [torch.device("cpu")] * 3), device="cpu")
    assert (three.shards.doc_map < 0).any()  # 7 documents over 3 shards pad
    three.sweep(2)
    three.check_counts_consistent()
    theta = three.theta()
    assert theta.shape == (7, K)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(three.phi().sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("kind,tier,block,seed", [
    ("adlda", False, 256, 13), ("adlda", "fused", 256, 14),
    ("adlda", "deferred", 256, 15),
    ("grid", False, 128, 16), ("grid", "deferred", 256, 17),
])
def test_sweep_fns_match_reference(kind, tier, block, seed):
    """``parallel.make_sharded_sweep_fn`` and ``grid.make_grid_sweep_fn``
    against the JAX functions, called as ``tests/test_grid.py:124-150``
    calls them: built from the runtimes' shards, mesh and layout, run for two
    sweeps from the reference's initial state with the reference's noise;
    the tolerance of ``assert_matches``."""
    jc, pc = mesh_corpora(seed)
    cfg = dict(topic_num=K, block_size=block, seed=seed, use_pallas=tier)
    ref = reference(kind, jc, **cfg)
    model = port(kind, pc, **cfg)
    make = {"adlda": (jax_make_sharded_sweep_fn, make_sharded_sweep_fn),
            "grid": (jax_make_grid_sweep_fn, make_grid_sweep_fn)}[kind]
    args = dict(alpha=0.5, beta=0.1, block_size=model.block_size, num_sweeps=2,
                use_pallas=tier, num_topics=K)
    jax_run = make[0](ref.shards, ref.mesh, pallas_interpret=True,
                      deferred_layout=ref._dlayout, **args)
    run = make[1](model.shards, model.mesh, noise_mode="external",
                  deferred_layout=model._layout, **args)
    assert run.kernel_tier == jax_run.kernel_tier == (tier or "xla")
    load_reference(model, ref)
    z, ndk, nwk, nk, _ = jax_run(ref.z, ref.ndk, ref.nwk, ref.nk, ref._key,
                                 jnp.int32(0))
    model.z, model.ndk, model.nwk, model.nk = run(
        model.z, model.ndk, model.nwk, model.nk, 0, 0,
        noise=reference_noise(kind, ref, model))
    assert_matches(kind, model, SimpleNamespace(z=z, ndk=ndk, nwk=nwk, nk=nk))


def test_sweep_fn_internal_noise_is_seeded_by_seed_and_sweep():
    """Internal noise from ``(seed, sweep)``: one call of two sweeps is two
    calls of one; another seed draws another chain; the inputs stay."""
    _, pc = mesh_corpora(18)
    model = port("adlda", pc, noise_mode="internal", topic_num=K, block_size=256,
                 seed=1, use_pallas="deferred")
    run = make_sharded_sweep_fn(model.shards, model.mesh, alpha=0.5, beta=0.1,
                                block_size=256, num_topics=K,
                                deferred_layout=model._layout)
    state = (model.z, model.ndk, model.nwk, model.nk)
    z0 = {p: t.clone() for p, t in model.z.items()}
    two = run(*state, 5, 0, n_sweeps=2)
    once = run(*run(*state, 5, 0), 5, 1)
    other = run(*state, 6, 0, n_sweeps=2)
    for p in z0:
        assert torch.equal(state[0][p], z0[p])
        assert torch.equal(two[0][p], once[0][p])
        assert torch.equal(two[2][p], once[2][p])
    assert any(not torch.equal(two[0][p], other[0][p]) for p in z0)
