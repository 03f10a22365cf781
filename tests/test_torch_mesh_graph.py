"""The mesh runtimes' sweep in one dispatch (``parallel/runtime.py``'s
``MeshRuntime._build_graph`` on ``ops/graphs.SweepGraph``), on the CPU.

On the CPU the graph's steps run eagerly on the same static buffers that a
card captures and replays, so these tests hold that body against the
runtimes' eager sweeps (``_eager_sweeps``: each runtime's
``_eager_sweep_once``, the local sweeps through ``_deferred_walk_`` on
clones, ``fused_gibbs_sweep`` and ``gibbs_sweep`` and the reconciliation through
``multihost.psum``), which ``test_torch_mesh_sweep.py`` and
``test_torch_chaingrid.py`` hold against the JAX package.

Tolerance: none.  Both forms run the same operations on the same values,
with integer sums for every reconciliation (exact in any order): ``z`` and
every table must be bitwise equal, in every runtime, tier and noise mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda, make_sharded_sweep_fn
from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet
from ldagibbssampling_tpu_torch.parallel.grid import GridLda, make_grid_sweep_fn
from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

K, V = 7, 300
CPU = torch.device("cpu")
AXES = {"adlda": {"data": 2}, "grid": {"data": 2, "vocab": 2},
        "token": {"data": 2}, "chain": {"chain": 2, "data": 2}}
TIERS = {"adlda": (False, "fused", "deferred"), "grid": (False, "fused", "deferred"),
         "token": (False, "deferred"), "chain": (False, "deferred")}
CASES = [(kind, tier) for kind, tiers in TIERS.items() for tier in tiers]


def corpus(seed: int = 0, num_docs: int = 60) -> FlatCorpus:
    """A small Zipf-worded corpus (``test_torch_mesh_sweep.mesh_corpora``'s)."""
    rng = np.random.default_rng(seed)
    docs = [list((rng.zipf(1.3, size=int(rng.integers(20, 120))) - 1) % V)
            for _ in range(num_docs)]
    return FlatCorpus.from_ragged(docs, vocab_size=V)


def build(kind: str, tier, mode: str = "internal", seed: int = 3, fc=None):
    axes = AXES[kind]
    mesh = multihost.make_mesh(axes, [CPU] * int(np.prod(list(axes.values()))))
    cls = {"adlda": ShardedLda, "grid": GridLda, "token": TokenShardedLda,
           "chain": ShardedChainSet}[kind]
    cfg = LdaConfig(topic_num=K, block_size=256 if tier else 128, seed=seed,
                    use_pallas=tier)
    model = cls(cfg, corpus() if fc is None else fc, mesh=mesh, device="cpu",
                noise_mode=mode)
    assert model.kernel_tier == (tier or "xla")
    return model


def noise_of(model):
    """``noise(position, sweep)``: external noise from a seed, shaped for
    the runtime's tier (Gumbel values for XLA, uniforms for the kernels)."""
    def noise(p, sweep):
        g = np.random.default_rng(1000 * p + sweep)
        t = model._tokens[p][0].shape[0]
        if model.kernel_tier == "xla":
            return -np.log(-np.log(g.uniform(1e-7, 1 - 1e-7, (t, K)))).astype(np.float32)
        return g.uniform(1e-7, 1 - 1e-7, (t, 128)).astype(np.float32)
    return noise


def assert_same(a, b) -> None:
    xa, xb = a.arrays(), b.arrays()
    for name in ("z", "ndk", "nwk", "nk"):
        np.testing.assert_array_equal(xa[name], xb[name], err_msg=name)


@pytest.mark.parametrize("mode", ["internal", "external", "deterministic"])
@pytest.mark.parametrize("kind,tier", CASES)
def test_graph_body_is_bitwise_the_eager_sweep(kind, tier, mode):
    """Three sweeps in one call against three eager sweeps, every tier and
    noise mode of every runtime; the graph's steps are one device segment
    in one process (one graph launch a sweep on the card)."""
    a, b = build(kind, tier, mode), build(kind, tier, mode)
    kw = dict(noise=noise_of(a)) if mode == "external" else {}
    a.sweep(3, **kw)
    b._eager_sweeps(3, **kw)
    assert a.sweeps_done == b.sweeps_done == 3
    assert_same(a, b)
    a.check_counts_consistent()
    assert a.graph.launches == 1 and a.graph.graphs == []  # never captured here
    assert (a.arrays()["z"] != build(kind, tier, mode).arrays()["z"]).any()


@pytest.mark.parametrize("kind,tier", CASES)
def test_one_and_two_sweeps_equal_three_in_one_call(kind, tier):
    a, b = build(kind, tier), build(kind, tier)
    a.sweep(1)
    a.sweep(2)
    b.sweep(3)
    assert_same(a, b)


@pytest.mark.parametrize("kind,tier", CASES)
def test_alpha_and_beta_changed_between_calls(kind, tier):
    """α and β (a Minka update's, or the caller's) reach the next call's
    sweeps through the graph's scalars."""
    a, b = build(kind, tier), build(kind, tier)
    for alpha, beta, n in ((0.5, 0.1, 1), (0.013, 0.71, 2), (0.2, 0.05, 1)):
        a.alpha = b.alpha = alpha
        a.beta = b.beta = beta
        a.sweep(n)
        b._eager_sweeps(n)
        assert_same(a, b)
    a.optimize_hyperparameters()
    b.optimize_hyperparameters()
    assert (a.alpha, a.beta) == (b.alpha, b.beta)
    a.sweep(2)
    b._eager_sweeps(2)
    assert_same(a, b)


@pytest.mark.parametrize("kind,tier", [("adlda", "deferred"), ("grid", False),
                                       ("token", "deferred"), ("chain", "deferred")])
def test_load_arrays_and_restore_between_calls(tmp_path, kind, tier):
    """A ``load_arrays`` and a checkpoint restore between calls are what
    the next replay sweeps from."""
    a, b = build(kind, tier), build(kind, tier)
    a.sweep(2)
    step = a.save_checkpoint(tmp_path / "ck")
    saved = a.arrays()
    a.sweep(2)  # the buffers move on past the checkpoint
    a.restore_checkpoint(tmp_path / "ck")
    assert a.sweeps_done == step == 2
    b.load_arrays(saved, sweep=2)
    b.generator.set_state(a.generator.get_state())
    a.sweep(2)
    b._eager_sweeps(2)
    assert_same(a, b)
    # the state another run reached, loaded into this runtime's graph
    c = build(kind, tier, seed=9)
    c.sweep(1)
    a.load_arrays(c.arrays(), sweep=c.sweeps_done)
    a.generator.set_state(c.generator.get_state())
    a.sweep(1)
    c._eager_sweeps(1)
    assert_same(a, c)


@pytest.mark.parametrize("kind,tier", CASES)
def test_handed_out_tables_unchanged_by_a_later_call(kind, tier):
    a = build(kind, tier)
    a.sweep(1)
    first = {name: {p: t.clone() for p, t in getattr(a, name).items()}
             for name in ("z", "ndk", "nwk", "nk")}
    held = {name: dict(getattr(a, name)) for name in first}
    a.sweep(2)
    for name, parts in held.items():
        for p, t in parts.items():
            assert torch.equal(t, first[name][p]), (name, p)
    assert any(not torch.equal(a.z[p], first["z"][p]) for p in a.z)


@pytest.mark.parametrize("kind,tier", CASES)
def test_replicas_share_one_tensor_after_a_call(kind, tier):
    """A table replicated over positions on one device is one tensor in the
    runtime's dicts after a call, as after the eager sweep."""
    a = build(kind, tier)
    a.sweep(1)
    for name, axes in a.SPEC.items():
        held = getattr(a, name)
        for p in a.positions:
            for q in a.positions:
                same = a._idx(p, axes) == a._idx(q, axes)
                assert (held[p] is held[q]) == same, (name, p, q)


@pytest.mark.parametrize("kind", ["adlda", "chain"])
def test_generator_state_after_n_sweeps_equals_eager(kind):
    a, b = build(kind, "deferred"), build(kind, "deferred")
    a.sweep(4)
    b._eager_sweeps(4)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_kernel_calls_per_sweep_equal_the_eager_sweep():
    """On the CPU the body calls the kernels' plain versions as the eager
    sweep does: per sweep one snapshot cast per distinct ``nwk``, one walk
    and one rebuild per position (here no warm-up: nothing is captured)."""
    a, b = build("grid", "deferred"), build("grid", "deferred")
    calls = []
    for model, run in ((a, a.sweep), (b, b._eager_sweeps)):
        before = tracing.counters()
        run(2)
        calls.append({n: c - before.get(n, 0) for n, c in tracing.counters().items()
                      if n.startswith(("launch.", "plain.")) and c != before.get(n, 0)})
    assert calls[0] == calls[1]
    assert not any(n.startswith("launch.") for n in calls[0])
    assert {n: c for n, c in calls[0].items()
            if n in ("plain.rebuild_counts", "plain.cast_mirror")} == {
        "plain.rebuild_counts": 8, "plain.cast_mirror": 4}


@pytest.mark.parametrize("kind,tier", [("adlda", False), ("adlda", "fused"),
                                       ("adlda", "deferred"), ("grid", False),
                                       ("grid", "deferred")])
def test_sweep_fn_seeded_by_seed_and_sweep_equals_eager(kind, tier):
    """``make_sharded_sweep_fn`` / ``make_grid_sweep_fn``'s ``run`` (the
    reference's jitted callable) replays the runtime's graph: seeded by
    ``(seed, sweep)``, bitwise the eager sweeps from the same inputs; the
    inputs stay as they were."""
    model = build(kind, tier)
    make = make_sharded_sweep_fn if kind == "adlda" else make_grid_sweep_fn
    args = dict(alpha=0.5, beta=0.1, block_size=model.block_size, num_sweeps=2,
                use_pallas=tier, num_topics=K, deferred_layout=model._layout)
    run = make(model.shards, model.mesh, **args)
    state = (model.z, model.ndk, model.nwk, model.nk)
    keep = [{p: t.clone() for p, t in d.items()} for d in state]
    out = run(*state, 5, 3, n_sweeps=1, alpha_v=0.3, beta_v=0.2)
    out = run(*out, 5, 4, n_sweeps=2)
    runtime = make(model.shards, model.mesh, **args).runtime  # driven eagerly
    runtime.z, runtime.ndk, runtime.nwk, runtime.nk = (dict(d) for d in state)
    runtime.sweep_idx, runtime.alpha, runtime.beta = 3, 0.3, 0.2
    runtime._eager_sweeps(1, seed=5)
    runtime.alpha, runtime.beta = 0.5, 0.1
    runtime._eager_sweeps(2, seed=5)
    for name, got in zip(("z", "ndk", "nwk", "nk"), out):
        for p in got:
            assert torch.equal(got[p], getattr(runtime, name)[p]), (name, p)
    for d, k in zip(state, keep):
        for p in d:
            assert torch.equal(d[p], k[p])


def test_psum_halves_give_psum_bits():
    """``local_sum`` (into a buffer or not) then ``reduce_across`` (nothing
    in one process) is ``psum``'s sum on every axis, float sums included
    (shard order, left to right)."""
    mesh = multihost.make_mesh({"data": 2, "vocab": 2}, [CPU] * 4)
    rng = np.random.default_rng(5)
    for dtype in (torch.int32, torch.float32):
        parts = {p: torch.from_numpy(rng.normal(size=33) * 1e3).to(dtype)
                 for p in range(4)}
        for axes in ("data", "vocab", ("data", "vocab")):
            want = multihost.psum(parts, mesh, axes)
            groups = multihost.local_groups(mesh, axes)
            assert sorted(p for g in groups for p in g.local) == [0, 1, 2, 3]
            for g in groups:
                assert not g.spans and g.local == g.positions
                total = multihost.local_sum([parts[p] for p in g.local])
                out = torch.empty_like(total)
                multihost.local_sum([parts[p] for p in g.local], out=out)
                multihost.reduce_across(out, g)
                for p in g.local:
                    assert torch.equal(want[p], total) and torch.equal(want[p], out)
    one = {0: torch.arange(4)}
    assert multihost.local_sum([one[0]]) is one[0]  # one part: no copy


@pytest.mark.parametrize("kind,tier", [("adlda", "deferred"), ("adlda", False),
                                       ("token", "deferred")])
def test_a_spanning_group_splits_the_graph_at_its_all_reduce(monkeypatch, kind, tier):
    """With the other half of each group in another process, a sweep is
    the graph before the reduction, the ``all_reduce`` on the host, and the
    graph after: one host step per spanning group, two graph launches a
    sweep (the process here holds position 0 of a two-process mesh; the
    reduction is recorded, not run)."""
    monkeypatch.setattr(multihost, "world", lambda: (0, 2))
    reduced = []
    monkeypatch.setattr(multihost, "reduce_across",
                        lambda total, group: reduced.append((total.shape, group.procs)))
    cls = {"adlda": ShardedLda, "token": TokenShardedLda}[kind]
    mesh = multihost.make_mesh({"data": 2}, [CPU] * 2, ranks=[0, 1])
    cfg = LdaConfig(topic_num=K, block_size=256, seed=1, use_pallas=tier)
    model = cls(cfg, corpus(), mesh=mesh, device="cpu")
    assert model.positions == [0]
    model.sweep(2)
    per_sweep = len(model._reconcile_rules()) - (tier == "deferred")
    assert len(reduced) == 2 * per_sweep and {r[1] for r in reduced} == {(0, 1)}
    assert model.graph.launches == 2
    assert [seg.device for seg in model.graph._segments] == [CPU, None, CPU]


def test_changed_alpha_reaches_a_sweep_fn_graph_built_earlier():
    """``run(..., alpha_v=...)`` at one call and the default at the next:
    each call writes its own α and β to the graph's scalars."""
    model = build("adlda", "deferred")
    run = make_sharded_sweep_fn(model.shards, model.mesh, alpha=0.5, beta=0.1,
                                block_size=256, num_topics=K,
                                deferred_layout=model._layout)
    state = (model.z, model.ndk, model.nwk, model.nk)
    a = run(*run(*state, 2, 0, alpha_v=0.9), 2, 1)
    b = run(*run(*state, 2, 0), 2, 1)
    assert any(not torch.equal(a[0][p], b[0][p]) for p in a[0])

