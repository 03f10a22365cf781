"""CVB0's sweep in one dispatch (``backends/cvb0.py`` on ``ops/graphs.SweepGraph``)
and its fixed-order scatter (``ops/cvb0_scatter.py``) on the CPU, where the
captured sweep's body runs eagerly on the graph's buffers and the scatter
runs its plain version.

- ``scatter_plan`` against a per-block loop over numpy's stable argsort and
  its runs of equal ids: doc-major document ids (the identity but for the
  padded last block), ``sort_blocks`` word ids, a block of one id only, and
  random ids.
- The plain scatter bitwise a serial ``table[i] += row`` loop in token order,
  and within rel 1e-6 of the JAX package's ``.at[i].add(r)``; the wrapper
  along a plan bitwise the plain version block by block.
- The model's ``sweep`` bitwise the eager ``cvb0_sweep`` loop; against the
  JAX package's ``cvb0_sweeps`` from the same ``gamma0``: γ atol 1e-5,
  counts rel 1e-4 (float32 sums in another order of additions), for
  ``sort_blocks`` False and True; chunked calls, a state set between calls
  and a restored checkpoint bitwise the uninterrupted run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu.backends.cvb0 import Cvb0Model as JaxCvb0Model
from ldagibbssampling_tpu.backends.cvb0 import cvb0_sweeps as jax_cvb0_sweeps
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model, cvb0_sweeps
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.ops.cvb0_scatter import (
    cvb0_scatter, cvb0_scatter_plain, scatter_plan)
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TABLES = ("gamma", "ndk", "nwk", "nk")


def _ragged(seed, num_docs=30, vocab=50, lo=5, hi=40):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(lo, hi)))]
            for _ in range(num_docs)]


def _expected_plan(ids, block):
    """The plan by a loop over blocks: numpy's stable argsort of each block,
    then its runs of equal ids."""
    order, bounds, dest, block_runs = [], [], [], [0]
    for b in range(len(ids) // block):
        blk = ids[b * block:(b + 1) * block]
        o = np.argsort(blk, kind="stable")
        s = blk[o]
        for i in range(block):
            if i == 0 or s[i] != s[i - 1]:
                bounds.append(b * block + i)
                dest.append(s[i])
        order.append(o)
        block_runs.append(len(dest))
    bounds.append(len(ids))
    return np.concatenate(order), np.array(bounds), np.array(dest), tuple(block_runs)


def _plan_ids(case):
    fc = FlatCorpus.from_ragged(_ragged(3), vocab_size=50)
    pc = fc.pad_to(64)
    if case == "doc_major":
        return pc.token_doc, 64
    if case == "sort_blocks":
        return pc.sort_within_blocks(64)[0].token_word, 64
    if case == "one_id":
        return np.concatenate([np.full(32, 7), np.arange(32) % 5]).astype(np.int32), 32
    return np.random.default_rng(1).integers(0, 9, size=96).astype(np.int32), 24


@pytest.mark.parametrize("case", ["doc_major", "sort_blocks", "one_id", "random"])
def test_scatter_plan_is_each_blocks_stable_argsort_and_runs(case):
    ids, block = _plan_ids(case)
    plan = scatter_plan(ids, block, "cpu")
    order, bounds, dest, block_runs = _expected_plan(np.asarray(ids, np.int64), block)
    assert plan.order.dtype == plan.bounds.dtype == plan.dest.dtype == torch.int32
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(plan.bounds.numpy(), bounds)
    np.testing.assert_array_equal(plan.dest.numpy(), dest)
    assert plan.block_runs == block_runs and plan.num_blocks == len(ids) // block
    np.testing.assert_array_equal(plan.index.numpy(), ids)
    if case == "doc_major":  # sorted ids but the padded last block's zeros
        last = len(ids) - block
        np.testing.assert_array_equal(plan.order.numpy()[:last],
                                      np.arange(last) % block)
        assert (plan.order.numpy()[last:] != np.arange(block)).any()
    if case == "one_id":  # the first block is one run of 32
        assert plan.block_runs[1] == 1 and plan.dest[0] == 7
        assert int(plan.bounds[1] - plan.bounds[0]) == 32


@pytest.mark.parametrize("ids,block", [
    (np.arange(10), 4),           # not a multiple of the block
    (np.array([0, -1, 2, 3]), 2),  # a negative row
    (np.zeros(0, np.int64), 4),   # no token
])
def test_scatter_plan_refuses_what_it_cannot_order(ids, block):
    with pytest.raises(ValueError):
        scatter_plan(ids, block, "cpu")


@pytest.mark.parametrize("rows_n,table_n,k,seed", [(64, 9, 5, 0), (200, 3, 1, 1),
                                                   (128, 40, 17, 2)])
def test_plain_scatter_is_index_add_in_token_order(rows_n, table_n, k, seed):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, table_n, size=rows_n)
    rows = rng.uniform(0.0, 1.0, size=(rows_n, k)).astype(np.float32)
    start = rng.uniform(0.0, 3.0, size=(table_n, k)).astype(np.float32)
    table = torch.from_numpy(start.copy())
    before = tracing.counters().get("plain.cvb0_scatter", 0)
    cvb0_scatter_plain(table, torch.from_numpy(index), torch.from_numpy(rows))
    assert tracing.counters()["plain.cvb0_scatter"] == before + 1
    want = start.copy()
    for i, r in enumerate(index):  # one float32 add at a time, in token order
        want[r] = want[r] + rows[i]
    np.testing.assert_array_equal(table.numpy(), want)
    zeros = torch.zeros(table_n, k)
    cvb0_scatter_plain(zeros, torch.from_numpy(index), torch.from_numpy(rows))
    ref = np.asarray(jnp.zeros((table_n, k), jnp.float32).at[index].add(rows))
    np.testing.assert_allclose(zeros.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("case", ["doc_major", "sort_blocks", "random"])
def test_scatter_along_the_plan_is_the_plain_version_block_by_block(case):
    ids, block = _plan_ids(case)
    plan = scatter_plan(ids, block, "cpu")
    rng = np.random.default_rng(4)
    k, rows_n = 6, int(ids.max()) + 1
    start = torch.from_numpy(rng.normal(size=(rows_n, k)).astype(np.float32))
    got, want = start.clone(), start.clone()
    before = tracing.counters()
    for b in range(plan.num_blocks):
        rows = torch.from_numpy(rng.normal(size=(block, k)).astype(np.float32))
        cvb0_scatter(got, rows, plan, b)
        want.index_add_(0, torch.from_numpy(np.asarray(ids[b * block:(b + 1) * block],
                                                       np.int64)), rows)
    assert torch.equal(got, want)
    after = tracing.counters()
    # the CPU launches nothing
    assert after.get("launch.cvb0_scatter", 0) == before.get("launch.cvb0_scatter", 0)
    assert (after["plain.cvb0_scatter"]
            == before.get("plain.cvb0_scatter", 0) + plan.num_blocks)


@pytest.mark.parametrize("case", ["float64", "rows_shape", "strided", "block"])
def test_scatter_refuses_what_the_kernel_does_not_take(case):
    plan = scatter_plan(np.arange(8) % 3, 4, "cpu")
    table, rows, block = torch.zeros(3, 5), torch.ones(4, 5), 0
    if case == "float64":
        table = table.double()
    elif case == "rows_shape":
        rows = torch.ones(4, 6)
    elif case == "strided":
        rows = torch.ones(5, 4).t()
    else:
        block = 2
    with pytest.raises(ValueError):
        cvb0_scatter(table, rows, plan, block)


def _model(sort_blocks=False, seed=1, k=5, block=64, **kw):
    fc = FlatCorpus.from_ragged(_ragged(seed), vocab_size=50)
    cfg = LdaConfig(topic_num=k, backend="cvb0", block_size=block, seed=seed,
                    sort_blocks=sort_blocks)
    return fc, cfg, Cvb0Model(cfg, fc, device="cpu", **kw)


def _eager(model, tables, n):
    """``n`` eager sweeps from copies of ``tables``."""
    out = [t.clone() for t in tables]
    cvb0_sweeps(*out, model._tw, model._td, model._tm, model._plans, n,
                alpha=model.config.alpha, beta=model.config.beta,
                block_size=model.block_size)
    return out


@pytest.mark.parametrize("sort_blocks", [False, True])
def test_model_sweep_is_the_eager_sweep_bitwise(sort_blocks):
    _, _, model = _model(sort_blocks)
    start = model._tables()
    want = _eager(model, start, 3)
    model.sweep(3)
    assert model.sweeps_done == 3
    for name, w in zip(TABLES, want):
        assert torch.equal(getattr(model, name), w), name
    assert all(torch.equal(a, b) for a, b in zip(start, _eager(model, start, 0)))


@pytest.mark.parametrize("sort_blocks", [False, True])
def test_model_matches_the_reference_cvb0_sweeps(sort_blocks):
    ragged = _ragged(2)
    kw = dict(topic_num=5, backend="cvb0", block_size=64, seed=4,
              sort_blocks=sort_blocks)
    ref = JaxCvb0Model(JaxLdaConfig(**kw), JaxFlatCorpus.from_ragged(ragged, vocab_size=50))
    port = Cvb0Model(LdaConfig(**kw), FlatCorpus.from_ragged(ragged, vocab_size=50),
                     device="cpu", gamma0=np.asarray(ref.gamma))
    want = jax_cvb0_sweeps(ref.gamma, ref.ndk, ref.nwk, ref.nk, ref._tw, ref._td,
                           ref._tm, jnp.int32(3), alpha=ref.config.alpha,
                           beta=ref.config.beta, block_size=ref.block_size,
                           sorted_words=ref._sorted)
    port.sweep(2)
    port.sweep(1)
    np.testing.assert_allclose(port.gamma.numpy(), np.asarray(want[0]), atol=1e-5)
    for name, w in zip(TABLES[1:], want[1:]):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    port.check_invariants()


@pytest.mark.parametrize("chunks", [(1, 2), (2, 1, 3)])
def test_chunked_calls_equal_one_call(chunks):
    _, _, a = _model(seed=5)
    _, _, b = _model(seed=5)
    for n in chunks:
        a.sweep(n)
    b.sweep(sum(chunks))
    assert a.sweeps_done == b.sweeps_done == sum(chunks)
    for name in TABLES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_a_state_set_between_calls_is_copied_in():
    """Tensors set on the model between calls (as ``interop.from_jax_cvb0``
    or a restore sets them) are what the next call starts from; the tensors
    a call handed out never change under a later call."""
    fc, _, model = _model(seed=6)
    other = Cvb0Model(LdaConfig(topic_num=5, backend="cvb0", block_size=64, seed=7),
                      fc, device="cpu")
    model.sweep(1)
    handed = [t.clone() for t in model._tables()]
    kept = model._tables()
    other.sweep(2)
    model.gamma, model.ndk, model.nwk, model.nk = (t.clone() for t in other._tables())
    want = _eager(model, other._tables(), 2)
    model.sweep(2)
    for name, w in zip(TABLES, want):
        assert torch.equal(getattr(model, name), w), name
    assert all(torch.equal(a, b) for a, b in zip(kept, handed))


def test_restored_checkpoint_continues_bitwise(tmp_path):
    _, cfg, ref = _model(sort_blocks=True, seed=8)
    ref.sweep(4)
    fc, cfg, a = _model(sort_blocks=True, seed=8)
    a.sweep(2)
    assert a.save_checkpoint(tmp_path) == 2
    b = Cvb0Model(cfg, fc, device="cpu")
    b.sweep(1)  # the restore replaces a state the graph holds
    assert b.restore_checkpoint(tmp_path) == 2
    b.sweep(2)
    assert b.sweeps_done == 4
    for name in TABLES:
        assert torch.equal(getattr(b, name), getattr(ref, name)), name


def test_sweeps_of_nothing_and_a_deterministic_graph():
    """``sweep(0)`` leaves the state alone; CVB0's graph draws nothing: it
    takes no seeds and no noise, and refuses a call of no sweep."""
    _, _, model = _model(seed=9)
    before = model._tables()
    model.sweep(0)
    assert model.sweeps_done == 0 and model._tables() == before
    graph = model.graph
    assert isinstance(graph, SweepGraph) and graph.noise_mode == "deterministic"
    assert graph.generators == [] and not graph.device_seeds
    out = graph(before, model.config.alpha, model.config.beta, 1)
    assert all(torch.equal(a, b) for a, b in zip(out, _eager(model, before, 1)))
    with pytest.raises(ValueError, match="at least one"):
        graph(before, model.config.alpha, model.config.beta, 0)
