"""CVB0's scatter's work units (``ops/cvb0_scatter.scatter_plan``'s
``units`` and ``block_units``) on the CPU, at small sizes.

- The units of every block cover each of its runs exactly once, and with
  ``scatter_slabs(k)`` each (run, topic column) exactly once; a unit is a
  span of whole runs of one block, at most ``UNIT_ROWS`` rows but for one
  run alone, a run of more than ``SHORT_RUN`` rows is alone, and each run's
  rows are in ascending token order; the units with the longest runs come
  first.
- The edges: a run of exactly ``SHORT_RUN`` rows (packed) and one more
  (alone), a run of exactly ``UNIT_ROWS`` (not streamed) and one more
  (streamed), a block that is one run, the padded last block, K = 1 and a
  K that the slab does not divide.
- A slow emulator walks the units in the kernel's order (unit, slab, run,
  a streamed run in chunks of its ring), one float32 add at a time in
  numpy: bitwise the CPU's serial ``index_add_``, and within rel 1e-6 of
  the JAX package's ``.at[i].add(r)`` (float32 sums in another order).
- The kernel's geometry in ``csrc/cvb0_scatter.cu`` is the plan's.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.ops import _build
from ldagibbssampling_tpu_torch.ops.cvb0_scatter import (
    SHORT_RUN, SLAB_COLS, UNIT_ROWS, scatter_plan, scatter_slabs)

torch.set_num_threads(1)

CHUNK = 64  # csrc/cvb0_scatter.cu's kChunk: rows per stage of a streamed run


def _ids(case):
    """(ids, block size) of one case."""
    rng = np.random.default_rng(3)
    if case == "zipf":  # a skewed word stream: long runs among short ones
        return (rng.zipf(1.1, size=4 * 1024) - 1) % 300, 1024
    if case == "doc_major_padded":  # sorted ids, the last block's padding zeros
        ids = np.sort(rng.integers(0, 12, size=3 * 1024 - 300))
        return np.concatenate([ids, np.zeros(300, np.int64)]), 1024
    if case == "one_run":  # a block that is one run, then a mixed one
        return np.concatenate([np.full(1024, 5), rng.integers(0, 40, size=1024)]), 1024
    if case == "thresholds":  # runs of SHORT_RUN, SHORT_RUN + 1, UNIT_ROWS, + 1
        lens = [3, SHORT_RUN, SHORT_RUN + 1, 1, UNIT_ROWS, 2, UNIT_ROWS + 1]
        ids = np.repeat(np.arange(len(lens)), lens)
        ids = np.concatenate([ids, np.full(1024 - len(ids), 40)])
        return rng.permutation(ids), 1024  # the plan sorts them back
    return rng.integers(0, 7, size=96), 24


CASES = ["zipf", "doc_major_padded", "one_run", "thresholds", "small"]


def _runs(plan):
    return plan.bounds.numpy().astype(np.int64), plan.dest.numpy()


@pytest.mark.parametrize("case", CASES)
def test_units_cover_each_run_once_in_whole_spans(case):
    ids, block = _ids(case)
    plan = scatter_plan(ids, block, "cpu")
    bounds, _ = _runs(plan)
    units = plan.units.numpy()
    assert plan.units.dtype == torch.int32 and units.shape[1] == 4
    assert len(plan.block_units) == plan.num_blocks + 1
    assert plan.block_units[0] == 0 and plan.block_units[-1] == len(units)
    for b in range(plan.num_blocks):
        mine = units[plan.block_units[b]:plan.block_units[b + 1]]
        assert len(mine) >= 1
        seen = np.zeros(plan.block_runs[b + 1] - plan.block_runs[b], int)
        for r0, r1, p0, p1 in mine:
            assert plan.block_runs[b] <= r0 < r1 <= plan.block_runs[b + 1]
            assert (p0, p1) == (bounds[r0], bounds[r1])
            lengths = np.diff(bounds[r0:r1 + 1])
            if r1 - r0 > 1:  # packed: short runs, fewer than UNIT_ROWS rows
                assert lengths.max() <= SHORT_RUN and p1 - p0 < UNIT_ROWS
            seen[r0 - plan.block_runs[b]:r1 - plan.block_runs[b]] += 1
        assert (seen == 1).all()
        longest = [np.diff(bounds[r0:r1 + 1]).max() for r0, r1, _, _ in mine]
        assert longest == sorted(longest, reverse=True)  # longest first


@pytest.mark.parametrize("k", [1, 15, 17, 37, 70, 500])
def test_slabs_cover_each_column_once(k):
    slabs = scatter_slabs(k)
    cols = np.concatenate([np.arange(c, c + w) for c, w in slabs])
    np.testing.assert_array_equal(cols, np.arange(k))
    assert all(w == SLAB_COLS for _, w in slabs[:-1]) and 0 < slabs[-1][1] <= SLAB_COLS
    ids, block = _ids("zipf")
    plan = scatter_plan(ids, block, "cpu")
    bounds, _ = _runs(plan)
    cells = np.zeros((len(bounds) - 1, k), int)
    for r0, r1, _, _ in plan.units.numpy():  # one CTA per (unit, slab)
        for c, w in slabs:
            cells[r0:r1, c:c + w] += 1
    assert (cells == 1).all()


@pytest.mark.parametrize("case", CASES)
def test_each_runs_rows_ascend_in_token_order(case):
    ids, block = _ids(case)
    plan = scatter_plan(ids, block, "cpu")
    bounds, dest = _runs(plan)
    order = plan.order.numpy()
    for r0, r1, _, _ in plan.units.numpy():
        for r in range(r0, r1):
            rows = order[bounds[r]:bounds[r + 1]]
            assert (np.diff(rows) > 0).all()
            b = bounds[r] // block
            assert (ids[b * block + rows] == dest[r]).all()


def test_threshold_edges():
    ids, block = _ids("thresholds")
    plan = scatter_plan(ids, block, "cpu")
    bounds, dest = _runs(plan)
    unit_of = {}
    for u, (r0, r1, _, _) in enumerate(plan.units.numpy()):
        for r in range(r0, r1):
            unit_of[int(dest[r])] = (u, r1 - r0, bounds[r1] - bounds[r0])
    # SHORT_RUN rows: packed with the run before it
    assert unit_of[1][0] == unit_of[0][0] and unit_of[1][1:] == (2, SHORT_RUN + 3)
    assert unit_of[2][1] == 1  # SHORT_RUN + 1: alone
    assert unit_of[4][1:] == (1, UNIT_ROWS)  # alone, staged at once
    assert unit_of[6][1:] == (1, UNIT_ROWS + 1)  # alone, streamed
    # the longest first: the run of UNIT_ROWS + 1
    first = plan.units.numpy()[0]
    assert first[3] - first[2] == max(np.diff(bounds))


def _emulate(table, rows, plan, block, k):
    """The kernel's walk of block ``block`` in numpy: per unit and slab, per
    run, the table's slab then each row's slab added in plan order, one
    float32 add per cell (a streamed run chunk by chunk, as its ring)."""
    out = table.copy()
    bounds, dest = _runs(plan)
    order = plan.order.numpy()
    units = plan.units.numpy()[plan.block_units[block]:plan.block_units[block + 1]]
    # a lone run of more rows streams: more than UNIT_ROWS // 2 where the
    # table has several slabs
    stream_rows = UNIT_ROWS // 2 if len(scatter_slabs(k)) > 1 else UNIT_ROWS
    for r0, r1, p0, p1 in units:
        streamed = r1 - r0 == 1 and p1 - p0 > stream_rows
        for c, w in scatter_slabs(k):
            for r in range(r0, r1):
                acc = out[dest[r], c:c + w].copy()
                span = range(bounds[r], bounds[r + 1])
                chunks = ([span[i:i + CHUNK] for i in range(0, len(span), CHUNK)]
                          if streamed else [span])
                for chunk in chunks:
                    for j in chunk:
                        acc = acc + rows[order[j], c:c + w]
                out[dest[r], c:c + w] = acc
    return out


@pytest.mark.parametrize("case,k", [("zipf", 37), ("doc_major_padded", 1),
                                    ("one_run", 17), ("thresholds", 70),
                                    ("small", 5), ("zipf", 500)])
def test_emulated_kernel_is_index_add_bitwise(case, k):
    ids, block = _ids(case)
    if k == 500:  # one block at the widest K
        ids, block = ids[:block], block
    plan = scatter_plan(ids, block, "cpu")
    rng = np.random.default_rng(k)
    n_rows = int(ids.max()) + 1
    start = rng.uniform(0.0, 3.0, size=(n_rows, k)).astype(np.float32)
    got, want = start.copy(), torch.from_numpy(start.copy())
    ref = jnp.asarray(start)
    for b in range(plan.num_blocks):
        rows = rng.uniform(0.0, 1.0, size=(block, k)).astype(np.float32)
        got = _emulate(got, rows, plan, b, k)
        index = np.asarray(ids[b * block:(b + 1) * block], np.int64)
        want.index_add_(0, torch.from_numpy(index), torch.from_numpy(rows))
        ref = ref.at[index].add(rows)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6)


def test_emulator_on_a_corpus_plan_by_word_and_by_document():
    """Both of a CVB0 model's plans (``token_doc``, ``token_word``) of a
    padded corpus, blocks of 512: the emulator bitwise ``index_add_``."""
    rng = np.random.default_rng(8)
    ragged = [[int(x) for x in (rng.zipf(1.3, size=int(rng.integers(20, 300))) - 1) % 80]
              for _ in range(12)]
    pc = FlatCorpus.from_ragged(ragged, vocab_size=80).pad_to(512)
    k = 40
    for ids, n_rows in ((pc.token_doc, pc.num_docs), (pc.token_word, pc.vocab_size)):
        plan = scatter_plan(ids, 512, "cpu")
        start = rng.normal(size=(n_rows, k)).astype(np.float32)
        got, want = start.copy(), torch.from_numpy(start.copy())
        for b in range(plan.num_blocks):
            rows = rng.normal(size=(512, k)).astype(np.float32)
            got = _emulate(got, rows, plan, b, k)
            want.index_add_(0, torch.from_numpy(
                np.asarray(ids[b * 512:(b + 1) * 512], np.int64)), torch.from_numpy(rows))
        np.testing.assert_array_equal(got, want.numpy())


def test_the_kernels_geometry_is_the_plans():
    src = (_build.CSRC / "cvb0_scatter.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kUnitRows") == UNIT_ROWS and const("kSlabCols") == SLAB_COLS
    assert const("kChunk") == CHUNK and SHORT_RUN == UNIT_ROWS // 2
