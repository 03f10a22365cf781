"""The port's deferred layout against the JAX package's: every plan array
and dtype, the row tile and the doc slabs must be equal (exact; they are
integer layouts).  ``plan_deferred`` is the host C++ planner
(``csrc/deferred_plan.cc``, built by ``g++`` at first use), held against the
reference's numpy planner and against the port's verbatim copy of it,
``plan_deferred_plain``."""

from __future__ import annotations

import dataclasses
import re
import stat

import numpy as np
import pytest

from ldagibbssampling_tpu.corpus.flat import PaddedCorpus as JaxPaddedCorpus
from ldagibbssampling_tpu.ops import count_kernel as jax_ck
from ldagibbssampling_tpu.ops.gibbs import _pick_row_tile as jax_pick_row_tile
from ldagibbssampling_tpu_torch.benchmarks import ladder
from ldagibbssampling_tpu_torch.corpus.flat import PaddedCorpus
from ldagibbssampling_tpu_torch.ops import _build
from ldagibbssampling_tpu_torch.ops import count_kernel as ck
from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

V = 300
BLOCK = 512


def _corpus(seed=0, num_docs=60, vocab=V, t_target=4000):
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, size=t_target).astype(np.int64)
    tw = ((raw - 1) % vocab).astype(np.int32)
    td = (np.arange(t_target, dtype=np.int64) * num_docs // t_target).astype(np.int32)
    return tw, td


def _assert_plans_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _max_shrinks(tw, block, v_loc):
    """The most times the reference's pass 1 shrinks one block."""
    most, pos = 0, 0
    while pos < tw.shape[0]:
        n, shrinks = min(block, tw.shape[0] - pos), 0
        while True:
            runs = np.bincount(tw[pos:pos + n] // v_loc, minlength=1)
            padded = int(((runs + 7) // 8 * 8).sum())
            if padded <= block:
                break
            n, shrinks = n - (padded - block), shrinks + 1
            assert n > 0, "block_size too small for stripe alignment"
        most, pos = max(most, shrinks), pos + n
    return most


def _sparse():
    # V = 100,000 and 3,000 tokens: blocks of hundreds of stripes, most runs
    # one or two real tokens and their pads
    rng = np.random.default_rng(7)
    tw = rng.integers(0, 100_000, size=3000).astype(np.int32)
    td = np.sort(rng.integers(0, 40, size=3000)).astype(np.int32)
    return tw, td, 100_000, 4096, {}


def _rung3():
    corpus, _, _, _ = ladder.rung3_corpus(0.02)
    return corpus.token_word, corpus.token_doc, corpus.vocab_size, 65_536, {}


def _shrinks_twice():
    # a candidate block whose tail alternates two stripes: cutting the
    # overshoot frees no slot the first time, so pass 1 shrinks again; then
    # at most 8 stripes, so that every block fits
    rng = np.random.default_rng(8)
    head = np.array([4] + [0, 8] * 40, np.int32)
    tw = np.concatenate([head, rng.integers(0, 32, size=600).astype(np.int32)])
    td = (np.arange(tw.shape[0]) // 30).astype(np.int32)
    assert _max_shrinks(tw, 64, 4) >= 2
    return tw, td, 40, 64, dict(v_loc=4)


def _hot_word():
    # word 5 is two thirds of the corpus: it fills several blocks alone
    rng = np.random.default_rng(9)
    tw = np.where(rng.random(3000) < 2 / 3, 5,
                  rng.integers(0, V, size=3000)).astype(np.int32)
    td = (np.arange(3000) // 50).astype(np.int32)
    assert np.bincount(tw).max() > 2 * BLOCK
    return tw, td, V, BLOCK, {}


def _existing(seed, kw):
    return lambda: (*_corpus(seed), V, BLOCK, kw)


PLAN_CASES = {  # the first three keep their earlier test ids
    "0-kw0": _existing(0, dict(v_loc=64, tile=128)),
    "1-kw1": _existing(1, dict()),
    "2-kw2": _existing(2, dict(v_loc=128, tile=256)),
    "sparse-V100000": _sparse,
    "rung3-0.02": _rung3,
    "empty": lambda: (np.zeros(0, np.int32), np.zeros(0, np.int32), 50, 512, {}),
    "one-token": lambda: (np.array([7], np.int32), np.array([0], np.int32), 50, 512, {}),
    "shrinks-twice": _shrinks_twice,
    "hot-word": _hot_word,
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_deferred_equals_reference(case):
    tw, td, vocab, block, kw = PLAN_CASES[case]()
    _assert_plans_equal(ck.plan_deferred(tw, td, vocab, block, **kw),
                        jax_ck.plan_deferred(tw, td, vocab, block, **kw))


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_deferred_plain_equals_native(case):
    tw, td, vocab, block, kw = PLAN_CASES[case]()
    _assert_plans_equal(ck.plan_deferred_plain(tw, td, vocab, block, **kw),
                        ck.plan_deferred(tw, td, vocab, block, **kw))


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_plan_does_not_depend_on_the_thread_count(threads):
    for case in ("1-kw1", "sparse-V100000", "hot-word"):
        tw, td, vocab, block, kw = PLAN_CASES[case]()
        kw = {"v_loc": 128, "tile": 2048, **kw}
        _assert_plans_equal(
            ck._plan_native(tw, td, vocab, block, threads=threads, **kw),
            jax_ck.plan_deferred(tw, td, vocab, block, **kw))


def _rejects_like_reference(tw, td, block, kw, message):
    for plan in (ck.plan_deferred, ck.plan_deferred_plain, jax_ck.plan_deferred):
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            plan(tw, td, V, block, **kw)


def test_plan_deferred_rejects_like_reference():
    tw, td = _corpus(3, t_target=1294)
    _rejects_like_reference(tw, td, 1294, {},
                            "block_size 1294 has no multiple-of-8 tile <= requested")


def test_plan_deferred_rejects_a_block_too_small_like_reference():
    # two stripes in the first 8 tokens need 16 slots of a block of 8
    tw = np.array([0, 4] * 8, np.int32)
    _rejects_like_reference(tw, np.zeros_like(tw), 8, dict(v_loc=4),
                            "block_size too small for stripe alignment")


@pytest.mark.parametrize("word,error", [(-1, ValueError), (V + 100, IndexError)])
def test_plan_deferred_rejects_out_of_range_words_like_reference(word, error):
    tw, td = _corpus(10)
    tw[100] = word
    for plan in (ck.plan_deferred, jax_ck.plan_deferred):
        with pytest.raises(error):
            plan(tw, td, V, BLOCK)


def _no_fallback(monkeypatch):
    def plain(*args, **kw):
        raise AssertionError("plan_deferred fell back to the numpy planner")
    monkeypatch.setattr(ck, "plan_deferred_plain", plain)


def test_planner_that_does_not_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: plan_deferred raises with its error."""
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'deferred_plan.cc:1: error: no compiler here' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    _no_fallback(monkeypatch)
    tw, td = _corpus(11)
    with pytest.raises(RuntimeError, match="error: no compiler here"):
        ck.plan_deferred(tw, td, V, BLOCK)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot build deferred_plan.cc"):
        ck.plan_deferred(tw, td, V, BLOCK)


def test_planner_that_does_not_load_raises(tmp_path, monkeypatch):
    """A library file that is not a library: plan_deferred raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build._lib_path("deferred_plan", ".cc", _build.HOST_FLAGS)[1]
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not a shared object")
    _no_fallback(monkeypatch)
    tw, td = _corpus(12)
    with pytest.raises(RuntimeError, match="cannot load libdeferred_plan-"):
        ck.plan_deferred(tw, td, V, BLOCK)


def test_stack_plans_equals_reference():
    plans, refs = [], []
    for seed, t in ((4, 3000), (5, 2200)):
        tw, td = _corpus(seed, t_target=t)
        plans.append(ck.plan_deferred(tw, td, V, BLOCK, v_loc=64, tile=128))
        refs.append(jax_ck.plan_deferred(tw, td, V, BLOCK, v_loc=64, tile=128))
    got, want = ck.stack_plans(plans), jax_ck.stack_plans(refs)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("num_topics", [7, 100, 500, 1000, 3000])
def test_pick_row_tile_equals_reference(num_topics):
    for block in (8, 64, 128, 512, 600, 1294, 1296, 2048, 32768, 65536):
        assert _pick_row_tile(block, num_topics) == jax_pick_row_tile(block, num_topics)


@pytest.mark.parametrize("block,multiple", [(512, 128), (512, 8), (1024, 128)])
def test_doc_slabs_equal_reference(block, multiple):
    tw, td = _corpus(6)
    plan = ck.plan_deferred(tw, td, V, block)
    args = dict(token_word=plan.token_word, token_doc=plan.token_doc,
                token_mask=plan.token_mask, num_real_tokens=tw.shape[0],
                vocab_size=V, num_docs=60)
    got = PaddedCorpus(**args).doc_slabs(block, d_loc_multiple=multiple)
    want = JaxPaddedCorpus(**args).doc_slabs(block, d_loc_multiple=multiple)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
