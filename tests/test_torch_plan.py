"""The port's deferred layout against the JAX package's: every plan array,
the row tile and the doc slabs must be equal (exact; they are integer
layouts computed by copied numpy code)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ldagibbssampling_tpu.corpus.flat import PaddedCorpus as JaxPaddedCorpus
from ldagibbssampling_tpu.ops import count_kernel as jax_ck
from ldagibbssampling_tpu.ops.gibbs import _pick_row_tile as jax_pick_row_tile
from ldagibbssampling_tpu_torch.corpus.flat import PaddedCorpus
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


@pytest.mark.parametrize("seed,kw", [
    (0, dict(v_loc=64, tile=128)),
    (1, dict()),
    (2, dict(v_loc=128, tile=256)),
])
def test_plan_deferred_equals_reference(seed, kw):
    tw, td = _corpus(seed)
    _assert_plans_equal(ck.plan_deferred(tw, td, V, BLOCK, **kw),
                        jax_ck.plan_deferred(tw, td, V, BLOCK, **kw))


def test_plan_deferred_rejects_like_reference():
    tw, td = _corpus(3, t_target=1294)
    for mod in (ck, jax_ck):
        with pytest.raises(ValueError, match="multiple-of-8 tile"):
            mod.plan_deferred(tw, td, V, 1294)


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
