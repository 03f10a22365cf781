"""The port's streaming (``data/stream.py``) against the JAX package's: the
same seed gives the same minibatches, and ``prefetch_to_device`` hands the
batches over in order (on the CPU it passes them through as tensors; a
``cuda`` request without CUDA raises)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.data.stream import BowStream as JaxBowStream
from ldagibbssampling_tpu.data.stream import minibatch_indices as jax_minibatch_indices
from ldagibbssampling_tpu_torch.data.stream import (
    BowStream, minibatch_indices, prefetch_to_device)


@pytest.mark.parametrize("num_items,batch,drop", [
    (37, 8, False), (37, 8, True), (64, 16, False), (5, 8, False)])
def test_minibatch_indices_equal_reference(num_items, batch, drop):
    got = list(minibatch_indices(num_items, batch, np.random.default_rng(3), drop))
    want = list(jax_minibatch_indices(num_items, batch, np.random.default_rng(3),
                                      drop))
    assert len(got) == len(want) > 0 or drop
    for (idx, real), (idx_ref, real_ref) in zip(got, want):
        np.testing.assert_array_equal(idx, idx_ref)
        assert real == real_ref and idx.shape == (batch,)


def test_bow_stream_equals_reference():
    bow = np.random.default_rng(1).poisson(0.5, size=(21, 6)).astype(np.float32)
    got, want = BowStream(bow, 4, seed=9), JaxBowStream(bow, 4, seed=9)
    for _ in range(2):  # the generator carries across epochs
        for (i, b, r), (i_ref, b_ref, r_ref) in zip(got.epoch(), want.epoch()):
            np.testing.assert_array_equal(i, i_ref)
            np.testing.assert_array_equal(b, b_ref)
            assert r == r_ref


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_order_on_the_cpu(depth):
    batches = [(np.full((2, 3), i, np.float32), {"idx": np.arange(i, i + 2)})
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), depth=depth, device="cpu"))
    assert len(out) == 7
    for i, (x, meta) in enumerate(out):
        assert torch.is_tensor(x) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(meta["idx"], torch.arange(i, i + 2))


def test_prefetch_rejects_bad_depth_and_missing_cuda(monkeypatch):
    with pytest.raises(ValueError, match="depth"):
        list(prefetch_to_device([np.zeros(2)], depth=0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(prefetch_to_device([np.zeros(2)]))
