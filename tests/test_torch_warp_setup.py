"""WarpLDA's set-up on the CPU (``backends/warp.py``): the word-major CSR
and the sweep's per-token arrays, built with torch on the model's device
from the padded stream, against a numpy builder kept here (the host build
the port had before it sorted on the device: numpy's stable ``argsort``,
``bincount`` and gathers on the host) and against the JAX package's
``word_csr``.  Bitwise, dtypes included, on corpora with padding and
without, with words that have no tokens, with one word holding every
token, and with documents of one token.  The same build on the card is in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.backends.warp import word_csr as jax_word_csr
from ldagibbssampling_tpu_torch.backends.warp import WarpModel, word_csr
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

DTYPES = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}


def _random(seed=0, docs=30, vocab=50):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(5, 40)))]
            for _ in range(docs)], vocab


def _sparse_vocab():
    """Words 0 and 40-59 have no token (padding takes word 0)."""
    rng = np.random.default_rng(1)
    return [[int(x) for x in rng.integers(1, 40, size=int(rng.integers(3, 30)))]
            for _ in range(25)], 60


def _one_word():
    return [[7] * n for n in (5, 1, 12, 3)], 10


def _one_token_docs():
    rng = np.random.default_rng(2)
    lengths = [1, 9, 1, 1, 17, 4, 1]
    return [[int(x) for x in rng.integers(0, 20, size=n)] for n in lengths], 20


CORPORA = {"padded": (_random, 128), "unpadded": (_random, 10**6),
           "empty_words": (_sparse_vocab, 64), "one_word": (_one_word, 16),
           "one_token_docs": (_one_token_docs, 32)}


def _model(name, seed=0):
    make, block = CORPORA[name]
    ragged, vocab = make()
    fc = FlatCorpus.from_ragged(ragged, vocab_size=vocab)
    cfg = LdaConfig(backend="warp", topic_num=5, block_size=block, seed=seed)
    return WarpModel(cfg, fc, device="cpu")


def _numpy_build(pc, doc_lengths):
    """The host build: numpy's stable sort by word, the word pointers from
    a ``bincount`` and every per-token array gathered on the host, each in
    the dtype the sweep takes."""
    real = pc.token_mask > 0
    sort_key = np.where(real, pc.token_word.astype(np.int64), pc.vocab_size)
    perm_w = np.argsort(sort_key, kind="stable").astype(np.int32)
    counts = np.bincount(pc.token_word[real], minlength=pc.vocab_size)
    word_ptr = np.zeros(pc.vocab_size + 1, dtype=np.int32)
    np.cumsum(counts, out=word_ptr[1:])
    doc_ptr = np.zeros(pc.num_docs + 1, dtype=np.int64)
    np.cumsum(doc_lengths, out=doc_ptr[1:])
    word_count = np.diff(word_ptr)
    tw, td = pc.token_word.astype(np.int64), pc.token_doc.astype(np.int64)
    return perm_w, word_ptr, dict(
        token_word=tw, token_doc=td, token_mask=pc.token_mask.astype(np.int32),
        doc_start=doc_ptr[td], word_start=word_ptr[tw].astype(np.int64),
        nd_tok=doc_lengths[td].astype(np.float32),
        nw_tok=word_count[tw].astype(np.float32),
        perm_w=perm_w.astype(np.int64))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_word_csr_is_the_numpy_and_jax_sort(name):
    pc = _model(name)._padded
    perm_w, word_ptr = word_csr(torch.from_numpy(pc.token_word), pc.vocab_size,
                                torch.from_numpy(pc.token_mask))
    assert perm_w.dtype == word_ptr.dtype == torch.int64
    want_perm, want_ptr, _ = _numpy_build(pc, np.zeros(pc.num_docs, np.int32))
    jax_perm, jax_ptr = jax_word_csr(pc.token_word, pc.vocab_size, pc.token_mask)
    for want in (want_perm, np.asarray(jax_perm)):
        np.testing.assert_array_equal(perm_w.numpy(), want)
    for want in (want_ptr, np.asarray(jax_ptr)):
        np.testing.assert_array_equal(word_ptr.numpy(), want)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_sweep_args_are_the_host_builds_bitwise(name):
    model = _model(name)
    pc = model._padded
    _, _, want = _numpy_build(pc, model.doc_lengths)
    assert model._args.keys() == want.keys()
    for key, arr in want.items():
        got = model._args[key]
        assert got.dtype == DTYPES[arr.dtype] and tuple(got.shape) == arr.shape, key
        assert torch.equal(got, torch.from_numpy(arr)), key


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_word_ranges_hold_exactly_their_real_tokens(name):
    model = _model(name)
    pc, args = model._padded, model._args
    perm_w = args["perm_w"].numpy()
    real = int(pc.token_mask.sum())
    for w in range(pc.vocab_size):
        count = int((pc.token_word[pc.token_mask > 0] == w).sum())
        slots = np.flatnonzero((pc.token_word == w) & (pc.token_mask > 0))
        if count:
            start = int(args["word_start"][slots[0]])
            seg = perm_w[start:start + count]
            np.testing.assert_array_equal(seg, slots)  # stable: stream order
            assert (args["nw_tok"].numpy()[slots] == count).all()
    np.testing.assert_array_equal(np.sort(perm_w[real:]),
                                  np.arange(real, pc.num_tokens))  # padding last
    np.testing.assert_array_equal(np.sort(perm_w), np.arange(pc.num_tokens))
