"""Tier resolution: for each rule, the port's ``kernel_tier`` and block equal
those of the JAX package's ``LdaModel`` built with ``pallas_interpret=True``
(which skips only the reference's platform rule, ``ops/gibbs.py:679-685``).

The one named difference: ``use_pallas=True`` with ``inverse_cdf`` runs the
XLA draw in both packages; the reference still reports ``"pallas-draw"``,
the port ``"xla"``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.documents import Documents as JaxDocuments
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.models.lda import LdaModel as JaxLdaModel
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.documents import Documents
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.models.lda import LdaModel, resolve_tier

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _corpus(num_tokens, num_docs=12, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=num_tokens) - 1) % vocab).astype(np.int32)
    td = (np.arange(num_tokens, dtype=np.int64) * num_docs // num_tokens
          ).astype(np.int32)
    ptr = np.zeros(num_docs + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=num_docs), out=ptr[1:])
    return (FlatCorpus(tw, td, ptr, vocab),
            JaxFlatCorpus(tw, td, ptr, vocab))


def _jax(cfg: dict, jfc):
    return JaxLdaModel(JaxLdaConfig(topic_num=6, pallas_interpret=True, **cfg), jfc)


# (config, corpus tokens, tier both packages run)
CASES = [
    ({}, 4000, "deferred"),                              # block 2048
    ({}, 1000, "deferred"),                              # block = num_tokens
    ({}, 1301, "fused"),                                 # no multiple-of-8 tile
    ({"block_size": 3001}, 4000, "xla"),                 # ... and no tile <= 2048
    ({"use_pallas": "fused", "block_size": 3001}, 4000, "xla"),
    ({"use_pallas": "fused", "block_size": 1000}, 4000, "fused"),
    ({"use_pallas": "fused", "block_size": 64}, 4000, "xla"),  # block < 128
    ({"block_size": 100}, 4000, "xla"),
    ({}, 90, "xla"),                                     # corpus < 128 tokens
    ({"use_pallas": True}, 4000, "pallas-draw"),
    ({"use_pallas": True, "block_size": 64}, 4000, "pallas-draw"),
    ({"use_pallas": False}, 4000, "xla"),
    ({"draw_method": "inverse_cdf"}, 4000, "xla"),
    ({"draw_method": "inverse_cdf", "use_pallas": "fused"}, 4000, "xla"),
    ({"sampler": "serial"}, 400, "serial-oracle"),
]


@pytest.mark.parametrize("cfg,tokens,tier", CASES)
def test_tier_and_block_equal_reference(cfg, tokens, tier):
    fc, jfc = _corpus(tokens)
    ref = _jax(cfg, jfc)
    choice = resolve_tier(LdaConfig(topic_num=6, **cfg), fc)
    assert choice.kernel_tier == ref.kernel_tier == tier
    model = LdaModel(LdaConfig(topic_num=6, **cfg), fc, device="cpu")
    assert model.kernel_tier == tier
    if tier != "serial-oracle":
        assert choice.block == model.block_size == ref.block_size
        for name in ("token_word", "token_doc", "token_mask"):
            np.testing.assert_array_equal(getattr(model._padded, name),
                                          getattr(ref._padded, name))
    model.sweep(2)
    model.check_counts_consistent()
    assert model.sweeps_done == 2


def test_pallas_draw_with_inverse_cdf_is_named_xla():
    fc, jfc = _corpus(4000)
    cfg = {"use_pallas": True, "draw_method": "inverse_cdf"}
    assert _jax(cfg, jfc).kernel_tier == "pallas-draw"
    model = LdaModel(LdaConfig(topic_num=6, **cfg), fc, device="cpu")
    assert model.kernel_tier == "xla"
    assert model.block_size == 2048


def test_fused_at_2_24_tokens_runs_the_xla_tier():
    # the fused tier's float32 running totals would round: both packages
    # run the XLA tier (resolution only; no sweep at this size)
    t, m, v = 1 << 24, 64, 50
    tw = (np.arange(t) % v).astype(np.int32)
    td = (np.arange(t, dtype=np.int64) * m // t).astype(np.int32)
    ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=m), out=ptr[1:])
    cfg = {"use_pallas": "fused", "block_size": 65536}
    ref = _jax(cfg, JaxFlatCorpus(tw, td, ptr, v))
    choice = resolve_tier(LdaConfig(topic_num=6, **cfg), FlatCorpus(tw, td, ptr, v))
    assert choice.kernel_tier == ref.kernel_tier == "xla"
    assert choice.block == ref.block_size == 65536
    assert "2^24" in choice.reason


def test_minicorpus_runs_the_reference_tier_and_block(tmp_path):
    """A minicorpus with ``num_tokens % 8 != 0`` under the default config:
    the reference runs the fused tier with one block of all the tokens (its
    deferred layout has no multiple-of-8 tile), and so does the port."""
    docs = write_minicorpus(tmp_path / "docs")
    fc = FlatCorpus.from_documents(Documents().read_docs(docs))
    jfc = JaxFlatCorpus.from_documents(JaxDocuments().read_docs(docs))
    assert fc.num_tokens % 8 != 0 and fc.num_tokens < 2048
    ref = JaxLdaModel(JaxLdaConfig(topic_num=10, pallas_interpret=True), jfc)
    model = LdaModel(LdaConfig(topic_num=10), fc, device="cpu")
    assert model.kernel_tier == ref.kernel_tier == "fused"
    assert model.block_size == ref.block_size == fc.num_tokens
    assert model._run_sweeps.row_tile == fc.num_tokens
    for name in ("token_word", "token_doc", "token_mask"):
        np.testing.assert_array_equal(getattr(model._padded, name),
                                      getattr(ref._padded, name))
    model.sweep(3)
    model.check_counts_consistent()
    z = model.z()  # back in corpus order
    nwk = np.zeros((fc.vocab_size, 10), np.int64)
    np.add.at(nwk, (fc.token_word, z), 1)
    np.testing.assert_array_equal(model.state.nwk.numpy(), nwk)
