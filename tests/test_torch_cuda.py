"""The CUDA kernels against their plain PyTorch versions on the card, at small
shapes.  Marked ``cuda``: without a GPU every test skips.  On a machine with
one (and without jax, hence ``--noconftest``):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: none.  On the card both sides run the same float32 operations
in the same order with the same libdevice ``logf``, so z and every count
must be equal in all three noise modes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.models.state import init_state
from ldagibbssampling_tpu_torch.ops import count_kernel as ck
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

pytestmark = pytest.mark.cuda

K, V, M = 37, 500, 40
HYPER = dict(alpha=0.5, beta=0.1, vbeta=float(np.float32(V) * np.float32(0.1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _setup(device, seed=0, t=6000, block=1024):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.2, size=t) - 1) % V).astype(np.int32)
    td = (np.arange(t) * M // t).astype(np.int32)
    plan = ck.plan_deferred(tw, td, V, block)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K, seed=seed,
                    device=device)
    toks = [torch.from_numpy(np.array(a)).to(device)
            for a in (plan.token_word, plan.token_doc, plan.token_mask)]
    return plan, st, toks


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k1_walk_equals_plain(cuda, mode):
    plan, st, (tw, td, tm) = _setup(cuda)
    nwk = torch.nn.functional.pad(st.nwk, (0, 128 - K, 0, plan.v_pad - V))
    mirror = ck.cast_mirror(nwk.contiguous())
    uniforms = torch.rand((tw.shape[0], 128), device=cuda) * 0.999 + 5e-4
    out = []
    for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
        ndk, nk = st.ndk.clone(), st.nk.clone()
        z = walk(mirror, ndk, nk, st.z, tw, td, tm, row_tile=256,
                 noise_mode=mode, seed=77, uniforms=uniforms, **HYPER)
        out.append((z, ndk, nk))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_k2_equals_plain(cuda):
    plan, st, (tw, _, tm) = _setup(cuda, seed=1)
    nwk, nk = ck.rebuild_counts(st.z, tw, tm, v_pad=plan.v_pad, k_pad=128)
    nwk_p, nk_p = ck.rebuild_counts_plain(st.z, tw, tm, v_pad=plan.v_pad, k_pad=128)
    assert torch.equal(nwk, nwk_p) and torch.equal(nk, nk_p)
    assert torch.equal(ck.cast_mirror(nwk), ck.cast_mirror_plain(nwk))


def test_model_on_card_counts_consistent(cuda):
    rng = np.random.default_rng(2)
    ragged = [[int(x) for x in rng.integers(0, 80, size=60)] for _ in range(30)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=80)
    launches = dict(fk.LAUNCHES)
    model = LdaModel(LdaConfig(topic_num=9, block_size=512), fc)
    assert model.state.z.is_cuda
    model.sweep(4)
    model.check_counts_consistent()
    assert fk.LAUNCHES["gibbs_tile_sample"] > launches["gibbs_tile_sample"]


def test_failed_launch_raises(cuda):
    # the C entry point refuses an unknown noise mode with cudaErrorInvalidValue
    build, lib = fk._lib()
    err = lib.lda_gibbs_tiles(None, 128, None, K, None, None, None, None, None,
                              None, None, 0, 256, 0.5, 0.1, 1.0, 7, 0, 0, 3,
                              None)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, err, "lda_gibbs_tiles")
