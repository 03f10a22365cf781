"""SVI's captured step (``backends/svi.SviGraph`` on ``ops/graphs.StepGraph``)
on the CPU, where the captured step runs eagerly on the graph's buffers.

- Against the eager ``svi_step`` from the same λ and batches, bitwise
  (λ and γ): steps with a changing ρ, full batches and a short last batch
  (``real < B``) through the one graph; a whole ``SviModel`` epoch against
  the same epoch stepped eagerly (λ and the γ cache).
- Against the JAX package's ``svi_step`` (rel 1e-4 per step) and its
  ``SviModel`` epoch (rel 1e-3), as ``tests/test_torch_backends.py`` holds
  the eager step: float32 sums in another order.
- ``step_factors``: the reference's float32 ``1 − ρ``, ``ρ`` and ``N / real``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu.backends.svi import SviModel as JaxSviModel
from ldagibbssampling_tpu.backends.svi import svi_step as jax_svi_step
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu_torch.backends.svi import (
    SviGraph, SviModel, step_factors, svi_step)
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.data.stream import minibatch_indices
from test_torch_backends import _corpora, _ragged

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _batches(v: int, b: int, reals, seed: int):
    rng = np.random.default_rng(seed)
    for real in reals:
        bow = rng.poisson(0.4, size=(b, v)).astype(np.float32)
        bow[real:] = 0  # padding rows
        yield torch.from_numpy(bow), real


@pytest.mark.parametrize("e_steps", [1, 20])
@pytest.mark.parametrize("reals", [(8, 8, 8), (8, 8, 5), (3, 8, 1)])
def test_captured_step_equals_eager_step(reals, e_steps):
    k, v, b = 5, 60, 8
    gen = torch.Generator().manual_seed(3)
    lam0 = torch._standard_gamma(torch.full((k, v), 100.0), generator=gen) / 100.0
    kw = dict(alpha=0.3, eta=0.05, e_steps=e_steps)
    graph = SviGraph(lam0, b, total_docs=50, **kw)
    got = want = lam0
    for t, (bow, real) in enumerate(_batches(v, b, reals, seed=4)):
        rho = (1.0 + t) ** -0.7
        got, g_got = graph(got, bow, rho, real)
        want, g_want = svi_step(want, bow, rho, real, total_docs=50, **kw)
        assert torch.equal(got, want) and torch.equal(g_got, g_want), t
    assert graph.graph.replays == 0  # the CPU ran the step eagerly


@pytest.mark.parametrize("batch_size", [8, 7])
def test_captured_epoch_equals_eager_epoch(batch_size):
    fc, _ = _corpora(_ragged(13, vocab=60), 60)  # 30 documents
    cfg = LdaConfig(topic_num=4, backend="svi", seed=3)
    model = SviModel(cfg, fc, batch_size=batch_size, device="cpu")
    lam = model.lam.clone()
    gamma_full = np.ones((fc.num_docs, 4), np.float32)
    rng = np.random.default_rng(cfg.seed)
    step = 0
    for _ in range(2):
        for idx, real in minibatch_indices(fc.num_docs, batch_size, rng):
            rho = (model.tau0 + step) ** (-model.kappa)
            lam, gamma = svi_step(lam, torch.from_numpy(model._batch_bow(idx, real)),
                                  rho, real, alpha=cfg.alpha, eta=model.eta,
                                  e_steps=model.e_steps, total_docs=fc.num_docs)
            gamma_full[idx[:real]] = gamma[:real].numpy()
            step += 1
    model.sweep(2)
    assert model._step_idx == step
    assert torch.equal(model.lam, lam)
    np.testing.assert_array_equal(model._gamma_full, gamma_full)


@pytest.mark.parametrize("real", [6, 8])
def test_captured_step_matches_reference(real):
    fc, jfc = _corpora(_ragged(2, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=5, backend="svi", seed=1), jfc)
    lam0 = np.asarray(ref.lam)
    rng = np.random.default_rng(7)
    bow = rng.poisson(0.3, size=(8, 60)).astype(np.float32)
    bow[real:] = 0
    graph = SviGraph(torch.from_numpy(lam0.copy()), 8, alpha=0.5, eta=0.1,
                     e_steps=20, total_docs=30)
    lam, g = torch.from_numpy(lam0.copy()), None
    lam_ref = jnp.asarray(lam0)
    for rho in (0.3, 0.21):
        lam_ref, g_ref = jax_svi_step(lam_ref, jnp.asarray(bow), jnp.float32(rho),
                                      jnp.float32(real), alpha=0.5, eta=0.1,
                                      e_steps=20, total_docs=30)
        lam, g = graph(lam, torch.from_numpy(bow), rho, real)
        np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4)


@pytest.mark.parametrize("batch_size", [8, 7])
def test_captured_epoch_matches_reference(batch_size):
    fc, jfc = _corpora(_ragged(3, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=5, backend="svi", seed=2), jfc,
                      batch_size=batch_size)
    port = SviModel(LdaConfig(topic_num=5, backend="svi", seed=2), fc,
                    batch_size=batch_size, device="cpu", lam0=np.asarray(ref.lam))
    ref.sweep(1)
    port.sweep(1)
    assert port._step_idx == ref._step_idx == -(-30 // batch_size)
    np.testing.assert_allclose(port.lam.numpy(), np.asarray(ref.lam), rtol=1e-3)
    np.testing.assert_allclose(port.theta(), ref.theta(), rtol=1e-3)


@pytest.mark.parametrize("rho,real,total", [(0.3, 6, 30), (1.0, 64, 16_400),
                                            (2.0 ** -0.7, 7, 1_000_003)])
def test_step_factors_are_the_reference_float32_scalars(rho, real, total):
    f = step_factors(rho, real, total)
    assert f.dtype == np.float32
    assert f[0] == np.float32(1.0) - np.float32(rho)
    assert f[1] == np.float32(rho)
    assert f[2] == np.float32(total) / np.float32(real)
    # as a 0-d tensor or as the Python float, a factor scales to the same bits
    x = torch.from_numpy(np.random.default_rng(0).random((4, 9)).astype(np.float32))
    for a in torch.from_numpy(f):
        assert torch.equal(a * x, float(a) * x)
