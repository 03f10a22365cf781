"""The port's CVB0, SVI, WarpLDA and SMC backends against the JAX package's,
from the same state and noise on the CPU.

- CVB0 from the reference model's own γ (``gamma0``), 3 sweeps, with and
  without sorted blocks: γ atol 1e-5, expected counts rel 1e-4 (float32
  sums in another order of additions), ``z`` equal on >= 99.9%.
- SVI from the reference's λ (``lam0``): one ``svi_step`` rel 1e-4, one
  whole epoch rel 1e-3 (the same minibatch order, from the same numpy seed).
- WarpLDA from the reference's state, fed its ``u[8, T_pad]`` of each sweep
  (``uniform(fold_in(key, sweep))``): ``z`` >= 99.9% (exact for these
  seeds), the counts a recount of ``z``.
- SMC fed the reference's chain of Gumbels (its key split once per token,
  once more inside a resample): without resampling (``ess_threshold=0``)
  ``z`` and the counts exact, log-weights rel 1e-5; with resampling, one
  token per call so each step's noise follows the reference's key after
  the previous step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.backends.cvb0 import Cvb0Model as JaxCvb0Model
from ldagibbssampling_tpu.backends.smc import smc_absorb as jax_smc_absorb
from ldagibbssampling_tpu.backends.svi import SviModel as JaxSviModel
from ldagibbssampling_tpu.backends.svi import svi_step as jax_svi_step
from ldagibbssampling_tpu.backends.warp import WarpModel as JaxWarpModel
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.backends import (
    Cvb0Model, InferenceBackend, SmcModel, SviModel, WarpModel, make_backend)
from ldagibbssampling_tpu_torch.backends.smc import smc_absorb
from ldagibbssampling_tpu_torch.backends.svi import svi_step
from ldagibbssampling_tpu_torch.backends.warp import word_csr
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.lda import LdaModel

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _ragged(seed, num_docs=30, vocab=50, lo=5, hi=40):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(lo, hi)))]
            for _ in range(num_docs)]


def _corpora(ragged, vocab):
    return (FlatCorpus.from_ragged(ragged, vocab_size=vocab),
            JaxFlatCorpus.from_ragged(ragged, vocab_size=vocab))


# --------------------------------------------------------------------- CVB0
@pytest.mark.parametrize("sort_blocks", [False, True])
def test_cvb0_matches_reference(sort_blocks):
    fc, jfc = _corpora(_ragged(0), 50)
    kw = dict(topic_num=5, backend="cvb0", block_size=64, seed=1,
              sort_blocks=sort_blocks)
    ref = JaxCvb0Model(JaxLdaConfig(**kw), jfc)
    port = Cvb0Model(LdaConfig(**kw), fc, device="cpu",
                     gamma0=np.asarray(ref.gamma))
    assert (port._perm is not None) == sort_blocks
    for name in ("ndk", "nwk", "nk"):  # the port's start from the same γ
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6)
    ref.sweep(3)
    port.sweep(3)
    assert port.sweeps_done == 3
    np.testing.assert_allclose(port.gamma.numpy(), np.asarray(ref.gamma), atol=1e-5)
    for name in ("ndk", "nwk", "nk"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert float((port.z() == ref.z()).mean()) >= 0.999
    port.check_invariants()
    np.testing.assert_allclose(port.phi(), ref.phi(), rtol=1e-4)


def test_cvb0_continues_the_reference_state():
    """The reference's whole state after two sweeps, carried across
    (``interop.from_jax_cvb0``), then one more sweep in each package."""
    fc, jfc = _corpora(_ragged(5), 50)
    kw = dict(topic_num=4, backend="cvb0", block_size=64, seed=2)
    ref = JaxCvb0Model(JaxLdaConfig(**kw), jfc)
    ref.sweep(2)
    port = Cvb0Model(LdaConfig(**kw), fc, device="cpu")
    for name, value in interop.from_jax_cvb0(
            {n: np.asarray(getattr(ref, n)) for n in ("gamma", "ndk", "nwk", "nk")}, device="cpu"
    ).items():
        setattr(port, name, value)
    ref.sweep(1)
    port.sweep(1)
    np.testing.assert_allclose(port.gamma.numpy(), np.asarray(ref.gamma), atol=1e-5)
    np.testing.assert_allclose(port.nwk.numpy(), np.asarray(ref.nwk), rtol=1e-4,
                               atol=1e-4)


def test_cvb0_own_start_is_seeded_and_learns():
    fc, _ = _corpora(_ragged(1), 50)
    cfg = LdaConfig(topic_num=4, backend="cvb0", block_size=64, seed=3)
    a, b = Cvb0Model(cfg, fc, device="cpu"), Cvb0Model(cfg, fc, device="cpu")
    assert torch.equal(a.gamma, b.gamma)
    sums, real = a.gamma.sum(dim=1).numpy(), a._padded.token_mask > 0
    np.testing.assert_allclose(sums[real], 1.0, rtol=1e-5)
    assert (sums[~real] == 0).all()  # padding rows stay zero
    a.sweep(4)
    b.sweep(4)
    assert torch.equal(a.gamma, b.gamma) and torch.equal(a.nwk, b.nwk)
    a.check_invariants()
    assert a.z().shape == (fc.num_tokens,)


# ---------------------------------------------------------------------- SVI
def test_svi_step_matches_reference():
    fc, jfc = _corpora(_ragged(2, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=5, backend="svi", seed=1), jfc)
    lam0 = np.asarray(ref.lam)
    rng = np.random.default_rng(7)
    bow = rng.poisson(0.3, size=(8, 60)).astype(np.float32)
    bow[6:] = 0  # two padding rows
    lam_ref, g_ref = jax_svi_step(jnp.asarray(lam0), jnp.asarray(bow),
                                  jnp.float32(0.3), jnp.float32(6), alpha=0.5,
                                  eta=0.1, e_steps=20, total_docs=30)
    lam, g = svi_step(torch.from_numpy(lam0.copy()), torch.from_numpy(bow), 0.3, 6,
                      alpha=0.5, eta=0.1, e_steps=20, total_docs=30)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4)


def test_svi_epoch_matches_reference():
    fc, jfc = _corpora(_ragged(3, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=5, backend="svi", seed=2), jfc,
                      batch_size=8)
    port = SviModel(LdaConfig(topic_num=5, backend="svi", seed=2), fc, batch_size=8,
                    device="cpu", lam0=np.asarray(ref.lam))
    ref.sweep(1)
    port.sweep(1)
    assert port._step_idx == ref._step_idx == 4 and port.sweeps_done == 1
    np.testing.assert_allclose(port.lam.numpy(), np.asarray(ref.lam), rtol=1e-3)
    np.testing.assert_allclose(port.theta(), ref.theta(), rtol=1e-3)
    np.testing.assert_allclose(port.phi(), ref.phi(), rtol=1e-3)


def test_svi_continues_the_reference_run():
    """λ, the γ cache, the counters and the shuffler's state of the
    reference after one epoch (``interop.from_jax_svi``), then one more
    epoch in each package."""
    fc, jfc = _corpora(_ragged(6, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=4, backend="svi", seed=5), jfc,
                      batch_size=8)
    ref.sweep(1)
    port = SviModel(LdaConfig(topic_num=4, backend="svi", seed=5), fc, batch_size=8,
                    device="cpu")
    port.lam, port._gamma_full = interop.from_jax_svi(
        {"lam": np.asarray(ref.lam), "gamma_full": ref._gamma_full}, device="cpu")
    port._step_idx, port._sweeps = ref._step_idx, ref._sweeps
    port._rng.bit_generator.state = ref._rng.bit_generator.state
    ref.sweep(1)
    port.sweep(1)
    np.testing.assert_allclose(port.lam.numpy(), np.asarray(ref.lam), rtol=1e-3)
    np.testing.assert_allclose(port.theta(), ref.theta(), rtol=1e-3)


def test_svi_sparse_batches_equal_the_reference_densify():
    fc, jfc = _corpora(_ragged(4, vocab=60), 60)
    ref = JaxSviModel(JaxLdaConfig(topic_num=3, backend="svi"), jfc, batch_size=8)
    port = SviModel(LdaConfig(topic_num=3, backend="svi"), fc, batch_size=8,
                    device="cpu")
    idx = np.array([3, 0, 17, 29, 5, 5, 5, 5])
    np.testing.assert_array_equal(port._batch_bow(idx, 4), ref._batch_bow(idx, 4))
    assert float(port.lam.min()) > 0 and torch.isfinite(port.lam).all()


# --------------------------------------------------------------------- Warp
@pytest.mark.parametrize("seed,sweeps", [(3, 5), (8, 3)])
def test_warp_matches_reference_under_its_uniforms(seed, sweeps):
    fc, jfc = _corpora(_ragged(seed, num_docs=40, vocab=64), 64)
    kw = dict(backend="warp", topic_num=7, block_size=128, seed=seed)
    ref = JaxWarpModel(JaxLdaConfig(**kw), jfc)
    state = interop.from_jax_state(
        {n: np.asarray(getattr(ref.state, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")},
        device="cpu")
    port = WarpModel(LdaConfig(**kw), fc, device="cpu", noise_mode="external",
                     state=state)
    key, t_pad = ref.state.key, int(ref.state.z.shape[0])

    def noise(sweep):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, sweep), (8, t_pad), jnp.float32)))

    ref.sweep(sweeps)
    port.sweep(sweeps, noise=noise)
    assert port.sweeps_done == sweeps == ref.sweeps_done
    pc = port._padded
    real = pc.token_mask > 0
    z = port.state.z.numpy()
    match = float((z[real] == np.asarray(ref.state.z)[real]).mean())
    assert match >= 0.999 and match == 1.0, match  # exact for these seeds
    ndk = np.zeros((pc.num_docs, 7), np.int64)
    nwk = np.zeros((pc.vocab_size, 7), np.int64)
    np.add.at(ndk, (pc.token_doc[real], z[real]), 1)
    np.add.at(nwk, (pc.token_word[real], z[real]), 1)
    np.testing.assert_array_equal(port.state.ndk.numpy(), ndk)
    np.testing.assert_array_equal(port.state.nwk.numpy(), nwk)
    np.testing.assert_array_equal(port.state.nk.numpy(), nwk.sum(axis=0))


def test_warp_internal_noise_seeded_and_word_csr():
    fc, _ = _corpora(_ragged(9, num_docs=20, vocab=30), 30)
    cfg = LdaConfig(backend="warp", topic_num=5, block_size=128, seed=2)
    a, b = WarpModel(cfg, fc, device="cpu"), WarpModel(cfg, fc, device="cpu")
    a.sweep(3)
    b.sweep(3)
    assert torch.equal(a.state.z, b.state.z) and a.sweeps_done == 3
    pc = a._padded
    perm_w, word_ptr = word_csr(pc.token_word, pc.vocab_size, pc.token_mask)
    for w in range(pc.vocab_size):
        seg = perm_w[word_ptr[w]:word_ptr[w + 1]]
        assert (pc.token_word[seg] == w).all() and (pc.token_mask[seg] == 1).all()
    assert int(a.state.nk.sum()) == fc.num_tokens


# ---------------------------------------------------------------------- SMC
_P, _K = 4, 3


def _smc_setup(seed):
    ragged = _ragged(seed, num_docs=10, vocab=20, hi=20)
    fc, _ = _corpora(ragged, 20)
    zeros = dict(ndk=np.zeros((_P, fc.num_docs, _K), np.int32),
                 nwk=np.zeros((_P, 20, _K), np.int32),
                 nk=np.zeros((_P, _K), np.int32),
                 z=np.zeros((_P, fc.num_tokens), np.int32),
                 logw=np.zeros(_P, np.float32))
    return fc, zeros


def _ref_state(st):
    return tuple(jnp.asarray(st[n]) for n in ("ndk", "nwk", "nk", "z", "logw"))


def _port_state(st):
    ps = interop.from_jax_smc(st, device="cpu")
    return tuple(ps[n] for n in ("ndk", "nwk", "nk", "z", "logw"))


def _assert_smc_equal(ref, port):
    for name, a, b in zip(("ndk", "nwk", "nk", "z"), ref[:4], port[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(port[4].numpy(), np.asarray(ref[4]), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_smc_without_resampling_matches_reference(seed):
    fc, st = _smc_setup(seed)
    t = fc.num_tokens
    tw, td = jnp.asarray(fc.token_word), jnp.asarray(fc.token_doc)
    ref, port = _ref_state(st), _port_state(st)
    key = jax.random.PRNGKey(seed + 5)
    for sweep in range(2):
        gumbels, k_ = [], key
        for _ in range(t):  # the reference's key chain without a resample
            k_, sub = jax.random.split(k_)
            gumbels.append(np.asarray(jax.random.gumbel(sub, (_P, _K))))
        *ref, key = jax_smc_absorb(*ref, key, tw, td, jnp.asarray(sweep == 0),
                                   jnp.int32(0), alpha=0.5, beta=0.1,
                                   ess_threshold=0.0, num_steps=t)
        port = smc_absorb(*port, fc.token_word, fc.token_doc, sweep == 0, 0,
                          alpha=0.5, beta=0.1, ess_threshold=0.0, num_steps=t,
                          gumbels=torch.from_numpy(np.stack(gumbels)),
                          resample_gumbels=torch.zeros((t, _P, _P)))
        _assert_smc_equal(ref, port)
    assert (port[2].sum(dim=1) == t).all()


def test_smc_resampling_matches_reference_one_token_per_call():
    fc, st = _smc_setup(2)
    tw, td = jnp.asarray(fc.token_word), jnp.asarray(fc.token_doc)
    ref, port = _ref_state(st), _port_state(st)
    key = jax.random.PRNGKey(7)
    resamples = 0
    for sweep in range(2):
        for t in range(fc.num_tokens):
            k1, sub = jax.random.split(key)
            g = np.array(jax.random.gumbel(sub, (_P, _K)))
            _, sub2 = jax.random.split(k1)  # the split inside a resample
            rg = np.array(jax.random.gumbel(sub2, (_P, _P)))
            *ref, key = jax_smc_absorb(*ref, key, tw, td, jnp.asarray(sweep == 0),
                                       jnp.int32(t), alpha=0.5, beta=0.1,
                                       ess_threshold=0.5, num_steps=1)
            port = smc_absorb(*port, fc.token_word, fc.token_doc, sweep == 0, t,
                              alpha=0.5, beta=0.1, ess_threshold=0.5, num_steps=1,
                              gumbels=torch.from_numpy(g)[None],
                              resample_gumbels=torch.from_numpy(rg)[None])
            resamples += int(not np.asarray(ref[4]).any())
        _assert_smc_equal(ref, port)
    assert resamples >= 3  # the resample branch really ran


def test_smc_chunked_absorb_matches_single_scan():
    fc, _ = _corpora(_ragged(23, num_docs=24, vocab=8, lo=30, hi=31), 8)
    cfg = LdaConfig(topic_num=4, seed=9, backend="smc")
    a = SmcModel(cfg, fc, num_particles=4, chunk_size=10**9, device="cpu")
    b = SmcModel(cfg, fc, num_particles=4, chunk_size=37, device="cpu")
    a.sweep(2)
    b.sweep(2)
    for name in ("z", "nwk", "ndk", "nk"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_allclose(a.logw.numpy(), b.logw.numpy(), rtol=1e-5)
    np.testing.assert_allclose(a._weights().sum(), 1.0, rtol=1e-6)
    assert (a.nk.sum(dim=1) == fc.num_tokens).all()
    assert int(a.z.min()) >= 0 and int(a.z.max()) < 4


# ------------------------------------------------------------------ factory
@pytest.mark.parametrize("backend,cls", [
    ("gibbs", LdaModel), ("cvb0", Cvb0Model), ("svi", SviModel),
    ("smc", SmcModel), ("warp", WarpModel)])
def test_make_backend_builds_each_backend_on_the_cpu(backend, cls):
    fc, _ = _corpora(_ragged(11, num_docs=12, vocab=8), 8)
    cfg = LdaConfig(topic_num=2, backend=backend, block_size=64, seed=0)
    m = make_backend(cfg, fc, device="cpu")
    assert isinstance(m, cls) and isinstance(m, InferenceBackend)
    m.sweep(2)
    assert m.sweeps_done == 2
    phi, theta = m.phi(), m.theta()
    assert phi.shape == (2, 8) and theta.shape == (fc.num_docs, 2)
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("backend", ["cvb0", "svi", "smc", "warp"])
def test_backends_raise_without_cuda(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc, _ = _corpora(_ragged(12, num_docs=4, vocab=8), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_backend(LdaConfig(topic_num=2, backend=backend), fc)
