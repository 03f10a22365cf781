"""Held-out perplexity in the port: the host fold-in
(``evaluation/metrics.py``) and the batched fold-in on the device
(``evaluation/device_metrics.py``) against the JAX package's.

Tolerances: ``fold_in_theta`` and ``heldout_perplexity`` are numpy copies of
the reference's, so they must be equal exactly.  ``_fold_in_batch`` is fed
the reference's own draws (``jax.random.randint(key, ...)`` for the initial
``z`` and ``jax.random.gumbel(fold_in(key, i + 1), ...)`` for sweep ``i``,
made here and injected): θ within rel 1e-5 of the reference's
``_fold_in_batch``, ``z`` equal on at least 99.9% of the real tokens (XLA's
and PyTorch's float32 ``log`` may differ by one ulp and flip a near-tie),
and ``heldout_perplexity_device`` within rel 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.evaluation import device_metrics as jax_dm
from ldagibbssampling_tpu.evaluation import metrics as jax_metrics
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import device_metrics as dm
from ldagibbssampling_tpu_torch.evaluation import metrics

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K, V, N_SWEEPS = 6, 40, 5


def _phi(seed=0):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(V, 0.3), size=K).astype(np.float32)


def _corpora(seed=1, docs=11):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, V, size=n)]
              for n in rng.integers(0, 30, size=docs)]
    ragged[3] = []      # an empty document
    ragged[4] = [7]     # one token: nothing to score
    fc = FlatCorpus.from_ragged(ragged, vocab_size=V)
    return fc, JaxFlatCorpus(fc.token_word, fc.token_doc, fc.doc_ptr, V)


def _jax_draws(seed, n_sweeps=N_SWEEPS):
    """The reference's draws for the group starting at document ``lo``."""
    def draws(lo, d, l, k):
        key = jax.random.PRNGKey(seed + lo)
        z0 = jax.random.randint(key, (d, l), 0, k, dtype=jnp.int32)
        gumbels = [jax.random.gumbel(jax.random.fold_in(key, i + 1), (d, l, k),
                                     dtype=jnp.float32) for i in range(n_sweeps)]
        return np.asarray(z0), [np.asarray(g) for g in gumbels]
    return draws


def _reference_z(phi, tokens, mask, alpha, key, n_sweeps):
    """``z`` after the reference's ``_fold_in_batch`` (which returns only θ):
    the same steps, ``device_metrics.py:119-150``."""
    d, l = tokens.shape
    k = phi.shape[0]
    phw = phi.T[tokens.reshape(-1)].reshape(d, l, k)
    phw = jnp.where(mask.reshape(d, l, 1) > 0, phw, 1.0)
    logphw = jnp.log(jnp.maximum(phw, 1e-30))
    maskf = mask.astype(jnp.float32)[:, :, None]
    z = jax.random.randint(key, (d, l), 0, k, dtype=jnp.int32)

    def counts(z):
        return (jax.nn.one_hot(z, k, dtype=jnp.float32) * maskf).sum(axis=1)

    ndk = counts(z)
    for i in range(n_sweeps):
        oh = jax.nn.one_hot(z, k, dtype=jnp.float32) * maskf
        logp = logphw + jnp.log(jnp.maximum(ndk[:, None, :] - oh + jnp.float32(alpha),
                                            1e-30))
        g = jax.random.gumbel(jax.random.fold_in(key, i + 1), (d, l, k),
                              dtype=jnp.float32)
        z = jnp.where(mask > 0, jnp.argmax(logp + g, axis=-1).astype(jnp.int32), z)
        ndk = counts(z)
    return np.asarray(z)


@pytest.mark.parametrize("doc,seed", [(0, 0), (5, 3), (3, 1)])
def test_fold_in_theta_equals_reference(doc, seed):
    fc, _ = _corpora()
    phi = _phi().astype(np.float64)
    toks = fc.doc_tokens(doc)
    got = metrics.fold_in_theta(phi, toks, 0.3, n_sweeps=4, seed=seed)
    want = jax_metrics.fold_in_theta(phi, toks, 0.3, n_sweeps=4, seed=seed)
    np.testing.assert_array_equal(got, want)


def test_heldout_perplexity_equals_reference():
    fc, jfc = _corpora()
    phi = _phi()
    got = metrics.heldout_perplexity(phi, fc, 0.2, n_sweeps=4, seed=2)
    assert got == jax_metrics.heldout_perplexity(phi, jfc, 0.2, n_sweeps=4, seed=2)
    assert np.isfinite(got) and got > 1.0


def _grid(fc):
    l = max(len(fc.doc_tokens(m)) for m in range(fc.num_docs))
    toks = np.zeros((fc.num_docs, l), np.int32)
    mask = np.zeros((fc.num_docs, l), np.int32)
    for m in range(fc.num_docs):
        t = fc.doc_tokens(m)
        toks[m, : len(t)], mask[m, : len(t)] = t, 1
    return toks, mask


def test_fold_in_batch_with_the_reference_draws():
    fc, _ = _corpora()
    phi = _phi()
    toks, mask = _grid(fc)
    d, l = toks.shape
    alpha, seed = 0.4, 9
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_dm._fold_in_batch(
        jnp.asarray(phi), jnp.asarray(toks), jnp.asarray(mask), alpha, key,
        n_sweeps=N_SWEEPS))
    z_want = _reference_z(jnp.asarray(phi), jnp.asarray(toks), jnp.asarray(mask),
                          alpha, key, N_SWEEPS)
    theta, z = dm._fold_in_batch(
        torch.from_numpy(phi), torch.from_numpy(toks), torch.from_numpy(mask),
        alpha, n_sweeps=N_SWEEPS, draws=_jax_draws(seed)(0, d, l, K))
    real = mask > 0
    match = float((z.numpy() == z_want)[real].mean())
    assert match >= 0.999, match
    np.testing.assert_allclose(theta.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(theta.numpy().sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("doc_batch", [256, 4])
def test_heldout_perplexity_device_with_the_reference_draws(doc_batch):
    fc, jfc = _corpora()
    phi = _phi()
    seed = 4
    want = jax_dm.heldout_perplexity_device(phi, jfc, 0.3, N_SWEEPS, seed=seed)
    if doc_batch != 256:  # the reference's groups, reproduced at any size
        obs = [jfc.doc_tokens(m)[0::2] for m in range(jfc.num_docs)]
        theta = jax_dm.fold_in_theta_batch(phi, obs, 0.3, N_SWEEPS, seed=seed,
                                           doc_batch=doc_batch)
        got_theta = dm.fold_in_theta_batch(
            phi, [fc.doc_tokens(m)[0::2] for m in range(fc.num_docs)], 0.3,
            N_SWEEPS, seed=seed, doc_batch=doc_batch, device="cpu",
            draws=_jax_draws(seed))
        np.testing.assert_allclose(got_theta, theta, rtol=1e-5)
    got = dm.heldout_perplexity_device(phi, fc, 0.3, N_SWEEPS, seed=seed,
                                       device="cpu", draws=_jax_draws(seed))
    assert got == pytest.approx(want, rel=1e-5)


def test_heldout_perplexity_device_own_draws():
    fc, _ = _corpora(docs=40)
    phi = _phi()
    a = dm.heldout_perplexity_device(phi, fc, 0.3, N_SWEEPS, seed=1, device="cpu")
    b = dm.heldout_perplexity_device(phi, fc, 0.3, N_SWEEPS, seed=1, device="cpu")
    c = dm.heldout_perplexity_device(phi, fc, 0.3, N_SWEEPS, seed=2, device="cpu")
    host = metrics.heldout_perplexity(phi, fc, 0.3, N_SWEEPS, seed=1)
    assert a == b != c
    assert np.isfinite(a) and a > 1.0
    # two Monte-Carlo estimates of one quantity: close, not equal
    assert a == pytest.approx(host, rel=0.1)
