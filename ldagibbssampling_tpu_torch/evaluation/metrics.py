"""Likelihood, perplexity and held-out (doc-completion) perplexity, on the host.

Copied from ``ldagibbssampling_tpu/evaluation/metrics.py:19-96`` (numpy; the
port keeps its own copy, line for line, so the results are the reference's
bit for bit).  No reference analog (the Java code computes no metrics); the
definitions are the standard ones:

    LL       = Σ_t log Σ_k θ[d_t, k] · φ[k, w_t]
    PPL      = exp(−LL / T)
    held-out = doc-completion: fold-in θ on the observation half of each unseen
               document with φ frozen, score the evaluation half.

``runner.run_inference`` falls back to these for a backend without a
``device_log_likelihood``.  They materialise ``θ[d_t]`` (``[T, K]`` float64),
so the device path (``evaluation/device_metrics.py``) is the one for large
corpora.
"""

from __future__ import annotations

import numpy as np

from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def log_likelihood(phi: np.ndarray, theta: np.ndarray, corpus: FlatCorpus) -> float:
    """Token log-likelihood under point estimates (phi [K,V], theta [M,K])."""
    phi = np.asarray(phi, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    tw = corpus.token_word
    td = corpus.token_doc
    # p[t] = Σ_k theta[d_t, k] * phi[k, w_t]
    p = np.einsum("tk,kt->t", theta[td], phi[:, tw])
    return float(np.log(np.maximum(p, 1e-300)).sum())


def perplexity(phi: np.ndarray, theta: np.ndarray, corpus: FlatCorpus) -> float:
    t = corpus.num_tokens
    if t == 0:
        return float("nan")
    return float(np.exp(-log_likelihood(phi, theta, corpus) / t))


def fold_in_theta(
    phi: np.ndarray,
    doc_tokens: np.ndarray,
    alpha: float,
    n_sweeps: int = 20,
    seed: int = 0,
) -> np.ndarray:
    """Estimate a single new document's θ by Gibbs with φ frozen.

    Standard fold-in: resample the doc's token topics from
    ``p(z=k) ∝ φ[k,w] · (ndk[k]+α)``, then ``θ[k] = (ndk[k]+α)/(N+Kα)``.
    """
    phi = np.asarray(phi, dtype=np.float64)
    k = phi.shape[0]
    rng = np.random.default_rng(seed)
    n = len(doc_tokens)
    if n == 0:
        return np.full(k, 1.0 / k)
    z = rng.integers(0, k, size=n)
    ndk = np.bincount(z, minlength=k).astype(np.float64)
    for _ in range(n_sweeps):
        for i in range(n):
            w = doc_tokens[i]
            ndk[z[i]] -= 1
            p = phi[:, w] * (ndk + alpha)
            p /= p.sum()
            z[i] = rng.choice(k, p=p)
            ndk[z[i]] += 1
    return (ndk + alpha) / (n + k * alpha)


def heldout_perplexity(
    phi: np.ndarray,
    heldout: FlatCorpus,
    alpha: float,
    n_sweeps: int = 20,
    seed: int = 0,
) -> float:
    """Doc-completion perplexity on unseen documents.

    Each held-out doc is split in half (even token positions = observation,
    odd = evaluation); θ is folded in on the observation half with φ frozen,
    and the evaluation half is scored.  This is the standard estimator that
    avoids the train-on-test bias of scoring with a θ fit on the same tokens.
    """
    phi = np.asarray(phi, dtype=np.float64)
    total_ll = 0.0
    total_tokens = 0
    for m in range(heldout.num_docs):
        toks = heldout.doc_tokens(m)
        obs, ev = toks[0::2], toks[1::2]
        if len(ev) == 0:
            continue
        theta = fold_in_theta(phi, obs, alpha, n_sweeps, seed=seed + m)
        p = theta @ phi[:, ev]
        total_ll += float(np.log(np.maximum(p, 1e-300)).sum())
        total_tokens += len(ev)
    if total_tokens == 0:
        return float("nan")
    return float(np.exp(-total_ll / total_tokens))
