"""Likelihood and perplexity of point estimates, on the host.

Copied from ``ldagibbssampling_tpu/evaluation/metrics.py:19-35`` (numpy; the
port keeps its own copy).  No reference analog (the Java code computes no
metrics); the definitions are the standard ones:

    LL  = Σ_t log Σ_k θ[d_t, k] · φ[k, w_t]
    PPL = exp(−LL / T)

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
