"""Serial Java-fidelity oracle sampler (``sampler="serial"``).

A copy of ``ldagibbssampling_tpu/models/oracle.py`` (pure numpy on the host;
the port imports nothing of the JAX package, so it keeps its own).

This is the behavioral ground truth of the whole framework (SURVEY.md §4): a
NumPy reimplementation of the reference's serial collapsed-Gibbs chain —
``LdaModel.initializeModel`` / ``inferenceModel`` / ``sampleTopicZ`` in
``src/liuyang/nlp/lda/main/LdaModel.java`` — driven by a bit-exact
``java.util.Random`` model.  The actual reference is *unseeded*
(``Math.random()``), so bit-parity is defined against this seeded oracle
(SURVEY.md §8.2); the TPU engine's ``block_size=1`` fidelity mode and the native
C oracle must match this chain exactly, token for token.

Semantics reproduced step-for-step (``sampleTopicZ`` :~150):

1. decrement the old topic's counts (token excluded from its own conditional);
2. ``p[k] = (nwk[w,k]+β)/(nk[k]+V·β) · (ndk[m,k]+α)/(N_m-1+K·α)`` in double;
3. in-place prefix sum ``p[k] += p[k-1]``; draw ``u = nextDouble() · p[K-1]``;
4. first ``k`` with ``u < p[k]`` wins (linear scan);
5. increment the new topic's counts.

Count layouts follow the engine convention (``nwk[V, K]``; the reference stores
``nkt[K, V]`` — a pure transpose).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.utils.javarandom import JavaRandom


class OracleSampler:
    """Serial collapsed-Gibbs LDA with Java RNG semantics (CPU, NumPy)."""

    def __init__(
        self,
        corpus: FlatCorpus,
        num_topics: int,
        alpha: float = 0.5,
        beta: float = 0.1,
        seed: int = 0,
        rng: Optional[JavaRandom] = None,
    ) -> None:
        self.corpus = corpus
        self.K = int(num_topics)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.rng = rng if rng is not None else JavaRandom(seed)

        self.M = corpus.num_docs
        self.V = corpus.vocab_size
        self.T = corpus.num_tokens
        self.doc_len = corpus.doc_lengths().astype(np.int64)

        # initializeModel (SURVEY.md §3.2): z[t] = (int)(nextDouble() * K) in
        # doc-major token order, then count accumulation.
        self.z = np.empty(self.T, dtype=np.int32)
        for t in range(self.T):
            self.z[t] = int(self.rng.next_double() * self.K)
        self.ndk = np.zeros((self.M, self.K), dtype=np.int64)
        self.nwk = np.zeros((self.V, self.K), dtype=np.int64)
        self.nk = np.zeros(self.K, dtype=np.int64)
        np.add.at(self.ndk, (corpus.token_doc, self.z), 1)
        np.add.at(self.nwk, (corpus.token_word, self.z), 1)
        np.add.at(self.nk, self.z, 1)
        self.sweep_idx = 0

    # ------------------------------------------------------------------
    def sweep(self, n: int = 1) -> None:
        """Run ``n`` full systematic-scan sweeps (reference ``inferenceModel`` loop)."""
        tw = self.corpus.token_word
        td = self.corpus.token_doc
        k_alpha = self.K * self.alpha
        v_beta = self.V * self.beta
        for _ in range(n):
            for t in range(self.T):
                w = tw[t]
                m = td[t]
                old = self.z[t]
                # 1. decrement
                self.ndk[m, old] -= 1
                self.nwk[w, old] -= 1
                self.nk[old] -= 1
                nm = self.doc_len[m] - 1
                # 2. conditional, double precision, Java's left-to-right op
                #    order ((A/B)·C)/D so every rounding step matches
                p = (self.nwk[w] + self.beta) / (self.nk + v_beta) * (
                    self.ndk[m] + self.alpha
                ) / (nm + k_alpha)
                # 3. in-place prefix sum + scaled uniform draw
                np.cumsum(p, out=p)
                u = self.rng.next_double() * p[-1]
                # 4. first k with u < p[k]
                new = int(np.searchsorted(p, u, side="right"))
                if new >= self.K:  # guard against fp edge (u == p[-1])
                    new = self.K - 1
                # 5. increment
                self.ndk[m, new] += 1
                self.nwk[w, new] += 1
                self.nk[new] += 1
                self.z[t] = new
            self.sweep_idx += 1

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        """``phi[k, t] = (nwk[t,k]+β)/(nk[k]+V·β)`` (updateEstimatedParameters)."""
        return ((self.nwk + self.beta) / (self.nk + self.V * self.beta)).T

    def theta(self) -> np.ndarray:
        """``theta[m, k] = (ndk[m,k]+α)/(N_m+K·α)``."""
        return (self.ndk + self.alpha) / (
            self.doc_len[:, None] + self.K * self.alpha
        )

    def check_invariants(self) -> None:
        assert (self.ndk >= 0).all() and (self.nwk >= 0).all() and (self.nk >= 0).all()
        assert (self.ndk.sum(axis=1) == self.doc_len).all()
        assert (self.nwk.sum(axis=0) == self.nk).all()
        assert self.nk.sum() == self.T
