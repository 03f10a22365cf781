"""SVI: stochastic variational inference (online LDA, Hoffman et al. 2010).

Counterpart of ``ldagibbssampling_tpu/backends/svi.py``; no analog in the
Java code.  The global state is the topic-word variational parameter λ
``[K, V]``; each step takes a minibatch of documents, runs a fixed number
of local E-steps for their γ, and blends the natural-gradient estimate into
λ with the decaying rate ρ_t = (τ₀ + t)^(−κ).  The update is dense
``[B, V] x [V, K]`` matmul work, in float32 with ``torch.matmul`` (TF32
stays off, PyTorch's default; this module never turns it on) and
``torch.special.digamma``.

The bag-of-words store is a sparse CSR of the unique (document, word) pairs
on the host, O(nnz); each minibatch densifies only its own ``[B, V]`` tile
right before its copy to the device, which ``data/stream.prefetch_to_device``
overlaps with the previous step.  The minibatch order comes from
``np.random.default_rng(config.seed)``, exactly as the reference's, so one
seed gives the same minibatches in both packages.  The per-document γ cache
stays on the host.

λ starts from a Gamma(100, 1/100) draw on a ``torch.Generator`` seeded with
``config.seed`` (the reference's threefry draw cannot be reproduced);
``lam0`` injects a start instead.  The reference's ``+ 1e-100`` guards are
kept as they are: in float32 they round to 0, in both packages.

Design premise, from the reference: SVI carries O(K·V) device state, where
Gibbs carries a few bytes per token, and suits documents that arrive as a
stream and are seen once.  Its speed on the H100 is in ``PERF.md``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.special import digamma

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def _exp_e_log_dirichlet(x: torch.Tensor) -> torch.Tensor:
    """exp(E[log θ]) for rows of a Dirichlet variational parameter."""
    return torch.exp(digamma(x) - digamma(x.sum(dim=-1, keepdim=True)))


def svi_step(
    lam: torch.Tensor,    # [K, V] global variational parameter (float32)
    bow: torch.Tensor,    # [B, V] minibatch bag-of-words (padding rows all-zero)
    rho: float,           # step size
    real: int,            # number of real (non-padding) documents in the batch
    *,
    alpha: float,
    eta: float,
    e_steps: int,
    total_docs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One online-LDA step; returns ``(lam_new, gamma [B, K])``."""
    b = bow.shape[0]
    k = lam.shape[0]
    e_log_beta = _exp_e_log_dirichlet(lam)                 # [K, V]

    gamma = torch.ones((b, k), dtype=torch.float32, device=lam.device)
    for _ in range(e_steps):
        e_log_theta = _exp_e_log_dirichlet(gamma)          # [B, K]
        phinorm = e_log_theta @ e_log_beta + 1e-100        # [B, V]
        gamma = alpha + e_log_theta * ((bow / phinorm) @ e_log_beta.T)

    e_log_theta = _exp_e_log_dirichlet(gamma)
    phinorm = e_log_theta @ e_log_beta + 1e-100
    # all-zero padding rows add nothing to sstats; the scale uses the REAL
    # batch size so the natural-gradient estimate stays unbiased
    sstats = e_log_beta * (e_log_theta.T @ (bow / phinorm))   # [K, V]
    # the reference's float32 scalars: N / real, ρ and 1 − ρ
    scale = float(np.float32(total_docs) / np.float32(real))
    rho32 = np.float32(rho)
    lam_hat = eta + scale * sstats
    lam_new = float(np.float32(1.0) - rho32) * lam + float(rho32) * lam_hat
    return lam_new, gamma


class SviModel:
    """Streaming online-LDA backend with the common InferenceBackend surface.

    One ``sweep()`` = one full pass over the corpus in minibatches (so
    matched-budget comparisons against Gibbs sweeps stay meaningful).
    """

    def __init__(
        self,
        config: LdaConfig,
        corpus: FlatCorpus,
        batch_size: int = 64,
        tau0: float = 1.0,
        kappa: float = 0.7,
        eta: Optional[float] = None,
        e_steps: int = 20,
        *,
        device: Any = "cuda",
        lam0: Optional[np.ndarray] = None,
    ) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.batch_size = min(batch_size, max(1, corpus.num_docs))
        self.tau0, self.kappa = tau0, kappa
        self.eta = config.beta if eta is None else eta
        self.e_steps = e_steps
        self.doc_lengths = corpus.doc_lengths()

        k, v, m = config.topic_num, corpus.vocab_size, corpus.num_docs
        if lam0 is None:
            # standard online-LDA start: Gamma(100, 1/100) noise
            gen = torch.Generator().manual_seed(int(config.seed))
            lam = torch._standard_gamma(torch.full((k, v), 100.0),
                                        generator=gen) / 100.0
        else:
            lam = torch.from_numpy(np.array(lam0, np.float32))
            if tuple(lam.shape) != (k, v):
                raise ValueError(f"lam0 is {tuple(lam.shape)}, the model's {(k, v)}")
        self.lam = lam.to(device=self.device, dtype=torch.float32)
        # host-side SPARSE bag-of-words: CSR of unique (doc, word) pairs with
        # counts.  token_doc is doc-major, so one in-doc word sort gives the
        # unique pairs.
        order = np.lexsort((corpus.token_word, corpus.token_doc))
        dw = corpus.token_doc[order].astype(np.int64) * v + corpus.token_word[order]
        new = np.empty(dw.shape[0], bool)
        if dw.shape[0]:
            new[0] = True
            np.not_equal(dw[1:], dw[:-1], out=new[1:])
        uniq = np.flatnonzero(new)
        self._csr_word = corpus.token_word[order][uniq].astype(np.int32)
        self._csr_count = np.diff(np.append(uniq, dw.shape[0])).astype(np.float32)
        doc_of_pair = corpus.token_doc[order][uniq]
        self._csr_ptr = np.zeros(m + 1, np.int64)
        np.cumsum(np.bincount(doc_of_pair, minlength=m), out=self._csr_ptr[1:])
        self._step_idx = 0
        self._sweeps = 0
        self._gamma_full = np.ones((m, k), np.float32)
        self._rng = np.random.default_rng(config.seed)

    def _batch_bow(self, idx: np.ndarray, real: int) -> np.ndarray:
        """Densify one minibatch from the CSR store: ``[B, V]`` float32."""
        v = self.corpus.vocab_size
        bow = np.zeros((len(idx), v), np.float32)
        starts = self._csr_ptr[idx[:real]]
        ends = self._csr_ptr[idx[:real] + 1]
        nnz = (ends - starts).astype(np.int64)
        rows = np.repeat(np.arange(real), nnz)
        cols = np.concatenate(
            [self._csr_word[s:e] for s, e in zip(starts, ends)]
        ) if real else np.zeros(0, np.int32)
        vals = np.concatenate(
            [self._csr_count[s:e] for s, e in zip(starts, ends)]
        ) if real else np.zeros(0, np.float32)
        bow[rows, cols] = vals  # unique pairs: plain assignment
        return bow

    # ------------------------------------------------------------------
    def _epoch(self):
        """Static-shape minibatches: (indices, zero-padded bow, real count)."""
        from ldagibbssampling_tpu_torch.data.stream import minibatch_indices

        for idx, real in minibatch_indices(
            self.corpus.num_docs, self.batch_size, self._rng
        ):
            yield idx, self._batch_bow(idx, real), real

    def sweep(self, n: int = 1) -> None:
        """One sweep = one epoch, its batches streamed to the device by
        ``prefetch_to_device`` while the previous batch's step runs."""
        from ldagibbssampling_tpu_torch.data.stream import prefetch_to_device

        for _ in range(n):
            metas: list = []

            def batches():
                for idx, bow, real in self._epoch():
                    metas.append((idx, real))
                    yield bow

            for bow_dev in prefetch_to_device(batches(), device=self.device):
                idx, real = metas.pop(0)
                rho = (self.tau0 + self._step_idx) ** (-self.kappa)
                self.lam, gamma = svi_step(
                    self.lam, bow_dev, rho, real, alpha=self.config.alpha,
                    eta=self.eta, e_steps=self.e_steps,
                    total_docs=self.corpus.num_docs)
                self._gamma_full[idx[:real]] = gamma[:real].cpu().numpy()
                self._step_idx += 1
            self._sweeps += 1

    @property
    def sweeps_done(self) -> int:
        return self._sweeps

    # ------------------------------------------------------------------
    def save_checkpoint(self, directory: str | Path) -> int:
        """Checkpoint of the whole online-LDA run: λ, the per-document γ
        cache, the step and sweep counters and the host shuffler's
        bit-generator state, so a resumed run draws the remaining minibatch
        sequence the uninterrupted run would have."""
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import save_backend_run

        meta = {
            "step_idx": self._step_idx,
            "sweeps": self._sweeps,
            "rng_state": self._rng.bit_generator.state,
        }
        arrays = {"lam": self.lam, "gamma_full": self._gamma_full}
        return save_backend_run(directory, arrays, meta, self._sweeps)

    def restore_checkpoint(self, directory: str | Path) -> int:
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import (
            restore_backend_run)

        like = {"lam": self.lam, "gamma_full": self._gamma_full}
        arrays, meta = restore_backend_run(directory, like)
        self.lam = arrays["lam"]
        self._gamma_full = arrays["gamma_full"]
        self._step_idx = int(meta["step_idx"])
        self._sweeps = int(meta["sweeps"])
        self._rng.bit_generator.state = meta["rng_state"]
        return self._sweeps

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        lam = self.lam.cpu().numpy().astype(np.float64)
        return lam / lam.sum(axis=1, keepdims=True)

    def theta(self) -> np.ndarray:
        g = self._gamma_full.astype(np.float64)
        return g / g.sum(axis=1, keepdims=True)
