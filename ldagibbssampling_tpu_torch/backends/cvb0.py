"""CVB0: collapsed variational Bayes (0th-order) LDA.

Counterpart of ``ldagibbssampling_tpu/backends/cvb0.py``; no analog in the
Java code, which is Gibbs-only.  Instead of hard assignments ``z``, every
token carries a responsibility vector γ_t ∈ Δ^K (Asuncion et al. 2009), and
the count tables hold *expected* counts (float32).  The update is Gibbs's
conditional with the token's own γ excluded:

    γ_t ∝ (E[nwk[w_t]] − γ_t + β) · (E[ndk[d_t]] − γ_t + α) / (E[nk] − γ_t + V·β)

pure gather, elementwise, normalise (floor 1e-30), mask and scatter-add of
the delta into ``ndk``, ``nwk`` and ``nk``: no random draw, no argmax.
Blocks of ``block_size`` tokens run in order, as the reference's
``fori_loop`` does.

**Fixed scatter order** (:func:`scatter_rows`).  A float32 ``index_add_``
on CUDA adds with atomics, so its order of additions, and with it the run's
last bits, would change from run to run.  On CUDA the scatters are
``index_put_(..., accumulate=True)``, whose CUDA path sorts the indices (a
stable radix sort) and adds each row's duplicates in that order.  On the
CPU it is the other way round: ``index_put_`` accumulates with atomic adds
across threads, and ``index_add_`` adds the rows one after another in index
order.  Either way the same inputs give the same bits in every run, so a
restored run continues the uninterrupted trajectory bit for bit.  ``nk``'s
delta is a column sum, a fixed reduction.

γ starts from a uniform(0.5, 1.5) draw on a ``torch.Generator`` seeded with
``config.seed`` (the reference's threefry draw cannot be reproduced);
``gamma0`` injects a start instead (the normalised, masked ``[T_pad, K]``
γ, e.g. the reference model's).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def scatter_rows(table: torch.Tensor, index: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """``table[index[i]] += rows[i]`` in a fixed order of additions on either
    device (see the module docstring)."""
    if table.device.type == "cuda":
        table.index_put_((index,), rows, accumulate=True)
    else:
        table.index_add_(0, index, rows)


def cvb0_sweep(
    gamma: torch.Tensor,       # [T_pad, K] responsibilities (padding rows all-zero)
    ndk: torch.Tensor,         # [M, K] expected counts (float32)
    nwk: torch.Tensor,         # [V, K]
    nk: torch.Tensor,          # [K]
    token_word: torch.Tensor,  # [T_pad] int64
    token_doc: torch.Tensor,   # [T_pad] int64
    token_mask: torch.Tensor,  # [T_pad]
    *,
    alpha: float,
    beta: float,
    block_size: int,
) -> torch.Tensor:
    """One CVB0 sweep, block after block, in place on ``gamma``, ``ndk``,
    ``nwk`` and ``nk``; returns the new ``nk`` (a new tensor)."""
    t_pad = gamma.shape[0]
    v = nwk.shape[0]
    # V·β as a Python product, as the reference's static floats form it;
    # each scalar is rounded to float32 by the op that reads it
    vbeta = v * beta
    msk_all = token_mask.to(gamma.dtype)
    for start in range(0, t_pad, block_size):
        sl = slice(start, start + block_size)
        w, d, msk = token_word[sl], token_doc[sl], msk_all[sl]
        g_old = gamma[sl]

        nwk_ex = nwk[w] - g_old
        ndk_ex = ndk[d] - g_old
        nk_ex = nk[None, :] - g_old
        unnorm = (nwk_ex + beta) * (ndk_ex + alpha) / (nk_ex + vbeta)
        g_new = unnorm / torch.clamp(unnorm.sum(dim=1, keepdim=True), min=1e-30)
        g_new = g_new * msk[:, None]  # padding rows stay zero

        delta = g_new - g_old
        scatter_rows(ndk, d, delta)
        scatter_rows(nwk, w, delta)
        nk = nk + delta.sum(dim=0)
        gamma[sl] = g_new
    return nk


def cvb0_sweeps(gamma, ndk, nwk, nk, token_word, token_doc, token_mask,
                n_sweeps: int, *, alpha: float, beta: float,
                block_size: int) -> torch.Tensor:
    """``n_sweeps`` CVB0 sweeps (no host sync between them); returns ``nk``."""
    for _ in range(n_sweeps):
        nk = cvb0_sweep(gamma, ndk, nwk, nk, token_word, token_doc, token_mask,
                        alpha=alpha, beta=beta, block_size=block_size)
    return nk


class Cvb0Model:
    """Deterministic CVB0 backend with the common InferenceBackend surface."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda",
                 gamma0: Optional[np.ndarray] = None) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        k = config.topic_num
        block = max(1, min(config.block_size, max(1, corpus.num_tokens)))
        self.block_size = block
        pc = corpus.pad_to(block)
        self._sorted = bool(config.sort_blocks) and block > 1
        if self._sorted:
            pc, self._perm = pc.sort_within_blocks(block)
        else:
            self._perm = None
        self._padded = pc
        self.doc_lengths = corpus.doc_lengths()

        if gamma0 is None:
            # random simplex start: jitter around uniform, as CVB0 practice
            gen = torch.Generator().manual_seed(int(config.seed))
            noise = torch.rand((pc.num_tokens, k), generator=gen) + 0.5
            g = noise / noise.sum(dim=1, keepdim=True)
            g = (g * torch.from_numpy(pc.token_mask.astype(np.float32))[:, None]).numpy()
        else:
            g = np.asarray(gamma0, np.float32)
            if g.shape != (pc.num_tokens, k):
                raise ValueError(f"gamma0 is {g.shape}, the model's "
                                 f"{(pc.num_tokens, k)}")
        g = g.astype(np.float32)
        ndk = np.zeros((pc.num_docs, k), np.float32)
        nwk = np.zeros((pc.vocab_size, k), np.float32)
        np.add.at(ndk, pc.token_doc, g)
        np.add.at(nwk, pc.token_word, g)
        self.gamma = torch.from_numpy(g).to(self.device)
        self.ndk = torch.from_numpy(ndk).to(self.device)
        self.nwk = torch.from_numpy(nwk).to(self.device)
        self.nk = torch.from_numpy(nwk.sum(axis=0)).to(self.device)

        def dev(x):
            return torch.from_numpy(np.asarray(x, np.int64)).to(self.device)

        self._tw, self._td, self._tm = (dev(pc.token_word), dev(pc.token_doc),
                                        dev(pc.token_mask))
        self._sweeps = 0

    # ------------------------------------------------------------------
    def sweep(self, n: int = 1) -> None:
        self.nk = cvb0_sweeps(
            self.gamma, self.ndk, self.nwk, self.nk, self._tw, self._td,
            self._tm, n, alpha=self.config.alpha, beta=self.config.beta,
            block_size=self.block_size)
        self._sweeps += n

    @property
    def sweeps_done(self) -> int:
        return self._sweeps

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        nwk = self.nwk.cpu().numpy().astype(np.float64)
        nk = self.nk.cpu().numpy().astype(np.float64)
        v = nwk.shape[0]
        return ((nwk + self.config.beta) / (nk + v * self.config.beta)).T

    def theta(self) -> np.ndarray:
        ndk = self.ndk.cpu().numpy().astype(np.float64)
        k = ndk.shape[1]
        return (ndk + self.config.alpha) / (
            self.doc_lengths[:, None] + k * self.config.alpha)

    def z(self) -> np.ndarray:
        """Hard assignments (argmax responsibilities) for artifact export,
        in corpus token order."""
        zs = self.gamma.cpu().numpy().argmax(axis=1).astype(np.int32)
        if self._perm is not None:
            z_orig = np.empty_like(zs)
            z_orig[self._perm] = zs
            zs = z_orig
        return zs[: self.corpus.num_tokens]

    # ------------------------------------------------------------------
    def _arrays(self) -> dict:
        return {"gamma": self.gamma, "ndk": self.ndk, "nwk": self.nwk,
                "nk": self.nk}

    def save_checkpoint(self, directory: str | Path) -> int:
        """Checkpoint of the whole CVB0 state (γ and the expected counts) at
        step ``sweeps_done``.  α and β are constants of this backend (it has
        no Minka path), so a restored run continues the uninterrupted
        trajectory bit for bit."""
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import save_backend_run

        return save_backend_run(directory, self._arrays(),
                                {"sweeps": self._sweeps}, self._sweeps)

    def restore_checkpoint(self, directory: str | Path) -> int:
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import (
            restore_backend_run)

        arrays, meta = restore_backend_run(directory, self._arrays())
        self.gamma, self.ndk = arrays["gamma"], arrays["ndk"]
        self.nwk, self.nk = arrays["nwk"], arrays["nk"]
        self._sweeps = int(meta["sweeps"])
        return self._sweeps

    def check_invariants(self) -> None:
        ndk = self.ndk.cpu().numpy().astype(np.float64)
        nwk = self.nwk.cpu().numpy().astype(np.float64)
        nk = self.nk.cpu().numpy().astype(np.float64)
        np.testing.assert_allclose(ndk.sum(axis=1), self.doc_lengths, rtol=1e-3)
        np.testing.assert_allclose(nwk.sum(axis=0), nk, rtol=1e-3)
        np.testing.assert_allclose(nk.sum(), self.corpus.num_tokens, rtol=1e-3)
