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

**Fixed scatter order** (``ops/cvb0_scatter.py``).  A float32
``index_add_`` on CUDA adds with atomics, so its order of additions, and
with it the run's last bits, would change from run to run.  A block's
document and word ids never change during a run, so the model sorts each
block's ids once, when it is built (``scatter_plan``, one plan per table),
and each scatter adds along that plan: on the card a hand-written kernel
adds each row's rows in ascending token order, on the CPU the serial
``index_add_`` does the same.  Either way the same inputs give the same
bits in every run, so a restored run continues the uninterrupted
trajectory bit for bit.  ``nk``'s delta is a column sum, a fixed reduction.

**One dispatch per sweep.**  The reference runs ``n`` sweeps as one
``jit(fori_loop)`` (``cvb0_sweeps``).  ``Cvb0Model.sweep`` replays one CUDA
graph of a whole sweep per sweep (``ops/graphs.SweepGraph``, which draws
nothing here: no generator, no device seed), over static buffers γ,
``ndk``, ``nwk`` and ``nk``.  Its body is :func:`cvb0_sweep`, in place,
which also runs eagerly: the tests hold the replays to it bitwise.  α, β and V·β
are Python floats that each op rounds to float32 as it reads them, baked
into the graph: this backend has no Minka path.  On the CPU the same body
runs eagerly on the same buffers.

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
from ldagibbssampling_tpu_torch.ops.cvb0_scatter import (
    ScatterPlan, cvb0_scatter, scatter_plan)
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph


def cvb0_sweep(
    gamma: torch.Tensor,       # [T_pad, K] responsibilities (padding rows all-zero)
    ndk: torch.Tensor,         # [M, K] expected counts (float32)
    nwk: torch.Tensor,         # [V, K]
    nk: torch.Tensor,          # [K]
    token_word: torch.Tensor,  # [T_pad] int64
    token_doc: torch.Tensor,   # [T_pad] int64
    token_mask: torch.Tensor,  # [T_pad]
    plans: tuple[ScatterPlan, ScatterPlan],  # by token_doc, by token_word
    *,
    alpha: float,
    beta: float,
    block_size: int,
) -> None:
    """One CVB0 sweep, block after block, in place on ``gamma``, ``ndk``,
    ``nwk`` and ``nk`` (the captured sweep's body)."""
    t_pad = gamma.shape[0]
    v = nwk.shape[0]
    doc_plan, word_plan = plans
    # V·β as a Python product, as the reference's static floats form it;
    # each scalar is rounded to float32 by the op that reads it
    vbeta = v * beta
    msk_all = token_mask.to(gamma.dtype)
    for b, start in enumerate(range(0, t_pad, block_size)):
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
        cvb0_scatter(ndk, delta, doc_plan, b)
        cvb0_scatter(nwk, delta, word_plan, b)
        nk.add_(delta.sum(dim=0))
        gamma[sl] = g_new


def cvb0_sweeps(gamma, ndk, nwk, nk, token_word, token_doc, token_mask, plans,
                n_sweeps: int, *, alpha: float, beta: float,
                block_size: int) -> None:
    """``n_sweeps`` eager CVB0 sweeps in place (no host sync between them)."""
    for _ in range(n_sweeps):
        cvb0_sweep(gamma, ndk, nwk, nk, token_word, token_doc, token_mask, plans,
                   alpha=alpha, beta=beta, block_size=block_size)


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
        g = torch.from_numpy(g.astype(np.float32))
        # the expected counts: the CPU's serial index_add_ in token order
        # (numpy's add.at's sums, many times faster)
        ndk, nwk = (torch.zeros((n, k)).index_add_(
                        0, torch.from_numpy(ids.astype(np.int64)), g)
                    for n, ids in ((pc.num_docs, pc.token_doc),
                                   (pc.vocab_size, pc.token_word)))
        self.gamma = g.to(self.device)
        self.ndk = ndk.to(self.device)
        self.nwk = nwk.to(self.device)
        self.nk = torch.from_numpy(nwk.numpy().sum(axis=0)).to(self.device)

        # each table's scatter plan; their index is the token's row
        self._plans = (scatter_plan(pc.token_doc, block, self.device),
                       scatter_plan(pc.token_word, block, self.device))
        self._td, self._tw = (p.index for p in self._plans)
        self._tm = torch.from_numpy(pc.token_mask.astype(np.int64)).to(self.device)
        self._sweeps = 0
        self.graph = SweepGraph(self._body, self._tables(),
                                vocab_size=pc.vocab_size, num_topics=k,
                                noise_mode="deterministic")

    # ------------------------------------------------------------------
    def _tables(self) -> tuple[torch.Tensor, ...]:
        return self.gamma, self.ndk, self.nwk, self.nk

    def _body(self, bufs, scalars, key, generators, noise) -> None:
        cvb0_sweep(*bufs, self._tw, self._td, self._tm, self._plans,
                   alpha=self.config.alpha, beta=self.config.beta,
                   block_size=self.block_size)

    def sweep(self, n: int = 1) -> None:
        """``n`` sweeps: one graph replay each on the card."""
        if n <= 0:
            return
        self.gamma, self.ndk, self.nwk, self.nk = self.graph(
            self._tables(), self.config.alpha, self.config.beta, n)
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
        return dict(zip(("gamma", "ndk", "nwk", "nk"), self._tables()))

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
