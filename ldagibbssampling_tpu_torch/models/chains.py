"""Several independent Gibbs chains with split-R̂ convergence tracking.

Counterpart of ``ldagibbssampling_tpu/models/chains.py``.  Chain ``c``
starts from ``init_state(..., seed=config.seed + c)`` and runs the XLA
tier's sweep (``ops/gibbs.gibbs_sweep``, ``use_pallas=False``, the
config's ``draw_method``) with its own ``torch.Generator``, as the
reference runs its vmapped XLA sweep (``kernel_tier="xla"``).  The chains
share the token arrays and are advanced one after another: each chain is
exactly the single-chain XLA sweep.  A batched ``[C, ...]`` form is left to
a later speed change (ROADMAP Queue 3).

``sweep(n)`` without recording enqueues the ``n`` sweeps of every chain
and makes no host sync.  With ``record_ll`` each sweep adds the per-chain
training log-likelihood per token: the reference's host
``log_likelihood(phi, theta) / T`` of the float32 point estimates,
computed here in float64 on the chains' device.  φ draws feed the split-R̂
accumulators of ``evaluation/diagnostics.py``.

Noise: ``noise_mode="internal"`` (each sweep's seed drawn from the chain's
generator), or ``"external"`` with ``sweep(..., noise=noise)`` where
``noise(c, sweep)`` gives chain ``c``'s array for that sweep (see
``ops/gibbs.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.diagnostics import r_hat
from ldagibbssampling_tpu_torch.models import state as state_lib
from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

_MESH_ERROR = "a chain mesh is not ported (ROADMAP Queue 1 item 14)"


def _ll_per_token(phi: torch.Tensor, theta: torch.Tensor, tw: torch.Tensor,
                  td: torch.Tensor, num_tokens: int,
                  chunk: int = 1 << 18) -> torch.Tensor:
    """``Σ_t log Σ_k θ[d_t, k] φ[k, w_t] / T`` in float64 on the tensors'
    device (a 0-d tensor): ``evaluation/metrics.log_likelihood`` / T."""
    phi_t = phi.T.to(torch.float64)
    theta64 = theta.to(torch.float64)
    total = torch.zeros((), dtype=torch.float64, device=phi.device)
    for s in range(0, tw.shape[0], chunk):
        p = (theta64[td[s:s + chunk]] * phi_t[tw[s:s + chunk]]).sum(dim=1)
        total = total + torch.log(torch.clamp(p, min=1e-300)).sum()
    return total / max(num_tokens, 1)


class ChainSet:
    """``num_chains`` independent XLA-tier chains on one device."""

    def __init__(
        self,
        config: LdaConfig,
        corpus: FlatCorpus,
        num_chains: Optional[int] = None,
        mesh: Any = None,
        *,
        device: Any = "cuda",
        noise_mode: str = "internal",
        states: Optional[Sequence[SamplerState]] = None,
    ) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        if mesh is not None:
            raise NotImplementedError(_MESH_ERROR)
        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.num_chains = num_chains or max(1, config.chains)
        block = max(1, min(config.block_size, max(1, corpus.num_tokens)))
        self.block_size = block
        pc = corpus.pad_to(block)
        self._padded = pc
        self.doc_lengths = corpus.doc_lengths()

        if states is None:
            states = [
                state_lib.init_state(
                    pc.token_word, pc.token_doc, pc.token_mask,
                    num_docs=pc.num_docs, vocab_size=pc.vocab_size,
                    num_topics=config.topic_num, seed=config.seed + c,
                    device=self.device,
                )
                for c in range(self.num_chains)
            ]
        elif len(states) != self.num_chains:
            raise ValueError(f"{len(states)} states for {self.num_chains} chains")
        self.states: list[SamplerState] = list(states)
        self.generators = [torch.Generator().manual_seed(s.seed)
                           for s in self.states]
        self._run = make_sweep_fn(
            pc.token_word, pc.token_doc, pc.token_mask, self.doc_lengths,
            alpha=config.alpha, beta=config.beta, block_size=block,
            draw_method=config.draw_method, use_pallas=False,
            num_topics=config.topic_num, device=self.device,
            noise_mode=noise_mode,
        )
        # the real tokens, for the LL (the padded tail is masked off)
        t = corpus.num_tokens
        self._tw = torch.from_numpy(pc.token_word[:t].astype(np.int64)).to(self.device)
        self._td = torch.from_numpy(pc.token_doc[:t].astype(np.int64)).to(self.device)
        self.ll_trace: list[np.ndarray] = []   # per sweep: [num_chains]
        self.phi_trace: list[np.ndarray] = []  # per recorded draw: [num_chains, K, V]
        self.phi_accum = None   # O(C·K·V) alternative to phi_trace (record_phi)
        self.phi_window = None  # pair-safe doubling-window variant (record_phi_auto)

    # ------------------------------------------------------------------
    def _advance(self, n: int, noise: Optional[Callable]) -> None:
        for c in range(self.num_chains):
            self.states[c] = self._run(
                self.states[c], n_sweeps=n, generator=self.generators[c],
                noise=None if noise is None else (lambda s, c=c: noise(c, s)))

    def sweep(
        self, n: int = 1, record_ll: bool = False, record_phi: bool = False,
        noise: Optional[Callable[[int, int], torch.Tensor]] = None,
    ) -> None:
        """``n`` sweeps of every chain; with ``record_ll``/``record_phi`` one
        per-chain LL (per token) / φ draw is recorded after each sweep."""
        if not (record_ll or record_phi):
            self._advance(n, noise)
            return
        for _ in range(n):
            self._advance(1, noise)
            if record_ll:
                self.record_ll()
            if record_phi:
                self.phi_trace.append(self._phis())

    def record_ll(self) -> None:
        """Append every chain's current LL per token to ``ll_trace`` (one
        host read for all chains)."""
        lls = []
        for c in range(self.num_chains):
            phi, theta = self._phi_theta(c)
            lls.append(_ll_per_token(phi, theta, self._tw, self._td,
                                     self.corpus.num_tokens))
        self.ll_trace.append(torch.stack(lls).cpu().numpy())

    def _phi_theta(self, c: int) -> tuple[torch.Tensor, torch.Tensor]:
        return state_lib.phi_theta(self.states[c], self.doc_lengths,
                                   self.config.alpha, self.config.beta)

    def _phis(self) -> np.ndarray:
        """``[C, K, V]`` float32: every chain's current φ, on the host."""
        return torch.stack([self._phi_theta(c)[0]
                            for c in range(self.num_chains)]).cpu().numpy()

    def record_phi(self, half: int) -> None:
        """Fold the current φ of every chain into the running split-R̂
        accumulator (``diagnostics.PhiRhatAccumulator``), the O(C·K·V)
        replacement for ``sweep(record_phi=True)``'s stored draws.
        ``half`` routes the draw to split-half 0 or 1; the caller owns the
        recording schedule (first half of the window -> 0)."""
        from ldagibbssampling_tpu_torch.evaluation.diagnostics import (
            PhiRhatAccumulator)

        if self.phi_accum is None:
            self.phi_accum = PhiRhatAccumulator(
                self.num_chains, self.config.topic_num, self.corpus.vocab_size)
        self.phi_accum.add(self._phis(), half)

    def record_phi_auto(self) -> None:
        """Fold the current φ of every chain into the pair-safe doubling-window
        accumulator (``diagnostics.PhiRhatWindowedAccumulator``): safe to call
        once per sweep with no known horizon; ``r_hat_phi()`` then never
        reports init-transient draws.  :class:`MultiChainModel` records
        through this; the benchmark ladder keeps its own windows via
        ``record_phi``."""
        from ldagibbssampling_tpu_torch.evaluation.diagnostics import (
            PhiRhatWindowedAccumulator)

        if self.phi_window is None:
            self.phi_window = PhiRhatWindowedAccumulator(
                self.num_chains, self.config.topic_num, self.corpus.vocab_size)
        self.phi_window.add(self._phis())

    def reset_phi_accumulator(self) -> None:
        """Drop accumulated φ moments (e.g. to re-window after more burn-in)."""
        self.phi_accum = None

    def chain_state(self, c: int) -> SamplerState:
        return self.states[c]

    def chain_phi_theta(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        phi, theta = self._phi_theta(c)
        return phi.cpu().numpy(), theta.cpu().numpy()

    def check_counts_consistent(self) -> None:
        """Every chain's count tables equal a serial recount of its ``z``."""
        from ldagibbssampling_tpu_torch.models.lda import _assert_recount

        pc = self._padded
        mask = pc.token_mask.astype(bool)
        for s in self.states:
            _assert_recount(pc.token_word[mask], pc.token_doc[mask],
                            s.z.cpu().numpy()[mask], s.ndk.cpu().numpy(),
                            s.nwk.cpu().numpy(), s.nk.cpu().numpy())

    # ------------------------------------------------------------------
    def r_hat_ll(self) -> float:
        """Split-R̂ on the per-chain log-likelihood traces (needs ≥4 draws)."""
        if len(self.ll_trace) < 4:
            return float("nan")
        return r_hat(np.stack(self.ll_trace, axis=1))

    def r_hat_phi(self) -> dict:
        """Topic-aligned split-R̂ on φ: stored draws
        (``sweep(record_phi=True)``) when there are four or more, else the
        windowed accumulator, else the running one; chains are aligned to
        chain 0 first (label switching)."""
        from ldagibbssampling_tpu_torch.evaluation.diagnostics import r_hat_phi

        if len(self.phi_trace) >= 4:
            return r_hat_phi(np.stack(self.phi_trace, axis=1))
        if self.phi_window is not None:
            return self.phi_window.result()
        if self.phi_accum is not None:
            return self.phi_accum.result()
        return {"max": float("nan"), "p99": float("nan"),
                "frac_gt_1_1": float("nan"), "n_cells": 0, "perms": []}

    def mean_phi(self) -> np.ndarray:
        """Posterior-averaged φ across chains (label switching caveat: chains
        are averaged in the permutation-invariant predictive sense only)."""
        phis = [self.chain_phi_theta(c)[0] for c in range(self.num_chains)]
        return np.mean(phis, axis=0)


class MultiChainModel:
    """``InferenceBackend`` over :class:`ChainSet` (``config.chains > 1``).

    Artifacts (φ, θ, z) come from chain 0, as the reference's single-chain
    output contract; all chains advance for the R̂ diagnostics (``r_hat()``
    and ``r_hat_phi()``, logged by the runner's metrics rows).
    """

    kernel_tier = "xla"  # ChainSet runs the XLA tier's sweep

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda", mesh: Any = None) -> None:
        if mesh is not None:
            raise NotImplementedError(_MESH_ERROR)
        self.config = config
        self.corpus = corpus
        self.chains = ChainSet(config, corpus, num_chains=max(2, config.chains),
                               device=device)
        self.device = self.chains.device
        self._sweeps = 0

    def sweep(self, n: int = 1) -> None:
        self.chains.sweep(n, record_ll=True)
        self._sweeps += n
        # one φ draw per call into the doubling-window accumulator: valid at
        # every horizon, and its window never holds the init transient
        self.chains.record_phi_auto()

    @property
    def sweeps_done(self) -> int:
        return self._sweeps

    def phi(self) -> np.ndarray:
        return self.chains.chain_phi_theta(0)[0]

    def theta(self) -> np.ndarray:
        return self.chains.chain_phi_theta(0)[1]

    def z(self) -> np.ndarray:
        return self.chains.chain_state(0).z.cpu().numpy()[: self.corpus.num_tokens]

    def r_hat(self) -> float:
        return self.chains.r_hat_ll()

    def r_hat_phi(self) -> dict:
        return self.chains.r_hat_phi()

    def mean_phi(self) -> np.ndarray:
        return self.chains.mean_phi()
