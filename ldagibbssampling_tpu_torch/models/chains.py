"""Several independent Gibbs chains with split-R̂ convergence tracking.

Counterpart of ``ldagibbssampling_tpu/models/chains.py``.  Chain ``c``
starts from ``init_state(..., seed=config.seed + c)`` and runs the XLA
tier's sweep (the config's ``draw_method``) with its own
``torch.Generator``, as the reference runs its vmapped XLA sweep
(``kernel_tier="xla"``).  As in the reference, the chains on one device
are one stacked state (``models/state.stack_states``: a leading chain axis
on every table, the token arrays shared) advanced in lockstep: each sweep
is one ``ops/gibbs.gibbs_sweep_chains`` per device, every op of a block
run once for all its chains, and chain ``c`` is bitwise the single-chain
XLA sweep of chain ``c``.  As the reference's ``jit(fori_loop(vmap(...)))``
makes a batch of sweeps one dispatch, a device's batched sweep is one CUDA
graph (``ops/gibbs.xla_sweep_graph``), replayed once per sweep; on the CPU
it runs eagerly.  ``states`` gives each chain's views of a state that no
later sweep modifies (each call makes new tensors).

``sweep(n)`` without recording enqueues the ``n`` sweeps of every chain
and makes no host sync.  With ``record_ll`` each sweep adds the per-chain
training log-likelihood per token: the reference's host
``log_likelihood(phi, theta) / T`` of the float32 point estimates,
computed here in float64 on the chains' device, for every chain of a
device in one pass and one host read.  φ draws feed the split-R̂
accumulators of ``evaluation/diagnostics.py`` straight from each device's
chains: their float64 moments stay on that device and a draw makes no host
sync, where the reference folds host copies with numpy.

Noise: ``noise_mode="internal"`` (each sweep's seed drawn from the chain's
generator), or ``"external"`` with ``sweep(..., noise=noise)`` where
``noise(c, sweep)`` gives chain ``c``'s array for that sweep (see
``ops/gibbs.py``).

Given a ``mesh`` (``parallel/multihost.Mesh``) with a ``chain`` axis, the
chains are spread over that axis's positions, as the reference shards its
stacked chains with ``PartitionSpec("chain")``: chain ``c`` runs on the
device of chain coordinate ``c * size // num_chains``, and the chains of
one device (positions that repeat a device included) are one batch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.diagnostics import r_hat
from ldagibbssampling_tpu_torch.models import state as state_lib
from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.fused_kernel import NOISE_MODES
from ldagibbssampling_tpu_torch.ops.gibbs import sweep_seed, xla_sweep_graph


def ll_sum(phi: torch.Tensor, theta: torch.Tensor, tw: torch.Tensor,
           td: torch.Tensor, mask: Optional[torch.Tensor] = None,
           budget: int = 1 << 26) -> torch.Tensor:
    """``Σ_t log Σ_k θ[d_t, k] φ[k, w_t]`` of each chain, in float64 on the
    tensors' device: ``phi [C, K, V]`` and ``theta [C, M, K]`` give a
    ``[C]`` tensor (``evaluation/metrics.log_likelihood``); where ``mask``
    is given, only its tokens (> 0) count.  Tokens go in chunks of at most
    ``budget`` float64 values per gathered operand."""
    num_chains, k = phi.shape[:2]
    phi_t = phi.transpose(1, 2).to(torch.float64)
    theta64 = theta.to(torch.float64)
    chunk = max(1, budget // (num_chains * k))
    total = torch.zeros(num_chains, dtype=torch.float64, device=phi.device)
    for s in range(0, tw.shape[0], chunk):
        p = (theta64[:, td[s:s + chunk]] * phi_t[:, tw[s:s + chunk]]).sum(dim=2)
        logs = torch.log(torch.clamp(p, min=1e-300))
        if mask is not None:
            logs = torch.where(mask[s:s + chunk] > 0, logs, 0.0)
        total = total + logs.sum(dim=1)
    return total


def _ll_per_token(phi: torch.Tensor, theta: torch.Tensor, tw: torch.Tensor,
                  td: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """:func:`ll_sum` over the real tokens, per token."""
    return ll_sum(phi, theta, tw, td) / max(num_tokens, 1)


def _chain_devices(mesh, num_chains: int) -> list[torch.device]:
    """Each chain's device on ``mesh``'s ``chain`` axis (the chains split
    evenly over it)."""
    if "chain" not in mesh.axis_names:
        raise ValueError(f"a chain mesh needs a 'chain' axis, got {mesh.axis_names}")
    size = mesh.axis_size("chain")
    if num_chains % size:
        raise ValueError(f"{num_chains} chains do not split over chain={size}")
    first = {mesh.coord(p, "chain"): p for p in reversed(range(mesh.size))}
    return [mesh.devices[first[c * size // num_chains]] for c in range(num_chains)]


class ChainSet:
    """``num_chains`` independent XLA-tier chains, stacked and advanced in
    lockstep per device."""

    def __init__(
        self,
        config: LdaConfig,
        corpus: FlatCorpus,
        num_chains: Optional[int] = None,
        mesh: Any = None,
        *,
        device: Any = "cuda",
        noise_mode: str = "internal",
        states: Union[SamplerState, Sequence[SamplerState], None] = None,
    ) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        if noise_mode not in NOISE_MODES:
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.noise_mode = noise_mode
        self.num_chains = num_chains or max(1, config.chains)
        self.chain_devices = [self.device] * self.num_chains
        if mesh is not None:
            self.chain_devices = _chain_devices(mesh, self.num_chains)
        # the chains of each device, in chain order: one stacked batch each
        self._batches: dict[torch.device, list[int]] = {}
        for c, dev in enumerate(self.chain_devices):
            self._batches.setdefault(dev, []).append(c)
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
                    device=self.chain_devices[c],
                )
                for c in range(self.num_chains)
            ]
        elif isinstance(states, SamplerState):  # already stacked
            states = state_lib.unstack_states(states)
        if len(states) != self.num_chains:
            raise ValueError(f"{len(states)} states for {self.num_chains} chains")
        self.generators = [torch.Generator().manual_seed(int(s.seed))
                           for s in states]
        self._stacks = {dev: state_lib.stack_states([states[c] for c in ids], dev)
                        for dev, ids in self._batches.items()}
        self._graphs: dict = {}  # the batched sweep of each device's chains
        # the sweep's token arrays (padded) and the real tokens for the LL
        # (the padded tail is masked off), once per device
        t = corpus.num_tokens

        def on(dev, a, dtype=np.int32):
            return torch.from_numpy(np.asarray(a).astype(dtype)).to(dev)

        self._tokens, self._ll_tokens = {}, {}
        for dev in self._batches:
            self._tokens[dev] = (on(dev, pc.token_word), on(dev, pc.token_doc),
                                 on(dev, pc.token_mask), on(dev, self.doc_lengths))
            self._ll_tokens[dev] = (on(dev, pc.token_word[:t], np.int64),
                                    on(dev, pc.token_doc[:t], np.int64))
        self.ll_trace: list[np.ndarray] = []   # per sweep: [num_chains]
        self.phi_trace: list[np.ndarray] = []  # per recorded draw: [num_chains, K, V]
        self.phi_accum = None   # O(C·K·V) alternative to phi_trace (record_phi)
        self.phi_window = None  # pair-safe doubling-window variant (record_phi_auto)

    # ------------------------------------------------------------------
    @property
    def states(self) -> list[SamplerState]:
        """Each chain's ``SamplerState``: views of its device's stacked
        state, with the chain's ``sweep`` and ``seed``."""
        out: list = [None] * self.num_chains
        for dev, ids in self._batches.items():
            for c, view in zip(ids, state_lib.unstack_states(self._stacks[dev])):
                out[c] = view
        return out

    def _advance(self, n: int, noise: Optional[Callable]) -> None:
        """``n`` sweeps of every chain: per device, ``n`` replays of its
        batched sweep's graph (``ops/gibbs.xla_sweep_graph``; eager on the
        CPU) from its stacked state, which it replaces by new tensors (a
        state or view handed out earlier keeps its values)."""
        if n <= 0:
            return
        cfg = self.config
        for dev, ids in self._batches.items():
            st = self._stacks[dev]
            tables = (st.z, st.ndk, st.nwk, st.nk)
            seeds, u = None, None
            if self.noise_mode == "internal":
                seeds = [tuple(sweep_seed(self.generators[c]) for c in ids)
                         for _ in range(n)]
            elif self.noise_mode == "external":
                if noise is None:
                    raise ValueError("external noise needs noise(chain, sweep)")

                def u(i, ids=ids, sweep=st.sweep, dev=dev):
                    return torch.stack([torch.as_tensor(noise(c, sweep + i))
                                        for c in ids]).to(dev)
            try:
                if dev not in self._graphs:
                    self._graphs[dev] = xla_sweep_graph(
                        tables, *self._tokens[dev], block_size=self.block_size,
                        draw_method=cfg.draw_method, noise_mode=self.noise_mode)
                z, ndk, nwk, nk = self._graphs[dev](tables, cfg.alpha, cfg.beta,
                                                    n, seeds=seeds, noise=u)
            except torch.cuda.OutOfMemoryError as e:
                shape = (len(ids), self.block_size, cfg.topic_num)
                raise torch.cuda.OutOfMemoryError(
                    f"the batched sweep of {len(ids)} chains on {dev} does "
                    f"not fit: its [C, B, K] = {list(shape)} working tensors "
                    f"take {np.prod(shape) * 4 / 2**30:.2f} GiB each in "
                    f"float32 beside the stacked tables; use fewer chains "
                    f"per device or a smaller block_size ({e})") from e
            self._stacks[dev] = SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk,
                                             sweep=st.sweep + n, seed=st.seed)

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

    def _phi_theta(self, dev) -> tuple[torch.Tensor, torch.Tensor]:
        """``[C, K, V]`` φ and ``[C, M, K]`` θ of the chains on ``dev``
        (float32, as ``state_lib.phi_theta``; no host sync)."""
        return state_lib.phi_theta(self._stacks[dev], self._tokens[dev][3],
                                   self.config.alpha, self.config.beta)

    def _phi_draw(self) -> list[tuple[list[int], torch.Tensor]]:
        """Every chain's current φ as the accumulators take it: the chains
        of each device and their ``[C_dev, K, V]`` φ, left on the device."""
        return [(ids, self._phi_theta(dev)[0]) for dev, ids in self._batches.items()]

    def chain_ll(self, c: int) -> float:
        """Chain ``c``'s training log-likelihood (not per token), in float64
        on its device: ``metrics.log_likelihood`` of its point estimates."""
        dev = self.chain_devices[c]
        i = self._batches[dev].index(c)
        phi, theta = self._phi_theta(dev)
        return float(ll_sum(phi[i:i + 1], theta[i:i + 1], *self._ll_tokens[dev])[0])

    def record_ll(self) -> None:
        """Append every chain's current LL per token to ``ll_trace``: one
        batched float64 pass and one host read per device."""
        lls = np.empty(self.num_chains, np.float64)
        for dev, ids in self._batches.items():
            phi, theta = self._phi_theta(dev)
            lls[ids] = _ll_per_token(phi, theta, *self._ll_tokens[dev],
                                     self.corpus.num_tokens).cpu().numpy()
        self.ll_trace.append(lls)

    def _phis(self) -> np.ndarray:
        """``[C, K, V]`` float32: every chain's current φ, on the host (one
        copy per device)."""
        out = np.empty((self.num_chains, self.config.topic_num,
                        self.corpus.vocab_size), np.float32)
        for dev, ids in self._batches.items():
            out[ids] = self._phi_theta(dev)[0].cpu().numpy()
        return out

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
        self.phi_accum.add(self._phi_draw(), half)

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
        self.phi_window.add(self._phi_draw())

    def reset_phi_accumulator(self) -> None:
        """Drop accumulated φ moments (e.g. to re-window after more burn-in)."""
        self.phi_accum = None

    def chain_state(self, c: int) -> SamplerState:
        """Chain ``c``'s ``SamplerState`` (views of its stacked state)."""
        return self.states[c]

    def chain_phi_theta(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        phi, theta = state_lib.phi_theta(self.chain_state(c), self.doc_lengths,
                                         self.config.alpha, self.config.beta)
        return phi.cpu().numpy(), theta.cpu().numpy()

    def check_counts_consistent(self) -> None:
        """Every chain's count tables equal a serial recount of its ``z``
        (the stacked tables read to the host once per device)."""
        from ldagibbssampling_tpu_torch.models.lda import _assert_recount

        pc = self._padded
        mask = pc.token_mask.astype(bool)
        for st in self._stacks.values():
            z, ndk, nwk, nk = (t.cpu().numpy() for t in (st.z, st.ndk, st.nwk, st.nk))
            for i in range(z.shape[0]):
                _assert_recount(pc.token_word[mask], pc.token_doc[mask],
                                z[i][mask], ndk[i], nwk[i], nk[i])

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
        return np.mean(self._phis(), axis=0)


class MultiChainModel:
    """``InferenceBackend`` over :class:`ChainSet` (``config.chains > 1``).

    Artifacts (φ, θ, z) come from chain 0, as the reference's single-chain
    output contract; all chains advance for the R̂ diagnostics (``r_hat()``
    and ``r_hat_phi()``, logged by the runner's metrics rows).
    """

    kernel_tier = "xla"  # ChainSet runs the XLA tier's sweep

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda", mesh: Any = None) -> None:
        self.config = config
        self.corpus = corpus
        self.chains = ChainSet(config, corpus, num_chains=max(2, config.chains),
                               mesh=mesh, device=device)
        self.device = self.chains.device
        self.devices = list(dict.fromkeys(self.chains.chain_devices))
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

    def device_log_likelihood(self) -> float:
        """Chain 0's training LL (the runner's rows), on its device."""
        return self.chains.chain_ll(0)

    def mean_phi(self) -> np.ndarray:
        return self.chains.mean_phi()
