"""Chains × data: independent Gibbs chains, each document-sharded.

Counterpart of ``ldagibbssampling_tpu/parallel/chaingrid.py``.  A
``('chain', 'data')`` mesh: chain ``c``'s shard ``s`` sits at position
``(c, s)``.  Within a chain the documents are sharded as in AD-LDA
(``adlda.ShardedLda``) and reconciled by ``psum`` over ``'data'`` only,
never across chains (``:150-250``):

- XLA tier: ``nwk += psum(Δnwk, 'data')``, ``nk += psum(Δnk, 'data')``;
- deferred tier: ``nwk = psum(local tables, 'data')``, ``nk`` its column
  sum.

A sweep of every chain is one replay of the runtime's graph
(``runtime._build_graph``; the rules above are ``_reconcile_rules``);
``_eager_sweep_once`` is the same sweep op by op, the tests' reference.

The chain runtime has no fused tier (``fused`` runs the deferred tier) and
no v1-draw tier (``use_pallas=True`` runs XLA), as the reference's
(``:74-108``).  The convergence diagnostics (split-R̂ on the chains' LL
traces and on φ) come from ``evaluation/diagnostics.py``, as in
``models/chains.py``, computed on the devices in float64 where the
reference computes them with numpy on the host: each position's LL
partial from its own ``ndk`` rows, document lengths and its chain's
``nwk``/``nk`` (the host formulas' φ and θ), summed per chain on the host
in position order; each chain's φ from its tables, folded into moments on
its device.  With several processes, each receives the other processes'
chains' ``nwk``/``nk`` only (``multihost.gather``), so every process
reports the R̂ of one process.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import diagnostics
from ldagibbssampling_tpu_torch.models.chains import ll_sum
from ldagibbssampling_tpu_torch.models.hyper import optimize_beta, sharded_alpha_update
from ldagibbssampling_tpu_torch.models.lda import resolve_device
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.adlda import deferred_shard_layout
from ldagibbssampling_tpu_torch.parallel.runtime import (
    MeshRuntime, bincount_table, column_sum, per_tensor)
from ldagibbssampling_tpu_torch.parallel.sharding import shard_corpus

_log = logging.getLogger("ldagibbssampling_tpu_torch")


class ShardedChainSet(MeshRuntime):
    """``num_chains`` independent AD-LDA runs on a ``('chain', 'data')`` mesh."""

    SPEC = {"z": ("chain", "data"), "ndk": ("chain", "data"),
            "nwk": ("chain",), "nk": ("chain",)}

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 num_chains: int = 2, num_shards: Optional[int] = None,
                 mesh: Optional[multihost.Mesh] = None, *,
                 device: Any = "cuda", noise_mode: str = "internal") -> None:
        resolve_device(device)
        if mesh is None:
            devices, ranks = multihost.global_devices(device)
            p = num_shards or max(1, len(devices) // num_chains)
            if num_chains * p > len(devices):
                raise ValueError(f"{num_chains} chains x {p} shards > "
                                 f"{len(devices)} devices")
            n = num_chains * p
            mesh = multihost.Mesh(("chain", "data"), (num_chains, p),
                                  tuple(devices[:n]), tuple(ranks[:n]))
        if mesh.axis_names != ("chain", "data"):
            raise ValueError(f"a chain mesh has the axes ('chain', 'data'), "
                             f"got {mesh.axis_names}")
        self._setup(config, corpus, mesh, noise_mode)
        c, p = mesh.shape
        self.num_chains = c
        block = max(1, config.block_size)
        self.shards = shard_corpus(corpus, p, block_size=block)
        block = min(block, self.shards.tokens_per_shard)
        self.block_size = block

        use_pallas = config.use_pallas
        if use_pallas == "fused":
            use_pallas = "deferred"  # no separate fused tier here
        elif use_pallas is True:
            use_pallas = False  # no v1-draw tier here
        if use_pallas == "deferred" and (config.draw_method != "gumbel" or block < 128):
            use_pallas = False
        self._layout, self._row_tile = None, 0
        if use_pallas == "deferred":
            layout, reason = deferred_shard_layout(self.shards, block, config.topic_num)
            if layout is None:
                _log.warning("kernel tier: requested 'deferred' -> running 'xla' (%s)",
                             reason)
            else:
                self.shards, self._layout = layout
                self._row_tile = self._layout["row_tile"]
        self.kernel_tier = "deferred" if self._layout is not None else "xla"

        sh = self.shards
        k = config.topic_num
        z = self._init_generators((c,) + sh.token_word.shape, k)
        mask = sh.token_mask > 0
        ndk = np.zeros((c, p, sh.docs_per_shard, k), np.int64)
        nwk = np.zeros((c, corpus.vocab_size, k), np.int64)
        for ci in range(c):
            for s in range(p):
                sel = mask[s]
                ndk[ci, s] = bincount_table(sh.token_doc[s][sel], z[ci, s][sel],
                                            (sh.docs_per_shard, k))
                nwk[ci] += bincount_table(sh.token_word[s][sel], z[ci, s][sel],
                                          (corpus.vocab_size, k))
        self.load_arrays({"z": z, "ndk": ndk.astype(np.int32),
                          "nwk": nwk.astype(np.int32),
                          "nk": nwk.sum(axis=1).astype(np.int32)})
        # tokens are replicated over the chains, sharded over the data axis
        tw, td, tm = (self._put(a, ("data",))
                      for a in (sh.token_word, sh.token_doc, sh.token_mask))
        self._tokens = {q: (tw[q], td[q], tm[q]) for q in self.positions}
        self._dl = self._put(sh.doc_lengths, ("data",))
        self.ll_trace: list[np.ndarray] = []
        self.phi_trace: list[np.ndarray] = []
        self.phi_window = None
        self.phi_accum = None

    def _reconcile_rules(self) -> list[tuple[str, str, tuple]]:
        if self.kernel_tier == "deferred":
            return [("nwk", "set", ("data",)), ("nk", "colsum", ())]
        return [("nwk", "add", ("data",)), ("nk", "add", ("data",))]

    def _eager_sweep_once(self, seeds: dict, noise: dict) -> None:
        tier = self.kernel_tier
        new = self._local_sweeps(seeds, noise)
        psum = multihost.psum
        if tier == "deferred":
            # a chain's global table = the psum of its shards' local tables
            self.z = {q: new[q][0] for q in new}
            self.ndk = {q: new[q][1] for q in new}
            self.nwk = psum({q: new[q][2] for q in new}, self.mesh, "data")
            self.nk = per_tensor(column_sum, self.nwk)
            return
        dnwk = psum({q: new[q].nwk - self.nwk[q] for q in new}, self.mesh, "data")
        dnk = psum({q: new[q].nk - self.nk[q] for q in new}, self.mesh, "data")
        self.nwk = per_tensor(torch.add, self.nwk, dnwk)
        self.nk = per_tensor(torch.add, self.nk, dnk)
        self.z = {q: new[q].z for q in new}
        self.ndk = {q: new[q].ndk for q in new}

    def sweep(self, n: int = 1, record_ll: bool = False, record_phi: bool = False,
              noise=None) -> None:
        """``n`` sweeps of every chain; with ``record_ll``/``record_phi`` the
        chains' LL per token (the reference's host ``log_likelihood`` of
        the float64 point estimates, on the devices) / φ is recorded after
        each."""
        if not (record_ll or record_phi):
            super().sweep(n, noise=noise)
            return
        for _ in range(n):
            super().sweep(1, noise=noise)
            self.record(record_ll, record_phi)

    def record(self, ll: bool = True, phi: bool = False) -> None:
        """Append the current per-chain LL per token and/or φ to the traces."""
        if phi:
            self.phi_trace.append(self._phis())
        if ll:
            self.ll_trace.append(self.chain_lls() / max(self.corpus.num_tokens, 1))

    def chain_lls(self, chains: Optional[set] = None) -> np.ndarray:
        """``[C]`` float64: each chain's training LL (not per token), or
        only those of ``chains`` (the others 0).  Each held position adds
        ``log Σ_k θ[d, k] φ[k, w]`` over its real tokens in float64 on its
        device, θ from its ``ndk`` rows and document lengths, φ from its
        chain's ``nwk``/``nk`` (as ``chain_theta``/``chain_phi``); the
        positions' partials, gathered from every process, are summed per
        chain in position order."""
        f64 = torch.float64
        k = self.config.topic_num
        phis, parts = {}, {}
        for q in self.positions:
            c = self.mesh.coord(q, "chain")
            if chains is not None and c not in chains:
                continue
            if id(self.nwk[q]) not in phis:
                phis[id(self.nwk[q])] = self._phi64(self.nwk[q], self.nk[q])
            theta = (self.ndk[q].to(f64) + self.alpha) / (
                self._dl[q].to(f64)[:, None] + k * self.alpha)
            tw, td, tm = self._tokens[q]
            parts[q] = ll_sum(phis[id(self.nwk[q])][None], theta[None],
                              tw.long(), td.long(), tm)[0]
        out = np.zeros(self.num_chains, np.float64)
        for q, partial in sorted(multihost.gather(parts, self.mesh).items()):
            out[self.mesh.coord(q, "chain")] += float(partial)
        return out

    def device_log_likelihood(self) -> float:
        """Chain 0's training LL (the runner's rows), on the devices."""
        return float(self.chain_lls({0})[0])

    def _phi64(self, nwk: torch.Tensor, nk: torch.Tensor) -> torch.Tensor:
        """``[K, V]`` float64 φ of one chain's tables, on their device
        (``chain_phi``'s arithmetic)."""
        f64 = torch.float64
        return ((nwk.to(f64) + self.beta) / (nk.to(f64) + nwk.shape[0] * self.beta)).T

    def _chain_tables(self) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
        """Each chain's ``(nwk, nk)``: its first held position's tensors;
        with several processes, the chains another process holds come from
        it (``multihost.gather`` of the tables of each process's first
        position per chain, and nothing else) onto this process's first
        device."""
        first: dict[int, int] = {}
        for q in self.positions:
            first.setdefault(self.mesh.coord(q, "chain"), q)
        out = {c: (self.nwk[q], self.nk[q]) for c, q in first.items()}
        if multihost.world()[1] > 1:
            nwk = multihost.gather({q: self.nwk[q] for q in first.values()}, self.mesh)
            nk = multihost.gather({q: self.nk[q] for q in first.values()}, self.mesh)
            for q in sorted(nwk):
                c = self.mesh.coord(q, "chain")
                if c not in out:
                    out[c] = (torch.from_numpy(nwk[q]).to(self.device),
                              torch.from_numpy(nk[q]).to(self.device))
        return out

    def _phi_draw(self) -> list[tuple[list[int], torch.Tensor]]:
        """Every chain's float64 φ as the accumulators take it: the chains
        on each device and their stacked ``[C_dev, K, V]`` φ."""
        by_dev: dict = {}
        for c, (nwk, nk) in sorted(self._chain_tables().items()):
            by_dev.setdefault(nwk.device, []).append((c, self._phi64(nwk, nk)))
        return [([c for c, _ in chains], torch.stack([p for _, p in chains]))
                for chains in by_dev.values()]

    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        """Minka (α, β) per chain (α's ``ndk`` sums ``psum``'d over
        ``'data'``, β from the chain's replicated ``nwk``), then averaged
        over the chains: one (α, β) trajectory for every chain, as split-R̂
        needs (reference ``:316-340``)."""
        a = sharded_alpha_update(self.ndk, self._dl, self.alpha, self.mesh,
                                 "data", iters=iters)
        b = per_tensor(lambda nw, nk: optimize_beta(nw, nk, self.beta, iters=iters),
                       self.nwk, self.nk)
        q0 = self.positions[0]
        c = self.num_chains
        self.alpha = float(multihost.psum(a, self.mesh, "chain")[q0] / c)
        self.beta = float(multihost.psum(b, self.mesh, "chain")[q0] / c)
        return self.alpha, self.beta

    # ------------------------------------------------------------------
    def chain_phi(self, ci: int, arrays: Optional[dict] = None) -> np.ndarray:
        a = self.arrays() if arrays is None else arrays
        nwk, nk = a["nwk"][ci], a["nk"][ci]
        return ((nwk + self.beta) / (nk + nwk.shape[0] * self.beta)).T

    def chain_theta(self, ci: int, arrays: Optional[dict] = None) -> np.ndarray:
        from ldagibbssampling_tpu_torch.parallel.adlda import _theta

        a = self.arrays() if arrays is None else arrays
        return _theta(a["ndk"][ci], self.shards.doc_map, self.corpus, self.alpha)

    def chain_z(self, ci: int) -> np.ndarray:
        """Chain ``ci``'s topic assignments in corpus token order (the
        ``.tassign`` artifact)."""
        z = self.arrays()["z"][ci]
        doc_ptr = self.corpus.doc_ptr
        out = np.empty(self.corpus.num_tokens, z.dtype)
        for s in range(self.shards.num_shards):
            zs = z[s]
            if self._layout is not None:
                # slot i holds the shard's compacted-stream token perm[s, i]
                perm = self._layout["perm"][s]
                valid = perm >= 0
                buf = np.empty(int(valid.sum()), zs.dtype)
                buf[perm[valid]] = zs[valid]
                zs = buf
            pos = 0
            for g in self.shards.doc_map[s]:
                if g < 0:
                    continue
                lo, hi = int(doc_ptr[g]), int(doc_ptr[g + 1])
                out[lo:hi] = zs[pos:pos + hi - lo]
                pos += hi - lo
        return out

    def r_hat_ll(self) -> float:
        if len(self.ll_trace) < 4:
            return float("nan")
        return diagnostics.r_hat(np.stack(self.ll_trace, axis=1))

    def _phis(self) -> np.ndarray:
        """``[C, K, V]`` float64: every chain's φ on the host."""
        tables = self._chain_tables()
        return np.stack([self._phi64(*tables[c]).cpu().numpy()
                         for c in range(self.num_chains)])

    def record_phi(self, half: int) -> None:
        """Fold the chains' φ into the running split-R̂ accumulator
        (``diagnostics.PhiRhatAccumulator``; see
        ``models/chains.ChainSet.record_phi``): ``half`` routes the draw to
        split-half 0 or 1."""
        if self.phi_accum is None:
            self.phi_accum = diagnostics.PhiRhatAccumulator(
                self.num_chains, self.config.topic_num, self.corpus.vocab_size)
        self.phi_accum.add(self._phi_draw(), half)

    def record_phi_auto(self) -> None:
        """Fold the chains' φ into the pair-safe doubling-window accumulator."""
        if self.phi_window is None:
            self.phi_window = diagnostics.PhiRhatWindowedAccumulator(
                self.num_chains, self.config.topic_num, self.corpus.vocab_size)
        self.phi_window.add(self._phi_draw())

    def r_hat_phi(self) -> dict:
        if len(self.phi_trace) >= 4:
            return diagnostics.r_hat_phi(np.stack(self.phi_trace, axis=1))
        if self.phi_window is not None:
            return self.phi_window.result()
        if self.phi_accum is not None:
            return self.phi_accum.result()
        return {"max": float("nan"), "p99": float("nan"),
                "frac_gt_1_1": float("nan"), "n_cells": 0, "perms": []}

    def check_counts_consistent(self) -> None:
        """Per chain: every table against a serial recount of its ``z``."""
        a = self.arrays()
        sh = self.shards
        mask = sh.token_mask > 0
        k = self.config.topic_num
        for ci in range(self.num_chains):
            z = a["z"][ci]
            nwk_ref = bincount_table(sh.token_word[mask], z[mask],
                                     (self.corpus.vocab_size, k))
            for s in range(sh.num_shards):
                np.testing.assert_array_equal(
                    a["ndk"][ci, s], bincount_table(
                        sh.token_doc[s][mask[s]], z[s][mask[s]], (sh.docs_per_shard, k)))
            for q in self.positions:
                if self.mesh.coord(q, "chain") == ci:
                    np.testing.assert_array_equal(self.nwk[q].cpu().numpy(), nwk_ref)
                    np.testing.assert_array_equal(self.nk[q].cpu().numpy(),
                                                  nwk_ref.sum(axis=0))


class ShardedChainModel:
    """``InferenceBackend`` over :class:`ShardedChainSet`, the CLI's
    ``--mesh chain=C,data=P``: artifacts (φ, θ, z) from chain 0, every
    chain advancing for the R̂ rows; φ draws go to the doubling-window
    accumulator."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 num_chains: int = 2, num_shards: Optional[int] = None,
                 mesh: Optional[multihost.Mesh] = None, *,
                 device: Any = "cuda", noise_mode: str = "internal") -> None:
        self.config = config
        self.corpus = corpus
        self.chains = ShardedChainSet(config, corpus, num_chains=num_chains,
                                      num_shards=num_shards, mesh=mesh,
                                      device=device, noise_mode=noise_mode)
        self.device = self.chains.device
        self.devices = self.chains.devices

    def sweep(self, n: int = 1) -> None:
        self.chains.sweep(n, record_ll=True)
        self.chains.record_phi_auto()

    @property
    def sweeps_done(self) -> int:
        return self.chains.sweeps_done

    @property
    def kernel_tier(self) -> str:
        return self.chains.kernel_tier

    @property
    def alpha(self) -> float:
        return self.chains.alpha

    @property
    def beta(self) -> float:
        return self.chains.beta

    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        return self.chains.optimize_hyperparameters(iters=iters)

    def save_checkpoint(self, directory) -> int:
        return self.chains.save_checkpoint(directory)

    def restore_checkpoint(self, directory) -> int:
        return self.chains.restore_checkpoint(directory)

    def phi(self) -> np.ndarray:
        return self.chains.chain_phi(0)

    def theta(self) -> np.ndarray:
        return self.chains.chain_theta(0)

    def z(self) -> np.ndarray:
        return self.chains.chain_z(0)

    def r_hat(self) -> float:
        return self.chains.r_hat_ll()

    def r_hat_phi(self) -> dict:
        return self.chains.r_hat_phi()

    def device_log_likelihood(self) -> float:
        return self.chains.device_log_likelihood()

    def check_counts_consistent(self) -> None:
        self.chains.check_counts_consistent()
