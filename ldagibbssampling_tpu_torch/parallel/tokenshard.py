"""Token-sharded collapsed Gibbs: the sequence-parallel analog.

Counterpart of ``ldagibbssampling_tpu/parallel/tokenshard.py``.  The flat
token stream is split evenly over the ``data`` axis regardless of document
boundaries (``split_tokens``), so one giant document's tokens land on many
shards.  Token doc ids stay GLOBAL; ``ndk [M, K]`` and ``nwk [V, K]`` are
both per-shard replicas reconciled once per sweep, as the reference's
bodies do:

- XLA tier (``:333-346``): ``ndk``, ``nwk`` and ``nk`` each ``+= psum(Δ)``;
- deferred tier (``:151-172``): each shard's K1 walk over a copy of the
  replicated ``ndk`` against the bf16 snapshot of the reconciled table,
  K2's rebuild of its local table, ``nwk = psum(local tables)``,
  ``ndk += psum(Δndk)`` (a straddling document's partial rows add up) and
  ``nk`` the column sum.

The runtime has no fused tier: ``fused`` runs the XLA tier, and a deferred
layout that cannot be made runs the XLA tier too (``:234-266``).  A sweep
is one replay of the runtime's graph (``runtime._build_graph``; the rules
above are ``_reconcile_rules``); ``_eager_sweep_once`` is the same sweep op
by op, the tests' reference.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.hyper import optimize_alpha, optimize_beta
from ldagibbssampling_tpu_torch.models.lda import resolve_device
from ldagibbssampling_tpu_torch.ops.count_kernel import plan_deferred, stack_plans
from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.runtime import (
    MeshRuntime, bincount_table, column_sum, per_tensor, resolve_mesh_tier)
from ldagibbssampling_tpu_torch.parallel.sharding import sort_blocks_inplace

_log = logging.getLogger("ldagibbssampling_tpu_torch")


def split_tokens(corpus: FlatCorpus, num_shards: int, block_size: int = 1):
    """Even contiguous split of the token stream, each shard block-padded:
    int32 ``token_word/token_doc/token_mask [P, T_s]`` with GLOBAL doc ids
    (contiguous ranges keep the reference's scan order within a shard)."""
    t = corpus.num_tokens
    per = -(-max(t, 1) // num_shards)
    t_s = ((per + block_size - 1) // block_size) * block_size
    tw = np.zeros((num_shards, t_s), dtype=np.int32)
    td = np.zeros((num_shards, t_s), dtype=np.int32)
    tm = np.zeros((num_shards, t_s), dtype=np.int32)
    for p in range(num_shards):
        lo = min(p * per, t)
        hi = min(lo + per, t)
        n = hi - lo
        tw[p, :n] = corpus.token_word[lo:hi]
        td[p, :n] = corpus.token_doc[lo:hi]
        tm[p, :n] = 1
    return tw, td, tm


def deferred_token_layout(tw: np.ndarray, td: np.ndarray, tm: np.ndarray,
                          vocab_size: int, block_size: int, num_topics: int = 512):
    """Per-shard ``DeferredPlan``s over ``[P, T_s]`` token arrays with
    global doc ids: ``((tw2, td2, tm2, layout), None)`` or ``(None,
    reason)``, by the rules of ``adlda.deferred_shard_layout`` (reference
    ``:40-96``)."""
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        return None, f"no multiple-of-8 row tile for block_size {block_size}"
    plans = []
    global_freq = np.zeros(max(vocab_size, 1), np.int64)
    for s in range(tw.shape[0]):
        real = tm[s] > 0
        global_freq += np.bincount(tw[s][real], minlength=vocab_size)
        try:
            plans.append(plan_deferred(tw[s][real], td[s][real], vocab_size,
                                       block_size))
        except ValueError as e:
            return None, str(e)
    if global_freq.size and int(global_freq.max()) >= (1 << 24):
        return None, (f"max global word frequency {int(global_freq.max())} "
                      ">= 2^24 would round the reference's float32 tables")
    stacked = stack_plans(plans)
    stacked["row_tile"] = row_tile
    return (stacked["token_word"], stacked["token_doc"], stacked["token_mask"],
            stacked), None


class TokenShardedLda(MeshRuntime):
    """Token-stream-sharded Gibbs over a one-axis mesh (giant-doc mode)."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 mesh: Optional[multihost.Mesh] = None,
                 num_shards: Optional[int] = None, axis: str = "data", *,
                 device: Any = "cuda", noise_mode: str = "internal") -> None:
        resolve_device(device)
        if mesh is None:
            mesh = multihost.line_mesh(num_shards, axis, device)
        self.axis = axis
        self.SPEC = {"z": (axis,), "ndk": (), "nwk": (), "nk": ()}
        self._setup(config, corpus, mesh, noise_mode)
        p = mesh.size
        block = max(1, config.block_size)
        tw, td, tm = split_tokens(corpus, p, block_size=block)
        block = min(block, tw.shape[1])
        self.block_size = block
        use_pallas = resolve_mesh_tier(config.use_pallas, config.draw_method, block)
        if use_pallas == "fused":
            _log.warning("kernel tier: requested 'fused' -> running 'xla' "
                         "(the token-sharded runtime has no fused tier)")
        self._layout, self._row_tile = None, 0
        if use_pallas == "deferred":
            layout, reason = deferred_token_layout(
                tw, td, tm, corpus.vocab_size, block, config.topic_num)
            if layout is None:
                _log.warning("kernel tier: requested 'deferred' -> running "
                             "'xla' (%s)", reason)
            else:
                tw, td, tm, self._layout = layout
                self._row_tile = self._layout["row_tile"]
        self.kernel_tier = "deferred" if self._layout is not None else "xla"
        if config.sort_blocks and block > 1 and self._layout is None:
            sort_blocks_inplace(tw, td, tm, block_size=block)
        self._tw, self._td, self._tm = tw, td, tm
        self.doc_lengths = corpus.doc_lengths()
        k = config.topic_num
        z = self._init_generators(tw.shape, k)
        mask = tm > 0
        ndk = bincount_table(td[mask], z[mask], (corpus.num_docs, k))
        nwk = bincount_table(tw[mask], z[mask], (corpus.vocab_size, k))
        self.load_arrays({"z": z, "ndk": ndk.astype(np.int32),
                          "nwk": nwk.astype(np.int32),
                          "nk": nwk.sum(axis=0).astype(np.int32)})
        tws, tds, tms = (self._put(a, (axis,)) for a in (tw, td, tm))
        self._tokens = {p: (tws[p], tds[p], tms[p]) for p in self.positions}
        self._dl = self._put(self.doc_lengths, ())

    def _reconcile_rules(self) -> list[tuple[str, str, tuple]]:
        a = (self.axis,)
        if self.kernel_tier == "deferred":
            return [("ndk", "add", a), ("nwk", "set", a), ("nk", "colsum", ())]
        return [("ndk", "add", a), ("nwk", "add", a), ("nk", "add", a)]

    def _eager_sweep_once(self, seeds: dict, noise: dict) -> None:
        tier = self.kernel_tier
        new = self._local_sweeps(seeds, noise)
        psum = multihost.psum
        if tier == "deferred":
            dndk = psum({p: new[p][1] - self.ndk[p] for p in new}, self.mesh, self.axis)
            self.ndk = per_tensor(torch.add, self.ndk, dndk)
            self.z = {p: new[p][0] for p in new}
            self.nwk = psum({p: new[p][2] for p in new}, self.mesh, self.axis)
            self.nk = per_tensor(column_sum, self.nwk)
            return
        deltas = {name: psum({p: getattr(new[p], name) - getattr(self, name)[p]
                              for p in new}, self.mesh, self.axis)
                  for name in ("ndk", "nwk", "nk")}
        for name, d in deltas.items():
            setattr(self, name, per_tensor(torch.add, getattr(self, name), d))
        self.z = {p: new[p].z for p in new}

    # ------------------------------------------------------------------
    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        """Minka (α, β): both tables are replicated, so the single-device
        fixed points apply directly (no collective, as the reference)."""
        p0 = self.positions[0]
        self.alpha = float(optimize_alpha(self.ndk[p0], self._dl[p0], self.alpha,
                                          iters=iters))
        self.beta = float(optimize_beta(self.nwk[p0], self.nk[p0], self.beta,
                                        iters=iters))
        return self.alpha, self.beta

    def device_log_likelihood(self) -> float:
        """Training LL: each shard's contiguous token range against the
        replicated tables, the partials summed on the host in float64."""
        from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
            shard_ll_chunks, sum_ll_chunks)

        parts = {p: shard_ll_chunks(self.ndk[p], self.nwk[p], self.nk[p],
                                    *self._tokens[p], self._dl[p], self.alpha,
                                    self.beta) for p in self.positions}
        return sum_ll_chunks(parts, self.mesh)

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        a = self.arrays()
        nwk, nk = a["nwk"].astype(np.float64), a["nk"].astype(np.float64)
        return ((nwk + self.beta) / (nk + nwk.shape[0] * self.beta)).T

    def theta(self) -> np.ndarray:
        ndk = self.arrays()["ndk"].astype(np.float64)
        k = ndk.shape[1]
        return (ndk + self.alpha) / (self.doc_lengths[:, None] + k * self.alpha)

    def check_counts_consistent(self) -> None:
        """Recompute every table serially from ``z`` and compare, every
        replica."""
        z = self.arrays()["z"]
        mask = self._tm > 0
        k = self.config.topic_num
        ndk_ref = bincount_table(self._td[mask], z[mask], (self.corpus.num_docs, k))
        nwk_ref = bincount_table(self._tw[mask], z[mask], (self.corpus.vocab_size, k))
        for p in self.positions:
            np.testing.assert_array_equal(self.ndk[p].cpu().numpy(), ndk_ref)
            np.testing.assert_array_equal(self.nwk[p].cpu().numpy(), nwk_ref)
            np.testing.assert_array_equal(self.nk[p].cpu().numpy(),
                                          nwk_ref.sum(axis=0))
