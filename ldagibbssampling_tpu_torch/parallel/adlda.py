"""AD-LDA: document-sharded collapsed Gibbs over a mesh of device positions.

Counterpart of ``ldagibbssampling_tpu/parallel/adlda.py``.  Each position
owns a document shard (``sharding.shard_corpus``: whole documents, local doc
ids, padding with ``token_mask = 0`` and ``doc_map = -1``) with its exact
``ndk`` and a replica of the global word-topic table; within a sweep each
shard runs the blocked update against its replica, and at the sweep's end
the replicas are reconciled over the ``data`` axis (Newman et al.'s AD-LDA),
as the reference's ``local_sweeps`` bodies do:

- XLA tier (``:293-301``): ``nwk += psum(Δnwk)``, ``nk += psum(Δnk)``;
- fused tier (``:278-292``): K1 on the live rows plus the count move per
  shard, ``nwk += psum(Δnwk)``, ``nk`` the column sum of the reconciled
  table (K1's running totals are a sampling normaliser only);
- deferred tier (``:397-411``): each shard's K1 walk against the bf16
  snapshot of the reconciled table (K2's ``cast_mirror``), then K2's
  ``rebuild_counts`` of its local table, ``nwk = psum(local tables)`` and
  ``nk`` its column sum.

A sweep is one replay of the runtime's graph (``runtime._build_graph``;
the rules above are ``_reconcile_rules``); ``_eager_sweep_once`` is the
same sweep op by op, the tests' reference.

The tier is resolved as the reference's constructor resolves it
(``:474-506``), without its platform rule: on the card each tier launches
its CUDA kernels, on ``device="cpu"`` their plain versions, and nothing
falls back when a kernel fails.  The mesh's ``deferred`` tier runs K1's
float32 chain on the bf16 snapshot, as the reference's mesh tier does,
whatever the config's ``kernel_compute_dtype`` and ``mirror_dtype``.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.lda import resolve_device
from ldagibbssampling_tpu_torch.ops.count_kernel import plan_deferred, stack_plans
from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.runtime import (
    MeshRuntime, bincount_table, column_sum, per_tensor, resolve_mesh_tier,
    sweep_fn_tier)
from ldagibbssampling_tpu_torch.parallel.sharding import (
    CorpusShards, shard_corpus, sort_blocks_inplace)

_log = logging.getLogger("ldagibbssampling_tpu_torch")


def fused_row_tile(word_freq: np.ndarray, max_doc_len: int, block_size: int,
                   num_topics: int) -> Optional[int]:
    """K1's row tile for the fused tier on a mesh, or ``None`` where the
    reference's ``_fused_shard_plan`` (``:38-95``) refuses the tier: a word
    frequency of 2^23 or more (a shard's float32 working cell could pass
    2^24 mid-sweep), a document of 2^24 tokens, or no multiple-of-8 row
    tile above 2,048 tokens.  The port's K1 indexes ``ndk`` by document and
    needs none of the reference's doc-slab layout."""
    if word_freq.size and int(word_freq.max()) >= (1 << 23):
        return None
    if max_doc_len >= (1 << 24):
        return None
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        if block_size > 2048:
            return None
        row_tile = block_size
    return row_tile


def deferred_shard_layout(
    shards: CorpusShards, block_size: int, num_topics: int = 512,
) -> tuple[Optional[tuple[CorpusShards, dict]], Optional[str]]:
    """Per-shard ``DeferredPlan``s, uniformised and stacked (``stack_plans``).

    Returns ``((new_shards, layout), None)`` with the plans' stripe-aligned
    token arrays (same local doc ids) and ``layout`` the stacked plans plus
    K1's ``row_tile``, or ``(None, reason)`` where the reference's
    ``deferred_shard_layout`` (``:97-171``) refuses: no multiple-of-8 row
    tile, a plan that cannot be made, or a global word frequency of 2^24 or
    more (its float32 cell-exactness rule, kept as the tier rule although
    the port's tables are int32).
    """
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        return None, f"no multiple-of-8 row tile for block_size {block_size}"
    plans = []
    global_freq = np.zeros(shards.vocab_size, np.int64)
    for s in range(shards.num_shards):
        real = shards.token_mask[s] > 0
        tw, td = shards.token_word[s][real], shards.token_doc[s][real]
        global_freq += np.bincount(tw, minlength=shards.vocab_size)
        try:
            plans.append(plan_deferred(tw, td, shards.vocab_size, block_size))
        except ValueError as e:
            return None, str(e)
    if global_freq.size and int(global_freq.max()) >= (1 << 24):
        return None, (f"max global word frequency {int(global_freq.max())} "
                      ">= 2^24 would round the reference's float32 tables")
    stacked = stack_plans(plans)
    new_shards = CorpusShards(
        token_word=stacked["token_word"], token_doc=stacked["token_doc"],
        token_mask=stacked["token_mask"], doc_lengths=shards.doc_lengths,
        doc_map=shards.doc_map, num_shards=shards.num_shards,
        vocab_size=shards.vocab_size, num_real_tokens=shards.num_real_tokens)
    stacked["row_tile"] = row_tile
    return (new_shards, stacked), None


def resolve_shard_tier(config, shards: CorpusShards, block: int):
    """``(tier, shards, layout, row_tile)`` of the reference's
    ``ShardedLda`` constructor and ``make_sharded_sweep_fn``: tier
    ``"deferred"``, ``"fused"`` or ``"xla"`` (``use_pallas=True`` runs the
    XLA tier on a mesh)."""
    use_pallas = resolve_mesh_tier(config.use_pallas, config.draw_method, block)
    if use_pallas == "deferred":
        layout, reason = deferred_shard_layout(shards, block, config.topic_num)
        if layout is not None:
            new_shards, stacked = layout
            return "deferred", new_shards, stacked, stacked["row_tile"]
        _log.warning("kernel tier: requested 'deferred' -> running 'fused' (%s)", reason)
        use_pallas = "fused"
    if use_pallas == "fused":
        row_tile = shard_fused_row_tile(shards, block, config.topic_num)
        if row_tile is not None:
            return "fused", shards, None, row_tile
        _log.warning("kernel tier: requested 'fused' -> running 'xla' "
                     "(no fused shard plan)")
    return "xla", shards, None, 0


def shard_fused_row_tile(shards: CorpusShards, block: int,
                         num_topics: int) -> Optional[int]:
    """:func:`fused_row_tile` of the shards' global word frequencies and
    longest document."""
    freq = np.zeros(max(shards.vocab_size, 1), np.int64)
    for s in range(shards.num_shards):
        real = shards.token_mask[s] > 0
        freq += np.bincount(shards.token_word[s][real], minlength=shards.vocab_size)
    max_len = int(shards.doc_lengths.max()) if shards.doc_lengths.size else 0
    return fused_row_tile(freq, max_len, block, num_topics)


def make_sharded_sweep_fn(
    shards: CorpusShards,
    mesh: multihost.Mesh,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    draw_method: str = "gumbel",
    num_sweeps: int = 1,
    axis: str = "data",
    sorted_words: bool = False,
    use_pallas: Any = False,
    num_topics: int = 512,
    deferred_layout: Optional[dict] = None,
    noise_mode: str = "internal",
):
    """The AD-LDA sweep over ``mesh``, as the reference's
    ``make_sharded_sweep_fn`` (``:174``): ``run(z, ndk, nwk, nk, seed,
    sweep) -> (z, ndk, nwk, nk)`` over this process's positions' tensors
    (``MeshRuntime.sweep_fn``), ``num_sweeps`` sweeps per call, the tables
    reconciled after each.  The tier (``run.kernel_tier``) by the
    reference's rules (``runtime.sweep_fn_tier``): ``deferred_layout`` from
    :func:`deferred_shard_layout`, whose stripe-aligned shards ``shards``
    must be, runs the deferred tier.  ``sorted_words`` is the reference's
    scatter hint, which the port's sweeps do not need (the same result
    either way); ``noise_mode`` the port's noise (``runtime``), in place of
    the reference's ``pallas_interpret``."""
    del sorted_words
    tier, row_tile = sweep_fn_tier(
        deferred_layout, use_pallas, draw_method, block_size,
        lambda: shard_fused_row_tile(shards, block_size, num_topics),
        "deferred_shard_layout")
    config = LdaConfig(alpha=alpha, beta=beta, topic_num=num_topics,
                       block_size=block_size, draw_method=draw_method)
    runtime = ShardedLda.__new__(ShardedLda)
    runtime._start(config, None, mesh, axis, noise_mode)
    runtime._place(shards, block_size, tier, deferred_layout, row_tile)
    return runtime.sweep_fn(num_sweeps)


class ShardedLda(MeshRuntime):
    """Document-sharded AD-LDA over a one-axis mesh."""

    SPEC = {"z": ("data",), "ndk": ("data",), "nwk": (), "nk": ()}

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 mesh: Optional[multihost.Mesh] = None,
                 num_shards: Optional[int] = None, axis: str = "data", *,
                 device: Any = "cuda", noise_mode: str = "internal") -> None:
        resolve_device(device)
        if mesh is None:
            mesh = multihost.line_mesh(num_shards, axis, device)
        self._start(config, corpus, mesh, axis, noise_mode)
        block = max(1, config.block_size)
        shards = shard_corpus(corpus, mesh.size, block_size=block)
        block = min(block, shards.tokens_per_shard)
        # the tier before the state: the deferred tier re-lays out the tokens
        tier, shards, layout, row_tile = resolve_shard_tier(config, shards, block)
        if config.sort_blocks and block > 1 and layout is None:
            sort_blocks_inplace(shards.token_word, shards.token_doc,
                                shards.token_mask, block_size=block)
        self._place(shards, block, tier, layout, row_tile)
        sh, p, k = self.shards, mesh.size, config.topic_num
        z = self._init_generators(sh.token_word.shape, k)
        mask = sh.token_mask > 0
        ndk = np.stack([bincount_table(sh.token_doc[s][mask[s]], z[s][mask[s]],
                                       (sh.docs_per_shard, k)) for s in range(p)])
        nwk = bincount_table(sh.token_word[mask], z[mask], (corpus.vocab_size, k))
        self.load_arrays({"z": z, "ndk": ndk.astype(np.int32),
                          "nwk": nwk.astype(np.int32),
                          "nk": nwk.sum(axis=0).astype(np.int32)})

    def _start(self, config, corpus, mesh, axis: str, noise_mode: str) -> None:
        self.axis = axis
        self.SPEC = {"z": (axis,), "ndk": (axis,), "nwk": (), "nk": ()}
        self._setup(config, corpus, mesh, noise_mode)

    def _place(self, shards: CorpusShards, block: int, tier: str,
               layout: Optional[dict], row_tile: int) -> None:
        """The tier and each held position's token stream on its device."""
        self.shards, self.block_size = shards, block
        self.kernel_tier, self._layout, self._row_tile = tier, layout, row_tile
        tw, td, tm = (self._put(a, (self.axis,))
                      for a in (shards.token_word, shards.token_doc, shards.token_mask))
        self._tokens = {p: (tw[p], td[p], tm[p]) for p in self.positions}
        self._dl = self._put(shards.doc_lengths, (self.axis,))

    def _reconcile_rules(self) -> list[tuple[str, str, tuple]]:
        a = (self.axis,)
        if self.kernel_tier == "deferred":
            return [("nwk", "set", a), ("nk", "colsum", ())]
        if self.kernel_tier == "fused":
            return [("nwk", "add", a), ("nk", "colsum", ())]
        return [("nwk", "add", a), ("nk", "add", a)]

    def _eager_sweep_once(self, seeds: dict, noise: dict) -> None:
        tier = self.kernel_tier
        new = self._local_sweeps(seeds, noise)
        if tier == "deferred":
            # global counts = the sum of the shards' local tables
            self.z = {p: new[p][0] for p in new}
            self.ndk = {p: new[p][1] for p in new}
            self.nwk = multihost.psum({p: new[p][2] for p in new}, self.mesh, self.axis)
            self.nk = per_tensor(column_sum, self.nwk)
            return
        dnwk = multihost.psum({p: new[p].nwk - self.nwk[p] for p in new},
                              self.mesh, self.axis)
        nwk = per_tensor(torch.add, self.nwk, dnwk)
        if tier == "fused":
            nk = per_tensor(column_sum, nwk)
        else:
            dnk = multihost.psum({p: new[p].nk - self.nk[p] for p in new},
                                 self.mesh, self.axis)
            nk = per_tensor(torch.add, self.nk, dnk)
        self.z = {p: new[p].z for p in new}
        self.ndk = {p: new[p].ndk for p in new}
        self.nwk, self.nk = nwk, nk

    # ------------------------------------------------------------------
    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        """Minka (α, β): α from the shards' ``ndk`` digamma sums reconciled
        over the data axis (``models/hyper.sharded_alpha_update``); β from
        the replicated ``nwk`` (no collective, as the reference)."""
        from ldagibbssampling_tpu_torch.models.hyper import (
            optimize_beta, sharded_alpha_update)

        a = sharded_alpha_update(self.ndk, self._dl, self.alpha, self.mesh,
                                 self.axis, iters=iters)
        p0 = self.positions[0]
        self.alpha = float(a[p0])
        self.beta = float(optimize_beta(self.nwk[p0], self.nk[p0], self.beta,
                                        iters=iters))
        return self.alpha, self.beta

    def device_log_likelihood(self) -> float:
        """Training LL: each shard's chunked partials
        (``evaluation/device_metrics.shard_ll_chunks``) against its exact
        ``ndk`` and the replicated tables, summed on the host in float64."""
        from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
            shard_ll_chunks, sum_ll_chunks)

        parts = {p: shard_ll_chunks(self.ndk[p], self.nwk[p], self.nk[p],
                                    *self._tokens[p], self._dl[p], self.alpha,
                                    self.beta) for p in self.positions}
        return sum_ll_chunks(parts, self.mesh)

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        a = self.arrays()
        nwk, nk = a["nwk"], a["nk"]
        return ((nwk + self.beta) / (nk + nwk.shape[0] * self.beta)).T

    def theta(self) -> np.ndarray:
        """``ndk`` gathered back to global document order through
        ``doc_map`` (padding documents dropped)."""
        return _theta(self.arrays()["ndk"], self.shards.doc_map,
                      self.corpus, self.alpha)

    def check_counts_consistent(self) -> None:
        """Recompute every table serially from ``z`` and compare with the
        reconciled tables; raises ``AssertionError`` on any divergence."""
        a = self.arrays()
        sh = self.shards
        k = self.config.topic_num
        mask = sh.token_mask > 0
        z = a["z"]
        nwk_ref = bincount_table(sh.token_word[mask], z[mask],
                                 (self.corpus.vocab_size, k))
        for s in range(sh.num_shards):
            np.testing.assert_array_equal(
                a["ndk"][s], bincount_table(sh.token_doc[s][mask[s]], z[s][mask[s]],
                                            (sh.docs_per_shard, k)))
        for p in self.positions:  # every replica, not only the first
            np.testing.assert_array_equal(self.nwk[p].cpu().numpy(), nwk_ref)
            np.testing.assert_array_equal(self.nk[p].cpu().numpy(),
                                          nwk_ref.sum(axis=0))


def _theta(ndk: np.ndarray, doc_map: np.ndarray, corpus: FlatCorpus,
           alpha: float) -> np.ndarray:
    """θ in global document order from per-shard ``ndk [P, M_s, K]``."""
    k = ndk.shape[-1]
    out = np.zeros((corpus.num_docs, k), dtype=np.float64)
    for s in range(doc_map.shape[0]):
        real = doc_map[s] >= 0
        out[doc_map[s][real]] = ndk[s][real]
    lengths = corpus.doc_lengths()
    return (out + alpha) / (lengths[:, None] + k * alpha)
