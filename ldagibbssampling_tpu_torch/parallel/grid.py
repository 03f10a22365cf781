"""2-D grid-parallel collapsed Gibbs: document shards × vocabulary slabs.

Counterpart of ``ldagibbssampling_tpu/parallel/grid.py``.  The mesh has the
axes ``('data', 'vocab')``: row ``i`` owns document shard ``i`` (and a
replica of its exact ``ndk``), column ``j`` owns the ``nwk`` rows of a
contiguous, token-balanced vocabulary range (``partition_vocab``), so each
position holds a ``[V_s, K]`` slab rather than the whole table.  Position
``(i, j)`` sweeps the tokens of shard ``i`` whose words fall in range ``j``
(local word and doc ids).  The conditional's ``V·β`` uses the GLOBAL
vocabulary size.  Reconciliation, as the reference's bodies (``:418-460``,
``:532-560``):

- XLA tier: ``nwk += psum(Δnwk, 'data')``, ``ndk += psum(Δndk, 'vocab')``,
  ``nk += psum(Δnk, ('data', 'vocab'))``;
- fused tier: the same for ``nwk`` and ``ndk``; ``nk`` the ``psum`` over
  ``'vocab'`` of the reconciled slabs' column sums;
- deferred tier: ``nwk = psum(local slab tables, 'data')``, ``ndk +=
  psum(Δndk, 'vocab')``, ``nk = psum(column sums, 'vocab')``.

A sweep is one replay of the runtime's graph (``runtime._build_graph``;
the rules above are ``_reconcile_rules``); ``_eager_sweep_once`` is the
same sweep op by op, the tests' reference.
"""

from __future__ import annotations

import dataclasses
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
from ldagibbssampling_tpu_torch.parallel.adlda import _theta, fused_row_tile
from ldagibbssampling_tpu_torch.parallel.runtime import (
    MeshRuntime, bincount_table, column_sum, per_tensor, resolve_mesh_tier,
    sweep_fn_tier)
from ldagibbssampling_tpu_torch.parallel.sharding import (
    assign_docs, sort_blocks_inplace)

_log = logging.getLogger("ldagibbssampling_tpu_torch")


def partition_vocab(corpus: FlatCorpus, num_parts: int) -> np.ndarray:
    """Contiguous vocabulary boundaries balanced by token frequency:
    ``bounds[num_parts + 1]``, part ``j`` owning ``[bounds[j],
    bounds[j+1])`` (local ids are a subtraction)."""
    v = corpus.vocab_size
    freq = np.bincount(corpus.token_word, minlength=v).astype(np.int64)
    cum = np.cumsum(freq)
    total = int(cum[-1]) if v else 0
    bounds = np.zeros(num_parts + 1, dtype=np.int32)
    bounds[num_parts] = v
    for j in range(1, num_parts):
        bounds[j] = int(np.searchsorted(cum, total * j // num_parts, side="left"))
    for j in range(1, num_parts + 1):  # monotone for one huge word
        bounds[j] = max(bounds[j], bounds[j - 1])
    return bounds


@dataclasses.dataclass(frozen=True)
class GridShards:
    """Per-cell token arrays, stacked ``[Pd, Pv, ...]``: word ids local to
    the cell's vocabulary range, doc ids local to its document shard."""

    token_word: np.ndarray   # int32 [Pd, Pv, T_c]
    token_doc: np.ndarray    # int32 [Pd, Pv, T_c]
    token_mask: np.ndarray   # int32 [Pd, Pv, T_c]
    doc_lengths: np.ndarray  # int32 [Pd, M_s] — full doc lengths (0 = pad doc)
    doc_map: np.ndarray      # int32 [Pd, M_s]
    vocab_bounds: np.ndarray  # int32 [Pv + 1]
    p_data: int
    p_vocab: int
    vocab_size: int
    num_real_tokens: int

    @property
    def tokens_per_cell(self) -> int:
        return int(self.token_word.shape[2])

    @property
    def docs_per_shard(self) -> int:
        return int(self.doc_lengths.shape[1])

    @property
    def vocab_per_shard(self) -> int:
        return int(np.max(np.diff(self.vocab_bounds))) if self.p_vocab else 0


def shard_corpus_grid(corpus: FlatCorpus, p_data: int, p_vocab: int,
                      block_size: int = 1) -> GridShards:
    """Partition the tokens onto a ``p_data × p_vocab`` grid, padded
    uniformly (the reference's vectorised bucketing, ``:109-175``)."""
    lengths = corpus.doc_lengths()
    shard_docs = assign_docs(lengths, p_data)
    bounds = partition_vocab(corpus, p_vocab)
    m_s = max(1, max(len(s) for s in shard_docs))
    num_docs = corpus.num_docs
    shard_of_doc = np.zeros(max(num_docs, 1), np.int32)
    local_of_doc = np.zeros(max(num_docs, 1), np.int32)
    dl = np.zeros((p_data, m_s), dtype=np.int32)
    dmap = np.full((p_data, m_s), -1, dtype=np.int32)
    for i, docs in enumerate(shard_docs):
        idx = np.asarray(docs, np.int64)
        shard_of_doc[idx] = i
        local_of_doc[idx] = np.arange(len(docs), dtype=np.int32)
        dl[i, : len(docs)] = lengths[idx]
        dmap[i, : len(docs)] = idx

    word_part = (np.searchsorted(bounds, corpus.token_word, side="right") - 1
                 ).astype(np.int64)
    group = shard_of_doc[corpus.token_doc].astype(np.int64) * p_vocab + word_part
    num_groups = p_data * p_vocab
    counts = np.bincount(group, minlength=num_groups)
    t_raw = max(1, int(counts.max()))
    t_c = ((t_raw + block_size - 1) // block_size) * block_size
    idx_dt = np.int32 if num_groups * t_c < (1 << 31) else np.int64
    flat = np.empty(group.shape[0], idx_dt)
    for g in range(num_groups):
        m = group == g
        flat[m] = np.arange(g * t_c, g * t_c + int(counts[g]), dtype=idx_dt)
    w_local = (corpus.token_word - bounds[word_part]).astype(np.int64)
    packed = np.zeros(num_groups * t_c, dtype=np.int64)  # (d_local << 32) | w+1
    packed[flat] = (local_of_doc[corpus.token_doc].astype(np.int64) << 32) | (w_local + 1)
    tm = (packed & 0xFFFFFFFF).astype(np.int32)
    tw = (tm - 1).clip(min=0)
    tm = (tm > 0).astype(np.int32)
    tw = np.where(tm > 0, tw, 0).reshape(p_data, p_vocab, t_c)
    td = (packed >> 32).astype(np.int32).reshape(p_data, p_vocab, t_c)
    return GridShards(
        token_word=tw, token_doc=td, token_mask=tm.reshape(p_data, p_vocab, t_c),
        doc_lengths=dl, doc_map=dmap, vocab_bounds=bounds,
        p_data=p_data, p_vocab=p_vocab, vocab_size=corpus.vocab_size,
        num_real_tokens=corpus.num_tokens)


def _grid_word_freq(shards: GridShards, v_slab: int) -> np.ndarray:
    """Global per-word frequencies as ``[Pv, v_slab]`` (local ids)."""
    freq = np.zeros((shards.p_vocab, max(v_slab, 1)), np.int64)
    for i in range(shards.p_data):
        for j in range(shards.p_vocab):
            real = shards.token_mask[i, j] > 0
            freq[j] += np.bincount(shards.token_word[i, j][real],
                                   minlength=max(v_slab, 1))
    return freq


def deferred_grid_layout(shards: GridShards, block_size: int,
                         num_topics: int = 512, v_slab: int = 0):
    """Per-cell ``DeferredPlan``s stacked ``[Pd, Pv, ...]`` (word ids stay
    local to the slab): ``((new_shards, layout), None)`` or ``(None,
    reason)``, by the reference's rules (``:240-329``)."""
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        return None, f"no multiple-of-8 row tile for block_size {block_size}"
    v_slab = v_slab or shards.vocab_per_shard
    freq = _grid_word_freq(shards, v_slab)
    if freq.size and int(freq.max()) >= (1 << 24):
        return None, (f"max global word frequency {int(freq.max())} >= 2^24 "
                      "would round the reference's float32 tables")
    plans = []
    for i in range(shards.p_data):
        for j in range(shards.p_vocab):
            real = shards.token_mask[i, j] > 0
            try:
                plans.append(plan_deferred(shards.token_word[i, j][real],
                                           shards.token_doc[i, j][real],
                                           v_slab, block_size))
            except ValueError as e:
                return None, str(e)
    stacked = stack_plans(plans)
    pd, pv = shards.p_data, shards.p_vocab

    def grid3(name):
        a = stacked[name]
        return a.reshape((pd, pv) + a.shape[1:])

    new_shards = dataclasses.replace(
        shards, token_word=grid3("token_word"), token_doc=grid3("token_doc"),
        token_mask=grid3("token_mask"))
    layout = {name: grid3(name) for name in
              ("perm", "row_gather_idx", "w_local", "tile_stripe")}
    layout.update({n: stacked[n] for n in ("v_loc", "v_pad", "tile", "block_size",
                                           "num_tiles")}, row_tile=row_tile)
    return (new_shards, layout), None


def grid_fused_row_tile(shards: GridShards, block: int,
                        num_topics: int) -> Optional[int]:
    """:func:`adlda.fused_row_tile` of the grid's global word frequencies
    and longest document."""
    max_len = int(shards.doc_lengths.max()) if shards.doc_lengths.size else 0
    return fused_row_tile(_grid_word_freq(shards, shards.vocab_per_shard),
                          max_len, block, num_topics)


def make_grid_sweep_fn(
    shards: GridShards,
    mesh: multihost.Mesh,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    draw_method: str = "gumbel",
    num_sweeps: int = 1,
    sorted_words: bool = False,
    use_pallas: Any = False,
    num_topics: int = 512,
    deferred_layout: Optional[dict] = None,
    noise_mode: str = "internal",
):
    """The grid sweep over a ``('data', 'vocab')`` mesh, as the reference's
    ``make_grid_sweep_fn`` (``:332``): ``run(z, ndk, nwk, nk, seed, sweep)
    -> (z, ndk, nwk, nk)`` over this process's positions' tensors (the
    cells' ``z``, their rows' ``ndk``, their columns' slabs of ``nwk``,
    ``nk``; ``MeshRuntime.sweep_fn``), ``V·β`` with the global vocabulary
    size.  The tier by the reference's rules, as
    ``adlda.make_sharded_sweep_fn`` (``deferred_layout`` from
    :func:`deferred_grid_layout`); ``sorted_words`` and ``noise_mode`` as
    there."""
    del sorted_words
    tier, row_tile = sweep_fn_tier(
        deferred_layout, use_pallas, draw_method, block_size,
        lambda: grid_fused_row_tile(shards, block_size, num_topics),
        "deferred_grid_layout")
    config = LdaConfig(alpha=alpha, beta=beta, topic_num=num_topics,
                       block_size=block_size, draw_method=draw_method)
    runtime = GridLda.__new__(GridLda)
    runtime._setup(config, None, mesh, noise_mode)
    runtime._place(shards, block_size, tier, deferred_layout, row_tile)
    return runtime.sweep_fn(num_sweeps)


class GridLda(MeshRuntime):
    """Document × vocabulary collapsed-Gibbs LDA over a ``('data',
    'vocab')`` mesh."""

    SPEC = {"z": ("data", "vocab"), "ndk": ("data",), "nwk": ("vocab",), "nk": ()}

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 mesh: Optional[multihost.Mesh] = None,
                 p_data: Optional[int] = None, p_vocab: Optional[int] = None, *,
                 device: Any = "cuda", noise_mode: str = "internal") -> None:
        resolve_device(device)
        if mesh is None:
            devices, ranks = multihost.global_devices(device)
            pd = p_data or max(1, len(devices) // (p_vocab or 2))
            pv = p_vocab or max(1, len(devices) // pd)
            if pd * pv > len(devices):
                raise ValueError(f"a {pd}x{pv} grid needs {pd * pv} devices, "
                                 f"have {len(devices)}")
            mesh = multihost.Mesh(("data", "vocab"), (pd, pv),
                                  tuple(devices[:pd * pv]), tuple(ranks[:pd * pv]))
        if mesh.axis_names != ("data", "vocab"):
            raise ValueError(f"GridLda needs a ('data', 'vocab') mesh, got {mesh.axis_names}")
        self._setup(config, corpus, mesh, noise_mode)
        pd, pv = mesh.shape
        block = max(1, config.block_size)
        shards = shard_corpus_grid(corpus, pd, pv, block_size=block)
        block = min(block, shards.tokens_per_cell)
        k = config.topic_num
        v_s = max(1, -(-shards.vocab_per_shard // 128) * 128)  # lane-aligned
        self._v_s = v_s

        use_pallas = resolve_mesh_tier(config.use_pallas, config.draw_method, block)
        tier, layout, row_tile = "xla", None, 0
        if use_pallas == "deferred":
            made, reason = deferred_grid_layout(shards, block, k, v_slab=v_s)
            if made is None:
                _log.warning("kernel tier: requested 'deferred' -> running "
                             "'fused' (%s)", reason)
                use_pallas = "fused"
            else:
                (shards, layout), tier = made, "deferred"
                row_tile = layout["row_tile"]
        if use_pallas == "fused":
            row_tile = grid_fused_row_tile(shards, block, k)
            if row_tile is None:
                _log.warning("kernel tier: requested 'fused' -> running 'xla' "
                             "(no fused grid plan)")
                row_tile = 0
            else:
                tier = "fused"
        if config.sort_blocks and block > 1 and layout is None:
            sort_blocks_inplace(shards.token_word, shards.token_doc,
                                shards.token_mask, block_size=block)
        self._place(shards, block, tier, layout, row_tile)
        sh = self.shards
        z = self._init_generators(sh.token_word.shape, k)
        mask = sh.token_mask > 0
        ndk = np.zeros((pd, sh.docs_per_shard, k), np.int64)
        nwk = np.zeros((pv, v_s, k), np.int64)
        for i in range(pd):
            for j in range(pv):
                sel = mask[i, j]
                ndk[i] += bincount_table(sh.token_doc[i, j][sel], z[i, j][sel],
                                         (sh.docs_per_shard, k))
                nwk[j] += bincount_table(sh.token_word[i, j][sel], z[i, j][sel],
                                         (v_s, k))
        self.load_arrays({"z": z, "ndk": ndk.astype(np.int32),
                          "nwk": nwk.astype(np.int32),
                          "nk": nwk.sum(axis=(0, 1)).astype(np.int32)})

    def _place(self, shards: GridShards, block: int, tier: str,
               layout: Optional[dict], row_tile: int) -> None:
        """The tier and each held cell's token stream on its device."""
        self.shards, self.block_size = shards, block
        self.kernel_tier, self._layout, self._row_tile = tier, layout, row_tile
        tw, td, tm = (self._put(a, ("data", "vocab"))
                      for a in (shards.token_word, shards.token_doc, shards.token_mask))
        self._tokens = {p: (tw[p], td[p], tm[p]) for p in self.positions}
        self._dl = self._put(shards.doc_lengths, ("data",))

    def _reconcile_rules(self) -> list[tuple[str, str, tuple]]:
        nwk = "set" if self.kernel_tier == "deferred" else "add"
        nk = (("nk", "add", ("data", "vocab")) if self.kernel_tier == "xla"
              else ("nk", "colsum", ("vocab",)))
        return [("nwk", nwk, ("data",)), ("ndk", "add", ("vocab",)), nk]

    def _global_vocab(self) -> Optional[int]:
        # V·β with the global vocabulary size, not the slab's height
        return self.shards.vocab_size

    def _eager_sweep_once(self, seeds: dict, noise: dict) -> None:
        tier = self.kernel_tier
        new = self._local_sweeps(seeds, noise)
        psum, mesh = multihost.psum, self.mesh
        if tier == "deferred":
            z = {p: new[p][0] for p in new}
            cell_ndk = {p: new[p][1] for p in new}
            nwk = psum({p: new[p][2] for p in new}, mesh, "data")
        else:
            z = {p: new[p].z for p in new}
            cell_ndk = {p: new[p].ndk for p in new}
            dnwk = psum({p: new[p].nwk - self.nwk[p] for p in new}, mesh, "data")
            nwk = per_tensor(torch.add, self.nwk, dnwk)
        dndk = psum({p: cell_ndk[p] - self.ndk[p] for p in new}, mesh, "vocab")
        ndk = per_tensor(torch.add, self.ndk, dndk)
        if tier == "xla":
            dnk = psum({p: new[p].nk - self.nk[p] for p in new}, mesh,
                       ("data", "vocab"))
            nk = per_tensor(torch.add, self.nk, dnk)
        else:
            nk = psum(per_tensor(column_sum, nwk), mesh, "vocab")
        self.z, self.ndk, self.nwk, self.nk = z, ndk, nwk, nk

    # ------------------------------------------------------------------
    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        """Minka (α, β) on the grid: α's ``ndk`` digamma sums ``psum``'d
        over ``'data'``, β's slab sums over ``'vocab'`` (zero padding rows
        add nothing), as ``models/hyper``'s sharded forms."""
        from ldagibbssampling_tpu_torch.models.hyper import (
            sharded_alpha_update, sharded_beta_update)

        a = sharded_alpha_update(self.ndk, self._dl, self.alpha, self.mesh,
                                 "data", iters=iters)
        b = sharded_beta_update(self.nwk, self.nk, self.beta, self.mesh, "vocab",
                                self.corpus.vocab_size, iters=iters)
        p0 = self.positions[0]
        self.alpha, self.beta = float(a[p0]), float(b[p0])
        return self.alpha, self.beta

    def device_log_likelihood(self) -> float:
        """Training LL: each cell's tokens against its slab and its row's
        ``ndk`` (every token lives in one cell), ``V·β`` with the global V,
        the partials summed on the host in float64."""
        from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
            shard_ll_chunks, sum_ll_chunks)

        parts = {p: shard_ll_chunks(self.ndk[p], self.nwk[p], self.nk[p],
                                    *self._tokens[p], self._dl[p], self.alpha,
                                    self.beta, vocab_size=self.corpus.vocab_size)
                 for p in self.positions}
        return sum_ll_chunks(parts, self.mesh)

    # ------------------------------------------------------------------
    def global_nwk(self, slabs: Optional[np.ndarray] = None) -> np.ndarray:
        """The global ``[V, K]`` word-topic table from the slabs."""
        slabs = self.arrays()["nwk"] if slabs is None else slabs
        bounds = self.shards.vocab_bounds
        out = np.zeros((self.corpus.vocab_size, slabs.shape[-1]), slabs.dtype)
        for j in range(self.shards.p_vocab):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            out[lo:hi] = slabs[j, : hi - lo]
        return out

    def phi(self) -> np.ndarray:
        a = self.arrays()
        nwk = self.global_nwk(a["nwk"]).astype(np.float64)
        nk = a["nk"].astype(np.float64)
        return ((nwk + self.beta) / (nk + nwk.shape[0] * self.beta)).T

    def theta(self) -> np.ndarray:
        return _theta(self.arrays()["ndk"], self.shards.doc_map, self.corpus,
                      self.alpha)

    def check_counts_consistent(self) -> None:
        """Recompute every table serially from ``z`` and compare, every
        replica."""
        z = self.arrays()["z"]
        sh = self.shards
        k = self.config.topic_num
        mask = sh.token_mask > 0
        ndk_ref = np.zeros((sh.p_data, sh.docs_per_shard, k), np.int64)
        nwk_ref = np.zeros((sh.p_vocab, self._v_s, k), np.int64)
        for i in range(sh.p_data):
            for j in range(sh.p_vocab):
                sel = mask[i, j]
                ndk_ref[i] += bincount_table(sh.token_doc[i, j][sel], z[i, j][sel],
                                             (sh.docs_per_shard, k))
                nwk_ref[j] += bincount_table(sh.token_word[i, j][sel], z[i, j][sel],
                                             (self._v_s, k))
        for p in self.positions:
            i, j = self.mesh.coords(p)
            np.testing.assert_array_equal(self.ndk[p].cpu().numpy(), ndk_ref[i])
            np.testing.assert_array_equal(self.nwk[p].cpu().numpy(), nwk_ref[j])
            np.testing.assert_array_equal(self.nk[p].cpu().numpy(),
                                          nwk_ref.sum(axis=(0, 1)))
