"""The plain reference for the deferred Gibbs cells, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
works out again, from the corpus and the seed that the benchmark hands to
both sides,

- the deferred layout (``plan_layout``): the reference planner's greedy
  block fill and its word-sorted runs per stripe of 128 words, each run
  padded to 8 slots (the JAX package's ``plan_deferred``, pass 1);
- the chain's start and noise (``ChainSeeds``): the initial topics and each
  sweep's seed, drawn from a ``torch.Generator`` on the host seeded by
  ``--seed``, as the configuration states;
- K1's draws (``tile_draws``): per tile of ``row_tile`` slots in layout
  order, each real token's new topic against the doc counts and topic
  totals as they stand at the tile's start and the sweep-stale bf16
  snapshot of the word-topic counts, under Philox4x32-10 noise keyed by the
  sweep's seed and counted by (slot, topic group of 4, 0, 0): the draw
  ``argmax p / E`` with ``E = -log u`` (the exponential race);
- the count tables (``DocIndex.counts``, ``word_topic_counts``) and the
  bf16 snapshot of the word-topic counts (``snapshot``), a recount of the
  topics.

It reads the program's outputs only to judge them.  Where the draws of a
sweep are followed, the counts at a tile's start are those of the program's
topics before the sweep with the tiles before it redrawn as the program drew
them: the reference follows the program tile by tile (``PERF.md`` says so).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

V_LOC = 128   # words per stripe of the layout
ALIGN = 8     # a run's slots are padded to a multiple of this

_M32 = 0xFFFFFFFF
# Philox4x32's multipliers and key increments (Salmon et al., SC'11)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def row_tile(block: int, num_topics: int) -> int:
    """Slots a tile holds, as the configuration's update order states: the
    largest multiple of 8 dividing the block within ``512 * 512 / k_pad``
    rows (``k_pad``: K rounded up to 128)."""
    k_pad = max(128, round_up(num_topics, 128))
    cap = max(8, (512 * 512 // k_pad) // 8 * 8)
    t = min(cap, block)
    for cand in range(t - t % 8, 7, -8):
        if block % cand == 0:
            return cand
    raise ValueError(f"block {block} has no multiple-of-8 tile")


@dataclasses.dataclass
class Layout:
    """The deferred layout: slot ``i`` holds real token ``perm[i]`` of the
    corpus (-1: a pad), with its word and document; ``blocks`` real tokens
    per block."""

    perm: torch.Tensor        # int64 [t_pad]
    word: torch.Tensor        # int32 [t_pad] (0 at pads)
    doc: torch.Tensor         # int32 [t_pad] (0 at pads)
    mask: torch.Tensor        # bool [t_pad]
    block: int
    blocks: np.ndarray        # real tokens of each block
    v_pad: int

    @property
    def t_pad(self) -> int:
        return int(self.perm.shape[0])


def _fill_blocks(token_word: np.ndarray, block: int) -> list[int]:
    """Pass 1 of the planner: real tokens per block, filled greedily in
    corpus order so that each block's runs, padded to 8 slots, fit."""
    t_real = token_word.shape[0]
    sizes, pos = [], 0
    while pos < t_real:
        n = min(block, t_real - pos)
        while True:
            runs = np.bincount(token_word[pos:pos + n] // V_LOC, minlength=1)
            padded = int(((runs + ALIGN - 1) // ALIGN * ALIGN).sum())
            if padded <= block:
                break
            n -= padded - block
            if n <= 0:
                raise ValueError("block too small for stripe alignment")
        sizes.append(n)
        pos += n
    return sizes or [0]


def plan_layout(token_word: torch.Tensor, token_doc: torch.Tensor,
                vocab_size: int, block: int) -> Layout:
    """The layout of the corpus ``token_word``/``token_doc`` (doc-major, on
    one device): blocks of ``block`` slots; in each, the block's tokens
    sorted by word (stably), one run per stripe of 128 words, each run
    padded to a multiple of 8 slots, the block's tail padded."""
    dev = token_word.device
    sizes = np.asarray(_fill_blocks(token_word.cpu().numpy(), block), np.int64)
    nb = sizes.shape[0]
    v_pad = max(round_up(max(vocab_size, 1), V_LOC), V_LOC)
    stripes = v_pad // V_LOC
    t = token_word.shape[0]
    blk = torch.repeat_interleave(torch.arange(nb, device=dev),
                                  torch.from_numpy(sizes).to(dev), output_size=t)
    word = token_word.long()
    order = torch.sort(blk * v_pad + word, stable=True).indices
    run = blk * stripes + word // V_LOC
    counts = torch.bincount(run, minlength=nb * stripes)
    slots = (counts + ALIGN - 1) // ALIGN * ALIGN
    per_block = slots.view(nb, stripes)
    cursor = (torch.arange(nb, device=dev)[:, None] * block
              + per_block.cumsum(1) - per_block).reshape(-1)
    first = counts.cumsum(0) - counts  # a run's first place in sorted order
    run_sorted = run[order]
    slot = cursor[run_sorted] + torch.arange(t, device=dev) - first[run_sorted]
    t_pad = nb * block
    perm = torch.full((t_pad,), -1, dtype=torch.int64, device=dev)
    perm[slot] = order
    out_word = torch.zeros(t_pad, dtype=torch.int32, device=dev)
    out_doc = torch.zeros(t_pad, dtype=torch.int32, device=dev)
    out_word[slot] = token_word[order]
    out_doc[slot] = token_doc[order]
    return Layout(perm, out_word, out_doc, perm >= 0, block, sizes, v_pad)


class ChainSeeds:
    """The chain's randomness from ``--seed``, as the configuration states
    it: a host ``torch.Generator`` seeded with the seed draws the initial
    topic of every slot (pads too), then the chain seed; a second generator,
    seeded with the chain seed, draws one seed per sweep."""

    def __init__(self, seed: int, t_pad: int, num_topics: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))
        self.z0 = torch.randint(0, num_topics, (t_pad,), generator=gen,
                                dtype=torch.int32)
        chain = int(torch.randint(0, 2**62, (), generator=gen))
        self._gen = torch.Generator().manual_seed(chain)
        self._seeds: list[int] = []

    def sweep_seed(self, sweep: int) -> int:
        """The seed of sweep ``sweep`` (1 is the first)."""
        while len(self._seeds) < sweep:
            self._seeds.append(int(torch.randint(0, 2**63 - 1, (),
                                                 generator=self._gen)))
        return self._seeds[sweep - 1]


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low words of ``a * b`` (both below 2^32) in int64 tensors."""
    t = (a & 0xFFFF) * b               # < 2^48
    u = (a >> 16) * b                  # < 2^48
    mid = t + ((u & 0xFFFF) << 16)     # < 2^49
    return (u >> 16) + (mid >> 32), mid & _M32


def philox_uniforms(seed: int, slots: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``[n, k_pad]`` float32 uniforms of the slots ``slots``: topic ``4g +
    j`` takes word ``j`` of Philox4x32-10 at counter (slot low, slot high,
    g, 0) and key (seed low, seed high); its low 24 bits ``b`` give ``(b +
    0.5) * 2^-24``."""
    n, groups = slots.shape[0], k_pad // 4
    dev = slots.device
    c0 = (slots & _M32)[:, None].expand(n, groups)
    c1 = (slots >> 32)[:, None].expand(n, groups)
    c2 = torch.arange(groups, dtype=torch.int64, device=dev)[None, :].expand(n, groups)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    bits = torch.stack((c0, c1, c2, c3), dim=-1).reshape(n, k_pad)
    return (bits & 0xFFFFFF).to(torch.float32) * 2.0**-24 + 2.0**-25


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def word_topic_counts(layout: Layout, z: torch.Tensor, vocab_size: int,
                      num_topics: int) -> torch.Tensor:
    """``nwk [V, K]`` (int64) recounted from the real slots' topics."""
    m = layout.mask
    key = layout.word[m].long() * num_topics + z[m].long()
    return torch.bincount(key, minlength=vocab_size * num_topics).view(
        vocab_size, num_topics)


def snapshot(nwk: torch.Tensor, v_pad: int, k_pad: int) -> torch.Tensor:
    """The sweep-stale snapshot ``[v_pad, k_pad]``: the counts rounded to
    bf16 (to nearest, ties to even), as float32."""
    out = torch.zeros((v_pad, k_pad), dtype=torch.float32, device=nwk.device)
    out[:nwk.shape[0], :nwk.shape[1]] = nwk.to(torch.float32)
    return _bf16(out)


class DocIndex:
    """The real slots of each document, for counts over a few documents."""

    def __init__(self, layout: Layout, num_docs: int) -> None:
        real = torch.nonzero(layout.mask).view(-1)
        docs = layout.doc[real].long()
        self.slots = real[torch.sort(docs, stable=True).indices]
        self.length = torch.bincount(docs, minlength=num_docs)
        self.start = self.length.cumsum(0) - self.length

    def counts(self, docs: torch.Tensor, z: torch.Tensor, num_topics: int,
               z_after: Optional[torch.Tensor] = None,
               before: int = 0) -> torch.Tensor:
        """``[len(docs), K]`` doc-topic counts of ``docs`` under ``z``, or,
        given ``z_after``, under ``z_after`` at the slots before ``before``."""
        lens = self.length[docs]
        total = int(lens.sum())
        dev = docs.device
        row = torch.repeat_interleave(torch.arange(docs.shape[0], device=dev),
                                      lens, output_size=total)
        first = torch.repeat_interleave(self.start[docs] - (lens.cumsum(0) - lens),
                                        lens, output_size=total)
        idx = self.slots[first + torch.arange(total, device=dev)]
        zm = z[idx] if z_after is None else torch.where(idx < before,
                                                         z_after[idx], z[idx])
        key = row * num_topics + zm.long()
        return torch.bincount(key, minlength=docs.shape[0] * num_topics).view(
            -1, num_topics)


@dataclasses.dataclass(frozen=True)
class Hyper:
    alpha: float
    beta: float
    vocab_size: int
    num_topics: int


def tile_draws(layout: Layout, index: DocIndex, z_before: torch.Tensor,
               z_after: torch.Tensor, tiles: Sequence[int], rows: int,
               seed: int, hyper: Hyper, chunk_cells: int = 1 << 25
               ) -> tuple[int, int]:
    """K1's draws of the tiles ``tiles`` (sorted indices of ``rows``-slot
    tiles) in a sweep from ``z_before`` seeded ``seed``, against the
    program's ``z_after``: returns (real tokens compared, tokens whose topic
    differs).  The counts at a tile's start take ``z_after`` before it and
    ``z_before`` from it on."""
    k = hyper.num_topics
    k_pad = round_up(k, 128)
    dev = z_before.device
    f32 = torch.float32
    alpha = torch.tensor(np.float32(hyper.alpha), device=dev)
    beta = torch.tensor(np.float32(hyper.beta), device=dev)
    vbeta = torch.tensor(np.float32(hyper.vocab_size) * np.float32(hyper.beta),
                         device=dev)
    nwk = word_topic_counts(layout, z_before, hyper.vocab_size, k)
    mirror = snapshot(nwk, layout.v_pad, k_pad)
    m = layout.mask
    nk = torch.bincount(z_before[m].long(), minlength=k)
    cursor = 0
    compared = differ = 0
    per_chunk = max(1, chunk_cells // (rows * k_pad))
    cols = torch.arange(k_pad, device=dev)
    for c in range(0, len(tiles), per_chunk):
        part = tiles[c:c + per_chunk]
        drows, recips, spans = [], [], []
        for t in part:
            a = t * rows
            span = slice(a, a + rows)
            seg = slice(cursor, a)
            nk = (nk + torch.bincount(z_after[seg][m[seg]].long(), minlength=k)
                  - torch.bincount(z_before[seg][m[seg]].long(), minlength=k))
            cursor = a
            td, tm = layout.doc[span].long(), m[span]
            docs = torch.unique(td[tm])
            if docs.numel():
                dc = index.counts(docs, z_before, k, z_after=z_after, before=a)
                row = torch.searchsorted(docs, td).clamp_(max=docs.shape[0] - 1)
                drows.append(dc[row].to(f32))
            else:
                drows.append(torch.zeros((rows, k), dtype=f32, device=dev))
            tot = torch.zeros(k_pad, dtype=f32, device=dev)
            tot[:k] = nk.to(f32)
            recips.append(torch.reciprocal(_bf16(tot + vbeta)).expand(rows, k_pad))
            spans.append(torch.arange(a, a + rows, device=dev))
        slots = torch.cat(spans)
        zb = z_before[slots].long()
        e = (cols[None, :] == zb[:, None]).to(f32)
        w = mirror[layout.word[slots].long()]
        d = torch.nn.functional.pad(torch.cat(drows), (0, k_pad - k))
        r = torch.cat(recips)
        p = ((w - e + beta) * (d - e + alpha)) * (r + e * (r * r))
        del w, d
        inv_e = torch.reciprocal(_bf16(-torch.log(philox_uniforms(seed, slots, k_pad))))
        score = torch.where(cols[None, :] < k, p * inv_e,
                            torch.tensor(-1.0, dtype=f32, device=dev))
        drawn = score.argmax(dim=1)
        real = m[slots]
        compared += int(real.sum())
        differ += int(((drawn != z_after[slots].long()) & real).sum())
    return compared, differ


def doc_topic_cells_off(layout: Layout, index: DocIndex, z: torch.Tensor,
                        ndk: torch.Tensor, docs_per_chunk: int = 1 << 16) -> int:
    """Cells of the program's ``ndk [D, K]`` that differ from a recount of
    ``z``, counted in chunks of documents."""
    d, k = ndk.shape
    off = 0
    for d0 in range(0, d, docs_per_chunk):
        docs = torch.arange(d0, min(d, d0 + docs_per_chunk), device=z.device)
        ref = index.counts(docs, z, k)
        off += int((ref != ndk[d0:d0 + docs.shape[0]].to(ref.device)).sum())
    return off
