"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 and the operations and bytes of a deferred sweep's kernels.

A frozen copy of the arithmetic that ``PERF.md`` section 6 and the port's
``chip_smoke.py`` (``bound``, ``sample_ops``, ``walk_bound``, the K2 rows)
use, so that no later change to the program moves it.  A bound is the least
time the chip could take: the larger of the bytes at the memory's rate
(each input read once, each output written once) and the operations at the
float32 rate.  The counts are those of the chain that the cells state: a
float32 draw against a bf16 snapshot; a cell that states another precision
brings its own count.
"""

from __future__ import annotations

import dataclasses

import torch

# NVIDIA's H100 data sheet (SXM part, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# K1's internal-noise draw per (token, real topic), counted from the
# kernel's source (csrc/fused_kernel.cu): Philox4x32-10 ~25 integer ops per
# topic, the uniform 3, log ~10, the bf16 reciprocal ~10.
SAMPLE_NOISE_OPS = 48
# the conditional ((w - e + beta) (d - e + alpha) (r + e r^2)) ~10, then the
# score and the argmax ~4
SAMPLE_CONDITIONAL_OPS, SAMPLE_SCORE_OPS = 10, 4
# per (tile, real topic): the reciprocal of the tile's topic total, ~13
SAMPLE_OPS_PER_TILE_TOPIC = 13
# a moved token's count move: -1 and +1 in its doc row and in the totals
MOVE_OPS = 4
# per slot the walk reads its word, doc, mask and topic and writes its
# new topic: 5 int32
WALK_SLOT_BYTES = 4 * 5
# a bf16 snapshot row's bytes per topic
ROW_BYTES = 2
# K2's rebuild reads per stream slot its word, mask and topic (3 int32)
REBUILD_SLOT_BYTES = 12


def counts_chain(config: dict) -> bool:
    """Whether ``config`` states the chain that these counts are of."""
    return (config.get("kernel_compute_dtype"),
            config.get("mirror_dtype")) == ("float32", "bfloat16")


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds for ``nbytes`` of memory traffic and ``ops``
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


@dataclasses.dataclass(frozen=True)
class SweepCounts:
    """What one deferred sweep does, counted from its inputs and its moves:
    summed over the layout's blocks where a count is per block."""

    num_topics: int
    k_pad: int
    v_pad: int
    t_pad: int          # slots of the layout
    block: int
    row_tile: int
    blocks: int
    real: int           # real tokens
    block_words: int    # Σ over blocks of the distinct words in the block
    block_docs: int     # Σ over blocks of the distinct documents
    moved: int          # tokens whose topic changed
    moved_cells: int    # Σ over blocks of doc-topic cells the moves change
    moved_topics: int   # Σ over blocks of topic totals the moves change


def walk_ops(c: SweepCounts) -> int:
    """Float32 operations of K1's walk over a sweep: the draws of every real
    token at every real topic, the tiles' reciprocals, the count moves."""
    k = c.num_topics
    tiles = c.blocks * (c.block // c.row_tile)
    per_draw = SAMPLE_NOISE_OPS + SAMPLE_CONDITIONAL_OPS + SAMPLE_SCORE_OPS
    return (c.real * k * per_draw + tiles * k * SAMPLE_OPS_PER_TILE_TOPIC
            + MOVE_OPS * c.moved)


def walk_bytes(c: SweepCounts) -> int:
    """K1's bytes over a sweep: per block each distinct word's snapshot row
    and each distinct document's counts read once, the topic totals, the
    slots' arrays; a write of each doc cell and total the moves change."""
    return (c.block_words * c.k_pad * ROW_BYTES + c.block_docs * c.num_topics * 4
            + c.blocks * (c.num_topics * 4 + c.block * WALK_SLOT_BYTES)
            + (c.moved_cells + c.moved_topics) * 4)


def walk_bound_s(c: SweepCounts) -> float:
    """The least seconds of K1's walk over a sweep (one launch: bytes and
    operations overlap, so one bound of the totals)."""
    return bound_s(walk_bytes(c), walk_ops(c))


def counts_bound_s(c: SweepCounts) -> float:
    """The least seconds of K2 over a sweep: ``rebuild_counts`` (the stream
    read, the padded ``nwk`` and ``nk`` written; 2 operations a real token)
    plus ``cast_mirror`` (the table read as int32, written as bf16)."""
    table = c.v_pad * c.k_pad
    rebuild = bound_s(c.t_pad * REBUILD_SLOT_BYTES + table * 4 + c.k_pad * 4,
                      2 * c.real)
    cast = bound_s(table * 6, table)
    return rebuild + cast


def sweep_ops(c: SweepCounts) -> int:
    """A sweep's float32 operations: K1's walk, K2's rebuild and cast."""
    return walk_ops(c) + 2 * c.real + c.v_pad * c.k_pad


def _per_block_distinct(block_of: torch.Tensor, key: torch.Tensor) -> int:
    """Σ over blocks of the distinct values of ``key`` in the block."""
    if key.numel() == 0:
        return 0
    span = int(key.max()) + 1
    return int(torch.unique(block_of * span + key).numel())


def sweep_counts(word: torch.Tensor, doc: torch.Tensor, mask: torch.Tensor,
                 z_before: torch.Tensor, z_after: torch.Tensor, *, block: int,
                 row_tile: int, num_topics: int, v_pad: int) -> SweepCounts:
    """The counts of one sweep over a layout's slots (``word``, ``doc``,
    ``mask``) that moved ``z_before`` to ``z_after``."""
    t_pad = int(word.shape[0])
    k = num_topics
    dev = word.device
    block_of = (torch.arange(t_pad, device=dev) // block)[mask]
    w, d = word[mask].long(), doc[mask].long()
    zb, za = z_before[mask].long(), z_after[mask].long()
    moved = za != zb
    mb, md = block_of[moved], d[moved]
    cells = _per_block_distinct(torch.cat((mb, mb)),
                                torch.cat((md * k + zb[moved], md * k + za[moved])))
    topics = _per_block_distinct(torch.cat((mb, mb)),
                                 torch.cat((zb[moved], za[moved])))
    return SweepCounts(
        num_topics=k, k_pad=max(128, (k + 127) // 128 * 128), v_pad=v_pad,
        t_pad=t_pad, block=block, row_tile=row_tile, blocks=t_pad // block,
        real=int(mask.sum()), block_words=_per_block_distinct(block_of, w),
        block_docs=_per_block_distinct(block_of, d), moved=int(moved.sum()),
        moved_cells=cells, moved_topics=topics)

