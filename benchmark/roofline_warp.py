"""The yardstick of the WarpLDA sweep's roofline: the least memory traffic
of one sweep of ``backends/warp._warp_sweep_`` at the H100's published
memory rate (``roofline.HBM_BYTES_PER_S``).

The sweep is gathers and elementwise passes; its float32 operations (two
ratios of six products a token) take far less time than its bytes, so the
bound is the bytes alone:

- per real token, its stream read and written once: word, document and
  topic read, topic written, as int32;
- per Metropolis–Hastings step (two a token), each table cell and proposal
  entry it gathers at random, one 32-byte sector each: ``ndk`` and ``nwk``
  at the current and at the proposed topic; the doc step's pooled topic
  ``z[j]``; the word step's pool slot ``perm_w[j]`` and its topic
  ``z[perm_w[j]]``; the topic totals ``nk`` (K cells) stay in cache;
- per token whose topic moved, the reconciliation's four cells (``ndk``
  and ``nwk`` at the old and the new topic) read and written, one sector
  each way.
"""

from __future__ import annotations

import dataclasses

from benchmark.roofline import HBM_BYTES_PER_S

SECTOR = 32
STREAM_BYTES = 4 * 4
DOC_STEP_SECTORS = 4 + 1
WORD_STEP_SECTORS = 4 + 2
MOVE_SECTORS = 4 * 2


@dataclasses.dataclass(frozen=True)
class SweepCounts:
    """What one WarpLDA sweep did: its real tokens and those it moved."""

    real: int
    moved: int


def sweep_bytes(c: SweepCounts) -> int:
    """A sweep's least bytes of memory traffic."""
    per_token = STREAM_BYTES + (DOC_STEP_SECTORS + WORD_STEP_SECTORS) * SECTOR
    return c.real * per_token + c.moved * MOVE_SECTORS * SECTOR


def sweep_bound_s(c: SweepCounts) -> float:
    """The least seconds of a sweep: its bytes at the memory's rate."""
    return sweep_bytes(c) / HBM_BYTES_PER_S
