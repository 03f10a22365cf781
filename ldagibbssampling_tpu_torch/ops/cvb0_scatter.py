"""CVB0's fixed-order scatter on a precomputed plan: one CUDA kernel.

Not the port of a TPU kernel.  The reference's CVB0 sweep adds each block's
``delta [B, K]`` into its expected counts with ``ndk.at[d].add(delta)`` and
``nwk.at[w].add(delta)`` (``ldagibbssampling_tpu/backends/cvb0.py:69-70``).
A block's document and word ids never change during a run, so
:func:`scatter_plan` sorts them once, on the host in numpy, when the model
is built: per block, the stable argsort of the block's ids (block-local
positions), the start of each run of equal ids in that order, each run's
table row, and the block's work units.  A unit is a span of whole runs:
runs of at most ``SHORT_RUN`` rows are packed several to a unit of at most
``UNIT_ROWS`` rows, a longer run is a unit of its own, and the units with
the longest runs come first.  The plan lives on the device.

:func:`cvb0_scatter` adds a block's rows into a table along it
(``csrc/cvb0_scatter.cu``): one CTA per (unit, slab of ``SLAB_COLS`` topic
columns), so a frequent word's run is spread over as many SMs as it has
slabs.  A unit's rows reach shared memory with ``cp.async`` (a lone run
of more than ``UNIT_ROWS`` rows, ``SHORT_RUN`` in a table of several
slabs, through a ring of stages, the next chunks loading while one is
added; a one-slab table's units of runs of at most 8 rows straight into
registers), and one thread per (run, column) adds the run's rows onto the
table's value in ascending token order, one float32 add at a time, with
no atomic: every cell's order of additions is ``table + r_i1 + r_i2 +
...``, so every run gives the same bits.

The plain version (:func:`cvb0_scatter_plain`) is the CPU's serial
``table.index_add_(0, index, rows)``, which adds the rows in token order:
the kernel's order of additions, so the two agree bitwise.  The wrapper
takes a CPU table to it; on a CUDA table it launches the kernel or raises.
The plain version runs only on the CPU, where ``index_add_`` is serial (on
CUDA it adds with atomics, in no fixed order).  ``LAUNCHES`` counts
launches, ``PLAIN_CALLS`` calls of the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ldagibbssampling_tpu_torch.ops._device import LAUNCH_COUNTERS

LAUNCHES = {"cvb0_scatter": 0}
PLAIN_CALLS = {"cvb0_scatter": 0}
LAUNCH_COUNTERS[__name__] = LAUNCHES
_INT32_MAX = 2**31 - 1
# the kernel's geometry (csrc/cvb0_scatter.cu's kUnitRows, kSlabCols; the
# library refuses a launch whose values differ)
UNIT_ROWS = 256  # a unit's rows at most, unless it is one longer run
SHORT_RUN = UNIT_ROWS // 2  # a run of more rows is a unit of its own
SLAB_COLS = 32  # topic columns per CTA


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """The fixed order of one table's scatters, block by block.

    ``index [T_pad]`` (int64) is each token's table row, ``order [T_pad]``
    (int32) each block's block-local positions stably sorted by row, run
    ``r`` is ``order[bounds[r]:bounds[r + 1]]`` (``bounds [R + 1]``, int32
    positions in ``order``) and adds into row ``dest[r]`` (``dest [R]``,
    int32).  Block ``b``'s runs are ``block_runs[b]:block_runs[b + 1]``.
    ``units [U, 4]`` (int32) are the kernel's work units, each runs
    ``units[u, 0]:units[u, 1]`` at positions ``units[u, 2]:units[u, 3]``;
    block ``b``'s are ``block_units[b]:block_units[b + 1]``, the longest
    run's first."""

    index: torch.Tensor
    order: torch.Tensor
    bounds: torch.Tensor
    dest: torch.Tensor
    block_runs: tuple[int, ...]
    block_size: int
    units: torch.Tensor
    block_units: tuple[int, ...]

    @property
    def num_blocks(self) -> int:
        return len(self.block_runs) - 1


def scatter_slabs(k: int) -> list[tuple[int, int]]:
    """``(first column, width)`` of each slab of ``k`` topic columns, in the
    kernel's order: ``SLAB_COLS`` wide but the last."""
    return [(c, min(SLAB_COLS, k - c)) for c in range(0, k, SLAB_COLS)]


def _work_units(starts: np.ndarray, t_pad: int,
                block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The work units of the runs that start at ``starts`` (``[R]``
    positions, block-major) and their blocks' offsets: a run of more than
    ``SHORT_RUN`` rows alone; the others, between two such runs in one
    block, grouped by the window of ``SHORT_RUN`` positions their first row
    lies in (so a unit holds fewer than ``UNIT_ROWS`` rows); in each block
    by the longest run's length, longest first, then in run order."""
    bounds = np.append(starts, t_pad)
    lengths = np.diff(bounds)
    run_block = starts // block_size
    alone = lengths > SHORT_RUN
    # a stretch: runs of one block with no run of its own between them
    new_stretch = np.ones(len(starts), bool)
    new_stretch[1:] = alone[1:] | alone[:-1] | (run_block[1:] != run_block[:-1])
    stretch_start = starts[np.flatnonzero(new_stretch)][np.cumsum(new_stretch) - 1]
    window = (starts - stretch_start) // SHORT_RUN
    new_unit = new_stretch.copy()
    new_unit[1:] |= window[1:] != window[:-1]
    first = np.flatnonzero(new_unit)
    end = np.append(first[1:], len(starts))
    longest = np.maximum.reduceat(lengths, first)
    unit_block = run_block[first]
    by = np.lexsort((-longest, unit_block))  # stable: run order among equals
    first, end, unit_block = first[by], end[by], unit_block[by]
    units = np.stack([first, end, bounds[first], bounds[end]], axis=1)
    block_units = np.searchsorted(unit_block, np.arange(t_pad // block_size + 1))
    return units, block_units


def scatter_plan(index: np.ndarray, block_size: int,
                 device: Any = "cuda") -> ScatterPlan:
    """The plan of scatters by ``index`` (``[T_pad]`` table rows, a multiple
    of ``block_size``), built on the host and moved to ``device``.  Doc-major
    blocks have sorted document ids, so their order is the identity; a
    block with padding, or word ids, is sorted the same way."""
    ids = np.asarray(index, np.int64)
    t_pad = ids.shape[0]
    if block_size < 1 or t_pad % block_size or t_pad == 0:
        raise ValueError(f"{t_pad} tokens: want a positive multiple of the "
                         f"block size {block_size}")
    if ids.min() < 0 or ids.max() > _INT32_MAX or t_pad > _INT32_MAX:
        raise ValueError("rows and positions must fit int32")
    block = np.arange(t_pad, dtype=np.int64) // block_size
    # block-major keys: one stable sort orders every block by row at once
    perm = np.argsort(block * (int(ids.max()) + 1) + ids, kind="stable")
    sorted_ids = ids[perm]
    new = np.ones(t_pad, bool)
    new[1:] = (sorted_ids[1:] != sorted_ids[:-1]) | (block[1:] != block[:-1])
    starts = np.flatnonzero(new)
    bounds = np.append(starts, t_pad).astype(np.int32)
    block_runs = np.searchsorted(starts, np.arange(0, t_pad + 1, block_size))
    units, block_units = _work_units(starts, t_pad, block_size)
    dev = torch.device(device)

    def on(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)

    return ScatterPlan(
        index=on(ids, torch.int64),
        order=on(perm - block * block_size, torch.int32),
        bounds=on(bounds, torch.int32), dest=on(sorted_ids[starts], torch.int32),
        block_runs=tuple(int(x) for x in block_runs), block_size=int(block_size),
        units=on(units, torch.int32),
        block_units=tuple(int(x) for x in block_units))


@functools.cache
def _lib():
    """The library with its entry point's types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("cvb0_scatter")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lda_cvb0_scatter.restype = i32
    lib.lda_cvb0_scatter.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                     i32, i32, vp]
    return _build, lib


def cvb0_scatter_plain(table: torch.Tensor, index: torch.Tensor,
                       rows: torch.Tensor) -> None:
    """``table[index[i]] += rows[i]`` for ``i`` in order: the CPU's serial
    ``index_add_``."""
    if table.device.type != "cpu":
        raise ValueError("the plain scatter runs on the CPU, where index_add_ "
                         f"adds in token order (got {table.device})")
    PLAIN_CALLS["cvb0_scatter"] += 1
    table.index_add_(0, index, rows)


def cvb0_scatter(table: torch.Tensor, rows: torch.Tensor, plan: ScatterPlan,
                 block: int) -> None:
    """``table[i] += rows`` along block ``block`` of ``plan`` (``rows`` is
    the block's ``[B, K]``), each cell's additions in token order."""
    dev = table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b = plan.block_size
    if not 0 <= block < plan.num_blocks:
        raise ValueError(f"block {block} of a plan of {plan.num_blocks}")
    for name, x in (("table", table), ("rows", rows)):
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous 2-d float32 tensor on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    k = table.shape[1]
    if tuple(rows.shape) != (b, k):
        raise ValueError(f"rows {tuple(rows.shape)}: want the block's ({b}, {k})")
    if plan.order.device != dev:
        raise ValueError(f"the plan is on {plan.order.device}, the table on {dev}")
    if dev.type == "cpu":
        cvb0_scatter_plain(table, plan.index[block * b:(block + 1) * b], rows)
        return
    build, lib = _lib()
    u0, u1 = plan.block_units[block], plan.block_units[block + 1]
    wide = max(table.numel(), rows.numel()) > _INT32_MAX
    with torch.cuda.device(dev):
        err = lib.lda_cvb0_scatter(
            table.data_ptr(), rows.data_ptr(), plan.order.data_ptr(),
            plan.bounds.data_ptr(), plan.dest.data_ptr(),
            plan.units.data_ptr() + 16 * u0, u1 - u0, k, UNIT_ROWS, SLAB_COLS,
            int(wide), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_cvb0_scatter")
    LAUNCHES["cvb0_scatter"] += 1
