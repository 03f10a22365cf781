"""CVB0's fixed-order scatter on a precomputed plan: one CUDA kernel.

Not the port of a TPU kernel.  The reference's CVB0 sweep adds each block's
``delta [B, K]`` into its expected counts with ``ndk.at[d].add(delta)`` and
``nwk.at[w].add(delta)`` (``ldagibbssampling_tpu/backends/cvb0.py:69-70``).
A block's document and word ids never change during a run, so
:func:`scatter_plan` sorts them once, on the host in numpy, when the model
is built: per block, the stable argsort of the block's ids (block-local
positions), the start of each run of equal ids in that order, and each
run's table row.  The plan lives on the device.  :func:`cvb0_scatter` adds
a block's rows into a table along it (``csrc/cvb0_scatter.cu``): one thread
per (run, topic column) adds the run's rows in ascending token order onto
the table's cell, with no atomic, so every run gives the same bits.

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


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """The fixed order of one table's scatters, block by block.

    ``index [T_pad]`` (int64) is each token's table row, ``order [T_pad]``
    (int32) each block's block-local positions stably sorted by row, run
    ``r`` is ``order[bounds[r]:bounds[r + 1]]`` (``bounds [R + 1]``, int32
    positions in ``order``) and adds into row ``dest[r]`` (``dest [R]``,
    int32).  Block ``b``'s runs are ``block_runs[b]:block_runs[b + 1]``."""

    index: torch.Tensor
    order: torch.Tensor
    bounds: torch.Tensor
    dest: torch.Tensor
    block_runs: tuple[int, ...]
    block_size: int

    @property
    def num_blocks(self) -> int:
        return len(self.block_runs) - 1


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
    dev = torch.device(device)

    def on(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)

    return ScatterPlan(
        index=on(ids, torch.int64),
        order=on(perm - block * block_size, torch.int32),
        bounds=on(bounds, torch.int32), dest=on(sorted_ids[starts], torch.int32),
        block_runs=tuple(int(x) for x in block_runs), block_size=int(block_size))


@functools.cache
def _lib():
    """The library with its entry point's types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("cvb0_scatter")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lda_cvb0_scatter.restype = i32
    lib.lda_cvb0_scatter.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp]
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
    r0, r1 = plan.block_runs[block], plan.block_runs[block + 1]
    wide = max(table.numel(), rows.numel()) > _INT32_MAX
    with torch.cuda.device(dev):
        err = lib.lda_cvb0_scatter(
            table.data_ptr(), rows.data_ptr(), plan.order.data_ptr(),
            plan.bounds.data_ptr() + 4 * r0, plan.dest.data_ptr() + 4 * r0,
            r1 - r0, k, int(wide), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_cvb0_scatter")
    LAUNCHES["cvb0_scatter"] += 1
