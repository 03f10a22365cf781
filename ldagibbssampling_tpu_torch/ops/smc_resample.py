"""The particle filter's resample, gated on a device flag: two CUDA kernels.

Not the port of a TPU kernel.  The reference resamples inside its scan with
``lax.cond`` (``ldagibbssampling_tpu/backends/smc.py:112-122``): every
particle's tables are gathered by the drawn indices when the effective
sample size falls below its threshold.  The port's captured absorb
(``backends/smc.py``) keeps that test on the device as a bool tensor, so
that a CUDA graph can hold every token's step; these kernels
(``csrc/smc_resample.cu``) are the branch.  ``resample_gather`` copies
``table[idx]`` into scratch tables of the same shapes and counts the
resample; ``resample_write`` copies the scratch back, so every table keeps
its address.  Both read the flag once per CTA and return at once when it is
false; a branch-free ``torch.where`` would move every table on every token.

The tables are the four per-particle int32 tables with the particle axis
first (``ndk [P, M, K]``, ``nwk [P, V, K]``, ``nk [P, K]``, ``z [P, T]``),
contiguous.  Each wrapper takes CUDA tensors to its kernel and CPU tensors
to its plain PyTorch version (``if flag: scratch.copy_(table[idx])``, then
``if flag: table.copy_(scratch)``), which reads the flag on the host; any
other device raises, and so does a failed launch.  A launch adds 1
to the recorder's counter ``launch.<kernel>``, a call of a plain version
to ``plain.<kernel>`` (``evaluation/tracing.count``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ldagibbssampling_tpu_torch.evaluation import tracing
# csrc/smc_resample.cu: particles held in shared memory
MAX_PARTICLES = 1024
# the grid: four CTAs of 256 threads per SM of an H100, one wave; a false
# flag costs each CTA one load
_GRID = 132 * 4


@functools.cache
def _lib():
    """The library with its entry point's types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("smc_resample")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lda_smc_resample.restype = i32
    lib.lda_smc_resample.argtypes = [i32, vp, vp, i32, *(vp,) * 8, *(i64,) * 4,
                                     vp, i32, vp]
    return _build, lib


def _check(flag: torch.Tensor, tables: Sequence[torch.Tensor],
           scratch: Sequence[torch.Tensor]) -> torch.device:
    dev = flag.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if flag.dtype != torch.bool or flag.numel() != 1:
        raise ValueError(f"flag: want one bool, got {flag.dtype} {tuple(flag.shape)}")
    if len(tables) != 4 or len(scratch) != 4:
        raise ValueError("want the four tables (ndk, nwk, nk, z) and their scratch")
    p = tables[0].shape[0]
    if p < 1 or (dev.type == "cuda" and p > MAX_PARTICLES):
        raise ValueError(f"{p} particles: at least 1, at most {MAX_PARTICLES} on a card")
    for t, s in zip(tables, scratch):
        for x in (t, s):
            if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
                raise ValueError(f"want contiguous int32 tables on {dev}, got "
                                 f"{x.dtype} on {x.device}")
        if t.shape != s.shape or t.shape[0] != p:
            raise ValueError(f"a table {tuple(t.shape)} and its scratch "
                             f"{tuple(s.shape)}: want [{p}, ...] both")
    return dev


def _launch(gather: bool, flag, idx, src, dst, count) -> None:
    build, lib = _lib()
    p = src[0].shape[0]
    rows = [t.numel() // p for t in src]
    with torch.cuda.device(flag.device):
        err = lib.lda_smc_resample(
            int(gather), flag.data_ptr(), idx.data_ptr() if gather else None, p,
            *(t.data_ptr() for t in src), *(t.data_ptr() for t in dst), *rows,
            count.data_ptr() if gather else None, _GRID,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_smc_resample")


def resample_gather_plain(flag, idx, tables, scratch, count) -> None:
    tracing.count("plain.resample_gather")
    if bool(flag):
        for t, s in zip(tables, scratch):
            s.copy_(t[idx])
        count.add_(1)


def resample_gather(flag: torch.Tensor, idx: torch.Tensor,
                    tables: Sequence[torch.Tensor], scratch: Sequence[torch.Tensor],
                    count: torch.Tensor) -> None:
    """If ``flag``: ``scratch[i] = tables[i][idx]`` for each table, and
    ``count`` (int64, one element) gains one."""
    dev = _check(flag, tables, scratch)
    p = tables[0].shape[0]
    if idx.device != dev or idx.dtype != torch.int64 or tuple(idx.shape) != (p,):
        raise ValueError(f"idx: want int64 [{p}] on {dev}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if count.device != dev or count.dtype != torch.int64 or count.numel() != 1:
        raise ValueError(f"count: want one int64 on {dev}")
    if dev.type == "cpu":
        resample_gather_plain(flag, idx, tables, scratch, count)
        return
    _launch(True, flag, idx.contiguous(), tables, scratch, count)
    tracing.count("launch.resample_gather")


def resample_write_plain(flag, scratch, tables) -> None:
    tracing.count("plain.resample_write")
    if bool(flag):
        for t, s in zip(tables, scratch):
            t.copy_(s)


def resample_write(flag: torch.Tensor, scratch: Sequence[torch.Tensor],
                   tables: Sequence[torch.Tensor]) -> None:
    """If ``flag``: ``tables[i].copy_(scratch[i])`` for each table."""
    dev = _check(flag, tables, scratch)
    if dev.type == "cpu":
        resample_write_plain(flag, scratch, tables)
        return
    _launch(False, flag, None, scratch, tables, None)
    tracing.count("launch.resample_write")
