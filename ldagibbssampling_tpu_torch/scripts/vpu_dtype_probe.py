"""Probe: the card's float32 against packed-bf16 elementwise rate (K4).

Counterpart of ``scripts/vpu_dtype_probe.py``, the TPU probe that measured
the VPU's f32 and bf16 rates before K1's bf16 chains were written.  It runs
the same chain at the same shape: per element of two ``[32768, 512]``
float32 inputs, 8 repeats of ``acc = (acc - e + 0.1) * (y - e + 0.5) +
acc * e`` (``e`` = column 3), in float32 or in bf16, through the CUDA
kernel ``csrc/dtype_probe.cu`` (``dtype_probe``), and prints the time and
the rate, with operations counted as the reference counts them
(``ROWS · K · REPS · 5``).  ``probe_plain`` is the plain PyTorch version.
Run it on the card:

    python -m ldagibbssampling_tpu_torch.scripts.vpu_dtype_probe [--reps N]

``--reps`` above 8 moves the chain from bytes to arithmetic (see the
kernel's source).  ``--device cpu`` times the plain version on the CPU,
which says nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time

import torch

from ldagibbssampling_tpu_torch.evaluation.tracing import count

ROWS = 1 << 15       # 32768 rows x 512 columns
K = 512
REPS = 8             # chain repeats per element
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def counter_name(dtype: str) -> str:
    return "dtype_probe_f32" if dtype == "float32" else "dtype_probe_bf16"


def probe_plain(a: torch.Tensor, b: torch.Tensor, *, reps: int = REPS,
                dtype: str = "float32") -> torch.Tensor:
    """The chain in PyTorch ops, each rounded to ``dtype``; the constants
    are ``dtype(0.1)`` and ``dtype(0.5)``, as in the reference."""
    count("plain." + counter_name(dtype))
    dt = DTYPES[dtype]
    x, y = a.to(dt), b.to(dt)
    cols = torch.arange(a.shape[1], device=a.device)
    e = (cols == 3).to(dt)[None, :]
    c01 = torch.tensor(0.1, dtype=dt, device=a.device)
    c05 = torch.tensor(0.5, dtype=dt, device=a.device)
    acc = x
    for _ in range(reps):
        acc = (acc - e + c01) * (y - e + c05) + acc * e
    return acc.to(torch.float32)


@functools.cache
def _lib():
    """The library with its entry point's types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("dtype_probe")
    vp = ctypes.c_void_p
    lib.lda_dtype_probe.restype = ctypes.c_int
    lib.lda_dtype_probe.argtypes = [vp, vp, vp, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, vp]
    return _build, lib


def dtype_probe(a: torch.Tensor, b: torch.Tensor, *, reps: int = REPS,
                dtype: str = "float32") -> torch.Tensor:
    """``[rows, 512]`` float32 result of the chain on ``a``, ``b`` (float32,
    ``[rows, 512]``, contiguous): the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != K
                or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: want contiguous float32 [rows, {K}] on "
                             f"{a.device}, got {t.dtype} {tuple(t.shape)}")
    if a.shape != b.shape or reps < 0:
        raise ValueError(f"shapes {tuple(a.shape)} {tuple(b.shape)}, reps {reps}")
    if a.device.type == "cpu":
        return probe_plain(a, b, reps=reps, dtype=dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    build, lib = _lib()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.lda_dtype_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  a.shape[0], reps, int(dtype == "bfloat16"),
                                  torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_dtype_probe")
    count("launch." + counter_name(dtype))
    return out


def ops_counted(rows: int = ROWS, reps: int = REPS) -> int:
    """Operations as the reference counts them: ~5 per repeat per element."""
    return rows * K * reps * 5


def measure(device: str = "cuda", *, rows: int = ROWS, reps: int = REPS,
            iters: int = 20, seed: int = 0) -> dict:
    """``{dtype: (ms per call, Gops/s)}`` of ``dtype_probe`` on ``device``:
    the mean over ``iters`` calls after one warm-up (CUDA events on the
    card, the host clock on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to time "
                           "the plain version")
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((rows, K), generator=g).to(dev)
    b = torch.rand((rows, K), generator=g).to(dev)
    out = {}
    for dtype in DTYPES:
        dtype_probe(a, b, reps=reps, dtype=dtype)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                dtype_probe(a, b, reps=reps, dtype=dtype)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                dtype_probe(a, b, reps=reps, dtype=dtype)
            ms = (time.perf_counter() - t0) / iters * 1e3
        out[dtype] = (ms, ops_counted(rows, reps) / (ms * 1e-3) / 1e9)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             and torch.cuda.is_available() else args.device)
    res = measure(args.device, rows=args.rows, reps=args.reps, iters=args.iters)
    print(f"[{args.rows}, {K}], {args.reps} repeats, on {where}")
    for dtype, (ms, gops) in res.items():
        print(f"{dtype}: {ms:.4f} ms  ({gops:.1f} Gops/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
