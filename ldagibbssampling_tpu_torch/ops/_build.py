"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it compiles
for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so``; the digest
covers the source and the flags, so an edited source builds anew and an
unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.  A failed build raises; nothing falls back.

No ``--use_fast_math``: it would swap ``logf`` for ``__logf`` and ``1/x``
for an approximation, which changes the draws against the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_kernel", "count_kernel")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output per source from this process's builds (ptxas prints each
# kernel's registers, shared memory and spills there)
build_log: dict[str, str] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    src, out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    build_log[name] = stdout + stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{stderr}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = SOURCES) -> float:
    """Build every kernel library that is not built yet, all ``nvcc`` runs in
    parallel; returns the seconds it took.  Every ``nvcc`` is waited for
    before the first failure is raised."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)[1]))
            lib.lda_error_string.restype = ctypes.c_char_p
            lib.lda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.lda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
