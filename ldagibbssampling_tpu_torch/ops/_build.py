"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it compiles
for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so``; the digest
covers the source, every ``csrc`` header it includes (``#include "x.cuh"``,
followed into headers that include others) and the flags, so an edit to the
source or to a header it shares builds anew and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.  A failed build raises; nothing falls back.

``build_host`` is the same for a host library, ``csrc/<name>.cc`` compiled
by ``$CXX`` (default ``g++``): the corpus ingest's (``corpus/native.py``)
and the deferred layout's planner (``ops/count_kernel.plan_deferred``),
which are not kernels and not in ``SOURCES``.  Every build compiles to a
temporary name of its own and renames it into place, so threads and
processes that build one library at once all end with the whole file.

No ``--use_fast_math``: it would swap ``logf`` for ``__logf`` and ``1/x``
for an approximation, which changes the draws against the plain versions.

A library that :func:`load` or :func:`load_host` has not opened yet is
built and opened in the span ``kernels.load``; ``kernels.built`` counts
each compiler run that succeeded and ``kernels.loaded`` each library
opened (``evaluation/tracing``).  A library already open takes neither.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

from ldagibbssampling_tpu_torch.evaluation import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_kernel", "count_kernel", "sample_kernel", "dtype_probe",
           "smc_resample", "cvb0_scatter")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_host_libs: dict[Path, ctypes.CDLL] = {}  # library path -> the loaded library
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _inputs(name: str, ext: str = ".cu") -> list[Path]:
    """``csrc/<name><ext>`` and every ``csrc`` header it includes, in the
    order first reached."""
    files = [CSRC / f"{name}{ext}"]
    for path in files:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep not in files:
                files.append(dep)
    return files


def _lib_path(name: str, ext: str = ".cu",
              flags: tuple[str, ...] = NVCC_FLAGS) -> tuple[Path, Path]:
    """``(source, library)``: the library's name carries a digest of the
    source, the headers it includes and the flags."""
    h = hashlib.sha256()
    for path in _inputs(name, ext):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return CSRC / f"{name}{ext}", BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(src: Path, out: Path, compiler: list[str]):
    """Start compiling ``src`` to a temporary name beside ``out``; None when
    ``out`` is built already."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # one build per process: _lock
    proc = subprocess.Popen(
        [*compiler, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    """Wait for a build; rename its output into place, or remove it and
    raise."""
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    build_log[name] = stdout + stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(proc.args[0]).name} failed on {Path(proc.args[-1]).name} "
            f"(exit {proc.returncode}):\n{stderr}")
    os.replace(tmp, out)
    tracing.count("kernels.built")


def _start_cuda(name: str):
    return _start(*_lib_path(name), [_nvcc(), *NVCC_FLAGS])


def build_all(names: tuple[str, ...] = SOURCES) -> float:
    """Build every kernel library that is not built yet, all ``nvcc`` runs in
    parallel; returns the seconds it took (the span ``kernels.build``).
    Every ``nvcc`` is waited for before the first failure is raised."""
    with tracing.span("kernels.build") as built, _lock:
        jobs = {n: _start_cuda(n) for n in names}
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
    return built.seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with tracing.span("kernels.load"):
                job = _start_cuda(name)
                if job is not None:
                    _finish(name, job)
                lib = ctypes.CDLL(str(_lib_path(name)[1]))
                tracing.count("kernels.loaded")
            lib.lda_error_string.restype = ctypes.c_char_p
            lib.lda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def build_host(name: str) -> Path:
    """The host library of ``csrc/<name>.cc`` built by ``$CXX`` (default
    ``g++``) with ``HOST_FLAGS``, building it if needed; raises
    ``RuntimeError`` when the source or the compiler is missing or the
    compiler fails."""
    cxx = os.environ.get("CXX") or "g++"
    with _lock:
        try:
            src, out = _lib_path(name, ".cc", HOST_FLAGS)
            job = _start(src, out, [*shlex.split(cxx), *HOST_FLAGS])
        except OSError as e:
            raise RuntimeError(f"cannot build {name}.cc with {cxx!r}: {e}") from e
        if job is not None:
            _finish(f"{name}.cc", job)
    return out


def load_host(name: str, declare) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cc`` (:func:`build_host`),
    ``declare(lib)`` typing its entry points once; raises ``RuntimeError``
    naming the compiler's or the loader's error.  A failure is not
    remembered: the next call tries again."""
    try:
        lib = _host_libs.get(_lib_path(name, ".cc", HOST_FLAGS)[1])
    except OSError:  # no source: build_host says so
        lib = None
    if lib is not None:
        return lib
    with tracing.span("kernels.load"):
        path = build_host(name)
        with _lock:
            lib = _host_libs.get(path)
            if lib is None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(f"cannot load {path.name}: {e}") from e
                tracing.count("kernels.loaded")
                declare(lib)
                _host_libs[path] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.lda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
