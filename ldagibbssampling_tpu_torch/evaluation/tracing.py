"""Tracing, profiling, and structured metrics.

Counterpart of ``ldagibbssampling_tpu/evaluation/tracing.py``:

- :func:`trace` — ``torch.profiler`` capture around a region (CPU and, when
  present, CUDA activity); writes a Chrome trace into the directory;
- :func:`annotate` — a named region in that trace
  (``torch.profiler.record_function``);
- :func:`kernel_device_ms` — a kernel's device time per launch, from
  ``torch.profiler``'s CUDA activity (what CUDA events around a short
  kernel's wrapper cannot give: they time the host's launches);
- :func:`block_on_backend` — ``torch.cuda.synchronize`` on the backend's
  device, so a timed region covers the compute and not the enqueue;
- :class:`SweepTimer` — per-sweep wall time and tokens-resampled/s;
- :class:`MetricsLog` — append-only JSONL of per-sweep scalars.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace into ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace region (shows up in the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield


def kernel_device_ms(fn, name: str, reps: int = 20) -> Optional[float]:
    """Mean device ms per launch of the CUDA kernels whose name holds
    ``name``, over ``reps`` calls of ``fn`` (after one warm-up call) under
    ``torch.profiler``; ``None`` where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def block_on_backend(backend) -> None:
    """Wait until the backend's device work is done (CUDA runs async: a timed
    ``sweep(chunk)`` without this measures the enqueue, not the compute).
    Every backend of the port names its ``device``; a mesh runtime also
    its ``devices``, each of which is waited for."""
    for dev in getattr(backend, "devices", None) or [getattr(backend, "device", None)]:
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)


class SweepTimer:
    """Wall-clock per-sweep timing + tokens-resampled/s.

    Usage::

        timer = SweepTimer(num_tokens=corpus.num_tokens)
        for i in range(sweeps):
            with timer:
                model.sweep(1)
        print(timer.summary())
    """

    def __init__(self, num_tokens: int):
        self.num_tokens = num_tokens
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "SweepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def last_tokens_per_s(self) -> float:
        if not self.times:
            return float("nan")
        return self.num_tokens / max(self.times[-1], 1e-12)

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {"sweeps": 0}
        # skip the first sweep (compile) for steady-state numbers when possible
        steady = self.times[1:] or self.times
        mean = sum(steady) / len(steady)
        return {
            "sweeps": len(self.times),
            "first_sweep_s": self.times[0],
            "mean_sweep_s": mean,
            "tokens_per_s": self.num_tokens / max(mean, 1e-12),
            "total_s": sum(self.times),
        }


class MetricsLog:
    """Append-only JSONL metrics sink (one object per line, ``sweep`` keyed)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def log(self, sweep: int, **scalars: Any) -> None:
        rec = {"sweep": int(sweep), "time": time.time()}
        for k, v in scalars.items():
            if v is None:
                continue
            rec[k] = float(v) if isinstance(v, (int, float)) else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str | Path) -> list[dict[str, Any]]:
    """Read a JSONL metrics file back (skips malformed lines)."""
    out = []
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out
