"""Tracing, profiling, and structured metrics.

Counterpart of ``ldagibbssampling_tpu/evaluation/tracing.py``:

- :func:`span` — a named interval of the program, kept in memory on
  ``time.perf_counter_ns`` with its enclosing span (its parent), and, while
  a profiler runs, also a ``torch.profiler.record_function`` of that name
  (on the profiler's clock, beside the copies and kernels it queued);
  :func:`annotate` is the same;
- :func:`count` — an in-memory integer counter;
- :func:`spans`, :func:`span_seconds`, :func:`self_seconds`,
  :func:`span_fields`, :func:`counters`, :func:`dropped`, :func:`reset` —
  their readers;
- :func:`trace` — ``torch.profiler`` capture around a region (CPU and, when
  present, CUDA activity); writes a Chrome trace into the directory;
- :func:`kernel_device_ms` — a kernel's device time per launch, from
  ``torch.profiler``'s CUDA activity (what CUDA events around a short
  kernel's wrapper cannot give: they time the host's launches);
- :func:`block_on_backend` — ``torch.cuda.synchronize`` on the backend's
  device, so a timed region covers the compute and not the enqueue;
- :class:`SweepTimer` — per-sweep wall time and tokens-resampled/s;
- :class:`MetricsLog` — append-only JSONL of per-sweep scalars.

Span names are ``<layer>.<phase>`` in lower case.  Spans time set-up and
the steps around the sweeps (the model's construction, the graph's first
call, a kernel library's build and load, the runner's LL, Minka,
checkpoint and save); the per-sweep path only adds counters: under a CUDA
profiler a range that encloses a launch gets a device copy, which a
trace's reader would count as device work.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

# spans kept per process; later ones are timed but only counted (dropped())
MAX_SPANS = 4096


class Span:
    """One recorded interval: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns`` (``end_ns`` None while open) and ``parent``,
    the span that was open around it on its thread (or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent")

    def __init__(self, name: str, start_ns: int, parent: Optional["Span"]) -> None:
        self.name, self.start_ns, self.parent = name, start_ns, parent
        self.end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_spans: list[Span] = []
_counters: dict[str, int] = {}
_dropped = 0
_lock = threading.Lock()  # guards the three above
_open = threading.local()  # .stack: this thread's open spans


class span:
    """``with span(name[, device]) as s:`` records ``s`` (a :class:`Span`)
    from entry to exit, ``s.seconds`` once closed.  While a profiler runs
    (its own enabled flag) the interval is also a
    ``torch.profiler.record_function(name)``.  With ``device`` (a device or
    a sequence of them) the exit first waits for each CUDA one, so the
    seconds are the work and not its enqueue: for set-up only, never on a
    path that runs every sweep."""

    __slots__ = ("name", "device", "record", "_rf")

    def __init__(self, name: str, device: Any = None) -> None:
        self.name, self.device = name, device
        self._rf = None

    def __enter__(self) -> Span:
        global _dropped
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.record = Span(self.name, time.perf_counter_ns(),
                           stack[-1] if stack else None)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(self.record)
            else:
                _dropped += 1
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc) -> None:
        try:
            if self.device is not None and exc[0] is None:
                devices = (self.device if isinstance(self.device, (list, tuple))
                           else (self.device,))
                for d in devices:
                    if torch.device(d).type == "cuda":
                        torch.cuda.synchronize(d)
        finally:
            self.record.end_ns = time.perf_counter_ns()
            _open.stack.pop()
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None


annotate = span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> list[Span]:
    """The recorded spans, in the order they opened (open ones included)."""
    return list(_spans)


def span_seconds(name: str) -> Optional[float]:
    """Seconds of the closed spans named ``name``, summed in the order they
    opened; ``None`` where none ran."""
    found = [s.seconds for s in _spans if s.name == name and s.end_ns is not None]
    return sum(found) if found else None


def self_seconds(name: str) -> Optional[float]:
    """:func:`span_seconds` less the seconds of those spans' children."""
    own = {id(s) for s in _spans if s.name == name and s.end_ns is not None}
    if not own:
        return None
    inner = sum(s.seconds for s in _spans
                if s.parent is not None and id(s.parent) in own and s.end_ns is not None)
    return span_seconds(name) - inner


def span_fields(since: int = 0, skip: tuple[str, ...] = ()) -> dict[str, float]:
    """The summed seconds of each name among the closed spans from the
    ``since``-th recorded on, as metrics fields: ``<name>_s`` with the dots
    as underscores (``lda.init`` → ``lda_init_s``), leaving out the names
    that start with one of ``skip``."""
    out: dict[str, float] = {}
    for s in _spans[since:]:
        if s.end_ns is not None and not s.name.startswith(skip):
            key = s.name.replace(".", "_") + "_s"
            out[key] = out.get(key, 0.0) + s.seconds
    return out


def counters() -> dict[str, int]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans timed past ``MAX_SPANS`` and not kept."""
    return _dropped


def reset() -> None:
    """Forget every span and counter (open spans still close)."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0


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
