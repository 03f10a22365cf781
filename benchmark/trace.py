"""The traced span of a run: ``torch.profiler`` over a few sweeps, reduced
to device time by kernel, the device's busy time, and the idle gaps with
what the host was doing in each.

Spans come from the benchmark's own files (``record_function`` around its
calls into the program); the trace stays in memory and is never written.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch

ANNOTATION = "bench."
SPAN = ANNOTATION + "traced_span"
_TEMPLATE = re.compile(r"<.*")


@dataclasses.dataclass
class Trace:
    """A traced span: its wall length, the sweeps in it, the device's busy
    seconds, device seconds by kernel, and the idle gaps (label, seconds),
    longest first."""

    window_s: float
    sweeps: int
    busy_s: float
    kernels: dict[str, float]
    gaps: list[tuple[str, float]]

    def kernel_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``name``; ``None``
        where the trace recorded none."""
        found = [s for k, s in self.kernels.items() if name in k]
        return sum(found) if found else None

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:10]]}


def kernel_name(name: str) -> str:
    """A device event's name without its signature and template arguments."""
    short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return _TEMPLATE.sub("", short.split("(")[0]).strip() or name[:80]


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events, sweeps: int) -> Optional[Trace]:
    """A :class:`Trace` from a profiler's events, or ``None`` where it holds
    no span or no device event."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == SPAN]
    if not spans:
        return None
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    # the device's copies of the benchmark's own spans are annotations, not work
    device = [e for e in events
              if e.device_type == cuda and not e.name.startswith(ANNOTATION)]
    host = [e for e in events if e.device_type != cuda and e.name != SPAN]
    kernels: dict[str, float] = {}
    intervals = []
    for e in device:
        a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if b <= a:
            continue
        intervals.append((a, b))
        key = kernel_name(e.name)
        kernels[key] = kernels.get(key, 0.0) + (b - a) * 1e-6
    if not intervals:
        return None
    merged = _merge(intervals)
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((_host_label(host, (a + b) / 2), (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(t1 - t0) * 1e-6, sweeps=sweeps, busy_s=busy * 1e-6,
                 kernels=kernels, gaps=gaps)


def _host_label(host, at: float) -> str:
    """The innermost host event running at ``at`` (µs), or ``idle host``."""
    best = None
    for e in host:
        if e.time_range.start <= at <= e.time_range.end:
            if best is None or e.time_range.elapsed_us() < best.time_range.elapsed_us():
                best = e
    return f"host: {best.name}" if best is not None else "host: idle"


def profile(run_sweeps: Callable[[int], None], sweeps: int,
            needed: str, tries: int = 3) -> tuple[Optional[Trace], int]:
    """Profile ``run_sweeps(sweeps)`` after one sweep; again, up to
    ``tries`` spans in all, where the trace holds no kernel named
    ``needed`` (the profiler has been seen to miss K1's walk now and then).  Returns the trace of the last
    span (``None`` where none recorded ``needed``) and the sweeps run."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    ran = 0
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            # one sweep before the span: the profiler's own start (its
            # first buffer request, ~3 ms) would read as the card's idle
            run_sweeps(1)
            with torch.profiler.record_function(SPAN):
                run_sweeps(sweeps)
        ran += 1 + sweeps
        trace = reduce_events(prof.events(), sweeps)
        if trace is not None and trace.kernel_s(needed) is not None:
            return trace, ran
    return None, ran
