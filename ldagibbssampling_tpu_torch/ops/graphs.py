"""One sweep of fixed shapes captured once as a CUDA graph, replayed per sweep.

The port's counterpart of the reference's ``jax.jit`` over ``lax.fori_loop``
(``ldagibbssampling_tpu/ops/gibbs.py:906-921``, ``models/chains.py:71-86``):
there a call of ``n`` sweeps is one dispatch, with α, β and ``n`` traced so
that a Minka update or another count never recompiles.  Here a
:class:`SweepGraph` owns static buffers for one path's state, captures one
sweep of them with ``torch.cuda.CUDAGraph`` at its first call on the card,
and replays that graph once per sweep: the host makes one graph launch a
sweep where the eager sweep makes one launch per operation.

What may change between replays lives on the device:

- the state tables (``z``, ``ndk``, ``nwk``, ``nk``; one chain or stacked
  ``[C, ...]``; the deferred tier's snapshot as a fifth), copied into the
  buffers at a call unless they are the state that the graph's previous
  call returned, unmodified since.  A table that the eager sweep hands out
  as the corner of a padded buffer (the deferred tier's ``nwk [V, K]`` of
  K2's ``[v_pad, k_pad]``) has such a buffer here, and the graph hands out
  the same corner;
- ``params``, a small int64 tensor: its first two words are the float32
  α, β, V·β and K·α (``scalars``, formed on the host as the reference forms
  them, ``_device.sweep_scalars``), then, for a body that draws with a
  device seed (K1, K3), a cursor and up to ``SEED_CHUNK`` sweep seeds: each
  replay reads the seed at the cursor and moves it on.  One copy writes
  them per call (per ``SEED_CHUNK`` sweeps), from pinned memory, without a
  host sync;
- one ``torch.Generator`` per chain on the device, registered with the
  graph, for a body that draws with PyTorch (the XLA tier): reseeded with
  the sweep's seed before each replay (``manual_seed``), which PyTorch's
  replay hands to the captured draws, so they are the eager draws;
- for external noise, the sweep's noise array, copied in before each replay.

A call returns clones of the buffers, so a state passed in or returned by
an earlier call never changes under a later one (the reference's functional
semantics; the eager sweeps clone the state they are given too).  The
counters that the kernel wrappers add to (``launch.<kernel>``,
``walk.tagged_records`` and the others; ``evaluation/tracing.count``) are
Python and do not run on a replay: what the capture counted is taken back
and added once per replay instead.  On the card a failed capture or replay
raises; nothing runs the sweep eagerly instead.  On the CPU the same sweep
body runs eagerly on the same buffers (what the tests run).

The first call on the card reports its set-up: ``setup_s``, its whole
wall time before the first replay (the span ``graph.setup``: the copies in,
``graph.copy_in``; the warm-up sweep, ``graph.warm_up``; the capture and
the instantiation, ``graph.capture``; the call waits for the card before
and after it, once, and at the end of each part), ``capture_s``, the
capture and instantiation alone, and ``nodes``, the captured graph's node
count (the device operations of one replay).  Every call adds integer
counters (``evaluation/tracing.count``) and opens no span:
``graph.replays``, ``graph.handout_bytes`` (the bytes of the clones it
hands back) and ``graph.copy_in_bytes`` (the tables it copied in because
they were not what it last handed out; 0 in a steady run);
``capture_graph`` counts ``graph.captures``.

A sweep may also be a list of steps, each on a device or on the host
(the mesh runtimes' sweep, ``parallel/runtime.py``): the steps between two
host steps are one graph, the host steps (a collective across processes,
a copy between devices) run between the replays; each device holds its
own ``params``, and a sweep takes one device seed per position.

:class:`StepGraph` is the same contract for a body that is not one sweep of
Gibbs tables: ``n`` steps of it in a row as one replay (a graph per distinct
``n``), its state copied in unless it is what the last call handed out,
clones out, the counters added per replay, the set-up timed.  SMC's absorb
(``backends/smc.py``, ``GRAPH_STEPS`` tokens a replay, the counterpart of
the reference's ``lax.scan`` over tokens) and SVI's minibatch step
(``backends/svi.py``, the reference's one ``jit`` a minibatch) replay one.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldagibbssampling_tpu_torch.evaluation.tracing import count, counters, span
from ldagibbssampling_tpu_torch.ops._device import seed_word, staged, sweep_scalars

# sweeps whose device seeds go to the card in one copy
SEED_CHUNK = 256


def _add_counts(per: dict, times: int) -> None:
    for name, n in per.items():
        count(name, n * times)


def _capture_node_count(stream: torch.cuda.Stream) -> int:
    """The nodes so far of the graph that ``stream`` is capturing into (the
    driver's ``cuStreamGetCaptureInfo_v2`` and ``cuGraphGetNodes``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    n = ctypes.c_size_t(0)
    if cu.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None,
            ctypes.byref(graph), None, None) or status.value != 1:
        raise RuntimeError("the side stream is not capturing")
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    return n.value


def capture_graph(fn: Callable[[], None], device: torch.device, *,
                  warm_up: Optional[Callable[[], None]] = None,
                  generators: Sequence[torch.Generator] = (),
                  pool=None, warm_up_devices: Optional[Sequence] = None) -> tuple:
    """``fn()`` captured into a new CUDA graph on a side stream, after
    ``warm_up()`` on that stream (it fills every launch configuration the
    kernel wrappers cache; outside the capture; the span ``graph.warm_up``,
    which waits for ``warm_up_devices``, default ``device``), into ``pool``
    where given (else the graph's own private pool); raises if the capture
    fails.  Returns ``(graph, nodes, per_replay, capture_s)``: the
    instantiated graph, its node count, what the counters moved between
    ``capture_begin`` and ``capture_end`` (the kernel launches and K1's
    walks, now taken back: the capture launched nothing; they are each
    replay's) and the seconds of the capture and instantiation (the span
    ``graph.capture``)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        if warm_up is not None:
            with span("graph.warm_up", warm_up_devices or device):
                warm_up()
        # a graph that only a reference cycle holds is freed now: freed by
        # the collector during the capture, it would invalidate the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        with span("graph.capture", device) as captured:
            before = counters()
            graph.capture_begin(pool=pool)
            try:
                fn()
                nodes = _capture_node_count(side)
            finally:
                try:
                    graph.capture_end()  # instantiates the graph
                finally:
                    after = counters()
                    if collecting:
                        gc.enable()
    count("graph.captures")
    main.wait_stream(side)
    per_replay = {k: n - before.get(k, 0) for k, n in after.items()
                  if n != before.get(k, 0)}
    _add_counts(per_replay, -1)
    return graph, nodes, per_replay, captured.seconds


def _holds(last: Optional[tuple], tables: Sequence[torch.Tensor]) -> bool:
    """Whether ``tables`` are the tensors ``last`` recorded (the same memory,
    or a view of it with the same shape and strides), unmodified since."""
    return last is not None and all(
        t.data_ptr() == o.data_ptr() and t.shape == o.shape
        and t.stride() == o.stride() and t._version == v
        for t, o, v in zip(tables, last[0], last[1]))


def _copy_into(buffers: Sequence[torch.Tensor], tables: Sequence[torch.Tensor]) -> None:
    for buf, t in zip(buffers, tables):
        if t.shape != buf.shape or t.dtype != buf.dtype:
            raise ValueError(f"a table {t.dtype} {tuple(t.shape)}: this graph "
                             f"was built for {buf.dtype} {tuple(buf.shape)}")
        buf.copy_(t)


# body(buffers, scalars, key, generators, noise): one sweep, in place
Body = Callable[[Sequence[torch.Tensor], torch.Tensor, Optional[torch.Tensor],
                 Sequence[torch.Generator], Optional[torch.Tensor]], None]


@dataclasses.dataclass
class _Segment:
    """Consecutive steps of a sweep: on ``device`` (captured as one graph),
    or on the host (``device`` None: run between the replays)."""

    device: Optional[torch.device]
    fns: list
    generators: list  # the indices of the generators its steps draw from


class SweepGraph:
    """One sweep of ``body`` over static buffers shaped like ``tables``:
    captured as a CUDA graph at the first call on the card and replayed
    once per sweep; run eagerly on the CPU.

    ``body(buffers, scalars, key, generators, noise)`` runs one sweep in
    place on ``buffers``: ``scalars`` is the float32 ``[4]`` view of α, β,
    V·β and K·α, ``key`` the sweep's int64 ``[device_seeds]`` seeds (else
    ``None``), ``generators`` ``num_generators`` generators on the device,
    reseeded per sweep (``internal`` noise), and ``noise`` the sweep's
    noise array (``external`` noise; else ``None``).  A body that draws
    nothing (CVB0's) takes ``noise_mode="deterministic"``: no seeds, no
    noise.  Everything it reads besides these must outlive the graph.
    ``padded[i]``, where given, is table ``i``'s buffer shape: the buffer is
    that zeroed tensor, the table its leading corner (``buffer[:V, :K]``),
    and ``body`` gets the whole buffer.

    ``body`` may instead be a list of steps ``(device, fn, gens)`` (the mesh
    runtimes' sweep, ``parallel/runtime.py``): ``fn`` takes the arguments of
    ``body``, with the ``scalars`` and ``key`` of its device (each device
    holds its own ``params``), and draws from the generators at the indices
    ``gens``; a step whose ``device`` is ``None`` is ``fn(buffers)`` on the
    host (a collective across processes, a copy between devices).  Consecutive
    steps on one device are captured as one graph, in one memory pool per
    device; a sweep replays the graphs in order with the host steps between
    them (``launches`` graph launches a sweep).  Then ``generator_devices``
    places the generators and ``noise_devices`` the noise buffers: a call's
    ``noise(i)`` gives one array per noise buffer.
    """

    def __init__(self, body: Body | Sequence[tuple], tables: Sequence[torch.Tensor], *,
                 vocab_size: int, num_topics: int, noise_mode: str,
                 num_generators: int = 0, device_seeds: int = 0,
                 padded: Optional[Sequence[Optional[tuple]]] = None,
                 generator_devices: Optional[Sequence[torch.device]] = None,
                 noise_devices: Optional[Sequence[torch.device]] = None) -> None:
        self.device = tables[0].device
        self.vocab_size, self.num_topics = vocab_size, num_topics
        self.noise_mode = noise_mode
        padded = padded or (None,) * len(tables)
        self.buffers = [torch.empty_like(t, memory_format=torch.contiguous_format)
                        if p is None else
                        torch.zeros(p, dtype=t.dtype, device=t.device)
                        for t, p in zip(tables, padded)]
        # each table's corner of its buffer (the whole buffer where unpadded)
        self._corners = [None if p is None else tuple(slice(0, n) for n in t.shape)
                         for t, p in zip(tables, padded)]
        # device seeds a sweep (True: one)
        self.device_seeds = int(device_seeds) if noise_mode == "internal" else 0
        gen_devs = (list(generator_devices) if generator_devices is not None
                    else [self.device] * num_generators)
        self.generators = ([torch.Generator(device=d) for d in gen_devs]
                           if noise_mode == "internal" else [])
        steps = ([(self.device, body, list(range(len(self.generators))))]
                 if callable(body) else list(body))
        self.devices = list(dict.fromkeys(
            [self.device] + [d for d, _, _ in steps if d is not None]))
        self._params = {d: torch.zeros(
            2 + (1 + SEED_CHUNK * self.device_seeds if self.device_seeds else 0),
            dtype=torch.int64, device=d) for d in self.devices}
        self.params = self._params[self.device]
        self.scalars = self.params[:2].view(torch.float32)
        self._keys = {d: torch.zeros((1, self.device_seeds), dtype=torch.int64,
                                     device=d) for d in self.devices}
        self._segments = self._split(steps)
        self._noise_devices = noise_devices
        self.noise = None  # allocated at the first call
        self.graph: Optional[torch.cuda.CUDAGraph] = None  # the first graph
        self.graphs: list = []  # per segment: its graph, None for the host's
        self.per_replay: dict = {}   # what one replay adds to each counter
        self.setup_s = self.capture_s = None
        self.nodes = 0  # the graphs' nodes: the card's operations a replay
        self.launches = sum(s.device is not None for s in self._segments)
        self.replays = 0
        # the bytes of the clones a call hands out
        self._handout_bytes = sum(b.numel() * b.element_size() for b in self.buffers)
        # the tensors the last call returned and their versions: the same
        # memory (a view of it too), unmodified, is what the buffers hold
        self._last: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _split(self, steps) -> list[_Segment]:
        """The steps as segments; a device's seed cursor moves on just
        before its first step of the sweep."""
        out: list[_Segment] = []
        for dev, fn, gens in steps:
            fns = [fn]
            if dev is not None and self.device_seeds and not any(
                    s.device == dev for s in out):
                fns.insert(0, lambda *args, dev=dev: self._next_key(dev))
            if out and out[-1].device == dev:
                out[-1].fns += fns
                out[-1].generators += list(gens)
            else:
                out.append(_Segment(dev, fns, list(gens)))
        return out

    def _next_key(self, dev: torch.device) -> None:
        """The sweep's seeds at the device's cursor, into its key buffer."""
        params = self._params[dev]
        cursor = params[2:3]
        torch.index_select(params[3:].view(-1, self.device_seeds), 0, cursor,
                           out=self._keys[dev])
        cursor.add_(1)

    def _run(self, seg: _Segment) -> None:
        if seg.device is None:
            for fn in seg.fns:
                fn(self.buffers)
            return
        key = self._keys[seg.device].view(-1) if self.device_seeds else None
        scalars = self._params[seg.device][:2].view(torch.float32)
        for fn in seg.fns:
            fn(self.buffers, scalars, key, self.generators, self.noise)

    def _sweep(self) -> None:
        for seg in self._segments:
            self._run(seg)

    def _write_params(self, alpha: float, beta: float,
                      seeds: Sequence[int] = ()) -> None:
        """α, β, V·β, K·α and, with device seeds, a zero cursor and the
        sweeps' seeds (``device_seeds`` a sweep, in a row), to every
        device's params."""
        words = sweep_scalars(alpha, beta, self.vocab_size,
                              self.num_topics).view(np.int64)
        if self.device_seeds:
            words = np.concatenate([words, np.array(
                [0, *(seed_word(s) for s in seeds)], np.int64)])
        for d, params in self._params.items():
            params[:words.shape[0]].copy_(staged(words, d), non_blocking=True)

    def _device_words(self, seeds, c0: int, c1: int) -> list:
        """Sweeps ``c0`` to ``c1``'s device seeds, in a row."""
        if not self.device_seeds:
            return []
        return [x for s in seeds[c0:c1] for x in s[:self.device_seeds]]

    def _copy_in(self, tables: Sequence[torch.Tensor]) -> None:
        if not _holds(self._last, tables):  # else the buffers hold this state
            _copy_into(self._corners_of(self.buffers), tables)
            if self._last is not None:  # not what this graph handed out
                count("graph.copy_in_bytes",
                      sum(t.numel() * t.element_size() for t in tables))

    def _corners_of(self, buffers: Sequence[torch.Tensor]) -> list:
        """The tables that ``buffers`` (the graph's, or clones of them)
        hold: each one's corner."""
        return [b if c is None else b[c] for b, c in zip(buffers, self._corners)]

    def _sweep_inputs(self, i: int, seeds, noise) -> None:
        """The host's part of sweep ``i``: its generators' seeds, its noise."""
        for g, s in zip(self.generators, seeds[i] if self.generators else ()):
            g.manual_seed(int(s))
        if noise is None:
            return
        u = noise(i)
        if self._noise_devices is None:
            if self.noise is None:
                self.noise = torch.empty(u.shape, dtype=u.dtype, device=self.device)
            self.noise.copy_(u, non_blocking=True)
            return
        if self.noise is None:
            self.noise = [torch.empty(x.shape, dtype=x.dtype, device=d)
                          for x, d in zip(u, self._noise_devices)]
        for buf, x in zip(self.noise, u):
            buf.copy_(x, non_blocking=True)

    def _capture(self) -> None:
        """A warm-up sweep, then each device segment captured into its
        device's memory pool and instantiated (``capture_graph``; its
        ``graph.capture`` spans summed in ``capture_s``)."""
        graphs, per_replay, nodes, capture_s = [], {}, 0, 0.0
        pools = {d: torch.cuda.graph_pool_handle() for d in self.devices
                 if sum(s.device == d for s in self._segments) > 1}
        for seg in self._segments:
            if seg.device is None:
                graphs.append(None)
                continue
            with torch.cuda.device(seg.device):
                graph, n, per, secs = capture_graph(
                    lambda seg=seg: self._run(seg), seg.device,
                    warm_up=None if graphs else self._sweep,
                    generators=[self.generators[i] for i in seg.generators],
                    pool=pools.get(seg.device), warm_up_devices=self.devices)
            graphs.append(graph)
            nodes += n
            capture_s += secs
            for k, c in per.items():
                per_replay[k] = per_replay.get(k, 0) + c
        self.graphs, self.graph = graphs, next(g for g in graphs if g is not None)
        self.nodes, self.per_replay, self.capture_s = nodes, per_replay, capture_s

    def _replay(self) -> None:
        for seg, graph in zip(self._segments, self.graphs):
            if graph is None:
                self._run(seg)
            elif seg.device == self.device:
                graph.replay()
            else:
                with torch.cuda.device(seg.device):
                    graph.replay()

    def _synchronize(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    def __call__(self, tables: Sequence[torch.Tensor], alpha: float, beta: float,
                 n: int, seeds: Optional[Sequence[Sequence[int]]] = None,
                 noise: Optional[Callable[[int], torch.Tensor]] = None,
                 ) -> tuple[torch.Tensor, ...]:
        """``n`` (> 0) sweeps from ``tables`` at ``alpha`` and ``beta``;
        returns the new tables (new tensors).  ``seeds[i]`` are sweep
        ``i``'s seeds (one per generator, or the device seeds first);
        ``noise(i)`` its noise array (``external``)."""
        if n <= 0:
            raise ValueError(f"{n} sweeps: a call runs at least one")
        if self.noise_mode == "internal" and (seeds is None or len(seeds) < n):
            raise ValueError("internal noise needs every sweep's seeds")
        if self.noise_mode == "external" and noise is None:
            raise ValueError("external noise needs noise(sweep)")
        on_card = self.device.type == "cuda"
        loaded = False  # sweep 0's noise already in its buffer
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            if on_card and self.graph is None:
                self._synchronize()
                with span("graph.setup", self.devices) as setup:
                    with span("graph.copy_in", self.devices):
                        self._copy_in(tables)
                        self._write_params(alpha, beta,
                                           self._device_words(seeds, 0, 1))
                        self._sweep_inputs(0, seeds, noise)
                    self._capture()
                self.setup_s = setup.seconds
                self._last, loaded = None, True
            self._copy_in(tables)
            for c0 in range(0, n, SEED_CHUNK if self.device_seeds else n):
                c1 = min(n, c0 + SEED_CHUNK) if self.device_seeds else n
                self._write_params(alpha, beta, self._device_words(seeds, c0, c1))
                for i in range(c0, c1):
                    self._sweep_inputs(i, seeds, None if i == 0 and loaded else noise)
                    if on_card:
                        self._replay()
                    else:
                        self._sweep()
            if on_card:
                _add_counts(self.per_replay, n)
                self.replays += n
                count("graph.replays", n)
            out = tuple(self._corners_of([b.clone() for b in self.buffers]))
            count("graph.handout_bytes", self._handout_bytes)
        self._last = (out, tuple(t._version for t in out))
        return out


class StepGraph:
    """``step()`` run ``n`` times in a row as one replay of a CUDA graph (one
    graph per distinct ``n``, captured at its first use on the card, all in
    one memory pool), over static buffers; run eagerly on the CPU.

    ``step`` works in place on ``state``, tensors that the caller allocated
    and the step closes over, and may read other tensors it closes over:
    inputs the host writes between replays (in place, so that they keep
    their addresses) and ``mutable`` ones that a step moves on (a cursor, a
    counter).  The first capture's warm-up step (``capture_graph``) is
    undone on ``state`` and ``mutable``.  :meth:`load` copies a state into
    the buffers unless it is what :meth:`result` last handed out,
    unmodified; :meth:`result` hands out clones.  A replay adds the kernel
    launches its capture counted; a failed capture or replay raises, and
    nothing runs the steps eagerly instead.

    ``setup_s`` is the first capture's wall time (the span ``graph.setup``:
    the warm-up, ``graph.warm_up``; the capture and the instantiation,
    ``graph.capture``; the card waited for before and after),
    ``capture_s[n]`` and ``nodes[n]`` each graph's capture and instantiation
    seconds (its ``graph.capture`` span) and node count.
    """

    def __init__(self, step: Callable[[], None], state: Sequence[torch.Tensor],
                 mutable: Sequence[torch.Tensor] = ()) -> None:
        self.step = step
        self.state = list(state)
        self.mutable = list(mutable)
        self.device = self.state[0].device
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.nodes: dict[int, int] = {}
        self.per_replay: dict[int, dict] = {}
        self.capture_s: dict[int, float] = {}
        self.setup_s: Optional[float] = None
        self.replays = 0
        self._pool = None
        self._last: Optional[tuple] = None

    def load(self, tables: Sequence[torch.Tensor]) -> None:
        """Copy ``tables`` into the state's buffers, unless they hold them."""
        if not _holds(self._last, tables):
            _copy_into(self.state, tables)
            self._last = None

    def result(self) -> tuple[torch.Tensor, ...]:
        """Clones of the state's buffers (what :meth:`load` may skip)."""
        out = tuple(b.clone() for b in self.state)
        self._last = (out, tuple(t._version for t in out))
        return out

    def run(self, n: int) -> None:
        """``n`` (> 0) steps: one replay on the card."""
        if n <= 0:
            raise ValueError(f"{n} steps: a run takes at least one")
        self._last = None  # the buffers move on from what was handed out
        if self.device.type != "cuda":
            self._steps(n)
            return
        graph = self.graphs.get(n)
        if graph is None:
            graph = self._capture(n)
        graph.replay()
        _add_counts(self.per_replay[n], 1)
        self.replays += 1

    def _steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def _warm_up(self) -> None:
        held = (*self.state, *self.mutable)
        saved = [t.clone() for t in held]
        self.step()
        for t, s in zip(held, saved):
            t.copy_(s)

    def _capture(self, n: int) -> torch.cuda.CUDAGraph:
        first = not self.graphs
        with torch.cuda.device(self.device):
            if first:
                torch.cuda.synchronize(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            with (span("graph.setup", self.device) if first
                  else contextlib.nullcontext()) as setup:
                graph, nodes, per_replay, secs = capture_graph(
                    lambda: self._steps(n), self.device,
                    warm_up=self._warm_up if first else None, pool=self._pool)
            if first:
                self.setup_s = setup.seconds
        self.graphs[n], self.nodes[n] = graph, nodes
        self.per_replay[n], self.capture_s[n] = per_replay, secs
        return graph
