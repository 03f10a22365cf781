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
wrappers' launch counters (``_device.LAUNCH_COUNTERS``) are Python and do
not run on a replay: the kernels a sweep launched during the capture are
counted once per replay instead.  On the card a failed capture or replay
raises; nothing runs the sweep eagerly instead.  On the CPU the same sweep
body runs eagerly on the same buffers (what the tests run).

The first call on the card reports its set-up: ``setup_s``, its whole
wall time before the first replay (the copies in, the warm-up sweep, the
capture and the instantiation; the call waits for the card before and
after it, once), ``capture_s``, the capture and instantiation alone, and
``nodes``, the captured graph's node count (the device operations of one
replay).

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
import gc
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldagibbssampling_tpu_torch.ops._device import (
    LAUNCH_COUNTERS, seed_word, staged, sweep_scalars)

# sweeps whose device seeds go to the card in one copy
SEED_CHUNK = 256


def _counts() -> dict:
    return {(mod, name): n for mod, d in LAUNCH_COUNTERS.items()
            for name, n in d.items()}


def _add_counts(per: dict, times: int) -> None:
    for (mod, name), n in per.items():
        LAUNCH_COUNTERS[mod][name] += n * times


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
                  pool=None) -> tuple:
    """``fn()`` captured into a new CUDA graph on a side stream, after
    ``warm_up()`` on that stream (it fills every launch configuration the
    kernel wrappers cache; outside the capture), into ``pool`` where given
    (else the graph's own private pool); raises if the capture fails.
    Returns ``(graph, nodes, per_replay, capture_s)``: the instantiated
    graph, its node count, the kernel launches the capture counted (now
    taken back: the capture launched nothing; they are each replay's) and
    the seconds of the capture and instantiation."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        if warm_up is not None:
            warm_up()
        # a graph that only a reference cycle holds is freed now: freed by
        # the collector during the capture, it would invalidate the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        before = _counts()
        t0 = time.perf_counter()
        graph.capture_begin(pool=pool)
        try:
            fn()
            nodes = _capture_node_count(side)
        finally:
            try:
                graph.capture_end()  # instantiates the graph
            finally:
                if collecting:
                    gc.enable()
        capture_s = time.perf_counter() - t0
    main.wait_stream(side)
    after = _counts()
    per_replay = {k: n - before.get(k, 0) for k, n in after.items()
                  if n != before.get(k, 0)}
    _add_counts(per_replay, -1)
    return graph, nodes, per_replay, capture_s


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


class SweepGraph:
    """One sweep of ``body`` over static buffers shaped like ``tables``:
    captured as a CUDA graph at the first call on the card and replayed
    once per sweep; run eagerly on the CPU.

    ``body(buffers, scalars, key, generators, noise)`` runs one sweep in
    place on ``buffers``: ``scalars`` is the float32 ``[4]`` view of α, β,
    V·β and K·α, ``key`` the sweep's int64 ``[1]`` seed (``device_seeds``;
    else ``None``), ``generators`` ``num_generators`` generators on the
    device, reseeded per sweep (``internal`` noise), and ``noise`` the
    sweep's noise array (``external`` noise; else ``None``).  A body that
    draws nothing (CVB0's) takes ``noise_mode="deterministic"``: no seeds,
    no noise.  Everything it reads besides these must outlive the graph.  ``padded[i]``, where given,
    is table ``i``'s buffer shape: the buffer is that zeroed tensor, the
    table its leading corner (``buffer[:V, :K]``), and ``body`` gets the
    whole buffer.
    """

    def __init__(self, body: Body, tables: Sequence[torch.Tensor], *,
                 vocab_size: int, num_topics: int, noise_mode: str,
                 num_generators: int = 0, device_seeds: bool = False,
                 padded: Optional[Sequence[Optional[tuple]]] = None) -> None:
        self.body = body
        self.device = tables[0].device
        self.vocab_size, self.num_topics = vocab_size, num_topics
        self.noise_mode = noise_mode
        padded = padded or (None,) * len(tables)
        self.buffers = [torch.empty_like(t, memory_format=torch.contiguous_format)
                        if p is None else
                        torch.zeros(p, dtype=t.dtype, device=self.device)
                        for t, p in zip(tables, padded)]
        # each table's corner of its buffer (the whole buffer where unpadded)
        self._corners = [None if p is None else tuple(slice(0, n) for n in t.shape)
                         for t, p in zip(tables, padded)]
        self.device_seeds = device_seeds and noise_mode == "internal"
        self.params = torch.zeros(2 + (1 + SEED_CHUNK if self.device_seeds else 0),
                                  dtype=torch.int64, device=self.device)
        self.scalars = self.params[:2].view(torch.float32)
        self.generators = ([torch.Generator(device=self.device)
                            for _ in range(num_generators)]
                           if noise_mode == "internal" else [])
        self.noise: Optional[torch.Tensor] = None  # allocated at the first call
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_replay: dict = {}   # kernel launches of one replay
        self.setup_s = self.capture_s = None
        self.nodes = 0  # the graph's nodes: the card's operations a replay
        self.replays = 0
        # the tensors the last call returned and their versions: the same
        # memory (a view of it too), unmodified, is what the buffers hold
        self._last: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _sweep(self) -> None:
        key = None
        if self.device_seeds:
            cursor = self.params[2:3]
            key = torch.index_select(self.params[3:], 0, cursor)
            cursor.add_(1)
        self.body(self.buffers, self.scalars, key, self.generators, self.noise)

    def _write_params(self, alpha: float, beta: float,
                      seeds: Sequence[int] = ()) -> None:
        words = sweep_scalars(alpha, beta, self.vocab_size,
                              self.num_topics).view(np.int64)
        if self.device_seeds:
            words = np.concatenate([words, np.array(
                [0, *(seed_word(s) for s in seeds)], np.int64)])
        self.params[:words.shape[0]].copy_(staged(words, self.device),
                                           non_blocking=True)

    def _copy_in(self, tables: Sequence[torch.Tensor]) -> None:
        if not _holds(self._last, tables):  # else the buffers hold this state
            _copy_into(self._corners_of(self.buffers), tables)

    def _corners_of(self, buffers: Sequence[torch.Tensor]) -> list:
        """The tables that ``buffers`` (the graph's, or clones of them)
        hold: each one's corner."""
        return [b if c is None else b[c] for b, c in zip(buffers, self._corners)]

    def _sweep_inputs(self, i: int, seeds, noise) -> None:
        """The host's part of sweep ``i``: its generators' seeds, its noise."""
        for g, s in zip(self.generators, seeds[i] if self.generators else ()):
            g.manual_seed(int(s))
        if noise is not None:
            u = noise(i)
            if self.noise is None:
                self.noise = torch.empty(u.shape, dtype=u.dtype, device=self.device)
            self.noise.copy_(u, non_blocking=True)

    def _capture(self) -> None:
        """A warm-up sweep, then one sweep captured into the graph's private
        memory pool and instantiated (``capture_graph``)."""
        self.graph, self.nodes, self.per_replay, self.capture_s = capture_graph(
            self._sweep, self.device, warm_up=self._sweep,
            generators=self.generators)

    def __call__(self, tables: Sequence[torch.Tensor], alpha: float, beta: float,
                 n: int, seeds: Optional[Sequence[Sequence[int]]] = None,
                 noise: Optional[Callable[[int], torch.Tensor]] = None,
                 ) -> tuple[torch.Tensor, ...]:
        """``n`` (> 0) sweeps from ``tables`` at ``alpha`` and ``beta``;
        returns the new tables (new tensors).  ``seeds[i]`` are sweep
        ``i``'s seeds (one per generator, or the device seed first);
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
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                self._copy_in(tables)
                self._write_params(alpha, beta, [s[0] for s in seeds[:1]]
                                   if self.device_seeds else ())
                self._sweep_inputs(0, seeds, noise)
                self._capture()
                torch.cuda.synchronize(self.device)
                self.setup_s = time.perf_counter() - t0
                self._last, loaded = None, True
            self._copy_in(tables)
            for c0 in range(0, n, SEED_CHUNK if self.device_seeds else n):
                c1 = min(n, c0 + SEED_CHUNK) if self.device_seeds else n
                self._write_params(alpha, beta, [s[0] for s in seeds[c0:c1]]
                                   if self.device_seeds else ())
                for i in range(c0, c1):
                    self._sweep_inputs(i, seeds, None if i == 0 and loaded else noise)
                    if on_card:
                        self.graph.replay()
                    else:
                        self._sweep()
            if on_card:
                _add_counts(self.per_replay, n)
                self.replays += n
            out = tuple(self._corners_of([b.clone() for b in self.buffers]))
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

    ``setup_s`` is the first capture's wall time (the warm-up, the capture
    and the instantiation; the card waited for before and after),
    ``capture_s[n]`` and ``nodes[n]`` each graph's capture and instantiation
    seconds and node count.
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
                t0 = time.perf_counter()
                self._pool = torch.cuda.graph_pool_handle()
            graph, nodes, per_replay, secs = capture_graph(
                lambda: self._steps(n), self.device,
                warm_up=self._warm_up if first else None, pool=self._pool)
            if first:
                torch.cuda.synchronize(self.device)
                self.setup_s = time.perf_counter() - t0
        self.graphs[n], self.nodes[n] = graph, nodes
        self.per_replay[n], self.capture_s[n] = per_replay, secs
        return graph
