"""What the mesh runtimes share: shard placement, noise, the local sweep.

The reference's runtimes (``ldagibbssampling_tpu/parallel/adlda.py``,
``grid.py``, ``tokenshard.py``, ``chaingrid.py``) keep each table as one
array sharded over a ``jax.sharding.Mesh`` and run one ``shard_map``
program per call.  Here a runtime keeps, for each position it holds, one
tensor per table on that position's device, in dicts keyed by position
(``self.z``, ``self.ndk``, ``self.nwk``, ``self.nk``).  ``SPEC`` names the
mesh axes that index each table's leading dimensions in the reference's
stacked host view (``arrays()``, ``load_arrays()``): a table indexed by
fewer axes than the mesh has is replicated over the others, and the
positions of a replica on one device share one tensor.  No sweep writes
into a state tensor: each local sweep works on copies.

A call of ``n`` sweeps replays one graph per sweep, as the reference's
``jax.jit(shard_map(lax.fori_loop(...)))`` is one dispatch
(``_build_graph``: ``ops/graphs.SweepGraph`` over one buffer per distinct
table).  The graph holds every position's local sweep in turn (the
tier's in-place bodies of ``ops/gibbs``, on one stream: K1's walk is a
cooperative launch over the whole card) and the whole reconciliation,
each runtime's ``_reconcile_rules``: each ``psum`` group's local parts
added up on the device (``multihost.local_sum``).  Where a group spans
processes its ``all_reduce`` (``multihost.reduce_across``) runs on the
host between two graphs; where positions span CUDA devices of this
process, each device has its graphs and the copies between devices run
between them (not exercised on one card).  On the CPU the same steps run
eagerly on the same buffers.  The eager sweep
(``_eager_sweeps``: ``_local_sweeps``, the tier's eager sweeps, then each
runtime's ``_eager_sweep_once`` through ``multihost.psum``) is what the
tests and ``chip_smoke.py`` hold the graph against; nothing else runs it.

Noise: ``internal`` draws one seed per sweep from the runtime's
``torch.Generator`` (its state goes into the checkpoint) and gives the shard
at position ``p`` the seed ``(seed + p * 0x9E3779B97F4A7C15) mod 2^63``:
its own Philox stream for the kernels, its own generator for the XLA tier.
``external`` takes ``sweep(n, noise=f)`` with ``f(position, sweep)`` the
shard's array for that sweep (the XLA tier's ``[T_s, K]`` Gumbel values or
``inverse_cdf``'s ``[T_s]`` uniforms, the kernels' ``[T_s, k_pad]``
uniforms), as ``ops/gibbs.py`` takes them.  ``deterministic`` takes the
argmax.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.count_kernel import cast_mirror
from ldagibbssampling_tpu_torch.ops.fused_kernel import NOISE_MODES
from ldagibbssampling_tpu_torch.ops.gibbs import (
    _deferred_walk_, _fused_sweep_, _round_up, _sweep_values, _xla_sweep_,
    fused_gibbs_sweep, gibbs_sweep, snapshot)
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph
from ldagibbssampling_tpu_torch.parallel import multihost

_GOLDEN = 0x9E3779B97F4A7C15
TABLES = ("z", "ndk", "nwk", "nk")
_log = logging.getLogger("ldagibbssampling_tpu_torch")


def bincount_table(rows: np.ndarray, cols: np.ndarray, shape) -> np.ndarray:
    """int64 ``shape`` table counting each ``(row, col)`` pair."""
    n = int(shape[0]) * int(shape[1])
    flat = rows.astype(np.int64) * int(shape[1]) + cols.astype(np.int64)
    return np.bincount(flat, minlength=n).reshape(shape)


def resolve_mesh_tier(use_pallas, draw_method: str, block: int) -> Any:
    """The reference constructors' first rules (``adlda.py:479-492``; its
    platform rule is not reproduced): the fused and deferred tiers need the
    gumbel draw and a block of 128 tokens or more, else the XLA tier runs."""
    if use_pallas in ("fused", "deferred") and (draw_method != "gumbel" or block < 128):
        return False
    return use_pallas


def sweep_fn_tier(deferred_layout: Optional[dict], use_pallas, draw_method: str,
                  block: int, fused_row_tile: Callable[[], Optional[int]],
                  layout_fn: str) -> tuple[str, int]:
    """``(tier, row_tile)`` of the reference's ``make_sharded_sweep_fn`` and
    ``make_grid_sweep_fn`` (its platform rule aside): ``deferred_layout``
    runs the deferred tier; ``use_pallas="deferred"`` without it runs the
    fused tier, which needs the gumbel draw, a block of 128 or more and a
    row tile (``fused_row_tile()``); otherwise the XLA tier."""
    if deferred_layout is not None:
        return "deferred", deferred_layout["row_tile"]
    if use_pallas == "deferred":
        _log.warning("kernel tier: requested 'deferred' -> running 'fused' "
                     "(no deferred_layout supplied; see %s)", layout_fn)
        use_pallas = "fused"
    if use_pallas == "fused":
        row_tile = (fused_row_tile() if draw_method == "gumbel" and block >= 128
                    else None)
        if row_tile is not None:
            return "fused", row_tile
        _log.warning("kernel tier: requested 'fused' -> running 'xla' "
                     "(no fused plan)")
    return "xla", 0


class MeshRuntime:
    """Base of the mesh runtimes (see the module docstring)."""

    SPEC: dict[str, tuple[str, ...]] = {}

    def _setup(self, config, corpus, mesh, noise_mode: str) -> None:
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        self.config = config
        self.corpus = corpus
        self.mesh = mesh
        self.noise_mode = noise_mode
        self.positions = mesh.local_positions
        if not self.positions:
            raise ValueError("this process holds no position of the mesh")
        self.device = mesh.devices[self.positions[0]]
        self.devices = list(dict.fromkeys(mesh.devices[p] for p in self.positions))
        self.alpha = float(config.alpha)
        self.beta = float(config.beta)
        self.sweep_idx = 0
        self.graph: Optional[SweepGraph] = None  # built at the first sweep

    def _init_generators(self, shape, num_topics: int) -> np.ndarray:
        """The initial ``z`` over the stacked token shape, drawn from the
        config's seed, and the sweeps' generator seeded after it."""
        gen = torch.Generator().manual_seed(int(self.config.seed))
        z = torch.randint(0, num_topics, tuple(shape), generator=gen, dtype=torch.int32)
        self.generator = torch.Generator().manual_seed(
            int(torch.randint(0, 2**62, (), generator=gen)))
        return z.numpy()

    # ------------------------------------------------------------------
    def _idx(self, pos: int, axes) -> tuple:
        c = self.mesh.coords(pos)
        return tuple(c[self.mesh.axis_names.index(a)] for a in axes)

    def _put(self, stacked, axes, dtype=torch.int32) -> dict[int, torch.Tensor]:
        """Each held position's slice of a stacked host array on its device,
        one tensor per (slice, device)."""
        stacked = np.asarray(stacked)
        cache: dict = {}
        out = {}
        for p in self.positions:
            key = (self._idx(p, axes), self.mesh.devices[p])
            if key not in cache:
                part = np.ascontiguousarray(stacked[key[0]])
                cache[key] = torch.from_numpy(part).to(device=key[1], dtype=dtype)
            out[p] = cache[key]
        return out

    def arrays(self) -> dict[str, np.ndarray]:
        """The state in the reference's stacked host view (``SPEC``)."""
        out = {}
        for name, axes in self.SPEC.items():
            parts = multihost.gather(getattr(self, name), self.mesh)
            first = next(iter(parts.values()))
            lead = tuple(self.mesh.axis_size(a) for a in axes)
            arr = np.zeros(lead + first.shape, first.dtype)
            for p, v in parts.items():
                arr[self._idx(p, axes)] = v
            out[name] = arr
        return out

    def load_arrays(self, arrays, sweep: Optional[int] = None) -> None:
        """Set the state from the stacked host view (``interop``, restore)."""
        for name, axes in self.SPEC.items():
            setattr(self, name, self._put(arrays[name], axes))
        if sweep is not None:
            self.sweep_idx = int(sweep)

    # ------------------------------------------------------------------
    def _seeds(self, seed: Optional[int], sweep: int) -> dict:
        """Internal noise: each position's seed of sweep ``sweep``, the
        base drawn from the runtime's generator, or derived from ``(seed,
        sweep)`` where ``seed`` is given."""
        if seed is None:
            base = int(torch.randint(0, 2**63 - 1, (), generator=self.generator))
        else:
            base = int(np.random.SeedSequence([seed, sweep])
                       .generate_state(1, np.uint64)[0] >> np.uint64(1))
        return {p: (base + p * _GOLDEN) % (1 << 63) for p in self.positions}

    def _sweep_noise(self, noise: Optional[Callable],
                     seed: Optional[int] = None) -> tuple[dict, dict]:
        """Per position: the sweep's seed and its external noise array (the
        eager sweep's inputs)."""
        if self.noise_mode == "internal":
            return self._seeds(seed, self.sweep_idx), {}
        seeds = dict.fromkeys(self.positions, 0)
        if self.noise_mode == "deterministic":
            return seeds, {}
        if noise is None:
            raise ValueError("noise_mode='external' needs sweep(..., noise=f)")
        return seeds, {p: _as_f32(noise(p, self.sweep_idx), self.mesh.devices[p])
                       for p in self.positions}

    def sweep(self, n: int = 1, noise: Optional[Callable] = None) -> None:
        """``n`` sweeps with the current α and β: no host read in between."""
        self._sweeps(n, noise)

    def _sweeps(self, n: int, noise: Optional[Callable],
                seed: Optional[int] = None) -> None:
        """``n`` sweeps, one replay each of the runtime's graph
        (:meth:`_build_graph` at the first; on the CPU its steps run
        eagerly)."""
        if n <= 0:
            return
        if self.noise_mode == "external" and noise is None:
            raise ValueError("noise_mode='external' needs sweep(..., noise=f)")
        if self.graph is None:
            self.graph = self._build_graph()
        s0, drawn, seeds = self.sweep_idx, None, None
        if self.noise_mode == "internal":
            if seed is None:
                drawn = self.generator.get_state()
            seeds = [tuple(self._seeds(seed, s0 + i).values()) for i in range(n)]
        arrays = None
        if self.noise_mode == "external":
            def arrays(i):
                return [_f32(noise(p, s0 + i)) for p in self.positions]
        tables = [getattr(self, name)[p] for name, p in self._graph_tables]
        try:
            out = self.graph(tables, self.alpha, self.beta, n, seeds=seeds, noise=arrays)
        except BaseException:
            if drawn is not None:
                self.generator.set_state(drawn)  # a failed call takes no seed
            raise
        for name in TABLES:
            setattr(self, name, {p: out[i] for p, i in self._slots[name].items()})
        self.sweep_idx += n

    def _eager_sweeps(self, n: int, noise: Optional[Callable] = None,
                      seed: Optional[int] = None) -> None:
        """``n`` sweeps launched op by op from the host (each runtime's
        ``_eager_sweep_once``): what the graph's replays are held against."""
        for _ in range(n):
            seeds, arrays = self._sweep_noise(noise, seed)
            self._eager_sweep_once(seeds, arrays)
            self.sweep_idx += 1

    def sweep_fn(self, num_sweeps: int) -> Callable:
        """This runtime's sweep as the reference's ``make_*_sweep_fn``
        callable: ``run(z, ndk, nwk, nk, seed, sweep, n_sweeps=None,
        alpha_v=None, beta_v=None, noise=None) -> (z, ndk, nwk, nk)``, each
        table a dict of this process's positions' tensors.  ``n_sweeps``
        (default ``num_sweeps``) sweeps from sweep index ``sweep``, with
        ``alpha_v`` and ``beta_v`` (default the runtime's α and β); internal
        noise from ``(seed, sweep index)``, external from ``noise(position,
        sweep)``.  ``run.kernel_tier`` names the tier, ``run.runtime`` is
        the runtime; a call replays its graph once per sweep."""
        alpha, beta = self.alpha, self.beta

        def run(z, ndk, nwk, nk, seed, sweep, n_sweeps=None, alpha_v=None,
                beta_v=None, noise=None):
            self.z, self.ndk, self.nwk, self.nk = dict(z), dict(ndk), dict(nwk), dict(nk)
            self.alpha = float(alpha if alpha_v is None else alpha_v)
            self.beta = float(beta if beta_v is None else beta_v)
            self.sweep_idx = int(sweep)
            self._sweeps(num_sweeps if n_sweeps is None else n_sweeps, noise, int(seed))
            return self.z, self.ndk, self.nwk, self.nk

        run.kernel_tier = self.kernel_tier
        run.runtime = self
        return run

    @property
    def sweeps_done(self) -> int:
        return int(self.sweep_idx)

    def _snapshots(self, v_pad: int) -> dict[int, torch.Tensor]:
        """The deferred tier's bf16 snapshot of each position's reconciled
        ``nwk`` (K2's ``cast_mirror``), one per distinct table tensor."""
        out, cache = {}, {}
        for p in self.positions:
            t = self.nwk[p]
            if id(t) not in cache:
                cache[id(t)] = snapshot(t, v_pad, _round_up(t.shape[1], 128), "bfloat16")
            out[p] = cache[id(t)]
        return out

    def _local_sweeps(self, seeds: dict, noise: dict) -> dict:
        """The eager sweep's first half: each held position's sweep of its token stream (``self._tokens``)
        in ``self.kernel_tier``: the new ``SamplerState`` (XLA and fused
        tiers) or ``(z, ndk, local_nwk)`` (deferred tier, ``local_nwk`` the
        rebuild of the stream's own counts), keyed by position."""
        tier, layout = self.kernel_tier, self._layout
        vocab_size = self._global_vocab()
        v_pad = layout["v_pad"] if layout else 0
        snaps = self._snapshots(v_pad) if tier == "deferred" else {}
        out = {}
        # the shards in turn: on one card never on concurrent streams (K1's
        # walk is a cooperative launch over the whole card)
        for p in self.positions:
            state, (tw, td, tm) = self._state(p), self._tokens[p]
            if tier == "deferred":
                # the graph's step (_local_step) on clones of the tables
                v_rows, k = state.nwk.shape
                k_pad = _round_up(k, 128)
                scalars, key = _sweep_values(self.alpha, self.beta,
                                             vocab_size or v_rows, k, seeds[p],
                                             tw.device)
                z, ndk, nk = state.z.clone(), state.ndk.clone(), state.nk.clone()
                local = (tw.new_zeros((v_pad, k_pad)), tw.new_zeros(k_pad))
                _deferred_walk_(z, ndk, nk, snaps[p], tw, td, tm, out=local,
                                scalars=scalars, key=key, row_tile=self._row_tile,
                                noise_mode=self.noise_mode, noise=noise.get(p),
                                compute_dtype="float32")
                out[p] = (z, ndk, local[0][:v_rows, :k])
            elif tier == "fused":
                out[p] = fused_gibbs_sweep(
                    state, tw, td, tm, self.alpha, self.beta,
                    block_size=self.block_size, row_tile=self._row_tile,
                    noise_mode=self.noise_mode, seed=seeds[p],
                    uniforms=noise.get(p), vocab_size=vocab_size)
            else:
                out[p] = gibbs_sweep(
                    state, tw, td, tm, self._dl[p], alpha=self.alpha,
                    beta=self.beta, block_size=self.block_size,
                    draw_method=self.config.draw_method, vocab_size=vocab_size,
                    noise_mode=self.noise_mode, seed=seeds[p], noise=noise.get(p))
        return out

    # ------------------------------------------------------------------
    # the sweep as one graph (ops/graphs.SweepGraph over the distinct tables)
    def _reconcile_rules(self) -> list[tuple[str, str, tuple]]:
        """How a sweep reconciles the tables after the local sweeps, in
        order, as the runtime's eager sweep does: ``(table, kind, axes)``
        with kind ``"set"`` (the table is the psum over ``axes`` of the
        positions' local tables, K2's rebuilds), ``"add"`` (the table plus
        the psum of the positions' moves) or ``"colsum"`` (the column sum
        of the reconciled ``nwk``, psum'd over ``axes`` where any).  A table
        that no rule names is the position's own, swept in place (``z``, and
        ``ndk`` where it is not replicated)."""
        raise NotImplementedError

    def _global_vocab(self) -> Optional[int]:
        """The V of V·β where it is not the height of ``nwk``."""
        return None

    def _build_graph(self) -> SweepGraph:
        """The sweep as the steps of one :class:`graphs.SweepGraph`, over
        one buffer per distinct table (a replica's positions on one device
        share it, as they share the tensor): per position in turn its local
        sweep in the tier (the in-place bodies of ``ops/gibbs``: the XLA
        tier's ``_xla_sweep_``, the fused ``_fused_sweep_``, the deferred
        ``_deferred_walk_`` after the snapshot of each distinct ``nwk``), on
        copies of the replicated tables and of its own where a rule moves
        it; then the reconciliation (:meth:`_reconcile_rules`) in stages: a
        rule that reads a table that an earlier rule of the stage updates
        starts the next stage.  A stage adds each psum group's local parts
        in shard order (``multihost.local_sum``, captured), runs the
        ``all_reduce`` of every group that spans processes on the host
        (``multihost.reduce_across``: the graph splits there), then updates
        the tables.  A part or a sum on another device of this process is
        copied there on the host, between the graphs."""
        tier, k = self.kernel_tier, int(self.config.topic_num)
        pos = list(self.positions)
        dev = self._devices_of()
        rules = self._reconcile_rules()
        kind_of = {name: kind for name, kind, _ in rules}
        # one buffer per distinct (slice, device) of each table
        self._slots, self._graph_tables = {}, []
        for name in TABLES:
            seen, self._slots[name] = {}, {}
            for p in pos:
                key = (self._idx(p, self.SPEC[name]), dev[p])
                if key not in seen:
                    seen[key] = len(self._graph_tables)
                    self._graph_tables.append((name, p))
                self._slots[name][p] = seen[key]
        slots = self._slots
        tables = [getattr(self, name)[p] for name, p in self._graph_tables]
        v_rows = next(t.shape[0] for (name, _), t in zip(self._graph_tables, tables)
                      if name == "nwk")
        deferred = tier == "deferred"
        v_pad, k_pad = (self._layout["v_pad"] if deferred else 0), _round_up(k, 128)
        padded = [(v_pad, k_pad) if deferred and name == "nwk" else None
                  for name, _ in self._graph_tables]

        def zeros(shape, device, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def state(bufs, name, p):  # position p's table (the corner of a padded one)
            b = bufs[slots[name][p]]
            return b[:v_rows, :k] if padded[slots[name][p]] else b

        def first_of(name):  # each buffer of ``name`` and its first position
            return {s: next(p for p in pos if slots[name][p] == s)
                    for s in dict.fromkeys(slots[name][p] for p in pos)}

        shape = {name: tuple(tables[slots[name][pos[0]]].shape) for name in TABLES}
        # the tables a local sweep moves: on copies, per position where the
        # rule adds its moves up, else one scratch per device
        moved = ("ndk", "nk") if deferred else ("ndk", "nwk", "nk")
        work, scratch = {}, {}
        for name in moved:
            if kind_of.get(name, "own") == "own":
                continue
            for p in pos:
                if kind_of[name] == "add":
                    work[name, p] = zeros(shape[name], dev[p])
                else:
                    if (name, dev[p]) not in scratch:
                        scratch[name, dev[p]] = zeros(shape[name], dev[p])
                    work[name, p] = scratch[name, dev[p]]
        steps: list = []
        if deferred:  # the bf16 snapshot of each distinct reconciled nwk
            snaps = {s: zeros((v_pad, k_pad), dev[p], torch.bfloat16)
                     for s, p in first_of("nwk").items()}
            local = {p: (zeros((v_pad, k_pad), dev[p]), zeros(k_pad, dev[p]))
                     for p in pos}
            for s, p in first_of("nwk").items():
                steps.append((dev[p], lambda bufs, *_, s=s: cast_mirror(
                    bufs[s], out=snaps[s]), ()))
        for j, p in enumerate(pos):
            draws = tier == "xla" and self.noise_mode == "internal"
            steps.append((dev[p], self._local_step(
                j, p, tier, state, work, moved, kind_of,
                snaps[slots["nwk"][p]] if deferred else None,
                local[p] if deferred else None), (j,) if draws else ()))
        # the reconciliation, stage by stage
        stage: list = []
        for rule in rules:
            if rule[1] == "colsum" and any(r[0] == "nwk" for r in stage):
                steps += self._stage_steps(stage, slots, state, work, first_of,
                                           local if deferred else None, zeros)
                stage = []
            stage.append(rule)
        steps += self._stage_steps(stage, slots, state, work, first_of,
                                   local if deferred else None, zeros)
        graph_vocab = self._global_vocab() or v_rows
        return SweepGraph(
            steps, tables, vocab_size=graph_vocab, num_topics=k,
            noise_mode=self.noise_mode, padded=padded,
            device_seeds=0 if tier == "xla" else len(pos),
            generator_devices=[dev[p] for p in pos] if tier == "xla" else None,
            noise_devices=([dev[p] for p in pos] if self.noise_mode == "external"
                           else None))

    def _devices_of(self) -> dict:
        """Each held position's device as its tensors name it (``cuda`` is
        ``cuda:0`` there): the graph's steps are grouped by it."""
        return {p: self._tokens[p][0].device for p in self.positions}

    def _local_step(self, j, p, tier, state, work, moved, kind_of, snap, local):
        """Position ``p``'s (the ``j``-th held) local sweep as a graph step."""
        tw, td, tm = self._tokens[p]
        noise_mode = self.noise_mode

        def step(bufs, scalars, key, generators, noise):
            t = {}
            for name in ("ndk", "nwk", "nk"):
                if kind_of.get(name, "own") == "own" or name not in moved:
                    t[name] = state(bufs, name, p)
                else:
                    t[name] = work[name, p]
                    t[name].copy_(state(bufs, name, p))
            z = state(bufs, "z", p)
            kj = None if key is None else key[j:j + 1]
            u = None if noise is None else noise[j]
            if tier == "deferred":
                _deferred_walk_(z, t["ndk"], t["nk"], snap, tw, td, tm, out=local,
                                scalars=scalars, key=kj, row_tile=self._row_tile,
                                noise_mode=noise_mode, noise=u,
                                compute_dtype="float32")
            elif tier == "fused":
                _fused_sweep_(z, t["ndk"], t["nwk"], t["nk"], tw, td, tm,
                              scalars=scalars, key=kj, block_size=self.block_size,
                              row_tile=self._row_tile, noise_mode=noise_mode, noise=u)
            else:
                _xla_sweep_(z[None], t["ndk"][None], t["nwk"][None], t["nk"][None],
                            tw, td, tm, self._dl[p], scalars=scalars,
                            block_size=self.block_size,
                            draw_method=self.config.draw_method,
                            prob_dtype=torch.float32, noise_mode=noise_mode,
                            generators=generators[j:j + 1],
                            noise=None if u is None else u[None])
            for name in moved:  # the moves that the reconciliation adds up
                if kind_of.get(name) == "add":
                    t[name].sub_(state(bufs, name, p))
        return step

    def _stage_steps(self, stage, slots, state, work, first_of, local, zeros) -> list:
        """One reconciliation stage's steps: every rule's psum groups added
        up, the spanning groups' ``all_reduce`` on the host, then every
        table updated (one step per buffer)."""
        mesh, dev = self.mesh, self._devices_of()
        first, reduce, update = [], [], []
        for name, kind, axes in stage:
            if kind == "colsum" and not axes:  # each buffer's column sum
                for s, p in first_of(name).items():
                    update.append((dev[p], lambda bufs, *_, s=s, p=p: torch.sum(
                        state(bufs, "nwk", p), dim=0, dtype=torch.int32,
                        out=bufs[s]), ()))
                continue
            if kind == "colsum":  # the parts: each distinct nwk's column sums
                colsums = {}
                for s, p in first_of("nwk").items():
                    colsums[s] = zeros(self.config.topic_num, dev[p])
                    first.append((dev[p], lambda bufs, *_, s=s, p=p: torch.sum(
                        state(bufs, "nwk", p), dim=0, dtype=torch.int32,
                        out=colsums[s]), ()))
            groups = multihost.local_groups(mesh, axes)
            users = {}  # buffer -> the groups that reach it
            for g in groups:
                for p in g.local:
                    users.setdefault(slots[name][p], set()).add(g)
            fed: dict = {}  # buffer -> the sum that it takes
            for g in groups:
                d0 = dev[g.local[0]]
                parts = []
                for p in g.local:
                    part = (local[p][0] if kind == "set" else work[name, p]
                            if kind == "add" else colsums[slots["nwk"][p]])
                    if part.device != d0:  # brought over on the host
                        near = torch.empty_like(part, device=d0)
                        first.append((None, lambda _, a=near, b=part: a.copy_(b), ()))
                        part = near
                    parts.append(part)
                own = {slots[name][p] for p in g.local}
                s0 = slots[name][g.local[0]]
                if kind != "add" and own == {s0} and users[s0] == {g}:
                    total = None  # the sum goes straight into the table
                else:
                    total = torch.empty_like(parts[0])
                first.append((d0, lambda bufs, *_, t=total, ps=parts, s=s0:
                              multihost.local_sum(ps, out=bufs[s] if t is None else t),
                              ()))
                if g.spans:
                    reduce.append((None, lambda bufs, t=total, g=g, s=s0:
                                   multihost.reduce_across(
                                       bufs[s] if t is None else t, g), ()))
                for s in dict.fromkeys(slots[name][p] for p in g.local):
                    fed.setdefault(s, total)
            for s, total in fed.items():
                if total is None:
                    continue
                p = first_of(name)[s]
                src = total
                if total.device != dev[p]:
                    src = torch.empty_like(total, device=dev[p])
                    update.append((None, lambda _, a=src, b=total: a.copy_(b), ()))
                update.append((dev[p], lambda bufs, *_, s=s, src=src, add=kind == "add":
                               bufs[s].add_(src) if add else bufs[s].copy_(src), ()))
        return first + reduce + update

    def _state(self, p: int) -> SamplerState:
        return SamplerState(z=self.z[p], ndk=self.ndk[p], nwk=self.nwk[p],
                            nk=self.nk[p], sweep=self.sweep_idx)

    # ------------------------------------------------------------------
    def _ckpt_meta(self) -> dict:
        return {"axes": list(self.mesh.axis_names), "shape": list(self.mesh.shape)}

    def save_checkpoint(self, directory) -> int:
        """The run (the stacked state, the live α and β, the sweeps'
        generator) at step ``sweeps_done``; one writer with several
        processes."""
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import save_mesh_run

        arrays = self.arrays()
        if multihost.world()[0] == 0:
            save_mesh_run(directory, arrays, self.alpha, self.beta,
                          self.sweep_idx, mesh=self._ckpt_meta(),
                          generator=self.generator)
        _barrier()
        return self.sweep_idx

    def restore_checkpoint(self, directory) -> int:
        """Resume from the latest checkpoint, saved on a mesh of the same
        shape (another shape raises, the reference's non-goal)."""
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import restore_mesh_run

        like = {name: (tuple(self.mesh.axis_size(a) for a in axes)
                       + tuple(next(iter(getattr(self, name).values())).shape))
                for name, axes in self.SPEC.items()}
        arrays, self.alpha, self.beta, gen_state, step = restore_mesh_run(
            directory, like, mesh=self._ckpt_meta())
        self.load_arrays(arrays, sweep=step)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        return self.sweep_idx


def _as_f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor, where it lies (a graph copies it in)."""
    if not torch.is_tensor(x):
        return torch.from_numpy(np.array(x, np.float32))
    return x.to(torch.float32)


def _barrier() -> None:
    if multihost.world()[1] > 1:
        multihost._dist().barrier()


def per_tensor(fn, *tables: dict) -> dict:
    """``fn`` over each position's tensors, once for positions whose inputs
    are the same tensors (replicas on one device)."""
    cache, out = {}, {}
    for p in tables[0]:
        key = tuple(id(t[p]) for t in tables)
        if key not in cache:
            cache[key] = fn(*(t[p] for t in tables))
        out[p] = cache[key]
    return out


def column_sum(table: torch.Tensor) -> torch.Tensor:
    """Exact int32 topic totals of a word-topic table."""
    return table.sum(dim=0, dtype=torch.int32)
