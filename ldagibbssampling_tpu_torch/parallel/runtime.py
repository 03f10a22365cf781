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

Each sweep runs the positions' local sweeps one after another
(``_local_sweeps``: the tier's kernels, through the wrappers of ``ops/``)
and then reconciles through ``multihost.psum``.

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
from ldagibbssampling_tpu_torch.ops.fused_kernel import NOISE_MODES
from ldagibbssampling_tpu_torch.ops.gibbs import (
    _round_up, deferred_local_counts, fused_gibbs_sweep, gibbs_sweep, snapshot)
from ldagibbssampling_tpu_torch.parallel import multihost

_GOLDEN = 0x9E3779B97F4A7C15
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
    def _sweep_noise(self, noise: Optional[Callable],
                     seed: Optional[int] = None) -> tuple[dict, dict]:
        """Per position: the sweep's seed and its external noise array.
        Internal noise draws the sweep's seed from the runtime's generator,
        or, given ``seed``, derives it from ``(seed, sweep)``."""
        if self.noise_mode == "internal":
            if seed is None:
                base = int(torch.randint(0, 2**63 - 1, (), generator=self.generator))
            else:
                base = int(np.random.SeedSequence([seed, self.sweep_idx])
                           .generate_state(1, np.uint64)[0] >> np.uint64(1))
            return {p: (base + p * _GOLDEN) % (1 << 63) for p in self.positions}, {}
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
        for _ in range(n):
            seeds, arrays = self._sweep_noise(noise, seed)
            self._sweep_once(seeds, arrays)
            self.sweep_idx += 1

    def sweep_fn(self, num_sweeps: int) -> Callable:
        """This runtime's sweep as the reference's ``make_*_sweep_fn``
        callable: ``run(z, ndk, nwk, nk, seed, sweep, n_sweeps=None,
        alpha_v=None, beta_v=None, noise=None) -> (z, ndk, nwk, nk)``, each
        table a dict of this process's positions' tensors.  ``n_sweeps``
        (default ``num_sweeps``) sweeps from sweep index ``sweep``, with
        ``alpha_v`` and ``beta_v`` (default the runtime's α and β); internal
        noise from ``(seed, sweep index)``, external from ``noise(position,
        sweep)``.  ``run.kernel_tier`` names the tier."""
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

    def _local_sweeps(self, seeds: dict, noise: dict, vocab_size=None) -> dict:
        """Each held position's sweep of its token stream (``self._tokens``)
        in ``self.kernel_tier``: the new ``SamplerState`` (XLA and fused
        tiers) or ``(z, ndk, local_nwk)`` (deferred tier, ``local_nwk`` the
        rebuild of the stream's own counts), keyed by position."""
        tier, layout = self.kernel_tier, self._layout
        v_pad = layout["v_pad"] if layout else 0
        snaps = self._snapshots(v_pad) if tier == "deferred" else {}
        out = {}
        # the shards in turn: on one card never on concurrent streams (K1's
        # walk is a cooperative launch over the whole card)
        for p in self.positions:
            state, (tw, td, tm) = self._state(p), self._tokens[p]
            if tier == "deferred":
                z, ndk, local, _, _ = deferred_local_counts(
                    state, tw, td, tm, self.alpha, self.beta,
                    row_tile=self._row_tile, v_pad=v_pad, mirror=snaps[p],
                    noise_mode=self.noise_mode, seed=seeds[p],
                    uniforms=noise.get(p), vocab_size=vocab_size,
                    emit_mirror=False)
                out[p] = (z, ndk, local)
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
