"""The deferred collapsed-Gibbs sweep (PyTorch + the K1/K2 CUDA kernels).

Counterpart of the deferred tier of ``ldagibbssampling_tpu/ops/gibbs.py``
(``deferred_local_counts``, ``_deferred_sweep_impl`` and
``make_sweep_fn(use_pallas="deferred")``).  One sweep:

1. walks the tokens in order, in tiles of ``row_tile``: K1
   (``ops/fused_kernel.gibbs_tiles``) draws each tile against the sweep-stale
   bf16 snapshot of ``nwk`` and the live ``ndk``/``nk``, then moves the
   tile's counts before the next tile draws;
2. rebuilds ``nwk``, ``nk`` and the next snapshot from ``z`` with K2
   (``ops/count_kernel.build_nwk``).

The reference walks blocks, and inside each block its tiles, carrying ``nk``
across blocks and writing each block's doc slab back.  Here ``ndk`` and
``nk`` are updated in place on the device, indexed by document, so the walk
over all tiles in order IS the walk over blocks in order; the block size
still fixes the layout (``plan_deferred``) and the row tile.  The TPU's
single-dispatch ``fori_loop`` over sweeps becomes a Python loop.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.count_kernel import build_nwk, cast_mirror
from ldagibbssampling_tpu_torch.ops.fused_kernel import gibbs_tiles


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_row_tile(block_size: int, num_topics: int = 512) -> int:
    """Largest multiple-of-8 divisor of ``block_size`` within the VMEM budget.

    Mosaic block shapes need sublane-dim % 8 == 0 (unless the block equals the
    whole array — see the single-tile path in ``make_sweep_fn``).  The cap
    keeps ``row_tile x K_pad`` at 512x512 f32 tiles (measured: 1024x512 OOMs
    the ~16 MB scoped VMEM at K=500), scaling down for larger K — e.g. K=1000
    (K_pad 1024) gets 256-row tiles.  Returns 0 when no valid tile exists
    (awkward block sizes like 2·647 — callers fall back to single-tile or the
    XLA sweep).
    """
    k_pad = max(128, _round_up(num_topics, 128))
    cap = max(8, (512 * 512 // k_pad) // 8 * 8)
    t = min(cap, block_size)
    for cand in range(t - t % 8, 7, -8):
        if block_size % cand == 0:
            return cand
    return 0


def _f32(x: float) -> float:
    return float(np.float32(x))


def deferred_local_counts(
    state: SamplerState,
    token_word: torch.Tensor,
    token_doc: torch.Tensor,
    token_mask: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    row_tile: int,
    v_pad: int,
    mirror: Optional[torch.Tensor] = None,
    noise_mode: str = "internal",
    seed: int = 0,
    uniforms: Optional[torch.Tensor] = None,
):
    """Deferred-mode sweep core: returns ``(z, ndk, nwk, nk, mirror_out)``.

    ``state.nwk`` is only read, as the sweep-stale snapshot: ``mirror``
    (``[v_pad, k_pad]`` bf16, the previous sweep's ``mirror_out``) or, when
    ``None``, a fresh bf16 cast of ``state.nwk``.  ``ndk`` comes from K1's
    in-place walk over a copy of ``state.ndk``; ``nwk``, ``nk`` and
    ``mirror_out`` come from K2's rebuild from the new ``z`` (K1's running
    ``nk`` is a sampling normaliser only, as in the reference).
    """
    v, k = state.nwk.shape
    k_pad = _round_up(k, 128)
    if mirror is None:
        mirror = cast_mirror(
            F.pad(state.nwk, (0, k_pad - k, 0, v_pad - v)).contiguous())
    # V·β in float32, as the reference forms it from its f32 β
    vbeta = float(np.float32(v) * np.float32(beta))
    ndk = state.ndk.clone()
    nk = state.nk.clone()
    z = gibbs_tiles(
        mirror, ndk, nk, state.z, token_word, token_doc, token_mask,
        alpha=_f32(alpha), beta=_f32(beta), vbeta=vbeta, row_tile=row_tile,
        noise_mode=noise_mode, seed=seed, uniforms=uniforms,
    )
    nwk, nk_rebuilt, mirror_out = build_nwk(
        z, token_word, token_mask, vocab_size=v, num_topics=k,
        v_pad=v_pad, k_pad=k_pad)
    return z, ndk, nwk, nk_rebuilt, mirror_out


def _deferred_sweep_impl(state: SamplerState, token_word, token_doc,
                         token_mask, alpha, beta, **kw):
    """One deferred sweep; returns ``(state', mirror')``.  Pass ``mirror'``
    back in as ``mirror=`` for the following sweep."""
    z, ndk, nwk, nk_rebuilt, mirror_out = deferred_local_counts(
        state, token_word, token_doc, token_mask, alpha, beta, **kw)
    # topic totals: the rebuild's ride-along counts below 2^24 stream tokens,
    # else the column sum of the table (the reference's f32 bound; both are
    # exact int32 here)
    if token_word.shape[0] < (1 << 24):
        nk_new = nk_rebuilt
    else:
        nk_new = nwk.sum(dim=0, dtype=torch.int32)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk_new,
                        sweep=state.sweep + 1, seed=state.seed), mirror_out


def make_sweep_fn(
    token_word: Any,
    token_doc: Any,
    token_mask: Any,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    num_sweeps: int = 1,
    use_pallas: str = "deferred",
    num_topics: int = 512,
    deferred_plan=None,
    device: Any = "cpu",
    noise_mode: str = "internal",
):
    """Build ``run(state, ...) -> state`` running ``num_sweeps`` deferred
    sweeps on ``device``.

    Only the deferred tier is ported; ``deferred_plan`` (from
    ``ops.count_kernel.plan_deferred``) must be the plan whose arrays are the
    ``token_*`` passed here.  ``noise_mode`` is ``"internal"`` (Philox in the
    kernel, keyed per sweep from the caller's ``torch.Generator``),
    ``"external"`` (caller uniforms per sweep) or ``"deterministic"``.
    """
    if use_pallas != "deferred":
        raise NotImplementedError(
            f"use_pallas={use_pallas!r} is not ported (ROADMAP Queue 1 "
            "items 7-8); the port has the deferred tier only")
    if deferred_plan is None:
        raise ValueError(
            "use_pallas='deferred' needs a deferred_plan "
            "(ops.count_kernel.plan_deferred) whose arrays are the token_* here"
        )
    plan = deferred_plan
    td_host = np.asarray(token_doc, np.int32)
    tm_host = np.asarray(token_mask, np.int32)
    # f32-exactness guards: the kernels score counts as float32
    if plan.max_word_freq >= (1 << 24):
        raise ValueError(
            "deferred sweep scores word-topic cells in float32; "
            f"max word frequency {plan.max_word_freq} >= 2^24 would round"
        )
    max_doc_len = int(np.bincount(td_host, weights=tm_host).max()) if td_host.size else 0
    if max_doc_len >= (1 << 24):
        raise ValueError(
            "fused kernel tracks doc-topic cells in float32; "
            f"max document length {max_doc_len} >= 2^24 would round"
        )
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        if block_size > 2048:
            raise NotImplementedError(
                f"block_size {block_size} has no multiple-of-8 row tile; the "
                "reference falls back to its XLA sweep (ROADMAP Queue 1 item 7)")
        row_tile = block_size  # single tile per block, as the reference

    def dev(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    tw, td, tm = dev(token_word), dev(token_doc), dev(token_mask)
    v_pad = plan.v_pad

    def run_with_mirror(
        state: SamplerState, alpha=alpha, beta=beta,
        mirror: Optional[torch.Tensor] = None, n_sweeps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[Callable[[int], torch.Tensor]] = None,
    ):
        """``n_sweeps`` (default ``num_sweeps``) sweeps carrying the bf16
        snapshot; returns ``(state, mirror)``.

        ``mirror=None`` (cold start) casts it from ``state.nwk``.  Internal
        noise draws each sweep's kernel seed from ``generator``; external
        noise calls ``uniforms(sweep)`` for each sweep's ``[T_pad, k_pad]``
        float32 uniforms."""
        n = num_sweeps if n_sweeps is None else n_sweeps
        if noise_mode == "internal" and generator is None and n > 0:
            raise ValueError("internal noise needs a torch.Generator")
        if noise_mode == "external" and uniforms is None and n > 0:
            raise ValueError("external noise needs uniforms(sweep)")
        for _ in range(n):
            seed = 0
            if noise_mode == "internal":
                seed = int(torch.randint(0, 2**63 - 1, (), generator=generator))
            u = uniforms(state.sweep) if noise_mode == "external" else None
            state, mirror = _deferred_sweep_impl(
                state, tw, td, tm, alpha, beta, row_tile=row_tile,
                v_pad=v_pad, mirror=mirror, noise_mode=noise_mode,
                seed=seed, uniforms=u,
            )
        return state, mirror

    def run_deferred(state: SamplerState, alpha=alpha, beta=beta,
                     n_sweeps=None, generator=None, uniforms=None) -> SamplerState:
        state, _ = run_with_mirror(state, alpha, beta, None, n_sweeps=n_sweeps,
                                   generator=generator, uniforms=uniforms)
        return state

    run_deferred.kernel_tier = "deferred"
    run_deferred.with_mirror = run_with_mirror
    run_deferred.row_tile = row_tile
    return run_deferred
