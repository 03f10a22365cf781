"""The port's collapsed-Gibbs sweeps, in the reference's four kernel tiers.

Counterpart of ``ldagibbssampling_tpu/ops/gibbs.py``.  ``make_sweep_fn``
builds a ``run(state, ...) -> state`` for the tier ``use_pallas`` asks for,
after the reference's layout and exactness rules (``sweep_tier``):

- ``False``, the XLA tier (``gibbs_sweep``): per block of ``block_size``
  tokens, PyTorch ops gather the block's count rows, draw (``gumbel``: argmax
  of the log conditional plus Gumbel noise; ``inverse_cdf``: the reference's
  prefix-sum inversion, bitwise the serial oracle's chain at block 1 with
  float64 and the oracle's uniforms) and scatter the block's moves.  It is
  one chain of ``gibbs_sweep_chains``, which advances several chains'
  stacked tables in lockstep, each op once per block for all of them (the
  reference's ``vmap`` over chains, ``models/chains.py``);
- ``True``, the v1-draw tier: the same blocks, with the gumbel draw in K3
  (``ops/sample_kernel.sample_block``, one launch per block) and the moves of
  ``ndk``, ``nwk`` and ``nk`` in one count-move launch
  (``ops/fused_kernel.count_move``), which also writes the block's new
  ``z`` (two launches per block).  ``inverse_cdf`` runs the XLA draw
  there (kernel tier ``"xla"``; the reference still names it
  ``"pallas-draw"``);
- ``"fused"`` (``fused_gibbs_sweep``): per block, K1
  (``ops/fused_kernel.gibbs_tiles``) walks the block's tiles in order against
  the block-start word-topic table, moving ``ndk`` and ``nk`` after each
  tile; then one count-move launch applies the block's word-topic moves
  and writes the block's new ``z``;
- ``"deferred"`` (``deferred_local_counts``): K1 walks every tile against the
  sweep-stale snapshot of ``nwk`` (``mirror_dtype`` bf16 or float32) in the
  chain ``compute_dtype``, and K2 (``ops/count_kernel``) rebuilds ``nwk``,
  ``nk`` and, for the bf16 snapshot, the next snapshot from ``z``; the
  float32 snapshot is a PyTorch cast of the rebuilt padded table, as the
  reference's is an XLA one (its ``ops/gibbs.py:491-501``).

Counts live as int32 on the caller's device and are updated in place on a
copy of the input state (the input state is not modified).  The reference
walks blocks, and inside each block its tiles, carrying ``nk`` across blocks
and writing each block's doc slab back; here ``ndk`` is indexed by document,
so the walk over tiles in order IS the walk over blocks in order.

The reference's single-dispatch ``fori_loop`` over sweeps: in every tier
``run`` (the deferred tier's ``run.with_mirror`` too) replays one captured
CUDA graph per sweep (``xla_sweep_graph``, ``draw_sweep_graph``,
``fused_sweep_graph``, ``deferred_sweep_graph``; ``ops/graphs.SweepGraph``,
α, β and the seeds as device values, one graph per table shapes in
``run.graphs``); on the CPU the same sweep body runs eagerly.  Each tier
has one sweep body, in place on its tables (``_xla_sweep_``,
``_draw_sweep_``, ``_fused_sweep_``, ``_deferred_sweep_``); the eager
sweeps ``gibbs_sweep_chains``, ``gibbs_sweep``, ``fused_gibbs_sweep`` and
``deferred_local_counts`` (``_deferred_sweep_impl``), which the tests (and
the mesh runtimes' eager reference) run, clone the state and run that
body.  The mesh runtimes (``parallel/runtime.py``) run the bodies
``_xla_sweep_``, ``_fused_sweep_`` and ``_deferred_walk_``.

Noise modes: ``internal`` (each sweep draws one seed from the caller's
``torch.Generator``: the kernels key Philox4x32-10 with it, the XLA draws
seed a ``torch.Generator`` on the tensors' device with it), ``external``
(the caller's ``noise(sweep)`` gives the sweep's array: uniforms for the
kernels and ``inverse_cdf``, Gumbel values for the XLA gumbel draw) and
``deterministic`` (argmax of the conditional; not for ``inverse_cdf``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ldagibbssampling_tpu_torch.evaluation.tracing import span
from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops._device import (
    device_values, seed_word, sweep_scalars)
from ldagibbssampling_tpu_torch.ops.count_kernel import cast_mirror, rebuild_counts
from ldagibbssampling_tpu_torch.ops.fused_kernel import (
    CHAINS, NOISE_MODES, count_move, gibbs_tiles)
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph
from ldagibbssampling_tpu_torch.ops.sample_kernel import sample_block

_log = logging.getLogger("ldagibbssampling_tpu_torch")
TIERS = (False, True, "fused", "deferred")


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


def _sweep_values(alpha: float, beta: float, vocab_size: int,
                  num_topics: int, seed: int, device) -> tuple:
    """An eager sweep's device values for K1 and K3: α, β, V·β and K·α
    (``_device.sweep_scalars``) and the seed's word (``key``)."""
    return (device_values(sweep_scalars(alpha, beta, vocab_size, num_topics),
                          device),
            device_values(np.array([seed_word(seed)], np.int64), device))


def snapshot(nwk: torch.Tensor, v_pad: int, k_pad: int,
             mirror_dtype: str) -> torch.Tensor:
    """The deferred tier's ``[v_pad, k_pad]`` snapshot of the int32 ``nwk``:
    bf16 through K2's ``cast_mirror``, or a float32 copy (exact counts)."""
    v, k = nwk.shape
    padded = F.pad(nwk, (0, k_pad - k, 0, v_pad - v))
    if mirror_dtype == "bfloat16":
        return cast_mirror(padded.contiguous())
    if mirror_dtype == "float32":
        return padded.float()
    raise ValueError(f"unknown mirror_dtype {mirror_dtype!r}")


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
    compute_dtype: str = "float32",
    mirror_dtype: str = "bfloat16",
):
    """One deferred sweep, run eagerly: returns ``(z, ndk, nwk, nk,
    mirror_out)``; ``deferred_sweep_graph`` replays the same sweep as a
    CUDA graph.

    ``_deferred_sweep_`` runs on clones of the state, ``nwk`` and ``nk`` in
    K2's padded ``[v_pad, k_pad]`` and ``[k_pad]`` tables, and on a clone of
    ``mirror`` (``[v_pad, k_pad]`` in ``mirror_dtype``, the previous sweep's
    ``mirror_out``) or, when ``None``, a fresh ``snapshot`` of
    ``state.nwk``; neither the state nor ``mirror`` is modified.  ``nwk``
    and ``nk`` are the padded tables' corners, as the graph hands them out;
    ``mirror_out`` is the next sweep's snapshot.
    """
    v, k = state.nwk.shape
    k_pad = _round_up(k, 128)
    mirror = (snapshot(state.nwk, v_pad, k_pad, mirror_dtype) if mirror is None
              else mirror.clone())
    # α, β and V·β in float32, as the reference forms them from its f32 β
    scalars, key = _sweep_values(alpha, beta, v, k, seed, state.z.device)
    z, ndk = state.z.clone(), state.ndk.clone()
    nwk = F.pad(state.nwk, (0, k_pad - k, 0, v_pad - v))
    nk = F.pad(state.nk, (0, k_pad - k))
    _deferred_sweep_(z, ndk, nwk, nk, mirror, token_word, token_doc, token_mask,
                     scalars=scalars, key=key, row_tile=row_tile,
                     noise_mode=noise_mode, noise=uniforms,
                     compute_dtype=compute_dtype, mirror_dtype=mirror_dtype)
    return z, ndk, nwk[:v, :k], nk[:k], mirror


def _deferred_sweep_impl(state: SamplerState, token_word, token_doc,
                         token_mask, alpha, beta, **kw):
    """One deferred sweep; returns ``(state', mirror')``.  Pass ``mirror'``
    back in as ``mirror=`` for the following sweep."""
    z, ndk, nwk, nk, mirror = deferred_local_counts(
        state, token_word, token_doc, token_mask, alpha, beta, **kw)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=state.sweep + 1,
                        seed=state.seed), mirror


def _deferred_walk_(z, ndk, nk, mirror, token_word, token_doc, token_mask, *,
                    out: tuple[torch.Tensor, torch.Tensor], scalars: torch.Tensor,
                    key: Optional[torch.Tensor], row_tile: int, noise_mode: str,
                    noise: Optional[torch.Tensor], compute_dtype: str) -> None:
    """A token stream's deferred sweep in place, without the snapshot:
    K1's walk against ``mirror`` (α, β, V·β from ``scalars`` and the seed
    from ``key``, device values) moves ``ndk [M, K]`` and ``nk [K]`` (its
    running normaliser) in place and writes the new ``z``; then K2 rebuilds
    the stream's own counts from ``z`` into ``out``, K2's padded ``(nwk
    [v_pad, k_pad], nk [k_pad])``.  The body of ``_deferred_sweep_`` and of
    the mesh runtimes' deferred sweep (``parallel/runtime.py``), which adds
    the streams' tables up itself."""
    z_new = gibbs_tiles(mirror, ndk, nk, z, token_word, token_doc, token_mask,
                        scalars=scalars, key=key, row_tile=row_tile,
                        noise_mode=noise_mode, uniforms=noise,
                        compute_dtype=compute_dtype)
    z.copy_(z_new)
    v_pad, k_pad = out[0].shape
    rebuild_counts(z, token_word, token_mask, v_pad=v_pad, k_pad=k_pad, out=out)


def _deferred_sweep_(z, ndk, nwk, nk, mirror, token_word, token_doc,
                     token_mask, *, scalars: torch.Tensor,
                     key: Optional[torch.Tensor], row_tile: int,
                     noise_mode: str, noise: Optional[torch.Tensor],
                     compute_dtype: str, mirror_dtype: str) -> None:
    """One deferred sweep in place: the body of ``deferred_sweep_graph`` and
    of ``deferred_local_counts``.  ``nwk [v_pad, k_pad]`` and ``nk [k_pad]``
    are K2's padded tables (the state's ``nwk`` and ``nk`` are their
    ``[:V, :K]`` and ``[:K]`` corners); ``mirror`` is the snapshot that K1's
    walk reads and that the sweep then overwrites with the next one.  K1
    moves ``ndk`` in place and ``nk[:K]`` as its running normaliser (as in
    the reference); K2 rebuilds ``nwk`` and ``nk`` from the new ``z``, its
    ``nk`` the table's exact column sum at any token count."""
    _deferred_walk_(z, ndk, nk[:ndk.shape[1]], mirror, token_word, token_doc,
                    token_mask, out=(nwk, nk), scalars=scalars, key=key,
                    row_tile=row_tile, noise_mode=noise_mode, noise=noise,
                    compute_dtype=compute_dtype)
    if mirror_dtype == "bfloat16":
        cast_mirror(nwk, out=mirror)
    else:
        mirror.copy_(nwk)  # the float32 snapshot: the cast of nwk.float()


def _clone(state: SamplerState):
    return (state.z.clone(), state.ndk.clone(), state.nwk.clone(),
            state.nk.clone())


def _scatter_counts(ndk, nwk, nk, dk, wk, one, zold, znew) -> None:
    """The XLA tier's per-block scatter-adds (reference ops/gibbs.py:233-238)
    for ``C`` chains at once: -1 at ``zold``, +1 at ``znew`` for the real
    tokens.  ``ndk [C, M, K]``, ``nwk [C, V, K]`` and ``nk [C, K]`` are
    moved in place; ``dk`` and ``wk`` are the block's row offsets ``d·K``
    and ``w·K`` (int64 ``[B]``, shared by the chains), ``one`` is 1 for a
    real token and 0 for a masked one (int32 ``[B]``), ``zold`` and
    ``znew`` are ``[C, B]``.  One ``scatter_add_`` per table and sign into
    each chain's flat row of its table: integer sums are exact in any
    order, so the atomic adds on CUDA give the same tables every time, with
    no sort of the indices.  A masked token adds 0 rather than being indexed
    out, so the scatter needs no host sync (a boolean index waits for the
    device)."""
    zo, zn = zold.long(), znew.long()
    minus, plus = (-one).expand_as(zo), one.expand_as(zo)
    for table, rows in ((ndk, dk), (nwk, wk), (nk, None)):
        flat = table.view(table.shape[0], -1)
        flat.scatter_add_(1, zo if rows is None else rows + zo, minus)
        flat.scatter_add_(1, zn if rows is None else rows + zn, plus)


def _check_sweep_args(draw_method: str, noise_mode: str, noise, t_pad: int,
                      block_size: int) -> None:
    if draw_method not in ("gumbel", "inverse_cdf"):
        raise ValueError(f"unknown draw_method {draw_method!r}")
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if draw_method == "inverse_cdf" and noise_mode == "deterministic":
        raise ValueError("inverse_cdf draws need uniforms: no deterministic mode")
    if noise_mode == "external" and noise is None:
        raise ValueError("noise_mode='external' needs the sweep's noise")
    if t_pad % block_size != 0:
        raise ValueError(
            f"padded token count {t_pad} not a multiple of block_size {block_size}")


def sweep_seed(generator: torch.Generator) -> int:
    """The next sweep's seed from a chain's host ``torch.Generator``
    (``internal`` noise)."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


def _xla_sweep_(
    z: torch.Tensor,
    ndk: torch.Tensor,
    nwk: torch.Tensor,
    nk: torch.Tensor,
    token_word: torch.Tensor,
    token_doc: torch.Tensor,
    token_mask: torch.Tensor,
    doc_lengths: Optional[torch.Tensor],
    *,
    scalars: torch.Tensor,
    block_size: int,
    draw_method: str,
    prob_dtype: torch.dtype,
    noise_mode: str,
    generators: Sequence[torch.Generator],
    noise: Optional[torch.Tensor],
) -> None:
    """One XLA-tier sweep of ``C`` stacked chains, in place on ``z``,
    ``ndk``, ``nwk`` and ``nk``: the body of ``gibbs_sweep_chains`` and of
    its CUDA graph (``xla_sweep_graph``).  ``scalars`` is float32 α, β, V·β
    and K·α (``_device.sweep_scalars``): a host tensor (read as scalars, no
    host sync) or one on the tables' device (a graph replays with the values
    it holds then; an add of a 0-d device tensor gives the bits of the add
    of the host scalar, and the sweep divides by no scalar).  Internal
    noise draws from ``generators[c]`` for chain ``c``."""
    num_chains, v_rows, k = nwk.shape
    t_pad = token_word.shape[0]
    dev = z.device
    alpha_c, beta_c, vbeta_c, kalpha_c = scalars.to(prob_dtype).unbind()
    if draw_method == "inverse_cdf":
        dl = doc_lengths.to(device=dev, dtype=prob_dtype)
    topics = torch.arange(k, device=dev)
    chain = torch.arange(num_chains, device=dev)[:, None]
    # per-sweep forms of the shared token arrays, sliced per block: each
    # chain's rows of its tokens in the flattened tables ([C, T_pad]) and
    # the tokens' offsets of a row within one chain's table ([T_pad])
    real = token_mask > 0
    one = real.to(torch.int32)
    tw, td = token_word.long(), token_doc.long()
    w_rows, d_rows = tw + chain * v_rows, td + chain * ndk.shape[1]
    wk, dk = tw * k, td * k
    nwk_rows, ndk_rows = nwk.view(-1, k), ndk.view(-1, k)

    def draws(shape):
        # one draw per chain from its own generator, stacked
        us = [torch.rand(shape, generator=g, dtype=prob_dtype, device=dev)
              for g in generators]
        return us[0][None] if num_chains == 1 else torch.stack(us)

    for s in range(0, t_pad, block_size):
        sl = slice(s, s + block_size)
        zold = z[:, sl]
        # self-exclusion of the unmasked tokens (decrement step)
        old = ((topics == zold[..., None]) & real[sl, None]).to(nwk.dtype)
        nwk_ex = (nwk_rows[w_rows[:, sl]] - old).to(prob_dtype)
        ndk_ex = (ndk_rows[d_rows[:, sl]] - old).to(prob_dtype)
        nk_ex = (nk[:, None, :] - old).to(prob_dtype)
        if draw_method == "gumbel":
            score = (torch.log(nwk_ex + beta_c) + torch.log(ndk_ex + alpha_c)
                     - torch.log(nk_ex + vbeta_c))
            if noise_mode == "external":
                score = score + noise[:, sl].to(prob_dtype)
            elif noise_mode == "internal":
                u = draws(score.shape[1:]).clamp_(min=torch.finfo(prob_dtype).tiny)
                score = score + (-torch.log(-torch.log(u)))
            znew = score.argmax(dim=-1).to(torch.int32)
        else:
            # the reference's op order: ((nwk+β)/(nk+Vβ) · (ndk+α)) / (N_m-1+Kα)
            den = (dl[td[sl]] - 1.0 + kalpha_c)[:, None]
            p = (nwk_ex + beta_c) / (nk_ex + vbeta_c) * (ndk_ex + alpha_c) / den
            c = torch.cumsum(p.view(-1, k), dim=1).view(p.shape)
            if noise_mode == "external":
                u = noise[:, sl].to(prob_dtype)
            else:
                u = draws((block_size,))
            # first k with u < c[k]  ==  number of k with c[k] <= u
            znew = (c <= (u * c[..., -1])[..., None]).sum(dim=-1)
            znew = znew.clamp(max=k - 1).to(torch.int32)
        znew = torch.where(real[sl], znew, zold)
        _scatter_counts(ndk, nwk, nk, dk[sl], wk[sl], one[sl], zold, znew)
        z[:, sl] = znew


def gibbs_sweep_chains(
    z: torch.Tensor,
    ndk: torch.Tensor,
    nwk: torch.Tensor,
    nk: torch.Tensor,
    token_word: torch.Tensor,
    token_doc: torch.Tensor,
    token_mask: torch.Tensor,
    doc_lengths: Optional[torch.Tensor] = None,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    draw_method: str = "gumbel",
    prob_dtype: torch.dtype = torch.float32,
    vocab_size: Optional[int] = None,
    noise_mode: str = "internal",
    seeds: Sequence[int] = (),
    noise: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One XLA-tier sweep of ``C`` chains in lockstep, the counterpart of
    the reference's ``jax.vmap(gibbs_sweep)`` (``models/chains.py:71-88``),
    run eagerly; returns the new ``(z, ndk, nwk, nk)`` (the inputs are not
    modified).  ``xla_sweep_graph`` replays the same sweep as a CUDA graph.

    ``z [C, T_pad]``, ``ndk [C, M, K]``, ``nwk [C, V, K]`` and ``nk [C, K]``
    are the chains' stacked tables; the token arrays (``[T_pad]``, padded
    to a multiple of ``block_size``) and ``doc_lengths`` (``[M]``, for
    ``inverse_cdf``) are shared, never repeated per chain.  Per block each
    op runs once for every chain: the gathers index ``[C, B]`` rows, the
    draw scores ``[C, B, K]``, the scatter adds into each chain's flat
    table.  Chain ``c`` is bitwise the single-chain sweep of chain ``c``
    (``gibbs_sweep`` is the ``C = 1`` case): the scalars are formed as
    there, every op is elementwise or works row by row (``inverse_cdf``'s
    prefix sum runs over a ``[C·B, K]`` view, each row as in the ``[B, K]``
    case), and the noise is per chain.  ``internal`` noise: chain ``c``'s
    sweep seed is ``seeds[c]``, which seeds its own generator on the
    tensors' device; each block draws its ``torch.rand`` per chain, in the
    single-chain order, and the draws are stacked.  ``external`` noise is
    the chains' stacked arrays: ``[C, T_pad, K]`` Gumbel values (gumbel)
    or ``[C, T_pad]`` uniforms (``inverse_cdf``).  ``vocab_size``
    overrides the V of ``V·β``.
    """
    t_pad = token_word.shape[0]
    _check_sweep_args(draw_method, noise_mode, noise, t_pad, block_size)
    num_chains, v_rows, k = nwk.shape
    _check_stacked(z, ndk, nwk, nk, t_pad)
    dev = z.device
    v = v_rows if vocab_size is None else int(vocab_size)
    gens = []
    if noise_mode == "internal":
        if len(seeds) != num_chains:
            raise ValueError(f"{len(seeds)} sweep seeds for {num_chains} chains")
        gens = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
    if draw_method == "inverse_cdf" and doc_lengths is None:
        raise ValueError("inverse_cdf needs doc_lengths")
    z, ndk, nwk, nk = z.clone(), ndk.clone(), nwk.clone(), nk.clone()
    _xla_sweep_(z, ndk, nwk, nk, token_word, token_doc, token_mask, doc_lengths,
                scalars=torch.from_numpy(sweep_scalars(alpha, beta, v, k)),
                block_size=block_size, draw_method=draw_method,
                prob_dtype=prob_dtype, noise_mode=noise_mode, generators=gens,
                noise=noise)
    return z, ndk, nwk, nk


def _check_stacked(z, ndk, nwk, nk, t_pad: int) -> None:
    num_chains, _, k = nwk.shape
    if z.shape != (num_chains, t_pad) or nk.shape != (num_chains, k) or (
            ndk.shape[0], ndk.shape[2]) != (num_chains, k):
        raise ValueError(
            f"stacked tables z {tuple(z.shape)}, ndk {tuple(ndk.shape)}, nwk "
            f"{tuple(nwk.shape)}, nk {tuple(nk.shape)} do not share [C, ..., K] "
            f"with {t_pad} tokens")


def _draw_sweep_(z, ndk, nwk, nk, token_word, token_doc, token_mask, *,
                 scalars: torch.Tensor, key: Optional[torch.Tensor],
                 block_size: int, noise_mode: str,
                 noise: Optional[torch.Tensor]) -> None:
    """One v1-draw sweep in place: per block K3 draws against the
    block-start counts (``scalars``: α, β, V·β on the tables' device;
    ``key``: the internal seed there), then one count-move launch moves the
    three tables and writes the block's ``z``."""
    for s in range(0, token_word.shape[0], block_size):
        sl = slice(s, s + block_size)
        w, d, msk, zold = token_word[sl], token_doc[sl], token_mask[sl], z[sl]
        znew = sample_block(
            nwk, ndk, nk, zold, w, d, scalars=scalars, noise_mode=noise_mode,
            key=key, uniforms=noise[sl] if noise_mode == "external" else None,
            slot0=s)
        # one launch moves the three tables and writes z[sl] (zold's
        # memory): mask ? znew : zold
        count_move(zold, znew, msk, nwk=nwk, token_word=w, ndk=ndk,
                   token_doc=d, nk=nk, z_out=zold)


def gibbs_sweep(
    state: SamplerState,
    token_word: torch.Tensor,
    token_doc: torch.Tensor,
    token_mask: torch.Tensor,
    doc_lengths: Optional[torch.Tensor] = None,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    draw_method: str = "gumbel",
    prob_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    vocab_size: Optional[int] = None,
    noise_mode: str = "internal",
    seed: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> SamplerState:
    """One sweep of the XLA tier (``use_pallas=False``: ``gibbs_sweep_chains``
    with one chain) or the v1-draw tier (``use_pallas=True``: K3 draws the
    gumbel blocks), run eagerly; returns the new state.

    ``token_*`` are padded to a multiple of ``block_size``; ``doc_lengths``
    (``[M]``) is needed by ``inverse_cdf``.  External ``noise`` is the
    sweep's array: ``[T_pad, K]`` Gumbel values (XLA gumbel), ``[T_pad, K]``
    uniforms (K3) or ``[T_pad]`` uniforms (``inverse_cdf``, the reference's
    ``uniforms=``).  ``vocab_size`` overrides the V of ``V·β``.  Scalars are
    formed as the reference forms them: α and β rounded to float32, ``V·β``
    and ``K·α`` float32 products, all then cast to ``prob_dtype``.
    """
    if not (use_pallas and draw_method == "gumbel"):
        z, ndk, nwk, nk = gibbs_sweep_chains(
            state.z[None], state.ndk[None], state.nwk[None], state.nk[None],
            token_word, token_doc, token_mask, doc_lengths, alpha=alpha,
            beta=beta, block_size=block_size, draw_method=draw_method,
            prob_dtype=prob_dtype, vocab_size=vocab_size, noise_mode=noise_mode,
            seeds=(seed,), noise=None if noise is None else noise[None])
        return SamplerState(z=z[0], ndk=ndk[0], nwk=nwk[0], nk=nk[0],
                            sweep=state.sweep + 1, seed=state.seed)
    t_pad = token_word.shape[0]
    _check_sweep_args(draw_method, noise_mode, noise, t_pad, block_size)
    v, k = state.nwk.shape
    v = v if vocab_size is None else int(vocab_size)
    scalars, key = _sweep_values(alpha, beta, v, k, seed, state.z.device)
    z, ndk, nwk, nk = _clone(state)
    _draw_sweep_(z, ndk, nwk, nk, token_word, token_doc, token_mask,
                 scalars=scalars, key=key, block_size=block_size,
                 noise_mode=noise_mode, noise=noise)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=state.sweep + 1,
                        seed=state.seed)


def xla_sweep_graph(tables: Sequence[torch.Tensor], token_word: torch.Tensor,
                    token_doc: torch.Tensor, token_mask: torch.Tensor,
                    doc_lengths: Optional[torch.Tensor] = None, *,
                    block_size: int, draw_method: str = "gumbel",
                    noise_mode: str = "internal",
                    vocab_size: Optional[int] = None) -> SweepGraph:
    """``gibbs_sweep_chains`` (float32) as a :class:`graphs.SweepGraph` over
    stacked tables shaped like ``tables`` (``z, ndk, nwk, nk``, each with a
    leading chain axis): one generator per chain, reseeded with its sweep
    seed before each replay; external noise stacked per chain."""
    z, ndk, nwk, nk = tables
    t_pad = token_word.shape[0]
    _check_sweep_args(draw_method, noise_mode, 0, t_pad, block_size)
    _check_stacked(z, ndk, nwk, nk, t_pad)
    if draw_method == "inverse_cdf" and doc_lengths is None:
        raise ValueError("inverse_cdf needs doc_lengths")
    num_chains, v_rows, k = nwk.shape

    def body(bufs, scalars, key, generators, noise):
        _xla_sweep_(*bufs, token_word, token_doc, token_mask, doc_lengths,
                    scalars=scalars, block_size=block_size,
                    draw_method=draw_method, prob_dtype=torch.float32,
                    noise_mode=noise_mode, generators=generators, noise=noise)

    return SweepGraph(body, tables, noise_mode=noise_mode,
                      vocab_size=v_rows if vocab_size is None else int(vocab_size),
                      num_topics=k, num_generators=num_chains)


def draw_sweep_graph(tables: Sequence[torch.Tensor], token_word: torch.Tensor,
                     token_doc: torch.Tensor, token_mask: torch.Tensor, *,
                     block_size: int, noise_mode: str = "internal",
                     vocab_size: Optional[int] = None) -> SweepGraph:
    """The v1-draw sweep (K3 and the count move per block) as a
    :class:`graphs.SweepGraph` over one chain's ``z, ndk, nwk, nk``; K3
    reads α, β, V·β and the sweep's seed from the graph's ``params``."""
    _check_sweep_args("gumbel", noise_mode, 0, token_word.shape[0], block_size)
    v_rows, k = tables[2].shape

    def body(bufs, scalars, key, generators, noise):
        _draw_sweep_(*bufs, token_word, token_doc, token_mask, scalars=scalars,
                     key=key, block_size=block_size, noise_mode=noise_mode,
                     noise=noise)

    return SweepGraph(body, tables, noise_mode=noise_mode,
                      vocab_size=v_rows if vocab_size is None else int(vocab_size),
                      num_topics=k, device_seeds=True)


def _check_fused(t_pad: int, block_size: int, row_tile: int) -> None:
    if t_pad % block_size or block_size % row_tile:
        raise ValueError(
            f"token count {t_pad} / block {block_size} / row_tile {row_tile} misaligned")


def _fused_sweep_(z, ndk, nwk, nk, token_word, token_doc, token_mask, *,
                  scalars: torch.Tensor, key: Optional[torch.Tensor],
                  block_size: int, row_tile: int, noise_mode: str,
                  noise: Optional[torch.Tensor]) -> None:
    """One fused sweep in place: per block, K1 walks the block's tiles
    against the block-start ``nwk`` (``scalars``: α, β, V·β on the tables'
    device; ``key``: the internal seed there), then one count-move launch
    moves ``nwk`` and writes the block's ``z``."""
    for s in range(0, token_word.shape[0], block_size):
        sl = slice(s, s + block_size)
        w, d, msk, zold = token_word[sl], token_doc[sl], token_mask[sl], z[sl]
        znew = gibbs_tiles(
            nwk, ndk, nk, zold, w, d, msk, scalars=scalars, key=key,
            row_tile=row_tile, noise_mode=noise_mode,
            uniforms=None if noise is None else noise[sl], slot0=s)
        # the walk keeps masked tokens' z, so z_out = znew: written into
        # z[sl] (zold's memory) by the move's launch
        count_move(zold, znew, msk, nwk=nwk, token_word=w, z_out=zold)


def fused_gibbs_sweep(
    state: SamplerState,
    token_word: torch.Tensor,
    token_doc: torch.Tensor,
    token_mask: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    block_size: int,
    row_tile: int,
    noise_mode: str = "internal",
    seed: int = 0,
    uniforms: Optional[torch.Tensor] = None,
    vocab_size: Optional[int] = None,
) -> SamplerState:
    """One sweep of the fused tier, run eagerly; returns the new state.
    ``fused_sweep_graph`` replays the same sweep as a CUDA graph.

    Per block, K1 walks the block's tiles in order against the block-start
    ``nwk`` (the live int32 table, only read), moving ``ndk`` and ``nk``
    after each tile; then one count-move launch applies the block's
    word-topic moves, as the reference's ``nwk.at[w].add(delta)`` does.
    ``nk`` carries across blocks.  External ``uniforms`` are the sweep's
    ``[T_pad, k_pad]`` array (the reference's ``uniform(sweep_key, ...)``).
    ``vocab_size`` overrides the V of ``V·β``.
    """
    _check_fused(token_word.shape[0], block_size, row_tile)
    v, k = state.nwk.shape
    v = v if vocab_size is None else int(vocab_size)
    scalars, key = _sweep_values(alpha, beta, v, k, seed, state.z.device)
    z, ndk, nwk, nk = _clone(state)
    _fused_sweep_(z, ndk, nwk, nk, token_word, token_doc, token_mask,
                  scalars=scalars, key=key, block_size=block_size,
                  row_tile=row_tile, noise_mode=noise_mode, noise=uniforms)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=state.sweep + 1,
                        seed=state.seed)


def fused_sweep_graph(tables: Sequence[torch.Tensor], token_word: torch.Tensor,
                      token_doc: torch.Tensor, token_mask: torch.Tensor, *,
                      block_size: int, row_tile: int,
                      noise_mode: str = "internal") -> SweepGraph:
    """The fused sweep (per block K1's walk and the count move) as a
    :class:`graphs.SweepGraph` over one chain's ``z, ndk, nwk, nk``; K1 reads
    α, β, V·β and the sweep's seed from the graph's ``params``."""
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    _check_fused(token_word.shape[0], block_size, row_tile)
    v_rows, k = tables[2].shape

    def body(bufs, scalars, key, generators, noise):
        _fused_sweep_(*bufs, token_word, token_doc, token_mask, scalars=scalars,
                      key=key, block_size=block_size, row_tile=row_tile,
                      noise_mode=noise_mode, noise=noise)

    return SweepGraph(body, tables, noise_mode=noise_mode, vocab_size=v_rows,
                      num_topics=k, device_seeds=True)


def deferred_sweep_graph(tables: Sequence[torch.Tensor],
                         token_word: torch.Tensor, token_doc: torch.Tensor,
                         token_mask: torch.Tensor, *, row_tile: int,
                         noise_mode: str = "internal",
                         compute_dtype: str = "float32",
                         mirror_dtype: str = "bfloat16") -> SweepGraph:
    """The deferred sweep (K1's walk against the snapshot, K2's rebuild and
    the next snapshot) as a :class:`graphs.SweepGraph` over one chain's
    ``z, ndk, nwk [V, K], nk [K]`` and the snapshot ``[v_pad, k_pad]`` in
    ``mirror_dtype``: the graph keeps ``nwk`` and ``nk`` in K2's padded
    tables and hands out their corners, as ``deferred_local_counts`` does;
    K1 reads α, β, V·β and the sweep's seed from the graph's ``params``."""
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    v_rows, k = tables[2].shape
    mirror = tables[4]
    if mirror.dtype != getattr(torch, mirror_dtype):
        raise ValueError(f"a {mirror.dtype} snapshot for mirror_dtype {mirror_dtype!r}")

    def body(bufs, scalars, key, generators, noise):
        _deferred_sweep_(*bufs, token_word, token_doc, token_mask,
                         scalars=scalars, key=key, row_tile=row_tile,
                         noise_mode=noise_mode, noise=noise,
                         compute_dtype=compute_dtype, mirror_dtype=mirror_dtype)

    v_pad, k_pad = mirror.shape
    return SweepGraph(body, tables, noise_mode=noise_mode, vocab_size=v_rows,
                      num_topics=k, device_seeds=True,
                      padded=(None, None, (v_pad, k_pad), (k_pad,), None))


def tier_name(use_pallas, draw_method: str = "gumbel") -> str:
    """The ``kernel_tier`` of a resolved ``use_pallas``, as the reference
    names it, except that ``use_pallas=True`` with ``inverse_cdf`` runs the
    XLA draw and is named ``"xla"``."""
    if use_pallas in ("fused", "deferred"):
        return use_pallas
    return "pallas-draw" if use_pallas and draw_method == "gumbel" else "xla"


def sweep_tier(use_pallas, *, draw_method: str, block_size: int,
               num_real_tokens: int, num_topics: int):
    """The reference ``make_sweep_fn``'s tier rules, without its platform
    rule (on the card every tier runs its CUDA kernels or raises).

    Returns ``(use_pallas, row_tile, reason)``: the tier that runs, the row
    tile of K1's walk (0 outside the fused and deferred tiers) and why the
    tier differs from the one asked for (``None`` when it does not):

    - fused and deferred blocks below 128 tokens run the XLA tier;
    - the fused tier with 2^24 real tokens or more runs the XLA tier (its
      float32 running totals would round);
    - a fused or deferred block without a multiple-of-8 row tile runs as one
      tile up to 2,048 tokens, and as the XLA tier above.
    """
    if use_pallas not in TIERS:
        raise ValueError(f"unknown kernel tier use_pallas={use_pallas!r}")
    if use_pallas not in ("fused", "deferred"):
        return use_pallas, 0, None
    if block_size < 128:
        return False, 0, f"block_size {block_size} < 128"
    if draw_method != "gumbel":
        raise ValueError(f"the {use_pallas} tier requires draw_method='gumbel'")
    if use_pallas == "fused" and num_real_tokens >= (1 << 24):
        return False, 0, (
            f"{num_real_tokens} tokens >= 2^24 would round the fused tier's "
            "float32 running totals; use use_pallas='deferred'")
    row_tile = _pick_row_tile(block_size, num_topics)
    if row_tile == 0:
        if block_size > 2048:
            return False, 0, f"no multiple-of-8 row tile for block_size {block_size}"
        row_tile = block_size  # one tile per block, as the reference
    return use_pallas, row_tile, None


def make_sweep_fn(
    token_word: Any,
    token_doc: Any,
    token_mask: Any,
    doc_lengths: Any = None,
    *,
    alpha: float,
    beta: float,
    block_size: int,
    draw_method: str = "gumbel",
    num_sweeps: int = 1,
    use_pallas: Any = "deferred",
    num_topics: int = 512,
    deferred_plan=None,
    device: Any = "cuda",
    noise_mode: str = "internal",
    kernel_compute_dtype: str = "float32",
    mirror_dtype: str = "bfloat16",
):
    """Build ``run(state, ...) -> state`` running ``num_sweeps`` sweeps of
    the tier ``use_pallas`` (``False``, ``True``, ``"fused"`` or
    ``"deferred"``, resolved by ``sweep_tier``) on ``device``.
    ``kernel_compute_dtype`` (K1's chain) and ``mirror_dtype`` (the
    snapshot's type) shape the deferred tier only, as in the reference.

    ``doc_lengths`` is needed by ``inverse_cdf``; ``deferred_plan`` (from
    ``ops.count_kernel.plan_deferred``) by the deferred tier, whose
    ``token_*`` must be the plan's arrays.  ``run.kernel_tier`` names the
    tier that runs.  ``run(state, alpha, beta, n_sweeps=None,
    generator=None, noise=None)``: internal noise draws each sweep's seed from
    ``generator``; external noise calls ``noise(sweep)`` for each sweep's
    array (see the module docstring).  A call replays one CUDA graph per
    sweep (``run.graphs``, one :class:`graphs.SweepGraph` per table shapes;
    the first call on the card also runs one warm-up sweep, which takes no
    seed from ``generator`` and changes no state).  The deferred tier's
    ``run.with_mirror(state, alpha, beta, mirror, ...)`` carries its
    snapshot across calls.
    """
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if kernel_compute_dtype not in CHAINS:
        raise ValueError(f"unknown kernel_compute_dtype {kernel_compute_dtype!r}")
    if mirror_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown mirror_dtype {mirror_dtype!r}")
    td_host = np.asarray(token_doc, np.int32)
    tm_host = np.asarray(token_mask, np.int32)
    tier, row_tile, reason = sweep_tier(
        use_pallas, draw_method=draw_method, block_size=block_size,
        num_real_tokens=int(tm_host.sum()), num_topics=num_topics)
    if reason is not None:
        _log.warning("kernel tier: requested %r -> running %r (%s)",
                     use_pallas, tier, reason)
    if tier in ("fused", "deferred"):
        max_doc_len = (int(np.bincount(td_host, weights=tm_host).max())
                       if td_host.size else 0)
        if max_doc_len >= (1 << 24):
            raise ValueError(
                "fused kernel tracks doc-topic cells in float32; "
                f"max document length {max_doc_len} >= 2^24 would round")

    def dev(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    tw, td, tm = dev(token_word), dev(token_doc), dev(tm_host)
    graphs: dict = {}  # one SweepGraph per table shapes

    def replay(make_graph, tables, sweep0: int, alpha, beta, n: int,
               generator, noise, stacked: bool = False):
        """``n`` sweeps from ``tables``, one replay each of the graph of
        their shapes (``make_graph(tables)`` at first): internal noise draws
        each sweep's seed from ``generator``, external noise is
        ``noise(sweep0 + i)`` (with a chain axis where ``stacked``)."""
        if noise_mode == "internal" and generator is None:
            raise ValueError("internal noise needs a torch.Generator")
        if noise_mode == "external" and noise is None:
            raise ValueError("external noise needs noise(sweep)")
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in tables)
        if key not in graphs:
            graphs[key] = make_graph(tables)
        seeds = None
        if noise_mode == "internal":
            seeds = [(sweep_seed(generator),) for _ in range(n)]
        u = None
        if noise_mode == "external":
            def u(i):
                arr = noise(sweep0 + i)
                return arr[None] if stacked else arr
        return graphs[key](tables, alpha, beta, n, seeds=seeds, noise=u)

    if tier == "deferred":
        if deferred_plan is None:
            raise ValueError(
                "use_pallas='deferred' needs a deferred_plan "
                "(ops.count_kernel.plan_deferred) whose arrays are the token_* here"
            )
        plan = deferred_plan
        # f32-exactness guard: the kernels score counts as float32
        if plan.max_word_freq >= (1 << 24):
            raise ValueError(
                "deferred sweep scores word-topic cells in float32; "
                f"max word frequency {plan.max_word_freq} >= 2^24 would round"
            )
        v_pad = plan.v_pad

        def deferred_graph(tables):
            return deferred_sweep_graph(
                tables, tw, td, tm, row_tile=row_tile, noise_mode=noise_mode,
                compute_dtype=kernel_compute_dtype, mirror_dtype=mirror_dtype)

        def run_with_mirror(
            state: SamplerState, alpha=alpha, beta=beta,
            mirror: Optional[torch.Tensor] = None,
            n_sweeps: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Callable[[int], torch.Tensor]] = None,
        ):
            """``n_sweeps`` (default ``num_sweeps``) sweeps carrying the
            snapshot (in ``mirror_dtype``), one graph replay each; returns
            ``(state, mirror)``.  ``mirror=None`` (cold start) casts it from
            ``state.nwk`` first, outside the graph (the reference's
            ``_cast_mirror``; the span ``sweep.snapshot``);
            ``noise(sweep)`` gives the sweep's ``[T_pad, k_pad]`` float32
            uniforms.  ``alpha`` and ``beta`` are read at every call."""
            n = num_sweeps if n_sweeps is None else n_sweeps
            if n <= 0:
                return state, mirror
            if mirror is None:
                with span("sweep.snapshot", state.nwk.device):
                    mirror = snapshot(state.nwk, v_pad,
                                      _round_up(state.nwk.shape[1], 128), mirror_dtype)
            out = replay(deferred_graph,
                         (state.z, state.ndk, state.nwk, state.nk, mirror),
                         state.sweep, alpha, beta, n, generator, noise)
            return SamplerState(*out[:4], sweep=state.sweep + n,
                                seed=state.seed), out[4]

        def run_deferred(state: SamplerState, alpha=alpha, beta=beta,
                         n_sweeps=None, generator=None, noise=None) -> SamplerState:
            state, _ = run_with_mirror(state, alpha, beta, None, n_sweeps=n_sweeps,
                                       generator=generator, noise=noise)
            return state

        run_deferred.kernel_tier = "deferred"
        run_deferred.with_mirror = run_with_mirror
        run_deferred.row_tile = row_tile
        run_deferred.graphs = graphs
        return run_deferred

    if draw_method == "inverse_cdf" and doc_lengths is None:
        raise ValueError("inverse_cdf needs doc_lengths")
    dl = None if doc_lengths is None else dev(doc_lengths)
    # the XLA tier's graph holds a chain axis
    stacked = not (tier == "fused" or (tier is True and draw_method == "gumbel"))

    def make_graph(tables):
        if tier == "fused":
            return fused_sweep_graph(tables, tw, td, tm, block_size=block_size,
                                     row_tile=row_tile, noise_mode=noise_mode)
        if not stacked:
            return draw_sweep_graph(tables, tw, td, tm, block_size=block_size,
                                    noise_mode=noise_mode)
        return xla_sweep_graph(tables, tw, td, tm, dl, block_size=block_size,
                               draw_method=draw_method, noise_mode=noise_mode)

    def run(state: SamplerState, alpha=alpha, beta=beta, n_sweeps=None,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Callable[[int], torch.Tensor]] = None) -> SamplerState:
        n = num_sweeps if n_sweeps is None else n_sweeps
        if n <= 0:
            return state
        tables = (state.z, state.ndk, state.nwk, state.nk)
        if stacked:
            tables = tuple(t[None] for t in tables)
        out = replay(make_graph, tables, state.sweep, alpha, beta, n, generator,
                     noise, stacked)
        if stacked:
            out = tuple(t[0] for t in out)
        return SamplerState(*out, sweep=state.sweep + n, seed=state.seed)

    run.kernel_tier = tier_name(tier, draw_method)
    run.row_tile = row_tile
    run.graphs = graphs
    return run
