"""The port's collapsed-Gibbs sweeps, in the reference's four kernel tiers.

Counterpart of ``ldagibbssampling_tpu/ops/gibbs.py``.  ``make_sweep_fn``
builds a ``run(state, ...) -> state`` for the tier ``use_pallas`` asks for,
after the reference's layout and exactness rules (``sweep_tier``):

- ``False``, the XLA tier (``gibbs_sweep``): per block of ``block_size``
  tokens, PyTorch ops gather the block's count rows, draw (``gumbel``: argmax
  of the log conditional plus Gumbel noise; ``inverse_cdf``: the reference's
  prefix-sum inversion, bitwise the serial oracle's chain at block 1 with
  float64 and the oracle's uniforms) and scatter the block's moves;
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
so the walk over tiles in order IS the walk over blocks in order.  The TPU's
single-dispatch ``fori_loop`` over sweeps becomes a Python loop.

Noise modes: ``internal`` (each sweep draws one seed from the caller's
``torch.Generator``: the kernels key Philox4x32-10 with it, the XLA draws
seed a ``torch.Generator`` on the tensors' device with it), ``external``
(the caller's ``noise(sweep)`` gives the sweep's array: uniforms for the
kernels and ``inverse_cdf``, Gumbel values for the XLA gumbel draw) and
``deterministic`` (argmax of the conditional; not for ``inverse_cdf``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.count_kernel import (
    build_nwk, cast_mirror, rebuild_counts)
from ldagibbssampling_tpu_torch.ops.fused_kernel import (
    CHAINS, NOISE_MODES, count_move, gibbs_tiles)
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


def _f32(x: float) -> float:
    return float(np.float32(x))


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
    vocab_size: Optional[int] = None,
    emit_mirror: bool = True,
):
    """Deferred-mode sweep core: returns ``(z, ndk, nwk, nk, mirror_out)``.

    ``state.nwk`` is only read, as the sweep-stale snapshot: ``mirror``
    (``[v_pad, k_pad]`` in ``mirror_dtype``, the previous sweep's
    ``mirror_out``) or, when ``None``, a fresh ``snapshot`` of
    ``state.nwk``.  ``ndk`` comes from K1's in-place walk, in the chain
    ``compute_dtype``, over a copy of ``state.ndk``; ``nwk`` and ``nk`` come
    from K2's rebuild from the new ``z`` (K1's running ``nk`` is a sampling
    normaliser only, as in the reference), and so does ``mirror_out``, the
    next sweep's snapshot: K2's ride-along cast for the bf16 snapshot, a
    PyTorch cast of the rebuilt padded table for the float32 one (the
    reference's ``ops/gibbs.py:469-472`` and :491-501).

    The mesh runtimes (``parallel/``) pass ``emit_mirror=False``: ``nwk``
    is then this token stream's local count table, K2's rebuild alone, and
    ``mirror_out`` is ``None`` (a shard's table is not the global one: the
    runtime casts the snapshot after the reconciliation).  ``vocab_size``
    overrides the V of ``V·β`` (a vocabulary slab's height is not V).
    """
    v_rows, k = state.nwk.shape
    v = v_rows if vocab_size is None else int(vocab_size)
    k_pad = _round_up(k, 128)
    if mirror is None:
        mirror = snapshot(state.nwk, v_pad, k_pad, mirror_dtype)
    # V·β in float32, as the reference forms it from its f32 β
    vbeta = float(np.float32(v) * np.float32(beta))
    ndk = state.ndk.clone()
    nk = state.nk.clone()
    z = gibbs_tiles(
        mirror, ndk, nk, state.z, token_word, token_doc, token_mask,
        alpha=_f32(alpha), beta=_f32(beta), vbeta=vbeta, row_tile=row_tile,
        noise_mode=noise_mode, seed=seed, uniforms=uniforms,
        compute_dtype=compute_dtype,
    )
    rebuild = dict(vocab_size=v_rows, num_topics=k, v_pad=v_pad, k_pad=k_pad)
    if not emit_mirror:
        nwk, nk_rebuilt = build_nwk(z, token_word, token_mask,
                                    emit_mirror=False, **rebuild)
        return z, ndk, nwk, nk_rebuilt, None
    if mirror_dtype == "bfloat16":
        nwk, nk_rebuilt, mirror_out = build_nwk(z, token_word, token_mask,
                                                **rebuild)
    else:
        # K2's rebuild alone (build_nwk's emit_mirror=False form), and the
        # float32 snapshot cast straight from its padded table
        nwk_p, nk_p = rebuild_counts(z, token_word, token_mask,
                                     v_pad=v_pad, k_pad=k_pad)
        nwk, nk_rebuilt, mirror_out = nwk_p[:v_rows, :k], nk_p[:k], nwk_p.float()
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


def _clone(state: SamplerState):
    return (state.z.clone(), state.ndk.clone(), state.nwk.clone(),
            state.nk.clone())


def _scatter_counts(ndk, nwk, nk, w, d, msk, zold, znew) -> None:
    """The XLA tier's per-block scatter-adds (reference ops/gibbs.py:233-238),
    as PyTorch ops: -1 at ``zold``, +1 at ``znew`` for the unmasked tokens.
    ``index_add_`` into the flat integer tables: integer sums are exact in
    any order, so the atomic adds on CUDA give the same tables every time,
    with no sort of the indices.  A masked token adds 0 rather than being
    indexed out, so the scatter needs no host sync (a boolean index waits
    for the device)."""
    one = (msk > 0).to(ndk.dtype)
    k = nk.shape[0]
    zo, zn = zold.long(), znew.long()
    for table, rows in ((ndk, d.long() * k), (nwk, w.long() * k), (nk, 0)):
        flat = table.view(-1)
        flat.index_add_(0, rows + zo, -one)
        flat.index_add_(0, rows + zn, one)


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
    """One sweep of the XLA tier (``use_pallas=False``) or the v1-draw tier
    (``use_pallas=True``: K3 draws the gumbel blocks); returns the new state.

    ``token_*`` are padded to a multiple of ``block_size``; ``doc_lengths``
    (``[M]``) is needed by ``inverse_cdf``.  External ``noise`` is the
    sweep's array: ``[T_pad, K]`` Gumbel values (XLA gumbel), ``[T_pad, K]``
    uniforms (K3) or ``[T_pad]`` uniforms (``inverse_cdf``, the reference's
    ``uniforms=``).  ``vocab_size`` overrides the V of ``V·β``.  Scalars are
    formed as the reference forms them: α and β rounded to float32, ``V·β``
    and ``K·α`` float32 products, all then cast to ``prob_dtype``.
    """
    if draw_method not in ("gumbel", "inverse_cdf"):
        raise ValueError(f"unknown draw_method {draw_method!r}")
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if draw_method == "inverse_cdf" and noise_mode == "deterministic":
        raise ValueError("inverse_cdf draws need uniforms: no deterministic mode")
    if noise_mode == "external" and noise is None:
        raise ValueError("noise_mode='external' needs the sweep's noise")
    t_pad = token_word.shape[0]
    if t_pad % block_size != 0:
        raise ValueError(
            f"padded token count {t_pad} not a multiple of block_size {block_size}")
    dev = state.z.device
    v, k = state.nwk.shape
    v = v if vocab_size is None else int(vocab_size)
    z, ndk, nwk, nk = _clone(state)
    alpha32, beta32 = np.float32(alpha), np.float32(beta)
    vbeta32 = np.float32(v) * beta32
    kalpha32 = np.float32(k) * alpha32
    kernel = bool(use_pallas) and draw_method == "gumbel"
    gen = None
    if noise_mode == "internal" and not kernel:
        gen = torch.Generator(device=dev).manual_seed(seed)

    def scalar(x):
        # a 0-d host tensor: a CUDA op reads it as a scalar, where a device
        # tensor made from a host value would cost a blocking copy
        return torch.tensor(float(x), dtype=prob_dtype)

    alpha_c, beta_c, vbeta_c, kalpha_c = map(
        scalar, (alpha32, beta32, vbeta32, kalpha32))
    if draw_method == "inverse_cdf":
        if doc_lengths is None:
            raise ValueError("inverse_cdf needs doc_lengths")
        dl = doc_lengths.to(device=dev, dtype=prob_dtype)
    topics = torch.arange(k, device=dev)

    for s in range(0, t_pad, block_size):
        sl = slice(s, s + block_size)
        w, d, msk, zold = token_word[sl], token_doc[sl], token_mask[sl], z[sl]
        if kernel:
            znew = sample_block(
                nwk, ndk, nk, zold, w, d, alpha=float(alpha32),
                beta=float(beta32), vbeta=float(vbeta32),
                noise_mode=noise_mode, seed=seed,
                uniforms=noise[sl] if noise_mode == "external" else None,
                slot0=s)
        else:
            # self-exclusion of the unmasked tokens (decrement step)
            old = ((topics[None, :] == zold[:, None]) & (msk > 0)[:, None]
                   ).to(nwk.dtype)
            nwk_ex = (nwk[w.long()] - old).to(prob_dtype)
            ndk_ex = (ndk[d.long()] - old).to(prob_dtype)
            nk_ex = (nk[None, :] - old).to(prob_dtype)
            if draw_method == "gumbel":
                score = (torch.log(nwk_ex + beta_c) + torch.log(ndk_ex + alpha_c)
                         - torch.log(nk_ex + vbeta_c))
                if noise_mode == "external":
                    score = score + noise[sl].to(prob_dtype)
                elif noise_mode == "internal":
                    u = torch.rand(score.shape, generator=gen, dtype=prob_dtype,
                                   device=dev).clamp_(min=torch.finfo(prob_dtype).tiny)
                    score = score + (-torch.log(-torch.log(u)))
                znew = score.argmax(dim=1).to(torch.int32)
            else:
                # the reference's op order: ((nwk+β)/(nk+Vβ) · (ndk+α)) / (N_m-1+Kα)
                den = (dl[d.long()] - 1.0 + kalpha_c)[:, None]
                p = (nwk_ex + beta_c) / (nk_ex + vbeta_c) * (ndk_ex + alpha_c) / den
                c = torch.cumsum(p, dim=1)
                if noise_mode == "external":
                    u = noise[sl].to(prob_dtype)
                else:
                    u = torch.rand(block_size, generator=gen, dtype=prob_dtype,
                                   device=dev)
                # first k with u < c[k]  ==  number of k with c[k] <= u
                znew = (c <= (u * c[:, -1])[:, None]).sum(dim=1)
                znew = znew.clamp(max=k - 1).to(torch.int32)
        if kernel:
            # one launch moves the three tables and writes z[sl] (zold's
            # memory): mask ? znew : zold
            count_move(zold, znew, msk, nwk=nwk, token_word=w, ndk=ndk,
                       token_doc=d, nk=nk, z_out=zold)
            continue
        znew = torch.where(msk > 0, znew, zold)
        _scatter_counts(ndk, nwk, nk, w, d, msk, zold, znew)
        z[sl] = znew
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=state.sweep + 1,
                        seed=state.seed)


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
    """One sweep of the fused tier; returns the new state.

    Per block, K1 walks the block's tiles in order against the block-start
    ``nwk`` (the live int32 table, only read), moving ``ndk`` and ``nk``
    after each tile; then one count-move launch applies the block's
    word-topic moves, as the reference's ``nwk.at[w].add(delta)`` does.
    ``nk`` carries across blocks.  External ``uniforms`` are the sweep's
    ``[T_pad, k_pad]`` array (the reference's ``uniform(sweep_key, ...)``).
    ``vocab_size`` overrides the V of ``V·β``.
    """
    t_pad = token_word.shape[0]
    if t_pad % block_size or block_size % row_tile:
        raise ValueError(
            f"token count {t_pad} / block {block_size} / row_tile {row_tile} misaligned")
    v = state.nwk.shape[0] if vocab_size is None else int(vocab_size)
    vbeta = float(np.float32(v) * np.float32(beta))
    z, ndk, nwk, nk = _clone(state)
    for s in range(0, t_pad, block_size):
        sl = slice(s, s + block_size)
        w, d, msk, zold = token_word[sl], token_doc[sl], token_mask[sl], z[sl]
        znew = gibbs_tiles(
            nwk, ndk, nk, zold, w, d, msk, alpha=_f32(alpha), beta=_f32(beta),
            vbeta=vbeta, row_tile=row_tile, noise_mode=noise_mode, seed=seed,
            uniforms=None if uniforms is None else uniforms[sl], slot0=s)
        # the walk keeps masked tokens' z, so z_out = znew: written into
        # z[sl] (zold's memory) by the move's launch
        count_move(zold, znew, msk, nwk=nwk, token_word=w, z_out=zold)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=state.sweep + 1,
                        seed=state.seed)


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
    array (see the module docstring).
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

    def sweep_noise(state, generator, noise):
        """``(seed, noise array)`` of the next sweep."""
        if noise_mode == "internal":
            if generator is None:
                raise ValueError("internal noise needs a torch.Generator")
            return int(torch.randint(0, 2**63 - 1, (), generator=generator)), None
        if noise_mode == "external":
            if noise is None:
                raise ValueError("external noise needs noise(sweep)")
            return 0, noise(state.sweep)
        return 0, None

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

        def run_with_mirror(
            state: SamplerState, alpha=alpha, beta=beta,
            mirror: Optional[torch.Tensor] = None,
            n_sweeps: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Callable[[int], torch.Tensor]] = None,
        ):
            """``n_sweeps`` (default ``num_sweeps``) sweeps carrying the
            snapshot (in ``mirror_dtype``); returns ``(state, mirror)``.
            ``mirror=None`` (cold start) casts it from ``state.nwk``;
            ``noise(sweep)`` gives the sweep's ``[T_pad, k_pad]`` float32
            uniforms.  ``alpha`` and ``beta`` are read at every call."""
            n = num_sweeps if n_sweeps is None else n_sweeps
            for _ in range(n):
                seed, u = sweep_noise(state, generator, noise)
                state, mirror = _deferred_sweep_impl(
                    state, tw, td, tm, alpha, beta, row_tile=row_tile,
                    v_pad=v_pad, mirror=mirror, noise_mode=noise_mode,
                    seed=seed, uniforms=u, compute_dtype=kernel_compute_dtype,
                    mirror_dtype=mirror_dtype,
                )
            return state, mirror

        def run_deferred(state: SamplerState, alpha=alpha, beta=beta,
                         n_sweeps=None, generator=None, noise=None) -> SamplerState:
            state, _ = run_with_mirror(state, alpha, beta, None, n_sweeps=n_sweeps,
                                       generator=generator, noise=noise)
            return state

        run_deferred.kernel_tier = "deferred"
        run_deferred.with_mirror = run_with_mirror
        run_deferred.row_tile = row_tile
        return run_deferred

    if draw_method == "inverse_cdf" and doc_lengths is None:
        raise ValueError("inverse_cdf needs doc_lengths")
    dl = None if doc_lengths is None else dev(doc_lengths)

    def run(state: SamplerState, alpha=alpha, beta=beta, n_sweeps=None,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Callable[[int], torch.Tensor]] = None) -> SamplerState:
        n = num_sweeps if n_sweeps is None else n_sweeps
        for _ in range(n):
            seed, u = sweep_noise(state, generator, noise)
            if tier == "fused":
                state = fused_gibbs_sweep(
                    state, tw, td, tm, alpha, beta, block_size=block_size,
                    row_tile=row_tile, noise_mode=noise_mode, seed=seed,
                    uniforms=u)
            else:
                state = gibbs_sweep(
                    state, tw, td, tm, dl, alpha=alpha, beta=beta,
                    block_size=block_size, draw_method=draw_method,
                    use_pallas=tier, noise_mode=noise_mode, seed=seed, noise=u)
        return state

    run.kernel_tier = tier_name(tier, draw_method)
    run.row_tile = row_tile
    return run
