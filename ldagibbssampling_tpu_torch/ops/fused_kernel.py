"""K1 of the deferred sweep: per-tile draw + doc/topic count update.

Counterpart of ``ldagibbssampling_tpu/ops/pallas_gibbs.py`` (the fused block
kernel ``_fused_kernel`` as the deferred tier calls it: ``emit_delta=False``,
float32 chain).  The CUDA kernels are in ``csrc/fused_kernel.cu``:

- ``gibbs_tile_sample``: one warp per token reads the token's row of the
  bf16 snapshot by word id, its doc row and ``nk``, and draws
  ``argmax p / E`` (the reference's exponential race);
- ``gibbs_tile_update``: moves each unmasked token's count from ``z_old`` to
  ``z_new`` in ``ndk`` and ``nk`` with integer atomics.

``ndk [M, K]`` and ``nk [K]`` are int32 and updated IN PLACE, indexed by the
token's document: the reference's per-block ``[D_LOC, K]`` slab is a VMEM
artefact, and since ``d0 + d_local == token_doc`` for every real token and
tiles run in order, in-place updates give the same chain.  Counts become
float32 only inside the score (exact below the 2^24 guard of
``ops/gibbs.make_sweep_fn``).

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it; any other device raises, and so does a failed
launch.  ``LAUNCHES`` counts kernel launches, ``PLAIN_CALLS`` calls of the
plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

NOISE_MODES = ("deterministic", "external", "internal")
LAUNCHES = {"gibbs_tile_sample": 0, "gibbs_tile_update": 0}
PLAIN_CALLS = {"gibbs_tile_sample": 0, "gibbs_tile_update": 0}

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side yardstick)
# ---------------------------------------------------------------------------


def approx_recip(x: torch.Tensor) -> torch.Tensor:
    """``pl.reciprocal(x, approx=True)`` as the reference computes it under
    the CPU interpreter: the float32 reciprocal of the bf16-cast input (the
    TPU's hardware estimate is another function)."""
    return torch.reciprocal(x.to(torch.bfloat16).float())


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # 32x32 -> 64-bit product in int64 without overflow: split b in halves
    p1 = a * (b & 0xFFFF)
    s = a * (b >> 16) + (p1 >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (p1 & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, slot0: int, n: int, k_pad: int,
                    device) -> torch.Tensor:
    """``[n, k_pad]`` float32 uniforms of the internal noise mode: Philox
    keyed by ``seed``, counter (token slot, topic group of 4, 0, 0), low 24
    bits → ``(bits + 0.5) · 2^-24`` (``pallas_gibbs.py:161``)."""
    slots = torch.arange(slot0, slot0 + n, dtype=torch.int64, device=device)
    groups = torch.arange(k_pad // 4, dtype=torch.int64, device=device)
    c0 = (slots & _MASK32)[:, None].expand(n, groups.shape[0])
    c1 = (slots >> 32)[:, None].expand_as(c0)
    c2 = groups[None, :].expand_as(c0)
    c3 = torch.zeros_like(c0)
    words = philox4x32_10(c0, c1, c2, c3, seed & _MASK32, (seed >> 32) & _MASK32)
    bits = torch.stack(words, dim=-1).reshape(n, k_pad)
    return (bits & 0xFFFFFF).float() * 2.0**-24 + 2.0**-25


def sample_plain(mirror, ndk, nk, z, token_word, token_doc, token_mask, *,
                 alpha, beta, vbeta, noise_mode, seed=0, uniforms=None,
                 slot0=0) -> torch.Tensor:
    """Draw every token against the given counts (no count update)."""
    PLAIN_CALLS["gibbs_tile_sample"] += 1
    k = ndk.shape[1]
    n, k_pad = z.shape[0], mirror.shape[1]
    f32 = torch.float32
    dev = mirror.device
    alpha, beta, vbeta = (torch.tensor(x, dtype=f32, device=dev)
                          for x in (alpha, beta, vbeta))
    cols = torch.arange(k_pad, device=dev)
    e = (cols[None, :] == z[:, None].long()).to(f32)
    rows = mirror[token_word.long()].to(f32)
    drows = F.pad(ndk[token_doc.long()], (0, k_pad - k)).to(f32)
    r = approx_recip(F.pad(nk, (0, k_pad - k)).to(f32) + vbeta)
    rr = r * r
    p = ((rows - e + beta) * (drows - e + alpha)) * (r + e * rr)
    if noise_mode == "deterministic":
        score = p
    else:
        u = (philox_uniforms(seed, slot0, n, k_pad, dev)
             if noise_mode == "internal" else uniforms)
        score = p * approx_recip(-torch.log(u))
    score = torch.where(cols[None, :] < k, score, torch.tensor(-1.0, device=dev))
    znew = score.argmax(dim=1).to(z.dtype)  # first index of the maximum
    return torch.where(token_mask > 0, znew, z)


def update_plain(ndk, nk, z_old, z_new, token_doc, token_mask) -> None:
    """-1 at (doc, z_old), +1 at (doc, z_new) in ``ndk`` and ``nk``, in place."""
    PLAIN_CALLS["gibbs_tile_update"] += 1
    real = token_mask > 0
    d = token_doc[real].long()
    zo = z_old[real].long()
    zn = z_new[real].long()
    one = torch.ones_like(d, dtype=ndk.dtype)
    ndk.index_put_((d, zo), -one, accumulate=True)
    ndk.index_put_((d, zn), one, accumulate=True)
    nk.index_put_((zo,), -one, accumulate=True)
    nk.index_put_((zn,), one, accumulate=True)


def gibbs_tiles_plain(mirror, ndk, nk, z, token_word, token_doc, token_mask,
                      *, alpha, beta, vbeta, row_tile, noise_mode="internal",
                      seed=0, uniforms=None, slot0=0) -> torch.Tensor:
    """The plain version of ``gibbs_tiles``: per tile, ``sample_plain`` then
    ``update_plain`` (on whatever device the tensors are)."""
    parts = []
    for s in range(0, z.shape[0], row_tile):
        sl = slice(s, s + row_tile)
        zt = sample_plain(
            mirror, ndk, nk, z[sl], token_word[sl], token_doc[sl],
            token_mask[sl], alpha=alpha, beta=beta, vbeta=vbeta,
            noise_mode=noise_mode, seed=seed,
            uniforms=None if uniforms is None else uniforms[sl],
            slot0=slot0 + s,
        )
        update_plain(ndk, nk, z[sl], zt, token_doc[sl], token_mask[sl])
        parts.append(zt)
    return torch.cat(parts) if parts else z.clone()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_tensors(dev, expect) -> None:
    """Each ``(name, tensor, dtype, ndim)`` lies on ``dev``, contiguous."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtype, ndim in expect:
        if t.device != dev or t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"{name}: want {dtype} {ndim}-d on {dev}, got {t.dtype} "
                f"{t.dim()}-d on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_counts(ndk, nk, z, token_doc, token_mask, extra=()) -> None:
    n = z.shape[0]
    _check_tensors(ndk.device, [
        ("ndk", ndk, torch.int32, 2), ("nk", nk, torch.int32, 1),
        ("z", z, torch.int32, 1), ("token_doc", token_doc, torch.int32, 1),
        ("token_mask", token_mask, torch.int32, 1), *extra])
    if nk.shape[0] != ndk.shape[1]:
        raise ValueError(f"nk has {nk.shape[0]} topics, ndk {ndk.shape[1]}")
    for name, t in (("token_doc", token_doc), ("token_mask", token_mask),
                    *((x[0], x[1]) for x in extra if x[3] == 1)):
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} tokens, z has {n}")


def _check(mirror, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms):
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    extra = [("mirror", mirror, torch.bfloat16, 2),
             ("token_word", token_word, torch.int32, 1)]
    k_pad = mirror.shape[1]
    if noise_mode == "external":
        if uniforms is None:
            raise ValueError("noise_mode='external' requires uniforms")
        extra.append(("uniforms", uniforms, torch.float32, 2))
        if tuple(uniforms.shape) != (z.shape[0], k_pad):
            raise ValueError(
                f"uniforms {tuple(uniforms.shape)} != {(z.shape[0], k_pad)}")
    _check_counts(ndk, nk, z, token_doc, token_mask, extra)
    if k_pad % 128 or ndk.shape[1] > k_pad:
        raise ValueError(
            f"k_pad {k_pad} must be a multiple of 128 holding K={ndk.shape[1]}")


def _lib():
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("fused_kernel")
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.lda_gibbs_tiles.restype = i32
    lib.lda_gibbs_tiles.argtypes = [
        vp, i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32,
        f32, f32, f32, i32, ctypes.c_ulonglong, i64, i32, vp]
    return _build, lib


def _launch(ndk, nk, z, z_new, token_doc, token_mask, *, mirror=None,
            token_word=None, uniforms=None, row_tile, alpha=0.0, beta=0.0,
            vbeta=0.0, noise_mode="deterministic", seed=0, slot0=0,
            phases) -> None:
    """One host call that launches the tiles' kernels (``phases``: 1 draw,
    2 count move, 3 both per tile); the phases' unused tensors may be None."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    build, lib = _lib()
    with torch.cuda.device(ndk.device):
        err = lib.lda_gibbs_tiles(
            ptr(mirror), 0 if mirror is None else mirror.shape[1], ptr(ndk),
            ndk.shape[1], ptr(nk), ptr(z), ptr(z_new), ptr(token_word),
            ptr(token_doc), ptr(token_mask),
            ptr(uniforms) if noise_mode == "external" else None,
            z.shape[0], row_tile, alpha, beta, vbeta,
            NOISE_MODES.index(noise_mode), seed & (2**64 - 1), slot0,
            phases, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "lda_gibbs_tiles")
    n_tiles = -(-z.shape[0] // row_tile)
    if phases & 1:
        LAUNCHES["gibbs_tile_sample"] += n_tiles
    if phases & 2:
        LAUNCHES["gibbs_tile_update"] += n_tiles


def gibbs_tiles(
    mirror: torch.Tensor,       # [v_pad, k_pad] bf16 — sweep-stale snapshot of nwk
    ndk: torch.Tensor,          # [M, K] int32 — updated in place
    nk: torch.Tensor,           # [K] int32 — updated in place
    z: torch.Tensor,            # [n] int32 — assignments before the walk
    token_word: torch.Tensor,   # [n] int32
    token_doc: torch.Tensor,    # [n] int32
    token_mask: torch.Tensor,   # [n] int32 — 1 real, 0 padding
    *,
    alpha: float,
    beta: float,
    vbeta: float,
    row_tile: int,
    noise_mode: str = "internal",
    seed: int = 0,
    uniforms: Optional[torch.Tensor] = None,  # [n, k_pad] f32 (external)
    slot0: int = 0,
) -> torch.Tensor:
    """Walk the tokens in tiles of ``row_tile``, in order: draw each tile,
    then move its counts, before the next tile draws.  Returns ``z_new``.

    ``slot0`` is the stream position of token 0 (the internal noise
    counter), so a walk over a slice draws what the whole walk would.
    """
    _check(mirror, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms)
    if row_tile <= 0:
        raise ValueError(f"row_tile {row_tile} must be positive")
    if mirror.device.type == "cuda":
        z_new = torch.empty_like(z)
        _launch(ndk, nk, z, z_new, token_doc, token_mask, mirror=mirror,
                token_word=token_word, uniforms=uniforms, row_tile=row_tile,
                alpha=alpha, beta=beta, vbeta=vbeta, noise_mode=noise_mode,
                seed=seed, slot0=slot0, phases=3)
        return z_new
    return gibbs_tiles_plain(
        mirror, ndk, nk, z, token_word, token_doc, token_mask, alpha=alpha,
        beta=beta, vbeta=vbeta, row_tile=row_tile, noise_mode=noise_mode,
        seed=seed, uniforms=uniforms, slot0=slot0)


def gibbs_tile_sample(mirror, ndk, nk, z, token_word, token_doc, token_mask,
                      *, alpha, beta, vbeta, row_tile, noise_mode="internal",
                      seed=0, uniforms=None, slot0=0) -> torch.Tensor:
    """The draw alone: every token against the given counts, launched in
    tiles of ``row_tile``; returns ``z_new`` and moves no count."""
    _check(mirror, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms)
    if mirror.device.type == "cpu":
        return sample_plain(
            mirror, ndk, nk, z, token_word, token_doc, token_mask,
            alpha=alpha, beta=beta, vbeta=vbeta, noise_mode=noise_mode,
            seed=seed, uniforms=uniforms, slot0=slot0)
    z_new = torch.empty_like(z)
    _launch(ndk, nk, z, z_new, token_doc, token_mask, mirror=mirror,
            token_word=token_word, uniforms=uniforms, row_tile=row_tile,
            alpha=alpha, beta=beta, vbeta=vbeta, noise_mode=noise_mode,
            seed=seed, slot0=slot0, phases=1)
    return z_new


def gibbs_tile_update(ndk, nk, z_old, z_new, token_doc, token_mask, *,
                      row_tile) -> None:
    """The count move alone: -1 at (doc, z_old), +1 at (doc, z_new) in
    ``ndk``/``nk`` (in place) for every unmasked token, in tiles of
    ``row_tile``."""
    _check_counts(ndk, nk, z_old, token_doc, token_mask,
                  [("z_new", z_new, torch.int32, 1)])
    if ndk.device.type == "cpu":
        update_plain(ndk, nk, z_old, z_new, token_doc, token_mask)
        return
    _launch(ndk, nk, z_old, z_new, token_doc, token_mask, row_tile=row_tile,
            phases=2)
