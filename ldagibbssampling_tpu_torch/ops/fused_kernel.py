"""K1 of the deferred and fused sweeps: the walk that draws each tile and
moves its doc/topic counts, and the count move.

Counterpart of ``ldagibbssampling_tpu/ops/pallas_gibbs.py`` (the fused block
kernel ``_fused_kernel``) in both modes: the deferred tier
(``emit_delta=False``) reads each token's row of a sweep-stale snapshot
``[v_pad, k_pad]`` of ``nwk``, bf16 or float32 (``mirror_dtype``); the fused
tier (``emit_delta=True``) reads the live int32 ``nwk [V, K]`` as it stood
at the start of the block.  The draw's ``[B, K]`` chain runs in one of the
reference's three ``compute_dtype`` chains (``CHAINS``): ``float32``;
``bfloat16``, the conditional product and the score in bf16; ``bf16p``, the
product in bf16 and the score in float32.  A bf16 chain rounds to bf16 after
every operation, as the reference's kernel is written (and as XLA computes
it with ``--xla_allow_excess_precision=false``); the fused tier runs the
float32 chain only, as the reference does.  The CUDA kernels are in
``csrc/fused_kernel.cu``:

- ``gibbs_walk``: a walk is ONE cooperative launch of as many CTAs as the
  card holds at once, which runs every tile in order: each tile's tokens are
  drawn across the whole card (a team of threads per token reads its row,
  snapshot or live table, by word id, its doc row and the tile's ``nk``
  reciprocals, and draws ``argmax p / E``, the reference's exponential
  race), then the tile's moves of ``ndk`` and ``nk`` go in with integer
  atomics before the next tile draws; templated on the noise mode, the chain
  and the row type.  Where every tile is one pass over the grid (a team of
  threads per token of a tile: the deferred and fused tiers' tiles at every
  K up to 2,048 on an H100, 2,048 tokens at K <= 128 and 1,024 at
  K <= 256 included) and the launch's tiles repay a copy of ``ndk``
  (``one_barrier_pays``), it takes no grid barrier: each leader writes its
  token's move as a 64-bit record (doc, old and new topic, a tag naming the
  tile) into a ring of two tiles, each CTA releases its own count of
  finished tiles once a tile, and the next tile waits on those counts and
  records themselves, folding each record into its CTA's own ``nk`` as it
  arrives; ``ndk`` is double-buffered (the kernel's head comment says why
  readers and writers never meet).  A tag is never 0 and never the tag of
  the tile two back, so neither a zeroed slot nor the slot's previous
  record passes as current; a wait of more than ~2^26 polls traps, so a
  fault fails the launch instead of hanging it.  Otherwise the walk takes
  two grid barriers per tile (``walk_config`` says which).  The wrapper
  allocates, per walk, the grid barrier's counter (one int32,
  ``torch.zeros``) or the ring and the counts (``2 * row_tile`` int64 and a
  uint32 a CTA, zeros) and, for the tagged walk only, the second ``ndk``
  buffer (a clone: ``ndk``'s memory twice while the walk runs); inside a
  stream capture they are a memset and a copy of the graph.  Each walk that
  moves counts adds 1 to the recorder's counter ``walk.tagged_records`` or
  ``walk.two_barrier`` (``evaluation/tracing.count``) when it launches, and
  once per replay where a graph replays it.  A launch the card refuses
  raises; nothing splits a walk into smaller launches or launches it
  without co-residency, which both forms' waits need.  The launch
  configuration is found once per kernel and shape
  (``csrc/fused_kernel.cu``'s cache), so a launch inside a capture makes
  no occupancy query;
- ``gibbs_tile_update``: the count move, ``count_move``: -1 at ``z_old``,
  +1 at ``z_new`` with integer atomics in any of ``nwk``/``ndk``/``nk`` for
  a whole block (the fused tier's word-topic moves, the v1 tier's three
  tables, and ``gibbs_tile_update()``, the walk's count move alone), and
  optionally the block's new assignments ``z_out = mask ? z_new : z_old``
  (``z_out`` may be ``z_old``: the sweep's own ``z``).  Where ``nk`` is
  moved, each CTA sums its ``nk`` moves in a shared histogram and a cluster
  of CTAs flushes one atomic per topic.  The
  reference's dense ``[B, Kp]`` delta (``emit_delta=True``) feeds only the
  word-topic scatter, so on the card it never leaves the kernel;
  ``gibbs_tiles_plain(..., emit_delta=True)`` still returns it.

α, β, V·β and the internal seed are device values, kernel and plain
version alike: ``scalars`` (float32 α, β, V·β first, as
``ops/_device.sweep_scalars`` lays them out) and ``key`` (int64, the seed's
64 bits, ``_device.seed_word``), which the walk reads when it starts.  A
CUDA graph of a sweep (``ops/graphs.py``) replays the walk with the values
its buffers hold then.

``ndk [M, K]`` and ``nk [K]`` are int32 and updated IN PLACE, indexed by the
token's document: the reference's per-block ``[D_LOC, K]`` slab is a VMEM
artefact, and since ``d0 + d_local == token_doc`` for every real token and
tiles run in order, in-place updates give the same chain.  Counts become
float32 only inside the score (exact below the 2^24 guards of
``ops/gibbs.make_sweep_fn``).

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it; any other device raises, and so does a failed
launch.  The recorder's counters ``launch.<kernel>`` count kernel
launches, one per walk, and ``plain.<kernel>`` calls of the plain versions
(per tile) (``evaluation/tracing.count``): a walk that draws counts under
``gibbs_tile_sample`` plus the chain's suffix (none, ``_bf16``, ``_bf16p``)
and the rows' (none for the bf16 snapshot, ``_f32rows``, ``_live`` for the
int32 table) — the instantiation that ran (``sample_name``); the count move
under ``count_move``, and under ``gibbs_tile_update`` where
``gibbs_tile_update()`` launches it (the walk's count move alone; ``plain.``:
the plain walk's per-tile moves).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ldagibbssampling_tpu_torch.evaluation.tracing import count

NOISE_MODES = ("deterministic", "external", "internal")
CHAINS = ("float32", "bfloat16", "bf16p")
_CHAIN_SUFFIX = {"float32": "", "bfloat16": "_bf16", "bf16p": "_bf16p"}
_ROWS_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32rows",
                torch.int32: "_live"}
# the C entry point's row kinds
_ROWS_KIND = {torch.bfloat16: 0, torch.int32: 1, torch.float32: 2}


def sample_name(rows_dtype: torch.dtype, compute_dtype: str = "float32") -> str:
    """The counter name of K1's draw for a row type and a chain."""
    return ("gibbs_tile_sample" + _CHAIN_SUFFIX[compute_dtype]
            + _ROWS_SUFFIX[rows_dtype])


_MASK32 = 0xFFFFFFFF
_MASK64 = 2**64 - 1


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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def row_width(rows: torch.Tensor, num_topics: int) -> int:
    """``k_pad`` of a walk: the snapshot's width, or ``K`` rounded up to 128
    for the live int32 table (the reference pads its f32 table so)."""
    if rows.dtype == torch.int32:
        return _round_up(num_topics, 128)
    return rows.shape[1]


def sample_plain(rows, ndk, nk, z, token_word, token_doc, token_mask, *,
                 scalars, noise_mode, key=None, uniforms=None, slot0=0,
                 compute_dtype="float32") -> torch.Tensor:
    """Draw every token against the given counts (no count update), in the
    chain ``compute_dtype`` (pallas_gibbs.py:140-177, op for op), at the α,
    β, V·β of ``scalars`` and the seed of ``key``."""
    count("plain." + sample_name(rows.dtype, compute_dtype))
    k = ndk.shape[1]
    n, k_pad = z.shape[0], row_width(rows, k)
    f32 = torch.float32
    dev = rows.device
    alpha, beta, vbeta = scalars[:3].to(device=dev, dtype=f32).unbind()
    cols = torch.arange(k_pad, device=dev)
    e = (cols[None, :] == z[:, None].long()).to(f32)
    wrows = F.pad(rows[token_word.long()], (0, k_pad - rows.shape[1])).to(f32)
    drows = F.pad(ndk[token_doc.long()], (0, k_pad - k)).to(f32)
    r32 = approx_recip(F.pad(nk, (0, k_pad - k)).to(f32) + vbeta)
    if compute_dtype == "float32":
        r, rr = r32, r32 * r32
    else:
        # every operand cast to bf16, and every op below rounds to bf16
        # (PyTorch computes a bf16 op in float32 and rounds its result)
        bf = torch.bfloat16
        r, rr = r32.to(bf), (r32 * r32).to(bf)
        e, wrows, drows = e.to(bf), wrows.to(bf), drows.to(bf)
        alpha, beta = alpha.to(bf), beta.to(bf)
    p = ((wrows - e + beta) * (drows - e + alpha)) * (r + e * rr)
    if noise_mode == "deterministic":
        score = p
    else:
        u = (philox_uniforms(int(key.reshape(-1)[0]) & _MASK64, slot0, n,
                             k_pad, dev)
             if noise_mode == "internal" else uniforms)
        inv_e = approx_recip(-torch.log(u))
        if compute_dtype == "bfloat16":
            score = p * inv_e.to(torch.bfloat16)
        else:  # float32, or bf16p's float32 score
            score = p.to(f32) * inv_e
    score = torch.where(cols[None, :] < k, score,
                        torch.tensor(-1.0, dtype=score.dtype, device=dev))
    # the argmax runs on the float32 cast (exact); first index of the maximum
    znew = score.to(f32).argmax(dim=1).to(z.dtype)
    return torch.where(token_mask > 0, znew, z)


def _move_plain(z_old, z_new, token_mask, *, nwk=None, token_word=None,
                ndk=None, token_doc=None, nk=None) -> None:
    real = token_mask > 0
    zo = z_old[real].long()
    zn = z_new[real].long()
    one = torch.ones_like(zo, dtype=torch.int32)
    for table, ids in ((nwk, token_word), (ndk, token_doc), (nk, None)):
        if table is None:
            continue
        idx = () if ids is None else (ids[real].long(),)
        table.index_put_((*idx, zo), -one, accumulate=True)
        table.index_put_((*idx, zn), one, accumulate=True)


def count_move_plain(z_old, z_new, token_mask, *, z_out=None, **tables) -> None:
    """-1 at ``z_old``, +1 at ``z_new`` for every unmasked token, in place,
    in each given table: ``nwk`` by ``token_word``, ``ndk`` by
    ``token_doc``, ``nk``; then, given ``z_out`` (which may be ``z_old``),
    ``z_out = mask ? z_new : z_old``."""
    count("plain.count_move")
    _move_plain(z_old, z_new, token_mask, **tables)
    if z_out is not None:
        z_out.copy_(torch.where(token_mask > 0, z_new, z_old))


def update_plain(ndk, nk, z_old, z_new, token_doc, token_mask) -> None:
    """One tile's move of ``ndk``/``nk``, in place (K1's walk)."""
    count("plain.gibbs_tile_update")
    _move_plain(z_old, z_new, token_mask, ndk=ndk, token_doc=token_doc, nk=nk)


def dense_delta(z_old, z_new, token_mask, k_pad: int) -> torch.Tensor:
    """The reference kernel's ``delta`` output ``[n, k_pad]`` float32:
    one-hot(z_new) - one-hot(z_old) on unmasked tokens, 0 on masked ones."""
    cols = torch.arange(k_pad, device=z_old.device)
    m = (token_mask > 0).to(torch.float32)[:, None]
    return ((cols == z_new[:, None].long()).float() * m
            - (cols == z_old[:, None].long()).float() * m)


def gibbs_tiles_plain(rows, ndk, nk, z, token_word, token_doc, token_mask,
                      *, scalars, row_tile, noise_mode="internal", key=None,
                      uniforms=None, slot0=0, emit_delta=False,
                      compute_dtype="float32"):
    """The plain version of ``gibbs_tiles``: per tile, ``sample_plain`` then
    ``update_plain`` (on whatever device the tensors are).  With
    ``emit_delta`` it returns ``(z_new, dense_delta)``."""
    parts = []
    for s in range(0, z.shape[0], row_tile):
        sl = slice(s, s + row_tile)
        zt = sample_plain(
            rows, ndk, nk, z[sl], token_word[sl], token_doc[sl],
            token_mask[sl], scalars=scalars, noise_mode=noise_mode, key=key,
            uniforms=None if uniforms is None else uniforms[sl],
            slot0=slot0 + s, compute_dtype=compute_dtype,
        )
        update_plain(ndk, nk, z[sl], zt, token_doc[sl], token_mask[sl])
        parts.append(zt)
    z_new = torch.cat(parts) if parts else z.clone()
    if emit_delta:
        return z_new, dense_delta(z, z_new, token_mask,
                                  row_width(rows, ndk.shape[1]))
    return z_new


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


def _check(rows, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms, compute_dtype, scalars, key):
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if noise_mode == "internal" and key is None:
        raise ValueError("noise_mode='internal' requires key")
    if compute_dtype not in CHAINS:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if rows.dtype not in _ROWS_KIND:
        raise ValueError(
            "rows: want the bfloat16 or float32 snapshot or the int32 table, "
            f"got {rows.dtype}")
    if rows.dtype == torch.int32 and compute_dtype != "float32":
        raise ValueError(
            "the live int32 table (the fused tier) runs the float32 chain only, "
            f"not {compute_dtype!r}")
    k = ndk.shape[1]
    k_pad = row_width(rows, k)
    extra = [("rows", rows, rows.dtype, 2),
             ("token_word", token_word, torch.int32, 1)]
    _check_tensors(ndk.device, [("scalars", scalars, torch.float32, 1),
                                *([("key", key, torch.int64, 1)] if key is not None
                                  else [])])
    if scalars.shape[0] < 3:
        raise ValueError(f"scalars {tuple(scalars.shape)}: α, β, Vβ needed")
    if noise_mode == "external":
        if uniforms is None:
            raise ValueError("noise_mode='external' requires uniforms")
        extra.append(("uniforms", uniforms, torch.float32, 2))
        if tuple(uniforms.shape) != (z.shape[0], k_pad):
            raise ValueError(
                f"uniforms {tuple(uniforms.shape)} != {(z.shape[0], k_pad)}")
    _check_counts(ndk, nk, z, token_doc, token_mask, extra)
    if rows.dtype == torch.int32 and rows.shape[1] != k:
        raise ValueError(f"the int32 table has {rows.shape[1]} topics, ndk {k}")
    if k_pad % 128 or k > k_pad:
        raise ValueError(f"k_pad {k_pad} must be a multiple of 128 holding K={k}")


@functools.cache
def _lib():
    """The library with its entry points' types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("fused_kernel")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lda_gibbs_tiles.restype = i32
    lib.lda_gibbs_tiles.argtypes = [
        vp, i32, i64, i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32,
        vp, vp, i32, i32, i64, i32, vp, vp, vp]
    lib.lda_walk_config.restype = i32
    lib.lda_walk_config.argtypes = [i32, i32, i32, i32, i64, i32,
                                    *[ctypes.POINTER(i32)] * 4]
    lib.lda_count_move.restype = i32
    lib.lda_count_move.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, vp, vp, i64,
                                   vp]
    return _build, lib


def _ptr(t):
    return None if t is None else t.data_ptr()


# What the tagged walk saves against the two-barrier walk, a tile: an H100
# at 700 W walked chip_smoke's K = 100 block (32 tiles of 2,048, its ndk
# 1.6 MB and copied) in 0.108 ms with one grid barrier a tile and 0.211 ms
# with two (scripts/walk_parity, in turns); the tagged walk takes as long as
# the one-barrier walk there.  What its copy of ``ndk`` costs at least:
# ``ndk``'s bytes read and written at the HBM's 3.35 TB/s (120 MB copied in
# 0.086 ms on that card).
TILE_SAVING_S = 3.2e-6
HBM_BYTES_PER_S = 3.35e12
# the tagged walk's ring of move records, in tiles, and the tiles whose
# records' tags differ before they repeat (t % 1023 + 1)
RING_TILES = 2
TAG_RANGE = 1023


def one_barrier_pays(n_tiles: int, ndk_bytes: int) -> bool:
    """Do a launch's ``n_tiles`` tiles repay the tagged walk's copy of
    ``ndk`` twice over?  A sweep in one launch does by far (NYTimes at
    K = 100: ~48,600 tiles against a 120 MB ``ndk``); the fused tier's
    launch of one block of 65,536 tokens (32 tiles of 2,048) does where
    ``ndk`` is under ~86 MB, so not at NYTimes's 300,000 documents, where
    its copy (0.086 ms) takes most of what the tiles save (0.10 ms).  The
    margin covers a saving measured with ``ndk`` in L2 and a copy that also
    evicts L2."""
    return n_tiles * TILE_SAVING_S >= 2 * (2 * ndk_bytes / HBM_BYTES_PER_S)


@functools.lru_cache(maxsize=256)
def _walk_config(device_index: int, rows_kind: int, chain: int, mode: int,
                 k_pad: int, n_tokens: int, row_tile: int) -> tuple:
    build, lib = _lib()
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        err = lib.lda_walk_config(rows_kind, chain, mode, k_pad, n_tokens,
                                  row_tile, *(ctypes.byref(x) for x in out))
    build.check(lib, err, "lda_walk_config")
    return tuple(x.value for x in out)


def walk_config(rows_dtype: torch.dtype, compute_dtype: str, noise_mode: str,
                k_pad: int, n_tokens: int, row_tile: int, device=None, *,
                ndk_bytes: int = 0) -> dict:
    """How ``gibbs_tiles`` launches a walk on the card with an ``ndk`` of
    ``ndk_bytes``: ``grid`` CTAs (as many as the occupancy query says fit at
    once) of ``threads``, ``team`` threads per token, and ``pipelined`` (the
    tagged walk, where every tile is one pass and the tiles repay the
    copies of ``ndk``) or not (two barriers per tile)."""
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
    grid, threads, team, pipelined = _walk_config(
        index, _ROWS_KIND[rows_dtype], CHAINS.index(compute_dtype),
        NOISE_MODES.index(noise_mode), k_pad, n_tokens, row_tile)
    n_tiles = -(-n_tokens // row_tile)
    return dict(grid=grid, threads=threads, team=team,
                pipelined=bool(pipelined) and one_barrier_pays(n_tiles, ndk_bytes))


def _launch(ndk, nk, z, z_new, token_doc, token_mask, *, rows, token_word,
            uniforms, row_tile, scalars, key, noise_mode, slot0,
            compute_dtype, phases) -> None:
    """One cooperative launch that walks every tile (``phases``: 1 draw,
    3 draw and count move per tile), reading α, β, Vβ and the seed from
    ``scalars`` and ``key`` on the card.  An empty walk launches nothing."""
    if z.shape[0] == 0:
        return
    build, lib = _lib()
    k_pad = row_width(rows, ndk.shape[1])
    # a walk that moves counts: the grid barrier's arrival counter, or for
    # the tagged walk its ring of two tiles' move records, each CTA's count
    # of finished tiles and the second doc-count buffer
    barrier = ndk_copy = None
    cfg = phases == 3 and walk_config(
        rows.dtype, compute_dtype, noise_mode, k_pad, z.shape[0], row_tile,
        ndk.device, ndk_bytes=ndk.nbytes)
    tagged = bool(cfg) and cfg["pipelined"]
    if tagged:  # the records, then a uint32 count of finished tiles a CTA
        barrier = torch.zeros(RING_TILES * row_tile + -(-cfg["grid"] // 2),
                              dtype=torch.int64, device=ndk.device)
        ndk_copy = ndk.clone()
    elif phases == 3:
        barrier = torch.zeros(1, dtype=torch.int32, device=ndk.device)
    with torch.cuda.device(ndk.device):
        err = lib.lda_gibbs_tiles(
            _ptr(rows), _ROWS_KIND[rows.dtype], rows.shape[1], k_pad, _ptr(ndk),
            ndk.shape[1], _ptr(nk), _ptr(z), _ptr(z_new), _ptr(token_word),
            _ptr(token_doc), _ptr(token_mask),
            _ptr(uniforms) if noise_mode == "external" else None,
            z.shape[0], row_tile, _ptr(scalars), _ptr(key),
            NOISE_MODES.index(noise_mode), CHAINS.index(compute_dtype),
            slot0, phases, _ptr(barrier), _ptr(ndk_copy),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "lda_gibbs_tiles")
    count("launch." + sample_name(rows.dtype, compute_dtype))
    if phases == 3:
        count("walk.tagged_records" if tagged else "walk.two_barrier")


def gibbs_tiles(
    rows: torch.Tensor,         # [v_pad, k_pad] bf16/f32 snapshot, or [V, K] int32 nwk
    ndk: torch.Tensor,          # [M, K] int32 — updated in place
    nk: torch.Tensor,           # [K] int32 — updated in place
    z: torch.Tensor,            # [n] int32 — assignments before the walk
    token_word: torch.Tensor,   # [n] int32
    token_doc: torch.Tensor,    # [n] int32
    token_mask: torch.Tensor,   # [n] int32 — 1 real, 0 padding
    *,
    scalars: torch.Tensor,      # f32 [>= 3]: α, β, Vβ, ... on rows' device
    row_tile: int,
    noise_mode: str = "internal",
    key: Optional[torch.Tensor] = None,       # int64 [1]: the seed (internal)
    uniforms: Optional[torch.Tensor] = None,  # [n, k_pad] f32 (external)
    slot0: int = 0,
    compute_dtype: str = "float32",  # the chain (CHAINS); float32 on int32 rows
) -> torch.Tensor:
    """Walk the tokens in tiles of ``row_tile``, in order: draw each tile,
    then move its ``ndk``/``nk`` counts, before the next tile draws (on the
    card: one launch for the whole walk).  Returns ``z_new``; ``rows`` is
    only read.

    ``scalars`` is a float32 tensor on the tables' device holding α, β and
    Vβ first; ``key`` an int64 tensor there holding the internal seed.
    ``slot0`` is the stream position of token 0 (the internal noise
    counter), so a walk over a slice draws what the whole walk would.
    """
    _check(rows, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms, compute_dtype, scalars, key)
    if row_tile <= 0:
        raise ValueError(f"row_tile {row_tile} must be positive")
    if rows.device.type == "cuda":
        z_new = torch.empty_like(z)
        _launch(ndk, nk, z, z_new, token_doc, token_mask, rows=rows,
                token_word=token_word, uniforms=uniforms, row_tile=row_tile,
                scalars=scalars, key=key, noise_mode=noise_mode, slot0=slot0,
                compute_dtype=compute_dtype, phases=3)
        return z_new
    return gibbs_tiles_plain(
        rows, ndk, nk, z, token_word, token_doc, token_mask, scalars=scalars,
        row_tile=row_tile, noise_mode=noise_mode, key=key, uniforms=uniforms,
        slot0=slot0, compute_dtype=compute_dtype)


def gibbs_tile_sample(rows, ndk, nk, z, token_word, token_doc, token_mask,
                      *, scalars, row_tile, noise_mode="internal", key=None,
                      uniforms=None, slot0=0,
                      compute_dtype="float32") -> torch.Tensor:
    """The draw alone: every token against the given counts, in tiles of
    ``row_tile`` (one launch, the walk with its count move off); returns
    ``z_new`` and moves no count."""
    _check(rows, ndk, nk, z, token_word, token_doc, token_mask, noise_mode,
           uniforms, compute_dtype, scalars, key)
    if rows.device.type == "cpu":
        return sample_plain(
            rows, ndk, nk, z, token_word, token_doc, token_mask,
            scalars=scalars, noise_mode=noise_mode, key=key,
            uniforms=uniforms, slot0=slot0, compute_dtype=compute_dtype)
    z_new = torch.empty_like(z)
    _launch(ndk, nk, z, z_new, token_doc, token_mask, rows=rows,
            token_word=token_word, uniforms=uniforms, row_tile=row_tile,
            scalars=scalars, key=key, noise_mode=noise_mode, slot0=slot0,
            compute_dtype=compute_dtype, phases=1)
    return z_new


def gibbs_tile_update(ndk, nk, z_old, z_new, token_doc, token_mask) -> None:
    """The walk's count move alone: -1 at (doc, z_old), +1 at (doc, z_new)
    in ``ndk``/``nk`` (in place) for every unmasked token.  On the card it
    is the count move's launch on the two tables (integer moves commute, so
    one launch gives what the walk's per-tile moves give), counted under
    ``gibbs_tile_update``."""
    _check_counts(ndk, nk, z_old, token_doc, token_mask,
                  [("z_new", z_new, torch.int32, 1)])
    if ndk.device.type == "cpu":
        update_plain(ndk, nk, z_old, z_new, token_doc, token_mask)
        return
    _move_launch(z_old, z_new, token_mask, None, None, ndk, token_doc, nk)
    count("launch.gibbs_tile_update")


def count_move(z_old: torch.Tensor, z_new: torch.Tensor,
               token_mask: torch.Tensor, *, nwk=None, token_word=None,
               ndk=None, token_doc=None, nk=None,
               z_out: Optional[torch.Tensor] = None) -> None:
    """One launch: -1 at ``z_old``, +1 at ``z_new`` for every unmasked token,
    in place, in each given table (``nwk [V, K]`` by ``token_word``,
    ``ndk [M, K]`` by ``token_doc``, ``nk [K]``).  Integer atomics: exact in
    any order.  Given ``z_out [n]`` (which may be ``z_old`` itself), the same
    launch writes ``z_out = mask ? z_new : z_old``."""
    dev, n = z_old.device, z_old.shape[0]
    expect = [("z_old", z_old, torch.int32, 1), ("z_new", z_new, torch.int32, 1),
              ("token_mask", token_mask, torch.int32, 1)]
    if z_out is not None:
        expect.append(("z_out", z_out, torch.int32, 1))
    given = []
    for name, table, ids_name, ids in (("nwk", nwk, "token_word", token_word),
                                       ("ndk", ndk, "token_doc", token_doc),
                                       ("nk", nk, None, None)):
        if table is None:
            continue
        given.append(table)
        expect.append((name, table, torch.int32, 1 if ids_name is None else 2))
        if ids_name is not None:
            if ids is None:
                raise ValueError(f"{name} needs {ids_name}")
            expect.append((ids_name, ids, torch.int32, 1))
    if not given:
        raise ValueError("count_move needs at least one table")
    _check_tensors(dev, expect)
    k = given[0].shape[-1]
    if any(t.shape[-1] != k for t in given):
        raise ValueError("the tables disagree on the number of topics")
    for name, t, _, ndim in expect:
        if ndim == 1 and name != "nk" and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} tokens, z_old has {n}")
    if dev.type == "cpu":
        count_move_plain(z_old, z_new, token_mask, nwk=nwk,
                         token_word=token_word, ndk=ndk, token_doc=token_doc,
                         nk=nk, z_out=z_out)
        return
    _move_launch(z_old, z_new, token_mask, nwk, token_word, ndk, token_doc, nk,
                 z_out)
    count("launch.count_move")


def _move_launch(z_old, z_new, token_mask, nwk, token_word, ndk, token_doc,
                 nk, z_out=None) -> None:
    """One launch of ``lda_count_move`` on the given (checked) tables."""
    k = next(t for t in (nwk, ndk, nk) if t is not None).shape[-1]
    build, lib = _lib()
    with torch.cuda.device(z_old.device):
        err = lib.lda_count_move(
            _ptr(nwk), _ptr(ndk), _ptr(nk), k, _ptr(token_word),
            _ptr(token_doc), _ptr(token_mask), _ptr(z_old), _ptr(z_new),
            _ptr(z_out), z_old.shape[0], torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_count_move")
