"""Deferred word-topic updates: the layout planner and K2, the count rebuild.

Counterpart of ``ldagibbssampling_tpu/ops/count_kernel.py``.  In the
deferred tier, blocks sample against a sweep-stale snapshot of ``nwk`` and
the table is rebuilt once per sweep from the final assignments.

- ``DeferredPlan`` and ``stack_plans`` are copied verbatim (numpy; the
  reference module imports jax, so the port keeps its own copy), and so is
  the reference's planner, as ``plan_deferred_plain``.  ``plan_deferred``
  makes the same plan, every field and dtype, in host C++
  (``csrc/deferred_plan.cc``, built by ``ops/_build.build_host`` at first
  use and bound with ``ctypes``) in time linear in the tokens: the numpy
  planner's per-block sorts and per-run loops take about a minute at rung
  3's full size on an 8-core host (``benchmarks/plan.py``).  A library that does not build or load raises; nothing falls back
  to the numpy planner, which only the tests call.  The plan's
  rebuild-stream arrays (``row_gather_idx``, ``w_local``, ``tile_stripe``)
  exist for the TPU's matrix unit; the GPU rebuild does not read them, but
  they stay so the plan equals the reference's field by field.
- K2 (``csrc/count_kernel.cu``): ``rebuild_counts`` recounts
  ``nwk [v_pad, k_pad]`` and ``nk [k_pad]`` from ``z`` with integer atomics,
  and ``cast_mirror`` writes the bf16 snapshot for the next sweep.
  ``build_nwk``, the reference's entry point, runs both
  (``emit_mirror=True``) or the rebuild alone (``emit_mirror=False``) and
  returns the reference's layout.  ``rebuild_counts`` and ``cast_mirror``
  also write into given tensors (``out=``): the deferred sweep
  (``ops/gibbs._deferred_sweep_``, eager or captured) rebuilds straight
  into its padded tables and snapshot.

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it; any other device raises, and so does a failed
launch.  Each launch adds 1 to the recorder's counter ``launch.<kernel>``,
each call of a plain version to ``plain.<kernel>``
(``evaluation/tracing.count``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.evaluation.tracing import count

# grid cap of the grid-stride kernels: 16 blocks of 256 threads per SM of an H100
_MAX_BLOCKS = 132 * 16
# rebuild_counts keeps a k_pad-wide int32 histogram in (static-limit) shared memory
_MAX_K_PAD = 48 * 1024 // 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_ALIGN = 8  # row-gather granularity: (block, stripe) runs start/end on 8-slot edges


@dataclasses.dataclass(frozen=True)
class DeferredPlan:
    """Static token layout for the deferred-``nwk`` fused sweep.

    The sweep arrays (``token_word/doc/mask``) are doc-major across blocks and
    word-sorted within each block, with every (block, vocab-stripe) run padded
    to a multiple of 8 slots; padding slots copy their run's last word/doc so
    block word order stays non-decreasing (the gather's ``indices_are_sorted``
    hint).  ``perm[i]`` is the source index of slot ``i`` in the caller's real
    token stream (-1 for padding).

    The rebuild stream is the word-sorted concatenation, per vocab stripe, of
    those runs: ``row_gather_idx`` indexes ``z.reshape(-1, 8)`` rows,
    ``w_local`` carries stripe-relative word ids (-1 neutralizes padding), and
    ``tile_stripe`` maps each ``tile``-token kernel step to its output stripe.
    """

    # sweep layout
    token_word: np.ndarray   # int32 [T_pad]
    token_doc: np.ndarray    # int32 [T_pad]
    token_mask: np.ndarray   # int32 [T_pad]
    perm: np.ndarray         # int64 [T_pad]; source real-token index, -1 = pad
    block_size: int
    # rebuild layout
    row_gather_idx: np.ndarray  # int32 [T2 // 8] — rows of z.reshape(-1, 8)
    w_local: np.ndarray         # int32 [T2]; -1 for padding slots
    tile_stripe: np.ndarray     # int32 [T2 // tile]
    v_loc: int
    v_pad: int
    tile: int
    # guards (f32 exactness bounds; see module docstring)
    max_word_freq: int

    @property
    def num_tokens(self) -> int:
        return int(self.token_word.shape[0])


def plan_deferred_plain(
    token_word: np.ndarray,
    token_doc: np.ndarray,
    vocab_size: int,
    block_size: int,
    *,
    v_loc: int = 128,
    tile: int = 2048,
) -> DeferredPlan:
    """Host-side, one-off layout for the deferred sweep (see ``DeferredPlan``):
    the reference's numpy planner, verbatim; the tests' reference for
    ``plan_deferred``.

    ``token_word/doc`` are the REAL (unpadded) doc-major token stream; blocks
    are filled greedily so that, after per-stripe 8-slot alignment padding,
    each block holds exactly ``block_size`` slots (~1–2% padding at Zipf word
    statistics).
    """
    token_word = np.asarray(token_word, np.int32)
    token_doc = np.asarray(token_doc, np.int32)
    t_real = int(token_word.shape[0])
    # largest multiple-of-8 divisor of block_size within the requested tile
    tile = min(tile, block_size)
    while tile >= _ALIGN and block_size % tile:
        tile -= _ALIGN
    if tile < _ALIGN or block_size % tile or tile % _ALIGN:
        raise ValueError(f"block_size {block_size} has no multiple-of-8 tile <= requested")
    v_pad = max(_round_up(max(vocab_size, 1), v_loc), v_loc)
    num_stripes = v_pad // v_loc

    # ---- pass 1: greedy block fill (real tokens per block, incl. alignment)
    blocks: list[tuple[int, int]] = []  # (start, n_real)
    pos = 0
    while pos < t_real:
        n = min(block_size, t_real - pos)
        while True:
            stripes = token_word[pos : pos + n] // v_loc
            runs = np.bincount(stripes, minlength=1)
            padded = int(((runs + _ALIGN - 1) // _ALIGN * _ALIGN).sum())
            if padded <= block_size:
                break
            n -= (padded - block_size)
            if n <= 0:
                raise ValueError("block_size too small for stripe alignment")
        blocks.append((pos, n))
        pos += n
    if not blocks:
        blocks = [(0, 0)]
    nb = len(blocks)
    t_pad = nb * block_size

    out_word = np.zeros(t_pad, np.int32)
    out_doc = np.zeros(t_pad, np.int32)
    out_mask = np.zeros(t_pad, np.int32)
    out_perm = np.full(t_pad, -1, np.int64)
    # (stripe, block) -> (slot_start, n_real, n_slots); filled in pass 2
    run_start = np.zeros((num_stripes, nb), np.int64)
    run_slots = np.zeros((num_stripes, nb), np.int64)
    run_real = np.zeros((num_stripes, nb), np.int64)

    for b, (start, n) in enumerate(blocks):
        w = token_word[start : start + n]
        order = np.argsort(w, kind="stable")
        w_sorted = w[order]
        src = start + order
        stripes_present = np.unique(w_sorted // v_loc) if n else np.array([], np.int64)
        cursor = b * block_size
        lo = 0
        for s in stripes_present:
            hi = int(np.searchsorted(w_sorted, (int(s) + 1) * v_loc, side="left"))
            rn = hi - lo
            slots = _round_up(rn, _ALIGN)
            sl = slice(cursor, cursor + rn)
            out_word[sl] = w_sorted[lo:hi]
            out_doc[sl] = token_doc[src[lo:hi]]
            out_mask[sl] = 1
            out_perm[sl] = src[lo:hi]
            if slots > rn:  # alignment pads copy the run's last word/doc
                out_word[cursor + rn : cursor + slots] = w_sorted[hi - 1]
                out_doc[cursor + rn : cursor + slots] = token_doc[src[hi - 1]]
            run_start[s, b] = cursor
            run_slots[s, b] = slots
            run_real[s, b] = rn
            cursor += slots
            lo = hi
        if cursor < (b + 1) * block_size and n:
            # block-tail pads keep the last word so the block stays sorted
            out_word[cursor : (b + 1) * block_size] = out_word[cursor - 1]
            out_doc[cursor : (b + 1) * block_size] = out_doc[cursor - 1]

    # ---- pass 2: rebuild stream (stripe-major concatenation of runs)
    stripe_slots = run_slots.sum(axis=1)
    stripe_padded = np.maximum(
        (stripe_slots + tile - 1) // tile * tile, tile
    )  # >=1 tile so every output stripe block is initialized
    t2 = int(stripe_padded.sum())
    row_gather_idx = np.zeros(t2 // _ALIGN, np.int32)
    w_local = np.full(t2, -1, np.int32)
    tile_stripe = np.empty(t2 // tile, np.int32)
    out = 0
    for s in range(num_stripes):
        seg_start = out
        for b in range(nb):
            slots = int(run_slots[s, b])
            if not slots:
                continue
            st = int(run_start[s, b])
            rn = int(run_real[s, b])
            row_gather_idx[out // _ALIGN : (out + slots) // _ALIGN] = (
                st // _ALIGN + np.arange(slots // _ALIGN, dtype=np.int32)
            )
            w_local[out : out + rn] = out_word[st : st + rn] - s * v_loc
            out += slots
        out = seg_start + int(stripe_padded[s])
        tile_stripe[seg_start // tile : out // tile] = s

    max_word_freq = (
        int(np.bincount(token_word, minlength=1).max()) if t_real else 0
    )
    return DeferredPlan(
        token_word=out_word, token_doc=out_doc, token_mask=out_mask,
        perm=out_perm, block_size=block_size,
        row_gather_idx=row_gather_idx, w_local=w_local,
        tile_stripe=tile_stripe, v_loc=v_loc, v_pad=v_pad, tile=tile,
        max_word_freq=max_word_freq,
    )


def _declare_plan(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.lda_plan_create.restype = vp
    lib.lda_plan_create.argtypes = [vp, i64, i64, i64, i64, i64, ctypes.POINTER(i32)]
    for name in ("lda_plan_num_blocks", "lda_plan_rebuild_len",
                 "lda_plan_max_word_freq"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [vp]
    lib.lda_plan_fill.restype = i32
    lib.lda_plan_fill.argtypes = [vp] * 10 + [i32]
    lib.lda_plan_destroy.restype = None
    lib.lda_plan_destroy.argtypes = [vp]


def _plan_lib() -> ctypes.CDLL:
    """The planner library, built if needed; raises ``RuntimeError`` naming
    the compiler's or the loader's error (no fallback)."""
    from ldagibbssampling_tpu_torch.ops import _build

    return _build.load_host("deferred_plan", _declare_plan)


def _plan_threads() -> int:
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)


def _plan_error(code: int, v_pad: int) -> Exception:
    if code == 1:
        return ValueError("block_size too small for stripe alignment")
    if code == 2:
        return ValueError("token_word holds a negative word id")
    if code == 3:
        return IndexError(f"token_word holds a word id >= v_pad {v_pad}")
    return MemoryError("the deferred plan does not fit in host memory")


def plan_deferred(
    token_word: np.ndarray,
    token_doc: np.ndarray,
    vocab_size: int,
    block_size: int,
    *,
    v_loc: int = 128,
    tile: int = 2048,
) -> DeferredPlan:
    """``plan_deferred_plain``'s plan (the reference's, every field and
    dtype), made by ``csrc/deferred_plan.cc``; the same ``ValueError``s."""
    return _plan_native(token_word, token_doc, vocab_size, block_size,
                        v_loc=v_loc, tile=tile, threads=_plan_threads())


def _plan_native(token_word, token_doc, vocab_size: int, block_size: int, *,
                 v_loc: int, tile: int, threads: int) -> DeferredPlan:
    """``plan_deferred`` on ``threads`` threads (the plan does not depend on
    their number)."""
    token_word = np.ascontiguousarray(token_word, np.int32)
    token_doc = np.ascontiguousarray(token_doc, np.int32)
    if token_word.ndim != 1 or token_doc.ndim != 1:
        raise ValueError("token_word and token_doc must be 1-d")
    t_real = int(token_word.shape[0])
    if token_doc.shape[0] < t_real:
        raise IndexError(f"token_doc has {token_doc.shape[0]} tokens, "
                         f"token_word {t_real}")
    # largest multiple-of-8 divisor of block_size within the requested tile
    tile = min(tile, block_size)
    while tile >= _ALIGN and block_size % tile:
        tile -= _ALIGN
    if tile < _ALIGN or block_size % tile or tile % _ALIGN:
        raise ValueError(f"block_size {block_size} has no multiple-of-8 tile <= requested")
    v_pad = max(_round_up(max(vocab_size, 1), v_loc), v_loc)

    lib = _plan_lib()
    err = ctypes.c_int32(0)
    h = lib.lda_plan_create(token_word.ctypes.data, t_real, v_loc, v_pad,
                            block_size, tile, ctypes.byref(err))
    if not h:
        raise _plan_error(err.value, v_pad)
    try:
        t_pad = lib.lda_plan_num_blocks(h) * block_size
        t2 = lib.lda_plan_rebuild_len(h)
        sweep = [np.empty(t_pad, np.int32) for _ in range(3)]
        perm = np.empty(t_pad, np.int64)
        rebuild = (np.empty(t2 // _ALIGN, np.int32), np.empty(t2, np.int32),
                   np.empty(t2 // tile, np.int32))
        code = lib.lda_plan_fill(
            h, token_word.ctypes.data, token_doc.ctypes.data,
            *(a.ctypes.data for a in (*sweep, perm, *rebuild)), threads)
        if code:
            raise _plan_error(code, v_pad)
        max_word_freq = int(lib.lda_plan_max_word_freq(h))
    finally:
        lib.lda_plan_destroy(h)
    return DeferredPlan(
        token_word=sweep[0], token_doc=sweep[1], token_mask=sweep[2],
        perm=perm, block_size=block_size, row_gather_idx=rebuild[0],
        w_local=rebuild[1], tile_stripe=rebuild[2], v_loc=v_loc, v_pad=v_pad,
        tile=tile, max_word_freq=max_word_freq,
    )


def stack_plans(plans: list["DeferredPlan"]) -> dict:
    """Uniformize per-shard plans to one static shape and stack ``[P, ...]``.

    The shard_map'd AD-LDA program needs identical shapes on every shard:
    shorter shards get all-pad trailing blocks (mask 0, last word/doc repeated
    so block word order stays non-decreasing) and all-pad trailing rebuild
    tiles (``w_local == -1`` rows assigned to the LAST stripe, which every
    plan visits — tile stripes stay non-decreasing and every output stripe
    stays initialized).
    """
    if not plans:
        raise ValueError("no plans to stack")
    p0 = plans[0]
    if any((q.v_loc, q.v_pad, q.tile, q.block_size)
           != (p0.v_loc, p0.v_pad, p0.tile, p0.block_size) for q in plans):
        raise ValueError("plans disagree on static layout parameters")
    block, tile = p0.block_size, p0.tile
    t_pad = max(q.num_tokens for q in plans)
    nt = max(q.tile_stripe.shape[0] for q in plans)
    last_stripe = p0.v_pad // p0.v_loc - 1

    def pad_sweep(q: "DeferredPlan"):
        n = q.num_tokens
        tw = np.full(t_pad, q.token_word[-1] if n else 0, np.int32)
        td = np.full(t_pad, q.token_doc[-1] if n else 0, np.int32)
        tm = np.zeros(t_pad, np.int32)
        pm = np.full(t_pad, -1, np.int64)
        tw[:n], td[:n], tm[:n], pm[:n] = (
            q.token_word, q.token_doc, q.token_mask, q.perm)
        return tw, td, tm, pm

    def pad_rebuild(q: "DeferredPlan"):
        qt = q.tile_stripe.shape[0]
        ts = np.full(nt, last_stripe, np.int32)
        wl = np.full(nt * tile, -1, np.int32)
        rg = np.zeros(nt * tile // _ALIGN, np.int32)
        ts[:qt] = q.tile_stripe
        wl[: qt * tile] = q.w_local
        rg[: qt * tile // _ALIGN] = q.row_gather_idx
        return ts, wl, rg

    sw = [pad_sweep(q) for q in plans]
    rb = [pad_rebuild(q) for q in plans]
    return {
        "token_word": np.stack([s[0] for s in sw]),
        "token_doc": np.stack([s[1] for s in sw]),
        "token_mask": np.stack([s[2] for s in sw]),
        "perm": np.stack([s[3] for s in sw]),
        "tile_stripe": np.stack([r[0] for r in rb]),
        "w_local": np.stack([r[1] for r in rb]),
        "row_gather_idx": np.stack([r[2] for r in rb]),
        "v_loc": p0.v_loc, "v_pad": p0.v_pad, "tile": tile,
        "block_size": block, "num_tiles": nt,
        "max_word_freq": max(q.max_word_freq for q in plans),
    }


@functools.cache
def _lib():
    """The library with its entry points' types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("count_kernel")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lda_rebuild_counts.restype = i32
    lib.lda_rebuild_counts.argtypes = [vp, vp, vp, i64, vp, i64, i32, vp, i32, vp]
    lib.lda_cast_mirror.restype = i32
    lib.lda_cast_mirror.argtypes = [vp, vp, i64, i32, vp]
    return _build, lib


def _check_tokens(z, token_word, token_mask):
    dev = z.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("z", z), ("token_word", token_word),
                    ("token_mask", token_mask)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(
                f"{name}: want 1-d int32 on {dev}, got {t.dtype} "
                f"{t.dim()}-d on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[0] != z.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} tokens, z has {z.shape[0]}")


def rebuild_counts_plain(z, token_word, token_mask, *, v_pad: int, k_pad: int):
    count("plain.rebuild_counts")
    real = token_mask > 0
    zr = z[real].long()
    one = torch.ones_like(zr, dtype=torch.int32)
    nwk = torch.zeros(v_pad * k_pad, dtype=torch.int32, device=z.device)
    nwk.index_put_((token_word[real].long() * k_pad + zr,), one, accumulate=True)
    nk = torch.zeros(k_pad, dtype=torch.int32, device=z.device)
    nk.index_put_((zr,), one, accumulate=True)
    return nwk.view(v_pad, k_pad), nk


def _check_out(name: str, t: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
        raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rebuild_counts(z: torch.Tensor, token_word: torch.Tensor,
                   token_mask: torch.Tensor, *, v_pad: int, k_pad: int,
                   out: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
    """Exact ``(nwk [v_pad, k_pad], nk [k_pad])`` int32 counts of the
    unmasked tokens' ``(word, z)`` pairs; written into ``out`` (both
    tables, contiguous) where it is given, which it returns."""
    _check_tokens(z, token_word, token_mask)
    if k_pad % 128 or k_pad > _MAX_K_PAD or v_pad <= 0:
        raise ValueError(f"k_pad {k_pad} (multiple of 128, <= {_MAX_K_PAD}), "
                         f"v_pad {v_pad}")
    if out is not None:
        _check_out("nwk", out[0], (v_pad, k_pad), torch.int32, z.device)
        _check_out("nk", out[1], (k_pad,), torch.int32, z.device)
    if z.device.type == "cpu":
        tables = rebuild_counts_plain(z, token_word, token_mask,
                                      v_pad=v_pad, k_pad=k_pad)
        if out is None:
            return tables
        for o, t in zip(out, tables):
            o.copy_(t)
        return out
    build, lib = _lib()
    nwk, nk = out if out is not None else (
        torch.empty((v_pad, k_pad), dtype=torch.int32, device=z.device),
        torch.empty(k_pad, dtype=torch.int32, device=z.device))
    with torch.cuda.device(z.device):
        err = lib.lda_rebuild_counts(
            z.data_ptr(), token_word.data_ptr(), token_mask.data_ptr(),
            z.shape[0], nwk.data_ptr(), v_pad, k_pad, nk.data_ptr(),
            _MAX_BLOCKS, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_rebuild_counts")
    count("launch.rebuild_counts")
    return nwk, nk


def cast_mirror_plain(nwk: torch.Tensor) -> torch.Tensor:
    count("plain.cast_mirror")
    return nwk.to(torch.bfloat16)


def cast_mirror(nwk: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 copy (round-to-nearest-even) of an int32 count table, written
    into ``out`` (contiguous, of the table's shape) where it is given."""
    if nwk.dtype != torch.int32 or not nwk.is_contiguous():
        raise ValueError(f"nwk must be contiguous int32, got {nwk.dtype}")
    if out is not None:
        _check_out("out", out, tuple(nwk.shape), torch.bfloat16, nwk.device)
    if nwk.device.type == "cpu":
        mirror = cast_mirror_plain(nwk)
        return mirror if out is None else out.copy_(mirror)
    if nwk.device.type != "cuda":
        raise ValueError(f"unsupported device {nwk.device}")
    build, lib = _lib()
    mirror = out if out is not None else torch.empty(
        nwk.shape, dtype=torch.bfloat16, device=nwk.device)
    with torch.cuda.device(nwk.device):
        err = lib.lda_cast_mirror(
            nwk.data_ptr(), mirror.data_ptr(), nwk.numel(), _MAX_BLOCKS,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_cast_mirror")
    count("launch.cast_mirror")
    return mirror


def build_nwk(z: torch.Tensor, token_word: torch.Tensor,
              token_mask: torch.Tensor, *, vocab_size: int, num_topics: int,
              v_pad: int, k_pad: int, emit_mirror: bool = True):
    """Rebuild the word-topic table from ``z`` (sweep-layout order).

    Returns ``(nwk [V, K], nk [K], mirror [v_pad, k_pad] bf16)`` in the
    reference's layout and orientation; ``nwk`` and ``nk`` are int32 views of
    the padded tables, ``mirror`` is the next sweep's snapshot.  With
    ``emit_mirror=False`` it returns ``(nwk, nk)`` and casts no snapshot.
    """
    nwk_p, nk_p = rebuild_counts(z, token_word, token_mask,
                                 v_pad=v_pad, k_pad=k_pad)
    nwk, nk = nwk_p[:vocab_size, :num_topics], nk_p[:num_topics]
    if not emit_mirror:
        return nwk, nk
    return nwk, nk, cast_mirror(nwk_p)
