"""K3 of the v1-draw sweep: the log-space Gumbel draw of one block.

Counterpart of ``ldagibbssampling_tpu/ops/pallas_gibbs.py`` (``_sample_kernel``
through ``pallas_sample_block``), which the XLA sweep calls per block when
``use_pallas=True``.  The CUDA kernel ``gibbs_block_sample`` is in
``csrc/sample_kernel.cu``: a warp per token reads the token's ``nwk`` row by
word id and its ``ndk`` row by doc id straight from the int32 tables (the
reference takes pre-gathered ``[B, K]`` float32 copies) and draws

    argmax_k  log(nwk - e + β) + log(ndk - e + α) - log(nk - e + Vβ) - log(-log u)

with the self-exclusion ``e = (k == z_old)`` unmasked, as the reference has
it.  No count moves: the whole block draws against the block-start counts,
so a block is one launch.  Noise modes: ``deterministic`` (no noise),
``external`` (caller uniforms ``[n, K]``) and ``internal`` (Philox4x32-10
keyed per sweep, counter (token slot, topic group of 4): the bits of
``ops/fused_kernel.philox_uniforms``).

On the card the conditional's three logs are table lookups, with the bits
of the formula: each CTA of a persistent grid (``block_sample_config``)
first computes ``log(nk - e + Vβ)`` for every topic and e in {0, 1}, and
``log(j + β)``, ``log(j + α)`` for the counts ``j = c - e`` in
``[-1, LOG_TABLE - 1)`` (``float(c) - e`` is ``float(c - e)`` exactly below
2^24); a count past the table computes its log.  The tables come from each
launch's α, β, Vβ and ``nk``: nothing is kept between launches.

α, β, Vβ and the internal seed are device values: ``scalars`` (float32
α, β, Vβ first, as ``ops/_device.sweep_scalars`` lays them out) and ``key``
(int64, the seed's 64 bits, ``_device.seed_word``), which the kernel reads
through pointers when it starts.  A CUDA graph of a sweep
(``ops/graphs.py``) replays the launch with the values its buffers hold
then.

``sample_block`` takes a CUDA tensor to the kernel and a CPU tensor to the
plain PyTorch version ``sample_block_plain``; any other device raises, and so
does a failed launch.  A launch adds 1 to the recorder's counter
``launch.gibbs_block_sample``, a call of the plain version to
``plain.gibbs_block_sample`` (``evaluation/tracing.count``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ldagibbssampling_tpu_torch.evaluation.tracing import count
from ldagibbssampling_tpu_torch.ops.fused_kernel import (
    NOISE_MODES, _check_tensors, philox_uniforms)

# entries of the kernel's log(j + β) and log(j + α) tables, j from -1
# (csrc/sample_kernel.cu, kLogTable)
LOG_TABLE = 2048
_MASK64 = 2**64 - 1


def sample_block_plain(nwk, ndk, nk, z_old, token_word, token_doc, *,
                       scalars, noise_mode, key=None, uniforms=None,
                       slot0=0) -> torch.Tensor:
    """The plain version of ``sample_block``, in the kernel's operation
    order, on the same ``scalars`` and ``key``."""
    count("plain.gibbs_block_sample")
    f32 = torch.float32
    n, k = z_old.shape[0], nk.shape[0]
    dev = nwk.device
    alpha, beta, vbeta = scalars[:3].to(device=dev, dtype=f32).unbind()
    e = (torch.arange(k, device=dev)[None, :] == z_old[:, None].long()).to(f32)
    score = (torch.log(nwk[token_word.long()].to(f32) - e + beta)
             + torch.log(ndk[token_doc.long()].to(f32) - e + alpha)) \
        - torch.log(nk.to(f32)[None, :] - e + vbeta)
    if noise_mode != "deterministic":
        if noise_mode == "internal":
            k4 = -(-k // 4) * 4
            seed = int(key.reshape(-1)[0]) & _MASK64
            uniforms = philox_uniforms(seed, slot0, n, k4, dev)[:, :k]
        score = score + (-torch.log(-torch.log(uniforms)))
    return score.argmax(dim=1).to(torch.int32)  # first index of the maximum


@functools.cache
def _lib():
    """The library with its entry points' types, set once per process."""
    from ldagibbssampling_tpu_torch.ops import _build

    lib = _build.load("sample_kernel")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lda_block_sample_config.restype = i32
    lib.lda_block_sample_config.argtypes = [i32, i32, i64,
                                            *[ctypes.POINTER(i32)] * 4]
    lib.lda_block_sample.restype = i32
    lib.lda_block_sample.argtypes = [
        vp, vp, vp, i32, vp, vp, vp, vp, vp, i64, vp, vp, i32, i64, i32, i32,
        i32, vp]
    return _build, lib


def block_sample_config(noise_mode: str, num_topics: int, n_tokens: int,
                        device=None) -> dict:
    """How ``sample_block`` launches on the card: ``grid`` CTAs (as many as
    the occupancy query fits at once, at most one warp per token) of
    ``threads``, ``smem`` bytes of tables per CTA, and ``nk_table`` (the
    ``nk`` logs in shared memory; above ~27,000 topics they are computed
    per element).  Queried once per device, mode, K and block length."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return dict(_config(NOISE_MODES.index(noise_mode), num_topics, n_tokens,
                        index))


@functools.lru_cache(maxsize=None)
def _config(mode: int, num_topics: int, n_tokens: int, device: int) -> dict:
    build, lib = _lib()
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = lib.lda_block_sample_config(mode, num_topics, n_tokens,
                                          *(ctypes.byref(x) for x in out))
    build.check(lib, err, "lda_block_sample_config")
    grid, threads, smem, nk_table = (x.value for x in out)
    return dict(grid=grid, threads=threads, smem=smem, nk_table=bool(nk_table))


def sample_block(
    nwk: torch.Tensor,          # [V, K] int32 — block-start word-topic counts
    ndk: torch.Tensor,          # [M, K] int32 — block-start doc-topic counts
    nk: torch.Tensor,           # [K] int32 — block-start topic totals
    z_old: torch.Tensor,        # [n] int32
    token_word: torch.Tensor,   # [n] int32
    token_doc: torch.Tensor,    # [n] int32
    *,
    scalars: torch.Tensor,                    # f32 [>= 3]: α, β, Vβ, ...
    noise_mode: str = "internal",
    key: Optional[torch.Tensor] = None,       # int64 [1]: the seed (internal)
    uniforms: Optional[torch.Tensor] = None,  # [n, K] f32 (external)
    slot0: int = 0,
) -> torch.Tensor:
    """Draw every token against the given counts; returns ``z_new [n]``
    int32 (masked tokens too: the caller keeps their ``z_old``).

    ``scalars`` is a float32 tensor on the tables' device holding α, β and
    Vβ first; ``key`` an int64 tensor there holding the internal seed.
    ``slot0`` is the stream position of token 0 (the internal noise
    counter)."""
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if noise_mode == "internal" and key is None:
        raise ValueError("noise_mode='internal' requires key")
    n, k = z_old.shape[0], nk.shape[0]
    expect = [("nwk", nwk, torch.int32, 2), ("ndk", ndk, torch.int32, 2),
              ("nk", nk, torch.int32, 1), ("z_old", z_old, torch.int32, 1),
              ("token_word", token_word, torch.int32, 1),
              ("token_doc", token_doc, torch.int32, 1)]
    if noise_mode == "external":
        if uniforms is None:
            raise ValueError("noise_mode='external' requires uniforms")
        expect.append(("uniforms", uniforms, torch.float32, 2))
        if tuple(uniforms.shape) != (n, k):
            raise ValueError(f"uniforms {tuple(uniforms.shape)} != {(n, k)}")
    expect.append(("scalars", scalars, torch.float32, 1))
    if scalars.shape[0] < 3:
        raise ValueError(f"scalars {tuple(scalars.shape)}: α, β, Vβ needed")
    if key is not None:
        expect.append(("key", key, torch.int64, 1))
    _check_tensors(nwk.device, expect)
    if nwk.shape[1] != k or ndk.shape[1] != k:
        raise ValueError(
            f"topics: nwk {nwk.shape[1]}, ndk {ndk.shape[1]}, nk {k}")
    if token_word.shape[0] != n or token_doc.shape[0] != n:
        raise ValueError(f"token ids {token_word.shape[0]}/{token_doc.shape[0]}"
                         f" != z_old {n}")
    if nwk.device.type == "cpu":
        return sample_block_plain(
            nwk, ndk, nk, z_old, token_word, token_doc, scalars=scalars,
            noise_mode=noise_mode, key=key, uniforms=uniforms, slot0=slot0)
    z_new = torch.empty_like(z_old)
    if n == 0:  # nothing to launch
        return z_new
    cfg = _config(NOISE_MODES.index(noise_mode), k, n, nwk.device.index)
    build, lib = _lib()
    with torch.cuda.device(nwk.device):
        err = lib.lda_block_sample(
            nwk.data_ptr(), ndk.data_ptr(), nk.data_ptr(), k, z_old.data_ptr(),
            z_new.data_ptr(), token_word.data_ptr(), token_doc.data_ptr(),
            uniforms.data_ptr() if noise_mode == "external" else None, n,
            scalars.data_ptr(), None if key is None else key.data_ptr(),
            NOISE_MODES.index(noise_mode), slot0, cfg["grid"], cfg["smem"],
            int(cfg["nk_table"]), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "lda_block_sample")
    count("launch.gibbs_block_sample")
    return z_new
