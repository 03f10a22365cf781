"""The CUDA kernels against their plain PyTorch versions on the card, at small
shapes.  Marked ``cuda``: without a GPU every test skips.  On a machine with
one (and without jax, hence ``--noconftest``):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: none.  On the card both sides run the same float32 operations
in the same order with the same libdevice ``logf``, so z and every count
must be equal in all three noise modes (K3: on the unmasked tokens, whose
draws the sweep keeps); the bf16 chains round to bf16 after the same
operations on both sides.  K4's bf16 variant is native packed bf16 (one
rounding per op) against PyTorch's float32-then-round ops, which give the
same bits (the double-rounding condition, ``csrc/dtype_probe.cu``): bitwise,
as its float32 variant.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.models.state import init_state
from ldagibbssampling_tpu_torch.ops import count_kernel as ck
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
from ldagibbssampling_tpu_torch.scripts import vpu_dtype_probe as probe

pytestmark = pytest.mark.cuda

K, V, M = 37, 500, 40
HYPER = dict(alpha=0.5, beta=0.1, vbeta=float(np.float32(V) * np.float32(0.1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _setup(device, seed=0, t=6000, block=1024):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.2, size=t) - 1) % V).astype(np.int32)
    td = (np.arange(t) * M // t).astype(np.int32)
    plan = ck.plan_deferred(tw, td, V, block)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K, seed=seed,
                    device=device)
    toks = [torch.from_numpy(np.array(a)).to(device)
            for a in (plan.token_word, plan.token_doc, plan.token_mask)]
    return plan, st, toks


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k1_walk_equals_plain(cuda, mode):
    plan, st, (tw, td, tm) = _setup(cuda)
    nwk = torch.nn.functional.pad(st.nwk, (0, 128 - K, 0, plan.v_pad - V))
    mirror = ck.cast_mirror(nwk.contiguous())
    uniforms = torch.rand((tw.shape[0], 128), device=cuda) * 0.999 + 5e-4
    out = []
    for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
        ndk, nk = st.ndk.clone(), st.nk.clone()
        z = walk(mirror, ndk, nk, st.z, tw, td, tm, row_tile=256,
                 noise_mode=mode, seed=77, uniforms=uniforms, **HYPER)
        out.append((z, ndk, nk))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chain,rows", [
    ("bfloat16", "bfloat16"), ("bf16p", "bfloat16"), ("float32", "float32"),
    ("bfloat16", "float32"), ("bf16p", "float32")])
@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k1_chains_walk_equals_plain(cuda, chain, rows, mode):
    plan, st, (tw, td, tm) = _setup(cuda, seed=7)
    nwk = torch.nn.functional.pad(st.nwk, (0, 128 - K, 0, plan.v_pad - V))
    snap = (ck.cast_mirror(nwk.contiguous()) if rows == "bfloat16"
            else nwk.float().contiguous())
    uniforms = torch.rand((tw.shape[0], 128), device=cuda) * 0.999 + 5e-4
    name = fk.sample_name(snap.dtype, chain)
    launched = fk.LAUNCHES[name]
    out = []
    for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
        ndk, nk = st.ndk.clone(), st.nk.clone()
        z = walk(snap, ndk, nk, st.z, tw, td, tm, row_tile=256, noise_mode=mode,
                 seed=80, uniforms=uniforms, compute_dtype=chain, **HYPER)
        out.append((z, ndk, nk))
    torch.cuda.synchronize()
    assert fk.LAUNCHES[name] > launched
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k1_live_table_walk_and_move_equal_plain(cuda, mode):
    plan, st, (tw, td, tm) = _setup(cuda, seed=3)
    uniforms = torch.rand((tw.shape[0], 128), device=cuda) * 0.999 + 5e-4
    out = []
    for walk, move in ((fk.gibbs_tiles, fk.count_move),
                       (fk.gibbs_tiles_plain, fk.count_move_plain)):
        nwk, ndk, nk = st.nwk.clone(), st.ndk.clone(), st.nk.clone()
        z = walk(nwk, ndk, nk, st.z, tw, td, tm, row_tile=256,
                 noise_mode=mode, seed=78, uniforms=uniforms, **HYPER)
        move(st.z, z, tm, nwk=nwk, token_word=tw)
        out.append((z, nwk, ndk, nk))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k3_equals_plain(cuda, mode):
    plan, st, (tw, td, tm) = _setup(cuda, seed=4)
    uniforms = torch.rand((tw.shape[0], K), device=cuda) * 0.999 + 5e-4
    z = [f(st.nwk, st.ndk, st.nk, st.z, tw, td, noise_mode=mode, seed=79,
           uniforms=uniforms, slot0=5, **HYPER)
         for f in (sk.sample_block, sk.sample_block_plain)]
    torch.cuda.synchronize()
    real = tm > 0
    assert torch.equal(z[0][real], z[1][real])


def test_tile_update_alone_equals_plain(cuda):
    plan, st, (tw, td, tm) = _setup(cuda, seed=6)
    z_new = torch.randint(0, K, st.z.shape, device=cuda, dtype=torch.int32)
    out = []
    for kernel in (True, False):
        ndk, nk = st.ndk.clone(), st.nk.clone()
        if kernel:
            launched = fk.LAUNCHES["gibbs_tile_update"]
            fk.gibbs_tile_update(ndk, nk, st.z, z_new, td, tm)
            assert fk.LAUNCHES["gibbs_tile_update"] == launched + 1
        else:
            fk.update_plain(ndk, nk, st.z, z_new, td, tm)
        out.append((ndk, nk))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_count_move_equals_plain(cuda):
    plan, st, (tw, td, tm) = _setup(cuda, seed=5)
    z_new = torch.randint(0, K, st.z.shape, device=cuda, dtype=torch.int32)
    out = []
    for move in (fk.count_move, fk.count_move_plain):
        t = dict(nwk=st.nwk.clone(), ndk=st.ndk.clone(), nk=st.nk.clone())
        move(st.z, z_new, tm, token_word=tw, token_doc=td, **t)
        out.append(t)
    torch.cuda.synchronize()
    for name in ("nwk", "ndk", "nk"):
        assert torch.equal(out[0][name], out[1][name]), name


def test_k2_equals_plain(cuda):
    plan, st, (tw, _, tm) = _setup(cuda, seed=1)
    nwk, nk = ck.rebuild_counts(st.z, tw, tm, v_pad=plan.v_pad, k_pad=128)
    nwk_p, nk_p = ck.rebuild_counts_plain(st.z, tw, tm, v_pad=plan.v_pad, k_pad=128)
    assert torch.equal(nwk, nwk_p) and torch.equal(nk, nk_p)
    assert torch.equal(ck.cast_mirror(nwk), ck.cast_mirror_plain(nwk))
    casts = ck.LAUNCHES["cast_mirror"]
    out = ck.build_nwk(st.z, tw, tm, vocab_size=V, num_topics=K,
                       v_pad=plan.v_pad, k_pad=128, emit_mirror=False)
    torch.cuda.synchronize()
    assert len(out) == 2 and ck.LAUNCHES["cast_mirror"] == casts
    assert torch.equal(out[0], nwk_p[:V, :K]) and torch.equal(out[1], nk_p[:K])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_probe_equals_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.rand((2048, probe.K), generator=g, device=cuda)
    b = torch.rand((2048, probe.K), generator=g, device=cuda)
    got = probe.dtype_probe(a, b, dtype=dtype)
    want = probe.probe_plain(a, b, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("chain,mirror", [
    ("bfloat16", "bfloat16"), ("bf16p", "float32"), ("float32", "float32")])
def test_deferred_chains_on_card(cuda, chain, mirror):
    rng = np.random.default_rng(2)
    ragged = [[int(x) for x in rng.integers(0, 80, size=60)] for _ in range(30)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=80)
    model = LdaModel(LdaConfig(topic_num=9, block_size=512,
                               kernel_compute_dtype=chain, mirror_dtype=mirror), fc)
    name = fk.sample_name(getattr(torch, mirror), chain)
    launches, casts = fk.LAUNCHES[name], ck.LAUNCHES["cast_mirror"]
    model.sweep(4)
    model.check_counts_consistent()
    assert fk.LAUNCHES[name] > launches
    assert (ck.LAUNCHES["cast_mirror"] > casts) == (mirror == "bfloat16")
    model.optimize_hyperparameters()
    model.sweep(1)
    assert np.isfinite(model.device_log_likelihood())
    model.check_counts_consistent()


@pytest.mark.parametrize("use_pallas,tier,kernel", [
    ("deferred", "deferred", "gibbs_tile_sample"),
    ("fused", "fused", "gibbs_tile_sample_live"),
    (True, "pallas-draw", "gibbs_block_sample"),
    (False, "xla", None),
])
def test_model_on_card_counts_consistent(cuda, use_pallas, tier, kernel):
    rng = np.random.default_rng(2)
    ragged = [[int(x) for x in rng.integers(0, 80, size=60)] for _ in range(30)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=80)
    launches = {**fk.LAUNCHES, **sk.LAUNCHES}
    model = LdaModel(LdaConfig(topic_num=9, block_size=512,
                               use_pallas=use_pallas), fc)
    assert model.state.z.is_cuda and model.kernel_tier == tier
    model.sweep(4)
    model.check_counts_consistent()
    if kernel is not None:
        assert {**fk.LAUNCHES, **sk.LAUNCHES}[kernel] > launches[kernel]


def test_failed_launch_raises(cuda):
    # the C entry point refuses an unknown noise mode with cudaErrorInvalidValue
    build, lib = fk._lib()
    err = lib.lda_gibbs_tiles(None, 0, 128, 128, None, K, None, None, None,
                              None, None, None, None, 0, 256, 0.5, 0.1, 1.0, 7,
                              0, 0, 0, 3, None, None, None)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, err, "lda_gibbs_tiles")


# --- K1's walk: one cooperative launch per call, the chain of the plain
# version at the shapes and layouts that stress its barriers and loads


def _walk_setup(device, *, k, n, v=300, m=20, seed=0, one_doc=False,
                masked=0.05):
    """A consistent state for a walk of ``n`` tokens at ``k`` topics: tables
    counted from ``z``; ``one_doc`` puts every token in document 0."""
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.2, size=n) - 1) % v).astype(np.int32)
    td = (np.zeros(n) if one_doc else np.arange(n) * m // max(n, 1)).astype(np.int32)
    tm = (rng.random(n) >= masked).astype(np.int32)
    st = init_state(tw, td, tm, num_docs=m, vocab_size=v, num_topics=k,
                    seed=seed, device=device)
    toks = [torch.from_numpy(a).to(device) for a in (tw, td, tm)]
    k_pad = -(-k // 128) * 128
    mirror = ck.cast_mirror(torch.nn.functional.pad(st.nwk, (0, k_pad - k)).contiguous())
    return st, toks, mirror


def _both_walks(rows, st, toks, *, row_tile, mode, chain="float32", seed=81,
                slot0=0, uniforms=None):
    out = []
    for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
        ndk, nk = st.ndk.clone(), st.nk.clone()
        z = walk(rows, ndk, nk, st.z, *toks, row_tile=row_tile, noise_mode=mode,
                 seed=seed, uniforms=uniforms, slot0=slot0, compute_dtype=chain,
                 **HYPER)
        out.append((z, ndk, nk))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("chain,rows", [
    ("float32", "bfloat16"), ("bfloat16", "bfloat16"), ("bf16p", "float32"),
    ("float32", "int32")])
def test_k1_walk_doc_shared_tiles_equal_plain(cuda, chain, rows):
    # every token of 4 consecutive tiles in one document: each tile's draws
    # read the doc row the previous tile moved, so a missing barrier or a
    # stale read of ndk/nk changes the draws
    st, toks, mirror = _walk_setup(cuda, k=K, n=4 * 256, one_doc=True, seed=9,
                                   masked=0.0)
    snap = {"bfloat16": mirror, "float32": mirror.float(), "int32": st.nwk}[rows]
    (z, ndk, nk), (zp, ndkp, nkp) = _both_walks(snap, st, toks, row_tile=256,
                                                mode="deterministic", chain=chain)
    assert torch.equal(z, zp) and torch.equal(ndk, ndkp) and torch.equal(nk, nkp)
    assert (z != st.z).any()


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
@pytest.mark.parametrize("k,n,row_tile,pipelined,one_doc", [
    (1000, 3 * 256, 256, True, False),   # k_pad 1024, the row tile the sweep picks
    (128, 2048, 2048, False, False),     # a single-tile block of 2,048 tokens
    (K, 1000, 256, True, False),         # n_tokens not a multiple of row_tile
    (K, 20000, 20000, False, False),     # more tokens in a tile than the grid has teams
    # the two-barrier walk over several tiles: each tile's moves, two
    # barriers, then the next tile's reads of ndk/nk through L2 and its hoist
    (100, 3 * 2048, 2048, False, True),  # the sweep's tiles at K <= 128, one document
    (100, 3 * 2048 + 700, 2048, False, False),  # and a ragged last tile
    (200, 4 * 1024, 1024, False, True),  # the sweep's tiles at 128 < K <= 256
    (2100, 3 * 128 + 50, 128, False, False),  # k_pad 2176: more groups than a team
])
def test_k1_walk_shapes_equal_plain(cuda, mode, k, n, row_tile, pipelined, one_doc):
    st, toks, mirror = _walk_setup(cuda, k=k, n=n, seed=k + n, one_doc=one_doc,
                                   masked=0.0 if one_doc else 0.05)
    cfg = fk.walk_config(mirror.dtype, "float32", mode, mirror.shape[1], n, row_tile)
    assert cfg["pipelined"] == pipelined  # both forms of the walk are held here
    uniforms = torch.rand((n, mirror.shape[1]), device=cuda) * 0.999 + 5e-4
    for rows in (mirror, st.nwk):
        (z, ndk, nk), (zp, ndkp, nkp) = _both_walks(
            rows, st, toks, row_tile=row_tile, mode=mode, uniforms=uniforms)
        assert torch.equal(z, zp) and torch.equal(ndk, ndkp) and torch.equal(nk, nkp)
        assert all((z[s:s + row_tile] != st.z[s:s + row_tile]).any()
                   for s in range(0, n, row_tile))


@pytest.mark.parametrize("k,row_tile,pipelined", [(100, 2048, False),
                                                  (500, 512, True)])
def test_k1_walk_second_ndk_buffer_only_when_pipelined(cuda, k, row_tile,
                                                       pipelined):
    # the one-barrier walk needs a copy of ndk; the two-barrier walk none
    n = 4 * row_tile
    st, toks, mirror = _walk_setup(cuda, k=k, n=n, m=20000, seed=3)
    assert fk.walk_config(mirror.dtype, "float32", "internal", mirror.shape[1], n,
                          row_tile)["pipelined"] == pipelined
    ndk, nk = st.ndk.clone(), st.nk.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    fk.gibbs_tiles(mirror, ndk, nk, st.z, *toks, row_tile=row_tile, seed=2, **HYPER)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    assert (extra >= ndk.nbytes) == pipelined, (extra, ndk.nbytes)


def test_k1_walk_empty_and_all_masked(cuda):
    st, (tw, td, tm), mirror = _walk_setup(cuda, k=K, n=600, seed=4)
    name = fk.sample_name(mirror.dtype)
    launched = fk.LAUNCHES[name]
    ndk, nk = st.ndk.clone(), st.nk.clone()
    empty = fk.gibbs_tiles(mirror, ndk, nk, st.z[:0], tw[:0], td[:0], tm[:0],
                           row_tile=256, seed=1, **HYPER)
    assert empty.shape == (0,) and fk.LAUNCHES[name] == launched  # nothing to launch
    z = fk.gibbs_tiles(mirror, ndk, nk, st.z, tw, td, torch.zeros_like(tm),
                       row_tile=256, seed=1, **HYPER)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[name] == launched + 1
    assert torch.equal(z, st.z) and torch.equal(ndk, st.ndk) and torch.equal(nk, st.nk)


def test_k1_sliced_walk_equals_whole_walk(cuda):
    st, (tw, td, tm), mirror = _walk_setup(cuda, k=K, n=1024, seed=12)
    ndk_all, nk_all = st.ndk.clone(), st.nk.clone()
    z_all = fk.gibbs_tiles(mirror, ndk_all, nk_all, st.z, tw, td, tm,
                           row_tile=256, seed=33, **HYPER)
    ndk, nk = st.ndk.clone(), st.nk.clone()
    parts = [fk.gibbs_tiles(mirror, ndk, nk, st.z[s:s + 512], tw[s:s + 512],
                            td[s:s + 512], tm[s:s + 512], row_tile=256, seed=33,
                            slot0=s, **HYPER) for s in (0, 512)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), z_all)
    assert torch.equal(ndk, ndk_all) and torch.equal(nk, nk_all)


@pytest.mark.parametrize("rows", ["bfloat16", "int32"])
def test_k1_walk_is_one_launch(cuda, rows):
    st, toks, mirror = _walk_setup(cuda, k=K, n=8 * 256, seed=5)
    snap = mirror if rows == "bfloat16" else st.nwk
    name = fk.sample_name(snap.dtype)
    for calls in range(1, 4):
        before = dict(fk.LAUNCHES)
        fk.gibbs_tiles(snap, st.ndk.clone(), st.nk.clone(), st.z, *toks,
                       row_tile=256, seed=calls, **HYPER)
        after = dict(fk.LAUNCHES)
        assert after[name] == before[name] + 1
        assert after["gibbs_tile_update"] == before["gibbs_tile_update"]
        assert after["count_move"] == before["count_move"]
    cfg = fk.walk_config(snap.dtype, "float32", "internal", 128, 8 * 256, 256)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cfg["grid"] >= sms and cfg["grid"] % sms == 0 and cfg["pipelined"]


# --- K3 with its log tables: every lookup against the logf it replaces,
# at the table's edges, the NaN path and shapes that leave the vector loads


def _k3_tables(device, *, k, n, v=40, m=12, seed=0, hot=None, one_word=False,
               offset=0):
    """Random int32 tables and tokens for a K3 draw (the draw needs no
    consistency between them).  ``hot``: counts around it in word 0's row
    and doc 0's row, and every third token on word 0 / doc 0; ``offset``
    shifts the tables by that many int32 in their storage (an unaligned
    row start)."""
    rng = np.random.default_rng(seed)

    def table(rows, hi):
        flat = torch.empty(rows * k + offset, dtype=torch.int32, device=device)
        flat = flat[offset:]
        flat.copy_(torch.from_numpy(rng.integers(0, hi, rows * k).astype(np.int32)))
        return flat.view(rows, k)

    nwk, ndk = table(v, 30), table(m, 12)
    nk = torch.from_numpy((rng.integers(0, 400, k) + 50).astype(np.int32))
    w = rng.integers(0, v, n).astype(np.int32)
    d = np.sort(rng.integers(0, m, n)).astype(np.int32)
    if one_word:
        w[:] = 3
    if hot is not None:
        span = torch.from_numpy(rng.integers(hot - 3, hot + 4, k).astype(np.int32)
                                ).to(device)
        nwk[0] = span
        nwk[0, ::5] = 5 * hot  # far past the table
        ndk[0] = span
        w[::3], d[::3] = 0, 0
    z = rng.integers(0, k, n).astype(np.int32)
    toks = [torch.from_numpy(a).to(device) for a in (z, w, d)]
    return [nwk, ndk, nk.to(device)], toks


def _both_k3(tables, toks, mode, seed=91, **hyper):
    hyper = {**HYPER, **hyper}
    n, k = toks[0].shape[0], tables[2].shape[0]
    uniforms = (torch.rand((n, k), device=tables[0].device) * 0.999 + 5e-4
                if mode == "external" else None)
    out = [f(*tables, *toks, noise_mode=mode, seed=seed, uniforms=uniforms,
             slot0=3, **hyper) for f in (sk.sample_block, sk.sample_block_plain)]
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
@pytest.mark.parametrize("hot", [sk.LOG_TABLE - 2, sk.LOG_TABLE, 3 * sk.LOG_TABLE])
def test_k3_counts_at_and_past_the_table_end_equal_plain(cuda, mode, hot):
    # word 0's and doc 0's counts straddle the table's last entry (c - e =
    # LOG_TABLE - 2) or lie past it, where the kernel computes the logf
    tables, toks = _k3_tables(cuda, k=K, n=3000, hot=hot, seed=hot)
    z, zp = _both_k3(tables, toks, mode)
    assert torch.equal(z, zp)


def test_k3_nan_path_equals_plain(cuda):
    # a masked token whose own topic's cells are 0: e = 1 drives them to -1,
    # log(-1 + beta) is NaN for beta < 1, and NaN wins at its first index,
    # as jnp.argmax has it (the sweep discards such a draw)
    tables, (z_old, w, d) = _k3_tables(cuda, k=K, n=2000, seed=5)
    nwk, ndk, _ = tables
    nan = torch.arange(0, 2000, 7, device=cuda)
    nwk[w[nan].long(), z_old[nan].long()] = 0
    ndk[d[nan].long(), z_old[nan].long()] = 0
    for mode in ("deterministic", "internal"):
        z, zp = _both_k3(tables, (z_old, w, d), mode)
        assert torch.equal(z, zp)
        assert torch.equal(z[nan], z_old[nan])


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
@pytest.mark.parametrize("k,n,offset,nk_table", [
    (1, 300, 0, True),       # one topic: a lane's group of 4 holds one
    (64, 700, 1, True),      # K % 4 == 0 but rows not 16-byte aligned: scalar
    (2100, 400, 0, True),    # K over 2,048: many groups per lane
    (5000, 150, 0, True),    # tables over 48 KB of shared memory
    (30000, 40, 0, False),   # L_nk past a CTA's shared memory: logf per element
])
def test_k3_shapes_equal_plain(cuda, mode, k, n, offset, nk_table):
    assert sk.block_sample_config(mode, k, n)["nk_table"] == nk_table
    tables, toks = _k3_tables(cuda, k=k, n=n, v=20, m=6, seed=k, offset=offset)
    assert (tables[0].data_ptr() % 16 == 0) == (offset == 0)
    z, zp = _both_k3(tables, toks, mode)
    assert torch.equal(z, zp)


def test_k3_ties_take_the_lowest_topic(cuda):
    # equal counts everywhere: every topic but z_old scores the same, so the
    # lowest of them wins
    n, k = 1000, 45
    tables = [torch.full((20, k), 4, dtype=torch.int32, device=cuda),
              torch.full((6, k), 2, dtype=torch.int32, device=cuda),
              torch.full((k,), 300, dtype=torch.int32, device=cuda)]
    rng = np.random.default_rng(2)
    toks = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).to(cuda)
            for hi in (k, 20, 6)]
    z, zp = _both_k3(tables, toks, "deterministic")
    assert torch.equal(z, zp)
    assert torch.equal(z, (toks[0] == 0).to(torch.int32))


def test_k3_empty_block_and_one_word(cuda):
    tables, (z_old, w, d) = _k3_tables(cuda, k=K, n=1500, one_word=True, seed=8)
    launched = sk.LAUNCHES["gibbs_block_sample"]
    empty = sk.sample_block(*tables, z_old[:0], w[:0], d[:0], seed=1, **HYPER)
    assert empty.shape == (0,) and sk.LAUNCHES["gibbs_block_sample"] == launched
    for mode in ("deterministic", "internal"):
        z, zp = _both_k3(tables, (z_old, w, d), mode)
        assert torch.equal(z, zp)


def test_k3_tables_follow_each_launchs_hyperparameters(cuda):
    # a Minka update between sweeps: the next launch must build its tables
    # from its own alpha and beta
    tables, toks = _k3_tables(cuda, k=K, n=4000, seed=13)
    first, first_p = _both_k3(tables, toks, "deterministic")
    second, second_p = _both_k3(tables, toks, "deterministic", alpha=0.013,
                                beta=0.71, vbeta=float(np.float32(V) * np.float32(0.71)))
    assert torch.equal(first, first_p) and torch.equal(second, second_p)
    assert not torch.equal(first, second)


# --- the count move: shared nk histograms flushed per cluster, the optional
# write-back of z


def _move_case(device, *, k=K, n=6000, v=60, m=25, seed=0, sort_words=False,
               one_topic=False):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, v, n).astype(np.int32)
    if sort_words:
        w = np.sort(rng.zipf(1.3, n) % v).astype(np.int32)
    toks = dict(token_word=w, token_doc=rng.integers(0, m, n).astype(np.int32))
    z_old = rng.integers(0, k, n).astype(np.int32)
    z_new = (np.full(n, k - 1) if one_topic else rng.integers(0, k, n)).astype(np.int32)
    mask = (rng.random(n) < 0.93).astype(np.int32)
    tables = dict(nwk=rng.integers(0, 50, (v, k)), ndk=rng.integers(0, 50, (m, k)),
                  nk=rng.integers(0, 5000, k))
    on = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
    return ({n_: on(a) for n_, a in tables.items()},
            {n_: on(a) for n_, a in toks.items()}, on(z_old), on(z_new), on(mask))


def _both_moves(tables, toks, z_old, z_new, mask, names, write_back=None):
    out = []
    for move in (fk.count_move, fk.count_move_plain):
        t = {n: tables[n].clone() for n in names}
        ids = {i: toks[i] for n, i in (("nwk", "token_word"), ("ndk", "token_doc"))
               if n in names}
        zo = z_old.clone()
        z_out = {"alias": zo, "separate": torch.full_like(zo, -7), None: None}[write_back]
        move(zo, z_new, mask, z_out=z_out, **ids, **t)
        out.append((t, zo if z_out is None else z_out))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("names", [("nwk",), ("ndk",), ("nk",), ("nwk", "ndk", "nk")])
@pytest.mark.parametrize("case", ["random", "word_sorted", "one_topic"])
def test_count_move_tables_equal_plain(cuda, names, case):
    tables, toks, z_old, z_new, mask = _move_case(
        cuda, seed=len(names), sort_words=case == "word_sorted",
        one_topic=case == "one_topic")
    (t, _), (tp, _) = _both_moves(tables, toks, z_old, z_new, mask, names)
    for name in names:
        assert torch.equal(t[name], tp[name]), name
        assert not torch.equal(t[name], tables[name]), name


@pytest.mark.parametrize("write_back", ["alias", "separate"])
def test_count_move_writes_back_z(cuda, write_back):
    tables, toks, z_old, z_new, mask = _move_case(cuda, seed=4, sort_words=True)
    launched = fk.LAUNCHES["count_move"]
    (t, z), (tp, zp) = _both_moves(tables, toks, z_old, z_new, mask,
                                   ("nwk", "ndk", "nk"), write_back)
    assert fk.LAUNCHES["count_move"] == launched + 1
    assert all(torch.equal(t[n], tp[n]) for n in t)
    assert torch.equal(z, zp)
    assert torch.equal(z, torch.where(mask > 0, z_new, z_old))


@pytest.mark.parametrize("k,n", [(13000, 3000), (K, 1), (K, 100_003)])
def test_count_move_shapes_equal_plain(cuda, k, n):
    # K past the shared histogram (nk by global atomics, no clusters), one
    # token, and a run that leaves the last cluster partly empty
    tables, toks, z_old, z_new, mask = _move_case(cuda, k=k, n=n, v=30, m=9,
                                                  seed=k + n, sort_words=True)
    (t, z), (tp, zp) = _both_moves(tables, toks, z_old, z_new, mask,
                                   ("nwk", "ndk", "nk"), "alias")
    assert all(torch.equal(t[name], tp[name]) for name in t)
    assert torch.equal(z, zp)


# --- the modules of the chains, the other backends and the stream on the card


def _small_corpus(seed=0, docs=40, vocab=60):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(10, 60)))]
              for _ in range(docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def test_prefetch_on_card_keeps_order_and_values(cuda):
    from ldagibbssampling_tpu_torch.data.stream import prefetch_to_device

    batches = [np.full((4, 1000), i, np.float32) for i in range(9)]
    out = [x.clone() for x in prefetch_to_device(iter(batches), depth=3,
                                                 device=cuda)]
    assert [x.device.type for x in out] == ["cuda"] * 9
    for i, x in enumerate(out):
        assert torch.equal(x.cpu(), torch.from_numpy(batches[i]))


def test_chains_unrecorded_sweeps_make_no_host_sync(cuda):
    from ldagibbssampling_tpu_torch.models.chains import ChainSet

    cs = ChainSet(LdaConfig(topic_num=5, block_size=256, chains=3), _small_corpus(),
                  device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cs.sweep(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cs.check_counts_consistent()


def test_cvb0_on_card_repeats_bitwise(cuda):
    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model

    cfg = LdaConfig(topic_num=6, backend="cvb0", block_size=128, seed=2)
    a, b = (Cvb0Model(cfg, _small_corpus(), device=cuda) for _ in range(2))
    a.sweep(3)
    b.sweep(1)
    b.sweep(2)
    for name in ("gamma", "ndk", "nwk", "nk"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    a.check_invariants()


@pytest.mark.parametrize("backend", ["cvb0", "svi", "smc", "warp"])
def test_backends_on_card_sweep_and_resume_where_they_checkpoint(cuda, backend,
                                                                  tmp_path):
    from ldagibbssampling_tpu_torch.backends import make_backend

    fc = _small_corpus(seed=3)
    cfg = LdaConfig(topic_num=4, backend=backend, block_size=128, seed=1)
    ref = make_backend(cfg, fc, device=cuda)
    ref.sweep(3)
    phi = ref.phi()
    assert phi.shape == (4, 60) and np.isfinite(phi).all()
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, rtol=1e-4)
    if not hasattr(ref, "save_checkpoint"):
        return
    a = make_backend(cfg, fc, device=cuda)
    a.sweep(1)
    a.save_checkpoint(tmp_path)
    b = make_backend(cfg, fc, device=cuda)
    assert b.restore_checkpoint(tmp_path) == 1
    b.sweep(2)
    np.testing.assert_array_equal(b.phi(), phi)
    np.testing.assert_array_equal(b.theta(), ref.theta())
