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
from ldagibbssampling_tpu_torch.ops._device import seed_word, sweep_scalars
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
from ldagibbssampling_tpu_torch.scripts import vpu_dtype_probe as probe

pytestmark = pytest.mark.cuda

K, V, M = 37, 500, 40
def sweep_values(device, seed, alpha=0.5, beta=0.1):
    """K1's and K3's device values: α, β, Vβ (and K·α) as the sweep forms
    them, and the seed's word."""
    return dict(scalars=torch.from_numpy(sweep_scalars(alpha, beta, V, K)).to(device),
                key=torch.tensor([seed_word(seed)], dtype=torch.int64, device=device))


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
                 noise_mode=mode, uniforms=uniforms, **sweep_values(cuda, 77))
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
                 uniforms=uniforms, compute_dtype=chain, **sweep_values(cuda, 80))
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
                 noise_mode=mode, uniforms=uniforms, **sweep_values(cuda, 78))
        move(st.z, z, tm, nwk=nwk, token_word=tw)
        out.append((z, nwk, ndk, nk))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k3_equals_plain(cuda, mode):
    plan, st, (tw, td, tm) = _setup(cuda, seed=4)
    uniforms = torch.rand((tw.shape[0], K), device=cuda) * 0.999 + 5e-4
    z = [f(st.nwk, st.ndk, st.nk, st.z, tw, td, noise_mode=mode,
           uniforms=uniforms, slot0=5, **sweep_values(cuda, 79))
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
    scalars = sweep_values(cuda, 0)["scalars"]
    err = lib.lda_gibbs_tiles(None, 0, 128, 128, None, K, None, None, None,
                              None, None, None, None, 0, 256, scalars.data_ptr(),
                              None, 7, 0, 0, 3, None, None, None)
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
                 uniforms=uniforms, slot0=slot0, compute_dtype=chain,
                 **sweep_values(rows.device, seed))
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
    fk.gibbs_tiles(mirror, ndk, nk, st.z, *toks, row_tile=row_tile,
                   **sweep_values(cuda, 2))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    assert (extra >= ndk.nbytes) == pipelined, (extra, ndk.nbytes)


def test_k1_walk_empty_and_all_masked(cuda):
    st, (tw, td, tm), mirror = _walk_setup(cuda, k=K, n=600, seed=4)
    name = fk.sample_name(mirror.dtype)
    launched = fk.LAUNCHES[name]
    ndk, nk = st.ndk.clone(), st.nk.clone()
    empty = fk.gibbs_tiles(mirror, ndk, nk, st.z[:0], tw[:0], td[:0], tm[:0],
                           row_tile=256, **sweep_values(cuda, 1))
    assert empty.shape == (0,) and fk.LAUNCHES[name] == launched  # nothing to launch
    z = fk.gibbs_tiles(mirror, ndk, nk, st.z, tw, td, torch.zeros_like(tm),
                       row_tile=256, **sweep_values(cuda, 1))
    torch.cuda.synchronize()
    assert fk.LAUNCHES[name] == launched + 1
    assert torch.equal(z, st.z) and torch.equal(ndk, st.ndk) and torch.equal(nk, st.nk)


def test_k1_sliced_walk_equals_whole_walk(cuda):
    st, (tw, td, tm), mirror = _walk_setup(cuda, k=K, n=1024, seed=12)
    ndk_all, nk_all = st.ndk.clone(), st.nk.clone()
    z_all = fk.gibbs_tiles(mirror, ndk_all, nk_all, st.z, tw, td, tm,
                           row_tile=256, **sweep_values(cuda, 33))
    ndk, nk = st.ndk.clone(), st.nk.clone()
    parts = [fk.gibbs_tiles(mirror, ndk, nk, st.z[s:s + 512], tw[s:s + 512],
                            td[s:s + 512], tm[s:s + 512], row_tile=256, slot0=s,
                            **sweep_values(cuda, 33)) for s in (0, 512)]
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
                       row_tile=256, **sweep_values(cuda, calls))
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


def _both_k3(tables, toks, mode, seed=91, alpha=0.5, beta=0.1):
    n, k = toks[0].shape[0], tables[2].shape[0]
    dev = tables[0].device
    uniforms = (torch.rand((n, k), device=dev) * 0.999 + 5e-4
                if mode == "external" else None)
    values = sweep_values(dev, seed, alpha, beta)
    out = [f(*tables, *toks, noise_mode=mode, uniforms=uniforms, slot0=3, **values)
           for f in (sk.sample_block, sk.sample_block_plain)]
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
    empty = sk.sample_block(*tables, z_old[:0], w[:0], d[:0],
                            **sweep_values(cuda, 1))
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
                                beta=0.71)
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


def test_phi_moments_on_card_equal_cpu_and_make_no_host_sync(cuda):
    """The chains' φ R̂ moments stay on the card, a mid-window draw makes
    no host sync, and they are bitwise the same class's fed CPU copies of
    the same draws; the summaries agree within relative 1e-9."""
    from ldagibbssampling_tpu_torch.evaluation.diagnostics import PhiRhatAccumulator
    from ldagibbssampling_tpu_torch.models.chains import ChainSet

    cs = ChainSet(LdaConfig(topic_num=5, block_size=256, chains=3, seed=5),
                  _small_corpus(), device=cuda)
    cpu = PhiRhatAccumulator(3, 5, cs.corpus.vocab_size)
    for i in range(4):
        cs.sweep(1)
        draw = cs._phi_draw()
        cpu.add([(ids, x.cpu()) for ids, x in draw], i // 2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cs.record_phi(i // 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert cs.phi_accum.mean.device.type == "cuda"
    assert torch.equal(cs.phi_accum.mean.cpu(), cpu.mean)
    assert torch.equal(cs.phi_accum.m2.cpu(), cpu.m2)
    got, want = cs.r_hat_phi(), cpu.result()
    assert got["perms"] == want["perms"] and got["n_cells"] == want["n_cells"]
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=0)


def test_phi_moments_that_do_not_fit_raise(cuda):
    """No host fallback: moments larger than the card's free memory raise
    an error that names their shape and size, before allocating."""
    from ldagibbssampling_tpu_torch.evaluation.diagnostics import PhiRhatAccumulator

    c, k, v = 64, 500, 1_000_000
    acc = PhiRhatAccumulator(c, k, v)
    draw = torch.zeros((1, 1, 1), device=cuda).expand(c, k, v)
    with pytest.raises(torch.cuda.OutOfMemoryError,
                       match=r"\[2, 64, 500, 1000000\].*GiB"):
        acc.add(draw, 0)
    assert acc.mean is None and acc.draws == 0


@pytest.mark.parametrize("draw", ["gumbel", "inverse_cdf"])
def test_batched_chains_equal_chains_in_turn_on_card(cuda, draw):
    """The batched sweep of four chains against the same chains run one
    after another (one single-chain XLA-tier sweep function each, the same
    states and generators): z and every table bitwise on the card."""
    import dataclasses

    from ldagibbssampling_tpu_torch.models.chains import ChainSet
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    cfg = LdaConfig(topic_num=K, block_size=256, chains=4, seed=3, draw_method=draw)
    cs = ChainSet(cfg, _small_corpus(seed=4), device=cuda)
    init = [dataclasses.replace(s, z=s.z.clone(), ndk=s.ndk.clone(),
                                nwk=s.nwk.clone(), nk=s.nk.clone())
            for s in cs.states]
    cs.sweep(3)
    pc = cs._padded
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask, cs.doc_lengths,
                        alpha=cfg.alpha, beta=cfg.beta, block_size=cs.block_size,
                        draw_method=draw, use_pallas=False, num_topics=K,
                        device=cuda)
    for c, s in enumerate(init):
        want = run(s, n_sweeps=3, generator=torch.Generator().manual_seed(s.seed))
        got = cs.chain_state(c)
        for name in ("z", "ndk", "nwk", "nk"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (c, name)
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


# --- the captured sweeps (ops/graphs.py): each replay against the eager
# sweep from the same state, seeds and noise, bitwise, across a change of
# alpha and beta between calls


def _graph_setup(device, seed=0, block=256):
    fc = _small_corpus(seed=seed, docs=60, vocab=200)
    pc = fc.pad_to(block)
    st = init_state(pc.token_word, pc.token_doc, pc.token_mask,
                    num_docs=pc.num_docs, vocab_size=pc.vocab_size, num_topics=K,
                    seed=seed, device=device)
    toks = [torch.from_numpy(np.asarray(a, np.int32)).to(device)
            for a in (pc.token_word, pc.token_doc, pc.token_mask)]
    dl = torch.from_numpy(fc.doc_lengths().astype(np.int32)).to(device)
    return pc, st, toks, dl


def _card_noise(device, t_pad, draw, k=K, chains=None):
    def noise(sweep, c=0):
        g = torch.Generator(device=device).manual_seed(1000 * c + sweep)
        shape = (t_pad, k) if draw != "inverse_cdf" else (t_pad,)
        u = torch.rand(shape, generator=g, device=device) * 0.999 + 5e-4
        return -torch.log(-torch.log(u)) if draw == "gumbel" else u
    return noise


@pytest.mark.parametrize("use_pallas,draw,mode", [
    (False, "gumbel", "internal"), (False, "gumbel", "external"),
    (False, "gumbel", "deterministic"), (False, "inverse_cdf", "internal"),
    (False, "inverse_cdf", "external"), (True, "gumbel", "internal"),
    (True, "gumbel", "external"), (True, "gumbel", "deterministic")])
def test_captured_sweeps_equal_eager_on_card(cuda, use_pallas, draw, mode):
    from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep, make_sweep_fn, sweep_seed

    pc, st, (tw, td, tm), dl = _graph_setup(cuda, seed=5)
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                        dl.cpu().numpy(), alpha=0.5, beta=0.1, block_size=256,
                        draw_method=draw, use_pallas=use_pallas, num_topics=K,
                        noise_mode=mode, device=cuda)
    kind = "v1" if use_pallas else draw
    noise = _card_noise(cuda, pc.num_tokens, kind) if mode == "external" else None
    gen, gen_eager = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    got = want = st
    for (a, b), n in (((0.5, 0.1), 2), ((0.013, 0.71), 1), ((0.5, 0.1), 3)):
        got = run(got, a, b, n_sweeps=n, generator=gen, noise=noise)
        for _ in range(n):
            want = gibbs_sweep(
                want, tw, td, tm, dl, alpha=a, beta=b, block_size=256,
                draw_method=draw, use_pallas=use_pallas, noise_mode=mode,
                seed=sweep_seed(gen_eager) if mode == "internal" else 0,
                noise=None if noise is None else noise(want.sweep))
        torch.cuda.synchronize()
        for name in ("z", "ndk", "nwk", "nk"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    (graph,) = run.graphs.values()
    assert graph.graph is not None and graph.replays == 6


@pytest.mark.parametrize("draw,mode", [("gumbel", "internal"),
                                       ("gumbel", "external"),
                                       ("inverse_cdf", "internal")])
def test_captured_chains_equal_eager_on_card(cuda, draw, mode):
    import dataclasses

    from ldagibbssampling_tpu_torch.models.chains import ChainSet
    from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep_chains, sweep_seed

    cfg = LdaConfig(topic_num=K, block_size=256, chains=3, seed=6, draw_method=draw)
    cs = ChainSet(cfg, _small_corpus(seed=6, docs=60, vocab=200), device=cuda,
                  noise_mode=mode)
    st = cs._stacks[cuda]
    tables = (st.z, st.ndk, st.nwk, st.nk)
    gens = [torch.Generator().set_state(g.get_state()) for g in cs.generators]
    card_noise = _card_noise(cuda, cs._padded.num_tokens, draw)

    def noise(c, sweep):
        return card_noise(sweep, c)
    sweep = 0
    for a, b, n in ((0.5, 0.1, 2), (0.02, 0.6, 1), (0.5, 0.1, 2)):
        cs.config = dataclasses.replace(cfg, alpha=a, beta=b)
        cs.sweep(n, noise=noise if mode == "external" else None)
        for _ in range(n):
            tables = gibbs_sweep_chains(
                *tables, *cs._tokens[cuda], alpha=a, beta=b,
                block_size=cs.block_size, draw_method=draw, noise_mode=mode,
                seeds=[sweep_seed(g) for g in gens] if mode == "internal" else (),
                noise=(torch.stack([noise(c, sweep) for c in range(3)])
                       if mode == "external" else None))
            sweep += 1
        got = cs._stacks[cuda]
        for name, want in zip(("z", "ndk", "nwk", "nk"), tables):
            assert torch.equal(getattr(got, name), want), name
    assert cs._graphs[cuda].replays == 5
    cs.check_counts_consistent()


def test_captured_draw_counts_its_kernels_per_replay(cuda):
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    pc, st, _, dl = _graph_setup(cuda, seed=7)
    blocks = pc.num_tokens // 256
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                        alpha=0.5, beta=0.1, block_size=256, use_pallas=True,
                        num_topics=K, device=cuda)
    before = (sk.LAUNCHES["gibbs_block_sample"], fk.LAUNCHES["count_move"])
    out = run(st, n_sweeps=3, generator=torch.Generator().manual_seed(1))
    # the warm-up sweep ran its kernels; the capture ran none; 3 replays
    assert (sk.LAUNCHES["gibbs_block_sample"] - before[0],
            fk.LAUNCHES["count_move"] - before[1]) == (4 * blocks, 4 * blocks)
    run(out, n_sweeps=2, generator=torch.Generator().manual_seed(2))
    assert (sk.LAUNCHES["gibbs_block_sample"] - before[0],
            fk.LAUNCHES["count_move"] - before[1]) == (6 * blocks, 6 * blocks)
    (graph,) = run.graphs.values()
    assert set(graph.per_replay.values()) == {blocks}
    # the graph's own count of its kernels, and its set-up timed whole
    assert graph.nodes >= 2 * blocks
    assert graph.setup_s > graph.capture_s > 0


def test_failed_capture_raises_and_runs_no_sweep_eagerly(cuda):
    # a sweep body that reads a value on the host cannot be captured: the
    # call raises, and every later call raises too (no eager fallback)
    from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph

    _, st, _, _ = _graph_setup(cuda, seed=8)
    ran = []

    def body(bufs, scalars, key, generators, noise):
        ran.append(float(bufs[3].sum()))  # a host sync
        bufs[0].add_(1)

    z = st.z.clone()
    g = SweepGraph(body, (st.z, st.ndk, st.nwk, st.nk), vocab_size=200,
                   num_topics=K, noise_mode="deterministic")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            g((st.z, st.ndk, st.nwk, st.nk), 0.5, 0.1, 1)
        assert g.graph is None and g.replays == 0
    assert len(ran) == 2  # the two warm-up sweeps; no sweep ran instead
    torch.cuda.synchronize()
    assert torch.equal(st.z, z)  # the input is untouched


# --- the captured kernel tiers (deferred: K1's cooperative walk, K2's
# rebuild and the snapshot; fused: K1's walk and the count move per block)
# against their eager sweeps, bitwise, across a change of alpha and beta


def _tier_layout(tier, k, seed=0, t=12_000, block=2048):
    """A Zipf corpus in ``tier``'s layout at ``k`` topics: the deferred plan
    (block 2,048: row tiles of 512 at K = 500, the one-barrier walk; one
    tile of 2,048 at K = 100, the two-barrier walk) or ``pad_to`` +
    ``sort_within_blocks``; its state on the card."""
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.2, size=t) - 1) % V).astype(np.int32)
    td = (np.arange(t) * M // t).astype(np.int32)
    if tier == "deferred":
        layout = ck.plan_deferred(tw, td, V, block)
    else:
        ptr = np.zeros(M + 1, np.int32)
        np.cumsum(np.bincount(td, minlength=M), out=ptr[1:])
        layout, _ = FlatCorpus(tw, td, ptr, V).pad_to(block).sort_within_blocks(block)
    st = init_state(layout.token_word, layout.token_doc, layout.token_mask,
                    num_docs=M, vocab_size=V, num_topics=k, seed=seed,
                    device="cuda")
    return layout, st


@pytest.mark.parametrize("tier,k,chain,mirror,mode", [
    ("deferred", 500, "float32", "bfloat16", "internal"),   # one barrier a tile
    ("deferred", 500, "float32", "bfloat16", "external"),
    ("deferred", 500, "bf16p", "float32", "internal"),
    ("deferred", 100, "float32", "bfloat16", "internal"),   # two barriers a tile
    ("deferred", 100, "bfloat16", "float32", "external"),
    ("fused", 500, "float32", "bfloat16", "internal"),
    ("fused", 500, "float32", "bfloat16", "external"),
])
def test_captured_kernel_tiers_equal_eager_on_card(cuda, tier, k, chain, mirror, mode):
    from ldagibbssampling_tpu_torch.ops.gibbs import (
        _deferred_sweep_impl, fused_gibbs_sweep, make_sweep_fn, sweep_seed)

    layout, st = _tier_layout(tier, k, seed=k)
    tw, td, tm = (torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
                  for a in (layout.token_word, layout.token_doc, layout.token_mask))
    run = make_sweep_fn(layout.token_word, layout.token_doc, layout.token_mask,
                        alpha=0.5, beta=0.1, block_size=2048, use_pallas=tier,
                        num_topics=k, deferred_plan=layout if tier == "deferred" else None,
                        device=cuda, noise_mode=mode, kernel_compute_dtype=chain,
                        mirror_dtype=mirror)
    k_pad = -(-k // 128) * 128
    cfg = fk.walk_config(torch.int32 if tier == "fused" else getattr(torch, mirror),
                         chain, mode, k_pad, 2048, run.row_tile)
    assert cfg["pipelined"] == (k == 500)

    def noise(sweep):
        g = torch.Generator(device=cuda).manual_seed(100 + sweep)
        u = torch.rand((layout.num_tokens, k_pad), generator=g, device=cuda)
        return u * 0.999 + 5e-4
    gen, gen_eager = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    got, want = st, st
    snap = want_snap = None
    for (a, b), n in (((0.5, 0.1), 2), ((0.013, 0.71), 1), ((0.5, 0.1), 3)):
        kw = dict(n_sweeps=n, generator=gen, noise=noise if mode == "external" else None)
        if tier == "deferred":
            got, snap = run.with_mirror(got, a, b, snap, **kw)
        else:
            got = run(got, a, b, **kw)
        for _ in range(n):
            eager = dict(noise_mode=mode,
                         seed=sweep_seed(gen_eager) if mode == "internal" else 0,
                         uniforms=noise(want.sweep) if mode == "external" else None)
            if tier == "deferred":
                want, want_snap = _deferred_sweep_impl(
                    want, tw, td, tm, a, b, row_tile=run.row_tile, v_pad=layout.v_pad,
                    mirror=want_snap, compute_dtype=chain, mirror_dtype=mirror, **eager)
            else:
                want = fused_gibbs_sweep(want, tw, td, tm, a, b, block_size=2048,
                                         row_tile=run.row_tile, **eager)
        torch.cuda.synchronize()
        for name in ("z", "ndk", "nwk", "nk"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        if tier == "deferred":
            assert torch.equal(snap, want_snap)
    (graph,) = run.graphs.values()
    assert graph.graph is not None and graph.replays == 6
    assert (got.z != st.z).any()


@pytest.mark.parametrize("tier", ["deferred", "fused"])
def test_captured_kernel_tier_replay_is_one_graph_launch_and_one_walk(cuda, tier):
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    layout, st = _tier_layout(tier, K, seed=3)
    blocks = 1 if tier == "deferred" else layout.num_tokens // 2048
    run = make_sweep_fn(layout.token_word, layout.token_doc, layout.token_mask,
                        alpha=0.5, beta=0.1, block_size=2048, use_pallas=tier,
                        num_topics=K, deferred_plan=layout if tier == "deferred" else None,
                        device=cuda)
    name = fk.sample_name(torch.bfloat16 if tier == "deferred" else torch.int32)

    def call(state, mirror, n, seed):
        gen = torch.Generator().manual_seed(seed)
        if tier == "deferred":  # the snapshot carried, as LdaModel carries it
            return run.with_mirror(state, mirror=mirror, n_sweeps=n, generator=gen)
        return run(state, n_sweeps=n, generator=gen), None

    before = {**fk.LAUNCHES, **ck.LAUNCHES}
    out, snap = call(st, None, 3, 1)
    torch.cuda.synchronize()
    after = {**fk.LAUNCHES, **ck.LAUNCHES}
    # the warm-up sweep ran its kernels, the capture none, then 3 replays;
    # the deferred tier's cold start casts one snapshot more
    want = ({name: 4, "rebuild_counts": 4, "cast_mirror": 5, "count_move": 0}
            if tier == "deferred" else
            {name: 4 * blocks, "count_move": 4 * blocks, "rebuild_counts": 0})
    assert {n: after[n] - before[n] for n in want} == want
    (graph,) = run.graphs.values()
    assert {n: c for (_, n), c in graph.per_replay.items()} == {
        n: c // 4 for n, c in want.items() if c and n != "cast_mirror"} | (
        {"cast_mirror": 1} if tier == "deferred" else {})
    # the runtime's calls of a call of two sweeps (the CUDA activity records
    # them; a run where it recorded nothing on the card is tried again)
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call(out, snap, 2, 2)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            break
    assert sum(n.startswith("cudaGraphLaunch") for n in names) == 2  # one a sweep
    assert not [n for n in names if n.startswith(("cudaLaunchCooperativeKernel",
                                                  "cudaLaunchKernel"))]


def test_refused_cooperative_capture_raises_and_runs_no_sweep_eagerly(cuda, monkeypatch):
    """A stream capture that refuses K1's cooperative launch fails the
    graph's first call, and every later one, with the launch's error: no
    sweep runs eagerly instead and the state is untouched.  The refusal is
    the card's code for a cooperative grid it will not launch
    (cudaErrorCooperativeLaunchTooLarge), returned by the C entry point for
    the launches made inside a capture."""
    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    build, lib = fk._lib()

    class Refusing:
        def __getattr__(self, attr):
            return getattr(lib, attr)

        def lda_gibbs_tiles(self, *args):
            if torch.cuda.is_current_stream_capturing():
                return 82  # cudaErrorCooperativeLaunchTooLarge
            return lib.lda_gibbs_tiles(*args)

    monkeypatch.setattr(fk, "_lib", lambda: (build, Refusing()))
    layout, st = _tier_layout("deferred", K, seed=4)
    run = make_sweep_fn(layout.token_word, layout.token_doc, layout.token_mask,
                        alpha=0.5, beta=0.1, block_size=2048, num_topics=K,
                        deferred_plan=layout, device=cuda)
    keep = [t.clone() for t in (st.z, st.ndk, st.nwk, st.nk)]
    name = fk.sample_name(torch.bfloat16)
    walks = fk.LAUNCHES[name]
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="lda_gibbs_tiles failed: CUDA error 82"):
            run.with_mirror(st, mirror=None, n_sweeps=2,
                            generator=torch.Generator().manual_seed(1))
        (graph,) = run.graphs.values()
        assert graph.graph is None and graph.replays == 0
        assert fk.LAUNCHES[name] == walks + calls  # the warm-up sweeps alone
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((st.z, st.ndk, st.nwk, st.nk), keep))


def test_model_captured_deferred_reads_minka_updates(cuda):
    """``LdaModel.sweep`` replays the deferred graph; a Minka update between
    calls reaches the next replay: bitwise the eager sweeps at the same α,
    β and seeds, the snapshot carried across calls."""
    from ldagibbssampling_tpu_torch.ops.gibbs import _deferred_sweep_impl, sweep_seed

    rng = np.random.default_rng(5)
    ragged = [[int(x) for x in rng.integers(0, 200, size=int(rng.integers(40, 90)))]
              for _ in range(80)]
    model = LdaModel(LdaConfig(topic_num=K, block_size=512),
                     FlatCorpus.from_ragged(ragged, vocab_size=200))
    assert model.kernel_tier == "deferred"
    plan = model._plan
    tw, td, tm = (torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
                  for a in (plan.token_word, plan.token_doc, plan.token_mask))
    gen = torch.Generator().set_state(model.generator.get_state())
    want, snap = model.state, None
    for n in (2, 1, 2):
        a, b = model.alpha, model.beta
        model.sweep(n)
        for _ in range(n):
            want, snap = _deferred_sweep_impl(
                want, tw, td, tm, a, b, row_tile=model._run_sweeps.row_tile,
                v_pad=plan.v_pad, mirror=snap, seed=sweep_seed(gen))
        torch.cuda.synchronize()
        for name in ("z", "ndk", "nwk", "nk"):
            assert torch.equal(getattr(model.state, name), getattr(want, name)), name
        assert torch.equal(model._mirror, snap)
        model.optimize_hyperparameters()
        assert (model.alpha, model.beta) != (a, b)
    model.check_counts_consistent()
    (graph,) = model._run_sweeps.graphs.values()
    assert graph.replays == 5


# --- SMC's absorb and SVI's step captured (backends/smc.SmcGraph,
# backends/svi.SviGraph on ops/graphs.StepGraph) against their eager forms
# on the card, bitwise; the resample's gated kernels against their plain
# versions


def _smc_models(monkeypatch, threshold, chunk, seed=4):
    from ldagibbssampling_tpu_torch.backends import smc

    monkeypatch.setattr(smc, "NOISE_BLOCK", 128)  # replays cross blocks
    fc = _small_corpus(seed=seed, docs=30, vocab=50)
    cfg = LdaConfig(topic_num=5, alpha=0.3, beta=0.07, seed=seed, backend="smc")
    kw = dict(num_particles=8, ess_threshold=threshold, chunk_size=chunk)
    return fc, smc.SmcModel(cfg, fc, **kw), smc.SmcModel(cfg, fc, **kw)


def _smc_eager_pass(model, first: bool, chunk: int, noise) -> tuple:
    from ldagibbssampling_tpu_torch.backends.smc import smc_absorb

    t = model._tw.shape[0]
    st = model._tables()
    pass_seed = int(torch.randint(0, 2**63 - 1, (), generator=model.generator))
    for pos in range(0, t, chunk):
        c = min(chunk, t - pos)
        g, rg = (model._noise(pass_seed, pos, c) if noise is None else
                 (x.to("cuda") for x in noise(pos, c)))
        st = smc_absorb(*st, model._tw, model._td, first, pos,
                        alpha=model.config.alpha, beta=model.config.beta,
                        ess_threshold=model.ess_threshold, num_steps=c,
                        gumbels=g, resample_gumbels=rg)
    (model.ndk, model.nwk, model.nk, model.z, model.logw) = st
    return tuple(x.clone() for x in st)


@pytest.mark.parametrize("mode", ["internal", "external"])
@pytest.mark.parametrize("threshold", [0.0, 0.9])
def test_captured_smc_equals_eager_on_card(cuda, monkeypatch, mode, threshold):
    fc, got, ref = _smc_models(monkeypatch, threshold, chunk=100)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.gumbel(size=(fc.num_tokens, 8, 5)).astype(np.float32))
    rg = torch.from_numpy(rng.gumbel(size=(fc.num_tokens, 8, 8)).astype(np.float32))

    def noise(pos, c):
        return g[pos:pos + c], rg[pos:pos + c]
    ext = noise if mode == "external" else None
    resamples = 0
    for first in (True, False):  # the first pass, then a rejuvenation pass
        want = _smc_eager_pass(ref, first, 100, ext)
        got.sweep(1, noise=ext)
        torch.cuda.synchronize()
        for name, w in zip(("ndk", "nwk", "nk", "z", "logw"), want):
            assert torch.equal(getattr(got, name), w), name
        resamples += got.resamples
    assert (resamples > 0) == (threshold > 0), resamples
    sg = got.graph.graph
    assert set(sg.graphs) == {64, 36, fc.num_tokens % 100 % 64} - {0}
    assert sg.replays == 2 * sum(-(-min(100, fc.num_tokens - p) // 64)
                                 for p in range(0, fc.num_tokens, 100))


def test_captured_smc_is_one_graph_launch_per_graph_steps_tokens(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from ldagibbssampling_tpu_torch.backends.smc import GRAPH_STEPS

    fc, model, _ = _smc_models(monkeypatch, 0.9, chunk=10**9)
    model.sweep(1)  # captures
    replays = model.graph.graph.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # no host read inside the pass
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.sweep(1)
            resamples = model.graph.resamples.clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = sum(e.name.startswith("cudaGraphLaunch") for e in prof.events())
    want = -(-fc.num_tokens // GRAPH_STEPS)
    assert launches == want == model.graph.graph.replays - replays
    assert int(resamples) == model.resamples > 0


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("p,t", [(16, 4_099), (5, 4_096), (1, 7)])
def test_resample_kernels_equal_plain(cuda, flag, p, t):
    from ldagibbssampling_tpu_torch.ops import smc_resample as sr

    rng = np.random.default_rng(p + t)
    host = [torch.from_numpy(rng.integers(-9, 1 << 20, size=s).astype(np.int32))
            for s in ((p, 33, 13), (p, 51, 13), (p, 13), (p, t))]
    idx = torch.from_numpy(rng.integers(0, p, size=p))
    out = []
    for dev in ("cuda", "cpu"):
        tables = [x.to(dev) for x in host]
        scratch = [torch.full_like(x, -1) for x in tables]
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        f = torch.tensor(flag, device=dev)
        sr.resample_gather(f, idx.to(dev), tables, scratch, count)
        sr.resample_write(f, scratch, tables)
        out.append([x.cpu() for x in (*tables, *scratch, count)])
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int(out[0][-1]) == int(flag)


def test_refused_smc_capture_raises_and_runs_no_step_eagerly(cuda, monkeypatch):
    """A capture that fails (here: the resample's launch refused inside it)
    fails the pass, and the next one, with the launch's error; the model's
    state is untouched and no token was absorbed eagerly instead."""
    from ldagibbssampling_tpu_torch.ops import smc_resample as sr

    build, lib = sr._lib()

    class Refusing:
        def __getattr__(self, attr):
            return getattr(lib, attr)

        def lda_smc_resample(self, *args):
            if torch.cuda.is_current_stream_capturing():
                return 1  # cudaErrorInvalidValue
            return lib.lda_smc_resample(*args)

    monkeypatch.setattr(sr, "_lib", lambda: (build, Refusing()))
    _, model, _ = _smc_models(monkeypatch, 0.9, chunk=100)
    keep = [t.clone() for t in model._tables()]
    before = dict(sr.LAUNCHES)
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="lda_smc_resample failed: CUDA error 1"):
            model.sweep(1)
        assert model.graph.graph.graphs == {} and model.graph.graph.replays == 0
        # the warm-up steps alone launched the kernels
        assert sr.LAUNCHES == {n: c + calls for n, c in before.items()}
    torch.cuda.synchronize()
    assert model.sweeps_done == 0
    assert all(torch.equal(a, b) for a, b in zip(model._tables(), keep))


def test_captured_svi_equals_eager_on_card(cuda):
    """``SviGraph`` against ``svi_step`` (a changing ρ, a short batch), then
    a whole ``SviModel`` epoch against the same epoch stepped eagerly; one
    graph launch a minibatch."""
    from torch.profiler import ProfilerActivity, profile

    from ldagibbssampling_tpu_torch.backends.svi import SviGraph, SviModel, svi_step
    from ldagibbssampling_tpu_torch.data.stream import minibatch_indices

    rng = np.random.default_rng(6)
    k, v, b = 7, 300, 16
    lam0 = torch.from_numpy(rng.gamma(100.0, 0.01, size=(k, v)).astype(np.float32)).to(cuda)
    kw = dict(alpha=0.3, eta=0.05, e_steps=20)
    graph = SviGraph(lam0, b, total_docs=90, **kw)
    got = want = lam0
    for t, real in enumerate((16, 16, 9, 16)):
        bow = torch.from_numpy(rng.poisson(0.4, size=(b, v)).astype(np.float32))
        bow[real:] = 0
        bow = bow.to(cuda)
        rho = (1.0 + t) ** -0.7
        got, g_got = graph(got, bow, rho, real)
        want, g_want = svi_step(want, bow, rho, real, total_docs=90, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(g_got, g_want), t
    assert graph.graph.replays == 4 and set(graph.graph.graphs) == {1}

    fc = _small_corpus(seed=9, docs=70, vocab=200)
    cfg = LdaConfig(topic_num=6, backend="svi", seed=2)
    model = SviModel(cfg, fc, batch_size=16, device=cuda)
    lam = model.lam.clone()
    gamma_full = np.ones((fc.num_docs, 6), np.float32)
    order = np.random.default_rng(cfg.seed)
    for step, (idx, real) in enumerate(minibatch_indices(fc.num_docs, 16, order)):
        bow = torch.from_numpy(model._batch_bow(idx, real)).to(cuda)
        lam, gamma = svi_step(lam, bow, (model.tau0 + step) ** (-model.kappa), real,
                              alpha=cfg.alpha, eta=model.eta, e_steps=model.e_steps,
                              total_docs=fc.num_docs)
        gamma_full[idx[:real]] = gamma[:real].cpu().numpy()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.sweep(1)
        torch.cuda.synchronize()
    assert torch.equal(model.lam, lam)
    np.testing.assert_array_equal(model._gamma_full, gamma_full)
    steps = -(-fc.num_docs // 16)
    assert model.graph.graph.replays == steps
    assert sum(e.name.startswith("cudaGraphLaunch") for e in prof.events()) == steps


# --- CVB0's fixed-order scatter (ops/cvb0_scatter.py) against its plain
# version on the CPU, and CVB0's and WarpLDA's captured sweeps against their
# eager sweeps


@pytest.mark.parametrize("case", ["doc_major", "random_words", "one_long_run"])
def test_cvb0_scatter_equals_plain_on_cpu_copies(cuda, case):
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    rng = np.random.default_rng(11)
    block, k = 512, 37
    if case == "doc_major":  # a padded last block: its zeros after real ids
        ids = np.sort(rng.integers(0, 40, size=3 * block - 100))
        ids = np.concatenate([ids, np.zeros(100, np.int64)])
    elif case == "random_words":
        ids = ((rng.zipf(1.2, size=3 * block) - 1) % V)
    else:  # one row takes a whole block: one run of 512 adds
        ids = np.concatenate([np.full(block, 3), rng.integers(0, 9, size=block)])
    rows_n = int(ids.max()) + 1
    host_table = torch.from_numpy(rng.uniform(0, 5, size=(rows_n, k)).astype(np.float32))
    deltas = [torch.from_numpy(rng.normal(size=(block, k)).astype(np.float32))
              for _ in range(len(ids) // block)]
    plan = cs.scatter_plan(ids, block, cuda)
    host_plan = cs.scatter_plan(ids, block, "cpu")
    table = host_table.to(cuda)
    launches = cs.LAUNCHES["cvb0_scatter"]
    for b, delta in enumerate(deltas):
        cs.cvb0_scatter(table, delta.to(cuda), plan, b)
        cs.cvb0_scatter(host_table, delta, host_plan, b)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["cvb0_scatter"] == launches + len(deltas)
    assert torch.equal(table.cpu(), host_table)
    with pytest.raises(ValueError, match="on the CPU"):
        cs.cvb0_scatter_plain(table, plan.index[:block], deltas[0].to(cuda))


@pytest.mark.parametrize("case,k", [
    ("one_word_block", 500),  # one run of 65,536 rows: streamed, 16 slabs
    ("thresholds", 1), ("thresholds", 15), ("thresholds", 17), ("thresholds", 500),
    ("padded", 15), ("padded", 500), ("zipf", 37)])
def test_cvb0_scatter_units_equal_plain_on_cpu_copies(cuda, case, k):
    """The kernel's packed and streamed units, both copy widths (K = 500's
    16-byte rows, K = 1, 15, 17 and 37's 4-byte ones) and its slabs against
    the plain version, bitwise, on every block."""
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    rng = np.random.default_rng(k)
    block = 65_536 if case == "one_word_block" else 2_048
    if case == "one_word_block":
        ids = np.concatenate([np.full(block, 7), np.full(block - 5_000, 7),
                              np.zeros(5_000, np.int64)])
    elif case == "thresholds":  # runs of SHORT_RUN and UNIT_ROWS, and one more
        lens = [3, cs.SHORT_RUN, cs.SHORT_RUN + 1, 1, cs.UNIT_ROWS, 2,
                cs.UNIT_ROWS + 1, 700]
        ids = np.repeat(np.arange(len(lens)), lens)
        ids = rng.permutation(np.concatenate([ids, rng.integers(8, 300,
                                                                size=block - len(ids))]))
        ids = np.concatenate([ids, np.repeat(np.arange(3), [1, cs.UNIT_ROWS, block - 257])])
    elif case == "padded":  # doc-major, the last block's padding zeros
        ids = np.sort(rng.integers(0, 9, size=3 * block - 600))
        ids = np.concatenate([ids, np.zeros(600, np.int64)])
    else:
        ids = (rng.zipf(1.1, size=3 * block) - 1) % 400
    rows_n = int(ids.max()) + 1
    host_table = torch.from_numpy(rng.uniform(0, 5, size=(rows_n, k)).astype(np.float32))
    plan = cs.scatter_plan(ids, block, cuda)
    host_plan = cs.scatter_plan(ids, block, "cpu")
    table = host_table.to(cuda)
    for b in range(plan.num_blocks):
        delta = torch.from_numpy(rng.normal(size=(block, k)).astype(np.float32))
        cs.cvb0_scatter(table, delta.to(cuda), plan, b)
        cs.cvb0_scatter(host_table, delta, host_plan, b)
        torch.cuda.synchronize()
        assert torch.equal(table.cpu(), host_table), f"block {b}"


def test_cvb0_scatter_takes_unaligned_rows_by_the_4_byte_path(cuda):
    """A K = 500 block of rows that is not 16-byte aligned (a view one float
    into its storage) goes by the 4-byte copies, bitwise the plain version."""
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    rng = np.random.default_rng(5)
    block, k = 1_024, 500
    ids = (rng.zipf(1.1, size=block) - 1) % 50
    host_table = torch.from_numpy(rng.uniform(0, 5, size=(50, k)).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=(block, k)).astype(np.float32))
    storage = torch.empty(block * k + 1, device=cuda)
    rows = storage[1:].view(block, k)
    rows.copy_(delta.to(cuda))
    assert rows.data_ptr() % 16 != 0
    table = host_table.to(cuda)
    cs.cvb0_scatter(table, rows, cs.scatter_plan(ids, block, cuda), 0)
    cs.cvb0_scatter(host_table, delta, cs.scatter_plan(ids, block, "cpu"), 0)
    torch.cuda.synchronize()
    assert torch.equal(table.cpu(), host_table)


def _cvb0_eager_on_card(model, n):
    from ldagibbssampling_tpu_torch.backends.cvb0 import cvb0_sweeps

    out = [t.clone() for t in model._tables()]
    cvb0_sweeps(*out, model._tw, model._td, model._tm, model._plans, n,
                alpha=model.config.alpha, beta=model.config.beta,
                block_size=model.block_size)
    return out


@pytest.mark.parametrize("sort_blocks", [False, True])
def test_captured_cvb0_equals_eager_on_card(cuda, sort_blocks):
    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    cfg = LdaConfig(topic_num=6, backend="cvb0", block_size=128, seed=2,
                    sort_blocks=sort_blocks)
    model = Cvb0Model(cfg, _small_corpus(seed=4), device=cuda)
    blocks = model._padded.num_tokens // 128
    want = _cvb0_eager_on_card(model, 3)
    before = dict(cs.LAUNCHES), dict(cs.PLAIN_CALLS)
    model.sweep(2)
    model.sweep(1)
    torch.cuda.synchronize()
    for name, w in zip(("gamma", "ndk", "nwk", "nk"), want):
        assert torch.equal(getattr(model, name), w), name
    # two scatters a block: the warm-up sweep's, then one replay a sweep
    assert cs.LAUNCHES["cvb0_scatter"] - before[0]["cvb0_scatter"] == 2 * blocks * 4
    assert cs.PLAIN_CALLS == before[1]
    assert model.graph.per_replay == {(cs.__name__, "cvb0_scatter"): 2 * blocks}
    model.check_invariants()


@pytest.mark.parametrize("sort_blocks", [False, True])
def test_captured_cvb0_with_long_runs_equals_eager_on_card(cuda, sort_blocks):
    """Blocks of 2,048 at K = 40 (two slabs, 16-byte copies) whose documents
    and frequent words hold runs of more than UNIT_ROWS rows (streamed)
    beside packed ones: the captured sweeps bitwise the eager ones, two
    scatters a block a replay."""
    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    rng = np.random.default_rng(9)
    ragged = [[int(x) for x in (rng.zipf(1.1, size=int(rng.integers(300, 900))) - 1) % 200]
              for _ in range(12)]
    cfg = LdaConfig(topic_num=40, backend="cvb0", block_size=2_048, seed=3,
                    sort_blocks=sort_blocks)
    model = Cvb0Model(cfg, FlatCorpus.from_ragged(ragged, vocab_size=200), device=cuda)
    runs = [np.diff(p.bounds.cpu().numpy()).max() for p in model._plans]
    assert min(runs) > cs.UNIT_ROWS
    blocks = model._padded.num_tokens // 2_048
    want = _cvb0_eager_on_card(model, 3)
    before = cs.LAUNCHES["cvb0_scatter"]
    model.sweep(2)
    model.sweep(1)
    torch.cuda.synchronize()
    for name, w in zip(("gamma", "ndk", "nwk", "nk"), want):
        assert torch.equal(getattr(model, name), w), name
    assert cs.LAUNCHES["cvb0_scatter"] - before == 2 * blocks * 4
    assert model.graph.per_replay == {(cs.__name__, "cvb0_scatter"): 2 * blocks}


@pytest.mark.parametrize("mode", ["internal", "external"])
def test_captured_warp_equals_eager_on_card(cuda, mode):
    from ldagibbssampling_tpu_torch.backends.warp import WarpModel, _warp_sweep
    from ldagibbssampling_tpu_torch.ops.gibbs import sweep_seed

    cfg = LdaConfig(topic_num=6, backend="warp", block_size=128, seed=3)
    model = WarpModel(cfg, _small_corpus(seed=5), device=cuda, noise_mode=mode)
    st = model.state
    t_pad = st.z.shape[0]
    noise = _card_noise(cuda, t_pad, "uniform", k=8)

    def u_of(sweep):
        return noise(sweep).t().contiguous()  # [8, T_pad]
    gen = torch.Generator().manual_seed(st.seed)
    want = st
    for _ in range(3):
        if mode == "external":
            u = u_of(want.sweep)
        else:
            g = torch.Generator(device=cuda).manual_seed(sweep_seed(gen))
            u = torch.rand((8, t_pad), generator=g, device=cuda)
        want = _warp_sweep(want, u, alpha=model.alpha, beta=model.beta, **model._args)
    model.sweep(2, noise=u_of)
    model.sweep(1, noise=u_of)
    torch.cuda.synchronize()
    for name in ("z", "ndk", "nwk", "nk"):
        assert torch.equal(getattr(model.state, name), getattr(want, name)), name
    assert model.graph.replays == 3 and model.sweeps_done == 3


@pytest.mark.parametrize("backend", ["cvb0", "warp"])
def test_captured_backend_is_one_graph_launch_a_sweep_without_host_sync(cuda, backend):
    from torch.profiler import ProfilerActivity, profile

    from ldagibbssampling_tpu_torch.backends import make_backend

    cfg = LdaConfig(topic_num=5, backend=backend, block_size=128, seed=1)
    model = make_backend(cfg, _small_corpus(seed=6), device=cuda)
    model.sweep(1)  # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # no host read inside the sweeps
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.sweep(3)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = sum(e.name.startswith("cudaGraphLaunch") for e in prof.events())
    assert launches == 3 == model.graph.replays - 1


def test_refused_cvb0_capture_raises_and_runs_no_sweep_eagerly(cuda, monkeypatch):
    """A scatter launch refused inside the capture fails the call with the
    launch's error; the model's state is untouched and nothing ran the
    sweep eagerly instead."""
    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model
    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    build, lib = cs._lib()

    class Refusing:
        def __getattr__(self, attr):
            return getattr(lib, attr)

        def lda_cvb0_scatter(self, *args):
            if torch.cuda.is_current_stream_capturing():
                return 1  # cudaErrorInvalidValue
            return lib.lda_cvb0_scatter(*args)

    monkeypatch.setattr(cs, "_lib", lambda: (build, Refusing()))
    cfg = LdaConfig(topic_num=4, backend="cvb0", block_size=128, seed=2)
    model = Cvb0Model(cfg, _small_corpus(seed=7), device=cuda)
    keep = [t.clone() for t in model._tables()]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="lda_cvb0_scatter failed: CUDA error 1"):
            model.sweep(1)
        assert model.graph.graph is None and model.graph.replays == 0
    torch.cuda.synchronize()
    assert model.sweeps_done == 0
    assert all(torch.equal(a, b) for a, b in zip(model._tables(), keep))


# --- the mesh runtimes' sweep in one dispatch (parallel/runtime.py on
# ops/graphs.SweepGraph): four positions on the one card, captured against
# the eager sweep (_eager_sweeps), bitwise


def _mesh_model(device, kind, tier, mode="internal", seed=5):
    from ldagibbssampling_tpu_torch.parallel import multihost
    from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
    from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet
    from ldagibbssampling_tpu_torch.parallel.grid import GridLda
    from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

    axes = {"adlda": {"data": 4}, "grid": {"data": 2, "vocab": 2},
            "token": {"data": 4}, "chain": {"chain": 2, "data": 2}}[kind]
    cls = {"adlda": ShardedLda, "grid": GridLda, "token": TokenShardedLda,
           "chain": ShardedChainSet}[kind]
    rng = np.random.default_rng(seed)
    fc = FlatCorpus.from_ragged(
        [list((rng.zipf(1.3, size=int(rng.integers(40, 240))) - 1) % V)
         for _ in range(120)], vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=512, seed=seed, use_pallas=tier)
    model = cls(cfg, fc, mesh=multihost.make_mesh(axes, [device] * 4),
                device=device, noise_mode=mode)
    assert model.kernel_tier == (tier or "xla")
    return model


def _mesh_noise(device, model):
    def noise(p, sweep):
        g = torch.Generator(device=device).manual_seed(1000 * p + sweep)
        t = model._tokens[p][0].shape[0]
        if model.kernel_tier == "xla":
            u = torch.rand((t, K), generator=g, device=device) * 0.999 + 5e-4
            return -torch.log(-torch.log(u))
        return torch.rand((t, 128), generator=g, device=device) * 0.999 + 5e-4
    return noise


@pytest.mark.parametrize("mode", ["internal", "external"])
@pytest.mark.parametrize("kind,tier", [("adlda", "deferred"), ("adlda", "fused"),
                                       ("adlda", False), ("grid", "deferred"),
                                       ("token", "deferred"), ("chain", "deferred")])
def test_captured_mesh_sweeps_equal_eager_on_card(cuda, kind, tier, mode):
    """Each runtime's graph (one replay a sweep) against its eager sweep
    from the same state, seeds and noise, α and β changed between calls:
    z and every table bitwise; the counts a recount of z."""
    a, b = _mesh_model(cuda, kind, tier, mode), _mesh_model(cuda, kind, tier, mode)
    kw = dict(noise=_mesh_noise(cuda, a)) if mode == "external" else {}
    for (alpha, beta), n in (((0.5, 0.1), 2), ((0.013, 0.71), 1), ((0.5, 0.1), 3)):
        a.alpha = b.alpha = alpha
        a.beta = b.beta = beta
        a.sweep(n, **kw)
        b._eager_sweeps(n, **kw)
        torch.cuda.synchronize()
        for name in ("z", "ndk", "nwk", "nk"):
            for p in a.positions:
                assert torch.equal(getattr(a, name)[p], getattr(b, name)[p]), (name, p)
    assert a.graph.graph is not None and a.graph.replays == 6
    assert a.graph.launches == 1
    a.check_counts_consistent()


@pytest.mark.parametrize("kind", ["adlda", "grid", "token", "chain"])
def test_captured_mesh_sweep_is_one_graph_launch_without_host_sync(cuda, kind):
    from torch.profiler import ProfilerActivity, profile

    model = _mesh_model(cuda, kind, "deferred")
    model.sweep(1)  # captures
    torch.cuda.synchronize()
    for _ in range(3):  # a run where the profiler saw nothing on the card is retried
        torch.cuda.set_sync_debug_mode("error")  # no host read inside the sweeps
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.sweep(3)
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            break
    names = [e.name for e in prof.events()]
    assert sum(n.startswith("cudaGraphLaunch") for n in names) == 3
    assert not [n for n in names if n.startswith(("cudaLaunchCooperativeKernel",
                                                  "cudaLaunchKernel"))]
    model.check_counts_consistent()


@pytest.mark.parametrize("kind,tier", [("adlda", "deferred"), ("adlda", "fused"),
                                       ("chain", "deferred")])
def test_captured_mesh_counts_its_kernels_per_replay(cuda, kind, tier):
    """The capture's counts are each replay's: the warm-up sweep's launches,
    then the per-replay counts times the sweeps."""
    model = _mesh_model(cuda, kind, tier)
    name = fk.sample_name(torch.bfloat16 if tier == "deferred" else torch.int32)
    def counters():
        return {**fk.LAUNCHES, **ck.LAUNCHES}

    before = counters()
    model.sweep(2)
    torch.cuda.synchronize()
    per = {n: c for (_, n), c in model.graph.per_replay.items()}
    if tier == "deferred":
        tables = 2 if kind == "chain" else 1  # distinct nwk: one per chain
        assert per == {name: 4, "rebuild_counts": 4, "cast_mirror": tables}
    else:
        blocks = sum(t[0].shape[0] // model.block_size for t in model._tokens.values())
        assert per == {name: blocks, "count_move": blocks}
    after = counters()
    assert {n: after[n] - before[n] for n in per} == {n: 3 * c for n, c in per.items()}
    model.sweep(2)
    again = counters()
    assert {n: again[n] - after[n] for n in per} == {n: 2 * c for n, c in per.items()}
    assert model.graph.nodes >= sum(per.values()) and model.graph.setup_s > 0


def test_refused_mesh_capture_raises_and_runs_no_sweep_eagerly(cuda, monkeypatch):
    """A capture that refuses K1's cooperative launch fails the runtime's
    sweep, and every later one: the state and the sweep count stay, and no
    eager sweep runs instead (the walks launched are the warm-up sweeps')."""
    build, lib = fk._lib()

    class Refusing:
        def __getattr__(self, attr):
            return getattr(lib, attr)

        def lda_gibbs_tiles(self, *args):
            if torch.cuda.is_current_stream_capturing():
                return 82  # cudaErrorCooperativeLaunchTooLarge
            return lib.lda_gibbs_tiles(*args)

    monkeypatch.setattr(fk, "_lib", lambda: (build, Refusing()))
    model = _mesh_model(cuda, "adlda", "deferred")
    keep = {n: {p: t.clone() for p, t in getattr(model, n).items()}
            for n in ("z", "ndk", "nwk", "nk")}
    gen = model.generator.get_state()
    name = fk.sample_name(torch.bfloat16)
    walks = fk.LAUNCHES[name]
    for calls in (1, 2):
        with pytest.raises(RuntimeError, match="lda_gibbs_tiles failed: CUDA error 82"):
            model.sweep(2)
        assert model.graph.graph is None and model.graph.replays == 0
        assert fk.LAUNCHES[name] == walks + 4 * calls  # the warm-up sweeps alone
    torch.cuda.synchronize()
    assert model.sweeps_done == 0
    for n, parts in keep.items():
        for p, t in parts.items():
            assert torch.equal(getattr(model, n)[p], t), (n, p)
    assert torch.equal(model.generator.get_state(), gen)  # no seed taken
