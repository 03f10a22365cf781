"""K1's plain version against the reference kernel in Pallas interpret mode:
``pallas_fused_block(..., emit_delta=False, interpret=True)`` with bf16 rows
(the deferred tier's snapshot), and ``emit_delta=True`` with float32 rows
(the fused tier's live table, including the dense ``delta``); and the walk
at the shapes and layouts that stress the card's walk kernel (tiles that
share one document, K = 1000, one tile of 2,048 tokens), whose plain
version the card tests then require the kernel to equal bitwise.

Tolerances: ``deterministic`` mode is exact (z, doc slab and topic totals
equal): every step is an IEEE float32 add/multiply or a bf16 rounding, done
in the same order.  ``external`` mode compares z exactly for these seeds; in
general XLA's and PyTorch's float32 ``log`` may differ by one ulp, which can
move its bf16 rounding (and so ``1/E``) and flip a near-tie (the sweep test
states the rate)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.ops.pallas_gibbs import pallas_fused_block
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
from ldagibbssampling_tpu_torch.ops._device import seed_word

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K = 7
V = 64
ALPHA, BETA = 0.5, 0.1
VBETA = V * BETA


def _k1(seed=0):
    """K1's device values: α, β and Vβ as the reference's float32 scalars
    (the values it is given here), and the internal seed's word."""
    return dict(scalars=torch.tensor([ALPHA, BETA, VBETA], dtype=torch.float32),
                key=torch.tensor([seed_word(seed)], dtype=torch.int64))


def _inputs(seed=0, b=128, k_pad=128, d_loc=8, big=False, k=K, one_doc=False):
    """Consistent tables: every token's own (word, z_old) and (doc, z_old)
    cells hold at least its own count, so exclusion never goes negative.
    ``one_doc`` puts every token in document 0."""
    rng = np.random.default_rng(seed)
    zold = rng.integers(0, k, b).astype(np.int32)
    d_local = (np.zeros(b) if one_doc else np.sort(rng.integers(0, d_loc, b))
               ).astype(np.int32)
    msk = np.ones(b, np.int32)
    msk[-7:] = 0
    hi = 3000 if big else 50  # > 256 exercises the bf16 snapshot rounding
    rows = np.zeros((b, k_pad), np.float32)
    rows[:, :k] = rng.integers(0, hi, (b, k))
    rows[np.arange(b), zold] += 1
    rows = np.asarray(jnp.asarray(rows, jnp.bfloat16).astype(jnp.float32))
    slab = np.zeros((d_loc, k_pad), np.float32)
    slab[:, :k] = rng.integers(0, 20, (d_loc, k))
    np.add.at(slab, (d_local[msk > 0], zold[msk > 0]), 1)
    nk = np.zeros((1, k_pad), np.float32)
    nk[0, :k] = slab[:, :k].sum(0) + rng.integers(100, 200 * (60 if big else 1), k)
    return rows, slab, nk, zold, d_local, msk


def _reference(rows, slab, nk, zold, d_local, msk, noise_mode, noise=None,
               row_tile=64, k=K):
    znew, slab_out, nk_out = pallas_fused_block(
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(slab), jnp.asarray(nk),
        jnp.asarray(zold), jnp.asarray(d_local), jnp.asarray(msk),
        jnp.int32(3), None if noise is None else jnp.asarray(noise),
        alpha=ALPHA, beta=BETA, vbeta=VBETA, k_real=k, noise_mode=noise_mode,
        interpret=True, row_tile=row_tile, emit_delta=False,
    )
    return np.asarray(znew), np.asarray(slab_out), np.asarray(nk_out)


def _port(rows, slab, nk, zold, d_local, msk, noise_mode, noise=None,
          row_tile=64, seed=0, k=K):
    """The same block through the port: the gathered rows ARE the snapshot
    (token i reads row i) and the slab is ``ndk`` indexed by ``d_local``."""
    b = rows.shape[0]
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :k].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :k].astype(np.int32))
    znew = fk.gibbs_tiles(
        mirror, ndk, nk_t, torch.from_numpy(zold),
        torch.arange(b, dtype=torch.int32), torch.from_numpy(d_local),
        torch.from_numpy(msk), row_tile=row_tile, noise_mode=noise_mode,
        uniforms=None if noise is None else torch.from_numpy(noise), **_k1(seed),
    )
    return znew.numpy(), ndk.numpy(), nk_t.numpy()


@pytest.mark.parametrize("seed,big", [(0, False), (1, True), (2, True)])
def test_deterministic_matches_reference(seed, big):
    inp = _inputs(seed, big=big)
    z_ref, slab_ref, nk_ref = _reference(*inp, "deterministic")
    z, ndk, nk = _port(*inp, "deterministic")
    np.testing.assert_array_equal(z, z_ref)
    np.testing.assert_array_equal(ndk, slab_ref[:, :K].astype(np.int32))
    np.testing.assert_array_equal(nk, nk_ref[0, :K].astype(np.int32))
    assert not slab_ref[:, K:].any()


@pytest.mark.parametrize("seed,big", [(3, False), (4, True)])
def test_external_matches_reference(seed, big):
    inp = _inputs(seed, big=big)
    noise = np.random.default_rng(seed + 100).uniform(
        1e-7, 1 - 1e-7, (128, 128)).astype(np.float32)
    z_ref, slab_ref, nk_ref = _reference(*inp, "external", noise)
    z, ndk, nk = _port(*inp, "external", noise)
    np.testing.assert_array_equal(z, z_ref)
    np.testing.assert_array_equal(ndk, slab_ref[:, :K].astype(np.int32))
    np.testing.assert_array_equal(nk, nk_ref[0, :K].astype(np.int32))


WALK_CASES = {  # name: (k, tokens, row_tile, one_doc); two to four tiles each
    "doc_shared_tiles": (K, 4 * 64, 64, True),
    "k1000": (1000, 2 * 256, 256, False),  # k_pad 1024, the sweep's row tile
    "single_tile_2048": (128, 2048, 2048, False),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("noise_mode,seed", [("deterministic", 21),
                                             ("external", 22)])
def test_walk_shapes_match_reference(case, noise_mode, seed):
    # z equal on >= 99.9% of tokens in general (one-ulp log differences),
    # and exactly for these seeds
    k, b, row_tile, one_doc = WALK_CASES[case]
    k_pad = -(-k // 128) * 128
    inp = _inputs(seed, b=b, k_pad=k_pad, big=True, k=k, one_doc=one_doc)
    noise = None
    if noise_mode == "external":
        noise = np.random.default_rng(seed + 100).uniform(
            1e-7, 1 - 1e-7, (b, k_pad)).astype(np.float32)
    z_ref, slab_ref, nk_ref = _reference(*inp, noise_mode, noise,
                                         row_tile=row_tile, k=k)
    z, ndk, nk = _port(*inp, noise_mode, noise, row_tile=row_tile, k=k)
    assert (z == z_ref).mean() >= 0.999
    np.testing.assert_array_equal(z, z_ref)
    np.testing.assert_array_equal(ndk, slab_ref[:, :k].astype(np.int32))
    np.testing.assert_array_equal(nk, nk_ref[0, :k].astype(np.int32))
    zold, msk = inp[3], inp[5]
    moved = (z != zold) & (msk > 0)
    assert moved.any() and (z[msk == 0] == zold[msk == 0]).all()
    if one_doc:  # the tiles really chain through one doc row
        assert moved[:row_tile].any() and moved[row_tile:].any()


@pytest.mark.parametrize("noise_mode", ["deterministic", "internal"])
def test_masked_tokens_are_inert(noise_mode):
    rows, slab, nk, zold, d_local, msk = _inputs(5)
    z, ndk, nk_out = _port(rows, slab, nk, zold, d_local, msk, noise_mode,
                           seed=17)
    pad = msk == 0
    np.testing.assert_array_equal(z[pad], zold[pad])
    # the counts moved exactly by the unmasked tokens' reassignments
    want = slab[:, :K].astype(np.int64)
    real = ~pad
    np.add.at(want, (d_local[real], zold[real]), -1)
    np.add.at(want, (d_local[real], z[real]), 1)
    np.testing.assert_array_equal(ndk, want)
    assert nk_out.sum() == nk[0, :K].sum()


@pytest.mark.parametrize("noise_mode", ["external", "internal"])
def test_never_samples_padded_topics(noise_mode):
    inp = _inputs(6)
    noise = np.random.default_rng(7).uniform(
        1e-6, 1 - 1e-6, (128, 128)).astype(np.float32)
    z, _, _ = _port(*inp, noise_mode, noise if noise_mode == "external" else None,
                    seed=23)
    assert z.max() < K and z.min() >= 0


def test_internal_draw_distribution():
    """The exponential race on the kernel's Philox uniforms samples
    categorical(p): one tile, identical conditionals for every row, chi-square
    at alpha = 1e-3 (dof 6, critical value 22.46)."""
    b, k_pad = 4096, 128
    rows = np.zeros((b, k_pad), np.float32)
    rows[:, :K] = [5, 1, 9, 3, 0, 2, 7]
    ndk = np.zeros((1, K), np.int32)
    ndk[0] = [2, 4, 1, 0, 3, 1, 2]
    nk = np.full(K, 100, np.int32)
    zold = np.full(b, 2, np.int32)
    e = np.zeros(K)
    e[2] = 1
    r = 1.0 / (100 + VBETA)
    p = (rows[0, :K] - e + BETA) * (ndk[0] - e + ALPHA) * (r + e * r * r)
    p /= p.sum()
    z = fk.sample_plain(
        torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(ndk),
        torch.from_numpy(nk), torch.from_numpy(zold),
        torch.arange(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32),
        torch.ones(b, dtype=torch.int32), noise_mode="internal",
        **_k1(12345)).numpy()
    counts = np.bincount(z, minlength=K)[:K]
    expected = p * b
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 22.46, (chi2, counts, expected)


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32-10
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = fk.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                               *key)
        assert tuple(int(x) for x in got) == want


def test_approx_recip_is_reference_definition():
    # pl.reciprocal(approx=True) as the reference kernel computes it in
    # interpret mode (inside the kernel, where XLA keeps the quotient in
    # float32), over values spanning the sweep's range
    from jax.experimental import pallas as pl

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-3, 30, 65536),
                        rng.uniform(30, 3e6, 65536)]).astype(np.float32)
    x = x.reshape(1024, 128)

    def kernel(x_ref, o_ref):
        o_ref[:] = pl.reciprocal(x_ref[:], approx=True)

    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    np.testing.assert_array_equal(fk.approx_recip(torch.from_numpy(x)).numpy(), want)


def test_sliced_walk_equals_whole_walk():
    # the internal noise counter is the stream slot: walking two halves with
    # slot0 draws exactly what one walk over the whole does
    rows, slab, nk, zold, d_local, msk = _inputs(8, b=256)
    z_all, ndk_all, nk_all = _port(rows, slab, nk, zold, d_local, msk,
                                   "internal", seed=99)
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    parts = []
    for s in (0, 128):
        sl = slice(s, s + 128)
        parts.append(fk.gibbs_tiles(
            mirror, ndk, nk_t, torch.from_numpy(zold[sl]),
            torch.arange(s, s + 128, dtype=torch.int32),
            torch.from_numpy(d_local[sl]), torch.from_numpy(msk[sl]),
            row_tile=64, noise_mode="internal", slot0=s, **_k1(99)))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), z_all)
    np.testing.assert_array_equal(ndk.numpy(), ndk_all)
    np.testing.assert_array_equal(nk_t.numpy(), nk_all)


def test_sample_then_update_equals_one_tile_walk():
    rows, slab, nk, zold, d_local, msk = _inputs(9)
    z_walk, ndk_walk, nk_walk = _port(rows, slab, nk, zold, d_local, msk,
                                      "internal", row_tile=128, seed=5)
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    args = (torch.arange(128, dtype=torch.int32), torch.from_numpy(d_local),
            torch.from_numpy(msk))
    z_old = torch.from_numpy(zold)
    z_new = fk.gibbs_tile_sample(mirror, ndk, nk_t, z_old, *args, row_tile=128,
                                 noise_mode="internal", **_k1(5))
    fk.gibbs_tile_update(ndk, nk_t, z_old, z_new, *args[1:])
    np.testing.assert_array_equal(z_new.numpy(), z_walk)
    np.testing.assert_array_equal(ndk.numpy(), ndk_walk)
    np.testing.assert_array_equal(nk_t.numpy(), nk_walk)


def test_wrapper_rejects_bad_inputs():
    rows, slab, nk, zold, d_local, msk = _inputs(10)
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    good = dict(row_tile=64, **_k1())
    toks = (torch.arange(128, dtype=torch.int32), torch.from_numpy(d_local),
            torch.from_numpy(msk))
    with pytest.raises(ValueError, match="float64"):  # a bf16/f32 snapshot
        fk.gibbs_tiles(mirror.double(), ndk, nk_t, torch.from_numpy(zold), *toks, **good)
    with pytest.raises(ValueError, match="compute_dtype"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       compute_dtype="float16", **good)
    with pytest.raises(ValueError, match="float32 chain only"):  # the live table
        fk.gibbs_tiles(ndk.clone(), ndk, nk_t, torch.from_numpy(zold), *toks,
                       compute_dtype="bfloat16", **good)
    with pytest.raises(ValueError, match="uniforms"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       noise_mode="external", **good)
    with pytest.raises(ValueError, match="noise_mode"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       noise_mode="gumbel", **good)
    with pytest.raises(ValueError, match="requires key"):  # the seed on the device
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       row_tile=64, scalars=good["scalars"])
    with pytest.raises(ValueError, match="Vβ needed"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       row_tile=64, scalars=good["scalars"][:2], key=good["key"])


def _live_port(rows, slab, nk, zold, d_local, msk, noise_mode, noise=None,
               row_tile=64, seed=0):
    """The block through the port's live-table walk: the gathered rows ARE
    the int32 table (token i reads row i); returns the plain walk's dense
    delta too."""
    b = rows.shape[0]
    nwk = torch.from_numpy(rows[:, :K].astype(np.int32))
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    znew, delta = fk.gibbs_tiles_plain(
        nwk, ndk, nk_t, torch.from_numpy(zold),
        torch.arange(b, dtype=torch.int32), torch.from_numpy(d_local),
        torch.from_numpy(msk), row_tile=row_tile, noise_mode=noise_mode,
        uniforms=None if noise is None else torch.from_numpy(noise),
        emit_delta=True, **_k1(seed))
    assert torch.equal(nwk, torch.from_numpy(rows[:, :K].astype(np.int32)))
    return znew.numpy(), delta.numpy(), ndk.numpy(), nk_t.numpy()


@pytest.mark.parametrize("noise_mode,seed,big", [
    ("deterministic", 11, False), ("deterministic", 12, True),
    ("external", 13, False), ("external", 14, True),
])
def test_live_table_walk_matches_reference_emit_delta(noise_mode, seed, big):
    # fused tier: float32 rows (no bf16 snapshot rounding: counts up to 3,000
    # stay exact), and the reference's dense delta
    _, slab, nk, zold, d_local, msk = _inputs(seed, big=big)
    rng = np.random.default_rng(seed)
    rows = np.zeros((128, 128), np.float32)
    rows[:, :K] = rng.integers(0, 3000 if big else 50, (128, K))
    rows[np.arange(128), zold] += 1
    noise = None
    if noise_mode == "external":
        noise = rng.uniform(1e-7, 1 - 1e-7, (128, 128)).astype(np.float32)
    znew, delta, slab_out, nk_out = pallas_fused_block(
        jnp.asarray(rows), jnp.asarray(slab), jnp.asarray(nk),
        jnp.asarray(zold), jnp.asarray(d_local), jnp.asarray(msk),
        jnp.int32(3), None if noise is None else jnp.asarray(noise),
        alpha=ALPHA, beta=BETA, vbeta=VBETA, k_real=K, noise_mode=noise_mode,
        interpret=True, row_tile=64, emit_delta=True)
    z, d, ndk, nk_p = _live_port(rows, slab, nk, zold, d_local, msk,
                                 noise_mode, noise)
    np.testing.assert_array_equal(z, np.asarray(znew))
    np.testing.assert_array_equal(d, np.asarray(delta))
    np.testing.assert_array_equal(ndk, np.asarray(slab_out)[:, :K].astype(np.int32))
    np.testing.assert_array_equal(nk_p, np.asarray(nk_out)[0, :K].astype(np.int32))
    assert (z != zold).any()


def test_live_table_kernel_path_equals_plain_walk():
    # the wrapper's CPU path on the int32 table is the plain walk, and the
    # count move of its draws is the word-topic scatter of the dense delta
    rows, slab, nk, zold, d_local, msk = _inputs(15)
    nwk = torch.from_numpy(rows[:, :K].astype(np.int32))
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    words = torch.from_numpy(np.random.default_rng(0).integers(0, 128, 128)
                             .astype(np.int32))
    z_old, d_t, m_t = (torch.from_numpy(a) for a in (zold, d_local, msk))
    z_new = fk.gibbs_tiles(nwk, ndk, nk_t, z_old, words, d_t, m_t, row_tile=32,
                           noise_mode="internal", **_k1(4))
    z_p, delta = fk.gibbs_tiles_plain(
        nwk, ndk.clone().copy_(torch.from_numpy(slab[:, :K].astype(np.int32))),
        torch.from_numpy(nk[0, :K].astype(np.int32)), z_old, words, d_t, m_t,
        row_tile=32, noise_mode="internal", emit_delta=True, **_k1(4))
    assert torch.equal(z_new, z_p)
    moved = nwk.clone()
    fk.count_move(z_old, z_new, m_t, nwk=moved, token_word=words)
    want = nwk.clone().float()
    want.index_add_(0, words.long(), delta[:, :K])
    assert torch.equal(moved, want.to(torch.int32))


def test_count_move_all_tables_and_inert_masked_tokens():
    rng = np.random.default_rng(16)
    n, v, m = 200, 30, 9
    w = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    d = torch.from_numpy(np.sort(rng.integers(0, m, n)).astype(np.int32))
    z_old = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    z_new = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.int32))
    nwk = torch.zeros((v, K), dtype=torch.int32)
    ndk = torch.zeros((m, K), dtype=torch.int32)
    nk = torch.zeros(K, dtype=torch.int32)
    fk.count_move(z_old, z_new, mask, nwk=nwk, token_word=w, ndk=ndk,
                  token_doc=d, nk=nk)
    real = mask.numpy() > 0
    for table, ids in ((nwk, w), (ndk, d), (nk, None)):
        want = np.zeros(table.shape, np.int64)
        idx = () if ids is None else (ids.numpy()[real],)
        np.add.at(want, (*idx, z_old.numpy()[real]), -1)
        np.add.at(want, (*idx, z_new.numpy()[real]), 1)
        np.testing.assert_array_equal(table.numpy(), want)
    with pytest.raises(ValueError, match="token_word"):
        fk.count_move(z_old, z_new, mask, nwk=nwk)
    with pytest.raises(ValueError, match="at least one table"):
        fk.count_move(z_old, z_new, mask)


@pytest.mark.parametrize("alias", [True, False])
def test_count_move_writes_back_z(alias):
    # the v1-draw and fused tiers' write-back: z_out = mask ? z_new : z_old
    # in the move's launch, z_out possibly z_old itself
    rng = np.random.default_rng(17)
    n, v, m = 300, 20, 7
    w = torch.from_numpy(np.sort(rng.integers(0, v, n)).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    z_old = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    z_new = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    mask = torch.from_numpy((rng.random(n) < 0.9).astype(np.int32))
    want = dict(nwk=torch.zeros((v, K), dtype=torch.int32),
                ndk=torch.zeros((m, K), dtype=torch.int32),
                nk=torch.zeros(K, dtype=torch.int32))
    got = {k: t.clone() for k, t in want.items()}
    fk.count_move(z_old, z_new, mask, token_word=w, token_doc=d, **want)
    zo = z_old.clone()
    z_out = zo if alias else torch.empty_like(zo)
    fk.count_move(zo, z_new, mask, token_word=w, token_doc=d, z_out=z_out, **got)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(z_out, torch.where(mask > 0, z_new, z_old))
    with pytest.raises(ValueError, match="z_out"):
        fk.count_move(zo, z_new, mask, nk=got["nk"], z_out=z_out[:-1])


@pytest.mark.parametrize("n_tiles,ndk_bytes,pays", [
    (48_604, 300_000 * 100 * 4, True),   # a NYTimes sweep at K = 100 in one launch
    (576_460, 1_640_000 * 1000 * 4, True),  # a PubMed sweep at K = 1,000
    (32, 300_000 * 100 * 4, False),      # a fused block of 65,536 at NYTimes's ndk
    (32, 4_096 * 100 * 4, True),         # the same block at bench.py's 4,096 documents
    (128, 1_640_000 * 1000 * 4, False),  # a fused block at K = 1,000, PubMed's ndk
    (1, 0, True),                        # no ndk to copy
])
def test_one_barrier_walk_pays_for_its_copy_of_ndk(n_tiles, ndk_bytes, pays):
    # the one-barrier walk where its tiles save twice the copy's time
    assert fk.one_barrier_pays(n_tiles, ndk_bytes) == pays
    copy_s = 2 * ndk_bytes / fk.HBM_BYTES_PER_S
    assert (n_tiles * fk.TILE_SAVING_S >= 2 * copy_s) == pays
    if ndk_bytes:  # the rule is monotone: more tiles pay, more bytes do not
        assert fk.one_barrier_pays(2 * n_tiles, ndk_bytes) or not pays
        assert not fk.one_barrier_pays(n_tiles, 2 * ndk_bytes) or pays
