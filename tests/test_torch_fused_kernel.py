"""K1's plain version against the reference kernel in Pallas interpret mode
(``pallas_fused_block(..., emit_delta=False, interpret=True)``, bf16 rows).

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

K = 7
V = 64
ALPHA, BETA = 0.5, 0.1
VBETA = V * BETA


def _inputs(seed=0, b=128, k_pad=128, d_loc=8, big=False):
    """Consistent tables: every token's own (word, z_old) and (doc, z_old)
    cells hold at least its own count, so exclusion never goes negative."""
    rng = np.random.default_rng(seed)
    zold = rng.integers(0, K, b).astype(np.int32)
    d_local = np.sort(rng.integers(0, d_loc, b)).astype(np.int32)
    msk = np.ones(b, np.int32)
    msk[-7:] = 0
    hi = 3000 if big else 50  # > 256 exercises the bf16 snapshot rounding
    rows = np.zeros((b, k_pad), np.float32)
    rows[:, :K] = rng.integers(0, hi, (b, K))
    rows[np.arange(b), zold] += 1
    rows = np.asarray(jnp.asarray(rows, jnp.bfloat16).astype(jnp.float32))
    slab = np.zeros((d_loc, k_pad), np.float32)
    slab[:, :K] = rng.integers(0, 20, (d_loc, K))
    np.add.at(slab, (d_local[msk > 0], zold[msk > 0]), 1)
    nk = np.zeros((1, k_pad), np.float32)
    nk[0, :K] = slab[:, :K].sum(0) + rng.integers(100, 200 * (60 if big else 1), K)
    return rows, slab, nk, zold, d_local, msk


def _reference(rows, slab, nk, zold, d_local, msk, noise_mode, noise=None,
               row_tile=64):
    znew, slab_out, nk_out = pallas_fused_block(
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(slab), jnp.asarray(nk),
        jnp.asarray(zold), jnp.asarray(d_local), jnp.asarray(msk),
        jnp.int32(3), None if noise is None else jnp.asarray(noise),
        alpha=ALPHA, beta=BETA, vbeta=VBETA, k_real=K, noise_mode=noise_mode,
        interpret=True, row_tile=row_tile, emit_delta=False,
    )
    return np.asarray(znew), np.asarray(slab_out), np.asarray(nk_out)


def _port(rows, slab, nk, zold, d_local, msk, noise_mode, noise=None,
          row_tile=64, seed=0):
    """The same block through the port: the gathered rows ARE the snapshot
    (token i reads row i) and the slab is ``ndk`` indexed by ``d_local``."""
    b = rows.shape[0]
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    znew = fk.gibbs_tiles(
        mirror, ndk, nk_t, torch.from_numpy(zold),
        torch.arange(b, dtype=torch.int32), torch.from_numpy(d_local),
        torch.from_numpy(msk), alpha=ALPHA, beta=BETA, vbeta=VBETA,
        row_tile=row_tile, noise_mode=noise_mode, seed=seed,
        uniforms=None if noise is None else torch.from_numpy(noise),
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
        torch.ones(b, dtype=torch.int32), alpha=ALPHA, beta=BETA, vbeta=VBETA,
        noise_mode="internal", seed=12345).numpy()
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
            alpha=ALPHA, beta=BETA, vbeta=VBETA, row_tile=64,
            noise_mode="internal", seed=99, slot0=s))
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
    z_new = fk.gibbs_tile_sample(mirror, ndk, nk_t, z_old, *args, alpha=ALPHA,
                                 beta=BETA, vbeta=VBETA, row_tile=128,
                                 noise_mode="internal", seed=5)
    fk.gibbs_tile_update(ndk, nk_t, z_old, z_new, *args[1:], row_tile=128)
    np.testing.assert_array_equal(z_new.numpy(), z_walk)
    np.testing.assert_array_equal(ndk.numpy(), ndk_walk)
    np.testing.assert_array_equal(nk_t.numpy(), nk_walk)


def test_wrapper_rejects_bad_inputs():
    rows, slab, nk, zold, d_local, msk = _inputs(10)
    mirror = torch.from_numpy(rows).to(torch.bfloat16)
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    good = dict(alpha=ALPHA, beta=BETA, vbeta=VBETA, row_tile=64)
    toks = (torch.arange(128, dtype=torch.int32), torch.from_numpy(d_local),
            torch.from_numpy(msk))
    with pytest.raises(ValueError, match="float32"):  # mirror must be bf16
        fk.gibbs_tiles(mirror.float(), ndk, nk_t, torch.from_numpy(zold), *toks, **good)
    with pytest.raises(ValueError, match="uniforms"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       noise_mode="external", **good)
    with pytest.raises(ValueError, match="noise_mode"):
        fk.gibbs_tiles(mirror, ndk, nk_t, torch.from_numpy(zold), *toks,
                       noise_mode="gumbel", **good)
