"""K3's plain version (``ops/sample_kernel.sample_block`` on the CPU) against
the reference kernel in Pallas interpret mode
(``pallas_sample_block(..., interpret=True)``).

The reference takes pre-gathered ``[B, K]`` float32 rows; the port reads the
rows from int32 tables by word and doc id, so the tests build tables whose
row i is token i's row (word id = doc id = i).

Tolerances: ``deterministic`` mode is exact (the same float32 ``log``s,
added in the same order; XLA's and PyTorch's CPU ``log`` agree on these
inputs).  ``external`` mode compares z exactly for these seeds: in general
the two ``log``s may differ by one ulp on some inputs, which can flip a
near-tie (the sweep tests state the rate).  The internal Philox draw is held
to the analytic conditional by a chi-square test."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu.ops.pallas_gibbs import pallas_sample_block
from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
from ldagibbssampling_tpu_torch.ops._device import seed_word

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

ALPHA, BETA = 0.5, 0.1


def _values(vbeta, seed=0):
    """K3's scalars (α, β, Vβ rounded to float32) and its key (the seed's
    word), on the CPU."""
    return dict(scalars=torch.tensor([ALPHA, BETA, vbeta], dtype=torch.float32),
                key=torch.tensor([seed_word(seed)]))


def _rows(b=64, k=7, seed=0, hi=20):
    """``nwk``/``ndk`` rows with every token's own ``z_old`` cell >= 1 (the
    port of ``tests/test_pallas.py::_random_rows``)."""
    rng = np.random.default_rng(seed)
    nwk = rng.integers(0, hi, size=(b, k)).astype(np.int32)
    ndk = rng.integers(0, 12, size=(b, k)).astype(np.int32)
    nk = (rng.integers(50, 200, size=k) + nwk.sum(0)).astype(np.int32)
    zold = rng.integers(0, k, size=b).astype(np.int32)
    nwk[np.arange(b), zold] += 1
    ndk[np.arange(b), zold] += 1
    return nwk, ndk, nk, zold


def _reference(nwk, ndk, nk, zold, v, noise_mode, noise=None, row_tile=256):
    return np.asarray(pallas_sample_block(
        jnp.asarray(nwk, jnp.float32), jnp.asarray(ndk, jnp.float32),
        jnp.asarray(nk, jnp.float32), jnp.asarray(zold), jnp.int32(7),
        None if noise is None else jnp.asarray(noise),
        alpha=ALPHA, beta=BETA, vbeta=v * BETA, k_real=nwk.shape[1],
        noise_mode=noise_mode, interpret=True, row_tile=row_tile))


def _port(nwk, ndk, nk, zold, v, noise_mode, noise=None, seed=0):
    b = zold.shape[0]
    ids = torch.arange(b, dtype=torch.int32)
    return sk.sample_block(
        torch.from_numpy(nwk), torch.from_numpy(ndk), torch.from_numpy(nk),
        torch.from_numpy(zold), ids, ids, noise_mode=noise_mode,
        uniforms=None if noise is None else torch.from_numpy(noise),
        **_values(float(np.float32(v * BETA)), seed)).numpy()


@pytest.mark.parametrize("b,k,row_tile,seed", [
    (64, 7, 256, 0),     # test_pallas.py:44 — K pads to 128 lanes
    (50, 7, 32, 1),      # test_pallas.py:56 — B pads to the row tile too
    (300, 130, 128, 2),  # K pads to 256, B to 384
])
def test_deterministic_matches_reference(b, k, row_tile, seed):
    nwk, ndk, nk, zold = _rows(b, k, seed)
    want = _reference(nwk, ndk, nk, zold, 30, "deterministic", row_tile=row_tile)
    got = _port(nwk, ndk, nk, zold, 30, "deterministic")
    assert got.shape == (b,) and got.max() < k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_external_matches_reference(seed):
    nwk, ndk, nk, zold = _rows(256, 9, seed, hi=400)
    noise = np.random.default_rng(seed + 100).uniform(
        1e-7, 1 - 1e-7, (256, 9)).astype(np.float32)
    want = _reference(nwk, ndk, nk, zold, 300, "external", noise)
    got = _port(nwk, ndk, nk, zold, 300, "external", noise)
    np.testing.assert_array_equal(got, want)


def test_internal_draw_matches_analytic_conditional():
    """The port of ``tests/test_pallas.py:68`` for the internal Philox draw:
    one token's counts replicated B times, chi-square at dof 4 against the
    collapsed-Gibbs conditional (P(chi2 > 23.5) ~ 1e-4)."""
    k, v, b = 5, 30, 8192
    nwk = np.array([[4, 1, 9, 2, 6]], np.int32)
    ndk = np.array([[2, 5, 1, 3, 1]], np.int32)
    nk = np.array([80, 60, 120, 40, 90], np.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    got = sk.sample_block(
        torch.from_numpy(nwk), torch.from_numpy(ndk), torch.from_numpy(nk),
        torch.full((b,), 2, dtype=torch.int32), zeros, zeros,
        noise_mode="internal", **_values(v * BETA, 123)).numpy()
    excl = np.eye(k)[2]
    p = (nwk[0] - excl + BETA) * (ndk[0] - excl + ALPHA) / (nk - excl + v * BETA)
    p /= p.sum()
    observed = np.bincount(got, minlength=k)
    expected = p * b
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < 23.5, (chi2, observed.tolist(), expected.tolist())


def test_internal_noise_is_the_stream_slot():
    # the counter is the token's stream slot: drawing two halves with slot0
    # equals one draw over the whole block, and another seed draws otherwise
    nwk, ndk, nk, zold = _rows(128, 11, 5, hi=300)
    t = [torch.from_numpy(a) for a in (nwk, ndk, nk)]
    ids = torch.arange(128, dtype=torch.int32)
    nine, ten = _values(30.0, 9), _values(30.0, 10)
    whole = sk.sample_block(*t, torch.from_numpy(zold), ids, ids, **nine)
    halves = torch.cat([
        sk.sample_block(*t, torch.from_numpy(zold[s:s + 64]), ids[s:s + 64],
                        ids[s:s + 64], slot0=s, **nine) for s in (0, 64)])
    other = sk.sample_block(*t, torch.from_numpy(zold), ids, ids, **ten)
    assert torch.equal(whole, halves) and not torch.equal(whole, other)


def test_wrapper_rejects_bad_inputs():
    nwk, ndk, nk, zold = (torch.from_numpy(a) for a in _rows(16, 7, 6))
    ids = torch.arange(16, dtype=torch.int32)
    kw = _values(3.0)
    with pytest.raises(ValueError, match="key"):
        sk.sample_block(nwk, ndk, nk, zold, ids, ids, scalars=kw["scalars"])
    with pytest.raises(ValueError, match="float32"):
        sk.sample_block(nwk.float(), ndk, nk, zold, ids, ids, **kw)
    with pytest.raises(ValueError, match="uniforms"):
        sk.sample_block(nwk, ndk, nk, zold, ids, ids, noise_mode="external", **kw)
    with pytest.raises(ValueError, match="noise_mode"):
        sk.sample_block(nwk, ndk, nk, zold, ids, ids, noise_mode="gumbel", **kw)
    with pytest.raises(ValueError, match="topics"):
        sk.sample_block(nwk[:, :5].contiguous(), ndk, nk, zold, ids, ids, **kw)


@pytest.mark.parametrize("alpha,beta", [(0.5, 0.1), (0.1, 0.05)])
def test_log_table_identity(alpha, beta):
    """What the kernel's log tables rely on: for an integer count c and
    e in {0, 1}, float(c) - e is float(c - e) exactly, so log(float(c) - e
    + shift) is the table's log(float(j) + shift) at j = c - e, to the bit
    (chip_smoke's and the planted corpus's α and β, j over the table and
    past it)."""
    j = torch.arange(-1, 4096, dtype=torch.int32)
    for shift in (alpha, beta):
        s = torch.tensor(shift, dtype=torch.float32)
        for e in (0, 1):
            c = j + e
            lhs = torch.log(c.float() - torch.tensor(float(e)) + s)
            rhs = torch.log((c - e).float() + s)
            assert torch.equal(lhs.view(torch.int32)[~lhs.isnan()],
                               rhs.view(torch.int32)[~rhs.isnan()])
            assert torch.equal(lhs.isnan(), rhs.isnan())
            assert torch.equal(lhs.isnan(), (j.float() + s) < 0)


def test_log_table_size_is_the_kernels():
    src = (Path(sk.__file__).resolve().parents[1] / "csrc" / "sample_kernel.cu").read_text()
    assert f"constexpr int kLogTable = {sk.LOG_TABLE};" in src
