"""The port's convergence diagnostics (``evaluation/diagnostics.py``) against
the JAX package's numpy ones, on seeded traces.

Tolerance: every function's result, and each accumulator's after a sequence
of ``add`` calls, equals the reference's to 1e-12 (absolute and relative;
the port computes the reference's float64 operations in its order on
tensors; only PyTorch's CPU ``sqrt``, within one ulp of the correctly
rounded root, keeps R̂ cells from being bitwise).  The accumulators'
moments are bitwise the reference's for the same draws, fed as tensors, as
numpy arrays or per device; their summaries agree within relative 1e-9,
``perms``, ``n_cells`` and the window's counts exactly.  The 99th
percentile helper is bitwise ``np.quantile``'s, inf cells included.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch

from ldagibbssampling_tpu.evaluation import diagnostics as ref
from ldagibbssampling_tpu_torch.evaluation import diagnostics as port

TOL = dict(rtol=1e-12, atol=1e-12)


def _close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _close(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), **TOL)


def _phis(seed, chains=3, draws=8, k=4, v=12, drift=0.0):
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.ones(v), size=k)
    out = np.empty((chains, draws, k, v))
    for c in range(chains):
        perm = rng.permutation(k)  # label switching across chains
        for s in range(draws):
            noisy = base * rng.gamma(50.0, 1 / 50.0, size=(k, v)) + drift * c
            out[c, s] = (noisy / noisy.sum(axis=1, keepdims=True))[perm]
    return out


@pytest.mark.parametrize("shape,shift", [((4, 40), 0.0), ((3, 41), 2.0),
                                         ((2, 3), 0.0)])
def test_r_hat_equals_reference(shape, shift):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape) + shift * np.arange(shape[0])[:, None]
    _close(port.r_hat(x), ref.r_hat(x))
    const = np.ones((3, 10))
    assert port.r_hat(const) == ref.r_hat(const) == 1.0


def test_r_hat_array_equals_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 20, 3, 5))
    x[:, :, 0, 0] = 0.25                 # constant cell: 1.0
    x[:, :, 0, 1] = np.arange(4)[:, None]  # no within-chain variance: inf
    got, want = port.r_hat_array(x), ref.r_hat_array(x)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _close(got[np.isfinite(got)], want[np.isfinite(want)])
    assert np.isnan(port.r_hat_array(x[:, :3])).all()


def test_align_topics_equals_reference():
    phis = _phis(2, chains=2, draws=1)
    got = port.align_topics(phis[0, 0], phis[1, 0])
    np.testing.assert_array_equal(got, ref.align_topics(phis[0, 0], phis[1, 0]))
    assert sorted(got.tolist()) == list(range(4))


def test_r_hat_phi_equals_reference():
    for drift in (0.0, 0.05):
        x = _phis(3, drift=drift)
        _close(port.r_hat_phi(x), ref.r_hat_phi(x))
        _close(port.r_hat_phi(x, mass_floor=3.0), ref.r_hat_phi(x, mass_floor=3.0))


def test_phi_rhat_accumulator_equals_reference():
    x = _phis(4, draws=10)
    a = port.PhiRhatAccumulator(3, 4, 12)
    b = ref.PhiRhatAccumulator(3, 4, 12)
    _close(a.result(), b.result())  # too few draws: NaN summary
    for s in range(10):
        half = int(s >= 5)
        a.add(x[:, s], half)
        b.add(x[:, s], half)
        _close(a.mean.cpu().numpy(), b.mean)
        _close(a.m2.cpu().numpy(), b.m2)
        assert a.draws == b.draws
    _close(a.result(), b.result())
    a.add(x[:, 0], 0)  # unbalanced halves
    b.add(x[:, 0], 0)
    _close(a.result(), b.result())
    with pytest.raises(ValueError):
        a.add(x[:2, 0], 0)


def test_phi_rhat_windowed_accumulator_equals_reference():
    x = _phis(5, draws=13)
    a = port.PhiRhatWindowedAccumulator(3, 4, 12)
    b = ref.PhiRhatWindowedAccumulator(3, 4, 12)
    for s in range(13):
        a.add(x[:, s])
        b.add(x[:, s])
        _close(a.result(), b.result())
        assert (a.draws, a.window, a.pos) == (b.draws, b.window, b.pos)
    with pytest.raises(ValueError):
        port.PhiRhatWindowedAccumulator(3, 4, 12, first_window=5)


def _draws(x, kind):
    """One draw of every chain as the port's accumulators take it."""
    if kind == "numpy":
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if kind == "tensor":
        return t
    return [([0, 2], t[[0, 2]]), ([1], t[[1]])]  # per device, chains out of order


def _assert_summary(got, want):
    assert got.keys() == want.keys()
    for key in ("perms", "n_cells", "window_draws", "burn_in_draws",
                "unbalanced_halves"):
        if key in want:
            assert got[key] == want[key], key
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["tensor", "numpy", "per device"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_accumulators_moments_bitwise_reference(kind, dtype):
    """The running and the windowed accumulator fed the same draws as the
    reference's: ``mean`` and ``m2`` bitwise after every draw (float32
    draws are what the chains record), the summaries as the module
    docstring says."""
    x = _phis(6, draws=12, k=5, v=30).astype(dtype)
    a, b = port.PhiRhatAccumulator(3, 5, 30), ref.PhiRhatAccumulator(3, 5, 30)
    wa = port.PhiRhatWindowedAccumulator(3, 5, 30)
    wb = ref.PhiRhatWindowedAccumulator(3, 5, 30)
    for s in range(12):
        a.add(_draws(x[:, s], kind), s // 6)
        b.add(x[:, s], s // 6)
        assert a.mean.dtype == torch.float64 and a.mean.device.type == "cpu"
        np.testing.assert_array_equal(a.mean.numpy(), b.mean)
        np.testing.assert_array_equal(a.m2.numpy(), b.m2)
        np.testing.assert_array_equal(a.n, b.n)
        wa.add(_draws(x[:, s], kind))
        wb.add(x[:, s])
        _assert_summary(wa.result(), wb.result())
        assert (wa.draws, wa.window, wa.pos) == (wb.draws, wb.window, wb.pos)
        if wb.pos:
            np.testing.assert_array_equal(wa.cur.mean.numpy(), wb.cur.mean)
            np.testing.assert_array_equal(wa.cur.m2.numpy(), wb.cur.m2)
    _assert_summary(a.result(), b.result())
    assert a.result()["n_cells"] > 0
    with pytest.raises(ValueError, match="group"):
        a.add(_draws(x[:, 0], "tensor" if kind == "per device" else "per device"), 0)


def test_r_hat_phi_and_r_hat_array_take_tensors():
    x = _phis(7, draws=8, k=5, v=30)
    _assert_summary(port.r_hat_phi(torch.from_numpy(x)), ref.r_hat_phi(x))
    got = port.r_hat_array(torch.from_numpy(x))
    assert torch.is_tensor(got) and got.dtype == torch.float64
    _close(got.numpy(), ref.r_hat_array(x))
    np.testing.assert_array_equal(
        port.align_topics(torch.from_numpy(x[0, 0]), x[1, 0]),
        ref.align_topics(x[0, 0], x[1, 0]))


def _quantile_cases():
    rng = np.random.default_rng(8)
    for n in (1, 2, 3, 99, 100, 101, 1000, 4097):
        yield f"normal{n}", rng.normal(size=n)
        yield f"ties{n}", np.round(rng.normal(size=n), 1)
        inf = 1.0 + rng.random(n)
        inf[rng.integers(0, n, size=max(1, n // 40))] = np.inf
        yield f"some_inf{n}", inf
        yield f"last_inf{n}", np.where(np.arange(n) == n - 1, np.inf, 1.0)
    yield "all_inf", np.full(300, np.inf)
    yield "constant", np.ones(300)


@pytest.mark.parametrize("name,values", list(_quantile_cases()))
def test_p99_matches_numpy_quantile(name, values):
    """``quantile_linear`` (one ``torch.sort``, the route the card takes
    too) against ``np.quantile(..., 0.99)``: bitwise, NaN where numpy's
    interpolation between two inf cells gives NaN."""
    with np.errstate(invalid="ignore"):
        want = np.quantile(values, 0.99)
    got = port.quantile_linear(torch.from_numpy(values), 0.99)
    assert (got == want) or (np.isnan(got) and np.isnan(want)), (got, want)
