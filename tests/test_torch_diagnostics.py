"""The port's convergence diagnostics (``evaluation/diagnostics.py``, numpy
copies) against the JAX package's, on seeded traces.

Tolerance: every function's result, and each accumulator's after a sequence
of ``add`` calls, equals the reference's to 1e-12 (absolute and relative;
both are the same float64 numpy code, so in practice exactly).
"""

from __future__ import annotations

import numpy as np
import pytest

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
        _close(a.mean, b.mean)
        _close(a.m2, b.m2)
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
