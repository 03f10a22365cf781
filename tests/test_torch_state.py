"""The port's sampler state against the JAX package's: for the same ``z`` the
count tables are exact, ``phi``/``theta`` agree within 1e-6 (both float32
quotients of the same integers; the bound allows one rounding of a
different evaluation order), and state crosses packages unchanged."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.models import state as jax_state_lib
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.models import state as state_lib

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K = 7
V = 300
M = 60


def _stream(seed=0, t=4000):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t) - 1) % V).astype(np.int32)
    td = (np.arange(t) * M // t).astype(np.int32)
    tm = np.ones(t, np.int32)
    tm[rng.random(t) < 0.05] = 0  # some padding slots
    return tw, td, tm


def _jax_state(seed=0):
    tw, td, tm = _stream(seed)
    st = jax_state_lib.init_state(tw, td, tm, num_docs=M, vocab_size=V,
                                  num_topics=K, seed=seed)
    return (tw, td, tm), st


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_exact_for_same_z(seed):
    (tw, td, tm), ref = _jax_state(seed)
    st = state_lib.init_state(tw, td, tm, num_docs=M, vocab_size=V,
                              num_topics=K, seed=seed, z=np.asarray(ref.z))
    for name in ("z", "ndk", "nwk", "nk"):
        got = getattr(st, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert st.sweep == 0


def test_phi_theta_match_reference():
    (tw, td, tm), ref = _jax_state(2)
    st = interop.from_jax_state(
        {n: np.asarray(getattr(ref, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")})
    dl = np.bincount(td[tm > 0], minlength=M)
    phi, theta = state_lib.phi_theta(st, dl, 0.5, 0.1)
    phi_ref, theta_ref = jax_state_lib.phi_theta(ref, dl, 0.5, 0.1)
    assert phi.shape == (K, V) and theta.shape == (M, K)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_ref), rtol=0, atol=1e-6)
    state_lib.check_invariants(st, tm, dl)


def test_interop_round_trip():
    (_, _, _), ref = _jax_state(3)
    arrays = {n: np.asarray(getattr(ref, n)) for n in ("z", "ndk", "nwk", "nk")}
    arrays["sweep"] = np.asarray(ref.sweep)
    st = interop.from_jax_state(arrays, device="cpu", seed=5)
    assert st.seed == 5 and st.device.type == "cpu"
    back = interop.to_numpy(st)
    for name, want in arrays.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_init_state_draw_is_seeded_and_in_range():
    tw, td, tm = _stream(4)
    kw = dict(num_docs=M, vocab_size=V, num_topics=K)
    a = state_lib.init_state(tw, td, tm, seed=9, **kw)
    b = state_lib.init_state(tw, td, tm, seed=9, **kw)
    c = state_lib.init_state(tw, td, tm, seed=10, **kw)
    assert torch.equal(a.z, b.z) and a.seed == b.seed
    assert not torch.equal(a.z, c.z)
    assert int(a.z.min()) >= 0 and int(a.z.max()) < K
    state_lib.check_invariants(a, tm, np.bincount(td[tm > 0], minlength=M))


def test_check_invariants_catches_corruption():
    tw, td, tm = _stream(5)
    st = state_lib.init_state(tw, td, tm, num_docs=M, vocab_size=V,
                              num_topics=K, seed=0)
    dl = np.bincount(td[tm > 0], minlength=M)
    st.nk[0] += 1
    with pytest.raises(AssertionError):
        state_lib.check_invariants(st, tm, dl)
