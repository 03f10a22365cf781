"""WarpLDA's sweep in one dispatch (``backends/warp.py`` on ``ops/graphs.SweepGraph``)
on the CPU, where the captured sweep's body (``_warp_sweep_``, in place on
the graph's buffers) runs eagerly.

- The model's ``sweep`` bitwise the eager ``_warp_sweep`` loop from the same
  state, in both noise modes: internal noise from a fresh generator seeded
  with each sweep's seed (the graph reseeds its registered one), external
  noise ``noise(sweep)``; chunked calls and a state set between calls the
  same.
- Against the JAX package's ``_warp_sweeps`` fed its own uniforms
  (``uniform(fold_in(key, sweep))``), from the reference's state: ``z``
  equal on >= 99.9% of the real tokens (exact for these seeds), the counts a
  recount of ``z``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.backends.warp import WarpModel as JaxWarpModel
from ldagibbssampling_tpu.backends.warp import _warp_sweeps as jax_warp_sweeps
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.backends.warp import WarpModel, _warp_sweep
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.ops.gibbs import sweep_seed

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TABLES = ("z", "ndk", "nwk", "nk")
K = 6


def _ragged(seed, num_docs=30, vocab=40, lo=5, hi=40):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(lo, hi)))]
            for _ in range(num_docs)]


def _model(mode, seed=1, **kw):
    fc = FlatCorpus.from_ragged(_ragged(seed), vocab_size=40)
    cfg = LdaConfig(backend="warp", topic_num=K, block_size=64, seed=seed)
    return WarpModel(cfg, fc, device="cpu", noise_mode=mode, **kw)


def _noise(t_pad, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(16, 8, t_pad)).astype(np.float32)
    return lambda sweep: torch.from_numpy(u[sweep])


def _eager(model, state, n, mode, noise=None, generator=None):
    """``n`` eager sweeps from ``state``: internal noise seeded per sweep from
    ``generator``, as the model draws it."""
    t_pad = state.z.shape[0]
    for _ in range(n):
        if mode == "external":
            u = noise(state.sweep)
        else:
            gen = torch.Generator().manual_seed(sweep_seed(generator))
            u = torch.rand((8, t_pad), generator=gen)
        state = _warp_sweep(state, u, alpha=model.alpha, beta=model.beta, **model._args)
    return state


def _assert_recount(model, k=K):
    pc, st = model._padded, model.state
    real = pc.token_mask > 0
    z = st.z.numpy()
    ndk = np.zeros((pc.num_docs, k), np.int64)
    nwk = np.zeros((pc.vocab_size, k), np.int64)
    np.add.at(ndk, (pc.token_doc[real], z[real]), 1)
    np.add.at(nwk, (pc.token_word[real], z[real]), 1)
    np.testing.assert_array_equal(st.ndk.numpy(), ndk)
    np.testing.assert_array_equal(st.nwk.numpy(), nwk)
    np.testing.assert_array_equal(st.nk.numpy(), nwk.sum(axis=0))
    assert st.z.dtype == torch.int32 and ((z >= 0) & (z < k)).all()


@pytest.mark.parametrize("mode", ["internal", "external"])
def test_model_sweep_is_the_eager_sweep_bitwise(mode):
    model = _model(mode, seed=2)
    start = model.state
    noise = _noise(start.z.shape[0])
    want = _eager(model, start, 4, mode, noise,
                  torch.Generator().manual_seed(start.seed))
    model.sweep(4, noise=noise)
    assert model.sweeps_done == want.sweep == 4
    for name in TABLES:
        assert torch.equal(getattr(model.state, name), getattr(want, name)), name
    assert start.sweep == 0 and model.state.seed == start.seed


@pytest.mark.parametrize("mode", ["internal", "external"])
def test_counts_are_a_recount_of_z(mode):
    model = _model(mode, seed=3)
    model.sweep(5, noise=_noise(model.state.z.shape[0], seed=3))
    _assert_recount(model)


@pytest.mark.parametrize("mode,chunks", [("internal", (1, 2)), ("external", (2, 1, 2))])
def test_chunked_calls_equal_one_call(mode, chunks):
    a, b = _model(mode, seed=4), _model(mode, seed=4)
    noise = _noise(a.state.z.shape[0], seed=4)
    for n in chunks:
        a.sweep(n, noise=noise)
    b.sweep(sum(chunks), noise=noise)
    for name in TABLES:
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), name
    assert a.sweeps_done == sum(chunks)


def test_a_state_set_between_calls_is_copied_in():
    model, other = _model("external", seed=5), _model("external", seed=5)
    noise = _noise(model.state.z.shape[0], seed=5)
    model.sweep(1, noise=noise)
    kept = model.state
    handed = [getattr(kept, n).clone() for n in TABLES]
    other.sweep(3, noise=noise)
    model.state = other.state
    want = _eager(model, other.state, 2, "external", noise)
    model.sweep(2, noise=noise)
    assert model.sweeps_done == 5
    for name in TABLES:
        assert torch.equal(getattr(model.state, name), getattr(want, name)), name
    assert all(torch.equal(getattr(kept, n), h) for n, h in zip(TABLES, handed))


def test_external_noise_is_required_and_modes_checked():
    model = _model("external", seed=6)
    with pytest.raises(ValueError, match="noise"):
        model.sweep(1)
    model.sweep(0)  # no sweep, no noise needed
    assert model.sweeps_done == 0
    with pytest.raises(ValueError, match="noise_mode"):
        _model("deterministic")


@pytest.mark.parametrize("seed,chunks", [(3, (2, 3)), (8, (1, 1, 1))])
def test_matches_the_reference_warp_sweeps_under_its_uniforms(seed, chunks):
    ragged = _ragged(seed, num_docs=40, vocab=64)
    kw = dict(backend="warp", topic_num=7, block_size=128, seed=seed)
    ref = JaxWarpModel(JaxLdaConfig(**kw), JaxFlatCorpus.from_ragged(ragged, vocab_size=64))
    state = interop.from_jax_state(
        {n: np.asarray(getattr(ref.state, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")},
        device="cpu")
    port = WarpModel(LdaConfig(**kw), FlatCorpus.from_ragged(ragged, vocab_size=64),
                     device="cpu", noise_mode="external", state=state)
    key, t_pad = ref.state.key, int(ref.state.z.shape[0])

    def noise(sweep):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, sweep), (8, t_pad), jnp.float32)))

    n = sum(chunks)
    want = jax_warp_sweeps(ref.state, *ref._args, jnp.int32(n), jnp.float32(ref.alpha),
                           jnp.float32(ref.beta), num_topics=7,
                           block_size=ref.block_size)
    for c in chunks:
        port.sweep(c, noise=noise)
    assert port.sweeps_done == n == int(want.sweep)
    real = port._padded.token_mask > 0
    match = float((port.state.z.numpy()[real] == np.asarray(want.z)[real]).mean())
    assert match >= 0.999 and match == 1.0, match  # exact for these seeds
    _assert_recount(port, k=7)
