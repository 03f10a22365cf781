"""The port's several chains (``models/chains.py``) against the JAX
package's ``ChainSet``: the reference's per-chain states carried across
(``interop.from_jax_chain_states``; chain ``c`` from ``config.seed + c``) and
its noise fed per chain, rebuilt from each chain's key as
``tests/test_torch_xla_sweep.py::_jax_noise`` does for one chain
(``gumbel(fold_in(fold_in(key_c, sweep), block), (B, K))``).

Tolerances: every chain's ``z`` equal on at least 99.9% of the tokens and
exact for the seeds below (XLA's and PyTorch's float32 ``log`` may differ by
one ulp and flip a near-tie); the recorded LL traces, ``r_hat_ll`` and
``r_hat_phi`` of identical chains agree to rel 1e-6 (the reference takes
the LL on the host in float64, the port on the chains' device in float64).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.models.chains import ChainSet as JaxChainSet
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.backends import make_backend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
from ldagibbssampling_tpu_torch.models.chains import ChainSet, MultiChainModel
from ldagibbssampling_tpu_torch.runner import run_inference

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

K, V, BLOCK = 4, 40, 64


def _ragged(seed, num_docs=16):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, V, size=int(rng.integers(8, 30)))]
            for _ in range(num_docs)]


def _jax_chain_noise(keys, block, num_blocks, draw="gumbel"):
    """``noise(c, sweep)``: the reference's noise of chain ``c``'s sweep
    (gumbels, or the ``inverse_cdf`` draw's uniforms)."""
    def one(key):
        if draw == "gumbel":
            return jax.random.gumbel(key, (block, K), jnp.float32)
        return jax.random.uniform(key, (block,), jnp.float32)

    def noise(c, sweep):
        sweep_key = jax.random.fold_in(keys[c], sweep)
        return torch.from_numpy(np.concatenate([
            np.asarray(one(jax.random.fold_in(sweep_key, i)))
            for i in range(num_blocks)]))
    return noise


def _pair(seed, chains, draw="gumbel"):
    ragged = _ragged(seed)
    kw = dict(topic_num=K, block_size=BLOCK, chains=chains, seed=seed,
              draw_method=draw)
    ref = JaxChainSet(JaxLdaConfig(**kw), JaxFlatCorpus.from_ragged(ragged, vocab_size=V))
    arrays = {n: np.asarray(getattr(ref.states, n))
              for n in ("z", "ndk", "nwk", "nk", "sweep")}
    states = interop.from_jax_chain_states(
        arrays, seeds=[seed + c for c in range(chains)], device="cpu")
    port = ChainSet(LdaConfig(**kw), FlatCorpus.from_ragged(ragged, vocab_size=V),
                    device="cpu", noise_mode="external", states=states)
    keys = [ref.states.key[c] for c in range(chains)]
    noise = _jax_chain_noise(keys, port.block_size,
                             port._padded.num_tokens // port.block_size, draw)
    return ref, port, noise


def _assert_chains_equal(ref, port):
    real = port._padded.token_mask > 0
    for c in range(port.num_chains):
        z = port.chain_state(c).z.numpy()
        z_ref = np.asarray(ref.chain_state(c).z)
        match = float((z[real] == z_ref[real]).mean())
        assert match >= 0.999, (c, match)
        assert match == 1.0  # exact for these seeds (see the module docstring)
        for name in ("ndk", "nwk", "nk"):
            np.testing.assert_array_equal(
                getattr(port.chain_state(c), name).numpy(),
                np.asarray(getattr(ref.chain_state(c), name)), err_msg=name)


@pytest.mark.parametrize("seed,chains,sweeps,draw", [
    (0, 3, 3, "gumbel"), (1, 2, 2, "gumbel"), (7, 2, 2, "inverse_cdf")])
def test_chains_match_reference(seed, chains, sweeps, draw):
    ref, port, noise = _pair(seed, chains, draw)
    ref.sweep(sweeps)
    port.sweep(sweeps, noise=noise)
    assert [s.sweep for s in port.states] == [sweeps] * chains
    _assert_chains_equal(ref, port)
    port.check_counts_consistent()


def test_recorded_traces_and_r_hat_match_reference():
    ref, port, noise = _pair(2, 3)
    ref.sweep(6, record_ll=True, record_phi=True)
    port.sweep(6, record_ll=True, record_phi=True, noise=noise)
    _assert_chains_equal(ref, port)
    np.testing.assert_allclose(np.stack(port.ll_trace), np.stack(ref.ll_trace),
                               rtol=1e-6)
    assert np.isfinite(port.r_hat_ll())
    np.testing.assert_allclose(port.r_hat_ll(), ref.r_hat_ll(), rtol=1e-6)
    got, want = port.r_hat_phi(), ref.r_hat_phi()
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(port.mean_phi(), ref.mean_phi(), rtol=1e-6)


def test_phi_accumulators_match_reference():
    """The running (``record_phi(half)``) and windowed
    (``record_phi_auto``) accumulators over identical chains."""
    ref, port, noise = _pair(3, 2)
    for half in (0, 0, 1, 1):
        ref.sweep(1)
        port.sweep(1, noise=noise)
        ref.record_phi(half)
        port.record_phi(half)
    got, want = port.r_hat_phi(), ref.r_hat_phi()
    for key in ("max", "p99"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    port.reset_phi_accumulator()
    ref.reset_phi_accumulator()
    for _ in range(4):
        ref.sweep(1)
        port.sweep(1, noise=noise)
        ref.record_phi_auto()
        port.record_phi_auto()
    got, want = port.r_hat_phi(), ref.r_hat_phi()
    np.testing.assert_allclose(got["p99"], want["p99"], rtol=1e-6)


def test_internal_noise_chains_differ_and_counts_consistent():
    fc = FlatCorpus.from_ragged(_ragged(4), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=4, seed=4)
    cs = ChainSet(cfg, fc, device="cpu")
    assert [s.seed for s in cs.states] == [
        s.seed for s in (ChainSet(cfg, fc, device="cpu").states)]
    z0 = [s.z.clone() for s in cs.states]
    cs.sweep(3)
    zs = [s.z.numpy() for s in cs.states]
    assert all(not np.array_equal(zs[a], zs[b])
               for a in range(4) for b in range(a + 1, 4))
    assert any(not torch.equal(a.z, b) for a, b in zip(cs.states, z0))
    cs.check_counts_consistent()
    for s in cs.states:
        assert int(s.nk.sum()) == fc.num_tokens and s.sweep == 3


def test_runner_rows_carry_r_hat(tmp_path):
    fc = FlatCorpus.from_ragged(_ragged(5), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=3, seed=5, iteration=10)
    model = make_backend(cfg, fc, device="cpu")
    assert isinstance(model, MultiChainModel) and model.kernel_tier == "xla"
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(model, cfg, fc, metrics=log, ll_every=5)
    rows = read_metrics(tmp_path / "m.jsonl")
    assert rows[0]["kernel_tier"] == "xla"
    assert [r["sweep"] for r in rows[1:]] == list(range(10))
    # r_hat needs four recorded sweeps; r_hat_phi_p99 rides the LL cadence
    assert [("r_hat" in r) for r in rows[1:]] == [False] * 3 + [True] * 7
    assert all(np.isfinite(r["r_hat"]) for r in rows[4:])
    assert "r_hat_phi_p99" in rows[-1] and np.isfinite(rows[-1]["r_hat_phi_p99"])
    assert np.isfinite(rows[-1]["log_likelihood"])
    assert model.sweeps_done == 10
    assert model.z().shape == (fc.num_tokens,)
    np.testing.assert_allclose(model.phi().sum(axis=1), 1.0, rtol=1e-5)
    model.chains.check_counts_consistent()


def test_mesh_raises_naming_item_14():
    """Named for the refusal that stood until the chain mesh was ported: a
    mesh without a ``chain`` axis raises, a chain mesh runs (the chains
    spread over its positions), and the config takes a chain mesh."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    fc = FlatCorpus.from_ragged(_ragged(6), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=2)
    cpu2 = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="'chain' axis"):
        ChainSet(cfg, fc, mesh=multihost.make_mesh({"data": 2}, cpu2), device="cpu")
    model = MultiChainModel(cfg, fc, device="cpu",
                            mesh=multihost.make_mesh({"chain": 2}, cpu2))
    model.sweep(2)
    model.chains.check_counts_consistent()
    assert LdaConfig(chains=2, mesh={"chain": 2, "data": 1}).mesh == {"chain": 2, "data": 1}
