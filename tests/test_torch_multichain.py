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
the LL on the host in float64, the port on the chains' device in float64);
``MultiChainModel.device_log_likelihood()``, the runner's LL rows, agrees
with the reference's host ``log_likelihood`` of chain 0 to rel 1e-9.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.evaluation.metrics import log_likelihood as jax_log_likelihood
from ldagibbssampling_tpu.models.chains import ChainSet as JaxChainSet
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.backends import make_backend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
from ldagibbssampling_tpu_torch.models.chains import ChainSet, MultiChainModel
from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn
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


# --- the batched sweep against the same chains run in turn -------------------

def _in_turn(cs, init, n, draw, noise_mode, noise=None):
    """The chains of ``cs`` run one after another from ``init``: one
    single-chain ``make_sweep_fn(use_pallas=False)`` per chain, each with a
    generator seeded from its chain seed, as ``ChainSet`` seeds its own."""
    pc = cs._padded
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                        cs.doc_lengths, alpha=cs.config.alpha, beta=cs.config.beta,
                        block_size=cs.block_size, draw_method=draw,
                        use_pallas=False, num_topics=cs.config.topic_num,
                        device="cpu", noise_mode=noise_mode)
    return [run(s, n_sweeps=n, generator=torch.Generator().manual_seed(s.seed),
                noise=None if noise is None else (lambda sw, c=c: noise(c, sw)))
            for c, s in enumerate(init)]


def _numpy_noise(seed, t_pad, draw):
    """``noise(c, sweep)``: seeded numpy Gumbel values ``[T_pad, K]`` or
    uniforms ``[T_pad]``."""
    def noise(c, sweep):
        rng = np.random.default_rng([seed, c, sweep])
        if draw == "gumbel":
            return torch.from_numpy(rng.gumbel(size=(t_pad, K)).astype(np.float32))
        return torch.from_numpy(rng.random(t_pad, dtype=np.float32))
    return noise


def _assert_bitwise(got, want):
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.sweep == w.sweep and g.seed == w.seed, c
        for name in ("z", "ndk", "nwk", "nk"):
            assert torch.equal(getattr(g, name), getattr(w, name)), (c, name)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("noise_mode,draw", [
    ("internal", "gumbel"), ("internal", "inverse_cdf"), ("external", "gumbel"),
    ("external", "inverse_cdf"), ("deterministic", "gumbel")])
def test_batched_chains_equal_chains_in_turn(noise_mode, draw, chains):
    """Every chain of the batched sweep is bitwise the single-chain XLA
    sweep of that chain, from the same state and generator (recorded and
    unrecorded sweeps)."""
    fc = FlatCorpus.from_ragged(_ragged(8), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=chains, seed=8,
                    draw_method=draw)
    cs = ChainSet(cfg, fc, device="cpu", noise_mode=noise_mode)
    assert cs._padded.num_tokens // BLOCK >= 4 and fc.num_tokens % BLOCK
    init = [dataclasses.replace(s, z=s.z.clone(), ndk=s.ndk.clone(),
                                nwk=s.nwk.clone(), nk=s.nk.clone())
            for s in cs.states]
    noise = (_numpy_noise(8, cs._padded.num_tokens, draw)
             if noise_mode == "external" else None)
    cs.sweep(2, noise=noise)
    cs.sweep(1, record_ll=True, noise=noise)
    _assert_bitwise(cs.states, _in_turn(cs, init, 3, draw, noise_mode, noise))
    cs.check_counts_consistent()


@pytest.mark.parametrize("devices", [
    [torch.device("cpu")] * 2,                        # one batch of four
    [torch.device("cpu"), torch.device("cpu", 0)]])   # two batches of two
def test_chain_mesh_equals_no_mesh(devices):
    """Four chains on a chain mesh of CPU positions against the same chains
    without a mesh: z, tables and the recorded LL bitwise; positions that
    repeat a device make one batch, distinct devices one batch each."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    fc = FlatCorpus.from_ragged(_ragged(9), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=4, seed=9)
    plain = ChainSet(cfg, fc, device="cpu")
    meshed = ChainSet(cfg, fc, device="cpu",
                      mesh=multihost.make_mesh({"chain": 2}, devices))
    assert len(meshed._batches) == len(set(devices))
    for cs in (plain, meshed):
        cs.sweep(2)
        cs.sweep(2, record_ll=True)
    _assert_bitwise(meshed.states, plain.states)
    np.testing.assert_array_equal(np.stack(meshed.ll_trace), np.stack(plain.ll_trace))
    np.testing.assert_array_equal(meshed._phis(), plain._phis())
    meshed.check_counts_consistent()


def test_batched_ll_and_phi_equal_per_chain():
    """``record_ll``'s one batched float64 pass against each chain's LL
    computed alone (rel 1e-12), and ``_phis`` against each chain's φ
    (equal)."""
    from ldagibbssampling_tpu_torch.models import state as state_lib

    fc = FlatCorpus.from_ragged(_ragged(10), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=3, seed=10)
    cs = ChainSet(cfg, fc, device="cpu")
    cs.sweep(3, record_ll=True)
    phis = cs._phis()
    tw, td = fc.token_word.astype(np.int64), fc.token_doc.astype(np.int64)
    for c in range(3):
        phi, theta = state_lib.phi_theta(cs.chain_state(c), cs.doc_lengths,
                                         cfg.alpha, cfg.beta)
        np.testing.assert_array_equal(phis[c], phi.numpy())
        p = (theta.numpy().astype(np.float64)[td]
             * phi.numpy().T.astype(np.float64)[tw]).sum(axis=1)
        want = np.log(np.maximum(p, 1e-300)).sum() / fc.num_tokens
        np.testing.assert_allclose(cs.ll_trace[-1][c], want, rtol=1e-12)
    np.testing.assert_array_equal(cs.mean_phi(), phis.mean(axis=0))


def test_chains_match_reference_from_its_stacked_state():
    """The reference's stacked state carried across as it is
    (``from_jax_chain_states(stacked=True)``) gives the chains of the
    per-chain carry, which match the reference."""
    ref, port, noise = _pair(11, 2)
    arrays = {n: np.asarray(getattr(ref.states, n))
              for n in ("z", "ndk", "nwk", "nk", "sweep")}
    stacked = interop.from_jax_chain_states(arrays, seeds=[11, 12], device="cpu",
                                            stacked=True)
    assert stacked.z.shape[0] == 2 and stacked.seed == (11, 12)
    port2 = ChainSet(port.config, port.corpus, device="cpu",
                     noise_mode="external", states=stacked)
    ref.sweep(2)
    for cs in (port, port2):
        cs.sweep(2, noise=noise)
    _assert_chains_equal(ref, port)
    _assert_bitwise(port2.states, port.states)
    with pytest.raises(ValueError, match="lockstep"):
        interop.from_jax_chain_states({**arrays, "sweep": np.array([0, 1])},
                                      device="cpu", stacked=True)


# --- the diagnostics on the chains' device -----------------------------------

def test_device_log_likelihood_matches_reference():
    """Chain 0's training LL on its device (float64) against the JAX
    package's host ``log_likelihood`` of the reference's chain 0, from the
    same states, before and after sweeps."""
    ref, port, noise = _pair(12, 3)
    model = MultiChainModel(port.config, port.corpus, device="cpu")
    model.chains = port
    jc = JaxFlatCorpus.from_ragged(_ragged(12), vocab_size=V)
    for sweeps in (0, 3):
        ref.sweep(sweeps)
        port.sweep(sweeps, noise=noise)
        want = jax_log_likelihood(*ref.chain_phi_theta(0), jc)
        got = model.device_log_likelihood()
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        np.testing.assert_allclose(port.chain_ll(2),
                                   jax_log_likelihood(*ref.chain_phi_theta(2), jc),
                                   rtol=1e-9, atol=0)


def test_runner_ll_rows_come_from_the_device(tmp_path, monkeypatch):
    """``run_inference`` takes the device branch for the chains: the rows'
    ``log_likelihood`` is ``device_log_likelihood()`` (the host
    ``metrics.log_likelihood`` made to raise), and equals the host LL of
    chain 0's φ and θ to rel 1e-9."""
    from ldagibbssampling_tpu_torch.evaluation import metrics

    host_ll = metrics.log_likelihood
    fc = FlatCorpus.from_ragged(_ragged(13), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=2, seed=13, iteration=10)
    model = make_backend(cfg, fc, device="cpu")

    def no_host_ll(*args, **kwargs):
        raise AssertionError("the runner took the host LL")

    monkeypatch.setattr(metrics, "log_likelihood", no_host_ll)
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(model, cfg, fc, metrics=log, ll_every=5)
    rows = read_metrics(tmp_path / "m.jsonl")
    lls = [r["log_likelihood"] for r in rows if "log_likelihood" in r]
    assert len(lls) == 2
    assert lls[-1] == model.device_log_likelihood()
    np.testing.assert_allclose(lls[-1], host_ll(model.phi(), model.theta(), fc),
                               rtol=1e-9, atol=0)


def test_phi_draws_stay_on_the_chains_device(monkeypatch):
    """``record_phi_auto`` and ``record_phi`` fold each device's φ as it is:
    ``_phis()`` (the host copy) is never called, the moments are float64
    on the chains' device, and R̂ on φ equals the reference's numpy
    accumulator fed the host copies of the same draws."""
    from ldagibbssampling_tpu.evaluation import diagnostics as ref_diag

    fc = FlatCorpus.from_ragged(_ragged(14), vocab_size=V)
    cfg = LdaConfig(topic_num=K, block_size=BLOCK, chains=3, seed=14)
    model = MultiChainModel(cfg, fc, device="cpu")
    cs = model.chains
    want = ref_diag.PhiRhatWindowedAccumulator(3, K, V)
    want_run = ref_diag.PhiRhatAccumulator(3, K, V)
    draws = []
    real_phis = cs._phis

    def no_phis():
        raise AssertionError("a φ draw was copied to the host")

    monkeypatch.setattr(cs, "_phis", no_phis)
    for i in range(5):
        model.sweep(1)
        draws.append(real_phis())
        want.add(draws[-1])
        cs.record_phi(i // 2 if i < 4 else 1)
        want_run.add(draws[-1], i // 2 if i < 4 else 1)
    got, ref_got = model.r_hat_phi(), want.result()
    assert got["window_draws"] == 4 and np.isfinite(got["p99"])
    assert {k: got[k] for k in ("perms", "n_cells", "burn_in_draws")} == {
        k: ref_got[k] for k in ("perms", "n_cells", "burn_in_draws")}
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], ref_got[key], rtol=1e-9, atol=0)
    assert cs.phi_window.cur.mean.dtype == torch.float64
    assert cs.phi_window.cur.mean.device == cs.device
    np.testing.assert_array_equal(cs.phi_window.cur.mean.numpy(), want.cur.mean)
    np.testing.assert_array_equal(cs.phi_accum.m2.numpy(), want_run.m2)
