"""The chains × data mesh (``parallel/chaingrid.py``) against the JAX
package's ``ShardedChainSet`` on a 2×2 ``('chain', 'data')`` mesh.

- Sweeps: from the reference's initial state, each cell ``(c, s)`` fed its
  noise rebuilt from ``fold_in(fold_in(key, c), s)``, three sweeps in the
  XLA and the deferred tier: ``z`` and every table equal the reference's
  (the tolerance of ``test_torch_mesh_sweep.py``: ≥ 99.9%, exact for these
  seeds), and each chain's tables are exact recounts of its own ``z``.
- R̂: from the same states after each sweep (the reference's state loaded
  into the port's runtime), the LL traces and split-R̂ on the LL and on φ
  equal the reference's to relative 1e-6 (float64 host sums in other
  orders).  The LL, computed on the devices, equals the reference's host
  LL per chain to relative 1e-9, and ``device_log_likelihood()`` chain 0's;
  recording never reads the whole state (``arrays()``).
- Internal noise: the chains differ pairwise.
- ``ChainSet`` and ``MultiChainModel`` place their chains on a chain mesh.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.models.chains import ChainSet, MultiChainModel
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainModel
from test_torch_mesh_sweep import (
    K, assert_matches, load_reference, mesh_corpora, port, reference,
    reference_noise)

torch.set_num_threads(1)


@pytest.mark.parametrize("tier,block,seed", [(False, 128, 31), ("deferred", 256, 32)])
def test_chain_mesh_matches_reference(tier, block, seed):
    jc, pc = mesh_corpora(seed)
    cfg = dict(topic_num=K, block_size=block, seed=seed, use_pallas=tier)
    ref = reference("chain", jc, **cfg)
    model = port("chain", pc, **cfg)
    assert model.kernel_tier == ref.kernel_tier == (tier or "xla")
    load_reference(model, ref)
    ref.sweep(3)
    model.sweep(3, noise=reference_noise("chain", ref, model))
    assert_matches("chain", model, ref)


def test_r_hat_matches_reference_from_the_same_states():
    jc, pc = mesh_corpora(33)
    cfg = dict(topic_num=K, block_size=128, seed=5)
    ref = reference("chain", jc, **cfg)
    model = port("chain", pc, noise_mode="internal", **cfg)
    for _ in range(5):
        ref.sweep(1, record_ll=True, record_phi=True)
        load_reference(model, ref)
        model.record(ll=True, phi=True)
    np.testing.assert_allclose(np.stack(model.ll_trace), np.stack(ref.ll_trace),
                               rtol=1e-6)
    np.testing.assert_allclose(model.r_hat_ll(), ref.r_hat_ll(), rtol=1e-6)
    got, want = model.r_hat_phi(), ref.r_hat_phi()
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("tier", [False, "deferred"])
def test_chains_differ_and_counts_exact(tier):
    _, pc = mesh_corpora(34)
    model = ShardedChainModel(
        LdaConfig(topic_num=K, block_size=256, seed=1, use_pallas=tier), pc,
        num_chains=2, mesh=port("chain", pc, topic_num=K).mesh, device="cpu")
    model.sweep(4)
    model.check_counts_consistent()
    z = model.chains.arrays()["z"]
    assert not np.array_equal(z[0], z[1])
    assert model.z().shape == (pc.num_tokens,)
    assert np.isfinite(model.r_hat())
    np.testing.assert_allclose(model.phi().sum(axis=1), 1.0, rtol=1e-6)


def test_chain_set_on_a_chain_mesh():
    _, pc = mesh_corpora(35)
    cfg = LdaConfig(topic_num=K, block_size=128, chains=4)
    mesh = multihost.make_mesh({"chain": 2}, [torch.device("cpu")] * 2)
    chains = ChainSet(cfg, pc, mesh=mesh, device="cpu")
    assert chains.chain_devices == [torch.device("cpu")] * 4
    chains.sweep(2, record_ll=True)
    chains.check_counts_consistent()
    model = MultiChainModel(cfg, pc, device="cpu", mesh=mesh)
    model.sweep(2)
    assert model.sweeps_done == 2
    with pytest.raises(ValueError, match="'chain' axis"):
        ChainSet(cfg, pc, mesh=multihost.make_mesh({"data": 2}, [torch.device("cpu")] * 2),
                 device="cpu")


def test_record_phi_matches_reference_from_the_same_states():
    """``ShardedChainSet.record_phi(half)``, the running split-R̂ on φ, as
    the reference's (``parallel/chaingrid.py:422``), from the same states."""
    jc, pc = mesh_corpora(36)
    cfg = dict(topic_num=K, block_size=128, seed=6)
    ref = reference("chain", jc, **cfg)
    model = port("chain", pc, noise_mode="internal", **cfg)
    for i in range(4):
        ref.sweep(1)
        load_reference(model, ref)
        ref.record_phi(i // 2)
        model.record_phi(i // 2)
    got, want = model.r_hat_phi(), ref.r_hat_phi()
    assert got["n_cells"] == want["n_cells"] > 0
    for key in ("max", "p99", "frac_gt_1_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("tier,block,seed", [(False, 128, 37), ("deferred", 256, 38)])
def test_record_ll_matches_reference_per_chain(tier, block, seed):
    """``record(ll=True)`` on the devices against the reference's host LL
    per chain (``parallel/chaingrid.py:286-307``), from the same states."""
    jc, pc = mesh_corpora(seed)
    cfg = dict(topic_num=K, block_size=block, seed=seed, use_pallas=tier)
    ref = reference("chain", jc, **cfg)
    model = port("chain", pc, noise_mode="internal", **cfg)
    assert model.kernel_tier == (tier or "xla")
    for _ in range(2):
        ref.sweep(1, record_ll=True)
        load_reference(model, ref)
        model.record(ll=True)
    np.testing.assert_allclose(np.stack(model.ll_trace), np.stack(ref.ll_trace),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(model.device_log_likelihood(),
                               ref.ll_trace[-1][0] * pc.num_tokens, rtol=1e-9, atol=0)


def test_record_reads_no_whole_state(monkeypatch):
    """Recording the LL and φ (stored, running and windowed) and the
    runner's LL never call ``arrays()`` (which copies ``z`` and ``ndk`` to
    the host); the stored φ equals ``chain_phi``'s host formula bitwise."""
    _, pc = mesh_corpora(39)
    model = ShardedChainModel(LdaConfig(topic_num=K, block_size=256, seed=2), pc,
                              num_chains=2, mesh=port("chain", pc, topic_num=K).mesh,
                              device="cpu")
    cs = model.chains
    model.sweep(1)
    whole = cs.arrays()
    want_phi = np.stack([cs.chain_phi(c, whole) for c in range(2)])

    def no_arrays():
        raise AssertionError("arrays() called")

    monkeypatch.setattr(cs, "arrays", no_arrays)
    cs.record(ll=True, phi=True)
    np.testing.assert_array_equal(cs.phi_trace[-1], want_phi)
    for i in range(4):
        cs.record_phi(i // 2)
        model.sweep(1)
    assert np.isfinite(model.device_log_likelihood())
    assert cs.phi_accum.mean.dtype == torch.float64
    assert cs.r_hat_phi()["window_draws"] == 4
