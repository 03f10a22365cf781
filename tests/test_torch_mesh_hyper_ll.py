"""The mesh runtimes' Minka updates, device LL and checkpoints.

From the same tables (the reference runtime's state after two sweeps,
loaded into the port's through ``interop.from_jax_mesh_state``):

- the sharded Minka α and β (``models/hyper.sharded_alpha_update`` and
  ``sharded_beta_update`` through each runtime's
  ``optimize_hyperparameters``) against the reference's, relative 1e-5:
  both sum float32 digammas over the shards, in other orders, as the
  single-device updates of ``tests/test_torch_metrics.py:114-115``;
- the device LL (``shard_ll_chunks`` per shard, the partials summed in
  float64 on the host) against the reference's, relative 1e-6: float32
  partials summed in other orders.

The mesh checkpoint: a run saved at sweep 2 and resumed to 5 on the same
mesh gives the uninterrupted run's ``z`` and tables bitwise, for each
runtime, in internal noise (the generator's state is saved); a checkpoint
restored on a mesh of another shape raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
from test_torch_mesh_sweep import K, load_reference, mesh_corpora, port, reference

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["adlda", "grid", "token", "chain"])
def test_minka_and_ll_match_reference(kind):
    jc, pc = mesh_corpora(21)
    cfg = dict(topic_num=K, block_size=256, seed=2, alpha=0.3, beta=0.05)
    ref = reference(kind, jc, **cfg)
    ref.sweep(2)
    model = port(kind, pc, noise_mode="internal", **cfg)
    load_reference(model, ref)
    if kind != "chain":  # the chain mesh has no device LL (as the reference)
        np.testing.assert_allclose(model.device_log_likelihood(),
                                   ref.device_log_likelihood(), rtol=1e-6)
    np.testing.assert_allclose(model.optimize_hyperparameters(iters=5),
                               ref.optimize_hyperparameters(iters=5), rtol=1e-5)


@pytest.mark.parametrize("kind,tier", [
    ("adlda", "deferred"), ("adlda", False), ("adlda", "fused"),
    ("grid", "deferred"), ("token", False), ("chain", "deferred")])
def test_mesh_resume_is_bitwise(tmp_path, kind, tier):
    _, pc = mesh_corpora(22)
    cfg = dict(topic_num=K, block_size=256, seed=4, use_pallas=tier)
    straight = port(kind, pc, noise_mode="internal", **cfg)
    straight.sweep(2)
    straight.optimize_hyperparameters()
    straight.sweep(3)
    first = port(kind, pc, noise_mode="internal", **cfg)
    first.sweep(2)
    first.optimize_hyperparameters()
    assert first.save_checkpoint(tmp_path / "ck") == 2
    first.sweep(1)  # runs on, as a killed run would have
    resumed = port(kind, pc, noise_mode="internal", **cfg)
    assert resumed.restore_checkpoint(tmp_path / "ck") == 2
    assert (resumed.alpha, resumed.beta) == (straight.alpha, straight.beta)
    resumed.sweep(3)
    assert resumed.sweeps_done == 5
    a, b = straight.arrays(), resumed.arrays()
    for name in ("z", "ndk", "nwk", "nk"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_restore_on_another_mesh_shape_raises(tmp_path):
    _, pc = mesh_corpora(23)
    cfg = LdaConfig(topic_num=K, block_size=256, seed=1)
    two = ShardedLda(cfg, pc, mesh=multihost.make_mesh(
        {"data": 2}, [torch.device("cpu")] * 2), device="cpu")
    two.sweep(1)
    two.save_checkpoint(tmp_path)
    three = ShardedLda(cfg, pc, mesh=multihost.make_mesh(
        {"data": 3}, [torch.device("cpu")] * 3), device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        three.restore_checkpoint(tmp_path)
