"""The port's shard layouts and meshes against the JAX package's.

The partitions are numpy on both sides and must be equal, array for array:
``assign_docs``, ``shard_corpus``, ``sort_blocks_inplace``,
``split_tokens``, ``partition_vocab``, ``shard_corpus_grid`` and the
deferred layouts of the three runtimes (their stripe-aligned token arrays
and the plans' slot maps).  ``make_mesh`` takes the reference's shapes and
raises its errors, word for word, over the same number of positions (the
reference's eight virtual CPU devices, the port's eight ``cpu``
positions).  ``psum`` sums over a named axis's groups and nothing else, and
``initialize_distributed`` is a no-op for one process.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from ldagibbssampling_tpu.config import LdaConfig as JaxConfig
from ldagibbssampling_tpu.parallel import adlda as jax_adlda
from ldagibbssampling_tpu.parallel import grid as jax_grid
from ldagibbssampling_tpu.parallel import multihost as jax_multihost
from ldagibbssampling_tpu.parallel import sharding as jax_sharding
from ldagibbssampling_tpu.parallel import tokenshard as jax_tokenshard
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.parallel import adlda, grid, multihost, sharding, tokenshard
from test_torch_mesh_sweep import mesh_corpora

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _fields_equal(a, b, names):
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, n)),
                                      np.asarray(getattr(b, n)), err_msg=n)


@pytest.mark.parametrize("p,block", [(1, 1), (2, 64), (3, 128), (4, 256)])
def test_shard_corpus_and_assign_docs_equal_reference(p, block):
    jc, pc = mesh_corpora(p, num_docs=23)
    assert sharding.assign_docs(pc.doc_lengths(), p) == \
        jax_sharding.assign_docs(jc.doc_lengths(), p)
    ours, ref = sharding.shard_corpus(pc, p, block), jax_sharding.shard_corpus(jc, p, block)
    _fields_equal(ours, ref, ("token_word", "token_doc", "token_mask",
                              "doc_lengths", "doc_map", "num_shards",
                              "vocab_size", "num_real_tokens"))
    sharding.sort_blocks_inplace(ours.token_word, ours.token_doc,
                                 ours.token_mask, block_size=block)
    jax_sharding.sort_blocks_inplace(ref.token_word, ref.token_doc,
                                     ref.token_mask, block_size=block)
    _fields_equal(ours, ref, ("token_word", "token_doc", "token_mask"))


@pytest.mark.parametrize("p,block", [(2, 1), (3, 128), (8, 64)])
def test_split_tokens_equals_reference(p, block):
    jc, pc = mesh_corpora(5)
    for a, b in zip(tokenshard.split_tokens(pc, p, block),
                    jax_tokenshard.split_tokens(jc, p, block)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pd,pv,block", [(1, 2, 1), (2, 2, 128), (3, 2, 64), (2, 4, 256)])
def test_partition_vocab_and_grid_equal_reference(pd, pv, block):
    jc, pc = mesh_corpora(pd + pv)
    np.testing.assert_array_equal(grid.partition_vocab(pc, pv),
                                  jax_grid.partition_vocab(jc, pv))
    _fields_equal(grid.shard_corpus_grid(pc, pd, pv, block),
                  jax_grid.shard_corpus_grid(jc, pd, pv, block),
                  ("token_word", "token_doc", "token_mask", "doc_lengths",
                   "doc_map", "vocab_bounds", "p_data", "p_vocab",
                   "vocab_size", "num_real_tokens"))


@pytest.mark.parametrize("block", [128, 256, 100])
def test_deferred_layouts_equal_reference(block):
    """The three runtimes' deferred layouts (or refusals: block 100 has no
    multiple-of-8 row tile)."""
    jc, pc = mesh_corpora(9)
    got, why = adlda.deferred_shard_layout(sharding.shard_corpus(pc, 3, block), block, 7)
    ref, ref_why = jax_adlda.deferred_shard_layout(
        jax_sharding.shard_corpus(jc, 3, block), block, 7)
    assert (got is None) == (ref is None)
    if got is None:
        assert why is not None and ref_why is not None
        return
    _fields_equal(got[0], ref[0], ("token_word", "token_doc", "token_mask"))
    np.testing.assert_array_equal(got[1]["perm"], ref[1]["perm"])
    assert got[1]["v_pad"] == ref[1]["v_pad"] and got[1]["row_tile"] == ref[1]["row_tile"]

    gs, js = grid.shard_corpus_grid(pc, 2, 2, block), jax_grid.shard_corpus_grid(jc, 2, 2, block)
    v_s = -(-gs.vocab_per_shard // 128) * 128  # GridLda's lane-aligned slab
    got, _ = grid.deferred_grid_layout(gs, block, 7, v_slab=v_s)
    ref, _ = jax_grid.deferred_grid_layout(js, block, 7, v_slab=v_s)
    _fields_equal(got[0], ref[0], ("token_word", "token_doc", "token_mask"))
    assert got[1]["v_pad"] == ref[1]["v_pad"] == v_s

    arrays = tokenshard.split_tokens(pc, 2, block)
    got, _ = tokenshard.deferred_token_layout(*arrays, pc.vocab_size, block, 7)
    ref, _ = jax_tokenshard.deferred_token_layout(
        *jax_tokenshard.split_tokens(jc, 2, block), jc.vocab_size, jc.num_docs, block, 7)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axes", [
    {"data": 8}, {"data": -1}, {"data": 2, "vocab": -1}, {"data": 4, "vocab": 2},
    {"chain": 2, "data": 4}, {"data": -1, "vocab": -1}, {"data": 3, "vocab": -1},
    {"data": 4}, {"data": 2, "vocab": 2, "x": 2},
])
def test_make_mesh_matches_reference(axes):
    try:
        ref = jax_multihost.make_mesh(axes, jax.devices()[:8])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            multihost.make_mesh(axes, CPU8)
        assert str(got.value) == str(e)
        return
    mesh = multihost.make_mesh(axes, CPU8)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.shape == tuple(ref.devices.shape)
    assert mesh.local_positions == list(range(mesh.size))


def test_mesh_from_config_and_line_mesh(monkeypatch):
    assert multihost.mesh_from_config(LdaConfig(), CPU8).shape == \
        tuple(jax_multihost.mesh_from_config(JaxConfig(), jax.devices()[:8]).devices.shape)
    cfg = LdaConfig(sampler="serial", mesh={"data": 2, "vocab": -1})
    assert multihost.mesh_from_config(cfg, CPU8).shape == (2, 4)
    monkeypatch.setattr(multihost, "local_devices", lambda device="cuda": CPU8[:3])
    assert multihost.line_mesh(None, device="cpu").shape == (3,)
    assert multihost.line_mesh(5, device="cpu").shape == (3,)  # devs[:n]
    assert multihost.line_mesh(2, "token", device="cpu").axis_names == ("token",)


def test_psum_sums_over_the_named_axis_only():
    mesh = multihost.make_mesh({"data": 2, "vocab": 2}, CPU8[:4])
    parts = {p: torch.tensor([p, 10 * p], dtype=torch.int32) for p in range(4)}
    by_data = multihost.psum(parts, mesh, "data")  # (i, j): sum over i
    assert [by_data[p].tolist() for p in range(4)] == [[2, 20], [4, 40], [2, 20], [4, 40]]
    assert by_data[0] is by_data[2]  # one device: the group shares its sum
    by_vocab = multihost.psum(parts, mesh, "vocab")
    assert [by_vocab[p].tolist() for p in range(4)] == [[1, 10], [1, 10], [5, 50], [5, 50]]
    both = multihost.psum(parts, mesh, ("data", "vocab"))
    assert all(both[p].tolist() == [6, 60] for p in range(4))
    assert [parts[p].tolist() for p in range(4)] == [[p, 10 * p] for p in range(4)]


def test_initialize_distributed_single_process():
    topo = multihost.initialize_distributed(device="cpu")
    assert (topo.process_index, topo.process_count) == (0, 1)
    assert topo.local_device_count == topo.global_device_count == 1
    assert multihost.world() == (0, 1)
