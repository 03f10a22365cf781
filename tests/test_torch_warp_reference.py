"""WarpLDA's sweep in the port (``backends/warp.py``) against the
benchmark's plain reference (``benchmark/reference_warp.py``, which imports
nothing of the port) on the CPU.

- The eager ``_warp_sweep`` and ``WarpModel.sweep`` in both noise modes,
  over seeded ragged corpora (empty documents among them) and random
  starts at K = 7 and 64: the topics bitwise the reference's, sweep after
  sweep, with the reference in chunks that split documents and words; the
  tables a recount of the topics.  The reference computes the ratios in
  the order the configuration states, so no flip is allowed.
- The model's start and uniforms are the configuration's: the initial
  topics those of ``benchmark/reference.ChainSeeds``, each sweep's
  uniforms ``reference_warp.sweep_uniforms`` of its sweep seed.
- The reference's own recount and its uniforms' stream.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.backends.warp import WarpModel, _warp_sweep
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
VOCAB = 50


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


ref_warp = _load("reference_warp")
ref = _load("reference")


def _corpus(seed, num_docs=40, lo=0, hi=45):
    rng = np.random.default_rng(seed)
    # a skewed word law, so that a few words hold many tokens
    p = 1.0 / np.arange(1, VOCAB + 1)
    ragged = [[int(x) for x in rng.choice(VOCAB, size=int(rng.integers(lo, hi)), p=p / p.sum())]
              for _ in range(num_docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=VOCAB)


def _model(seed, k, mode="internal"):
    cfg = LdaConfig(backend="warp", topic_num=k, block_size=64, seed=seed + 100)
    return WarpModel(cfg, _corpus(seed), device="cpu", noise_mode=mode)


def _stream(model):
    c = model.corpus
    hyper = ref_warp.Hyper(model.alpha, model.beta, c.vocab_size, model.config.topic_num)
    return ref_warp.Stream(torch.from_numpy(c.token_word), torch.from_numpy(c.token_doc),
                           c.num_docs, hyper)


def _assert_tables(stream, state):
    for name, want in zip(("ndk", "nwk", "nk"), stream.tables(state.z)):
        assert torch.equal(want, getattr(state, name)), name


@pytest.mark.parametrize("chunk", [13, 1 << 20])
@pytest.mark.parametrize("k", [7, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eager_sweep_is_the_reference_bitwise(seed, k, chunk):
    model = _model(seed, k)
    stream = _stream(model)
    state = model.state
    assert state.z.shape[0] > model.corpus.num_tokens  # pads in the stream
    gen = torch.Generator().manual_seed(seed)
    z_ref = state.z
    for _ in range(3):
        u = torch.rand((8, state.z.shape[0]), generator=gen)
        state = _warp_sweep(state, u, alpha=model.alpha, beta=model.beta, **model._args)
        z_ref = stream.sweep(z_ref, u, chunk=chunk)
        assert torch.equal(z_ref, state.z)
        _assert_tables(stream, state)
    assert not torch.equal(state.z, model.state.z)  # the chain moved


@pytest.mark.parametrize("k", [7, 64])
def test_model_sweep_internal_noise_is_the_configurations_chain(k):
    model = _model(3, k)
    stream = _stream(model)
    t_pad = model.state.z.shape[0]
    seeds = ref.ChainSeeds(model.config.seed, t_pad, k)
    assert torch.equal(model.state.z, seeds.z0)
    z_ref = seeds.z0
    for sweep in range(1, 4):
        model.sweep(1)
        u = ref_warp.sweep_uniforms(seeds.sweep_seed(sweep), t_pad, "cpu")
        z_ref = stream.sweep(z_ref, u, chunk=29)
        assert torch.equal(z_ref, model.state.z), sweep
        _assert_tables(stream, model.state)


@pytest.mark.parametrize("k", [7, 64])
def test_model_sweep_external_noise_is_the_reference_bitwise(k):
    model = _model(4, k, mode="external")
    stream = _stream(model)
    t_pad = model.state.z.shape[0]
    rng = np.random.default_rng(k)
    u = torch.from_numpy(rng.uniform(size=(4, 8, t_pad)).astype(np.float32))
    z_ref = model.state.z
    model.sweep(2, noise=lambda s: u[s])
    model.sweep(1, noise=lambda s: u[s])
    for s in range(3):
        z_ref = stream.sweep(z_ref, u[s], chunk=1 << 20)
    assert torch.equal(z_ref, model.state.z)
    _assert_tables(stream, model.state)


def test_reference_keeps_the_pads_and_reads_only_their_real_tokens():
    model = _model(5, 7)
    stream = _stream(model)
    z = model.state.z.clone()
    real = model.corpus.num_tokens
    z[real:] = 6  # whatever the pads hold
    u = ref_warp.sweep_uniforms(9, z.shape[0], "cpu")
    out = stream.sweep(z, u)
    assert torch.equal(out[real:], z[real:])
    assert torch.equal(out[:real], stream.sweep(model.state.z, u)[:real])


def test_reference_uniforms_are_one_draw_of_the_sweeps_seed():
    a = ref_warp.sweep_uniforms(2**62 + 5, 300, "cpu")
    assert a.shape == (8, 300) and a.dtype == torch.float32
    assert torch.equal(a, ref_warp.sweep_uniforms(2**62 + 5, 300, "cpu"))
    want = torch.rand((8, 300), generator=torch.Generator().manual_seed(2**62 + 5))
    assert torch.equal(a, want)
    assert not torch.equal(a, ref_warp.sweep_uniforms(2**62 + 6, 300, "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_reference_tables_are_a_recount():
    model = _model(6, 7)
    stream = _stream(model)
    c, k = model.corpus, 7
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.integers(0, k, model.state.z.shape[0]).astype(np.int32))
    zr = z.numpy()[:c.num_tokens]
    ndk = np.zeros((c.num_docs, k), np.int64)
    nwk = np.zeros((c.vocab_size, k), np.int64)
    np.add.at(ndk, (c.token_doc, zr), 1)
    np.add.at(nwk, (c.token_word, zr), 1)
    got = stream.tables(z)
    assert all(t.dtype == torch.int32 for t in got)
    np.testing.assert_array_equal(got[0].numpy(), ndk)
    np.testing.assert_array_equal(got[1].numpy(), nwk)
    np.testing.assert_array_equal(got[2].numpy(), nwk.sum(axis=0))
