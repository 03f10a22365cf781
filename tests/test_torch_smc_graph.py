"""SMC's captured absorb (``backends/smc.SmcGraph`` on ``ops/graphs.StepGraph``)
on the CPU, where the captured step runs eagerly on the graph's buffers.

- Against the eager ``smc_absorb`` from the same state and noise, bitwise
  (``z``, ``ndk``, ``nwk``, ``nk``, ``logw``): a first pass and a
  rejuvenation pass, with resampling and without, internal and external
  noise, chunks of 37 tokens, of ``GRAPH_STEPS``, of a non-multiple of it
  and of the whole pass.  Noise blocks of 128 tokens there (the module's
  ``NOISE_BLOCK`` patched), so that chunks and replays cross many blocks
  and the ring of two blocks wraps; once more at the real 4,096, across
  its first block's end.
- Against the JAX package's ``smc_absorb`` fed the reference's chain of
  Gumbels (its key split once per token, once more inside a resample; the
  reference stepped one token a call, as ``tests/test_torch_backends.py``
  does, to know where it resampled), with resampling and without: ``z``
  and the counts exact, log-weights rel 1e-5 (XLA's and PyTorch's float32
  ``log`` may differ by an ulp).
- α, β, V·β and K·α as the eager ops round them, the resample's plain
  version with its flag true and false, and the graph's copy-in rule.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.backends.smc import smc_absorb as jax_smc_absorb
from ldagibbssampling_tpu_torch.backends import smc
from ldagibbssampling_tpu_torch.backends.smc import (
    GRAPH_STEPS, SmcModel, smc_absorb, smc_scalars)
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.ops import smc_resample as sr
from ldagibbssampling_tpu_torch.ops._device import sweep_scalars
from ldagibbssampling_tpu_torch.ops.graphs import StepGraph
from test_torch_backends import _P, _K, _assert_smc_equal, _ref_state, _smc_setup

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TABLES = ("ndk", "nwk", "nk", "z", "logw")


def _corpus(seed: int, docs: int, vocab: int = 30, lo: int = 5, hi: int = 40):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(lo, hi)))]
              for _ in range(docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def _external(fc, p, k, seed):
    """``noise(pos, c)``: slices of one pass's Gumbels, made with numpy."""
    rng = np.random.default_rng(seed)
    t = fc.num_tokens
    g = rng.gumbel(size=(t, p, k)).astype(np.float32)
    rg = rng.gumbel(size=(t, p, p)).astype(np.float32)
    return lambda pos, c: (torch.from_numpy(g[pos:pos + c]),
                           torch.from_numpy(rg[pos:pos + c]))


def _eager_passes(model: SmcModel, passes: int, chunk: int, noise=None) -> list:
    """``model``'s chain through the eager ``smc_absorb``, chunk by chunk:
    its internal noise (the same pass seeds, ``_noise``) or ``noise``;
    the tables after each pass."""
    tw, td = model._tw, model._td
    t = tw.shape[0]
    st = model._tables()
    out = []
    for sweep in range(passes):
        pass_seed = int(torch.randint(0, 2**63 - 1, (), generator=model.generator))
        for pos in range(0, t, chunk):
            c = min(chunk, t - pos)
            g, rg = (model._noise(pass_seed, pos, c) if noise is None
                     else noise(pos, c))
            st = smc_absorb(*st, tw, td, sweep == 0, pos,
                            alpha=model.config.alpha, beta=model.config.beta,
                            ess_threshold=model.ess_threshold, num_steps=c,
                            gumbels=g, resample_gumbels=rg)
        out.append(tuple(x.clone() for x in st))  # it moves its tables in place
    return out


def _assert_bitwise(got: SmcModel, want: tuple, label: str) -> None:
    for name, w in zip(TABLES, want):
        assert torch.equal(getattr(got, name), w), f"{label}: {name}"


@pytest.mark.parametrize("mode", ["internal", "external"])
@pytest.mark.parametrize("threshold", [0.0, 0.9])
@pytest.mark.parametrize("chunk", [37, GRAPH_STEPS, 100, 10**9])
def test_captured_body_equals_eager_absorb(monkeypatch, chunk, threshold, mode):
    monkeypatch.setattr(smc, "NOISE_BLOCK", 128)
    fc = _corpus(1, docs=24)  # ~520 tokens: five noise blocks
    cfg = LdaConfig(topic_num=3, alpha=0.3, beta=0.07, seed=4, backend="smc")
    kw = dict(num_particles=4, ess_threshold=threshold, chunk_size=chunk,
              device="cpu")
    got, ref = SmcModel(cfg, fc, **kw), SmcModel(cfg, fc, **kw)
    noise = _external(fc, 4, 3, 8) if mode == "external" else None
    want = _eager_passes(ref, 2, chunk, noise)
    resamples = []
    for sweep in range(2):  # the first pass, then a rejuvenation pass
        got.sweep(1, noise=noise)
        _assert_bitwise(got, want[sweep], f"pass {sweep}")
        resamples.append(got.resamples)
    assert (sum(resamples) > 0) == (threshold > 0), resamples
    assert (got.nk.sum(dim=1) == fc.num_tokens).all()


@pytest.mark.parametrize("mode", ["internal", "external"])
def test_captured_body_crosses_the_first_noise_block(mode):
    fc = _corpus(2, docs=200, vocab=50, lo=15, hi=30)  # past 4,096 tokens
    assert smc.NOISE_BLOCK < fc.num_tokens < 2 * smc.NOISE_BLOCK
    cfg = LdaConfig(topic_num=3, seed=6, backend="smc")
    kw = dict(num_particles=3, ess_threshold=0.6, chunk_size=1_000, device="cpu")
    got, ref = SmcModel(cfg, fc, **kw), SmcModel(cfg, fc, **kw)
    noise = _external(fc, 3, 3, 9) if mode == "external" else None
    (want,) = _eager_passes(ref, 1, 1_000, noise)
    got.sweep(1, noise=noise)
    _assert_bitwise(got, want, "one pass")
    assert got.resamples > 0


def _reference_chain(seed: int, passes: int, threshold: float):
    """The reference stepped one token a call for ``passes`` passes from
    ``_smc_setup``'s zeros: its final state, each pass's Gumbels and its
    resamples."""
    fc, st = _smc_setup(seed)
    tw, td = jnp.asarray(fc.token_word), jnp.asarray(fc.token_doc)
    ref, key = _ref_state(st), jax.random.PRNGKey(seed + 7)
    noise, resamples = [], 0
    for sweep in range(passes):
        gs, rgs = [], []
        for t in range(fc.num_tokens):
            k1, sub = jax.random.split(key)
            gs.append(np.array(jax.random.gumbel(sub, (_P, _K))))
            _, sub2 = jax.random.split(k1)  # the split inside a resample
            rgs.append(np.array(jax.random.gumbel(sub2, (_P, _P))))
            *ref, key = jax_smc_absorb(*ref, key, tw, td, jnp.asarray(sweep == 0),
                                       jnp.int32(t), alpha=0.5, beta=0.1,
                                       ess_threshold=threshold, num_steps=1)
            resamples += int(not np.asarray(ref[4]).any())
        noise.append((np.stack(gs), np.stack(rgs)))
    return fc, ref, noise, resamples


@pytest.mark.parametrize("seed,chunk,threshold", [
    (2, 37, 0.5), (3, 10**9, 0.5), (4, GRAPH_STEPS, 0.5), (5, 100, 0.0)])
def test_captured_body_matches_reference_chain(seed, chunk, threshold):
    fc, ref, noise, resamples = _reference_chain(seed, 2, threshold)
    # the resample branch ran, or (threshold 0) never did
    assert resamples >= 3 if threshold else resamples == 0
    model = SmcModel(LdaConfig(topic_num=_K, alpha=0.5, beta=0.1, backend="smc"),
                     fc, num_particles=_P, ess_threshold=threshold, chunk_size=chunk,
                     device="cpu")
    counted = 0
    for g, rg in noise:
        model.sweep(1, noise=lambda pos, c, g=g, rg=rg: (
            torch.from_numpy(g[pos:pos + c]), torch.from_numpy(rg[pos:pos + c])))
        counted += model.resamples
    assert counted == resamples
    _assert_smc_equal(ref, model._tables())


@pytest.mark.parametrize("alpha,beta,v,k", [
    (0.3, 0.07, 30, 3),    # K·α: 0.3 * 3 in doubles rounds below float32's product
    (0.5, 0.1, 1_000, 15),
    (0.3, 0.01, 100_000, 100)])
def test_smc_scalars_round_as_the_eager_ops(alpha, beta, v, k):
    s = smc_scalars(alpha, beta, v, k)
    assert s.dtype == np.float32
    np.testing.assert_array_equal(s, [np.float32(alpha), np.float32(beta),
                                      np.float32(v * beta), np.float32(k * alpha)])
    # the eager step adds the Python doubles to int32 rows: one rounding each
    rows = torch.arange(-2, 300, dtype=torch.int32)
    for x, dev in zip((alpha, beta, v * beta, k * alpha), torch.from_numpy(s)):
        assert torch.equal(rows + x, rows + dev)
    if (alpha, k) == (0.3, 3):  # a product of float32 values is another value
        assert sweep_scalars(alpha, beta, v, k)[3] != s[3]


def _tables(p=3, m=5, v=7, k=4, t=11, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 50, size=s).astype(np.int32))
            for s in ((p, m, k), (p, v, k), (p, k), (p, t))]


@pytest.mark.parametrize("flag", [True, False])
def test_resample_plain_gathers_only_when_flagged(flag):
    tables = _tables()
    before = [t.clone() for t in tables]
    scratch = [torch.full_like(t, -1) for t in tables]
    idx = torch.tensor([2, 2, 0])
    count = torch.zeros(1, dtype=torch.int64)
    names = ("plain.resample_gather", "plain.resample_write")
    calls = tracing.counters()
    f = torch.tensor(flag)
    sr.resample_gather(f, idx, tables, scratch, count)
    sr.resample_write(f, scratch, tables)
    assert {n: tracing.counters()[n] for n in names} == {
        n: calls.get(n, 0) + 1 for n in names}
    assert int(count) == int(flag)
    for t, s, b in zip(tables, scratch, before):
        assert torch.equal(t, b[idx] if flag else b)
        assert torch.equal(s, b[idx]) if flag else bool((s == -1).all())


def test_resample_wrappers_reject_bad_inputs():
    tables = _tables()
    scratch = [torch.empty_like(t) for t in tables]
    idx, count, flag = torch.tensor([0, 1, 2]), torch.zeros(1, dtype=torch.int64), \
        torch.tensor(True)
    with pytest.raises(ValueError, match="bool"):
        sr.resample_gather(torch.tensor(1), idx, tables, scratch, count)
    with pytest.raises(ValueError, match="idx"):
        sr.resample_gather(flag, idx.int(), tables, scratch, count)
    with pytest.raises(ValueError, match="scratch"):
        sr.resample_write(flag, scratch[:3] + [scratch[3][:, 1:].contiguous()], tables)
    with pytest.raises(ValueError, match="int32"):
        sr.resample_write(flag, [s.long() for s in scratch], tables)
    with pytest.raises(ValueError, match="four"):
        sr.resample_write(flag, scratch[:3], tables[:3])


def test_step_graph_copies_in_only_a_state_it_did_not_hand_out():
    buf = torch.zeros(4)
    cursor = torch.zeros(1)
    g = StepGraph(lambda: (buf.add_(1), cursor.add_(1)), [buf], mutable=[cursor])
    g.load([torch.full((4,), 5.0)])
    g.run(3)
    (a,) = g.result()
    assert torch.equal(a, torch.full((4,), 8.0)) and float(cursor) == 3
    g.load([a])          # what it handed out: no copy
    buf.add_(100)        # (a copy would have undone this)
    g.run(1)
    (b,) = g.result()
    assert torch.equal(b, torch.full((4,), 109.0))
    g.load([a])          # an older state: copied in
    g.run(1)
    (c,) = g.result()
    assert torch.equal(c, torch.full((4,), 9.0))
    c.add_(1)            # modified after it was handed out: copied in
    g.load([c])
    assert torch.equal(buf, torch.full((4,), 10.0))
    with pytest.raises(ValueError, match="at least one"):
        g.run(0)
    with pytest.raises(ValueError, match="built for"):
        g.load([torch.zeros(5)])
