"""The training loop's metrics and hyperparameter updates against the JAX
package: the chunked device log-likelihood
(``evaluation/device_metrics.py``), the host metrics
(``evaluation/metrics.py``), the Minka updates (``models/hyper.py``) and
``run_inference``'s ``ll_every`` and ``optimize_hyper_every`` branches.

Tolerances: the device LL within rel 1e-6 of the reference's (both sum
float32 chunk partials in float64; the order of the float32 sums inside a
chunk differs between XLA and PyTorch); the Minka updates within rel 1e-5
(float32 digamma sums, XLA's and PyTorch's digamma differ in the last
bits); the runner's α, β and LL within rel 1e-4 after several updates.
The runner test replays the JAX chain: the port's model takes each state
the JAX model reached, so both runners see the same chain and differ only
in their own arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.evaluation import metrics as jax_metrics
from ldagibbssampling_tpu.evaluation.device_metrics import (
    device_log_likelihood as jax_device_ll)
from ldagibbssampling_tpu.evaluation.tracing import MetricsLog as JaxMetricsLog
from ldagibbssampling_tpu.evaluation.tracing import read_metrics as jax_read_metrics
from ldagibbssampling_tpu.models.hyper import optimize_alpha as jax_alpha
from ldagibbssampling_tpu.models.hyper import optimize_beta as jax_beta
from ldagibbssampling_tpu.models.lda import LdaModel as JaxLdaModel
from ldagibbssampling_tpu.runner import run_inference as jax_run_inference
from ldagibbssampling_tpu_torch import cli, interop
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import metrics
from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
    device_log_likelihood)
from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
from ldagibbssampling_tpu_torch.models.hyper import optimize_alpha, optimize_beta
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.runner import run_inference

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _tables(seed, t=777, v=40, m=9, k=5):
    rng = np.random.default_rng(seed)
    tw = rng.integers(0, v, t).astype(np.int32)
    td = np.sort(rng.integers(0, m, t)).astype(np.int32)
    tm = np.ones(t, np.int32)
    tm[rng.random(t) < 0.05] = 0  # padding slots must not count
    dl = np.bincount(td[tm > 0], minlength=m).astype(np.int32)
    z = rng.integers(0, k, t)
    ndk = np.zeros((m, k), np.int32)
    nwk = np.zeros((v, k), np.int32)
    np.add.at(ndk, (td[tm > 0], z[tm > 0]), 1)
    np.add.at(nwk, (tw[tm > 0], z[tm > 0]), 1)
    return ndk, nwk, nwk.sum(0).astype(np.int32), tw, td, tm, dl


@pytest.mark.parametrize("seed,chunk", [(1, 256), (2, 1 << 19), (3, 100)])
def test_device_ll_matches_reference(seed, chunk):
    ndk, nwk, nk, tw, td, tm, dl = _tables(seed)
    ref = jax_device_ll(ndk, nwk, nk, tw, td, tm, dl, 0.5, 0.1, chunk_size=chunk)
    got = device_log_likelihood(
        *(torch.from_numpy(a) for a in (ndk, nwk, nk, tw, td, tm, dl)),
        0.5, 0.1, chunk_size=chunk)
    assert got == pytest.approx(ref, rel=1e-6)


def test_device_ll_chunking_boundaries():
    # a token count no multiple of the chunk: the short last chunk (and the
    # masked slots) contribute nothing extra; numpy inputs work too
    ndk, nwk, nk, tw, td, tm, dl = _tables(4)
    small = device_log_likelihood(ndk, nwk, nk, tw, td, tm, dl, 0.5, 0.1,
                                  chunk_size=256)
    big = device_log_likelihood(ndk, nwk, nk, tw, td, tm, dl, 0.5, 0.1)
    assert small == pytest.approx(big, rel=1e-6)
    real = tm > 0
    phi = (nwk.T + 0.1) / (nk[:, None] + 40 * 0.1)
    theta = (ndk + 0.5) / (dl[:, None] + 5 * 0.5)
    p = np.einsum("tk,kt->t", theta[td[real]], phi[:, tw[real]])
    assert small == pytest.approx(float(np.log(p).sum()), rel=1e-5)


def test_host_metrics_equal_reference():
    rng = np.random.default_rng(5)
    ragged = [[int(x) for x in rng.integers(0, 30, size=20)] for _ in range(10)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=30)
    jfc = JaxFlatCorpus(fc.token_word, fc.token_doc, fc.doc_ptr, fc.vocab_size)
    phi = rng.dirichlet(np.ones(30), size=4)
    theta = rng.dirichlet(np.ones(4), size=10)
    assert metrics.log_likelihood(phi, theta, fc) == jax_metrics.log_likelihood(
        phi, theta, jfc)
    assert metrics.perplexity(phi, theta, fc) == jax_metrics.perplexity(
        phi, theta, jfc)


@pytest.mark.parametrize("seed,alpha,beta,iters", [
    (6, 0.5, 0.1, 5), (7, 0.05, 0.01, 5), (8, 2.0, 0.5, 20)])
def test_minka_updates_match_reference(seed, alpha, beta, iters):
    ndk, nwk, nk, _, _, _, dl = _tables(seed, t=3000, v=60, m=20, k=8)
    a_ref = float(jax_alpha(jnp.asarray(ndk), jnp.asarray(dl), alpha, iters=iters))
    b_ref = float(jax_beta(jnp.asarray(nwk), jnp.asarray(nk), beta, iters=iters))
    a = optimize_alpha(torch.from_numpy(ndk), torch.from_numpy(dl), alpha,
                       iters=iters)
    b = optimize_beta(torch.from_numpy(nwk), torch.from_numpy(nk), beta,
                      iters=iters)
    assert a.dtype == torch.float32 and b.dtype == torch.float32
    assert float(a) == pytest.approx(a_ref, rel=1e-5)
    assert float(b) == pytest.approx(b_ref, rel=1e-5)
    assert float(a) != alpha and float(b) != beta


def test_minka_degenerate_tables_and_clip():
    # all of each document in one topic: α heads towards 0, as in the
    # reference; uniform word counts from a huge β: clipped to 1e3
    ndk = np.zeros((6, 4), np.int32)
    ndk[:, 0] = 50
    a = optimize_alpha(torch.from_numpy(ndk), torch.full((6,), 50), 0.5, iters=200)
    a_ref = jax_alpha(jnp.asarray(ndk), jnp.full((6,), 50), 0.5, iters=200)
    assert float(a) == pytest.approx(float(a_ref), rel=1e-5) and float(a) < 1e-3
    nwk = np.full((30, 4), 7, np.int32)
    b = optimize_beta(torch.from_numpy(nwk), torch.from_numpy(nwk.sum(0)), 5e3,
                      iters=1)
    assert float(b) == 1e3


class _Recording:
    """The JAX model, keeping a copy of its state after every sweep call."""

    def __init__(self, model):
        self._model = model
        self.states = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def sweep(self, n=1):
        self._model.sweep(n)
        st = self._model.state
        self.states.append({k: np.asarray(getattr(st, k))
                            for k in ("z", "ndk", "nwk", "nk", "sweep")})


def test_runner_ll_and_hyper_rows_match_reference(tmp_path):
    rng = np.random.default_rng(9)
    ragged = [[int(x) for x in rng.integers(0, 50, size=40)] for _ in range(24)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=50)
    jfc = JaxFlatCorpus(fc.token_word, fc.token_doc, fc.doc_ptr, fc.vocab_size)
    kw = dict(topic_num=6, seed=4, block_size=128, use_pallas=False, iteration=7)
    jmodel = _Recording(JaxLdaModel(JaxLdaConfig(**kw), jfc))
    with JaxMetricsLog(tmp_path / "ref.jsonl") as log:
        jax_run_inference(jmodel, JaxLdaConfig(**kw), jfc, metrics=log,
                          ll_every=2, optimize_hyper_every=2)
    ref = jax_read_metrics(tmp_path / "ref.jsonl")

    cfg = LdaConfig(**kw)
    model = LdaModel(cfg, fc, device="cpu")
    states = iter(jmodel.states)

    def replay(n=1):  # the port's model takes the JAX chain's next state
        model.state = interop.from_jax_state(next(states))

    model.sweep = replay
    with MetricsLog(tmp_path / "port.jsonl") as log:
        run_inference(model, cfg, fc, metrics=log, ll_every=2,
                      optimize_hyper_every=2)
    rows = read_metrics(tmp_path / "port.jsonl")
    assert [r["sweep"] for r in rows] == [r["sweep"] for r in ref]
    assert [sorted(set(r) - {"time"}) for r in rows] == [
        sorted(set(r) - {"time"}) for r in ref]
    assert sum("log_likelihood" in r for r in rows) == 3
    for got, want in zip(rows[1:], ref[1:]):
        for key in ("log_likelihood", "perplexity", "alpha", "beta"):
            if key in want:
                assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert rows[-1]["alpha"] != 0.5 and rows[-1]["beta"] != 0.1


def test_hyper_updates_reach_the_next_sweep():
    # the deferred sweep reads α and β at every call: after an update the
    # chain differs from one that keeps the old values
    rng = np.random.default_rng(10)
    ragged = [[int(x) for x in rng.integers(0, 50, size=40)] for _ in range(24)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=50)
    cfg = LdaConfig(topic_num=6, seed=4, block_size=128)
    a, b = LdaModel(cfg, fc, device="cpu"), LdaModel(cfg, fc, device="cpu")
    a.sweep(3)
    b.sweep(3)
    alpha, beta = a.optimize_hyperparameters()
    assert (alpha, beta) == (a.alpha, a.beta) != (0.5, 0.1)
    a.sweep(2)
    b.sweep(2)
    assert not torch.equal(a.state.z, b.state.z)
    a.check_counts_consistent()


def test_cli_ll_and_hyper_rows(tmp_path):
    rc = cli.main([
        "--generate-minicorpus", "--docs", str(tmp_path / "docs"),
        "--results", str(tmp_path / "res"), "-k", "8", "--iterations", "60",
        "--save-step", "10", "--begin-save-iters", "50", "--device", "cpu",
        "--ll-every", "5", "--optimize-hyper-every", "5", "--metrics-every", "0",
        "--metrics-file", str(tmp_path / "m.jsonl")])
    assert rc == 0
    rows = read_metrics(tmp_path / "m.jsonl")
    ll_rows = [r for r in rows if "log_likelihood" in r]
    assert [r["sweep"] for r in ll_rows] == list(range(4, 60, 5))
    assert all(np.isfinite(r["log_likelihood"]) and r["perplexity"] > 1
               for r in ll_rows)
    assert all({"alpha", "beta"} <= set(r) for r in rows[1:])
    assert ll_rows[-1]["alpha"] != 0.5


def test_evaluation_exports_equal_reference():
    """``evaluation``'s four exports, as the JAX package's
    (``ldagibbssampling_tpu/evaluation/__init__.py:8-15``), on one input."""
    import ldagibbssampling_tpu.evaluation as jax_evaluation

    import ldagibbssampling_tpu_torch.evaluation as evaluation

    assert evaluation.__all__ == jax_evaluation.__all__
    rng = np.random.default_rng(9)
    ragged = [[int(x) for x in rng.integers(0, 30, size=24)] for _ in range(8)]
    fc = FlatCorpus.from_ragged(ragged, vocab_size=30)
    jfc = JaxFlatCorpus(fc.token_word, fc.token_doc, fc.doc_ptr, fc.vocab_size)
    phi = rng.dirichlet(np.ones(30), size=4)
    theta = rng.dirichlet(np.ones(4), size=8)
    for name in ("log_likelihood", "perplexity"):
        assert getattr(evaluation, name)(phi, theta, fc) == getattr(
            jax_evaluation, name)(phi, theta, jfc), name
    assert evaluation.heldout_perplexity(phi, fc, 0.5, n_sweeps=5, seed=3) == \
        pytest.approx(jax_evaluation.heldout_perplexity(phi, jfc, 0.5, n_sweeps=5,
                                                        seed=3), rel=1e-12)
    traces = rng.normal(size=(4, 40))
    assert evaluation.r_hat(traces) == jax_evaluation.r_hat(traces)


def test_annotate_names_a_profiler_region():
    """``tracing.annotate`` (the reference's ``jax.profiler.TraceAnnotation``
    region) is a ``torch.profiler`` region of that name."""
    from torch.profiler import ProfilerActivity, profile

    from ldagibbssampling_tpu_torch.evaluation.tracing import annotate

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("lda_sweep_region"):
            torch.ones(8).sum()
    assert "lda_sweep_region" in {e.key for e in prof.key_averages()}
