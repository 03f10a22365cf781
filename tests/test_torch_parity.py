"""Statistical parity through the port: its blocked chain against the serial
oracle (``evaluation/parity.py``), on the CPU.

The three tests of ``tests/test_parity.py`` through the port's ``LdaModel``
and ``OracleSampler`` (``device="cpu"``: the kernels' plain versions).
Tolerance, as there: |z| < 4 on the per-token training LL and the sorted
mean topic entropy (matched sweep budgets, independent seeds); both families
above the uniform model's LL per token.  On the CPU the reference's tests
run its XLA tier (its platform rule), so their ports name that tier; the
port has no platform rule, and one more test holds its default tier, the
deferred one, on the 20-document minicorpus.

``serial_vs_parallel`` runs each mesh runtime (AD-LDA, the 2×2 grid,
token sharding) on eight ``cpu`` positions against the single-device
family at a small budget; its report has the reference's keys (the
reference's own report on the same corpus) and finite z-scores.  The
statistical gate needs a burn-in (the reference's docstring), so the short
budget checks the harness, not the chains.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.corpus.documents import Documents as JaxDocuments
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.evaluation.parity import (
    serial_vs_parallel as jax_serial_vs_parallel)
from ldagibbssampling_tpu.evaluation.parity import z_score as jax_z_score
from ldagibbssampling_tpu_torch.corpus.documents import Documents
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.evaluation.parity import (
    oracle_vs_blocked, serial_vs_parallel, z_score)

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def minicorpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("docs")
    write_minicorpus(d, num_docs=12)
    return FlatCorpus.from_documents(Documents().read_docs(d))


def test_blocked_chain_statistically_matches_oracle(minicorpus):
    report = oracle_vs_blocked(
        minicorpus, k=5, sweeps=30, seeds=(0, 1, 2, 3), block_size=256,
        use_pallas=False, device="cpu", expect_tier="xla",
    )
    assert report["kernel_tier"] == "xla"
    # bias beyond MC error on either functional fails the build
    assert abs(report["z_ll"]) < 4.0, report
    assert abs(report["z_entropy"]) < 4.0, report
    # and both families actually learned something: LL/token above the
    # uniform-model floor log(1/V)
    v = minicorpus.vocab_size
    assert report["oracle"]["ll_per_token_mean"] > -np.log(v)
    assert report["blocked"]["ll_per_token_mean"] > -np.log(v)


def test_small_block_also_passes(minicorpus):
    # near-serial blocked chain (block 16, the XLA tier) — tighter
    # approximation, same result
    report = oracle_vs_blocked(
        minicorpus, k=5, sweeps=20, seeds=(0, 1, 2), block_size=16,
        device="cpu", expect_tier="xla",
    )
    assert abs(report["z_ll"]) < 4.0, report


def test_default_tier_matches_oracle(tmp_path):
    # the deferred tier (K1 against a sweep-stale snapshot of nwk, then K2's
    # rebuild), the port's default, at a block of 256
    fc = FlatCorpus.from_documents(Documents().read_docs(
        write_minicorpus(tmp_path / "docs")))
    report = oracle_vs_blocked(fc, k=5, sweeps=30, seeds=(0, 1, 2, 3),
                               block_size=256, device="cpu",
                               expect_tier="deferred")
    assert abs(report["z_ll"]) < 4.0, report
    assert abs(report["z_entropy"]) < 4.0, report


def test_z_score_helper():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 8)
    assert abs(z_score(a, a)) < 1e-9
    b = a + 100.0
    assert abs(z_score(a, b)) > 50
    assert z_score(a, b) == jax_z_score(a, b)
    assert z_score(np.ones(3), np.ones(3)) == 0.0
    assert z_score(np.ones(3), np.zeros(3)) == float("inf")


@pytest.mark.parametrize("runtime", ["adlda", "grid", "tokenshard"])
def test_serial_vs_parallel_report(minicorpus, tmp_path, monkeypatch, runtime):
    from ldagibbssampling_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    report = serial_vs_parallel(
        minicorpus, k=4, runtime=runtime, sweeps=3, seeds=(0, 1),
        block_size=64, num_shards=4, device="cpu")
    docs = write_minicorpus(tmp_path / "docs", num_docs=12)
    jc = JaxFlatCorpus.from_documents(JaxDocuments().read_docs(docs))
    ref = jax_serial_vs_parallel(jc, k=4, runtime=runtime, sweeps=1,
                                 seeds=(0, 1), block_size=64, num_shards=4)
    assert set(report) == set(ref)
    for family in ("single", runtime):
        assert set(report[family]) == set(ref[family])
        assert report[family]["name"] == family
    assert np.isfinite(report["z_ll"]) and np.isfinite(report["z_entropy"])
