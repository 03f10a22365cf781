"""The port's benchmark ladder (``benchmarks/ladder.py``) on the CPU at a
tiny scale: rungs 1 to 5 run through the port's own models and report at
least the keys the JAX package's ladder reports (its tracked
``ladder_report.json``); rung 3 runs the document-sharded runtime in the
deferred tier with exact counts."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.benchmarks import ladder

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _reference_keys(rung):
    report = json.loads((REPO / "ladder_report.json").read_text())
    (res,) = [r for r in report["rungs"] if r["rung"] == rung]
    return set(res) - {"wall_s"}


def test_rung1_fidelity_and_gap():
    res = ladder.rung1(scale=1.0, sweeps=20, device="cpu")
    assert _reference_keys(1) <= set(res)
    assert res["bitwise_z_match"] is True
    assert res["rel_gap"] < 0.2 and res["kernel_tier"] == "xla"


def test_rung2_reports_tokens_and_heldout():
    res = ladder.rung2(scale=0.002, sweeps=2, device="cpu")
    assert _reference_keys(2) <= set(res)
    assert res["tokens_per_s"] > 0 and np.isfinite(res["held_out_ppl"])


def test_rung4_gated_r_hat():
    res = ladder.rung4(scale=0.001, sweeps=16, sweep_cap_factor=2, device="cpu")
    assert _reference_keys(4) <= set(res)
    assert res["gate"] in ("PASSED", "FAILED") and res["chains"] == 4
    assert res["sweeps"] <= res["sweep_cap"]
    assert np.isfinite(res["r_hat_phi_p99"]) and res["alpha_opt"] > 0


def test_rung5_five_backends():
    res = ladder.rung5(scale=0.0005, sweeps=2, device="cpu")
    assert _reference_keys(5) <= set(res)
    v = 400
    for name in ("gibbs", "cvb0", "svi", "warp", "smc"):
        assert 0 < res[f"{name}_perplexity"] < v, name
        assert res[f"{name}_tokens_per_s"] > 0
    assert res["smc_passes"] == 1


def test_main_writes_report_and_refuses_rung3(tmp_path, capsys):
    """Named for the refusal it held before rung 3 was ported: ``--rungs 3``
    now runs (exit 0, its dict in the report), and an unknown rung exits
    2."""
    out = tmp_path / "r.json"
    assert ladder.main(["--rungs", "6", "--out", str(out), "--device", "cpu"]) == 2
    assert "unknown rungs" in capsys.readouterr().err and not out.exists()
    assert ladder.main(["--rungs", "2,3", "--scale", "0.0002", "--out", str(out),
                        "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["gate_failures"] == [] and [r["rung"] for r in rep["rungs"]] == [2, 3]
    assert "wall_s" in rep["rungs"][0]
    assert rep["rungs"][1]["kernel_tier"] == "deferred"


def test_rung3_sharded_deferred_counts_exact(monkeypatch):
    """Rung 3 over two CPU positions: every position a shard, the deferred
    tier, exact counts (``check_counts_consistent`` inside the rung)."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)
    res = ladder.rung3(scale=0.0002, sweeps=1, device="cpu")
    assert _reference_keys(3) <= set(res)
    assert res["kernel_tier"] == "deferred" and res["counts_consistent"] is True
    assert res["devices"] == res["shards"] == 2 and res["K"] == 100
    assert res["tokens"] > 0 and np.isfinite(res["held_out_ppl"])


def test_default_out_is_not_a_tracked_report(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ladder.main(["--rungs", "2", "--scale", "0.001", "--device", "cpu"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["ladder_report_torch.json"]
    assert "ladder_report_torch.json" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("docs,vocab,topics,length,seed", [
    (60, 300, 10, 80, 3), (40, 5000, 15, 100, 4), (7, 50, 3, 5, 0)])
def test_planted_corpus_equals_reference(docs, vocab, topics, length, seed):
    """The port's planted-topic generator (each topic's word CDF computed
    once) draws the JAX package's corpus and φ bit for bit."""
    from ldagibbssampling_tpu.data.synthetic import planted_topic_corpus as jax_planted

    from ldagibbssampling_tpu_torch.data.synthetic import planted_topic_corpus

    got, phi = planted_topic_corpus(docs, vocab, topics, mean_doc_len=length, seed=seed)
    want, phi_ref = jax_planted(docs, vocab, topics, mean_doc_len=length, seed=seed)
    np.testing.assert_array_equal(phi, phi_ref)
    for name in ("token_word", "token_doc", "doc_ptr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.vocab_size == want.vocab_size
