"""The port's benchmark ladder (``benchmarks/ladder.py``) on the CPU at a
tiny scale: rungs 1, 2, 4 and 5 run through the port's own models and
report at least the keys the JAX package's ladder reports (its tracked
``ladder_report.json``); ``--rungs 3`` exits 2 naming ROADMAP item 14."""

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
    out = tmp_path / "r.json"
    assert ladder.main(["--rungs", "3", "--out", str(out), "--device", "cpu"]) == 2
    assert "item 14" in capsys.readouterr().err and not out.exists()
    assert ladder.main(["--rungs", "2", "--scale", "0.001", "--out", str(out),
                        "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["gate_failures"] == [] and rep["rungs"][0]["rung"] == 2
    assert "wall_s" in rep["rungs"][0]


def test_default_out_is_not_a_tracked_report(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ladder.main(["--rungs", "2", "--scale", "0.001", "--device", "cpu"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["ladder_report_torch.json"]
    assert "ladder_report_torch.json" in (REPO / ".gitignore").read_text().split()
