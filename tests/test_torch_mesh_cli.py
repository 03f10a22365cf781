"""The port's CLI with ``--mesh`` on the CPU (``--device cpu``), with
``parallel/multihost.local_devices`` patched to eight ``cpu`` positions
(the eight virtual devices the JAX tests get from ``tests/conftest.py``):

- ``data=2``, ``data=2,vocab=2``, ``token=2`` and ``chain=2,data=2`` train
  with ``--check-counts`` (every table an exact recount), write the five
  artifacts, and with ``--ll-every``/``--optimize-hyper-every`` write
  metrics rows with the LL, α and β (the chain mesh: R̂ too);
- unpatched (one position, as the reference on one device) ``data=4``
  trains one shard and ``data=2,vocab=2`` raises;
- a ``--mesh data=2`` run killed at sweep 4 and resumed to 8 writes the
  uninterrupted run's artifacts byte for byte;
- an unknown axis raises the reference's ``ValueError``;
- the runner's batched sweeps give the per-sweep loop's chain and
  artifacts on a mesh, and its LL rows take the mesh's device LL.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.backends import make_backend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.parallel import multihost
from test_torch_mesh_sweep import mesh_corpora

torch.set_num_threads(1)

ARTIFACTS = ("params", "phi", "theta", "tassign", "twords")


@pytest.fixture
def eight_positions(monkeypatch):
    monkeypatch.setattr(multihost, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)


def _cli(docs, *flags):
    return cli.main(["--docs", str(docs), "-k", "4", "--seed", "1",
                     "--device", "cpu", "--block-size", "256", *flags])


@pytest.mark.parametrize("mesh,shards", [
    ("data=2", 2), ("data=2,vocab=2", 4), ("token=2", 2), ("chain=2,data=2", 4),
    ("data=-1", 8)])
def test_cli_mesh_runs(tmp_path, capsys, eight_positions, mesh, shards):
    docs = write_minicorpus(tmp_path / "docs", num_docs=8)
    metrics = tmp_path / "m.jsonl"
    assert _cli(docs, "--mesh", mesh, "--results", str(tmp_path / "r"),
                "--iterations", "8", "--save-step", "4", "--begin-save-iters", "4",
                "--check-counts", "--ll-every", "4", "--optimize-hyper-every", "4",
                "--metrics-file", str(metrics)) == 0
    assert "bitwise-consistent" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert names == sorted(f"lda_{i}.{e}" for i in (4, 8) for e in ARTIFACTS)
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert rows[0]["kernel_tier"] == "deferred"
    last = rows[-1]
    assert last["sweep"] == 7 and {"log_likelihood", "perplexity", "alpha",
                                   "beta"} <= set(last)
    if mesh.startswith("chain"):
        assert "r_hat" in last
    cfg = LdaConfig(topic_num=4, block_size=256, mesh=dict(
        (k, int(v)) for k, v in (kv.split("=") for kv in mesh.split(","))))
    model = make_backend(cfg, mesh_corpora(1)[1], device="cpu")
    runtime = getattr(model, "chains", model)
    assert runtime.mesh.size == shards


def test_one_position_as_the_reference_on_one_device(tmp_path):
    _, pc = mesh_corpora(2)
    model = make_backend(LdaConfig(topic_num=4, mesh={"data": 4}), pc, device="cpu")
    assert model.mesh.size == 1  # ShardedLda's Mesh(devs[:4]) of one device
    model.sweep(1)
    model.check_counts_consistent()
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_backend(LdaConfig(topic_num=4, mesh={"data": 2, "vocab": 2}), pc,
                     device="cpu")
    with pytest.raises(ValueError, match="conflicts with mesh chain=2"):
        make_backend(LdaConfig(topic_num=4, chains=3, mesh={"chain": 2, "data": 1}),
                     pc, device="cpu")


def test_cli_mesh_resume_writes_the_uninterrupted_artifacts(tmp_path, capsys,
                                                            eight_positions):
    docs = write_minicorpus(tmp_path / "docs", num_docs=8)
    flags = ["--mesh", "data=2", "--save-step", "2", "--begin-save-iters", "4"]
    assert _cli(docs, *flags, "--results", str(tmp_path / "full"),
                "--iterations", "8", "--optimize-hyper-every", "3") == 0
    assert _cli(docs, *flags, "--no-save", "--iterations", "4",
                "--optimize-hyper-every", "3", "--checkpoint-dir",
                str(tmp_path / "ck"), "--checkpoint-every", "2") == 0
    capsys.readouterr()
    assert _cli(docs, *flags, "--results", str(tmp_path / "resumed"),
                "--iterations", "8", "--optimize-hyper-every", "3",
                "--checkpoint-dir", str(tmp_path / "ck"), "--resume") == 0
    assert "Resumed from sweep 4" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "resumed").iterdir())
    assert names == sorted(f"lda_{i}.{e}" for i in (4, 6, 8) for e in ARTIFACTS)
    for name in names:
        assert ((tmp_path / "resumed" / name).read_bytes()
                == (tmp_path / "full" / name).read_bytes()), name


def test_unknown_axes_rejected(tmp_path, eight_positions):
    docs = write_minicorpus(tmp_path / "docs", num_docs=4)
    with pytest.raises(ValueError, match="unsupported mesh axes"):
        _cli(docs, "--mesh", "pipeline=2", "--no-save", "--iterations", "2")


def test_runner_chunked_schedule_and_device_ll(tmp_path, eight_positions):
    """As ``tests/test_mesh_backend.py:84`` and ``test_mesh_device_ll.py:66``:
    the runner's batched sweeps give the per-sweep loop's chain and
    artifacts, and its ``--ll-every`` rows take the mesh's device LL."""
    from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
    from ldagibbssampling_tpu_torch.runner import run_inference

    _, pc = mesh_corpora(3)
    cfg = LdaConfig(topic_num=4, block_size=256, seed=7, iteration=12,
                    save_step=4, begin_save_iters=4, mesh={"data": 2})
    batched = make_backend(cfg, pc, device="cpu")
    lines = []
    run_inference(batched, cfg, pc, tmp_path / "a", progress=lines.append)
    assert lines == list(range(12))
    stepped = make_backend(cfg, pc, device="cpu")
    calls = []
    stepped.device_log_likelihood = lambda f=stepped.device_log_likelihood: (
        calls.append(1), f())[1]
    with MetricsLog(tmp_path / "m.jsonl") as metrics:
        run_inference(stepped, cfg, pc, tmp_path / "b", metrics=metrics, ll_every=2)
    rows = read_metrics(tmp_path / "m.jsonl")
    assert len(calls) == 6 and all(np.isfinite(r["log_likelihood"])
                                   for r in rows if "log_likelihood" in r)
    np.testing.assert_array_equal(batched.arrays()["z"], stepped.arrays()["z"])
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "b").iterdir())
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
