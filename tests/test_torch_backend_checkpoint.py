"""Backend checkpoints (``lda_io/checkpoint.save_backend_run``): a resumed
CVB0 or SVI run is the uninterrupted one bit for bit on the CPU (the JAX
package's ``tests/test_resume_cli.py:88-130`` holds its own to rel 1e-5),
through the API and through the CLI's artifacts; and the CLI's refusals,
in the reference's words: checkpoints and resume for smc, warp and several
chains, ``--check-counts`` for a backend without integer count tables."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model
from ldagibbssampling_tpu_torch.backends.svi import SviModel
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.lda_io.checkpoint import (
    latest_step, restore_backend_run, save_backend_run)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ARTIFACTS = ("params", "phi", "theta", "tassign", "twords")


def _corpus(seed, num_docs=20, vocab=30):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, vocab, size=int(rng.integers(5, 30)))]
              for _ in range(num_docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def test_backend_run_round_trip_and_layout(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "n": np.ones((4,), np.float32)}
    meta = {"sweeps": 3, "rng_state": rng.bit_generator.state}
    for step in (1, 2, 3, 4, 2):  # newest three kept; a step not above is skipped
        save_backend_run(tmp_path, arrays, {**meta, "sweeps": step}, step)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3", "4"]
    assert latest_step(tmp_path) == 4
    like = {"t": torch.zeros(2, 3), "n": np.zeros((4,), np.float32)}
    got, got_meta = restore_backend_run(tmp_path, like)
    assert torch.equal(got["t"], arrays["t"]) and isinstance(got["n"], np.ndarray)
    assert got_meta["sweeps"] == 4 and got_meta["rng_state"] == meta["rng_state"]
    _, old_meta = restore_backend_run(tmp_path, like, step=3)
    assert old_meta["sweeps"] == 3
    with pytest.raises(ValueError, match="checkpoint t"):
        restore_backend_run(tmp_path, {"t": torch.zeros(3, 2), "n": like["n"]})
    with pytest.raises(FileNotFoundError):
        restore_backend_run(tmp_path / "none", like)


def test_cvb0_resume_is_the_uninterrupted_trajectory(tmp_path):
    fc = _corpus(3)
    cfg = LdaConfig(topic_num=4, seed=1, block_size=32, backend="cvb0")
    ref = Cvb0Model(cfg, fc, device="cpu")
    ref.sweep(6)
    a = Cvb0Model(cfg, fc, device="cpu")
    a.sweep(3)
    assert a.save_checkpoint(tmp_path / "ck") == 3
    b = Cvb0Model(cfg, fc, device="cpu")
    assert b.restore_checkpoint(tmp_path / "ck") == 3 == b.sweeps_done
    b.sweep(3)
    for name in ("gamma", "ndk", "nwk", "nk"):
        assert torch.equal(getattr(b, name), getattr(ref, name)), name


def test_svi_resume_is_the_uninterrupted_trajectory(tmp_path):
    fc = _corpus(4)
    cfg = LdaConfig(topic_num=4, seed=2, backend="svi")
    ref = SviModel(cfg, fc, batch_size=4, device="cpu")
    ref.sweep(4)
    a = SviModel(cfg, fc, batch_size=4, device="cpu")
    a.sweep(2)
    assert a.save_checkpoint(tmp_path / "ck") == 2
    b = SviModel(cfg, fc, batch_size=4, device="cpu")
    assert b.restore_checkpoint(tmp_path / "ck") == 2
    b.sweep(2)
    assert torch.equal(b.lam, ref.lam)
    np.testing.assert_array_equal(b.theta(), ref.theta())
    assert b._step_idx == ref._step_idx


@pytest.mark.parametrize("backend", ["cvb0", "svi"])
def test_cli_resume_writes_the_uninterrupted_artifacts(tmp_path, backend):
    docs = write_minicorpus(tmp_path / "docs", num_docs=8)
    common = ["--docs", str(docs), "-k", "4", "--save-step", "5",
              "--begin-save-iters", "15", "--seed", "3", "--backend", backend,
              "--device", "cpu"]
    assert cli.main([*common, "--results", str(tmp_path / "full"),
                     "--iterations", "20"]) == 0
    ck = str(tmp_path / "ck")
    assert cli.main([*common, "--no-save", "--iterations", "10",
                     "--checkpoint-dir", ck, "--checkpoint-every", "5"]) == 0
    assert cli.main([*common, "--results", str(tmp_path / "resumed"),
                     "--iterations", "20", "--checkpoint-dir", ck,
                     "--checkpoint-every", "5", "--resume"]) == 0
    names = sorted(f"lda_{i}.{e}" for i in (15, 20) for e in ARTIFACTS)
    assert sorted(p.name for p in (tmp_path / "full").iterdir()) == names
    for n in names:
        assert ((tmp_path / "full" / n).read_bytes()
                == (tmp_path / "resumed" / n).read_bytes()), n


@pytest.mark.parametrize("flags,message", [
    (["--backend", "smc", "--checkpoint-every", "5"], "does not support checkpointing"),
    (["--backend", "warp", "--checkpoint-every", "5"], "does not support checkpointing"),
    (["--chains", "3", "--checkpoint-every", "5"], "does not support checkpointing"),
    (["--backend", "smc", "--resume"], "does not support resume"),
    (["--backend", "warp", "--resume"], "does not support resume"),
    (["--backend", "cvb0", "--check-counts"], "has no count tables to check"),
    (["--backend", "svi", "--check-counts"], "has no count tables to check"),
    (["--chains", "2", "--check-counts"], "has no count tables to check"),
])
def test_cli_refusals_exit_2(tmp_path, capsys, flags, message):
    docs = write_minicorpus(tmp_path / "docs", num_docs=4)
    rc = cli.main(["--docs", str(docs), "--no-save", "-k", "3", "--iterations",
                   "5", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                   *flags])
    assert rc == 2
    assert message in capsys.readouterr().err
