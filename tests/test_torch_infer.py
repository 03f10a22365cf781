"""The port's fold-in of new documents (``lda_io/infer.py``, the CLI's
``--infer-docs``) against the JAX package's.

Tolerances, all exact: ``read_docs_frozen_vocab`` keeps and drops the same
terms; ``infer_new_docs`` writes ``inferred.theta``, ``.tassign`` and
``.docs`` byte-identical to the reference's for the same φ, documents, α
and seed (both are numpy on the host, line for line); so does the CLI, where
both packages train the serial oracle's chain (bitwise the same chain, so
the same φ).  This mirrors ``tests/test_infer.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from ldagibbssampling_tpu.cli import main as jax_cli_main
from ldagibbssampling_tpu.lda_io.infer import infer_new_docs as jax_infer_new_docs
from ldagibbssampling_tpu.lda_io.infer import (
    read_docs_frozen_vocab as jax_read_docs_frozen_vocab)
from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.lda_io.infer import (
    infer_new_docs, read_docs_frozen_vocab)

INFERRED = ("inferred.theta", "inferred.tassign", "inferred.docs")


def _write(p, name, text):
    (p / name).write_text(text)


def test_frozen_vocab_drops_the_reference_terms(tmp_path):
    d = tmp_path / "new"
    d.mkdir()
    _write(d, "a.txt", "alpha beta gamma unknownword\n")
    _write(d, "b.txt", "beta beta the of\n")  # "the"/"of" are stopwords
    _write(d, "c.txt", "Gamma, gamma-ray 42 x beta!\r\nalpha\n")
    (d / "sub").mkdir()  # not a file: skipped
    vocab = {"alpha": 0, "beta": 1, "gamma": 2}
    got = read_docs_frozen_vocab(d, vocab)
    assert got == jax_read_docs_frozen_vocab(d, vocab)
    names, docs, dropped = got
    assert names == ["a.txt", "b.txt", "c.txt"]
    assert docs[:2] == [[0, 1, 2], [1, 1]]
    assert dropped >= 1


@pytest.mark.parametrize("alpha,seed", [(0.1, 0), (0.7, 5)])
def test_infer_new_docs_byte_identical_to_reference(tmp_path, alpha, seed):
    d = tmp_path / "new"
    d.mkdir()
    _write(d, "doc0.txt", "apple apple banana kiwi\n")
    _write(d, "doc1.txt", "cherry cherry cherry apple banana\n")
    _write(d, "empty.txt", "the of and\n")  # all stopwords -> 0 tokens
    vocab = {"apple": 0, "banana": 1, "cherry": 2, "date": 3}
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.ones(4), size=3)  # [K=3, V=4]
    got = infer_new_docs(phi, d, vocab, alpha, tmp_path / "port", seed=seed)
    want = jax_infer_new_docs(phi, d, vocab, alpha, tmp_path / "ref", seed=seed)
    assert {k: v for k, v in got.items() if k in ("num_docs", "num_tokens",
                                                   "dropped_unknown_terms")} == {
        k: v for k, v in want.items() if k in ("num_docs", "num_tokens",
                                               "dropped_unknown_terms")}
    assert got["num_docs"] == 3 and got["dropped_unknown_terms"] == 1
    for name in INFERRED:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    theta = np.loadtxt(tmp_path / "port" / "inferred.theta")
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(theta[2], 1 / 3, atol=1e-6)


def test_cli_infer_docs_byte_identical_to_reference(tmp_path, monkeypatch, capsys):
    # both CLIs train the serial oracle (bitwise one chain), then fold in
    monkeypatch.chdir(tmp_path)
    write_minicorpus("docs", num_docs=8)
    new = tmp_path / "new"
    new.mkdir()
    first, second = sorted((tmp_path / "docs").iterdir())[:2]
    _write(new, "unseen.txt", first.read_text())
    _write(new, "mixed.txt", second.read_text() + "\nzyzzyva quokka\n")
    common = ["--docs", "docs", "-k", "3", "--iterations", "12",
              "--begin-save-iters", "10", "--save-step", "2", "--seed", "1",
              "--sampler", "serial", "--infer-docs", str(new)]
    assert cli.main([*common, "--results", "port", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Inferred 2 new docs" in out and "unknown terms dropped" in out
    assert jax_cli_main([*common, "--results", "ref"]) == 0
    for name in (*INFERRED, "lda_12.phi"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    theta = np.loadtxt(tmp_path / "port" / "inferred.theta")
    assert theta.shape == (2, 3)


def test_cli_infer_docs_in_the_default_tier(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    write_minicorpus("docs", num_docs=8)
    new = tmp_path / "new"
    new.mkdir()
    _write(new, "unseen.txt", sorted((tmp_path / "docs").iterdir())[0].read_text())
    rc = cli.main(["--docs", "docs", "--no-save", "-k", "3", "--iterations",
                   "4", "--seed", "1", "--device", "cpu", "--infer-docs", str(new)])
    assert rc == 0
    assert "Inferred 1 new docs" in capsys.readouterr().out
    theta = np.loadtxt(tmp_path / "inferred.theta")  # --no-save: the cwd
    assert theta.shape == (3,)
    np.testing.assert_allclose(theta.sum(), 1.0, rtol=1e-5)


def test_cli_infer_docs_missing_dir(tmp_path, capsys):
    docs = write_minicorpus(tmp_path / "docs", num_docs=6)
    rc = cli.main(["--docs", str(docs), "--no-save", "-k", "3", "--iterations",
                   "2", "--device", "cpu", "--infer-docs", str(tmp_path / "no")])
    assert rc == 2
    assert "--infer-docs directory" in capsys.readouterr().err
