"""The port's native (C++) corpus ingest (``corpus/native.py``,
``csrc/ldacorpus.cc``) on the CPU.

The JAX package's eight native-ingest cases run against the port; the
port's native route is held bitwise against the JAX package's Python
pipeline (``Documents().read_docs`` → ``FlatCorpus.from_documents``) on
the minicorpus, the bundled original documents and an adversarial corpus
made from a seed; the library's build is atomic under threads and processes;
without a compiler ``read_docs_flat`` takes the Python route and says so; and
the CLI logs its route and writes the same artifacts by either route.

These tests need a C++ compiler (``$CXX``, default ``g++``) and skip only
where none is found; a build failure is a failure.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from ldagibbssampling_tpu.corpus.documents import Documents as JaxDocuments
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.corpus import native
from ldagibbssampling_tpu_torch.corpus.documents import Documents
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.corpus.stopwords import STOPWORDS
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import read_metrics
from ldagibbssampling_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = ("params", "phi", "theta", "tassign", "twords")


@pytest.fixture
def compiler():
    """Skip where no C++ compiler is found; elsewhere the library must
    build."""
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which(cxx.split()[0]) is None:
        pytest.skip(f"no C++ compiler ({cxx}) on this machine")
    return cxx


def _python_flat(path):
    return FlatCorpus.from_documents(Documents().read_docs(path))


def _assert_same(a, b):
    np.testing.assert_array_equal(a.token_word, b.token_word)
    np.testing.assert_array_equal(a.token_doc, b.token_doc)
    np.testing.assert_array_equal(a.doc_ptr, b.doc_ptr)
    assert a.token_word.dtype == b.token_word.dtype == np.int32
    assert a.token_doc.dtype == b.token_doc.dtype == np.int32
    assert a.doc_ptr.dtype == b.doc_ptr.dtype == np.int32
    assert a.vocab == b.vocab
    assert a.vocab_size == b.vocab_size


# --- the JAX package's eight cases (tests/test_native_corpus.py), on the port


def test_native_matches_python_on_minicorpus(tmp_path, compiler):
    d = write_minicorpus(tmp_path / "docs", num_docs=20)
    fc, route = native.read_docs_routed(d)
    assert route == "native"
    _assert_same(fc, _python_flat(d))


def test_native_matches_python_on_adversarial_corpus(tmp_path, compiler):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text(
        "The QUICK brown\tfox the THE a\fjumps\r\nover www.example.org "
        "foo.com http://x 1234 ... alpha-beta c3po \x01weird\x01 trailing  "
    )
    (docs / "b.txt").write_text("")  # empty file
    (docs / "c.txt").write_text("and or but the of")  # all stopwords
    (docs / "d.txt").write_text("alpha beta gamma alpha beta alpha")
    fc, route = native.read_docs_routed(docs)
    assert route == "native"
    _assert_same(fc, _python_flat(docs))


def test_native_term_counts_match_python(tmp_path, compiler):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "x.txt").write_text("apple banana apple cherry banana apple")
    tw, ptr, vocab, counts = native.ingest_texts(
        [(docs / "x.txt").read_bytes()])
    py = Documents().read_docs(docs)
    assert vocab == tuple(py.index_to_term)
    assert {v: int(c) for v, c in zip(vocab, counts)} == py.term_count
    assert list(tw) == py.docs[0].doc_words
    assert list(ptr) == [0, len(tw)]


def test_native_noise_and_stopword_filtering(compiler):
    tw, ptr, vocab, counts = native.ingest_texts(
        [b"the apple WWW.foo bar.com http://baz 42 !!! zebra"])
    assert vocab == ("apple", "zebra")
    assert list(tw) == [0, 1]
    assert list(counts) == [1, 1]


def test_non_ascii_corpus_falls_back_to_python(tmp_path, compiler):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text("café résumé apple", encoding="utf-8")
    fc, route = native.read_docs_routed(docs)
    assert route == "python (non-ASCII corpus)"
    _assert_same(fc, _python_flat(docs))
    # the Python pipeline lowercases unicode; the word must be present
    assert "café" in fc.vocab


def test_directory_order_flag(tmp_path, compiler):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "b.txt").write_text("bravo")
    (docs / "a.txt").write_text("alpha")
    assert native.read_docs_flat(docs).vocab == ("alpha", "bravo")  # sorted
    fc = native.read_docs_flat(docs, directory_order=True)  # os.listdir's
    assert fc.vocab == tuple({"a.txt": "alpha", "b.txt": "bravo"}[n]
                             for n in os.listdir(docs))
    _assert_same(fc, FlatCorpus.from_documents(
        Documents().read_docs(docs, directory_order=True)))


def test_empty_directory(tmp_path, compiler):
    docs = tmp_path / "docs"
    docs.mkdir()
    fc, route = native.read_docs_routed(docs)
    assert route == "native"
    assert fc.num_docs == 0 and fc.num_tokens == 0 and fc.vocab_size == 0


def test_force_python_matches_native(tmp_path, compiler):
    d = write_minicorpus(tmp_path / "docs", num_docs=6)
    fc, route = native.read_docs_routed(d, force_python=True)
    assert route == "python (forced)"
    _assert_same(fc, native.read_docs_flat(d))


@pytest.mark.parametrize("directory_order", [False, True])
def test_entries_that_are_not_files_are_skipped_as_by_python(
        tmp_path, compiler, directory_order):
    """A subdirectory is skipped, a link to a file is read and a dangling
    link skipped, as ``Path.is_file`` decides in the Python pipeline."""
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "b.txt").write_text("bravo charlie")
    (docs / "a_dir").mkdir()
    (docs / "a_dir" / "x.txt").write_text("hidden")
    (tmp_path / "outside.txt").write_text("delta echo")
    (docs / "c_link.txt").symlink_to(tmp_path / "outside.txt")
    (docs / "d_dangling.txt").symlink_to(tmp_path / "missing.txt")
    fc, route = native.read_docs_routed(docs, directory_order=directory_order)
    assert route == "native"
    _assert_same(fc, FlatCorpus.from_documents(
        Documents().read_docs(docs, directory_order=directory_order)))
    assert fc.num_docs == 2 and "hidden" not in fc.vocab


# --- cross-package parity: the port's native route against the JAX
# package's Python pipeline, bitwise


_WORDS = ("Market", "STOCKS", "goal", "Team", "quantum", "Voter", "chip",
          "alpha-beta", "c3po", "x.y", "MiXeD", "I")
_NOISE = ("1234", "007", "...", "!!!", "www.example.org", "http://x.org/a",
          "shop.com", "SHOP.COM", "a.com.b", "42.5", "--")
_SEPS = (" ", "  ", "\t", "\n", "\r\n", "\f", " \t ", "\r\n\r\n")


def _adversarial(root: Path, seed: int = 7, num_docs: int = 40) -> Path:
    """Files of capitals, tabs, CRLF and lone CR line ends, form feeds,
    stopwords, URLs, ``.com``, digit-only tokens, control characters,
    random letter words, and empty files, from a numpy seed."""
    rng = np.random.default_rng(seed)
    stop = sorted(STOPWORDS)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    root.mkdir(parents=True)
    for m in range(num_docs):
        if m % 9 == 4:
            (root / f"doc{m:03d}.txt").write_bytes(b"")
            continue
        parts = []
        for _ in range(int(rng.integers(1, 120))):
            kind = rng.integers(0, 10)
            if kind < 4:
                tok = "".join(rng.choice(letters, size=int(rng.integers(1, 9))))
            elif kind < 5:
                tok = str(_WORDS[int(rng.integers(0, len(_WORDS)))])
            elif kind < 7:
                tok = stop[int(rng.integers(0, len(stop)))]
                tok = tok.upper() if rng.random() < 0.3 else tok
            elif kind < 9:
                tok = _NOISE[int(rng.integers(0, len(_NOISE)))]
            else:
                tok = "\x01" + "".join(rng.choice(letters, size=3)) + "\x0b"
            parts.append(tok)
            parts.append(_SEPS[int(rng.integers(0, len(_SEPS)))])
            if rng.random() < 0.02:
                parts.append("\r")  # a lone CR: a line end to Python's reader
        (root / f"doc{m:03d}.txt").write_bytes("".join(parts).encode("ascii"))
    return root


def _corpus_dir(name: str, tmp_path: Path) -> Path:
    if name == "minicorpus":
        return write_minicorpus(tmp_path / "docs", num_docs=20)
    if name == "original":
        return REPO / "data" / "LdaOriginalDocs"
    return _adversarial(tmp_path / "docs")


@pytest.mark.parametrize("name", ["minicorpus", "original", "adversarial"])
def test_native_route_equals_the_jax_python_pipeline(tmp_path, compiler, name):
    d = _corpus_dir(name, tmp_path)
    fc, route = native.read_docs_routed(d)
    assert route == "native"
    jdocs = JaxDocuments().read_docs(d)
    ref = JaxFlatCorpus.from_documents(jdocs)
    _assert_same(fc, ref)
    assert fc.num_tokens > 0
    # term counts: the native library's and the tokens' against the JAX
    # pipeline's, in vocabulary order
    want = np.array([jdocs.term_count[t] for t in ref.vocab], np.int64)
    texts = [p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()]
    tw, ptr, vocab, counts = native.ingest_texts(texts)
    assert vocab == ref.vocab
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(tw, ref.token_word)
    np.testing.assert_array_equal(ptr, ref.doc_ptr.astype(np.int64))
    np.testing.assert_array_equal(
        np.bincount(fc.token_word, minlength=fc.vocab_size), want)


# --- the build: atomic, digest-named, in the build directory


def _lib_name() -> str:
    return _build._lib_path("ldacorpus", ".cc", _build.HOST_FLAGS)[1].name


def test_library_is_built_from_the_port_source_under_a_digest_name(compiler):
    src, out = _build._lib_path("ldacorpus", ".cc", _build.HOST_FLAGS)
    assert src == REPO / "ldagibbssampling_tpu_torch" / "csrc" / "ldacorpus.cc"
    assert re.fullmatch(r"libldacorpus-[0-9a-f]{16}\.so", out.name)
    assert "ldacorpus" not in _build.SOURCES  # not a kernel: nvcc never sees it
    assert native.load_library() is not None and native.native_available()


_LOAD_IN_PROCESS = """
import json, sys
from pathlib import Path
from ldagibbssampling_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
from ldagibbssampling_tpu_torch.corpus import native
tw, ptr, vocab, counts = native.ingest_texts([b"alpha Beta alpha the", b"gamma"])
print(json.dumps([tw.tolist(), ptr.tolist(), vocab, counts.tolist()]))
"""
_EXPECTED = [[0, 1, 0, 2], [0, 3, 4], ["alpha", "beta", "gamma"], [2, 1, 1]]


def test_build_is_atomic_under_two_threads(tmp_path, monkeypatch, compiler):
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    barrier, results, errors = threading.Barrier(2), [None, None], []

    def load(i):
        try:
            barrier.wait(timeout=60)
            tw, ptr, vocab, counts = native.ingest_texts(
                [b"alpha Beta alpha the", b"gamma"])
            results[i] = [tw.tolist(), ptr.tolist(), list(vocab), counts.tolist()]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert results == [_EXPECTED, _EXPECTED]
    assert [p.name for p in build.iterdir()] == [_lib_name()]


def test_build_is_atomic_under_two_processes(tmp_path, compiler):
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_IN_PROCESS, str(build)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert json.loads(out) == _EXPECTED
    assert [p.name for p in build.iterdir()] == [_lib_name()]


@pytest.mark.parametrize("cxx", ["missing", "fails", "no source"])
def test_without_a_compiler_the_python_route_runs(tmp_path, monkeypatch, cxx):
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    if cxx == "no source":  # an installed package without csrc/ldacorpus.cc
        (tmp_path / "csrc").mkdir()
        monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    else:
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++") if cxx == "missing"
                           else shutil.which("false"))
    with pytest.raises(RuntimeError, match="native corpus library unavailable"):
        native.ingest_texts([b"alpha"])
    assert native.load_library() is None and not native.native_available()
    d = write_minicorpus(tmp_path / "docs", num_docs=6)
    fc, route = native.read_docs_routed(d)
    assert route.startswith("python (no native library: ")
    _assert_same(fc, _python_flat(d))
    _assert_same(native.read_docs_flat(d), fc)
    assert not build.exists() or not any(build.iterdir())  # no partial file


def _run_cli(tmp_path, capsys, tag):
    rc = cli.main([
        "--docs", str(tmp_path / "docs"), "--results", str(tmp_path / tag),
        "-k", "8", "--iterations", "20", "--save-step", "10",
        "--begin-save-iters", "10", "--check-counts", "--device", "cpu",
        "--metrics-file", str(tmp_path / f"{tag}.jsonl"),
        "--metrics-every", "0",
    ])
    assert rc == 0
    return capsys.readouterr().out, read_metrics(tmp_path / f"{tag}.jsonl")[0]


def test_cli_logs_the_route_and_writes_the_same_artifacts(
        tmp_path, monkeypatch, capsys, compiler):
    write_minicorpus(tmp_path / "docs", num_docs=20)
    out, header = _run_cli(tmp_path, capsys, "native")
    assert re.search(r"^ingest: native; \d+ tokens of 20 documents in ",
                     out, re.MULTILINE)
    assert header["ingest"] == "native"
    assert header["ingest_s"] >= 0 and header["setup_s"] >= 0
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    out, header = _run_cli(tmp_path, capsys, "python")
    assert "ingest: python (no native library: " in out
    assert header["ingest"].startswith("python (no native library")
    names = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert names == sorted(f"lda_{i}.{e}" for i in (10, 20) for e in ARTIFACTS)
    for n in names:
        assert ((tmp_path / "native" / n).read_bytes()
                == (tmp_path / "python" / n).read_bytes()), n


def test_ingest_benchmark_times_each_source_and_checks_they_agree(
        capsys, compiler):
    from ldagibbssampling_tpu_torch.benchmarks import ingest

    port_src = _build.CSRC / "ldacorpus.cc"
    ref_src = REPO / "native" / "ldacorpus.cc"
    assert ingest.main(["--scale", "0.001", "--repeats", "2",
                        "--source", str(ref_src), "--source", str(port_src)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    texts, tokens = ingest.rung3_texts(0.001)
    assert [r["source"] for r in rows] == [str(ref_src), str(port_src)]
    for r in rows:
        assert r["tokens"] == tokens > 0 and len(r["seconds"]) == 2
    # the rendered corpus is what the native route reads from files
    ids, doc_ptr, vocab, _ = native.ingest_texts(texts)
    assert len(ids) == tokens and len(doc_ptr) == len(texts) + 1
    assert all(5 <= len(t) <= 9 and t.isalpha() for t in vocab)
