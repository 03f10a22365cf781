"""ctypes bindings of the port's native (C++) corpus ingest.

Counterpart of ``ldagibbssampling_tpu/corpus/native.py``.  The reference's
ingestion (``Documents.readDocs``, ``src/liuyang/nlp/lda/main/
Documents.java``, SURVEY.md §3.1) is pure Java; the port keeps the
pure-Python fidelity pipeline (``corpus/documents.py``) and adds this
native route for large corpora, where host-side preprocessing otherwise
sets the time to the first sweep.

The output equals the Python pipeline's on ASCII corpora (token ids,
vocabulary order, term counts; ``tests/test_torch_native_corpus.py``).  The
native lowercaser covers ASCII A-Z only, so a corpus with any non-ASCII byte
takes the Python pipeline: that is the rule for correctness, not a
fallback.

The library is built from ``csrc/ldacorpus.cc`` at first use by
``ops/_build.build_host`` (``$CXX``, default ``g++``) into ``_build/``
under a digest name, atomically.  Where it cannot be built or loaded,
``read_docs_flat`` takes the Python pipeline and says so in its route.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.ops import _build

_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}  # library path -> the loaded library


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.lda_ingest.restype = ctypes.c_void_p
    lib.lda_ingest.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_char_p, i64p,
        ctypes.c_int64,
    ]
    for name in ("lda_num_tokens", "lda_num_docs", "lda_vocab_size",
                 "lda_vocab_bytes"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name, args in (
            ("lda_copy_tokens", [ctypes.c_void_p, ctypes.c_void_p]),
            ("lda_copy_doc_ptr", [ctypes.c_void_p, ctypes.c_void_p]),
            ("lda_copy_vocab", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
            ("lda_copy_term_counts", [ctypes.c_void_p, ctypes.c_void_p]),
            ("lda_destroy", [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args


def _load() -> tuple[Optional[ctypes.CDLL], str]:
    """``(library, "")``, building it if needed, or ``(None, why not)``.
    A failure is not remembered: the next call tries again."""
    try:
        path = _build.build_host("ldacorpus")
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    with _LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                return None, f"cannot load {path.name}: {e}"
            _declare(lib)
            _LIBS[path] = lib
    return lib, ""


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None when unavailable."""
    return _load()[0]


def native_available() -> bool:
    return load_library() is not None


def _offsets(chunks: Sequence[bytes]) -> np.ndarray:
    off = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in chunks], out=off[1:])
    return off


def _ingest(
    lib: ctypes.CDLL, texts: Sequence[bytes], stopwords: Optional[Sequence[str]],
) -> tuple[np.ndarray, np.ndarray, tuple[str, ...], np.ndarray]:
    if stopwords is None:
        from ldagibbssampling_tpu_torch.corpus.stopwords import STOPWORDS

        stopwords = sorted(STOPWORDS)
    stop_b = [s.encode("utf-8") for s in stopwords]
    text_buf = b"".join(texts)
    doc_off = _offsets(texts)
    stop_buf = b"".join(stop_b)
    stop_off = _offsets(stop_b)
    i64p = ctypes.POINTER(ctypes.c_int64)
    h = lib.lda_ingest(text_buf, doc_off.ctypes.data_as(i64p), len(texts),
                       stop_buf, stop_off.ctypes.data_as(i64p), len(stop_b))
    if not h:
        raise RuntimeError("native ingest failed")
    try:
        t = lib.lda_num_tokens(h)
        m = lib.lda_num_docs(h)
        v = lib.lda_vocab_size(h)
        vb = lib.lda_vocab_bytes(h)
        token_word = np.empty(t, dtype=np.int32)
        doc_ptr = np.empty(m + 1, dtype=np.int64)
        vocab_buf = ctypes.create_string_buffer(max(1, vb))
        vocab_off = np.empty(v + 1, dtype=np.int64)
        term_counts = np.empty(v, dtype=np.int64)
        if t:
            lib.lda_copy_tokens(h, token_word.ctypes.data)
        lib.lda_copy_doc_ptr(h, doc_ptr.ctypes.data)
        lib.lda_copy_vocab(h, vocab_buf, vocab_off.ctypes.data)
        if v:
            lib.lda_copy_term_counts(h, term_counts.ctypes.data)
        raw, off = vocab_buf.raw[:vb], vocab_off.tolist()
        vocab = tuple(raw[off[i]:off[i + 1]].decode("utf-8") for i in range(v))
        return token_word, doc_ptr, vocab, term_counts
    finally:
        lib.lda_destroy(h)


def ingest_texts(
    texts: Sequence[bytes],
    stopwords: Optional[Sequence[str]] = None,
) -> tuple[np.ndarray, np.ndarray, tuple[str, ...], np.ndarray]:
    """Run the native ingester over in-memory document bytes.

    Returns ``(token_word [T] int32, doc_ptr [M+1] int64, vocab, term_counts)``.
    Raises ``RuntimeError`` when the native library is unavailable: callers
    wanting the Python route in that case use :func:`read_docs_flat`.
    """
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native corpus library unavailable: {why}")
    return _ingest(lib, texts, stopwords)


def read_texts(path: str | Path, *, directory_order: bool = False) -> List[bytes]:
    """The bytes of every file in ``path``, in the ingest's order: sorted
    names, or raw directory order with ``directory_order`` (as
    ``Documents.read_docs``).  The directory is listed once, by
    ``os.scandir``, and whether an entry is a file comes from that listing,
    not from one ``stat`` per file: on a network or virtual file system
    each ``stat`` is a round trip."""
    entries = list(os.scandir(path))
    if not directory_order:
        entries.sort(key=lambda e: e.name)
    texts = []
    for e in entries:
        if e.is_file():
            with open(e.path, "rb") as f:
                texts.append(f.read())
    return texts


def read_docs_routed(
    path: str | Path,
    *,
    directory_order: bool = False,
    force_python: bool = False,
) -> tuple[FlatCorpus, str]:
    """:func:`read_docs_flat` and the route it took: ``"native"``, or
    ``"python (<reason>)"``."""
    p = Path(path)
    if force_python:
        route = "python (forced)"
    else:
        lib, why = _load()
        if lib is None:
            route = f"python (no native library: {why})"
        else:
            texts = read_texts(p, directory_order=directory_order)
            if all(b.isascii() for b in texts):
                token_word, doc_ptr, vocab, _ = _ingest(lib, texts, None)
                token_doc = np.repeat(
                    np.arange(len(texts), dtype=np.int32), np.diff(doc_ptr))
                return FlatCorpus(
                    token_word=token_word,
                    token_doc=token_doc,
                    doc_ptr=doc_ptr.astype(np.int32),
                    vocab_size=len(vocab),
                    vocab=vocab,
                ), "native"
            route = "python (non-ASCII corpus)"

    from ldagibbssampling_tpu_torch.corpus.documents import Documents

    docs = Documents().read_docs(p, directory_order=directory_order)
    return FlatCorpus.from_documents(docs), route


def read_docs_flat(
    path: str | Path,
    *,
    directory_order: bool = False,
    force_python: bool = False,
) -> FlatCorpus:
    """Directory ingestion straight to a :class:`FlatCorpus`.

    Uses the native library when it is available *and* the corpus is pure
    ASCII (the same output as the Python pipeline: the lowercase step is the
    only byte-dependent operation); otherwise ``Documents.read_docs`` +
    ``FlatCorpus.from_documents``.  :func:`read_docs_routed` also says which.
    """
    return read_docs_routed(path, directory_order=directory_order,
                            force_python=force_python)[0]
