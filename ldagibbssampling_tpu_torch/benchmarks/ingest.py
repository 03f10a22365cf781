"""The native ingest library's own rate, on rung 3's corpus as text in memory.

Renders rung 3's whole corpus at ``--scale`` (NYT-shaped: ``zipf_corpus``,
300 tokens per document, before the held-out split) as one bytes object per
document, each word id a term of :func:`rung3_terms`, and times the
library's ``lda_ingest`` on them; no file is written or read, so the time
is the library's alone.  Each ``--source`` is a C++ file with the library's
``extern "C"`` surface (default the port's ``csrc/ldacorpus.cc``), compiled
with ``$CXX`` (default ``g++``) and the port's host flags into a temporary
directory.  The sources are timed in turn, ``--repeats`` rounds, and their
outputs must be equal.  Prints one JSON line per source.

Usage::

    python -m ldagibbssampling_tpu_torch.benchmarks.ingest --scale 0.2 \\
        [--source A.cc --source B.cc] [--repeats 3]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ldagibbssampling_tpu_torch.ops import _build


def rung3_terms(v: int) -> list[bytes]:
    """Word id -> a term of 5-9 lowercase letters, never a stopword and
    never noise: ``x``, the id's four base-26 letters, then ``id % 5`` more
    ``x`` (the first five letters name the id)."""
    from ldagibbssampling_tpu_torch.corpus.documents import is_noise_word
    from ldagibbssampling_tpu_torch.corpus.stopwords import is_stopword

    if v > 26 ** 4:
        raise ValueError(f"V = {v} has no four-letter code")
    letters = "abcdefghijklmnopqrstuvwxyz"
    terms = ["x" + "".join(letters[i // 26 ** j % 26] for j in (3, 2, 1, 0))
             + "x" * (i % 5) for i in range(v)]
    bad = [t for t in terms if is_stopword(t) or is_noise_word(t)]
    if bad:
        raise ValueError(f"terms the ingest would drop: {bad[:5]}")
    return [t.encode() for t in terms]


def rung3_texts(scale: float) -> tuple[list[bytes], int]:
    """Rung 3's whole corpus at ``scale`` as one line of space-separated
    terms per document; returns the texts and the token count."""
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung3_shape
    from ldagibbssampling_tpu_torch.data.synthetic import zipf_corpus

    m, v = rung3_shape(scale)
    corpus = zipf_corpus(m, v, mean_doc_len=300, seed=2)
    terms = rung3_terms(v)
    tw, ptr = corpus.token_word.tolist(), corpus.doc_ptr.tolist()
    texts = [b" ".join([terms[i] for i in tw[ptr[d]:ptr[d + 1]]]) + b"\n"
             for d in range(m)]
    return texts, corpus.num_tokens


def _compile(src: Path, out_dir: Path, tag: int) -> ctypes.CDLL:
    from ldagibbssampling_tpu_torch.corpus.native import _declare

    out = out_dir / f"lib{tag}.so"
    cxx = os.environ.get("CXX") or "g++"
    subprocess.run([*shlex.split(cxx), *_build.HOST_FLAGS, "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib


def main(argv: list[str] | None = None) -> int:
    from ldagibbssampling_tpu_torch.corpus.native import _ingest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--source", action="append", type=Path,
                    help="a C++ ingest source (repeatable; default the port's)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    sources = args.source or [_build.CSRC / "ldacorpus.cc"]

    t0 = time.perf_counter()
    texts, tokens = rung3_texts(args.scale)
    print(f"rung 3 at scale {args.scale}: {len(texts)} documents, {tokens} "
          f"tokens, {sum(map(len, texts))} bytes (rendered in "
          f"{time.perf_counter() - t0:.2f}s)", file=sys.stderr, flush=True)
    times: list[list[float]] = [[] for _ in sources]
    with tempfile.TemporaryDirectory() as tmp:
        libs = [_compile(s, Path(tmp), i) for i, s in enumerate(sources)]
        first = None
        for _ in range(args.repeats):
            for i, lib in enumerate(libs):
                t0 = time.perf_counter()
                got = _ingest(lib, texts, None)
                times[i].append(time.perf_counter() - t0)
                if first is None:
                    first = got
                    if len(got[0]) != tokens:
                        raise AssertionError(f"{len(got[0])} tokens kept, not {tokens}")
                elif not (all(np.array_equal(a, b) for a, b in
                              ((got[0], first[0]), (got[1], first[1]), (got[3], first[3])))
                          and got[2] == first[2]):
                    raise AssertionError(f"{sources[i]} differs from {sources[0]}")
    for src, ts in zip(sources, times):
        print(json.dumps({"source": str(src), "scale": args.scale, "tokens": tokens,
                          "seconds": ts, "tokens_per_s": [tokens / t for t in ts]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
