"""Corpus ingestion and preprocessing.

Reference: ``src/liuyang/nlp/lda/main/Documents.java`` (SURVEY.md §2.1 #3, §3.1):
``Documents.readDocs(path)`` iterates the files of a directory, and each inner
``Document`` reads lines → whitespace-tokenize + lowercase (``FileUtil
.tokenizeAndLowerCase``) → drops stopwords (``Stopwords.isStopword``) and noise
words (``Document.isNoiseWord``: URL-ish tokens or tokens with no ASCII letter)
→ assigns vocabulary ids in first-seen order and counts term frequencies.

Conscious divergences from the reference (documented per SURVEY.md §8.2):

- File order: the reference uses Java ``File.list()`` — an *unspecified*
  filesystem order, making vocab ids irreproducible across machines.  We default
  to sorted filename order for reproducibility; pass ``directory_order=True``
  for raw ``os.listdir`` order (the closest analog of the reference behavior).
- Membership checks are hash-based (dict/frozenset) instead of linear scans —
  same semantics, better complexity.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Iterable, List

from ldagibbssampling_tpu_torch.corpus import fileutil
from ldagibbssampling_tpu_torch.corpus.stopwords import is_stopword

# Noise filter (reference Documents.isNoiseWord :~105): a token is noise when it
# looks URL-ish or contains no ASCII letter at all.
_NOISE_PATTERNS = (
    re.compile(r".*www\..*"),
    re.compile(r".*\.com.*"),
    re.compile(r".*http:.*"),
)
_HAS_LETTER = re.compile(r"[a-zA-Z]")


def is_noise_word(token: str) -> bool:
    """True when the token should be dropped (reference ``Document.isNoiseWord``)."""
    if not _HAS_LETTER.search(token):
        return True
    return any(p.match(token) for p in _NOISE_PATTERNS)


class Document:
    """One ingested document: a sequence of vocabulary ids in token order.

    Mirrors the reference's inner ``Documents.Document`` class: the constructor
    reads the file, tokenizes+lowercases, removes stopwords/noise, and appends
    new terms to the *shared* vocabulary maps in first-seen order.
    """

    __slots__ = ("doc_name", "doc_words")

    def __init__(
        self,
        path: str | Path,
        term_to_index: Dict[str, int],
        index_to_term: List[str],
        term_count: Dict[str, int],
    ) -> None:
        self.doc_name = str(path)
        words: List[str] = []
        for line in fileutil.read_lines(path):
            words.extend(fileutil.tokenize_and_lowercase(line))
        # Reference removes stopwords/noise in place with i-- ; a filter pass is
        # behaviorally identical.
        kept = [w for w in words if w and not is_stopword(w) and not is_noise_word(w)]
        ids: List[int] = []
        for w in kept:
            idx = term_to_index.get(w)
            if idx is None:
                idx = len(index_to_term)
                term_to_index[w] = idx
                index_to_term.append(w)
                term_count[w] = 1
            else:
                term_count[w] = term_count[w] + 1
            ids.append(idx)
        self.doc_words = ids

    def __len__(self) -> int:
        return len(self.doc_words)


class Documents:
    """A corpus: list of documents + shared vocabulary (reference ``Documents``)."""

    def __init__(self) -> None:
        self.docs: List[Document] = []
        self.term_to_index: Dict[str, int] = {}
        self.index_to_term: List[str] = []
        self.term_count: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def read_docs(self, path: str | Path, *, directory_order: bool = False) -> "Documents":
        """Ingest every file in ``path`` (reference ``Documents.readDocs``).

        ``directory_order=True`` iterates raw ``os.listdir`` order (the closest
        analog of Java ``File.list()``); the default sorts filenames for
        reproducible vocab ids (divergence documented in the module docstring).
        """
        p = Path(path)
        names = os.listdir(p)
        if not directory_order:
            names = sorted(names)
        for name in names:
            f = p / name
            if f.is_file():
                self.docs.append(
                    Document(f, self.term_to_index, self.index_to_term, self.term_count)
                )
        return self

    def add_document_tokens(self, tokens: Iterable[str], name: str = "<memory>") -> None:
        """Ingest a pre-tokenized document (engine extension; no reference analog).

        Applies the same stopword/noise filtering and vocab growth as file
        ingestion, so synthetic/test corpora follow one code path.
        """
        doc = Document.__new__(Document)
        doc.doc_name = name
        ids: List[int] = []
        for raw in tokens:
            w = raw.lower().strip()
            if not w or is_stopword(w) or is_noise_word(w):
                continue
            idx = self.term_to_index.get(w)
            if idx is None:
                idx = len(self.index_to_term)
                self.term_to_index[w] = idx
                self.index_to_term.append(w)
                self.term_count[w] = 1
            else:
                self.term_count[w] = self.term_count[w] + 1
            ids.append(idx)
        doc.doc_words = ids
        self.docs.append(doc)

    # ------------------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return len(self.docs)

    @property
    def vocab_size(self) -> int:
        return len(self.index_to_term)

    @property
    def total_tokens(self) -> int:
        return sum(len(d) for d in self.docs)

    def __len__(self) -> int:
        return len(self.docs)
