"""Flat (CSR/ragged) corpus layout — the device-facing data structure.

The reference stores the corpus as a ragged Java array ``doc[M][N_m]``
(``LdaModel.initializeModel``, SURVEY.md §3.2) and walks it token-by-token.
A TPU engine wants *flat, statically-shaped* arrays instead: one token stream
with parallel word/doc id arrays and a CSR-style ``doc_ptr`` for per-document
slicing.  Token order is identical to the reference's systematic scan order
(doc-major, within-doc original token order), so a serial sweep over the flat
arrays visits exactly the reference's ``(m, n)`` sequence.

``pad_to`` produces block-aligned arrays for the blocked-Gibbs sweep: padding
tokens carry ``token_mask == 0`` and are ignored by the sampler's count updates.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ldagibbssampling_tpu_torch.corpus.documents import Documents


@dataclasses.dataclass(frozen=True)
class FlatCorpus:
    """Flattened corpus: ``token_word[T]``, ``token_doc[T]``, ``doc_ptr[M+1]``."""

    token_word: np.ndarray  # int32 [T] — vocab id of each token
    token_doc: np.ndarray   # int32 [T] — document id of each token
    doc_ptr: np.ndarray     # int32 [M+1] — CSR offsets; doc m is tokens [ptr[m], ptr[m+1])
    vocab_size: int
    vocab: tuple[str, ...] = ()  # index → term (may be empty for bag-of-words corpora)

    # ------------------------------------------------------------------
    @property
    def num_tokens(self) -> int:
        return int(self.token_word.shape[0])

    @property
    def num_docs(self) -> int:
        return int(self.doc_ptr.shape[0]) - 1

    def doc_tokens(self, m: int) -> np.ndarray:
        return self.token_word[self.doc_ptr[m] : self.doc_ptr[m + 1]]

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_ptr)

    # ------------------------------------------------------------------
    @classmethod
    def from_documents(cls, docs: "Documents") -> "FlatCorpus":
        """Flatten a ``Documents`` corpus, preserving reference token order."""
        ragged = [d.doc_words for d in docs.docs]
        return cls.from_ragged(ragged, docs.vocab_size, vocab=tuple(docs.index_to_term))

    @classmethod
    def from_ragged(
        cls,
        ragged: Sequence[Sequence[int]],
        vocab_size: int,
        vocab: tuple[str, ...] = (),
    ) -> "FlatCorpus":
        lengths = [len(d) for d in ragged]
        doc_ptr = np.zeros(len(ragged) + 1, dtype=np.int32)
        np.cumsum(lengths, out=doc_ptr[1:])
        total = int(doc_ptr[-1])
        token_word = np.zeros(total, dtype=np.int32)
        token_doc = np.zeros(total, dtype=np.int32)
        for m, d in enumerate(ragged):
            s, e = doc_ptr[m], doc_ptr[m + 1]
            token_word[s:e] = np.asarray(d, dtype=np.int32)
            token_doc[s:e] = m
        return cls(token_word, token_doc, doc_ptr, vocab_size, vocab)

    def to_ragged(self) -> List[List[int]]:
        return [list(map(int, self.doc_tokens(m))) for m in range(self.num_docs)]

    def select_docs(self, doc_ids: np.ndarray) -> "FlatCorpus":
        """Sub-corpus of the given documents (renumbered 0..len-1), sharing
        the vocabulary.  Pure numpy — O(T) with no per-doc Python loops, so
        it is usable at benchmark-rung token counts (the train/held-out
        splitter behind the ladder's held-out perplexity)."""
        doc_ids = np.unique(np.asarray(doc_ids, np.int64))  # dedupe + sort:
        # duplicate ids would desync doc_ptr from the once-selected tokens
        lengths = np.diff(self.doc_ptr)
        keep = np.zeros(self.num_docs, bool)
        keep[doc_ids] = True
        # token membership via doc_ptr expansion (keeps doc-major order; the
        # selected docs appear in ascending original id order)
        tok_keep = keep[self.token_doc]
        new_ptr = np.zeros(len(doc_ids) + 1, np.int32)
        np.cumsum(lengths[doc_ids], out=new_ptr[1:])  # doc_ids sorted above
        # renumber doc ids: old id -> rank among kept
        remap = np.cumsum(keep) - 1
        return FlatCorpus(
            token_word=self.token_word[tok_keep].copy(),
            token_doc=remap[self.token_doc[tok_keep]].astype(np.int32),
            doc_ptr=new_ptr,
            vocab_size=self.vocab_size,
            vocab=self.vocab,
        )

    def split_docs(self, heldout_frac: float, seed: int = 0
                   ) -> tuple["FlatCorpus", "FlatCorpus"]:
        """Random (train, heldout) document split — heldout gets
        ``round(M * heldout_frac)`` docs (at least 1 when M > 1)."""
        m = self.num_docs
        rng = np.random.default_rng(seed)
        n_h = min(m - 1, max(1, int(round(m * heldout_frac)))) if m > 1 else 0
        held = rng.choice(m, size=n_h, replace=False)
        mask = np.ones(m, bool)
        mask[held] = False
        return self.select_docs(np.flatnonzero(mask)), self.select_docs(held)

    # ------------------------------------------------------------------
    def pad_to(self, multiple: int) -> "PaddedCorpus":
        """Pad the token stream to a multiple of ``multiple`` tokens.

        Padding tokens get word id 0 / doc id 0 and mask 0; samplers must apply
        the mask so padding never perturbs the count tables.
        """
        t = self.num_tokens
        padded = ((t + multiple - 1) // multiple) * multiple if t else multiple
        word = np.zeros(padded, dtype=np.int32)
        doc = np.zeros(padded, dtype=np.int32)
        mask = np.zeros(padded, dtype=np.int32)
        word[:t] = self.token_word
        doc[:t] = self.token_doc
        mask[:t] = 1
        return PaddedCorpus(word, doc, mask, t, self.vocab_size, self.num_docs)


@dataclasses.dataclass(frozen=True)
class PaddedCorpus:
    """Block-aligned token stream for the device sweep (padding masked out)."""

    token_word: np.ndarray  # int32 [T_pad]
    token_doc: np.ndarray   # int32 [T_pad]
    token_mask: np.ndarray  # int32 [T_pad] — 1 for real tokens, 0 for padding
    num_real_tokens: int
    vocab_size: int
    num_docs: int

    @property
    def num_tokens(self) -> int:
        return int(self.token_word.shape[0])

    def doc_slabs(
        self, block_size: int, d_loc_multiple: int = 8
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Per-block doc-slab layout for the fused Pallas sweep.

        Because the token stream is doc-major, each ``block_size`` block touches
        a *contiguous* range of document ids; the fused kernel keeps that range
        as a VMEM-resident ``[D_LOC, K]`` slab.  Returns
        ``(d_local [T_pad], d0 [num_blocks], d_loc)`` where
        ``d_local = token_doc - d0[block]`` (0 for padding tokens) and
        ``d_loc`` is the maximum block span rounded up to ``d_loc_multiple``.
        ``d0`` is clamped so ``d0 + d_loc <= num_docs`` whenever
        ``num_docs >= d_loc`` (slabs may overlap; the sweep is sequential, so
        overlapping writes are ordered).
        """
        t = self.num_tokens
        if t % block_size != 0:
            raise ValueError(f"padded length {t} not a multiple of {block_size}")
        nb = t // block_size
        d0 = np.zeros(nb, dtype=np.int32)
        span = 1
        for i in range(nb):
            s = slice(i * block_size, (i + 1) * block_size)
            docs = self.token_doc[s][self.token_mask[s] > 0]
            if docs.size:
                d0[i] = docs.min()
                span = max(span, int(docs.max()) - int(d0[i]) + 1)
        d_loc = ((span + d_loc_multiple - 1) // d_loc_multiple) * d_loc_multiple
        d0 = np.maximum(np.minimum(d0, self.num_docs - d_loc), 0).astype(np.int32)
        d_local = (
            (self.token_doc - np.repeat(d0, block_size)) * self.token_mask
        ).astype(np.int32)
        return d_local, d0, int(d_loc)

    def sort_within_blocks(self, block_size: int) -> tuple["PaddedCorpus", np.ndarray]:
        """Stable-sort each ``block_size`` block by word id.

        Within a block every token samples against the same count snapshot,
        so block-internal order is *statistically irrelevant* — but sorted
        word ids let the word-topic scatter-add use XLA's
        ``indices_are_sorted`` fast path (measured +17% sweep throughput on
        TPU v5e at K=500).  Returns ``(sorted_corpus, perm)`` with
        ``sorted.token_word[i] == self.token_word[perm[i]]``; assignments
        computed in sorted space map back via ``z_orig[perm] = z_sorted``.
        """
        t = self.num_tokens
        if t % block_size != 0:
            raise ValueError(f"padded length {t} not a multiple of {block_size}")
        perm = np.empty(t, dtype=np.int64)
        for s in range(0, t, block_size):
            perm[s : s + block_size] = s + np.argsort(
                self.token_word[s : s + block_size], kind="stable"
            )
        return (
            PaddedCorpus(
                token_word=self.token_word[perm],
                token_doc=self.token_doc[perm],
                token_mask=self.token_mask[perm],
                num_real_tokens=self.num_real_tokens,
                vocab_size=self.vocab_size,
                num_docs=self.num_docs,
            ),
            perm,
        )
