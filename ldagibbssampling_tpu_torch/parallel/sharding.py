"""Document sharding for AD-LDA: partition a flat corpus across devices.

Docs are assigned whole (a document's tokens never split across shards in DP
mode — its ``ndk`` row must live on exactly one device), greedily balancing
token counts.  Every shard is padded to identical static shapes so the result
stacks into ``[P, T_s]`` / ``[P, M_s]`` arrays that shard cleanly on a mesh
axis.  Token ``doc`` ids are *local* to the shard; ``doc_map`` recovers global
ids (−1 for padding rows).

The port's copy of ``ldagibbssampling_tpu/parallel/sharding.py`` (numpy
only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


@dataclasses.dataclass(frozen=True)
class CorpusShards:
    """Stacked per-shard token arrays (leading axis = shard)."""

    token_word: np.ndarray  # int32 [P, T_s]
    token_doc: np.ndarray   # int32 [P, T_s] — LOCAL doc ids
    token_mask: np.ndarray  # int32 [P, T_s]
    doc_lengths: np.ndarray  # int32 [P, M_s] — 0 for padding docs
    doc_map: np.ndarray     # int32 [P, M_s] — global doc id, -1 for padding
    num_shards: int
    vocab_size: int
    num_real_tokens: int

    @property
    def tokens_per_shard(self) -> int:
        return int(self.token_word.shape[1])

    @property
    def docs_per_shard(self) -> int:
        return int(self.doc_lengths.shape[1])


def sort_blocks_inplace(
    token_word: np.ndarray, *others: np.ndarray, block_size: int
) -> None:
    """Word-sort each ``block_size`` block of the LAST axis, in place.

    Applies the same permutation to every array in ``others`` (doc ids,
    masks).  Works on any leading shard dims (``[T]``, ``[P, T]``,
    ``[Pd, Pv, T]``).  Within-block order is statistically irrelevant to the
    blocked sweep (snapshot semantics), and ascending word ids enable the
    XLA sorted-scatter fast path (``gibbs_sweep(sorted_words=True)``).
    """
    t = token_word.shape[-1]
    if t % block_size != 0:
        raise ValueError(f"stream length {t} not a multiple of {block_size}")
    flat_w = token_word.reshape(-1, t)
    flat_o = [o.reshape(-1, t) for o in others]
    for r in range(flat_w.shape[0]):
        for s in range(0, t, block_size):
            sl = slice(s, s + block_size)
            perm = np.argsort(flat_w[r, sl], kind="stable")
            flat_w[r, sl] = flat_w[r, sl][perm]
            for o in flat_o:
                o[r, sl] = o[r, sl][perm]


def assign_docs(lengths: np.ndarray, num_shards: int) -> list[list[int]]:
    """Greedy token-balanced document partition (LPT: biggest docs first onto
    the lightest shard), original doc order preserved within each shard."""
    order = np.argsort(-lengths, kind="stable")
    shard_docs: list[list[int]] = [[] for _ in range(num_shards)]
    shard_load = np.zeros(num_shards, dtype=np.int64)
    for doc in order:
        p = int(np.argmin(shard_load))
        shard_docs[p].append(int(doc))
        shard_load[p] += int(lengths[doc])
    for p in range(num_shards):
        shard_docs[p].sort()
    return shard_docs


def shard_corpus(corpus: FlatCorpus, num_shards: int, block_size: int = 1) -> CorpusShards:
    """Greedy token-balanced document partition, padded to uniform shapes."""
    lengths = corpus.doc_lengths()
    m = corpus.num_docs
    shard_docs = assign_docs(lengths, num_shards)
    shard_load = np.array(
        [sum(int(lengths[g]) for g in docs) for docs in shard_docs], dtype=np.int64
    )

    m_s = max(1, max(len(s) for s in shard_docs))
    t_raw = max(1, int(shard_load.max()))
    t_s = ((t_raw + block_size - 1) // block_size) * block_size

    tw = np.zeros((num_shards, t_s), dtype=np.int32)
    td = np.zeros((num_shards, t_s), dtype=np.int32)
    tm = np.zeros((num_shards, t_s), dtype=np.int32)
    dl = np.zeros((num_shards, m_s), dtype=np.int32)
    dmap = np.full((num_shards, m_s), -1, dtype=np.int32)

    for p, docs in enumerate(shard_docs):
        pos = 0
        for local, g in enumerate(docs):
            s, e = corpus.doc_ptr[g], corpus.doc_ptr[g + 1]
            n = int(e - s)
            tw[p, pos : pos + n] = corpus.token_word[s:e]
            td[p, pos : pos + n] = local
            tm[p, pos : pos + n] = 1
            dl[p, local] = n
            dmap[p, local] = g
            pos += n

    return CorpusShards(
        token_word=tw, token_doc=td, token_mask=tm,
        doc_lengths=dl, doc_map=dmap,
        num_shards=num_shards, vocab_size=corpus.vocab_size,
        num_real_tokens=corpus.num_tokens,
    )
