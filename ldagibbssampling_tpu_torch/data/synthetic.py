"""Synthetic corpora for benchmarks (BASELINE.md ladder stand-ins).

The ladder's public datasets (20NG, NYTimes, Wikipedia, PubMed) are not
shipped with the repository (SURVEY.md §0), so each rung runs against a
synthetic corpus with the same statistical shape: Zipf word
frequencies, log-normal document lengths, and (optionally) a planted topic
structure so quality metrics move with inference progress.
"""

from __future__ import annotations

import numpy as np

from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def zipf_corpus(
    num_docs: int,
    vocab_size: int,
    mean_doc_len: int,
    seed: int = 0,
    zipf_a: float = 1.1,
) -> FlatCorpus:
    """Unstructured Zipf bag-of-words corpus as flat arrays (no host ragged
    build at scale)."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(
        1, rng.lognormal(np.log(mean_doc_len), 0.5, size=num_docs).astype(np.int64)
    )
    t = int(lengths.sum())
    raw = rng.zipf(zipf_a, size=t).astype(np.int64)
    token_word = ((raw - 1) % vocab_size).astype(np.int32)
    doc_ptr = np.zeros(num_docs + 1, dtype=np.int32)
    np.cumsum(lengths, out=doc_ptr[1:])
    token_doc = np.repeat(
        np.arange(num_docs, dtype=np.int32), lengths
    )
    return FlatCorpus(token_word, token_doc, doc_ptr, vocab_size)


def planted_topic_corpus(
    num_docs: int,
    vocab_size: int,
    num_topics: int,
    mean_doc_len: int,
    seed: int = 0,
    alpha: float = 0.1,
    beta: float = 0.05,
) -> tuple[FlatCorpus, np.ndarray]:
    """LDA-generative corpus with known ``phi`` — quality metrics (held-out
    perplexity, topic recovery) have a ground truth to move toward.

    Returns ``(corpus, phi_true [K, V])``.
    """
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(vocab_size, beta), size=num_topics)  # [K, V]
    thetas = rng.dirichlet(np.full(num_topics, alpha), size=num_docs)
    lengths = np.maximum(
        1, rng.lognormal(np.log(mean_doc_len), 0.4, size=num_docs).astype(np.int64)
    )
    # each topic's word CDF once: ``rng.choice(V, size, p=phi[k])`` is
    # ``cdf.searchsorted(rng.random(size), side="right")`` with this very
    # CDF, so the draws are the reference's, without its O(V) work per call
    cdfs = phi.cumsum(axis=1)
    cdfs /= cdfs[:, -1:]
    words = []
    for m in range(num_docs):
        zs = rng.choice(num_topics, size=lengths[m], p=thetas[m])
        # vectorized per-topic word draws
        w = np.empty(lengths[m], dtype=np.int32)
        for k in np.unique(zs):
            sel = zs == k
            w[sel] = cdfs[k].searchsorted(rng.random(int(sel.sum())), side="right")
        words.append(w)
    doc_ptr = np.zeros(num_docs + 1, dtype=np.int32)
    np.cumsum(lengths, out=doc_ptr[1:])
    token_word = np.concatenate(words).astype(np.int32)
    token_doc = np.repeat(np.arange(num_docs, dtype=np.int32), lengths)
    return FlatCorpus(token_word, token_doc, doc_ptr, vocab_size), phi
