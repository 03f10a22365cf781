"""The corpus generator: the same inputs for the same seed, the same bag of
lengths, word counts and runs for every seed, each configuration's V, D, T
and mean length, and the published number of distinct (document, word)
pairs that its word law and placement were fitted to."""

import json

import numpy as np
import pytest
import torch

from benchmark import corpus, spec
from benchmark.tests._tiny import TINY_CONFIG


def test_same_seed_same_corpus_other_seed_other_order():
    a = corpus.make_corpus(TINY_CONFIG, 2**31 + 7, "cpu")
    b = corpus.make_corpus(TINY_CONFIG, 2**31 + 7, "cpu")
    c = corpus.make_corpus(TINY_CONFIG, 2**31 + 8, "cpu")
    assert torch.equal(a.token_word, b.token_word)
    assert torch.equal(a.token_doc, b.token_doc)
    assert np.array_equal(a.doc_ptr, b.doc_ptr)
    assert not torch.equal(a.token_word, c.token_word)
    # the same bag: word counts by rank and the lengths, sorted
    def bag(x):
        counts = torch.bincount(x.token_word.long(), minlength=x.vocab_size)
        return (torch.sort(counts).values, np.sort(np.diff(x.doc_ptr)))
    (wa, la), (wc, lc) = bag(a), bag(c)
    assert torch.equal(wa, wc) and np.array_equal(la, lc)


def test_corpus_shape():
    x = corpus.make_corpus(TINY_CONFIG, 3, "cpu")
    t, d, v = TINY_CONFIG["num_tokens"], TINY_CONFIG["num_docs"], TINY_CONFIG["vocab_size"]
    assert x.num_tokens == t and x.num_docs == d and x.vocab_size == v
    assert x.token_word.dtype == torch.int32 and x.token_doc.dtype == torch.int32
    assert int(x.token_word.min()) >= 0 and int(x.token_word.max()) < v
    lengths = np.diff(x.doc_ptr)
    assert lengths.min() >= 1 and lengths.sum() == t
    assert torch.equal(x.token_doc, torch.repeat_interleave(
        torch.arange(d, dtype=torch.int32), torch.from_numpy(lengths)))


def _config(name):
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return entry, spec.load_json(spec.ROOT / entry["file"])


def _nnz_share(cfg, docs):
    """Distinct pairs of ``cfg``'s corpus drawn over ``docs`` documents (the
    same mean length), as a share of the published count at that size."""
    pub = cfg["published"]
    small = dict(cfg, num_docs=docs,
                 num_tokens=round(pub["num_tokens"] * docs / pub["num_docs"]))
    return small, pub["nnz"] * docs / pub["num_docs"]


def test_clumps_split_each_word():
    runs = corpus.clumps(np.array([0, 1, 2, 7, 100]), 1.3)
    assert runs.tolist() == [0, 1, 2, 5, 77]
    assert corpus.clumps(np.array([0, 3, 50]), 1.0).tolist() == [0, 3, 50]
    # a word's runs hold its tokens, sizes as equal as may be
    x = corpus.make_corpus(dict(TINY_CONFIG, clump=3.0), 5, "cpu")
    counts = np.bincount(x.token_word.numpy(), minlength=x.vocab_size)
    assert np.array_equal(np.sort(counts)[::-1],
                          corpus.word_counts(x.vocab_size, x.num_tokens, 1.0))


@pytest.mark.parametrize("name, docs", [("nytimes-k100", 15_000), ("pubmed-k1000", 82_000)])
def test_published_nnz_at_a_share(name, docs):
    """The word law and the runs give the published distinct pairs: drawn
    over a share of the documents, within 1%."""
    _, cfg = _config(name)
    small, want = _nnz_share(cfg, docs)
    got = corpus.nnz(corpus.make_corpus(small, 2**31 + 5, "cpu"))
    assert got / want == pytest.approx(1.0, abs=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nytimes-k100", "pubmed-k1000"])
def test_published_nnz_at_the_cells_size(cuda, name):
    """The same at the size the cell runs, on the card: within 0.5%."""
    _, cfg = _config(name)
    small, want = _nnz_share(cfg, cfg["num_docs"])
    got = corpus.nnz(corpus.make_corpus(small, 2**33 + 1, cuda))
    print(f"{name}: nnz {got}, {got / want:.6f} of the published share")
    assert got / want == pytest.approx(1.0, abs=0.005)


@pytest.mark.parametrize("name", ["nytimes-k100", "pubmed-k1000"])
def test_configuration_bag(name):
    """Each configuration's counts, without drawing its 10^8 tokens."""
    entry, cfg = _config(name)
    t, d, v = cfg["num_tokens"], cfg["num_docs"], cfg["vocab_size"]
    words = corpus.word_counts(v, t, cfg["zipf_s"])
    lengths = corpus.doc_lengths(d, t, cfg["doc_len_sigma"])
    assert words.shape == (v,) and words.sum() == t
    assert np.all(np.diff(words) <= 0)             # rank 1 the most frequent
    assert lengths.shape == (d,) and lengths.sum() == t and lengths.min() >= 1
    assert lengths.mean() == pytest.approx(t / d)
    # log-normal with sigma 0.5: the log-lengths' spread
    assert np.log(lengths).std() == pytest.approx(cfg["doc_len_sigma"], rel=0.02)
    # the deferred tier scores word-topic cells in float32: no word of 2^24
    assert words.max() < 2**24
    pub = cfg["published"]
    assert cfg["vocab_size"] == pub["vocab_size"]
    share = d / pub["num_docs"]
    assert t == round(pub["num_tokens"] * share)
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
