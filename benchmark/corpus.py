"""The benchmark's corpus, drawn on the device from ``--seed``.

A frozen copy of the idea of the port's ``data/synthetic.zipf_corpus``
(Zipf word frequencies, log-normal document lengths), rewritten in PyTorch
so that a corpus of 10^8 tokens is made on the card in a few large calls.

Every seed gets the same bag: the same multiset of document lengths, the
same word counts and the same clumps, so every seed asks for the same work.
The seed chooses which vocabulary id each frequency rank gets, the order of
the documents' lengths, and the order of the clumps in the token stream,
which decides the document each clump falls in.

- Word counts: a truncated Zipf law, ``p(r) ∝ r^-s`` over ranks ``1..V``,
  turned into whole counts that sum to ``T`` by largest remainders.
- Clumps (the placement): each word's tokens in ``round(count / clump)``
  runs of as equal sizes as may be (at least one run); the runs are laid
  out in a random order and cut into documents, so that a run mostly lands
  in one document.  ``clump`` 1 is a uniform permutation of the tokens; a
  larger one repeats words within documents, as text does, and lowers the
  number of distinct (document, word) pairs (``nnz``), which a
  configuration fits to its published count.
- Document lengths: log-normal with ``sigma`` around the mean ``T / D``, as
  the ``D`` mid-quantiles of the law, scaled to sum to ``T`` (largest
  remainders again), at least 1 token each.

The generator imports nothing of the program; ``FlatCorpus`` is built from
its arrays by the driver.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Corpus:
    """A doc-major token stream: ``token_word[T]``, ``token_doc[T]`` (int32,
    on the device it was drawn on) and ``doc_ptr[D + 1]`` (int64, host)."""

    token_word: torch.Tensor
    token_doc: torch.Tensor
    doc_ptr: np.ndarray
    vocab_size: int

    @property
    def num_tokens(self) -> int:
        return int(self.token_word.shape[0])

    @property
    def num_docs(self) -> int:
        return int(self.doc_ptr.shape[0]) - 1


def _whole_counts(weights: np.ndarray, total: int, floor: int = 0) -> np.ndarray:
    """Whole counts proportional to ``weights`` summing to ``total``, each at
    least ``floor``, by largest remainders (ties to the lower index)."""
    w = np.asarray(weights, np.float64)
    spare = total - floor * w.shape[0]
    if spare < 0:
        raise ValueError(f"{total} cannot give {w.shape[0]} items {floor} each")
    exact = w / w.sum() * spare
    counts = np.floor(exact).astype(np.int64)
    short = spare - int(counts.sum())
    if short:
        order = np.argsort(-(exact - counts), kind="stable")
        counts[order[:short]] += 1
    return counts + floor


def nnz(c: Corpus) -> int:
    """Distinct (document, word) pairs: the published ``NNZ`` of a
    bag-of-words corpus."""
    key = c.token_doc.long() * c.vocab_size + c.token_word.long()
    return int(torch.unique(key).numel())


def word_counts(vocab_size: int, num_tokens: int, zipf_s: float) -> np.ndarray:
    """Tokens of each frequency rank ``1..V``: truncated Zipf(``zipf_s``)."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    return _whole_counts(ranks ** -zipf_s, num_tokens)


def clumps(counts: np.ndarray, clump: float) -> np.ndarray:
    """Runs of each rank: ``round(count / clump)``, at least 1 where the
    rank has tokens, at most its tokens."""
    c = np.asarray(counts, np.int64)
    n = np.clip(np.rint(c / float(clump)).astype(np.int64), 1, None)
    return np.where(c > 0, np.minimum(n, c), 0)


def doc_lengths(num_docs: int, num_tokens: int, sigma: float) -> np.ndarray:
    """The ``D`` documents' lengths, sorted: log-normal mid-quantiles with
    ``sigma`` (the mean is fixed by the scaling to ``T``)."""
    q = (np.arange(num_docs, dtype=np.float64) + 0.5) / num_docs
    # the standard normal's quantiles, from the inverse error function
    z = math.sqrt(2.0) * torch.special.erfinv(
        torch.from_numpy(2.0 * q - 1.0)).numpy()
    return _whole_counts(np.exp(sigma * z), num_tokens, floor=1)


def make_corpus(config: dict, seed: int, device) -> Corpus:
    """The configuration's corpus (``num_docs``, ``vocab_size``,
    ``num_tokens``, ``zipf_s``, ``clump``, ``doc_len_sigma``) for ``seed``
    on ``device``."""
    v, t, d = config["vocab_size"], config["num_tokens"], config["num_docs"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    words = word_counts(v, t, config["zipf_s"])
    runs = clumps(words, config["clump"])
    n_runs = int(runs.sum())
    counts = torch.from_numpy(words).to(dev)
    per_rank = torch.from_numpy(runs).to(dev)
    lengths = torch.from_numpy(doc_lengths(d, t, config["doc_len_sigma"])).to(dev)
    ids = torch.randperm(v, generator=gen, device=dev)
    lengths = lengths[torch.randperm(d, generator=gen, device=dev)]
    # each run's rank and size: a rank's tokens split as evenly as may be
    rank = torch.repeat_interleave(torch.arange(v, device=dev), per_rank,
                                   output_size=n_runs)
    nth = torch.arange(n_runs, device=dev) - (per_rank.cumsum(0) - per_rank)[rank]
    safe = per_rank.clamp(min=1)
    size = (counts // safe)[rank] + (nth < (counts % safe)[rank])
    del nth
    order = torch.randperm(n_runs, generator=gen, device=dev)
    token_word = torch.repeat_interleave(ids.to(torch.int32)[rank[order]], size[order],
                                         output_size=t)
    del rank, size, order
    token_doc = torch.repeat_interleave(
        torch.arange(d, dtype=torch.int32, device=dev), lengths, output_size=t)
    doc_ptr = np.zeros(d + 1, np.int64)
    np.cumsum(lengths.cpu().numpy(), out=doc_ptr[1:])
    return Corpus(token_word.contiguous(), token_doc, doc_ptr, v)
