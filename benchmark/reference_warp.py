"""The plain reference for the WarpLDA cell, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: from
the corpus, a sweep's starting topics and the seed that the benchmark hands
to both sides it works out one WarpLDA sweep (Chen, Li, Zhu & Chen,
"WarpLDA: a Cache Efficient O(1) Algorithm for Latent Dirichlet
Allocation", PVLDB 2016) as the configuration states it:

- the stream: slot ``i`` holds token ``i`` of the doc-major corpus, the
  pads after the last real token; a slot's uniforms are column ``i`` of the
  sweep's ``u [8, T_pad]`` (:func:`sweep_uniforms`: one ``torch.rand`` from
  a fresh generator on the device, seeded with the sweep's seed);
- the count tables ``ndk``, ``nwk``, ``nk`` recounted from the sweep's
  starting topics and frozen for the whole sweep (:meth:`Stream.tables`);
- for each real token, the doc step: with probability ``N_d / (N_d + Kα)``
  the proposal is the starting topic of a uniformly chosen token of its
  document (row 1 picks it, row 0 decides), else a uniform topic (row 2);
  it is accepted where row 3 lies under the Metropolis–Hastings ratio
  ``π(k')/π(k) · q(k)/q(k')``, with ``π(k) ∝ (ndk−e+α)(nwk−e+β)/(nk−e+Vβ)``
  and ``q_d(k) ∝ ndk[d, k] + α``;
- then the word step from the doc step's topic, the same with rows 4-7,
  ``N_d`` and ``Kα`` replaced by ``n_w`` and ``Kβ``, the pool being the
  starting topics of the word's tokens and ``q_w(k) ∝ nwk[w, k] + β``;
- the new topics, whose recount is what the tables must hold after the
  sweep (the reconciliation).

Every ratio is computed in float32 in the order the configuration states
(``num / den · (c_cur + x) / (c_prop + x)``, products and sums left to
right), so that a sound program gives the same bits.

Departures from the paper, each the program's as the configuration states:

- both steps read the tables as they stood at the sweep's start; the paper
  refreshes the counts between its word phase and its document phase;
- both proposal pools are the sweep's starting topics (the paper's pools
  are the topics as its current phase left them);
- the self-exclusion ``e`` is taken against the frozen tables, which count
  the token at its starting topic: ``−1`` at the current topic and ``−e``
  (``e = [k' = k]``) at the proposal.  In the word step the current topic
  is the doc step's, so where the doc step moved the token the ``−1`` lands
  on a topic the frozen tables do not count it under (the paper excludes
  the token from the counts, ``¬di``);
- the proposals' ``q`` counts include the token itself (the mixture's
  empirical part picks any token of the document or word, the token too);
- a token is accepted where its uniform is strictly under the ratio (the
  paper: with probability ``min(1, ratio)``, the same law).

The work is done in chunks of tokens, so that a sweep of 10^8 tokens fits
beside the program's tables; a chunk may split a document or a word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the sweep's uniform rows (``u[r]``)
DOC_MIX, DOC_PICK, DOC_TOPIC, DOC_ACCEPT = 0, 1, 2, 3
WORD_MIX, WORD_PICK, WORD_TOPIC, WORD_ACCEPT = 4, 5, 6, 7


def sweep_uniforms(seed: int, t_pad: int, device) -> torch.Tensor:
    """The sweep's ``[8, T_pad]`` float32 uniforms: ``torch.rand`` from a
    fresh generator on ``device`` seeded with the sweep's seed."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return torch.rand((8, t_pad), generator=gen, device=dev)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """α, β, V and K, and the float32 scalars the ratios use."""

    alpha: float
    beta: float
    vocab_size: int
    num_topics: int

    def f32(self) -> dict:
        f = np.float32
        return dict(alpha=float(f(self.alpha)), beta=float(f(self.beta)),
                    vbeta=float(f(self.vocab_size) * f(self.beta)),
                    kalpha=float(f(self.num_topics) * f(self.alpha)),
                    kbeta=float(f(self.num_topics) * f(self.beta)))


@dataclasses.dataclass
class _Groups:
    """A key's groups over the real tokens: the tokens of group ``g`` in
    stream order are ``order[first[g] : first[g] + size[g]]``."""

    order: torch.Tensor   # int64 [T]
    first: torch.Tensor   # int64 [G]
    size: torch.Tensor    # int64 [G]

    @classmethod
    def of(cls, key: torch.Tensor, groups: int) -> "_Groups":
        order = torch.sort(key, stable=True).indices
        size = torch.bincount(key, minlength=groups)
        return cls(order, size.cumsum(0) - size, size)

    def pick(self, g: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Group sizes as float32, and the token that uniform ``u`` picks in
        each token's group ``g``: the ``floor(u · size)``-th in stream order."""
        n = self.size[g].to(torch.float32)
        return n, self.order[self.first[g] + torch.floor(u * n).to(torch.int64)]


class Stream:
    """The real tokens of a doc-major stream (``word``, ``doc``: the first
    ``T`` slots) grouped by document and by word."""

    def __init__(self, word: torch.Tensor, doc: torch.Tensor, num_docs: int,
                 hyper: Hyper) -> None:
        self.word, self.doc = word.long(), doc.long()
        self.num_docs, self.hyper = num_docs, hyper
        self.by_doc = _Groups.of(self.doc, num_docs)
        self.by_word = _Groups.of(self.word, hyper.vocab_size)

    @property
    def num_tokens(self) -> int:
        return int(self.word.shape[0])

    def tables(self, z: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``ndk [D, K]``, ``nwk [V, K]`` and ``nk [K]`` (int32) recounted
        from the real tokens' topics ``z[:T]``."""
        k, zr = self.hyper.num_topics, z[:self.num_tokens].long()
        one = torch.ones_like(zr, dtype=torch.int32)
        out = []
        for rows, n in ((self.doc, self.num_docs), (self.word, self.hyper.vocab_size)):
            flat = torch.zeros(n * k, dtype=torch.int32, device=z.device)
            flat.index_add_(0, rows * k + zr, one)
            out.append(flat.view(n, k))
        nk = torch.zeros(k, dtype=torch.int32, device=z.device).index_add_(0, zr, one)
        return (*out, nk)

    def sweep(self, z: torch.Tensor, u: torch.Tensor,
              chunk: int = 1 << 24) -> torch.Tensor:
        """One sweep from the topics ``z [T_pad]`` under the uniforms
        ``u [8, T_pad]``: the new topics (pads keep theirs)."""
        k = self.hyper.num_topics
        s = self.hyper.f32()
        ndk, nwk, nk = (t.view(-1) for t in self.tables(z))
        z_start = z.long()
        out = z.clone()
        f32 = torch.float32

        def ratio(c_cur, c_prop, nk_cur, nk_prop, own_cur, own_prop, prior, e):
            """π(k')/π(k) · q(k)/q(k') from the frozen counts at the current
            and the proposed topic (``c``: the doc's and the word's counts;
            ``own``: the counts the proposal was drawn from)."""
            num = (c_prop[0] - e + s["alpha"]) * (c_prop[1] - e + s["beta"]) * (
                nk_cur - 1.0 + s["vbeta"])
            den = (c_cur[0] - 1.0 + s["alpha"]) * (c_cur[1] - 1.0 + s["beta"]) * (
                nk_prop - e + s["vbeta"])
            return num / den * ((own_cur + prior) / (own_prop + prior))

        for a in range(0, self.num_tokens, chunk):
            b = min(self.num_tokens, a + chunk)
            d, w, uc = self.doc[a:b], self.word[a:b], u[:, a:b]
            dk, wk = d * k, w * k
            cur = z_start[a:b]
            for groups, mix, pick, topic, accept, prior, own in (
                    (self.by_doc, DOC_MIX, DOC_PICK, DOC_TOPIC, DOC_ACCEPT,
                     (s["alpha"], s["kalpha"]), 0),
                    (self.by_word, WORD_MIX, WORD_PICK, WORD_TOPIC, WORD_ACCEPT,
                     (s["beta"], s["kbeta"]), 1)):
                n, token = groups.pick(d if own == 0 else w, uc[pick])
                uniform = torch.floor(uc[topic] * float(k)).to(torch.int64)
                prop = torch.where(uc[mix] < n / (n + prior[1]), z_start[token], uniform)
                e = (prop == cur).to(f32)
                c_cur = (ndk[dk + cur].to(f32), nwk[wk + cur].to(f32))
                c_prop = (ndk[dk + prop].to(f32), nwk[wk + prop].to(f32))
                r = ratio(c_cur, c_prop, nk[cur].to(f32), nk[prop].to(f32),
                          c_cur[own], c_prop[own], prior[0], e)
                cur = torch.where(uc[accept] < r, prop, cur)
            out[a:b] = cur.to(out.dtype)
        return out
