"""Deterministic stand-in for the reference's bundled example corpus.

The reference ships ~a-dozen-to-20 short English news/article-like documents in
``data/LdaOriginalDocs/`` (SURVEY.md §2.1 #9); the mount is empty, so benchmark
config 1 ("bundled mini-corpus, K=10") runs against this generated substitute
(substitution documented per SURVEY.md §7 hard-part 6).

The generator builds topic-structured documents: a handful of latent "themes",
each with its own content-word pool; every document mixes 1-2 themes plus
function words (which the stopword filter then removes, exercising the
preprocessing path end to end).  Everything is driven by a fixed-seed LCG so the
corpus is bit-identical across runs and machines — no dependence on Python's
``random`` module internals.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

_THEMES: dict[str, list[str]] = {
    "markets": """stock market shares trading investors price index fund profit
        earnings bank revenue economy inflation growth quarter dividend asset
        bond currency exchange""".split(),
    "sports": """team game season player coach league score goal match win
        championship tournament defense offense stadium fans injury trade
        playoff record""".split(),
    "science": """research study cells protein gene experiment laboratory data
        species climate energy physics particle theory evidence sample
        measurement discovery molecule brain""".split(),
    "politics": """government election president congress policy vote senate
        campaign party law minister parliament reform debate legislation
        coalition opposition budget treaty diplomat""".split(),
    "technology": """computer software internet network data system users
        security hardware mobile digital platform startup algorithm chip
        server cloud device application code""".split(),
}

# Function words deliberately present so the stopword filter has work to do.
_GLUE = "the of and a to in is that it for was on are with as they at be this".split()


class _Lcg:
    """Tiny 64-bit LCG (Knuth MMIX constants) — stable across Python versions."""

    def __init__(self, seed: int) -> None:
        self.state = seed & ((1 << 64) - 1)

    def next_int(self, bound: int) -> int:
        self.state = (self.state * 6364136223846793005 + 1442695040888963407) & (
            (1 << 64) - 1
        )
        return (self.state >> 33) % bound


def generate_minicorpus(num_docs: int = 20, seed: int = 20260817) -> List[str]:
    """Return ``num_docs`` documents as text strings (lines of ~12 words)."""
    rng = _Lcg(seed)
    theme_names = sorted(_THEMES)
    docs: List[str] = []
    for _ in range(num_docs):
        k1 = theme_names[rng.next_int(len(theme_names))]
        k2 = theme_names[rng.next_int(len(theme_names))]
        pools = (_THEMES[k1], _THEMES[k2])
        n_words = 60 + rng.next_int(60)
        words: List[str] = []
        for _ in range(n_words):
            r = rng.next_int(10)
            if r < 3:  # ~30% glue words → exercised stopword removal
                words.append(_GLUE[rng.next_int(len(_GLUE))])
            else:
                pool = pools[rng.next_int(2)]
                words.append(pool[rng.next_int(len(pool))])
        lines = [" ".join(words[i : i + 12]) for i in range(0, len(words), 12)]
        docs.append("\n".join(lines) + "\n")
    return docs


def write_minicorpus(
    out_dir: str | Path, num_docs: int = 20, seed: int = 20260817
) -> Path:
    """Write the corpus as ``doc_00.txt .. doc_NN.txt`` files; return the dir."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, text in enumerate(generate_minicorpus(num_docs, seed)):
        (out / f"doc_{i:02d}.txt").write_text(text, encoding="utf-8")
    return out
