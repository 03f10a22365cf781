"""Reference-format artifact writers.

Reference: ``LdaModel.saveIteratedModel`` (``src/liuyang/nlp/lda/main/
LdaModel.java``, SURVEY.md §3.4, §8.3).  Each call writes five files under the
results dir:

    lda_<i>.params   one "name = value" line per hyperparameter + derived
                     docNum / termNum
    lda_<i>.phi      K lines of V tab-separated floats
    lda_<i>.theta    M lines of K tab-separated floats
    lda_<i>.tassign  per doc: "wordId:topic" pairs, original token order
    lda_<i>.twords   per topic: "topic i :" header + top-N "\\t<term>" lines,
                     sorted by φ descending, ties by ascending word index
                     (the reference's stable Collections.sort over indices)

Exact float formatting in the reference is unverifiable (empty mount); we use
repr-style shortest-roundtrip decimal, which is lossless and diffable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def _fmt(x: float) -> str:
    return repr(float(x))


def save_iterated_model(
    result_dir: str | Path,
    iteration: int,
    phi: np.ndarray,          # [K, V]
    theta: np.ndarray,        # [M, K]
    z: np.ndarray,            # [T] topic per token (real tokens only, corpus order)
    corpus: FlatCorpus,
    config: LdaConfig,
    vocab: Sequence[str] | None = None,
) -> list[Path]:
    """Write the five reference artifacts for sweep ``iteration``; returns paths."""
    out = Path(result_dir)
    out.mkdir(parents=True, exist_ok=True)
    phi = np.asarray(phi)
    theta = np.asarray(theta)
    z = np.asarray(z)
    k, v = phi.shape
    m = theta.shape[0]
    if vocab is None:
        vocab = corpus.vocab if corpus.vocab else [str(t) for t in range(v)]
    base = out / f"lda_{iteration}"
    paths = []

    # .params — six knobs + derived counts (reference writes hyperparams and
    # docNum/termNum; exact key naming unverifiable, kept self-describing)
    p = base.with_suffix(".params")
    p.write_text(
        "".join(
            f"{name} = {val}\n"
            for name, val in [
                ("alpha", config.alpha),
                ("beta", config.beta),
                ("topicNum", config.topic_num),
                ("docNum", m),
                ("termNum", v),
                ("iterations", config.iteration),
                ("saveStep", config.save_step),
                ("beginSaveIters", config.begin_save_iters),
            ]
        )
    )
    paths.append(p)

    p = base.with_suffix(".phi")
    with open(p, "w") as f:
        for row in phi:
            f.write("\t".join(_fmt(x) for x in row) + "\n")
    paths.append(p)

    p = base.with_suffix(".theta")
    with open(p, "w") as f:
        for row in theta:
            f.write("\t".join(_fmt(x) for x in row) + "\n")
    paths.append(p)

    # .tassign — per doc, "wordId:topic" in original token order
    p = base.with_suffix(".tassign")
    with open(p, "w") as f:
        for d in range(corpus.num_docs):
            s, e = corpus.doc_ptr[d], corpus.doc_ptr[d + 1]
            pairs = (
                f"{int(corpus.token_word[t])}:{int(z[t])}" for t in range(s, e)
            )
            f.write("\t".join(pairs) + "\n")
    paths.append(p)

    # .twords — top-N terms by φ descending; ties broken by ascending word id
    # (reference: stable sort over word indices with a descending-φ comparator)
    p = base.with_suffix(".twords")
    top_n = min(config.top_words, v)
    with open(p, "w") as f:
        for t in range(k):
            # stable argsort of -φ keeps ascending index order among ties
            order = np.argsort(-phi[t], kind="stable")[:top_n]
            f.write(f"topic {t} :\n")
            for w in order:
                f.write(f"\t{vocab[int(w)]}\n")
    paths.append(p)
    return paths
