"""Inference on NEW documents against a trained model (engine extension).

Copied from ``ldagibbssampling_tpu/lda_io/infer.py:29-120`` (numpy on the
host; the port keeps its own copy, so the artifacts are the reference's byte
for byte for the same φ, documents, α and seed).  The reference is
training-only; this module adds the standard fold-in: unseen documents are
preprocessed with the SAME pipeline (tokenize / stopwords / noise filter)
against the FROZEN training vocabulary (new terms are dropped, counted, and
reported), θ is estimated per document by Gibbs with φ fixed
(``evaluation.metrics.fold_in_theta``), and reference-shaped artifacts are
written:

    inferred.theta   — one row per new doc, K tab-separated floats
    inferred.tassign — per token ``wordId:topic`` (MAP topic under φ·θ)
    inferred.docs    — the ingested filenames, row order of the above
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ldagibbssampling_tpu_torch.corpus import fileutil
from ldagibbssampling_tpu_torch.corpus.documents import is_noise_word
from ldagibbssampling_tpu_torch.corpus.stopwords import is_stopword


def read_docs_frozen_vocab(
    path: str | Path,
    term_to_index: Dict[str, int],
    *,
    directory_order: bool = False,
) -> Tuple[List[str], List[List[int]], int]:
    """Ingest a directory with the trained vocabulary frozen.

    Same preprocessing as training ingestion; terms absent from
    ``term_to_index`` are dropped.  Returns ``(names, token_id_lists,
    num_dropped_unknown)``.
    """
    p = Path(path)
    names = os.listdir(p)
    if not directory_order:
        names = sorted(names)
    kept_names: List[str] = []
    docs: List[List[int]] = []
    dropped = 0
    for name in names:
        f = p / name
        if not f.is_file():
            continue
        ids: List[int] = []
        for line in fileutil.read_lines(f):
            for w in fileutil.tokenize_and_lowercase(line):
                if not w or is_stopword(w) or is_noise_word(w):
                    continue
                idx = term_to_index.get(w)
                if idx is None:
                    dropped += 1
                else:
                    ids.append(idx)
        kept_names.append(name)
        docs.append(ids)
    return kept_names, docs, dropped


def infer_new_docs(
    phi: np.ndarray,
    docs_dir: str | Path,
    term_to_index: Dict[str, int],
    alpha: float,
    result_dir: str | Path,
    *,
    n_sweeps: int = 20,
    seed: int = 0,
) -> dict:
    """Fold-in every document of ``docs_dir``; write inference artifacts.

    Returns a summary dict (docs, tokens, dropped unknown terms, paths).
    """
    from ldagibbssampling_tpu_torch.evaluation.metrics import fold_in_theta

    phi = np.asarray(phi, dtype=np.float64)
    names, docs, dropped = read_docs_frozen_vocab(docs_dir, term_to_index)

    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    thetas: List[np.ndarray] = []
    tassign_lines: List[str] = []
    for m, toks in enumerate(docs):
        toks_arr = np.asarray(toks, dtype=np.int64)
        theta = fold_in_theta(phi, toks_arr, alpha, n_sweeps=n_sweeps, seed=seed + m)
        thetas.append(theta)
        if len(toks_arr):
            # MAP topic per token under the folded-in mixture
            scores = phi[:, toks_arr] * theta[:, None]   # [K, N]
            zmap = scores.argmax(axis=0)
            tassign_lines.append(
                "\t".join(f"{int(w)}:{int(z)}" for w, z in zip(toks_arr, zmap))
            )
        else:
            tassign_lines.append("")

    theta_path = result_dir / "inferred.theta"
    theta_path.write_text(
        "".join("\t".join(f"{x:.6f}" for x in th) + "\n" for th in thetas)
    )
    tassign_path = result_dir / "inferred.tassign"
    tassign_path.write_text("".join(line + "\n" for line in tassign_lines))
    docs_path = result_dir / "inferred.docs"
    docs_path.write_text("".join(n + "\n" for n in names))
    return {
        "num_docs": len(docs),
        "num_tokens": int(sum(len(d) for d in docs)),
        "dropped_unknown_terms": dropped,
        "theta": str(theta_path),
        "tassign": str(tassign_path),
        "docs": str(docs_path),
    }
