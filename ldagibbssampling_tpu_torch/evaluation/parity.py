"""Statistical parity harness: blocked chains vs the serial oracle.

Counterpart of ``ldagibbssampling_tpu/evaluation/parity.py:29-112``.
Blocked Gibbs runs a *different Markov chain* than the reference's serial
scan; equality is distributional, not bitwise.  This harness runs
matched-budget chain families (same corpus, same sweep count, independent
seeds) and compares permutation-invariant posterior functionals with a
two-sample z-score on the across-seed Monte-Carlo spread:

- per-token train log-likelihood (label-free);
- mean topic entropy (sorted — invariant to topic relabeling).

A |z| ≲ 3-4 on each functional means the blocked chain's stationary bias is
within MC error of the serial chain.  The blocked family runs through the
port's ``LdaModel`` in the tier ``use_pallas`` names, on ``device``; the
oracle family through the port's ``OracleSampler`` on the host.
``serial_vs_parallel`` (reference ``:115-188``) holds a mesh runtime of
``parallel/`` against the single-device blocked family the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.metrics import log_likelihood


@dataclasses.dataclass
class FamilyStats:
    name: str
    ll_per_token: np.ndarray       # [n_seeds]
    topic_entropy: np.ndarray      # [n_seeds]

    def summary(self) -> dict:
        return {
            "name": self.name,
            "ll_per_token_mean": float(self.ll_per_token.mean()),
            "ll_per_token_std": float(self.ll_per_token.std(ddof=1)),
            "topic_entropy_mean": float(self.topic_entropy.mean()),
            "topic_entropy_std": float(self.topic_entropy.std(ddof=1)),
        }


def _functionals(phi: np.ndarray, theta: np.ndarray, corpus: FlatCorpus):
    ll = log_likelihood(phi, theta, corpus) / max(corpus.num_tokens, 1)
    ent = -np.sum(phi * np.log(np.maximum(phi, 1e-300)), axis=1)
    return ll, float(np.sort(ent).mean())


def run_family(
    name: str,
    corpus: FlatCorpus,
    make_and_run: Callable[[int], tuple[np.ndarray, np.ndarray]],
    seeds: Sequence[int],
) -> FamilyStats:
    """``make_and_run(seed) -> (phi, theta)`` after the matched sweep budget."""
    lls, ents = [], []
    for s in seeds:
        phi, theta = make_and_run(s)
        ll, ent = _functionals(phi, theta, corpus)
        lls.append(ll)
        ents.append(ent)
    return FamilyStats(name, np.asarray(lls), np.asarray(ents))


def z_score(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample z on across-seed means; guards the zero-variance corner."""
    na, nb = len(a), len(b)
    se = np.sqrt(a.var(ddof=1) / na + b.var(ddof=1) / nb)
    if se == 0:
        return 0.0 if a.mean() == b.mean() else float("inf")
    return float((a.mean() - b.mean()) / se)


def oracle_vs_blocked(
    corpus: FlatCorpus,
    k: int,
    *,
    alpha: float = 0.5,
    beta: float = 0.1,
    sweeps: int = 40,
    seeds: Sequence[int] = (0, 1, 2, 3),
    block_size: int = 256,
    draw_method: str = "gumbel",
    use_pallas: Any = "deferred",
    device: Any = "cuda",
    expect_tier: str | None = None,
) -> dict:
    """The standard parity report: serial oracle family vs blocked family.

    The blocked models run the tier ``use_pallas`` resolves to for the
    corpus (``models/lda.resolve_tier``); with ``expect_tier`` each model
    must report that ``kernel_tier`` or the call raises.  The report's
    ``kernel_tier`` names the tier that ran.
    """
    from ldagibbssampling_tpu_torch.models.lda import LdaModel
    from ldagibbssampling_tpu_torch.models.oracle import OracleSampler

    tiers = set()

    def run_oracle(seed: int):
        o = OracleSampler(corpus, k, alpha, beta, seed=seed)
        o.sweep(sweeps)
        return o.phi(), o.theta()

    def run_blocked(seed: int):
        cfg = LdaConfig(
            topic_num=k, alpha=alpha, beta=beta, seed=seed,
            block_size=block_size, draw_method=draw_method,
            use_pallas=use_pallas,
        )
        m = LdaModel(cfg, corpus, device=device)
        if expect_tier is not None and m.kernel_tier != expect_tier:
            raise AssertionError(
                f"asked for the {expect_tier} tier, the model runs {m.kernel_tier}")
        tiers.add(m.kernel_tier)
        m.sweep(sweeps)
        return m.phi(), m.theta()

    fa = run_family("oracle", corpus, run_oracle, seeds)
    fb = run_family("blocked", corpus, run_blocked, seeds)
    return {
        "oracle": fa.summary(),
        "blocked": fb.summary(),
        "kernel_tier": ",".join(sorted(tiers)),
        "z_ll": z_score(fa.ll_per_token, fb.ll_per_token),
        "z_entropy": z_score(fa.topic_entropy, fb.topic_entropy),
    }


def serial_vs_parallel(
    corpus: FlatCorpus,
    k: int,
    runtime: str,
    *,
    alpha: float = 0.5,
    beta: float = 0.1,
    sweeps: int = 40,
    seeds: Sequence[int] = (0, 1, 2, 3),
    block_size: int = 64,
    num_shards: int = 4,
    device: Any = "cuda",
) -> dict:
    """Parity report: the single-device blocked family against a mesh
    runtime's, ``runtime`` one of ``"adlda"``, ``"grid"`` (``num_shards //
    2`` × 2) and ``"tokenshard"``, over the positions of
    ``parallel/multihost.local_devices`` (as in the reference, fewer
    positions than ``num_shards`` give fewer shards).  Stale
    parallel updates mix more slowly: assert parity after burn-in, not at
    short matched budgets (the reference's docstring)."""
    from ldagibbssampling_tpu_torch.models.lda import LdaModel
    from ldagibbssampling_tpu_torch.parallel import multihost

    if runtime not in ("adlda", "grid", "tokenshard"):
        raise ValueError(f"unknown runtime {runtime!r}")
    devices, ranks = multihost.global_devices(device)

    def config(seed: int) -> LdaConfig:
        return LdaConfig(topic_num=k, alpha=alpha, beta=beta, seed=seed,
                         block_size=block_size)

    def run_single(seed: int):
        m = LdaModel(config(seed), corpus, device=device)
        m.sweep(sweeps)
        return m.phi(), m.theta()

    def run_parallel(seed: int):
        if runtime == "grid":
            from ldagibbssampling_tpu_torch.parallel.grid import GridLda

            pd = max(1, num_shards // 2)
            mesh = multihost.Mesh(("data", "vocab"), (pd, 2),
                                  tuple(devices[:pd * 2]), tuple(ranks[:pd * 2]))
            m = GridLda(config(seed), corpus, mesh=mesh, device=device)
        else:
            from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
            from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

            n = len(devices[:num_shards])
            mesh = multihost.Mesh(("data",), (n,), tuple(devices[:n]),
                                  tuple(ranks[:n]))
            cls = ShardedLda if runtime == "adlda" else TokenShardedLda
            m = cls(config(seed), corpus, mesh=mesh, device=device)
        m.sweep(sweeps)
        return m.phi(), m.theta()

    fa = run_family("single", corpus, run_single, seeds)
    fb = run_family(runtime, corpus, run_parallel, seeds)
    return {
        "single": fa.summary(),
        runtime: fb.summary(),
        "z_ll": z_score(fa.ll_per_token, fb.ll_per_token),
        "z_entropy": z_score(fa.topic_entropy, fb.topic_entropy),
    }
