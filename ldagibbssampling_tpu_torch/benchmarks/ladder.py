"""The benchmark ladder on the port's own models, scaled to one card.

Counterpart of ``ldagibbssampling_tpu/benchmarks/ladder.py``.  The public
datasets of the ladder's rungs (20NG, NYTimes, Wikipedia, PubMed) are not
in the repository, so rungs 2, 4 and 5 run synthetic stand-ins with their
statistical shape (``data/synthetic.py``) at a ``--scale`` fraction of the
real corpus size, and the report says so (``corpus: synthetic``).

- rung 1: the minicorpus, the serial oracle against the blocked sampler at
  K = 10, and the fidelity sweep's bitwise match with the oracle (block 1,
  ``inverse_cdf``, float64, the oracle's own uniforms), which runs on the
  CPU as the reference's does: the contract is about semantics;
- rung 2: 20NG-shaped Gibbs, tokens/s and held-out perplexity;
- rung 3: NYT-shaped document-sharded AD-LDA (``parallel/adlda.ShardedLda``)
  over every position of ``parallel/multihost.local_devices``, in the
  deferred tier; on the card the trained corpus keeps at least 2^24 tokens,
  as the reference's does on its accelerator;
- rung 4: four chains (``models/chains.ChainSet``), split-R̂ on φ in
  doubling windows with a gate (p99 < 1.2), Minka's α and β;
- rung 5: PubMed-shaped, the five backends side by side.

Each rung returns a JSON-able dict; ``main`` writes them to ``--out`` as
they finish.

Usage::

    python -m ldagibbssampling_tpu_torch.benchmarks.ladder --rungs 1,2,3,4,5 \\
        --scale 0.01 [--device cpu] [--out ladder_report_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.data.synthetic import planted_topic_corpus
from ldagibbssampling_tpu_torch.evaluation.metrics import perplexity
from ldagibbssampling_tpu_torch.evaluation.tracing import block_on_backend

def _timed_sweeps(model, n: int) -> float:
    """Run n sweeps, return steady-state tokens/s.

    TWO warm-up calls, as the reference: the first builds what a cold start
    builds (kernels, the deferred tier's snapshot), the second runs the
    steady call, so neither lands inside the timed window.
    """
    model.sweep(1)
    block_on_backend(model)
    model.sweep(1)
    block_on_backend(model)
    t0 = time.perf_counter()
    model.sweep(n)
    block_on_backend(model)
    dt = time.perf_counter() - t0
    return n * model.corpus.num_tokens / max(dt, 1e-9)


def rung1(scale: float, sweeps: int = 200, device: Any = "cuda") -> dict:
    """Mini-corpus fidelity: seeded oracle vs blocked sweep, K=10."""
    import tempfile

    from ldagibbssampling_tpu_torch.corpus.documents import Documents
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu_torch.data import write_minicorpus
    from ldagibbssampling_tpu_torch.models.lda import LdaModel
    from ldagibbssampling_tpu_torch.models.oracle import OracleSampler

    with tempfile.TemporaryDirectory() as d:
        write_minicorpus(d, num_docs=20)
        corpus = FlatCorpus.from_documents(Documents().read_docs(d))
    cfg = LdaConfig(topic_num=10, alpha=0.5, beta=0.1, seed=42, block_size=64)
    oracle = OracleSampler(corpus, 10, 0.5, 0.1, seed=42)
    oracle.sweep(sweeps)
    blocked = LdaModel(cfg, corpus, device=device)
    blocked.sweep(sweeps)
    p_oracle = perplexity(oracle.phi(), oracle.theta(), corpus)
    p_blocked = perplexity(blocked.phi(), blocked.theta(), corpus)
    return {
        "rung": 1, "corpus": "stand-in mini-corpus", "K": 10,
        "sweeps": sweeps, "tokens": corpus.num_tokens,
        "kernel_tier": blocked.kernel_tier,
        "perplexity_oracle": p_oracle, "perplexity_blocked": p_blocked,
        "rel_gap": abs(p_oracle - p_blocked) / p_oracle,
        # "bit-comparable vs the seeded oracle": the fidelity mode must
        # reproduce the serial chain exactly, in the report
        "bitwise_z_match": _fidelity_bit_match(corpus, n_sweeps=3),
    }


def _fidelity_bit_match(corpus, n_sweeps: int = 3, k: int = 3) -> bool:
    """The fidelity sweep vs the JavaRandom oracle: True iff z and nwk match
    bitwise after ``n_sweeps`` systematic sweeps.  On the CPU in float64
    (the oracle's probability arithmetic), as the reference runs it."""
    import torch

    from ldagibbssampling_tpu_torch.models.oracle import OracleSampler
    from ldagibbssampling_tpu_torch.models.state import SamplerState
    from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep

    oracle = OracleSampler(corpus, num_topics=k, seed=42)
    state = SamplerState(*(torch.from_numpy(np.asarray(a, np.int32)) for a in (
        oracle.z, oracle.ndk, oracle.nwk, oracle.nk)))
    tw = torch.from_numpy(corpus.token_word.astype(np.int32))
    td = torch.from_numpy(corpus.token_doc.astype(np.int32))
    tm = torch.ones_like(tw)
    dl = torch.from_numpy(corpus.doc_lengths().astype(np.int32))
    for _ in range(n_sweeps):
        # continue the oracle's JavaRandom stream for this sweep's draws,
        # then rewind so oracle.sweep consumes the same draws
        saved = oracle.rng._seed
        uniforms = torch.tensor(
            [oracle.rng.next_double() for _ in range(corpus.num_tokens)],
            dtype=torch.float64)
        state = gibbs_sweep(
            state, tw, td, tm, dl, alpha=0.5, beta=0.1, block_size=1,
            draw_method="inverse_cdf", prob_dtype=torch.float64,
            noise_mode="external", noise=uniforms)
        oracle.rng._seed = saved
        oracle.sweep(1)
        if not np.array_equal(state.z.numpy(), oracle.z):
            return False
    return bool(np.array_equal(state.nwk.numpy(), oracle.nwk))


def rung_corpus(rung: int, scale: float):
    """``(corpus, heldout)`` of rung 2, 4 or 5 at ``scale``: the synthetic
    stand-in with the rung's statistical shape (rung 4 holds nothing out:
    ``heldout`` is ``None``)."""
    if rung == 2:
        m = max(20, int(19_000 * scale))
        v = max(200, int(60_000 * min(1.0, scale * 5)))
        full, _ = planted_topic_corpus(m, v, 20, mean_doc_len=120, seed=1)
        return full.split_docs(0.05, seed=1)
    if rung == 4:
        m = max(40, int(4_000 * scale * 10))
        v = max(300, int(20_000 * min(1.0, scale * 5)))
        return planted_topic_corpus(m, v, 10, mean_doc_len=80, seed=3)[0], None
    if rung == 5:
        m = max(60, int(8_200_000 * scale / 100))
        v = max(400, int(20_000 * min(1.0, scale * 5)))
        full, _ = planted_topic_corpus(m, v, 15, mean_doc_len=100, seed=4)
        return full.split_docs(0.05, seed=4)
    raise ValueError(f"rung {rung} has no synthetic corpus here")


def _heldout_ppl(phi, heldout, alpha: float, device: Any) -> float:
    """Doc-completion held-out perplexity via the batched device fold-in."""
    from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
        heldout_perplexity_device)

    return float(heldout_perplexity_device(phi, heldout, alpha, device=device))


def rung2(scale: float, sweeps: int = 20, device: Any = "cuda") -> dict:
    """20NG-shaped single-card Gibbs: ~19k docs × scale, V=60k, K=20."""
    from ldagibbssampling_tpu_torch.models.lda import LdaModel

    # the north star is HELD-OUT perplexity: train on 95% of the documents,
    # fold in and score the rest
    corpus, heldout = rung_corpus(2, scale)
    m, v = corpus.num_docs + heldout.num_docs, corpus.vocab_size
    cfg = LdaConfig(topic_num=20, seed=0, block_size=16_384)
    model = LdaModel(cfg, corpus, device=device)
    tps = _timed_sweeps(model, sweeps)
    return {
        "rung": 2, "corpus": f"synthetic 20NG-shaped ({m} docs, V={v})",
        "K": 20, "tokens": corpus.num_tokens, "sweeps": sweeps,
        "kernel_tier": model.kernel_tier,
        "tokens_per_s": tps,
        "perplexity": perplexity(model.phi(), model.theta(), corpus),
        "held_out_docs": heldout.num_docs,
        "held_out_ppl": _heldout_ppl(model.phi(), heldout, cfg.alpha, device),
    }


def rung3_shape(scale: float, floor: bool = False) -> tuple[int, int]:
    """``(documents, V)`` of rung 3 at ``scale``; with ``floor`` (rung 3 on
    the card) enough documents for 2^24 training tokens, the floor inflated
    by 1/0.95 for the held-out split (reference ``ladder.py:185-192``)."""
    m = max(40, int(300_000 * scale))
    if floor:
        m = max(m, int(((1 << 24) // 300 + 1) / 0.95) + 1)
    return m, max(500, int(100_000 * min(1.0, scale * 5)))


def rung3_corpus(scale: float, floor: bool = False):
    """``(corpus, heldout, m, v)`` of rung 3 at ``scale``: NYT-shaped
    (``zipf_corpus``, 300 tokens per document), 5% of the documents held
    out; ``floor`` as in :func:`rung3_shape`."""
    from ldagibbssampling_tpu_torch.data.synthetic import zipf_corpus

    m, v = rung3_shape(scale, floor)
    corpus, heldout = zipf_corpus(m, v, mean_doc_len=300, seed=2).split_docs(
        0.05, seed=2)
    if floor and corpus.num_tokens < (1 << 24):
        raise AssertionError(f"rung 3 trains {corpus.num_tokens} < 2^24 tokens")
    return corpus, heldout, m, v


def rung3(scale: float, sweeps: int = 10, device: Any = "cuda") -> dict:
    """NYT-shaped document-sharded AD-LDA over every position (one shard
    per CUDA device; on the CPU one), K = 100, block 65,536, in the tier the
    config resolves to (deferred).  Two warm-up calls, then ``sweeps``
    timed; the counts are checked against a recount after."""
    import torch

    from ldagibbssampling_tpu_torch.parallel import multihost
    from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda

    t0 = time.perf_counter()
    corpus, heldout, m, v = rung3_corpus(
        scale, floor=torch.device(device).type == "cuda")
    corpus_s = time.perf_counter() - t0
    n_dev = len(multihost.global_devices(device)[0])
    cfg = LdaConfig(topic_num=100, seed=0, block_size=65_536)
    t0 = time.perf_counter()
    model = ShardedLda(cfg, corpus, num_shards=n_dev, device=device)
    block_on_backend(model)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.sweep(1)
    block_on_backend(model)
    model.sweep(1)
    block_on_backend(model)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.sweep(sweeps)
    block_on_backend(model)
    dt = time.perf_counter() - t0
    model.check_counts_consistent()
    return {
        "rung": 3, "corpus": f"synthetic NYT-shaped ({m} docs, V={v})",
        "K": 100, "tokens": corpus.num_tokens, "devices": n_dev,
        "shards": model.mesh.size, "sweeps": sweeps,
        "kernel_tier": model.kernel_tier,
        "tokens_per_s": sweeps * corpus.num_tokens / max(dt, 1e-9),
        "corpus_s": corpus_s, "setup_s": setup_s, "warmup_s": warmup_s,
        "counts_consistent": True,
        "held_out_docs": heldout.num_docs,
        "held_out_ppl": _heldout_ppl(model.phi(), heldout, cfg.alpha, device),
    }


def rung4(scale: float, sweeps: int = 240, sweep_cap_factor: int = 8,
          device: Any = "cuda") -> dict:
    """Multi-chain R̂ on φ + Minka hyperparameter adaptation (Wikipedia rung).

    Chains record φ draws, topics are aligned across chains (label
    switching), and the report is GATED: the sweep budget scales with the
    corpus, recording uses the O(C·K·V) running-moment accumulator, and a
    run that does not converge publishes ``"gate": "FAILED"``.  Recording
    runs in doubling windows: while the gate fails, the window so far
    becomes burn-in and a window of twice the length is recorded, until the
    gate passes or the budget reaches ``sweep_cap_factor`` times the scaled
    base budget.
    """
    import torch

    from ldagibbssampling_tpu_torch.models.chains import ChainSet
    from ldagibbssampling_tpu_torch.models.hyper import optimize_alpha, optimize_beta

    corpus, _ = rung_corpus(4, scale)
    m, v = corpus.num_docs, corpus.vocab_size
    cfg = LdaConfig(topic_num=10, seed=0, block_size=8_192, chains=4)
    chains = ChainSet(cfg, corpus, num_chains=4, device=device)
    thin = 5
    base = max(sweeps, int(sweeps * (m / 400.0) ** 0.5))
    cap = sweep_cap_factor * base

    burn = base // 2
    chains.sweep(burn)  # unrecorded: no host sync
    total = burn
    window = base - burn
    history = []
    while True:
        chains.reset_phi_accumulator()
        draws = max(4, (window // thin) // 2 * 2)  # even; >=2 per half
        for di in range(draws):
            chains.sweep(thin - 1)
            chains.sweep(1, record_ll=True)
            chains.record_phi(half=0 if di < draws // 2 else 1)
        total += draws * thin
        rhat_phi = chains.r_hat_phi()
        history.append({"sweeps_total": total, "window_draws": draws,
                        "r_hat_phi_p99": rhat_phi["p99"],
                        "r_hat_phi_max": rhat_phi["max"]})
        print(f"rung4: {total} sweeps, window {draws} draws -> "
              f"R-hat(phi) p99 = {rhat_phi['p99']:.3f}",
              file=sys.stderr, flush=True)
        if rhat_phi["p99"] < 1.2 or total + 2 * draws * thin > cap:
            break
        window *= 2

    converged = bool(rhat_phi["p99"] < 1.2)
    rhat_ll = chains.r_hat_ll()
    s0 = chains.chain_state(0)
    lengths = torch.from_numpy(corpus.doc_lengths()).to(s0.ndk.device)
    a = float(optimize_alpha(s0.ndk, lengths, cfg.alpha))
    b = float(optimize_beta(s0.nwk, s0.nk, cfg.beta))
    out = {
        "rung": 4, "corpus": f"synthetic ({m} docs, V={v})", "K": 10,
        "chains": 4, "sweeps": total, "sweep_cap": cap,
        "gate": "PASSED" if converged else "FAILED",
        "r_hat_ll": rhat_ll,
        "r_hat_phi_max": rhat_phi["max"], "r_hat_phi_p99": rhat_phi["p99"],
        "r_hat_phi_frac_gt_1_1": rhat_phi["frac_gt_1_1"],
        "r_hat_history": history,
        "alpha_opt": a, "beta_opt": b,
    }
    if not converged:
        print(
            "*** RUNG 4 CONVERGENCE GATE FAILED: aligned R-hat(phi) p99 = "
            f"{rhat_phi['p99']:.3f} after {total} sweeps (cap {cap}) — "
            "published as FAILED, not as a silent number ***",
            file=sys.stderr, flush=True,
        )
    return out


def rung5(scale: float, sweeps: int = 15, device: Any = "cuda") -> dict:
    """Backend shoot-out (PubMed-rung shape): Gibbs, CVB0, SVI, WarpLDA, SMC."""
    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model
    from ldagibbssampling_tpu_torch.backends.smc import SmcModel
    from ldagibbssampling_tpu_torch.backends.svi import SviModel
    from ldagibbssampling_tpu_torch.backends.warp import WarpModel
    from ldagibbssampling_tpu_torch.models.lda import LdaModel

    corpus, heldout = rung_corpus(5, scale)
    m, v = corpus.num_docs + heldout.num_docs, corpus.vocab_size
    cfg = LdaConfig(topic_num=15, seed=0, block_size=8_192)
    out: dict = {
        "rung": 5, "corpus": f"synthetic PubMed-shaped ({m} docs, V={v})",
        "K": 15, "tokens": corpus.num_tokens, "sweeps": sweeps,
        "held_out_docs": heldout.num_docs,
    }
    # SMC runs its design-premise budget, ONE absorb pass (a single-pass
    # posterior, no burn-in): its per-token sequential absorb makes matched
    # multi-sweep budgets pointless (backends/smc.py)
    builders = [
        ("gibbs", lambda: LdaModel(cfg, corpus, device=device), sweeps),
        ("cvb0", lambda: Cvb0Model(cfg, corpus, device=device), sweeps),
        ("svi", lambda: SviModel(cfg, corpus, batch_size=64, device=device),
         sweeps),
        ("warp", lambda: WarpModel(cfg, corpus, device=device), sweeps),
        ("smc", lambda: SmcModel(cfg, corpus, device=device), 1),
    ]
    for name, build, n_passes in builders:
        model = build()
        t0 = time.perf_counter()
        model.sweep(n_passes)
        block_on_backend(model)
        dt = time.perf_counter() - t0
        out[f"{name}_perplexity"] = perplexity(model.phi(), model.theta(), corpus)
        out[f"{name}_tokens_per_s"] = n_passes * corpus.num_tokens / max(dt, 1e-9)
        out[f"{name}_held_out_ppl"] = _heldout_ppl(
            model.phi(), heldout, cfg.alpha, device)
        if n_passes != sweeps:
            out[f"{name}_passes"] = n_passes
        del model
    return out


RUNGS = {1: rung1, 2: rung2, 3: rung3, 4: rung4, 5: rung5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the benchmark ladder on the port")
    ap.add_argument("--rungs", default="1,2,3,4,5",
                    help="comma-separated rung numbers (1-5)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="fraction of the real corpus size for synthetic rungs")
    ap.add_argument("--out", default="ladder_report_torch.json")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    rungs = [int(x) for x in args.rungs.split(",") if x.strip()]
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        print(f"error: unknown rungs {unknown}", file=sys.stderr)
        return 2
    from ldagibbssampling_tpu_torch.models.lda import resolve_device

    resolve_device(args.device)  # no card: fail before any rung runs

    report = {"scale": args.scale, "device": args.device, "rungs": [],
              "gate_failures": []}
    for r in rungs:
        t0 = time.perf_counter()
        try:
            res = RUNGS[r](args.scale, device=args.device)
        except Exception as e:  # noqa: BLE001 — a rung's crash must not
            # lose the finished rungs' results: recorded loudly, exit 1
            res = {"rung": r, "gate": "FAILED",
                   "error": f"{type(e).__name__}: {e}"}
            report["gate_failures"].append(r)
            print(f"*** RUNG {r} CRASHED: {res['error']} ***",
                  file=sys.stderr, flush=True)
        res["wall_s"] = time.perf_counter() - t0
        report["rungs"].append(res)
        if res.get("gate") == "FAILED" and r not in report["gate_failures"]:
            report["gate_failures"].append(r)
        print(json.dumps(res), flush=True)
        # written after every rung: a later crash or a killed run keeps
        # everything measured so far
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(f"wrote {args.out}", file=sys.stderr)
    if report["gate_failures"]:
        print(f"GATE FAILURES on rungs {report['gate_failures']} — "
              "see the report's r_hat entries", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
