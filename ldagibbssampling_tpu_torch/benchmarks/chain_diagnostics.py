"""The chains' diagnostics timed apart on the card, for this checkout's
package and, optionally, another checkout's.

    python -m ldagibbssampling_tpu_torch.benchmarks.chain_diagnostics [--parent DIR] [--rounds N]

Two shapes, the ones ``chip_smoke.py`` runs:

- ``wide``: ``MultiChainModel`` with K = 500 and 4 chains on bench.py's
  corpus (T = 2^20 Zipf(1.1) tokens, V = 50,000, M = 4,096, block 65,536,
  alpha 0.5, beta 0.1), after two unrecorded sweeps.  Times, each
  synchronised: one sweep of the four chains; ``record_ll``; building
  every chain's φ on the card (``_phi_theta``) and ``_phis()`` (φ built
  and copied to the host); ``record_phi(half)`` four times (two draws per
  half, a sweep before each) and the running accumulator's ``result()``,
  the window summary;
  ``record_phi_auto`` three times mid-window; the runner's LL row
  (``device_log_likelihood()`` where the model has it, else the host
  ``log_likelihood(phi(), theta())``, as ``runner.run_inference`` picks);
  and ``MultiChainModel.sweep(1)`` four times from a fresh window (the
  fourth completes it); peak device memory.
- ``mesh``: ``ShardedChainSet``, 2 chains x 2 shards on four positions of
  the first card, rung 3's corpus at scale 0.02, K = 100, the deferred
  tier, after one sweep: ``record(ll=True)`` twice.

With ``--parent DIR`` (the root of another checkout, e.g. the parent
commit unpacked with ``git archive``) each side runs in a process of its
own, importing its own checkout's package, in the order other, this, this,
other (``--rounds`` times over); without it this checkout runs once.
Prints the card's name and power limit and one JSON line of each side's
runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
T, V, M, K, CHAINS = 1 << 20, 50_000, 4_096, 500, 4
BLOCK, ALPHA, BETA = 65_536, 0.5, 0.1
MESH_SCALE, MESH_K = 0.02, 100


def _wide_corpus(seed: int):
    import numpy as np

    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.1, size=T).astype(np.int64) - 1) % V).astype(np.int32)
    td = (np.arange(T, dtype=np.int64) * M // T).astype(np.int32)
    doc_ptr = np.zeros(M + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=M), out=doc_ptr[1:])
    return FlatCorpus(tw, td, doc_ptr, V)


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(fn) -> float:
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t0


def wide(seed: int, device: str = "cuda") -> dict:
    import torch

    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation.metrics import log_likelihood
    from ldagibbssampling_tpu_torch.models.chains import MultiChainModel

    corpus = _wide_corpus(seed)
    cfg = LdaConfig(topic_num=K, seed=seed, block_size=BLOCK, alpha=ALPHA,
                    beta=BETA, chains=CHAINS)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = MultiChainModel(cfg, corpus, device=device)
    chains = model.chains
    chains.sweep(2)
    out = {"sweep_s": _timed(lambda: chains.sweep(1)),
           "record_ll_s": _timed(chains.record_ll),
           "phi_build_s": _timed(lambda: [chains._phi_theta(d)[0] for d in chains._batches]),
           "phis_to_host_s": _timed(chains._phis)}
    out["record_phi_s"] = []
    for half in (0, 0, 1, 1):  # a window of draws from moving chains
        chains.sweep(1)
        out["record_phi_s"].append(_timed(lambda: chains.record_phi(half)))
    out["summary_s"] = _timed(chains.phi_accum.result)
    summary = chains.phi_accum.result()
    out["summary"] = {k: summary[k] for k in ("max", "p99", "frac_gt_1_1", "n_cells")}
    chains.reset_phi_accumulator()
    out["record_phi_auto_mid_window_s"] = [_timed(chains.record_phi_auto) for _ in range(3)]
    chains.phi_window = None
    dev_ll = getattr(model, "device_log_likelihood", None)
    if callable(dev_ll):
        out["ll_row_route"] = "device_log_likelihood"
        out["ll_row_s"] = _timed(dev_ll)
    else:
        out["ll_row_route"] = "host log_likelihood(phi(), theta())"
        out["ll_row_s"] = _timed(
            lambda: log_likelihood(model.phi(), model.theta(), corpus))
    out["model_sweep_s"] = [_timed(lambda: model.sweep(1)) for _ in range(4)]
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    return out


def mesh(seed: int, device: str = "cuda") -> dict:
    import torch

    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung3_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.parallel import multihost
    from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet

    corpus, _, _, _ = rung3_corpus(MESH_SCALE)
    cfg = LdaConfig(topic_num=MESH_K, seed=seed, block_size=BLOCK,
                    use_pallas="deferred")
    dev = multihost.local_devices(device)[0]
    model = ShardedChainSet(cfg, corpus, num_chains=2, mesh=multihost.make_mesh(
        {"chain": 2, "data": 2}, [dev] * 4), device=device)
    model.sweep(1)
    secs = [_timed(lambda: model.record(ll=True)) for _ in range(2)]
    return {"tokens": corpus.num_tokens, "kernel_tier": model.kernel_tier,
            "record_ll_s": secs, "ll": [float(x) for x in model.ll_trace[-1]]}


def run_side(root: Path, seed: int, out: Path) -> None:
    """One side: the package of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import ldagibbssampling_tpu_torch as pkg

    where = Path(pkg.__file__).resolve()
    if root.resolve() not in where.parents:
        raise RuntimeError(f"imported {where}, not the package under {root}")
    out.write_text(json.dumps({"package": str(where), "wide": wide(seed),
                               "mesh": mesh(seed)}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over the order other, this, this, other")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side is not None:
        run_side(args.side, args.seed, args.out)
        return 0
    if args.parent is not None and not (args.parent / "ldagibbssampling_tpu_torch").is_dir():
        ap.error("--parent must be the root of a checkout of this repository")
    import torch

    if not torch.cuda.is_available():
        print("chain_diagnostics: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    sides = {"this": REPO}
    order: tuple = ("this",)
    if args.parent is not None:
        sides["other"] = args.parent.resolve()
        order = ("other", "this", "this", "other") * args.rounds
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(order):
            out = Path(tmp) / f"{i}_{side}.json"
            subprocess.run([sys.executable, str(HERE), "--side", str(sides[side]),
                            "--seed", str(args.seed), "--out", str(out)],
                           check=True, timeout=1200, cwd=tmp)
            res = json.loads(out.read_text())
            print(f"[{side}] {json.dumps(res)}", flush=True)
            runs.append({"side": side, **res})
    print(json.dumps({"device": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
