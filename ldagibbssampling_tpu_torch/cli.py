"""Command-line driver of the PyTorch/CUDA port.

Counterpart of ``ldagibbssampling_tpu/cli.py`` (reference:
``LdaGibbsSampling.main``): load parameters, ingest the docs directory,
initialize, run the sweep loop with periodic saves, dump the final model.
It takes the reference CLI's flags, plus ``--device {cuda,cpu}`` (default
``cuda``; without CUDA the run fails rather than carry on on the CPU).
``--backend`` picks gibbs, cvb0, svi, smc or warp, ``--chains N`` runs N
blocked Gibbs chains with R̂ in the metrics rows, and ``--mesh`` (e.g.
``data=4``, ``data=2,vocab=2``, ``token=8``, ``chain=2,data=2``; -1 = every
position) runs a parallel runtime of ``parallel/`` over the positions of
``parallel/multihost.local_devices`` (the serial oracle ignores
``--chains`` and ``--mesh``, as in the reference).  ``--checkpoint-dir``/``--checkpoint-every``/``--resume`` save
and restore the whole run (``lda_io/checkpoint.py``), and ``--infer-docs``
folds unseen documents into the trained model (``lda_io/infer.py``), with
the reference's messages and exit codes, including its refusals:
checkpoints and resume for a backend without them (smc, warp, several
chains) and ``--check-counts`` for one without integer count tables.  K1's
chain and the deferred snapshot's type come in through ``--config-json``
(``kernel_compute_dtype``, ``mirror_dtype``), as in the reference.
``--profile-dir`` writes a ``torch.profiler`` trace of the run from the
backend's construction on, its set-up spans included
(``evaluation/tracing``); ``--metrics-file``'s header row carries the
ingest's and the backend's seconds (the spans ``cli.ingest`` and
``cli.backend_init``), the seconds of the set-up spans inside them
(``<name>_s``) and the kernel libraries built and opened
(``kernels_built``, ``kernels_loaded``).

Usage:
    python -m ldagibbssampling_tpu_torch.cli --docs data/LdaOriginalDocs \\
        --results data/LdaResults [--params data/LdaParameters.txt] [overrides]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

from ldagibbssampling_tpu_torch import conf
from ldagibbssampling_tpu_torch.config import LdaConfig, ReferenceGuardError
from ldagibbssampling_tpu_torch.evaluation import tracing


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lda-torch",
        description="collapsed-Gibbs LDA trainer (PyTorch/CUDA port)")
    # reference PathConfig defaults (conf.py)
    ap.add_argument("--docs", default=conf.LDA_DOCS_PATH, help="corpus directory")
    ap.add_argument("--results", default=conf.LDA_RESULTS_PATH, help="artifact output directory")
    ap.add_argument("--params", default=None, help="reference-format tab-separated parameter file")
    ap.add_argument("--config-json", default=None, help="engine-native JSON config file")
    # the six reference knobs as overrides
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--topics", "-k", dest="topic_num", type=int, default=None)
    ap.add_argument("--iterations", dest="iteration", type=int, default=None)
    ap.add_argument("--save-step", dest="save_step", type=int, default=None)
    ap.add_argument("--begin-save-iters", dest="begin_save_iters", type=int, default=None)
    # engine knobs
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--block-size", dest="block_size", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the CUDA kernels; cpu runs "
                         "their plain PyTorch versions")
    ap.add_argument("--generate-minicorpus", action="store_true",
                    help="populate --docs with the deterministic stand-in corpus first")
    ap.add_argument("--no-save", action="store_true",
                    help="skip artifact writing (timing / benchmark runs)")
    ap.add_argument("--metrics-file", default=None,
                    help="append JSONL metrics (throughput, LL, alpha/beta) here")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="metrics row cadence in sweeps (default 1)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run into this dir")
    ap.add_argument("--check-counts", action="store_true",
                    help="after training, recompute every count table "
                         "serially from z and assert bitwise equality with "
                         "the device tables")
    ap.add_argument("--pallas", dest="use_pallas",
                    choices=["0", "1", "fused", "deferred"], default=None,
                    help="kernel tier: 0 = XLA sweep, 1 = v1 draw kernel, "
                         "fused = fused block kernel, deferred = fused kernel "
                         "+ deferred word-topic rebuild (default)")
    ap.add_argument("--sampler", choices=["blocked", "serial"], default=None,
                    help="blocked (device sweep) or serial (Java-fidelity "
                         "host oracle)")
    ap.add_argument("--draw-method", dest="draw_method",
                    choices=["gumbel", "inverse_cdf"], default=None)
    ap.add_argument("--ll-every", type=int, default=0,
                    help="log training log-likelihood/perplexity every N "
                         "sweeps into --metrics-file (0 = off)")
    ap.add_argument("--optimize-hyper-every", type=int, default=0,
                    help="Minka fixed-point (alpha, beta) update every N "
                         "sweeps (0 = off)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (state, live alpha/beta and "
                         "the sweep seeds' generator)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every N sweeps into --checkpoint-dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --checkpoint-dir")
    ap.add_argument("--infer-docs", default=None,
                    help="after training, fold-in unseen documents from this "
                         "directory (trained vocabulary; new words dropped) and "
                         "write inferred.theta/.tassign to --results")
    ap.add_argument("--chains", type=int, default=None,
                    help="independent blocked-Gibbs chains (R-hat in the "
                         "metrics rows; artifacts from chain 0)")
    ap.add_argument("--backend", choices=["gibbs", "cvb0", "svi", "smc", "warp"],
                    default=None, help="inference backend (default gibbs)")
    ap.add_argument("--mesh", default=None,
                    help="parallel runtime mesh, e.g. 'data=4', 'data=2,vocab=2', "
                         "'token=8', 'chain=2,data=2' (-1 = all devices); "
                         "gibbs backend only")
    return ap


_OVERRIDE_FIELDS = (
    "alpha", "beta", "topic_num", "iteration", "save_step", "begin_save_iters",
    "seed", "chains", "sampler", "backend", "block_size", "draw_method",
)


def _file_config(args: argparse.Namespace) -> LdaConfig:
    if args.config_json:
        return LdaConfig.from_json(args.config_json)
    if args.params:
        return LdaConfig.from_reference_parameter_file(args.params)
    return LdaConfig()


def config_from_args(args: argparse.Namespace) -> LdaConfig:
    cfg = _file_config(args)
    overrides = {
        f: getattr(args, f) for f in _OVERRIDE_FIELDS if getattr(args, f) is not None
    }
    if args.use_pallas is not None:
        overrides["use_pallas"] = {
            "0": False, "1": True, "fused": "fused", "deferred": "deferred",
        }[args.use_pallas]
    if args.mesh:
        overrides["mesh"] = {
            k.strip(): int(v)
            for k, v in (kv.split("=") for kv in args.mesh.split(","))
        }
    return cfg.replace(**overrides) if overrides else cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # what this run records: its spans from here on, its counters' moves
    since, counted = len(tracing.spans()), tracing.counters()
    try:
        cfg = config_from_args(args)
    except NotImplementedError as e:  # a config file naming an unported path
        print(f"error: {e}", file=sys.stderr)
        return 2

    docs_dir = Path(args.docs)
    if args.generate_minicorpus:
        from ldagibbssampling_tpu_torch.data import write_minicorpus

        write_minicorpus(docs_dir)
    if not docs_dir.is_dir():
        print(f"error: docs directory {docs_dir} does not exist "
              "(use --generate-minicorpus for the stand-in corpus)", file=sys.stderr)
        return 2

    # the native C++ ingest where the corpus is ASCII and the library builds
    # (the same output; see corpus/native.py), the Python pipeline otherwise
    from ldagibbssampling_tpu_torch.corpus.native import read_docs_routed

    with tracing.span("cli.ingest") as ingest:
        corpus, route = read_docs_routed(docs_dir)
    ingest_s = ingest.seconds
    print(f"ingest: {route}; {corpus.num_tokens} tokens of {corpus.num_docs} "
          f"documents in {ingest_s:.3f}s")
    print(f"wordMap size {corpus.vocab_size}")
    if corpus.num_tokens == 0:
        print("error: corpus has no tokens after preprocessing", file=sys.stderr)
        return 2

    result_dir = None if args.no_save else Path(args.results)
    if result_dir is not None:
        # fail the reference guard before any device work
        try:
            cfg.validate_reference_guard()
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        result_dir.mkdir(parents=True, exist_ok=True)

    from ldagibbssampling_tpu_torch.backends import make_backend
    from ldagibbssampling_tpu_torch.evaluation.tracing import (
        MetricsLog, block_on_backend, trace)
    from ldagibbssampling_tpu_torch.runner import run_inference, save_backend_model

    def progress(i: int) -> None:
        print(f"Iteration {i}")

    with contextlib.ExitStack() as stack:
        if args.profile_dir:
            # open before the backend: its set-up spans land in the trace
            stack.enter_context(trace(args.profile_dir))
        print("1 Initialize the model ...")
        with tracing.span("cli.backend_init") as init:
            model = make_backend(cfg, corpus, device=args.device)
            block_on_backend(model)
        setup_s = init.seconds

        if args.checkpoint_every > 0 and not hasattr(model, "save_checkpoint"):
            print(f"error: backend {cfg.backend!r} does not support "
                  "checkpointing (smc/warp are documented non-goals)",
                  file=sys.stderr)
            return 2

        if args.resume:
            if not args.checkpoint_dir:
                print("error: --resume requires --checkpoint-dir", file=sys.stderr)
                return 2
            if not hasattr(model, "restore_checkpoint"):
                print(f"error: backend {cfg.backend!r} does not support resume",
                      file=sys.stderr)
                return 2
            from ldagibbssampling_tpu_torch.lda_io.checkpoint import latest_step

            if latest_step(args.checkpoint_dir) is not None:
                step = model.restore_checkpoint(args.checkpoint_dir)
                print(f"Resumed from sweep {step}")

        print("2 Learning and Saving the model ...")
        t0 = time.perf_counter()
        now = tracing.counters()
        header = {"ingest": route, "ingest_s": ingest_s, "setup_s": setup_s,
                  **tracing.span_fields(since, skip=("cli.",)),
                  **{name.replace(".", "_"): now.get(name, 0) - counted.get(name, 0)
                     for name in ("kernels.built", "kernels.loaded")}}
        metrics = None
        if args.metrics_file:
            metrics = stack.enter_context(MetricsLog(args.metrics_file))
        try:
            run_inference(
                model, cfg, corpus, result_dir, progress=progress,
                metrics=metrics, metrics_every=args.metrics_every,
                ll_every=args.ll_every,
                optimize_hyper_every=args.optimize_hyper_every,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                header=header,
            )
        except ReferenceGuardError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        block_on_backend(model)
    dt = time.perf_counter() - t0

    if args.check_counts:
        checker = getattr(model, "check_counts_consistent", None)
        if checker is None:
            print(f"error: backend {cfg.backend!r} has no count tables to "
                  "check (--check-counts is for the gibbs runtimes)",
                  file=sys.stderr)
            return 2
        checker()
        print("count tables bitwise-consistent with a serial recount of z")

    print("3 Output the final model ...")
    if result_dir is not None:
        save_backend_model(model, cfg.iteration, result_dir, corpus, cfg)

    if args.infer_docs:
        infer_dir = Path(args.infer_docs)
        if not infer_dir.is_dir():
            print(f"error: --infer-docs directory {infer_dir} does not exist",
                  file=sys.stderr)
            return 2
        out_dir = result_dir if result_dir is not None else Path(".")
        from ldagibbssampling_tpu_torch.lda_io.infer import infer_new_docs

        term_to_index = {t: i for i, t in enumerate(corpus.vocab)}
        alpha_live = float(getattr(model, "alpha", cfg.alpha))
        summary = infer_new_docs(
            model.phi(), infer_dir, term_to_index, alpha_live, out_dir,
            seed=cfg.seed,
        )
        print(f"Inferred {summary['num_docs']} new docs "
              f"({summary['num_tokens']} tokens, "
              f"{summary['dropped_unknown_terms']} unknown terms dropped) "
              f"-> {summary['theta']}")
    tokens = corpus.num_tokens * cfg.iteration
    print(f"Done: {cfg.iteration} sweeps over {corpus.num_tokens} tokens in "
          f"{dt:.2f}s ({tokens / max(dt, 1e-9):,.0f} tokens resampled/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
