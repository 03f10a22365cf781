"""Backend-agnostic inference driver.

Counterpart of ``ldagibbssampling_tpu/runner.py``: the reference's
``inferenceModel`` loop (save schedule + guard) over any
:class:`InferenceBackend`, batching the sweeps between schedule boundaries
into one ``backend.sweep(chunk)`` call, with the reference's Minka (α, β)
updates (``optimize_hyper_every``), training log-likelihood rows
(``ll_every``), the multi-chain R̂ rows and checkpoints
(``checkpoint_every``).  Backends without per-token assignments (SVI) get
MAP assignments from (φ, θ) for the ``.tassign`` artifact.  The LL, Minka,
checkpoint and artifact steps are the spans ``runner.ll``, ``runner.hyper``,
``runner.checkpoint`` and ``runner.save`` (``evaluation/tracing``), which a
``--profile-dir`` trace shows.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ldagibbssampling_tpu_torch.backends.base import InferenceBackend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.evaluation.tracing import (
    MetricsLog, SweepTimer, block_on_backend, span)
from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model

# counters a metrics row carries when they moved since the row before: a
# recapture or a state copied into the sweep graph mid-run (ops/graphs.py),
# K1's walks in each form (ops/fused_kernel.py), counted at every launch and
# every replay of a graph that holds one, so they move with every sweep
ROW_COUNTERS = ("graph.captures", "graph.copy_in_bytes", "walk.tagged_records",
                "walk.two_barrier")


def map_assignments(phi: np.ndarray, theta: np.ndarray, corpus: FlatCorpus) -> np.ndarray:
    """MAP topic per token: argmax_k φ[k, w_t]·θ[d_t, k]."""
    scores = theta[corpus.token_doc] * phi[:, corpus.token_word].T  # [T, K]
    return scores.argmax(axis=1).astype(np.int32)


def _assignments(backend: InferenceBackend, corpus: FlatCorpus) -> np.ndarray:
    z_fn = getattr(backend, "z", None)
    if callable(z_fn):
        return np.asarray(z_fn())
    return map_assignments(backend.phi(), backend.theta(), corpus)


def save_backend_model(
    backend: InferenceBackend,
    iteration: int,
    result_dir: str | Path,
    corpus: FlatCorpus,
    config: LdaConfig,
):
    with span("runner.save"):
        return save_iterated_model(
            result_dir, iteration, backend.phi(), backend.theta(),
            _assignments(backend, corpus), corpus, config,
        )


def run_inference(
    backend: InferenceBackend,
    config: LdaConfig,
    corpus: FlatCorpus,
    result_dir: Optional[str | Path] = None,
    progress: Optional[Callable[[int], None]] = None,
    metrics: Optional["MetricsLog"] = None,
    metrics_every: int = 1,
    ll_every: int = 0,
    optimize_hyper_every: int = 0,
    checkpoint_dir: Optional[str | Path] = None,
    checkpoint_every: int = 0,
    header: Optional[dict] = None,
) -> None:
    """The reference inference loop: sweep with the periodic save schedule.

    ``metrics`` gets one header row (the tier, the backend and ``header``'s
    keys) and then a throughput row every
    ``metrics_every`` sweeps (0: rows only at the other boundaries); a row
    forces a device synchronise so its time covers the compute.
    ``optimize_hyper_every`` runs the backend's ``optimize_hyperparameters``
    after every N-th sweep.  ``ll_every`` adds ``log_likelihood`` and
    ``perplexity`` to the metrics row after every N-th sweep (the backend's
    ``device_log_likelihood``, else the host ``evaluation/metrics``); rows
    carry the live ``alpha`` and ``beta``, and for a multi-chain backend
    ``r_hat`` (the split-R̂ of the chains' LL traces, left out while NaN)
    and, on the LL cadence, ``r_hat_phi_p99`` (the topic-aligned R̂ on φ).
    ``checkpoint_dir`` +
    ``checkpoint_every`` save the backend's checkpoint after every N-th
    sweep (after that sweep's hyperparameter update); the loop starts at the
    backend's ``sweeps_done``, so a restored backend resumes mid-schedule.
    A row also carries the seconds of the spans recorded since the row
    before, other than the runner's own (``<name>_s``: the sweep graph's
    set-up in the first row after it), and the counters of
    ``ROW_COUNTERS`` that moved since then, by how much
    (``graph_captures``, ``graph_copy_in_bytes``, ``walk_tagged_records``,
    ``walk_two_barrier``).
    """
    if result_dir is not None:
        config.validate_reference_guard()
    timer = SweepTimer(corpus.num_tokens)
    start = int(getattr(backend, "sweeps_done", 0))
    since, last = len(tracing.spans()), tracing.counters()

    def _moved() -> dict:
        """The spans and ``ROW_COUNTERS`` since the last row, as fields."""
        nonlocal since, last
        now = tracing.counters()
        out = tracing.span_fields(since, skip=("runner.",))
        out.update({name.replace(".", "_"): now.get(name, 0) - last.get(name, 0)
                    for name in ROW_COUNTERS if now.get(name, 0) != last.get(name, 0)})
        since, last = len(tracing.spans()), now
        return out

    if metrics is not None:
        metrics.log(
            start, kernel_tier=getattr(backend, "kernel_tier", "n/a"),
            requested_tier=str(config.use_pallas), backend=config.backend,
            **(header or {}),
        )

    def _save_due(i: int) -> bool:
        return (result_dir is not None and i >= config.begin_save_iters
                and (i - config.begin_save_iters) % config.save_step == 0)

    def _boundary(i: int) -> bool:
        """Does anything on the schedule need to run right after sweep i?"""
        n = i + 1
        if _save_due(n):
            return True
        if optimize_hyper_every > 0 and n % optimize_hyper_every == 0:
            return True
        if checkpoint_dir is not None and checkpoint_every > 0 and (
                n % checkpoint_every == 0):
            return True
        if metrics is not None and metrics_every > 0 and n % metrics_every == 0:
            return True
        return metrics is not None and ll_every > 0 and n % ll_every == 0

    i = start
    while i < config.iteration:
        if _save_due(i):
            save_backend_model(backend, i, result_dir, corpus, config)
        # batch sweeps up to the next schedule boundary into one call
        chunk = 1
        while i + chunk < config.iteration and not _boundary(i + chunk - 1):
            chunk += 1
        with timer:
            backend.sweep(chunk)
            if metrics is not None:
                block_on_backend(backend)
        i_last = i + chunk - 1
        if (optimize_hyper_every > 0
                and (i_last + 1) % optimize_hyper_every == 0
                and hasattr(backend, "optimize_hyperparameters")):
            with span("runner.hyper"):
                backend.optimize_hyperparameters()
        if (checkpoint_dir is not None and checkpoint_every > 0
                and (i_last + 1) % checkpoint_every == 0
                and hasattr(backend, "save_checkpoint")):
            with span("runner.checkpoint"):
                backend.save_checkpoint(checkpoint_dir)
        if metrics is not None:
            scalars = {
                "tokens_per_s": chunk * corpus.num_tokens
                / max(timer.times[-1], 1e-12),
            }
            if chunk > 1:
                scalars["sweeps_in_chunk"] = chunk
            if ll_every > 0 and (i_last + 1) % ll_every == 0:
                dev_ll = getattr(backend, "device_log_likelihood", None)
                with span("runner.ll"):
                    if callable(dev_ll):
                        ll = dev_ll()  # chunked on the device
                    else:
                        from ldagibbssampling_tpu_torch.evaluation.metrics import (
                            log_likelihood)

                        ll = log_likelihood(backend.phi(), backend.theta(), corpus)
                scalars["log_likelihood"] = ll
                if corpus.num_tokens:
                    scalars["perplexity"] = float(np.exp(-ll / corpus.num_tokens))
            for name in ("alpha", "beta"):
                value = getattr(backend, name, None)
                if value is not None:
                    scalars[name] = value
            r_hat_fn = getattr(backend, "r_hat", None)
            if callable(r_hat_fn):
                rh = r_hat_fn()
                if rh == rh:  # NaN until 4 sweeps are recorded
                    scalars["r_hat"] = rh
            if ll_every > 0 and (i_last + 1) % ll_every == 0:
                # the O(C·K·V) φ summary, on the LL cadence only
                rhp_fn = getattr(backend, "r_hat_phi", None)
                if callable(rhp_fn):
                    p99 = rhp_fn().get("p99", float("nan"))
                    if p99 == p99:
                        scalars["r_hat_phi_p99"] = p99
            metrics.log(i_last, **scalars, **_moved())
        if progress is not None:
            for j in range(i, i_last + 1):  # keep per-iteration stdout parity
                progress(j)
        i = i_last + 1
