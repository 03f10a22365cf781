"""Backend-agnostic inference driver.

Counterpart of ``ldagibbssampling_tpu/runner.py``: the reference's
``inferenceModel`` loop (save schedule + guard) over any
:class:`InferenceBackend`, batching the sweeps between schedule boundaries
into one ``backend.sweep(chunk)`` call.  The hyperparameter, checkpoint and
log-likelihood branches are not ported yet and raise when asked for.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

from ldagibbssampling_tpu_torch.backends.base import InferenceBackend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import (
    MetricsLog, SweepTimer, block_on_backend)
from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model


def save_backend_model(
    backend: InferenceBackend,
    iteration: int,
    result_dir: str | Path,
    corpus: FlatCorpus,
    config: LdaConfig,
):
    return save_iterated_model(
        result_dir, iteration, backend.phi(), backend.theta(), backend.z(),
        corpus, config,
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
) -> None:
    """The reference inference loop: sweep with the periodic save schedule.

    ``metrics`` gets one header row and then a throughput row every
    ``metrics_every`` sweeps (0: rows only at save boundaries); a row forces
    a device synchronise so its time covers the compute.  ``ll_every``,
    ``optimize_hyper_every`` and ``checkpoint_*`` raise
    ``NotImplementedError`` when set (ROADMAP Queue 1 items 9-11).
    """
    missing = [name for name, on in (
        ("ll_every (ROADMAP Queue 1 item 9)", ll_every > 0),
        ("optimize_hyper_every (item 10)", optimize_hyper_every > 0),
        ("checkpoints (item 11)",
         checkpoint_dir is not None or checkpoint_every > 0),
    ) if on]
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    if result_dir is not None:
        config.validate_reference_guard()
    timer = SweepTimer(corpus.num_tokens)
    start = int(getattr(backend, "sweeps_done", 0))
    if metrics is not None:
        metrics.log(
            start, kernel_tier=getattr(backend, "kernel_tier", "n/a"),
            requested_tier=str(config.use_pallas), backend=config.backend,
        )

    def _save_due(i: int) -> bool:
        return (result_dir is not None and i >= config.begin_save_iters
                and (i - config.begin_save_iters) % config.save_step == 0)

    def _boundary(i: int) -> bool:
        """Does anything on the schedule need to run right after sweep i?"""
        n = i + 1
        if _save_due(n):
            return True
        return metrics is not None and metrics_every > 0 and n % metrics_every == 0

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
        if metrics is not None:
            scalars = {
                "tokens_per_s": chunk * corpus.num_tokens
                / max(timer.times[-1], 1e-12),
                "alpha": getattr(backend, "alpha", None),
                "beta": getattr(backend, "beta", None),
            }
            if chunk > 1:
                scalars["sweeps_in_chunk"] = chunk
            metrics.log(i_last, **scalars)
        if progress is not None:
            for j in range(i, i_last + 1):  # keep per-iteration stdout parity
                progress(j)
        i = i_last + 1
