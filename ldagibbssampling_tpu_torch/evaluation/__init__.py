"""Evaluation: metrics, convergence diagnostics, tracing and timing."""

from ldagibbssampling_tpu_torch.evaluation.diagnostics import r_hat
from ldagibbssampling_tpu_torch.evaluation.metrics import (
    heldout_perplexity,
    log_likelihood,
    perplexity,
)

__all__ = ["log_likelihood", "perplexity", "heldout_perplexity", "r_hat"]
