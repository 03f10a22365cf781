"""IO layer: reference-format artifact export."""

from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model

__all__ = ["save_iterated_model"]
