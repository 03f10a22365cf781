"""IO layer: reference-format artifact export."""

from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model

__all__ = ["save_iterated_model"]


def __getattr__(name):  # lazy, as in the JAX package
    if name in ("save_checkpoint", "restore_checkpoint", "latest_step"):
        from ldagibbssampling_tpu_torch.lda_io import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
