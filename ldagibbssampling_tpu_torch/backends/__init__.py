"""Inference backends behind one protocol; the port has the Gibbs backend."""

from ldagibbssampling_tpu_torch.backends.base import InferenceBackend, make_backend

__all__ = ["InferenceBackend", "make_backend"]
