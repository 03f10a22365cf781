"""PyTorch/CUDA port of the LDA collapsed-Gibbs engine, for NVIDIA Hopper.

Counterpart of ``ldagibbssampling_tpu`` (the JAX package, kept as the
reference).  This package imports neither jax nor the JAX package.  It runs
single-chain blocked collapsed Gibbs in the deferred kernel tier: a draw
kernel (``ops/fused_kernel.py``) that samples against a sweep-stale bf16
snapshot of the word-topic table, and a rebuild kernel
(``ops/count_kernel.py``) that recounts the tables once per sweep, both
hand-written CUDA (``csrc/``) built on first use.  Entry points run on
``cuda`` unless given ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.

Public symbols are re-exported lazily (importing the root pulls in nothing).
"""

from __future__ import annotations

import importlib
from typing import Any

__version__ = "0.2.0"

# symbol -> submodule that defines it (resolved lazily via PEP 562 __getattr__)
_EXPORTS = {
    "LdaConfig": "ldagibbssampling_tpu_torch.config",
    "Documents": "ldagibbssampling_tpu_torch.corpus.documents",
    "Document": "ldagibbssampling_tpu_torch.corpus.documents",
    "FlatCorpus": "ldagibbssampling_tpu_torch.corpus.flat",
    "SamplerState": "ldagibbssampling_tpu_torch.models.state",
    "LdaModel": "ldagibbssampling_tpu_torch.models.lda",
    "make_backend": "ldagibbssampling_tpu_torch.backends.base",
    "InferenceBackend": "ldagibbssampling_tpu_torch.backends.base",
    "run_inference": "ldagibbssampling_tpu_torch.runner",
    "write_minicorpus": "ldagibbssampling_tpu_torch.data",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str) -> Any:
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__() -> list[str]:
    return __all__
