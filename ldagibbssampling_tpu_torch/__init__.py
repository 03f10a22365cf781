"""PyTorch/CUDA port of the LDA collapsed-Gibbs engine, for NVIDIA Hopper.

Counterpart of ``ldagibbssampling_tpu`` (the JAX package, kept as the
reference).  This package imports neither jax nor the JAX package.  It runs
single-chain collapsed Gibbs in the reference's four kernel tiers
(``ops/gibbs.py``: XLA, v1 draw, fused, deferred), chosen as the reference
chooses them for the config and corpus (``models/lda.resolve_tier``), and
the serial Java-fidelity oracle (``models/oracle.py``).  The kernels are
hand-written CUDA (``csrc/``) built on first use: K1, the per-tile draw and
count update (``ops/fused_kernel.py``), K2, the count rebuild
(``ops/count_kernel.py``), and K3, the per-block draw
(``ops/sample_kernel.py``).  The parallel runtimes (``parallel/``: AD-LDA,
the document × vocabulary grid, token sharding, chains × data) run the
same kernels per shard over a mesh of device positions, with
``torch.distributed`` across processes.  Corpora are read by a native C++
ingest (``corpus/native.py``, ``csrc/ldacorpus.cc``, built by ``g++`` at
first use) where they are ASCII, by the Python pipeline otherwise.  Entry points run on ``cuda`` unless given
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

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
    "OracleSampler": "ldagibbssampling_tpu_torch.models.oracle",
    "JavaRandom": "ldagibbssampling_tpu_torch.utils.javarandom",
    "ChainSet": "ldagibbssampling_tpu_torch.models.chains",
    "MultiChainModel": "ldagibbssampling_tpu_torch.models.chains",
    "ShardedLda": "ldagibbssampling_tpu_torch.parallel.adlda",
    "GridLda": "ldagibbssampling_tpu_torch.parallel.grid",
    "TokenShardedLda": "ldagibbssampling_tpu_torch.parallel.tokenshard",
    "make_backend": "ldagibbssampling_tpu_torch.backends.base",
    "InferenceBackend": "ldagibbssampling_tpu_torch.backends.base",
    "run_inference": "ldagibbssampling_tpu_torch.runner",
    "WarpModel": "ldagibbssampling_tpu_torch.backends.warp",
    "read_docs_flat": "ldagibbssampling_tpu_torch.corpus.native",
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
