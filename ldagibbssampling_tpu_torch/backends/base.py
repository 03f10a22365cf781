"""Backend protocol + factory.

Counterpart of ``ldagibbssampling_tpu/backends/base.py``.  Every backend
exposes the same surface as the Gibbs ``LdaModel`` (sweep / phi / theta /
sweeps_done), so the runner and artifact writers are backend-agnostic.
The port has every backend on a single device: Gibbs (one chain, or
several through ``models/chains.MultiChainModel``), CVB0, SVI, SMC and
WarpLDA.  The mesh runtimes wait for ROADMAP Queue 1 item 14, and
``LdaConfig`` rejects a mesh.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Protocol, runtime_checkable

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


@runtime_checkable
class InferenceBackend(Protocol):
    def sweep(self, n: int = 1) -> None: ...
    def phi(self) -> np.ndarray: ...
    def theta(self) -> np.ndarray: ...

    @property
    def sweeps_done(self) -> int: ...


def make_backend(config: "LdaConfig", corpus: "FlatCorpus",
                 device: Any = "cuda") -> InferenceBackend:
    """Construct the backend selected by ``config.backend`` on ``device``
    (``cuda`` by default; raises when CUDA is unavailable): for the blocked
    Gibbs sampler with ``chains > 1``, the multi-chain model."""
    if config.backend == "gibbs":
        if config.chains > 1 and config.sampler == "blocked":
            from ldagibbssampling_tpu_torch.models.chains import MultiChainModel

            return MultiChainModel(config, corpus, device=device)
        from ldagibbssampling_tpu_torch.models.lda import LdaModel

        return LdaModel(config, corpus, device=device)
    if config.backend == "cvb0":
        from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model

        return Cvb0Model(config, corpus, device=device)
    if config.backend == "svi":
        from ldagibbssampling_tpu_torch.backends.svi import SviModel

        return SviModel(config, corpus, device=device)
    if config.backend == "smc":
        from ldagibbssampling_tpu_torch.backends.smc import SmcModel

        return SmcModel(config, corpus, device=device)
    if config.backend == "warp":
        from ldagibbssampling_tpu_torch.backends.warp import WarpModel

        return WarpModel(config, corpus, device=device)
    raise ValueError(f"unknown backend {config.backend!r}")
