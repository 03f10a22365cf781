"""Backend protocol + factory.

Every backend exposes the same surface as the Gibbs ``LdaModel`` (sweep /
phi / theta / sweeps_done), so the driver and artifact writers are
backend-agnostic.  The port has one backend: Gibbs on a single device.
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
    """Construct the backend selected by ``config`` on ``device`` (``cuda``
    by default; raises when CUDA is unavailable).  ``LdaConfig`` itself
    rejects the backends, meshes and chain counts the port does not have."""
    if config.backend != "gibbs":
        raise NotImplementedError(
            f"backend {config.backend!r} is not ported (ROADMAP Queue 1 item 13)")
    from ldagibbssampling_tpu_torch.models.lda import LdaModel

    return LdaModel(config, corpus, device=device)
