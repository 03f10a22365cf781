"""Model layer: sampler state, the LDA model and the multi-chain set
(reference: ``main/LdaModel.java``)."""

from ldagibbssampling_tpu_torch.models.oracle import OracleSampler
from ldagibbssampling_tpu_torch.models.state import SamplerState, init_state

__all__ = ["OracleSampler", "SamplerState", "init_state"]

_LAZY = {
    "LdaModel": "ldagibbssampling_tpu_torch.models.lda",
    "ChainSet": "ldagibbssampling_tpu_torch.models.chains",
    "MultiChainModel": "ldagibbssampling_tpu_torch.models.chains",
}


def __getattr__(name):  # lazy, as in the JAX package
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
