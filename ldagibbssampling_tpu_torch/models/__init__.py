"""Model layer: sampler state and the LDA model (reference: ``main/LdaModel.java``)."""

from ldagibbssampling_tpu_torch.models.state import SamplerState, init_state

__all__ = ["SamplerState", "init_state"]


def __getattr__(name):  # lazy, as in the JAX package
    if name == "LdaModel":
        from ldagibbssampling_tpu_torch.models.lda import LdaModel

        return LdaModel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
