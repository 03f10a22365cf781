"""Inference backends behind one protocol (``InferenceBackend``), built by
``make_backend`` from ``config.backend``: Gibbs, CVB0, SVI, SMC, WarpLDA.
The backend classes are exported lazily, as ``models`` exports
``LdaModel``."""

from ldagibbssampling_tpu_torch.backends.base import InferenceBackend, make_backend

__all__ = ["InferenceBackend", "make_backend",
           "Cvb0Model", "SviModel", "SmcModel", "WarpModel"]

_LAZY = {
    "Cvb0Model": "ldagibbssampling_tpu_torch.backends.cvb0",
    "SviModel": "ldagibbssampling_tpu_torch.backends.svi",
    "SmcModel": "ldagibbssampling_tpu_torch.backends.smc",
    "WarpModel": "ldagibbssampling_tpu_torch.backends.warp",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
