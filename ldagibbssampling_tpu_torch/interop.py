"""Carry sampler state between the JAX package and the port, as numpy arrays.

Tests use it so that both packages start from the same chain state: the
port cannot reproduce the reference's threefry initial draw.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ldagibbssampling_tpu_torch.models.state import SamplerState


def from_jax_state(arrays: Mapping[str, Any], device: Any = "cpu",
                   seed: int = 0) -> SamplerState:
    """``SamplerState`` from ``z/ndk/nwk/nk/sweep`` numpy arrays, e.g.
    ``{"z": np.asarray(jax_state.z), ...}``; ``seed`` is the chain seed."""
    def t(name):
        return torch.from_numpy(np.array(arrays[name], np.int32)).to(device)

    return SamplerState(z=t("z"), ndk=t("ndk"), nwk=t("nwk"), nk=t("nk"),
                        sweep=int(np.asarray(arrays["sweep"])), seed=int(seed))


def to_numpy(state: SamplerState) -> dict[str, np.ndarray]:
    """The reverse of ``from_jax_state``: host copies of the state's arrays."""
    out = {name: getattr(state, name).cpu().numpy()
           for name in ("z", "ndk", "nwk", "nk")}
    out["sweep"] = np.int32(state.sweep)
    return out
