"""Carry state between the JAX package and the port, as numpy arrays.

Tests use it so that both packages start from the same state: the port
cannot reproduce the reference's threefry draws.  Forms: one Gibbs chain
(``from_jax_state``), the stacked states of several chains, CVB0's
``(gamma, ndk, nwk, nk)``, SVI's λ and γ cache, SMC's
``(ndk, nwk, nk, z, logw)``, and the mesh runtimes' stacked tables
(``from_jax_mesh_state``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ldagibbssampling_tpu_torch.models.state import SamplerState


def from_jax_state(arrays: Mapping[str, Any], device: Any = "cuda",
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


def _tensor(x: Any, dtype: torch.dtype, device: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def from_jax_chain_states(arrays: Mapping[str, Any], device: Any = "cuda",
                          seeds: Any = None) -> list[SamplerState]:
    """Per-chain ``SamplerState``s from the reference ``ChainSet``'s stacked
    states (``z/ndk/nwk/nk/sweep`` with a leading chain axis); ``seeds[c]``
    is chain ``c``'s seed (default ``c``)."""
    num_chains = np.asarray(arrays["z"]).shape[0]
    sweeps = np.broadcast_to(np.asarray(arrays["sweep"]), (num_chains,))
    seeds = range(num_chains) if seeds is None else seeds
    return [from_jax_state({**{n: np.asarray(arrays[n])[c]
                               for n in ("z", "ndk", "nwk", "nk")},
                            "sweep": sweeps[c]}, device, seed)
            for c, seed in zip(range(num_chains), seeds)]


def from_jax_cvb0(arrays: Mapping[str, Any], device: Any = "cuda") -> dict:
    """CVB0's ``gamma/ndk/nwk/nk`` (float32) from the reference's."""
    return {n: _tensor(arrays[n], torch.float32, device)
            for n in ("gamma", "ndk", "nwk", "nk")}


def from_jax_svi(arrays: Mapping[str, Any], device: Any = "cuda"
                 ) -> tuple[torch.Tensor, np.ndarray]:
    """SVI's ``(lam, gamma_full)``: λ as a float32 tensor on ``device``,
    the per-document γ cache as a float32 host array (where SVI keeps it)."""
    return (_tensor(arrays["lam"], torch.float32, device),
            np.array(arrays["gamma_full"], np.float32))


def from_jax_smc(arrays: Mapping[str, Any], device: Any = "cuda") -> dict:
    """SMC's ``ndk/nwk/nk/z`` (int32) and ``logw`` (float32)."""
    out = {n: _tensor(arrays[n], torch.int32, device)
           for n in ("ndk", "nwk", "nk", "z")}
    out["logw"] = _tensor(arrays["logw"], torch.float32, device)
    return out


def from_jax_mesh_state(runtime, arrays: Mapping[str, Any]) -> None:
    """Load a reference mesh runtime's state into the port's runtime of the
    same mesh and layout: ``z/ndk/nwk/nk`` as the reference's stacked
    arrays (``ShardedLda``: ``z [P, T_s]``, ``ndk [P, M_s, K]``, ``nwk
    [V, K]``, ``nk [K]``; ``GridLda``: ``z [Pd, Pv, T_c]``, ``ndk
    [Pd, M_s, K]``, ``nwk [Pv, V_s, K]``; ``TokenShardedLda``: ``ndk
    [M, K]``; ``ShardedChainSet``: a leading chain axis on each) and
    ``sweep``, e.g. ``{n: np.asarray(getattr(ref, n)) ...}``."""
    runtime.load_arrays({n: np.array(arrays[n], np.int32)
                         for n in ("z", "ndk", "nwk", "nk")},
                        sweep=int(np.asarray(arrays.get("sweep", 0))))
