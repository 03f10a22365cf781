"""Backend protocol + factory.

Counterpart of ``ldagibbssampling_tpu/backends/base.py``.  Every backend
exposes the same surface as the Gibbs ``LdaModel`` (sweep / phi / theta /
sweeps_done), so the runner and artifact writers are backend-agnostic:
Gibbs (one chain, several through ``models/chains.MultiChainModel``, or a
mesh runtime of ``parallel/``), CVB0, SVI, SMC and WarpLDA.  A mesh takes
its positions from ``parallel/multihost.local_devices`` (every CUDA device,
or one ``cpu``), as the reference takes them from ``jax.devices()``.
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


def _mesh_backend(config: "LdaConfig", corpus: "FlatCorpus",
                  device: Any) -> InferenceBackend:
    """Map ``config.mesh`` (axis -> size; -1 or 0 = what the other axes
    leave of every position) onto a runtime, as the reference's
    ``_mesh_backend`` (``backends/base.py:30-75``): ``{data}`` AD-LDA,
    ``{data, vocab}`` the grid, ``{token}`` token sharding, ``{chain,
    data}`` the chains × data mesh."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    spec = dict(config.mesh)
    devices, ranks = multihost.global_devices(device)
    n_dev = len(devices)
    for k, v in spec.items():
        if v in (-1, 0):
            others = int(np.prod([x for kk, x in spec.items() if kk != k and x > 0]) or 1)
            spec[k] = max(1, n_dev // others)
    axes = frozenset(spec)
    if axes == {"data"}:
        from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda

        return ShardedLda(config, corpus, num_shards=spec["data"], device=device)
    if axes == {"data", "vocab"}:
        from ldagibbssampling_tpu_torch.parallel.grid import GridLda

        pd, pv = spec["data"], spec["vocab"]
        if pd * pv > n_dev:  # the reference's reshape of too few devices fails
            raise ValueError(f"mesh data={pd},vocab={pv} needs {pd * pv} "
                             f"devices, have {n_dev}")
        mesh = multihost.Mesh(("data", "vocab"), (pd, pv),
                              tuple(devices[:pd * pv]), tuple(ranks[:pd * pv]))
        return GridLda(config, corpus, mesh=mesh, device=device)
    if axes == {"token"}:
        from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

        return TokenShardedLda(config, corpus, num_shards=spec["token"], device=device)
    if axes == {"chain", "data"}:
        from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainModel

        c = spec["chain"]
        if config.chains > 1 and config.chains != c:
            raise ValueError(f"--chains {config.chains} conflicts with mesh chain={c}")
        return ShardedChainModel(config, corpus, num_chains=c,
                                 num_shards=spec["data"], device=device)
    raise ValueError(
        f"unsupported mesh axes {sorted(spec)}; expected {{data}}, "
        "{data, vocab}, {token}, or {chain, data}")


def make_backend(config: "LdaConfig", corpus: "FlatCorpus",
                 device: Any = "cuda") -> InferenceBackend:
    """Construct the backend selected by ``config.backend`` on ``device``
    (``cuda`` by default; raises when CUDA is unavailable): for the blocked
    Gibbs sampler, the mesh runtime of ``config.mesh`` (unless ``chains >
    1`` without a chain axis) or, with ``chains > 1``, the multi-chain
    model."""
    if config.backend == "gibbs":
        if config.mesh and config.sampler == "blocked" and (
                config.chains == 1 or "chain" in config.mesh):
            return _mesh_backend(config, corpus, device)
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
