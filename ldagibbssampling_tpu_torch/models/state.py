"""Sampler state: the sufficient statistics of collapsed-Gibbs LDA as tensors.

Counterpart of ``ldagibbssampling_tpu/models/state.py``.  Reference fields
(``LdaModel`` in ``src/liuyang/nlp/lda/main/LdaModel.java``): ``z[M][N_m]``
topic assignments, ``nmk[M][K]`` doc-topic counts, ``nkt[K][V]`` topic-word
counts, ``nktSum[K]`` topic totals.  Layout as in the JAX package: ``z`` is
flat over the padded token stream, ``nwk`` is word-major ``[V, K]``.

The JAX state carries a threefry key; this one carries ``seed``, the chain
seed from which the owner seeds its ``torch.Generator`` (the per-sweep kernel
seeds are drawn from that generator).  ``init_state`` draws the initial ``z``
from a ``torch.Generator``, which cannot reproduce the reference's threefry
draw, so it also accepts a given ``z`` (``interop.from_jax_state`` carries a
whole JAX state across).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SamplerState:
    """Collapsed-Gibbs sufficient statistics of one chain."""

    z: torch.Tensor     # int32 [T_pad] — topic of each token (padding: masked)
    ndk: torch.Tensor   # int32 [M, K]  — doc-topic counts   (reference nmk)
    nwk: torch.Tensor   # int32 [V, K]  — word-topic counts  (reference nkt, transposed)
    nk: torch.Tensor    # int32 [K]     — topic totals       (reference nktSum)
    sweep: int = 0      # completed sweeps
    seed: int = 0       # chain seed (seeds the owner's torch.Generator)

    @property
    def device(self) -> torch.device:
        return self.z.device


def init_state(
    token_word: Any,
    token_doc: Any,
    token_mask: Any,
    *,
    num_docs: int,
    vocab_size: int,
    num_topics: int,
    seed: int = 0,
    device: Any = "cuda",
    z: Optional[Any] = None,
) -> SamplerState:
    """Random topic init + count-table construction
    (``LdaModel.initializeModel``): each token gets a uniform random topic
    (or the given ``z``), then counts are accumulated over the unmasked
    tokens.  The chain seed is drawn from the same generator after ``z``."""
    gen = torch.Generator().manual_seed(int(seed))
    shape = (int(np.asarray(token_word).shape[0]),)
    if z is None:
        z = torch.randint(0, num_topics, shape, generator=gen, dtype=torch.int32)
    chain_seed = int(torch.randint(0, 2**62, (), generator=gen))

    def dev(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.int32)
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    z = dev(z)
    real = dev(token_mask) > 0
    zr = z[real].long()
    one = torch.ones_like(zr, dtype=torch.int32)
    ndk = torch.zeros((num_docs, num_topics), dtype=torch.int32, device=z.device)
    nwk = torch.zeros((vocab_size, num_topics), dtype=torch.int32, device=z.device)
    ndk.index_put_((dev(token_doc)[real].long(), zr), one, accumulate=True)
    nwk.index_put_((dev(token_word)[real].long(), zr), one, accumulate=True)
    nk = nwk.sum(dim=0, dtype=torch.int32)
    return SamplerState(z=z, ndk=ndk, nwk=nwk, nk=nk, sweep=0, seed=chain_seed)


def phi_theta(
    state: SamplerState,
    doc_lengths: Any,
    alpha: float,
    beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point estimates from current counts (``LdaModel.updateEstimatedParameters``).

    phi[k, t] = (nwk[t, k] + β) / (nk[k] + V·β)
    theta[m, k] = (ndk[m, k] + α) / (N_m + K·α)

    Returned in the reference's orientation: phi ``[K, V]``, theta ``[M, K]``.
    """
    v, k = state.nwk.shape
    f32 = torch.float32
    lengths = torch.as_tensor(np.asarray(doc_lengths), dtype=f32).to(state.device)
    beta_t = torch.tensor(beta, dtype=f32, device=state.device)
    alpha_t = torch.tensor(alpha, dtype=f32, device=state.device)
    phi = (state.nwk.T.to(f32) + beta_t) / (
        state.nk[:, None].to(f32) + torch.tensor(v * beta, dtype=f32,
                                                 device=state.device))
    theta = (state.ndk.to(f32) + alpha_t) / (
        lengths[:, None] + torch.tensor(k * alpha, dtype=f32,
                                        device=state.device))
    return phi, theta


def check_invariants(
    state: SamplerState,
    token_mask: Any,
    doc_lengths: Any,
) -> None:
    """Assert the count-table invariants: raises on violation.

    Σ_k ndk[m, k] == N_m;  Σ_t nwk[t, k] == nk[k];  Σ_k nk[k] == total tokens;
    all counts non-negative.
    """
    ndk = state.ndk.cpu().numpy()
    nwk = state.nwk.cpu().numpy()
    nk = state.nk.cpu().numpy()
    lengths = np.asarray(doc_lengths)
    mask = token_mask.cpu().numpy() if torch.is_tensor(token_mask) else token_mask
    total = int(np.asarray(mask).sum())
    if (ndk < 0).any() or (nwk < 0).any() or (nk < 0).any():
        raise AssertionError("negative counts")
    if not (ndk.sum(axis=1) == lengths).all():
        raise AssertionError("ndk row sums != doc lengths")
    if not (nwk.sum(axis=0) == nk).all():
        raise AssertionError("nwk column sums != nk")
    if int(nk.sum()) != total:
        raise AssertionError(f"nk total {int(nk.sum())} != token count {total}")
