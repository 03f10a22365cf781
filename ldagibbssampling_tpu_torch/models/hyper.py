"""Symmetric Dirichlet hyperparameter optimisation (Minka fixed point).

Counterpart of ``ldagibbssampling_tpu/models/hyper.py:26-57``.  The Java
reference has no hyperparameter learning (α and β are fixed knobs); these
are the standard Minka (2000) fixed-point updates on the collapsed count
tables, with digamma sums in float32 on the tables' device:

    α ← α · Σ_{m,k} [Ψ(ndk+α) − Ψ(α)] / (K · Σ_m [Ψ(N_m+Kα) − Ψ(Kα)])
    β ← β · Σ_{w,k} [Ψ(nwk+β) − Ψ(β)] / (V · Σ_k [Ψ(nk+Vβ) − Ψ(Vβ)])

Each runs ``iters`` steps (5 by default), clipped after each to
[1e-6, 1e3] (α) and [1e-8, 1e3] (β), as the reference does.

The sharded forms (reference ``:60-100``) take the mesh runtimes' per-position
tables (dicts keyed by position, ``parallel/runtime.py``) and reconcile the
shard-local digamma sums with ``parallel/multihost.psum`` over the named
axis; they return each position's new value (equal on every position).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.special import digamma


def optimize_alpha(ndk: torch.Tensor, doc_lengths: torch.Tensor, alpha,
                   iters: int = 5) -> torch.Tensor:
    """Minka fixed point for symmetric α given doc-topic counts [M, K];
    returns a 0-d float32 tensor on ``ndk``'s device."""
    k = ndk.shape[1]
    ndk = ndk.to(torch.float32)
    lengths = torch.as_tensor(doc_lengths, device=ndk.device).to(torch.float32)
    a = torch.tensor(float(alpha), dtype=torch.float32, device=ndk.device)
    for _ in range(iters):
        num = torch.sum(digamma(ndk + a) - digamma(a))
        den = k * torch.sum(digamma(lengths + k * a) - digamma(k * a))
        a = torch.clamp(a * num / torch.clamp(den, min=1e-30), 1e-6, 1e3)
    return a


def optimize_beta(nwk: torch.Tensor, nk: torch.Tensor, beta,
                  iters: int = 5) -> torch.Tensor:
    """Minka fixed point for symmetric β given word-topic counts [V, K];
    returns a 0-d float32 tensor on ``nwk``'s device."""
    v = nwk.shape[0]
    nwk = nwk.to(torch.float32)
    nk = nk.to(torch.float32)
    b = torch.tensor(float(beta), dtype=torch.float32, device=nwk.device)
    for _ in range(iters):
        num = torch.sum(digamma(nwk + b) - digamma(b))
        den = v * torch.sum(digamma(nk + v * b) - digamma(v * b))
        b = torch.clamp(b * num / torch.clamp(den, min=1e-30), 1e-8, 1e3)
    return b


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def sharded_alpha_update(ndk: Mapping[int, torch.Tensor],
                         doc_lengths: Mapping[int, torch.Tensor], alpha,
                         mesh, axis, iters: int = 5) -> dict[int, torch.Tensor]:
    """Minka α over document shards: ``ndk[p]`` / ``doc_lengths[p]`` are
    position ``p``'s documents (padding documents have length 0: they add
    Ψ(α)−Ψ(α) = 0 to the numerator and are masked out of the
    denominator); numerator and denominator are ``psum``'d over ``axis``."""
    from ldagibbssampling_tpu_torch.parallel.multihost import psum

    nd = {p: t.to(torch.float32) for p, t in ndk.items()}
    lengths = {p: doc_lengths[p].to(torch.float32) for p in ndk}
    k = next(iter(nd.values())).shape[1]
    a = {p: _scalar(alpha, t) for p, t in nd.items()}
    for _ in range(iters):
        num = psum({p: torch.sum(digamma(nd[p] + a[p]) - digamma(a[p]))
                    for p in nd}, mesh, axis)
        den = psum({p: torch.sum((lengths[p] > 0).to(torch.float32) * (
            digamma(lengths[p] + k * a[p]) - digamma(k * a[p]))) for p in nd},
            mesh, axis)
        a = {p: torch.clamp(a[p] * num[p] / torch.clamp(k * den[p], min=1e-30),
                            1e-6, 1e3) for p in nd}
    return a


def sharded_beta_update(nwk: Mapping[int, torch.Tensor],
                        nk: Mapping[int, torch.Tensor], beta, mesh, axis,
                        v_global: int, iters: int = 5) -> dict[int, torch.Tensor]:
    """Minka β over vocabulary slabs: ``nwk[p]`` is position ``p``'s
    ``[V_s, K]`` slab (zero padding rows add Ψ(β)−Ψ(β) = 0), ``nk[p]`` the
    replicated topic totals, so only the numerator is ``psum``'d over
    ``axis``; ``v_global`` is the whole vocabulary's size."""
    from ldagibbssampling_tpu_torch.parallel.multihost import psum

    nw = {p: t.to(torch.float32) for p, t in nwk.items()}
    tot = {p: nk[p].to(torch.float32) for p in nw}
    b = {p: _scalar(beta, t) for p, t in nw.items()}
    for _ in range(iters):
        num = psum({p: torch.sum(digamma(nw[p] + b[p]) - digamma(b[p]))
                    for p in nw}, mesh, axis)
        b = {p: torch.clamp(b[p] * num[p] / torch.clamp(
            v_global * torch.sum(digamma(tot[p] + v_global * b[p])
                                 - digamma(v_global * b[p])), min=1e-30),
            1e-8, 1e3) for p in nw}
    return b
