"""Symmetric Dirichlet hyperparameter optimisation (Minka fixed point).

Counterpart of ``ldagibbssampling_tpu/models/hyper.py:26-57``.  The Java
reference has no hyperparameter learning (α and β are fixed knobs); these
are the standard Minka (2000) fixed-point updates on the collapsed count
tables, with digamma sums in float32 on the tables' device:

    α ← α · Σ_{m,k} [Ψ(ndk+α) − Ψ(α)] / (K · Σ_m [Ψ(N_m+Kα) − Ψ(Kα)])
    β ← β · Σ_{w,k} [Ψ(nwk+β) − Ψ(β)] / (V · Σ_k [Ψ(nk+Vβ) − Ψ(Vβ)])

Each runs ``iters`` steps (5 by default), clipped after each to
[1e-6, 1e3] (α) and [1e-8, 1e3] (β), as the reference does.  The sharded
forms wait for the port's ``parallel/`` (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

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
