"""Device-side metrics: the chunked training log-likelihood.

Counterpart of ``ldagibbssampling_tpu/evaluation/device_metrics.py:31-92``.
:func:`device_log_likelihood` walks the token stream in fixed chunks on the
count tables' device, gathering each chunk's count rows and reducing the
chunk to one float32 partial sum; the host sees only the ``[num_chunks]``
partials and sums them in float64, so device memory stays O(chunk · K) and
host memory O(T / chunk).  The reference computes this in XLA, outside any
Pallas kernel, and so does the port, in PyTorch gathers and sums.

The batched fold-in and the held-out perplexity (the reference's :118-211)
are not ported yet (ROADMAP Queue 1 item 9, with ``--infer-docs``).
No reference analog in the Java code, which computes no metrics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _ll_chunks(ndk, nwk, nk, tw, td, tm, dl, alpha, beta, *, chunk_size: int,
               vocab_size: Optional[int] = None) -> torch.Tensor:
    """``[n_chunks]`` float32 partial sums of ``log Σ_k φ[k, w] θ[d, k]``
    over the unmasked tokens of each chunk of ``chunk_size``."""
    t = tw.shape[0]
    k = ndk.shape[1]
    # vocab_size overrides V for the V·β smoothing mass
    v = nwk.shape[0] if vocab_size is None else vocab_size
    f32 = torch.float32
    dev = ndk.device
    alpha32 = np.float32(alpha)
    beta32 = np.float32(beta)
    # V·β and K·α in float32, as the reference forms them from its f32 α, β
    vbeta = torch.tensor(float(np.float32(v) * beta32), dtype=f32, device=dev)
    kalpha = torch.tensor(float(np.float32(k) * alpha32), dtype=f32, device=dev)
    alpha_t = torch.tensor(float(alpha32), dtype=f32, device=dev)
    beta_t = torch.tensor(float(beta32), dtype=f32, device=dev)
    nkf = nk.to(f32) + vbeta                                          # [K]
    dlf = dl.to(f32)
    n_chunks = -(-t // chunk_size)
    out = torch.empty(n_chunks, dtype=f32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk_size, (i + 1) * chunk_size)
        w, d, m = tw[sl].long(), td[sl].long(), tm[sl]
        phi_rows = (nwk[w].to(f32) + beta_t) / nkf                   # [C, K]
        theta_rows = (ndk[d].to(f32) + alpha_t) / (dlf[d] + kalpha)[:, None]
        p = torch.sum(phi_rows * theta_rows, dim=-1)
        logs = torch.log(torch.clamp(p, min=1e-30))
        out[i] = torch.sum(torch.where(m > 0, logs, torch.zeros_like(logs)))
    return out


def device_log_likelihood(
    ndk, nwk, nk,
    token_word, token_doc, token_mask, doc_lengths,
    alpha: float, beta: float,
    chunk_size: int = 1 << 19,
) -> float:
    """Token log-likelihood from the count tables, chunked on their device.

    The same quantity as ``metrics.log_likelihood`` of the point estimates
    φ = (nwk+β)/(nk+Vβ), θ = (ndk+α)/(N+Kα).  Every array may be a tensor
    or a numpy array; all go to ``ndk``'s device (the CPU for numpy).
    """
    dev = ndk.device if torch.is_tensor(ndk) else torch.device("cpu")

    def on_dev(x):
        return torch.as_tensor(x, device=dev)

    tw, td, tm, dl = (on_dev(x) for x in (token_word, token_doc, token_mask,
                                          doc_lengths))
    t = tw.shape[0]
    chunk_size = min(chunk_size, max(t, 1))
    chunks = _ll_chunks(on_dev(ndk), on_dev(nwk), on_dev(nk), tw, td, tm, dl,
                        alpha, beta, chunk_size=int(chunk_size))
    return float(chunks.cpu().numpy().astype(np.float64).sum())
