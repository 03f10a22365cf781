"""Device-side metrics: chunked log-likelihood and batched fold-in.

Counterpart of ``ldagibbssampling_tpu/evaluation/device_metrics.py:31-92``
and ``:118-211``.  The reference computes both in XLA, outside any Pallas
kernel, and so does the port, in PyTorch ops on the tables' device.

- :func:`device_log_likelihood` walks the token stream in fixed chunks,
  gathering each chunk's count rows and reducing the chunk to one float32
  partial sum; the host sees only the ``[num_chunks]`` partials and sums
  them in float64, so device memory stays O(chunk · K) and host memory
  O(T / chunk).
- :func:`fold_in_theta_batch` folds in many documents at once as blocked
  Gibbs with φ frozen, over a padded ``[D, L]`` token grid: one gather of
  the documents' ``[D, L, K]`` log φ, then ``n_sweeps`` Gumbel-max sweeps
  against ``ndk − onehot + α``.  The initial ``z`` and the Gumbel noise come
  from an explicit ``torch.Generator`` (the reference's threefry draws
  cannot be reproduced; tests inject them through ``draws``).
  :func:`heldout_perplexity_device` scores the documents' odd positions
  after folding in their even ones.

No reference analog in the Java code, which computes no metrics.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

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


def shard_ll_chunks(ndk, nwk, nk, tw, td, tm, dl, alpha, beta,
                    chunk_size: int = 1 << 19, vocab_size=None) -> torch.Tensor:
    """One shard's ``[n_chunks]`` float32 LL partials (reference
    ``:95-117``): its own token stream against its ``ndk`` rows and its
    (replicated or slab) ``nwk``, on the tables' device.  ``vocab_size``
    is the global V of ``V·β`` for a vocabulary slab."""
    chunk = int(min(chunk_size, max(tw.shape[0], 1)))
    return _ll_chunks(ndk, nwk, nk, tw, td, tm, dl, alpha, beta,
                      chunk_size=chunk, vocab_size=vocab_size)


def sum_ll_chunks(parts, mesh) -> float:
    """The mesh runtimes' LL: every position's partials (gathered from
    every process) summed on the host in float64, in position order."""
    from ldagibbssampling_tpu_torch.parallel.multihost import gather

    host = gather(parts, mesh)
    return float(np.concatenate(
        [host[p].astype(np.float64) for p in sorted(host)]).sum())


def _fold_in_batch(phi: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
                   alpha: float, *, n_sweeps: int,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[tuple] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(θ [D, K] float32, z [D, L] int32)`` after ``n_sweeps`` blocked
    fold-in sweeps of the ``[D, L]`` grid ``tokens`` (``mask`` > 0 marks real
    tokens) against the frozen ``phi [K, V]`` float32, all on ``phi``'s
    device.  ``draws = (z0 [D, L], gumbels)`` with ``gumbels[i]`` the
    ``[D, L, K]`` noise of sweep ``i`` replaces ``generator``'s draws."""
    d, l = tokens.shape
    k = phi.shape[0]
    f32 = torch.float32
    dev = phi.device
    alpha = torch.tensor(float(np.float32(alpha)), dtype=f32, device=dev)
    # one gather of the docs' phi columns: [D, L, K]
    phw = phi.T[tokens.reshape(-1).long()].reshape(d, l, k)
    phw = torch.where(mask.reshape(d, l, 1) > 0, phw, torch.ones_like(phw))
    logphw = torch.log(torch.clamp(phw, min=1e-30))
    maskf = mask.to(f32)[:, :, None]
    tiny = torch.finfo(f32).tiny

    if draws is not None:
        z0, gumbels = draws
        z = torch.from_numpy(np.array(z0, np.int32)).to(dev)
    else:
        z = torch.randint(0, k, (d, l), generator=generator, device=dev,
                          dtype=torch.int32)

    def onehot(z):
        return torch.nn.functional.one_hot(z.long(), k).to(f32) * maskf

    ndk = onehot(z).sum(dim=1)  # [D, K]
    for i in range(n_sweeps):
        logp = logphw + torch.log(
            torch.clamp(ndk[:, None, :] - onehot(z) + alpha, min=1e-30))
        if draws is not None:
            g = torch.from_numpy(np.array(gumbels[i], np.float32)).to(dev)
        else:
            u = torch.rand((d, l, k), generator=generator, device=dev, dtype=f32)
            g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        z_new = torch.argmax(logp + g, dim=-1).to(torch.int32)
        z = torch.where(mask > 0, z_new, z)
        ndk = onehot(z).sum(dim=1)
    n = maskf.sum(dim=(1, 2))
    return (ndk + alpha) / (n[:, None] + k * alpha), z


def fold_in_theta_batch(
    phi: Any,
    docs: list,
    alpha: float,
    n_sweeps: int = 20,
    seed: int = 0,
    doc_batch: int = 256,
    *,
    device: Any = "cuda",
    draws: Optional[Callable[[int, int, int, int], tuple]] = None,
) -> np.ndarray:
    """θ ``[len(docs), K]`` float64 for many new documents at once: blocked
    Gibbs with φ frozen, on ``device``.

    Documents go in groups of ``doc_batch`` (memory O(doc_batch · L · K));
    the group starting at document ``lo`` draws from a generator seeded with
    ``seed + lo`` (the reference: ``PRNGKey(seed + lo)``), or, where
    ``draws`` is given, takes ``draws(lo, D, L, K) -> (z0, gumbels)``.
    """
    from ldagibbssampling_tpu_torch.models.lda import resolve_device

    dev = resolve_device(device)
    phi_t = torch.as_tensor(np.asarray(phi, np.float32)).to(dev)
    k = phi_t.shape[0]
    out = np.empty((len(docs), k), np.float64)
    for lo in range(0, len(docs), doc_batch):
        group = docs[lo: lo + doc_batch]
        l = max(1, max((len(t) for t in group), default=1))
        toks = np.zeros((len(group), l), np.int32)
        mask = np.zeros((len(group), l), np.int32)
        for i, t in enumerate(group):
            toks[i, : len(t)] = t
            mask[i, : len(t)] = 1
        gen = None
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(seed + lo)
        theta, _ = _fold_in_batch(
            phi_t, torch.from_numpy(toks).to(dev), torch.from_numpy(mask).to(dev),
            alpha, n_sweeps=n_sweeps, generator=gen,
            draws=None if draws is None else draws(lo, len(group), l, k))
        out[lo: lo + len(group)] = theta.cpu().numpy().astype(np.float64)
    return out


def heldout_perplexity_device(
    phi: Any,
    heldout: Any,
    alpha: float,
    n_sweeps: int = 20,
    seed: int = 0,
    *,
    device: Any = "cuda",
    doc_batch: int = 256,
    draws: Optional[Callable[[int, int, int, int], tuple]] = None,
) -> float:
    """Doc-completion perplexity with batched fold-in on ``device``.

    Same estimator as ``metrics.heldout_perplexity`` (even positions observe,
    odd evaluate, on the ``FlatCorpus`` ``heldout``), but all documents fold
    in together; the evaluation half is scored on the host in float64.
    """
    obs = [heldout.doc_tokens(m)[0::2] for m in range(heldout.num_docs)]
    evs = [heldout.doc_tokens(m)[1::2] for m in range(heldout.num_docs)]
    theta = fold_in_theta_batch(phi, obs, alpha, n_sweeps, seed=seed,
                                doc_batch=doc_batch, device=device, draws=draws)
    phi64 = np.asarray(phi, np.float64)
    total_ll, total_tokens = 0.0, 0
    for m, ev in enumerate(evs):
        if len(ev) == 0:
            continue
        p = theta[m] @ phi64[:, ev]
        total_ll += float(np.log(np.maximum(p, 1e-300)).sum())
        total_tokens += len(ev)
    if total_tokens == 0:
        return float("nan")
    return float(np.exp(-total_ll / total_tokens))
