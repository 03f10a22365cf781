"""SMC: sequential Monte Carlo (particle-filter) LDA.

Counterpart of ``ldagibbssampling_tpu/backends/smc.py``; no analog in the
Java code.  The single-pass particle filter of Canini et al. (2009): P
particles each carry their own count tables; tokens are absorbed one at a
time — each particle draws ``z_t`` from its own collapsed conditional, its
log-weight gains the log predictive probability of the token, and the
particles are resampled (multinomial) exactly when the effective sample size
falls below ``ess_threshold·P``.  ``sweep()`` is one full absorb pass over
the corpus; passes after the first remove each token's previous topic
first (a rejuvenation pass).

**The ESS branch.**  The reference takes the resample branch with
``lax.cond`` inside its scan.  Eager PyTorch has no device-side branch: a
branch-free ``torch.where`` over an index vector would gather every table
for every token, O(P·(M+V)·K) bytes per token.  Here each token's step is a
few dozen small PyTorch ops on ``[P, K]`` views of the tables (the document's
and the word's rows, so no table is copied), and one host read of the
ESS test decides the branch: one device-to-host sync per token, and the
resample copies the tables only when it happens.  The chain is the
reference's: resample exactly when ``ess < ess_threshold·P``.  The per-token
sequential absorb is the algorithm (each token's conditional depends on
every earlier token's assignment), so its cost is the per-token latency of
that step; tokens/s and µs per token on the H100 are in ``PERF.md``.

Memory against one 80 GB H100: the per-particle count tables are int32
``[P, M, K] + [P, V, K]``; at P = 16 that is 2.6 GB at M = 300k, V = 100k,
K = 100 (fits); 35 GB at M = 1M, V = 100k, K = 500 (fits, and a resample's
gathered copy doubles it to 70 GB); 534 GB at M = 8.2M, V = 140k, K = 1,000
(does not fit).  ``z[P, T]`` adds 64 bytes per token at P = 16.

Noise: each token takes ``[P, K]`` Gumbels for its draw and ``[P, P]``
Gumbels for a resample (``jax.random.categorical`` is the argmax of Gumbels
plus the logits).  Internally both are drawn in fixed blocks of
``NOISE_BLOCK`` tokens, block ``b`` of a pass from a device
``torch.Generator`` seeded with the pass's seed (drawn from the model's host
generator) plus ``b``, so the chain does not depend on ``chunk_size``;
externally ``smc_absorb`` takes them as arrays (the reference splits its key
once per token and once more inside a resample).

Checkpoint and resume are a documented non-goal, as in the reference: a
faithful resume would snapshot every particle's tables and the weights
mid-absorption.  The CLI refuses ``--checkpoint-every`` and ``--resume``
for this backend.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus


def smc_absorb(
    ndk: torch.Tensor,        # [P, M, K] int32 per-particle doc-topic counts
    nwk: torch.Tensor,        # [P, V, K] int32
    nk: torch.Tensor,         # [P, K] int32
    z: torch.Tensor,          # [P, T] int32 assignments
    logw: torch.Tensor,       # [P] float32 log-weights
    token_word: np.ndarray,   # [T] host ints
    token_doc: np.ndarray,    # [T] host ints
    first_pass: bool,         # False: remove each token's previous topic first
    t_offset: int,            # absolute index of the chunk's first token
    *,
    alpha: float,
    beta: float,
    ess_threshold: float,
    num_steps: int,
    gumbels: torch.Tensor,           # [num_steps, P, K] draw noise
    resample_gumbels: torch.Tensor,  # [num_steps, P, P] resample noise
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorb ``num_steps`` tokens from ``t_offset``; returns
    ``(ndk, nwk, nk, z, logw)``.  The tables are updated in place until a
    resample, which replaces them with gathered copies: use the returned
    tensors.  The carry crosses chunks exactly, so chunks of any size give
    one chain."""
    p, _, k = ndk.shape
    v = nwk.shape[1]
    # V·β and K·α as the reference's static Python floats form them; each
    # op that reads one rounds it to float32
    vbeta = v * beta
    kalpha = k * alpha
    one = torch.ones((p, 1), dtype=ndk.dtype, device=ndk.device)
    threshold = ess_threshold * p
    for i in range(num_steps):
        t = t_offset + i
        w, d = int(token_word[t]), int(token_doc[t])
        ndk_d = ndk[:, d, :]                            # [P, K] views
        nwk_w = nwk[:, w, :]
        if not first_pass:
            old = z[:, t].long()[:, None]
            for rows in (ndk_d, nwk_w, nk):
                rows.scatter_add_(1, old, -one)

        cond = (nwk_w + beta) / (nk + vbeta) * (ndk_d + alpha)  # [P, K] float32
        total = cond.sum(dim=1)              # predictive (unnorm by N_d+Kα)
        nd_tot = ndk_d.sum(dim=1)            # post-decrement doc total
        znew = torch.argmax(torch.log(torch.clamp(cond, min=1e-30)) + gumbels[i],
                            dim=1)
        for rows in (ndk_d, nwk_w, nk):
            rows.scatter_add_(1, znew[:, None], one)
        z[:, t] = znew.to(z.dtype)
        logw = logw + torch.log(torch.clamp(total / (nd_tot + kalpha), min=1e-300))

        # resample on ESS collapse: the one host read of the step
        wnorm = torch.softmax(logw, dim=0)
        ess = 1.0 / torch.clamp(torch.sum(wnorm * wnorm), min=1e-30)
        if bool(ess < threshold):
            idx = torch.argmax(resample_gumbels[i] + logw[None, :], dim=1)
            ndk, nwk, nk, z = ndk[idx], nwk[idx], nk[idx], z[idx]
            logw = torch.zeros_like(logw)
    return ndk, nwk, nk, z, logw


NOISE_BLOCK = 4096  # tokens per block of internal noise


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))`` in float32."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class SmcModel:
    """Particle-filter backend (small corpora; particles on a leading axis)."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 num_particles: int = 16, ess_threshold: float = 0.5,
                 chunk_size: int = 32_768, *, device: Any = "cuda") -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.num_particles = num_particles
        self.ess_threshold = ess_threshold
        self.chunk_size = max(1, chunk_size)
        self.doc_lengths = corpus.doc_lengths()

        p, m, v, k = num_particles, corpus.num_docs, corpus.vocab_size, config.topic_num
        t = corpus.num_tokens
        dev = self.device
        self.ndk = torch.zeros((p, m, k), dtype=torch.int32, device=dev)
        self.nwk = torch.zeros((p, v, k), dtype=torch.int32, device=dev)
        self.nk = torch.zeros((p, k), dtype=torch.int32, device=dev)
        self.z = torch.zeros((p, t), dtype=torch.int32, device=dev)
        self.logw = torch.zeros(p, dtype=torch.float32, device=dev)
        self.generator = torch.Generator().manual_seed(int(config.seed))
        self._tw = np.asarray(corpus.token_word)
        self._td = np.asarray(corpus.token_doc)
        self._sweeps = 0

    def _noise(self, pass_seed: int, pos: int, c: int) -> tuple:
        """Internal ``(gumbels [c, P, K], resample_gumbels [c, P, P])`` of
        tokens ``pos .. pos + c`` of a pass, from the pass's noise blocks."""
        p, k = self.num_particles, self.config.topic_num
        parts = []
        for b in range(pos // NOISE_BLOCK, (pos + c - 1) // NOISE_BLOCK + 1):
            gen = torch.Generator(device=self.device).manual_seed(
                (pass_seed + b) % (2**63))
            n = NOISE_BLOCK
            g = gumbel_noise((n, p, k), gen, self.device)
            rg = gumbel_noise((n, p, p), gen, self.device)
            lo = max(pos - b * n, 0)
            hi = min(pos + c - b * n, n)
            parts.append((g[lo:hi], rg[lo:hi]))
        return (torch.cat([g for g, _ in parts]),
                torch.cat([rg for _, rg in parts]))

    def sweep(self, n: int = 1,
              noise: Optional[Callable[[int, int], tuple]] = None) -> None:
        """Absorb (first call) or re-absorb (rejuvenate) the whole token
        stream, in chunks of ``chunk_size`` tokens; the chain does not
        depend on the chunk size.  ``noise(pos, steps)`` gives a chunk's
        ``(gumbels, resample_gumbels)`` (default: the model's own)."""
        t_total = int(self._tw.shape[0])
        for _ in range(n):
            first = self._sweeps == 0
            pass_seed = int(torch.randint(0, 2**63 - 1, (), generator=self.generator))
            pos = 0
            while pos < t_total:
                c = min(self.chunk_size, t_total - pos)
                if noise is None:
                    g, rg = self._noise(pass_seed, pos, c)
                else:
                    g, rg = (x.to(self.device, torch.float32) for x in noise(pos, c))
                (self.ndk, self.nwk, self.nk, self.z, self.logw) = smc_absorb(
                    self.ndk, self.nwk, self.nk, self.z, self.logw,
                    self._tw, self._td, first, pos,
                    alpha=self.config.alpha, beta=self.config.beta,
                    ess_threshold=self.ess_threshold, num_steps=c,
                    gumbels=g, resample_gumbels=rg)
                pos += c
            self._sweeps += 1

    @property
    def sweeps_done(self) -> int:
        return self._sweeps

    # ------------------------------------------------------------------
    def _weights(self) -> np.ndarray:
        return torch.softmax(self.logw, dim=0).cpu().numpy().astype(np.float64)

    def phi(self) -> np.ndarray:
        wts = self._weights()[:, None, None]
        nwk = self.nwk.cpu().numpy().astype(np.float64)
        nk = self.nk.cpu().numpy().astype(np.float64)[:, None, :]
        v = nwk.shape[1]
        per_particle = (nwk + self.config.beta) / (nk + v * self.config.beta)
        return np.swapaxes((wts * per_particle).sum(axis=0), 0, 1)

    def theta(self) -> np.ndarray:
        wts = self._weights()[:, None, None]
        ndk = self.ndk.cpu().numpy().astype(np.float64)
        k = ndk.shape[2]
        per_particle = (ndk + self.config.alpha) / (
            self.doc_lengths[None, :, None] + k * self.config.alpha)
        return (wts * per_particle).sum(axis=0)
