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

**One dispatch per ``GRAPH_STEPS`` tokens.**  The reference runs a chunk
as one ``jit`` of a ``lax.scan`` over tokens and takes the resample branch
with ``lax.cond`` inside it.  ``SmcModel.sweep`` runs the same chain as
replays of a CUDA graph of ``GRAPH_STEPS`` token steps
(``ops/graphs.StepGraph``; a chunk's remainder is a graph of its own
length, captured once per length), with no host read inside a chunk.  Its
step (``SmcGraph``) reads the token from device arrays at a device cursor,
its noise from a device ring of two noise blocks, and α, β, V·β and K·α
from a device tensor (``smc_scalars``), and does the eager step's
arithmetic op for op, so its chain is bitwise the eager ``smc_absorb``'s.
The ESS test stays on the device as a bool; the resample indices are drawn
every token (``[P, P]`` of work), and the gather runs only when the bool is
true, in two hand-written kernels that read it (``ops/smc_resample.py``):
a branch-free ``torch.where`` would move O(P·(M+V)·K) bytes every token.
The eager ``smc_absorb`` keeps host ints and one host read of the test per
token; it is the tests' reference.  The per-token sequential absorb is the
algorithm (each token's conditional depends on every earlier token's
assignment), so its cost is the per-token latency of the step; µs per token
on the H100, eager and captured, are in ``PERF.md``.

Memory against one 80 GB H100: the per-particle count tables are int32
``[P, M, K] + [P, V, K]``; at P = 16 that is 2.6 GB at M = 300k, V = 100k,
K = 100 (fits); 35 GB at M = 1M, V = 100k, K = 500; 534 GB at M = 8.2M, V = 140k,
K = 1,000 (does not fit).  ``z[P, T]`` adds 64 bytes per token at P = 16.
The captured absorb holds the state three times: the model's tensors, the
graph's buffers and the resample's scratch (7.8 GB at the first shape; the
second does not fit), where the eager absorb makes its gathered copy on
each resample.

Noise: each token takes ``[P, K]`` Gumbels for its draw and ``[P, P]``
Gumbels for a resample (``jax.random.categorical`` is the argmax of Gumbels
plus the logits).  Internally both are drawn in fixed blocks of
``NOISE_BLOCK`` tokens, block ``b`` of a pass from a device
``torch.Generator`` seeded with the pass's seed (drawn from the model's host
generator) plus ``b``, so the chain does not depend on ``chunk_size``;
externally ``smc_absorb`` takes them as arrays (the reference splits its key
once per token and once more inside a resample).  The captured absorb fills
each block once, outside the graph, into one slot of its ring; a replay
that needs the next block waits for its fill in stream order.

Checkpoint and resume are a documented non-goal, as in the reference: a
faithful resume would snapshot every particle's tables and the weights
mid-absorption.  The CLI refuses ``--checkpoint-every`` and ``--resume``
for this backend.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.ops._device import staged
from ldagibbssampling_tpu_torch.ops.graphs import StepGraph
from ldagibbssampling_tpu_torch.ops.smc_resample import (
    resample_gather, resample_write)


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
GRAPH_STEPS = 64    # token steps a replay of the captured absorb (<= NOISE_BLOCK)


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))`` in float32."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def smc_scalars(alpha: float, beta: float, vocab_size: int,
                num_topics: int) -> np.ndarray:
    """α, β, V·β and K·α as float32, as ``smc_absorb``'s ops round them:
    each a Python double (the products taken in doubles) rounded once.
    (``ops/_device.sweep_scalars`` multiplies float32 values instead, which
    can be one ulp away.)"""
    return np.array([alpha, beta, vocab_size * beta, num_topics * alpha],
                    np.float32)


class SmcGraph:
    """The absorb as replays of a captured step over static buffers.

    One step absorbs the token at the device cursor, as ``smc_absorb``'s
    loop body does, op for op, with device indices: the token's flat
    offsets into ``ndk``, ``nwk`` and ``nk``, the ±1 moves by
    ``scatter_add_`` at computed offsets (the decrement multiplied by the
    pass's ``dec`` ∈ {0, 1}, as the reference does), the noise rows at the
    cursor's place in the ring, the ESS test a device bool that gates the
    resample kernels.  :meth:`absorb` runs ``num_steps`` tokens as replays
    of ``GRAPH_STEPS`` steps and one of the remainder (``ops/graphs.
    StepGraph``), filling the noise blocks they reach first (``fill(b)``,
    which writes :meth:`noise_block`), and makes no host read.
    """

    def __init__(self, tables, token_word: np.ndarray, token_doc: np.ndarray,
                 ess_threshold: float) -> None:
        ndk, nwk, nk, z, logw = tables
        p, m, k = ndk.shape
        v, t = nwk.shape[1], z.shape[1]
        dev = ndk.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.state = [torch.empty_like(x) for x in tables]
        self.scratch = [torch.empty_like(x) for x in tables[:4]]
        self.flats = [x.view(-1) for x in self.state[:3]]
        self.zflat = self.state[3].view(-1)
        # per token: its document's and its word's row offsets (·K), and
        # nk's 0; per table and particle: the particle's first cell
        self.tok = torch.from_numpy(np.stack(
            [np.asarray(token_doc, np.int64) * k, np.asarray(token_word, np.int64) * k,
             np.zeros(t, np.int64)], axis=1)).to(dev)
        pid = torch.arange(p, **i64)
        self.cellbase = torch.stack([pid * (m * k), pid * (v * k), pid * k])
        self.rowbase = self.cellbase[:2, :, None] + torch.arange(k, **i64)
        self.zbase = pid * t
        self.threshold = ess_threshold * p
        # two noise blocks (one where the pass has one): a replay of at most
        # GRAPH_STEPS <= NOISE_BLOCK tokens reaches at most two
        self.ring = NOISE_BLOCK * (2 if t > NOISE_BLOCK else 1)
        self.gumbels = torch.zeros((self.ring, p, k), dtype=torch.float32, device=dev)
        self.resample_gumbels = torch.zeros((self.ring, p, p), dtype=torch.float32,
                                            device=dev)
        # the cursor and the float32 α, β, V·β, K·α (two words), one copy in
        self.params = torch.zeros(3, **i64)
        self.cursor = self.params[:1]
        self.scalars = self.params[1:].view(torch.float32)
        self.negdec = torch.zeros(p, dtype=torch.int32, device=dev)
        self.one = torch.ones(p, dtype=torch.int32, device=dev)
        self.resamples = torch.zeros(1, **i64)  # the gather counts them
        self.graph = StepGraph(self._step, self.state,
                               mutable=(self.cursor, self.resamples))

    def noise_block(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The ring's rows of noise block ``b`` (``[NOISE_BLOCK, P, K]`` and
        ``[NOISE_BLOCK, P, P]``): token ``b·NOISE_BLOCK + i`` reads row i."""
        lo = b * NOISE_BLOCK % self.ring
        return (self.gumbels[lo:lo + NOISE_BLOCK],
                self.resample_gumbels[lo:lo + NOISE_BLOCK])

    def _step(self) -> None:
        logw = self.state[4]
        t = self.cursor
        tk = self.tok.index_select(0, t).view(3, 1)
        zi = self.zbase + t
        old = self.zflat.index_select(0, zi)
        base = self.cellbase + tk                         # [3, P]
        for flat, cell in zip(self.flats, base + old):
            flat.scatter_add_(0, cell, self.negdec)
        rows = self.rowbase + tk[:2].view(2, 1, 1)        # [2, P, K]
        ndk_d = self.flats[0].take(rows[0])
        nwk_w = self.flats[1].take(rows[1])
        alpha, beta, vbeta, kalpha = self.scalars.unbind()

        cond = (nwk_w + beta) / (self.state[2] + vbeta) * (ndk_d + alpha)
        total = cond.sum(dim=1)
        nd_tot = ndk_d.sum(dim=1)
        row = torch.remainder(t, self.ring)
        g = self.gumbels.index_select(0, row)[0]
        znew = torch.argmax(torch.log(torch.clamp(cond, min=1e-30)) + g, dim=1)
        for flat, cell in zip(self.flats, base + znew):
            flat.scatter_add_(0, cell, self.one)
        self.zflat.index_copy_(0, zi, znew.to(torch.int32))
        logw.add_(torch.log(torch.clamp(total / (nd_tot + kalpha), min=1e-300)))

        wnorm = torch.softmax(logw, dim=0)
        ess = 1.0 / torch.clamp(torch.sum(wnorm * wnorm), min=1e-30)
        flag = ess < self.threshold
        rg = self.resample_gumbels.index_select(0, row)[0]
        idx = torch.argmax(rg + logw[None, :], dim=1)
        logw.masked_fill_(flag, 0.0)
        resample_gather(flag, idx, self.state[:4], self.scratch, self.resamples)
        resample_write(flag, self.scratch, self.state[:4])
        t.add_(1)

    def absorb(self, tables, first_pass: bool, t_offset: int, num_steps: int,
               fill: Callable[[int], None], *, alpha: float, beta: float) -> tuple:
        """Absorb ``num_steps`` tokens from ``t_offset``, as ``smc_absorb``;
        returns new ``(ndk, nwk, nk, z, logw)``.  ``fill(b)`` is called
        before the first replay that reaches noise block ``b``."""
        self.graph.load(tables)
        _, v, k = self.state[1].shape
        words = smc_scalars(alpha, beta, v, k).view(np.int64)
        params = np.concatenate([[t_offset], words]).astype(np.int64)
        self.params.copy_(staged(params, self.params.device), non_blocking=True)
        self.negdec.fill_(0 if first_pass else -1)
        pos, end = t_offset, t_offset + num_steps
        while pos < end:
            n = min(GRAPH_STEPS, end - pos)
            for b in range(pos // NOISE_BLOCK, (pos + n - 1) // NOISE_BLOCK + 1):
                fill(b)
            self.graph.run(n)
            pos += n
        return self.graph.result()


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
        self.graph = SmcGraph(self._tables(), self._tw, self._td, ess_threshold)

    def _tables(self) -> tuple:
        return self.ndk, self.nwk, self.nk, self.z, self.logw

    @property
    def resamples(self) -> int:
        """Resamples in the last (or the running) pass: a host read."""
        return int(self.graph.resamples)

    def _block(self, pass_seed: int, b: int) -> tuple:
        """Internal noise block ``b`` of a pass: ``(gumbels [NOISE_BLOCK, P,
        K], resample_gumbels [NOISE_BLOCK, P, P])`` from its own generator."""
        gen = torch.Generator(device=self.device).manual_seed((pass_seed + b) % (2**63))
        p, k = self.num_particles, self.config.topic_num
        return (gumbel_noise((NOISE_BLOCK, p, k), gen, self.device),
                gumbel_noise((NOISE_BLOCK, p, p), gen, self.device))

    def _noise(self, pass_seed: int, pos: int, c: int) -> tuple:
        """Internal ``(gumbels [c, P, K], resample_gumbels [c, P, P])`` of
        tokens ``pos .. pos + c`` of a pass, from the pass's noise blocks:
        what the eager ``smc_absorb`` takes."""
        parts = []
        for b in range(pos // NOISE_BLOCK, (pos + c - 1) // NOISE_BLOCK + 1):
            lo = max(pos - b * NOISE_BLOCK, 0)
            hi = min(pos + c - b * NOISE_BLOCK, NOISE_BLOCK)
            parts.append([x[lo:hi] for x in self._block(pass_seed, b)])
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
            self.graph.resamples.zero_()
            filled: set = set()  # the noise blocks in the ring
            pos = 0
            while pos < t_total:
                c = min(self.chunk_size, t_total - pos)
                if noise is None:
                    fill = functools.partial(self._fill_block, filled, pass_seed)
                else:
                    filled = set()  # the chunk's own noise
                    fill = functools.partial(self._fill_chunk, filled, pos, tuple(
                        x.to(self.device, torch.float32) for x in noise(pos, c)))
                (self.ndk, self.nwk, self.nk, self.z, self.logw) = self.graph.absorb(
                    self._tables(), first, pos, c, fill,
                    alpha=self.config.alpha, beta=self.config.beta)
                pos += c
            self._sweeps += 1

    def _fill_block(self, filled: set, pass_seed: int, b: int) -> None:
        """Internal noise block ``b`` of a pass into the ring, once."""
        if b in filled:
            return
        for dst, src in zip(self.graph.noise_block(b), self._block(pass_seed, b)):
            dst.copy_(src)
        filled.add(b)

    def _fill_chunk(self, filled: set, pos: int, chunk: tuple, b: int) -> None:
        """The rows of noise block ``b`` that the chunk from ``pos`` covers,
        from its external ``(gumbels, resample_gumbels)``, once."""
        if b in filled:
            return
        lo = max(pos, b * NOISE_BLOCK)
        hi = min(pos + chunk[0].shape[0], (b + 1) * NOISE_BLOCK)
        for dst, src in zip(self.graph.noise_block(b), chunk):
            dst[lo - b * NOISE_BLOCK:hi - b * NOISE_BLOCK].copy_(src[lo - pos:hi - pos])
        filled.add(b)

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
