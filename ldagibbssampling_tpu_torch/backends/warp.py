"""WarpLDA-style Metropolis–Hastings LDA: O(1) work per token.

Counterpart of ``ldagibbssampling_tpu/backends/warp.py``; no analog in the
Java code, whose only sampler is the O(K)-per-token collapsed Gibbs loop
(``LdaModel.sampleTopicZ``).  Chen, Li & Zhu, "WarpLDA: a Cache Efficient
O(1) Algorithm for Latent Dirichlet Allocation" (VLDB 2016): the exact O(K)
draw is replaced by two cheap Metropolis–Hastings proposals per token per
sweep,

- **doc proposal**:  k' ~ q_d(k) = (ndk[d,k] + α) / (N_d + Kα), drawn in O(1)
  by picking a uniformly random token of the *same document* and reusing its
  current topic (mixed with a uniform draw for the +α mass);
- **word proposal**: k' ~ q_w(k) = (nwk[w,k] + β) / (n_w + Kβ), drawn the same
  way over the word's token positions (word-major CSR, :func:`word_csr`);

each accepted with the exact MH ratio against the collapsed conditional
π(k) ∝ (ndk−e+α)(nwk−e+β)/(nk−e+Vβ).  The count tables are **frozen within a
sweep** (WarpLDA's delayed update) and reconciled at the sweep's end: −1 at
each moved token's old topic and +1 at its new one, int32 scatter-adds,
which are exact and give the same tables in any order of additions.

Chain semantics: an approximate MH chain (frozen-count proposals, parallel
moves); per sweep it mixes more slowly than exact Gibbs.  Each sweep draws
``u[8, T_pad]`` uniforms: internally from a device ``torch.Generator``
seeded with a seed from the chain's host generator, or externally from
``noise(sweep)`` (the reference draws them from ``fold_in(state.key,
sweep)``).  Its speed on the H100 is in ``PERF.md``.

**One dispatch per sweep.**  The reference runs ``n`` sweeps as one
``jit`` of a ``fori_loop`` over sweeps (``_warp_sweeps``).
``WarpModel.sweep`` replays one CUDA graph of a sweep per sweep
(``ops/graphs.SweepGraph``) over static buffers ``z``, ``ndk``, ``nwk`` and
``nk``; its body is :func:`_warp_sweep_`, in place, which the eager
:func:`_warp_sweep` also runs (on copies), so a replay is bitwise the eager
sweep.  Internal noise draws from the graph's one registered device
generator, reseeded with the sweep's seed before each replay (the draws of
a fresh generator with that seed); external noise is copied into the
graph's noise buffer before each replay.  No host sync inside a sweep.

Checkpoint and resume are a documented non-goal of this backend, as in the
reference: it is an algorithmic reference, and long runs belong on the
Gibbs tiers, which checkpoint.  The CLI refuses ``--checkpoint-every`` and
``--resume`` for it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import count, span
from ldagibbssampling_tpu_torch.models.state import SamplerState, init_state
from ldagibbssampling_tpu_torch.ops.gibbs import _scatter_counts, sweep_seed
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph


def word_csr(token_word: torch.Tensor, vocab_size: int, mask: torch.Tensor):
    """Word-major CSR over the token stream on its device:
    ``(perm_w [T] int64, word_ptr [V+1] int64)``.

    ``perm_w`` lists token indices sorted by word id (stable, padding last);
    the word proposal draws a uniform position inside a word's range and reuses
    ``z[perm_w[j]]``.  A stable order is unique, so ``perm_w`` is numpy's
    ``argsort(kind="stable")`` of the same keys.  ``word_ptr[w]`` is the number
    of real tokens with a word below ``w``, found in the sorted keys.
    """
    # order real tokens by word; padding tokens sort after every real word
    sort_key = torch.where(mask > 0, token_word, vocab_size)
    sorted_key, perm_w = torch.sort(sort_key, stable=True)
    del sort_key
    words = torch.arange(vocab_size + 1, dtype=sorted_key.dtype,
                         device=sorted_key.device)
    return perm_w, torch.searchsorted(sorted_key, words)


def _warp_sweep_(
    z: torch.Tensor,           # [T_pad] int32 assignments
    ndk: torch.Tensor,         # [M, K] int32
    nwk: torch.Tensor,         # [V, K] int32
    nk: torch.Tensor,          # [K] int32
    u: torch.Tensor,           # [8, T_pad] float32 uniforms of this sweep
    token_word: torch.Tensor,  # [T_pad] int64 (doc-major)
    token_doc: torch.Tensor,   # [T_pad] int64
    token_mask: torch.Tensor,  # [T_pad] int32
    doc_start: torch.Tensor,   # [T_pad] int64: the token's document's first slot
    word_start: torch.Tensor,  # [T_pad] int64: the token's word's first CSR slot
    nd_tok: torch.Tensor,      # [T_pad] float32: N_d of the token's document
    nw_tok: torch.Tensor,      # [T_pad] float32: n_w of the token's word
    perm_w: torch.Tensor,      # [T_pad] int64
    alpha: float,
    beta: float,
) -> None:
    """One WarpLDA sweep in place on ``z``, ``ndk``, ``nwk`` and ``nk``
    (the captured sweep's body): both MH moves against the frozen tables,
    then the reconciliation.  ``z`` is written last: the word proposal
    reads the frozen ``z``, the reconciliation both."""
    z_buf = z
    z = z.long()
    t_pad = z.shape[0]
    v, k = nwk.shape
    f32 = np.float32
    # the reference's float32 scalars (its α and β are float32 arrays)
    alpha_f, beta_f = float(f32(alpha)), float(f32(beta))
    vbeta = float(f32(v) * f32(beta))
    kalpha = float(f32(k) * f32(alpha))
    kbeta = float(f32(k) * f32(beta))
    kf = float(k)
    msk = token_mask > 0
    d, w = token_doc, token_word

    def cnt(table, *index):
        return table[index].to(torch.float32)

    def pi_ratio(kcur, kprop):
        """π(k')/π(k) with self-exclusion against the frozen tables."""
        e_p = (kprop == kcur).to(torch.float32)
        num = ((cnt(ndk, d, kprop) - e_p + alpha_f)
               * (cnt(nwk, w, kprop) - e_p + beta_f)
               * (cnt(nk, kcur) - 1.0 + vbeta))
        den = ((cnt(ndk, d, kcur) - 1.0 + alpha_f)
               * (cnt(nwk, w, kcur) - 1.0 + beta_f)
               * (cnt(nk, kprop) - e_p + vbeta))
        return num / den

    def topic(x):
        return torch.floor(x).to(torch.int64)

    # ---- doc proposal: q_d(k) = (ndk_frozen + α) / (N_d + Kα) ----
    zcur = z
    p_emp = nd_tok / (nd_tok + kalpha)
    j = doc_start + topic(u[1] * nd_tok)
    k_emp = z[torch.clamp(j, 0, t_pad - 1)]
    k_unif = topic(u[2] * kf)
    kprop = torch.where(u[0] < p_emp, k_emp, k_unif)
    ratio = pi_ratio(zcur, kprop) * (
        (cnt(ndk, d, zcur) + alpha_f) / (cnt(ndk, d, kprop) + alpha_f))
    znew = torch.where((u[3] < ratio) & msk, kprop, zcur)

    # ---- word proposal: q_w(k) = (nwk_frozen + β) / (n_w + Kβ) ----
    zcur = znew
    p_emp = nw_tok / (nw_tok + kbeta)
    j = word_start + topic(u[5] * nw_tok)
    k_emp = z[perm_w[torch.clamp(j, 0, t_pad - 1)]]  # frozen-z proposal pool
    k_unif = topic(u[6] * kf)
    kprop = torch.where(u[4] < p_emp, k_emp, k_unif)
    ratio = pi_ratio(zcur, kprop) * (
        (cnt(nwk, w, zcur) + beta_f) / (cnt(nwk, w, kprop) + beta_f))
    znew = torch.where((u[7] < ratio) & msk, kprop, zcur)

    # ---- delayed count reconciliation: exact int32 scatter-adds ----
    _scatter_counts(ndk[None], nwk[None], nk[None], d.long() * k, w.long() * k,
                    msk.to(torch.int32), z[None], znew[None])
    z_buf.copy_(znew)


def _warp_sweep(state: SamplerState, u: torch.Tensor, **args) -> SamplerState:
    """One eager WarpLDA sweep (:func:`_warp_sweep_` on copies of the
    state's tables); returns the new state."""
    tables = tuple(t.clone() for t in (state.z, state.ndk, state.nwk, state.nk))
    _warp_sweep_(*tables, u, **args)
    return SamplerState(*tables, sweep=state.sweep + 1, seed=state.seed)


class WarpModel:
    """MH (WarpLDA) backend behind the standard ``InferenceBackend`` surface.

    ``noise_mode="external"`` takes each sweep's ``[8, T_pad]`` uniforms from
    ``sweep(n, noise=noise)``, ``noise(sweep)``; ``state`` injects a start
    (e.g. the reference's, through ``interop.from_jax_state``).

    The construction is the span ``warp.init`` (it waits for the card at its
    end), around ``state.init`` (where no start is given), ``warp.word_csr``
    (the word stream and mask uploaded as int32 and stably sorted by word on
    the model's device, waited for) and ``warp.args`` (the document stream
    and lengths uploaded, the per-token arrays gathered on the device,
    waited for).  Once a construction, the counter ``warp.upload_bytes``
    adds the bytes uploaded from the host (12 a slot and 4 a document) and
    ``warp.arg_bytes`` the per-token arrays' bytes (52 a slot).  A sweep
    opens no span."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda", *, noise_mode: str = "internal",
                 state: Optional[SamplerState] = None) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        if noise_mode not in ("internal", "external"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        self.device = resolve_device(device)
        with span("warp.init", self.device):
            self._init(config, corpus, noise_mode, state)

    def _init(self, config: LdaConfig, corpus: FlatCorpus, noise_mode: str,
              state: Optional[SamplerState]) -> None:
        self.config = config
        self.corpus = corpus
        self.noise_mode = noise_mode
        self.alpha = float(config.alpha)
        self.beta = float(config.beta)
        block = max(1, min(config.block_size, max(1, corpus.num_tokens)))
        pc = corpus.pad_to(block)
        self.block_size = block
        self._padded = pc
        self.doc_lengths = corpus.doc_lengths()
        if state is None:
            with span("state.init", self.device):
                state = init_state(
                    pc.token_word, pc.token_doc, pc.token_mask,
                    num_docs=pc.num_docs, vocab_size=pc.vocab_size,
                    num_topics=config.topic_num, seed=config.seed,
                    device=self.device)
        self.state = state
        self.generator = torch.Generator().manual_seed(self.state.seed)
        self._args = self._sweep_args(pc)
        count("warp.arg_bytes", sum(a.numel() * a.element_size()
                                    for a in self._args.values()))
        st = self.state
        self.graph = SweepGraph(
            self._body, (st.z, st.ndk, st.nwk, st.nk), vocab_size=pc.vocab_size,
            num_topics=config.topic_num, noise_mode=noise_mode,
            num_generators=1 if noise_mode == "internal" else 0)

    def _sweep_args(self, pc) -> dict:
        """The sweep's per-token arrays, built on the model's device from the
        padded stream and the document lengths, uploaded once as int32 (the
        counter ``warp.upload_bytes``).  The sort's and the gathers'
        temporaries are freed when this returns."""
        def upload(x):
            return torch.from_numpy(x).to(device=self.device, dtype=torch.int32)

        with span("warp.word_csr", self.device):
            tw, mask = upload(pc.token_word), upload(pc.token_mask)
            perm_w, word_ptr = word_csr(tw, pc.vocab_size, mask)
        with span("warp.args", self.device):
            td, lengths = upload(pc.token_doc), upload(self.doc_lengths)
            count("warp.upload_bytes", sum(
                x.numel() * x.element_size() for x in (tw, mask, td, lengths)))
            # doc_ptr over the PADDED stream == original (padding sits at the end)
            doc_ptr = torch.zeros(pc.num_docs + 1, dtype=torch.int64,
                                  device=self.device)
            doc_ptr[1:] = torch.cumsum(lengths, 0, dtype=torch.int64)
            tw, td = tw.long(), td.long()
            return dict(
                token_word=tw, token_doc=td, token_mask=mask,
                doc_start=doc_ptr[td], word_start=word_ptr[tw],
                nd_tok=lengths[td].to(torch.float32),
                nw_tok=word_ptr.diff()[tw].to(torch.float32),
                perm_w=perm_w,
            )

    # ------------------------------------------------------------------
    def _body(self, bufs, scalars, key, generators, noise) -> None:
        if noise is None:  # internal: the sweep's draws on its generator
            noise = torch.rand((8, bufs[0].shape[0]), generator=generators[0],
                               device=self.device)
        _warp_sweep_(*bufs, noise, alpha=self.alpha, beta=self.beta, **self._args)

    def sweep(self, n: int = 1,
              noise: Optional[Callable[[int], torch.Tensor]] = None) -> None:
        """``n`` sweeps: one graph replay each on the card.  Internal noise
        draws each sweep's seed from the model's host generator; external
        noise is ``noise(sweep)``, each sweep's ``[8, T_pad]`` uniforms."""
        if n <= 0:
            return
        st = self.state
        if self.noise_mode == "external":
            if noise is None:
                raise ValueError("external noise needs noise(sweep)")
            seeds = None

            def u(i):
                return noise(st.sweep + i).to(self.device, torch.float32)
        else:
            seeds, u = [(sweep_seed(self.generator),) for _ in range(n)], None
        out = self.graph((st.z, st.ndk, st.nwk, st.nk), self.alpha, self.beta, n,
                         seeds=seeds, noise=u)
        self.state = SamplerState(*out, sweep=st.sweep + n, seed=st.seed)

    @property
    def sweeps_done(self) -> int:
        return int(self.state.sweep)

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        from ldagibbssampling_tpu_torch.models.state import phi_theta

        phi, _ = phi_theta(self.state, self.doc_lengths, self.alpha, self.beta)
        return phi.cpu().numpy()

    def theta(self) -> np.ndarray:
        from ldagibbssampling_tpu_torch.models.state import phi_theta

        _, theta = phi_theta(self.state, self.doc_lengths, self.alpha, self.beta)
        return theta.cpu().numpy()

    def z(self) -> np.ndarray:
        return self.state.z.cpu().numpy()[: self.corpus.num_tokens]

    # ------------------------------------------------------------------
    def save_iterated_model(self, iteration: int, result_dir: str | Path):
        from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model

        return save_iterated_model(
            result_dir, iteration, self.phi(), self.theta(), self.z(),
            self.corpus, self.config,
        )
