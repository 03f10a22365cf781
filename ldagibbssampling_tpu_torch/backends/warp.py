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
from ldagibbssampling_tpu_torch.models.state import SamplerState, init_state
from ldagibbssampling_tpu_torch.ops.gibbs import _scatter_counts, sweep_seed
from ldagibbssampling_tpu_torch.ops.graphs import SweepGraph


def word_csr(token_word: np.ndarray, vocab_size: int, mask: np.ndarray):
    """Word-major CSR over the token stream: ``(perm_w [T], word_ptr [V+1])``.

    ``perm_w`` lists token indices sorted by word id (stable, padding last);
    the word proposal draws a uniform position inside a word's range and reuses
    ``z[perm_w[j]]``.
    """
    # order real tokens by word; padding tokens sort after every real word
    sort_key = np.where(mask > 0, token_word.astype(np.int64), vocab_size)
    perm_w = np.argsort(sort_key, kind="stable").astype(np.int32)
    counts = np.bincount(token_word[mask > 0], minlength=vocab_size)
    word_ptr = np.zeros(vocab_size + 1, dtype=np.int32)
    np.cumsum(counts, out=word_ptr[1:])
    return perm_w, word_ptr


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
    (e.g. the reference's, through ``interop.from_jax_state``)."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda", *, noise_mode: str = "internal",
                 state: Optional[SamplerState] = None) -> None:
        from ldagibbssampling_tpu_torch.models.lda import resolve_device

        if noise_mode not in ("internal", "external"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        self.device = resolve_device(device)
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
            state = init_state(
                pc.token_word, pc.token_doc, pc.token_mask,
                num_docs=pc.num_docs, vocab_size=pc.vocab_size,
                num_topics=config.topic_num, seed=config.seed,
                device=self.device)
        self.state = state
        self.generator = torch.Generator().manual_seed(self.state.seed)
        perm_w, word_ptr = word_csr(pc.token_word, pc.vocab_size, pc.token_mask)
        # doc_ptr over the PADDED stream == original (padding sits at the end)
        doc_ptr = np.zeros(pc.num_docs + 1, dtype=np.int64)
        np.cumsum(self.doc_lengths, out=doc_ptr[1:])
        word_count = np.diff(word_ptr)

        def dev(x, dtype=torch.int64):
            return torch.from_numpy(np.asarray(x)).to(device=self.device, dtype=dtype)

        tw, td = pc.token_word.astype(np.int64), pc.token_doc.astype(np.int64)
        self._args = dict(
            token_word=dev(tw), token_doc=dev(td),
            token_mask=dev(pc.token_mask, torch.int32),
            doc_start=dev(doc_ptr[td]), word_start=dev(word_ptr[tw]),
            nd_tok=dev(self.doc_lengths[td], torch.float32),
            nw_tok=dev(word_count[tw], torch.float32),
            perm_w=dev(perm_w),
        )
        st = self.state
        self.graph = SweepGraph(
            self._body, (st.z, st.ndk, st.nwk, st.nk), vocab_size=pc.vocab_size,
            num_topics=config.topic_num, noise_mode=noise_mode,
            num_generators=1 if noise_mode == "internal" else 0)

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
