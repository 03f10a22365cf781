"""High-level LDA model: the reference's driver flow on the PyTorch port.

Counterpart of ``ldagibbssampling_tpu/models/lda.py``.  Reference:
``LdaModel`` + ``LdaGibbsSampling.main`` (``src/liuyang/nlp/lda/main/``):

    initialize (random topics, count tables)            initializeModel :~55
    sweep loop with periodic artifact saves             inferenceModel  :~100
    final artifact dump                                 saveIteratedModel :~190

``resolve_tier`` picks the kernel tier and block size that the reference
``LdaModel`` and ``make_sweep_fn`` would run on a TPU for the same config
and corpus (their layout and exactness rules, not their platform rule), and
the model runs that tier: on ``cuda`` through its CUDA kernels, or with
``device="cpu"`` through their plain PyTorch versions.  With no CUDA the
default device raises rather than carry on on the CPU, and no kernel failure
falls back to another tier.  ``sampler="serial"`` runs the host oracle
(``models/oracle.py``).  The deferred tier runs K1 in the config's chain
(``kernel_compute_dtype``) against a snapshot of ``nwk`` in its
``mirror_dtype``.  ``optimize_hyperparameters`` (Minka's updates,
``models/hyper.py``) moves α and β between sweeps; the next sweep reads
them.  ``device_log_likelihood`` is the chunked training LL of
``evaluation/device_metrics.py``.  ``save_checkpoint``/``restore_checkpoint``
keep the whole run (``lda_io/checkpoint.py``): the state, the live α and β
and the generator that seeds each sweep, so a resumed chain is the
uninterrupted one, bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus, PaddedCorpus
from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
    device_log_likelihood)
from ldagibbssampling_tpu_torch.evaluation.tracing import span
from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model
from ldagibbssampling_tpu_torch.models import state as state_lib
from ldagibbssampling_tpu_torch.models.hyper import optimize_alpha, optimize_beta
from ldagibbssampling_tpu_torch.models.oracle import OracleSampler
from ldagibbssampling_tpu_torch.ops.count_kernel import DeferredPlan, plan_deferred
from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn, sweep_tier, tier_name

_log = logging.getLogger("ldagibbssampling_tpu_torch")


def resolve_device(device: Any = "cuda") -> torch.device:
    """``torch.device`` for an entry point; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) to "
            "run the kernels' plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class TierChoice:
    """What ``resolve_tier`` chose for a config and corpus."""

    kernel_tier: str        # "serial-oracle", "xla", "pallas-draw", "fused", "deferred"
    use_pallas: Any         # the make_sweep_fn tier (None for the oracle)
    block: Optional[int]    # tokens per block (None for the oracle)
    plan: Optional[DeferredPlan]  # the deferred layout, when it was made
    reason: Optional[str]   # why the tier differs from config.use_pallas


def resolve_tier(config: LdaConfig, corpus: FlatCorpus) -> TierChoice:
    """The tier and block the reference ``LdaModel`` + ``make_sweep_fn``
    would run on a TPU (``ldagibbssampling_tpu/models/lda.py:43-112``):

    - ``sampler="serial"`` runs the oracle;
    - ``block = min(block_size, num_tokens)`` (at least 1);
    - ``inverse_cdf`` turns the fused and deferred tiers into the XLA tier;
    - a deferred layout that ``plan_deferred`` cannot make (no multiple-of-8
      tile) turns the deferred tier into the fused tier;
    - then ``ops/gibbs.sweep_tier``'s block, token-count and row-tile rules.

    A pure function of the config and the corpus's shape and words."""
    if config.sampler == "serial":
        return TierChoice("serial-oracle", None, None, None, None)
    block = max(1, min(config.block_size, max(1, corpus.num_tokens)))
    use_pallas = config.use_pallas
    reasons = []
    if config.draw_method != "gumbel" and use_pallas in ("fused", "deferred"):
        use_pallas = False
        reasons.append(f"draw_method {config.draw_method!r} runs the XLA draw")
    plan = None
    if use_pallas == "deferred" and block >= 128:
        try:
            with span("plan.deferred"):
                plan = plan_deferred(corpus.token_word, corpus.token_doc,
                                     corpus.vocab_size, block)
        except ValueError as e:  # e.g. no multiple-of-8 tile
            use_pallas = "fused"
            reasons.append(f"no deferred layout ({e})")
    tier, _, why = sweep_tier(
        use_pallas, draw_method=config.draw_method, block_size=block,
        num_real_tokens=corpus.num_tokens, num_topics=config.topic_num)
    if why is not None:
        reasons.append(why)
    return TierChoice(tier_name(tier, config.draw_method), tier, block, plan,
                      "; ".join(reasons) or None)


def _assert_recount(token_word, token_doc, z, ndk, nwk, nk) -> None:
    """The count tables equal a serial recount of ``z`` (real tokens only):
    each table's cells counted exactly by one ``np.bincount`` over the flat
    cell index ``row * K + z``, linear in the tokens."""
    k = nwk.shape[1]
    z = np.asarray(z, np.int64)
    if z.size and (z.min() < 0 or z.max() >= k):
        raise AssertionError(f"z outside [0, {k}): {z.min()}..{z.max()}")

    def recount(rows, shape):
        flat = np.asarray(rows, np.int64) * k + z
        return np.bincount(flat, minlength=shape[0] * k).reshape(shape)

    ndk_ref = recount(token_doc, ndk.shape)
    nwk_ref = recount(token_word, nwk.shape)
    np.testing.assert_array_equal(ndk, ndk_ref)
    np.testing.assert_array_equal(nwk, nwk_ref)
    np.testing.assert_array_equal(nk, nwk_ref.sum(axis=0))


class LdaModel:
    """Collapsed-Gibbs LDA over a flat corpus (single chain, single device).

    The construction is the span ``lda.init``, around ``plan.deferred``
    (``resolve_tier``), ``state.init`` and ``sweep_fn.build`` (each waits
    for the card at its end); the deferred tier's first sweep casts its
    snapshot in ``sweep.snapshot`` (``ops/gibbs.make_sweep_fn``)."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        with span("lda.init", self.device):
            self._init(config, corpus)

    def _init(self, config: LdaConfig, corpus: FlatCorpus) -> None:
        self.config = config
        self.corpus = corpus
        self.doc_lengths = corpus.doc_lengths()
        self.alpha = float(config.alpha)
        self.beta = float(config.beta)
        choice = resolve_tier(config, corpus)
        self.kernel_tier = choice.kernel_tier
        log = _log.warning if choice.reason else _log.info
        log("kernel tier %s, block %s (requested use_pallas=%r, sampler=%r)%s",
            choice.kernel_tier, choice.block, config.use_pallas, config.sampler,
            f": {choice.reason}" if choice.reason else "")
        self._oracle: Optional[OracleSampler] = None
        self._plan = choice.plan
        self._perm: Optional[np.ndarray] = None
        self._mirror: Optional[torch.Tensor] = None
        self._ll_inputs: Optional[tuple] = None
        if choice.kernel_tier == "serial-oracle":
            self._oracle = OracleSampler(corpus, config.topic_num, config.alpha,
                                         config.beta, seed=config.seed)
            self.state = None
            self._run_sweeps = None
            return
        block = choice.block
        self.block_size = block
        if self._plan is not None:
            # slot i of the deferred layout holds real token plan.perm[i] (-1 = pad)
            pc = PaddedCorpus(
                token_word=self._plan.token_word,
                token_doc=self._plan.token_doc,
                token_mask=self._plan.token_mask,
                num_real_tokens=corpus.num_tokens,
                vocab_size=corpus.vocab_size,
                num_docs=corpus.num_docs,
            )
        else:
            pc = corpus.pad_to(block)
            if config.sort_blocks and block > 1:
                # within-block word sort: statistically free, and the
                # reference's layout for these tiers
                pc, self._perm = pc.sort_within_blocks(block)
        self._padded = pc
        with span("state.init", self.device):
            self.state = state_lib.init_state(
                pc.token_word, pc.token_doc, pc.token_mask,
                num_docs=pc.num_docs, vocab_size=pc.vocab_size,
                num_topics=config.topic_num, seed=config.seed, device=self.device,
            )
        # per-sweep seeds come from this generator (JAX: chain key)
        self.generator = torch.Generator().manual_seed(self.state.seed)
        with span("sweep_fn.build", self.device):
            self._run_sweeps = make_sweep_fn(
                pc.token_word, pc.token_doc, pc.token_mask, self.doc_lengths,
                alpha=config.alpha, beta=config.beta, block_size=block,
                draw_method=config.draw_method, num_sweeps=1,
                use_pallas=choice.use_pallas, num_topics=config.topic_num,
                deferred_plan=self._plan, device=self.device,
                kernel_compute_dtype=config.kernel_compute_dtype,
                mirror_dtype=config.mirror_dtype,
            )

    # ------------------------------------------------------------------
    def sweep(self, n: int = 1) -> None:
        """``n`` sweeps with the current α and β.  The deferred tier carries
        its snapshot (counts only, so it outlives a hyperparameter update)
        across calls: only the first sweep casts it from ``nwk``."""
        if self._oracle is not None:
            self._oracle.sweep(n)
            return
        with_mirror = getattr(self._run_sweeps, "with_mirror", None)
        if with_mirror is not None:
            self.state, self._mirror = with_mirror(
                self.state, self.alpha, self.beta, self._mirror, n_sweeps=n,
                generator=self.generator)
            return
        self.state = self._run_sweeps(self.state, self.alpha, self.beta,
                                      n_sweeps=n, generator=self.generator)

    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        """Minka fixed-point update of (α, β) from the current count tables
        (``models/hyper.py``); the next sweep reads the new values.  Not in
        serial-oracle mode (the oracle is the Java-fidelity chain)."""
        if self._oracle is not None:
            raise NotImplementedError(
                "hyperparameter optimization requires the device sampler")
        dl = torch.from_numpy(np.asarray(self.doc_lengths)).to(self.device)
        self.alpha = float(optimize_alpha(self.state.ndk, dl, self.alpha,
                                          iters=iters))
        self.beta = float(optimize_beta(self.state.nwk, self.state.nk,
                                        self.beta, iters=iters))
        return self.alpha, self.beta

    @property
    def sweeps_done(self) -> int:
        if self._oracle is not None:
            return self._oracle.sweep_idx
        return int(self.state.sweep)

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        if self._oracle is not None:
            return self._oracle.phi()
        phi, _ = state_lib.phi_theta(
            self.state, self.doc_lengths, self.alpha, self.beta)
        return phi.cpu().numpy()

    def theta(self) -> np.ndarray:
        if self._oracle is not None:
            return self._oracle.theta()
        _, theta = state_lib.phi_theta(
            self.state, self.doc_lengths, self.alpha, self.beta)
        return theta.cpu().numpy()

    def z(self) -> np.ndarray:
        """Topic assignments of the real (unpadded) tokens, corpus order."""
        if self._oracle is not None:
            return self._oracle.z.copy()
        z = self.state.z.cpu().numpy()
        if self._plan is not None:
            valid = self._plan.perm >= 0
            z_orig = np.empty(self.corpus.num_tokens, dtype=z.dtype)
            z_orig[self._plan.perm[valid]] = z[valid]
            return z_orig
        if self._perm is not None:
            # z lives in block-sorted order; map back to corpus order
            z_orig = np.empty_like(z)
            z_orig[self._perm] = z
            z = z_orig
        return z[: self.corpus.num_tokens]

    def check_counts_consistent(self) -> None:
        """Recompute all count tables serially from ``z`` and assert bitwise
        equality with the model's tables (the race-detection analog)."""
        if self._oracle is not None:
            o = self._oracle
            _assert_recount(self.corpus.token_word, self.corpus.token_doc,
                            o.z, o.ndk, o.nwk, o.nk)
            return
        pc = self._padded
        mask = pc.token_mask.astype(bool)
        _assert_recount(pc.token_word[mask], pc.token_doc[mask],
                        self.state.z.cpu().numpy()[mask],
                        self.state.ndk.cpu().numpy(),
                        self.state.nwk.cpu().numpy(),
                        self.state.nk.cpu().numpy())

    def device_log_likelihood(self) -> float:
        """Training LL computed on the model's device in token chunks
        (``evaluation/device_metrics.py``), the ``--ll-every`` path."""
        if self.state is None:
            raise NotImplementedError("serial-oracle mode has no device state")
        if self._ll_inputs is None:  # the token arrays, once, on the device
            pc = self._padded
            self._ll_inputs = tuple(
                torch.from_numpy(np.asarray(a, np.int32)).to(self.device)
                for a in (pc.token_word, pc.token_doc, pc.token_mask,
                          self.doc_lengths))
        return device_log_likelihood(
            self.state.ndk, self.state.nwk, self.state.nk, *self._ll_inputs,
            self.alpha, self.beta)

    def save_checkpoint(self, directory: str | Path) -> int:
        """Checkpoint of the full run (state, live α/β, the sweep seeds'
        generator) at step ``sweeps_done``; returns the step."""
        if self.state is None:
            raise NotImplementedError("serial-oracle mode has no device state")
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import save_run

        return save_run(directory, self.state, self.alpha, self.beta,
                        generator=self.generator)

    def restore_checkpoint(self, directory: str | Path) -> int:
        """Resume from the latest checkpoint; returns the restored sweep index."""
        if self.state is None:
            raise NotImplementedError("serial-oracle mode has no device state")
        from ldagibbssampling_tpu_torch.lda_io.checkpoint import restore_run

        self.state, self.alpha, self.beta, gen_state = restore_run(
            directory, self.state)
        if gen_state is not None:
            self.generator.set_state(gen_state)
        self._mirror = None  # the deferred snapshot is cast anew from nwk
        return int(self.state.sweep)

    # ------------------------------------------------------------------
    def save_iterated_model(self, iteration: int, result_dir: str | Path):
        """Dump the five reference artifacts (``saveIteratedModel``)."""
        return save_iterated_model(
            result_dir, iteration, self.phi(), self.theta(), self.z(),
            self.corpus, self.config,
        )

    def inference(
        self,
        result_dir: Optional[str | Path] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> None:
        """The reference's ``inferenceModel`` loop, including the save schedule.

        Saves happen when ``i >= beginSaveIters`` and ``(i - beginSaveIters) %
        saveStep == 0`` (only when ``result_dir`` is given); the reference's
        ``iterations < saveStep + beginSaveIters`` hard-exit guard is enforced
        as a ValueError in that case.
        """
        cfg = self.config
        if result_dir is not None:
            cfg.validate_reference_guard()
        for i in range(cfg.iteration):
            if (
                result_dir is not None
                and i >= cfg.begin_save_iters
                and (i - cfg.begin_save_iters) % cfg.save_step == 0
            ):
                self.save_iterated_model(i, result_dir)
            self.sweep(1)
            if progress is not None:
                progress(i)
