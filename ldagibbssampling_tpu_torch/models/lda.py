"""High-level LDA model: the reference's driver flow on the PyTorch port.

Counterpart of ``ldagibbssampling_tpu/models/lda.py`` for
``sampler="blocked"`` in the deferred kernel tier.  Reference: ``LdaModel``
+ ``LdaGibbsSampling.main`` (``src/liuyang/nlp/lda/main/``):

    initialize (random topics, count tables)            initializeModel :~55
    sweep loop with periodic artifact saves             inferenceModel  :~100
    final artifact dump                                 saveIteratedModel :~190

The model runs on ``cuda`` unless given ``device="cpu"`` (where the kernels'
plain PyTorch versions run); with no CUDA it raises rather than carry on on
the CPU.  Hyperparameter optimisation, checkpoints and the device
log-likelihood are not ported yet and raise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus, PaddedCorpus
from ldagibbssampling_tpu_torch.lda_io.artifacts import save_iterated_model
from ldagibbssampling_tpu_torch.models import state as state_lib
from ldagibbssampling_tpu_torch.ops.count_kernel import plan_deferred
from ldagibbssampling_tpu_torch.ops.gibbs import _round_up, make_sweep_fn


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


class LdaModel:
    """Collapsed-Gibbs LDA over a flat corpus (single chain, single device)."""

    def __init__(self, config: LdaConfig, corpus: FlatCorpus,
                 device: Any = "cuda") -> None:
        self.device = resolve_device(device)
        self.config = config
        self.corpus = corpus
        self.doc_lengths = corpus.doc_lengths()
        self.alpha = float(config.alpha)
        self.beta = float(config.beta)
        # The deferred layout needs a multiple-of-8 block: a corpus shorter
        # than config.block_size gets one block of its size rounded up to 8
        # (the reference clamps to the exact token count and, when that has
        # no multiple-of-8 tile, downgrades to another tier).
        block = min(config.block_size, _round_up(max(1, corpus.num_tokens), 8))
        if block < 128:
            raise NotImplementedError(
                f"a block of {block} tokens (< 128) runs the reference's XLA "
                "sweep, which is not ported (ROADMAP Queue 1 item 7)")
        self.block_size = block
        # slot i of the sweep layout holds real token plan.perm[i] (-1 = pad)
        self._plan = plan_deferred(corpus.token_word, corpus.token_doc,
                                   corpus.vocab_size, block)
        self._padded = PaddedCorpus(
            token_word=self._plan.token_word,
            token_doc=self._plan.token_doc,
            token_mask=self._plan.token_mask,
            num_real_tokens=corpus.num_tokens,
            vocab_size=corpus.vocab_size,
            num_docs=corpus.num_docs,
        )
        pc = self._padded
        self.state = state_lib.init_state(
            pc.token_word, pc.token_doc, pc.token_mask,
            num_docs=pc.num_docs, vocab_size=pc.vocab_size,
            num_topics=config.topic_num, seed=config.seed, device=self.device,
        )
        # per-sweep kernel seeds come from this generator (JAX: chain key)
        self.generator = torch.Generator().manual_seed(self.state.seed)
        self._run_sweeps = make_sweep_fn(
            pc.token_word, pc.token_doc, pc.token_mask, alpha=config.alpha,
            beta=config.beta, block_size=block, num_sweeps=1, use_pallas="deferred", num_topics=config.topic_num,
            deferred_plan=self._plan, device=self.device,
        )
        self.kernel_tier = self._run_sweeps.kernel_tier
        self._mirror: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def sweep(self, n: int = 1) -> None:
        """``n`` sweeps, carrying the bf16 snapshot across calls: only the
        first sweep casts it from ``nwk``."""
        self.state, self._mirror = self._run_sweeps.with_mirror(
            self.state, self.alpha, self.beta, self._mirror, n_sweeps=n,
            generator=self.generator)

    def optimize_hyperparameters(self, iters: int = 5) -> tuple[float, float]:
        raise NotImplementedError(
            "hyperparameter optimisation is not ported (ROADMAP Queue 1 item 10)")

    @property
    def sweeps_done(self) -> int:
        return int(self.state.sweep)

    # ------------------------------------------------------------------
    def phi(self) -> np.ndarray:
        phi, _ = state_lib.phi_theta(
            self.state, self.doc_lengths, self.alpha, self.beta)
        return phi.cpu().numpy()

    def theta(self) -> np.ndarray:
        _, theta = state_lib.phi_theta(
            self.state, self.doc_lengths, self.alpha, self.beta)
        return theta.cpu().numpy()

    def z(self) -> np.ndarray:
        """Topic assignments of the real (unpadded) tokens, corpus order."""
        z = self.state.z.cpu().numpy()
        valid = self._plan.perm >= 0
        z_orig = np.empty(self.corpus.num_tokens, dtype=z.dtype)
        z_orig[self._plan.perm[valid]] = z[valid]
        return z_orig

    def check_counts_consistent(self) -> None:
        """Recompute all count tables serially from ``z`` and assert bitwise
        equality with the device tables (the race-detection analog)."""
        pc = self._padded
        mask = pc.token_mask.astype(bool)
        z = self.state.z.cpu().numpy()
        k = self.config.topic_num
        ndk_ref = np.zeros((pc.num_docs, k), np.int64)
        nwk_ref = np.zeros((pc.vocab_size, k), np.int64)
        np.add.at(ndk_ref, (pc.token_doc[mask], z[mask]), 1)
        np.add.at(nwk_ref, (pc.token_word[mask], z[mask]), 1)
        np.testing.assert_array_equal(self.state.ndk.cpu().numpy(), ndk_ref)
        np.testing.assert_array_equal(self.state.nwk.cpu().numpy(), nwk_ref)
        np.testing.assert_array_equal(self.state.nk.cpu().numpy(),
                                      nwk_ref.sum(axis=0))

    def device_log_likelihood(self) -> float:
        raise NotImplementedError(
            "the device log-likelihood is not ported (ROADMAP Queue 1 item 9)")

    def save_checkpoint(self, directory: str | Path) -> int:
        raise NotImplementedError(
            "checkpoints are not ported (ROADMAP Queue 1 item 11)")

    def restore_checkpoint(self, directory: str | Path) -> int:
        raise NotImplementedError(
            "checkpoints are not ported (ROADMAP Queue 1 item 11)")

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
