"""Configuration for the LDA engine (PyTorch/CUDA port).

The reference exposes exactly six runtime knobs through a tab-separated parameter
file parsed by an enum-switch (``LdaGibbsSampling.getParametersFromFile`` in
``src/liuyang/nlp/lda/main/LdaGibbsSampling.java``), with code defaults
``alpha=0.5, beta=0.1, topicNum=100, iteration=100, saveStep=10,
beginSaveIters=50`` (``modelparameters`` inner class).  We keep those six knobs
with the same names/semantics, add the engine-level knobs the reference lacks
(mesh shape, backend, seed, precision, chains), and provide an importer for the
reference's parameter-file format.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping


class ReferenceGuardError(ValueError):
    """The reference's ``iterations < saveStep + beginSaveIters`` hard-exit
    (``LdaModel.inferenceModel`` guard), surfaced as a typed error so the CLI
    can distinguish it from genuine internal failures."""


@dataclasses.dataclass
class LdaConfig:
    # --- the reference's six knobs (names per LdaGibbsSampling.parameters enum) ---
    alpha: float = 0.5
    beta: float = 0.1
    topic_num: int = 100
    iteration: int = 100
    save_step: int = 10
    begin_save_iters: int = 50

    # --- engine knobs (new; absent in reference) ---
    backend: str = "gibbs"  # gibbs | cvb0 | svi | smc | warp (O(1)/token MH)
    seed: int = 0
    chains: int = 1
    block_size: int = 2048  # tokens per blocked-Gibbs block; 1 => exact serial chain
    sampler: str = "blocked"  # blocked | serial (Java-fidelity, CPU)
    # Kernel tier: False = XLA sweep (PyTorch ops); True = v1 draw kernel
    # (K3) per block; "fused" = K1 against the live word-topic table, tiles
    # in order, nwk moved after each block; "deferred" = K1 against a
    # sweep-stale bf16 snapshot of nwk plus a per-sweep rebuild kernel (the
    # default).  models/lda.resolve_tier applies the reference's layout and
    # exactness rules to it (and reports the tier that runs as kernel_tier);
    # no kernel failure falls back to another tier.
    use_pallas: bool | str = "deferred"
    # the reference's interpreter switch; the port has none (raises if set)
    pallas_interpret: bool = False
    # deferred tier only: K1's [B, K] chain dtype.  "float32"; "bfloat16"
    # (the conditional product and the score in bf16, rounded after every
    # op); "bf16p" (the product in bf16, the score in float32)
    kernel_compute_dtype: str = "float32"
    # deferred tier only: the sweep-stale snapshot of nwk that K1 reads,
    # "bfloat16" (rounds counts above 256) or "float32" (exact counts)
    mirror_dtype: str = "bfloat16"
    draw_method: str = "gumbel"  # gumbel (fast path) | inverse_cdf (fidelity draw)
    sort_blocks: bool = True  # word-sort tokens within blocks (sorted-scatter fast path)
    count_dtype: str = "int32"
    prob_dtype: str = "float32"
    # mesh: axis name -> size; empty = single device
    mesh: dict[str, int] = dataclasses.field(default_factory=dict)
    top_words: int = 20  # .twords top-N (topNum=20 in saveIteratedModel)

    def __post_init__(self) -> None:
        if self.backend not in ("gibbs", "cvb0", "svi", "smc", "warp"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.sampler not in ("blocked", "serial"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.draw_method not in ("inverse_cdf", "gumbel"):
            raise ValueError(f"unknown draw_method {self.draw_method!r}")
        if self.use_pallas not in (False, True, "fused", "deferred"):
            raise ValueError(f"unknown use_pallas {self.use_pallas!r}")
        if self.kernel_compute_dtype not in ("float32", "bfloat16", "bf16p"):
            raise ValueError(
                f"unknown kernel_compute_dtype {self.kernel_compute_dtype!r}")
        if self.mirror_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown mirror_dtype {self.mirror_dtype!r}")
        self._check_ported()

    def _check_ported(self) -> None:
        """Raise for settings whose code paths the port does not have.

        The port runs every backend, the Gibbs tiers, several chains
        (``chains > 1``) and the mesh runtimes (``mesh``); the serial
        oracle ignores ``chains`` and ``mesh`` as the reference's does.
        The reference's Pallas interpreter has no counterpart; nothing falls
        back to another path.
        """
        missing = []
        if self.pallas_interpret:
            missing.append(
                "pallas_interpret=True (no interpreter: device='cpu' runs "
                "the kernels' plain versions)")
        if missing:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(missing))

    # The reference hard-exits when iterations < saveStep + beginSaveIters
    # (LdaModel.inferenceModel guard). We validate instead of System.exit.
    def validate_reference_guard(self) -> None:
        if self.iteration < self.save_step + self.begin_save_iters:
            raise ReferenceGuardError(
                "iteration must be >= save_step + begin_save_iters "
                f"({self.iteration} < {self.save_step} + {self.begin_save_iters}); "
                "the reference exits with an error here"
            )

    # ------------------------------------------------------------------
    # Reference parameter-file format: lines "<name>\t<value>", names matching
    # the parameters enum {alpha, beta, topicNum, iteration, saveStep,
    # beginSaveIters}. Unknown names are ignored (the reference's enum-switch
    # simply has no case for them).
    # ------------------------------------------------------------------
    _REF_KEYMAP = {
        "alpha": ("alpha", float),
        "beta": ("beta", float),
        "topicnum": ("topic_num", int),
        "iteration": ("iteration", int),
        "savestep": ("save_step", int),
        "beginsaveiters": ("begin_save_iters", int),
    }

    @classmethod
    def from_reference_parameter_file(cls, path: str | Path, **overrides: Any) -> "LdaConfig":
        cfg = cls(**overrides)
        for raw in Path(path).read_text().splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            if len(parts) < 2:
                continue
            entry = cls._REF_KEYMAP.get(parts[0].strip().lower())
            if entry is None:
                continue
            field, typ = entry
            setattr(cfg, field, typ(float(parts[1])) if typ is int else typ(parts[1]))
        return cfg

    def to_reference_parameter_file(self, path: str | Path) -> None:
        names = [
            ("alpha", self.alpha),
            ("beta", self.beta),
            ("topicNum", self.topic_num),
            ("iteration", self.iteration),
            ("saveStep", self.save_step),
            ("beginSaveIters", self.begin_save_iters),
        ]
        Path(path).write_text("".join(f"{k}\t{v}\n" for k, v in names))

    # ------------------------------------------------------------------
    # JSON round-trip (engine-native config files)
    # ------------------------------------------------------------------
    @classmethod
    def from_json(cls, path: str | Path) -> "LdaConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LdaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")

    def replace(self, **kw: Any) -> "LdaConfig":
        return dataclasses.replace(self, **kw)
