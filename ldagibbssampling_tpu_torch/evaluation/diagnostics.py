"""Cross-chain convergence diagnostics (Gelman-Rubin split-R̂).

Copied from ``ldagibbssampling_tpu/evaluation/diagnostics.py:13-265`` (numpy;
the port keeps its own copy, line for line).  No reference analog in the
Java code; the multi-chain runs (ROADMAP Queue 1 item 12) report R̂ on the
training LL and on φ through these.  Operates on per-chain scalar traces
(e.g. log-likelihood per sweep, or a φ entry per save), shape
``[n_chains, n_draws]``.
"""

from __future__ import annotations

import numpy as np


def r_hat(traces: np.ndarray) -> float:
    """Split-R̂ of Gelman et al. (BDA3): values near 1.0 indicate convergence.

    ``traces``: [n_chains, n_draws]; each chain is split in half, so the
    effective chain count is 2·n_chains.
    """
    x = np.asarray(traces, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("traces must be [n_chains, n_draws]")
    n = x.shape[1] // 2
    if n < 2:
        return float("nan")
    halves = np.concatenate([x[:, :n], x[:, n : 2 * n]], axis=0)  # [2C, n]
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    w = chain_vars.mean()                       # within-chain variance
    b = n * chain_means.var(ddof=1)             # between-chain variance
    if w <= 0:
        return 1.0 if b <= 0 else float("inf")
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def r_hat_array(traces: np.ndarray, eps: float = 1e-30) -> np.ndarray:
    """Vectorized split-R̂ over every trailing element.

    ``traces``: [n_chains, n_draws, ...]; returns R̂ with shape ``traces.shape[2:]``.
    Elements whose within- and between-chain variances are both ~0 (e.g. a
    φ cell that is essentially constant) report 1.0, not inf.
    """
    x = np.asarray(traces, dtype=np.float64)
    if x.ndim < 2:
        raise ValueError("traces must be [n_chains, n_draws, ...]")
    n = x.shape[1] // 2
    if n < 2:
        return np.full(x.shape[2:], np.nan)
    halves = np.concatenate([x[:, :n], x[:, n : 2 * n]], axis=0)  # [2C, n, ...]
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    out = np.sqrt(np.divide(var_plus, w, out=np.ones_like(w), where=w > eps))
    out = np.where((w <= eps) & (b > eps), np.inf, out)
    return out


def align_topics(phi_ref: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Greedy topic matching: permutation ``perm`` with ``phi[perm]`` ≈ ``phi_ref``.

    φ is identified only up to topic relabeling across chains (label
    switching), so cross-chain comparisons must align first.  Similarity is
    the Bhattacharyya coefficient between topic-word rows (rows are
    distributions over V); greedy max-picking is O(K³) worst case — fine for
    the K ≤ a few thousand this model family uses.
    """
    a = np.sqrt(np.asarray(phi_ref, np.float64))
    b = np.sqrt(np.asarray(phi, np.float64))
    sim = a @ b.T                          # [K, K]
    k = sim.shape[0]
    perm = np.full(k, -1, np.int64)
    sim = sim.copy()
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(sim), sim.shape)
        perm[i] = j
        sim[i, :] = -np.inf
        sim[:, j] = -np.inf
    return perm


class PhiRhatAccumulator:
    """Split-R̂ on φ from running moments — O(C·K·V) memory, any draw count.

    Round-3 verdict (weak #2): storing ``[C, S, K, V]`` φ snapshots is
    ~1.6 GB/draw at the Wikipedia-rung shape; split-R̂ only needs, per
    (chain, split-half), the per-cell running mean and M2 (Welford).  The
    caller routes each recorded draw to half 0 or half 1 (first half of the
    recording window vs second — the standard split); topic alignment across
    chains happens once at ``result()`` time by permuting the ACCUMULATED
    moments (a per-chain permutation constant over draws commutes with the
    running sums, so this equals accumulating aligned draws).
    """

    def __init__(self, num_chains: int, num_topics: int, vocab: int,
                 dtype=np.float64) -> None:
        self.c, self.k, self.v = num_chains, num_topics, vocab
        self.n = np.zeros((2, num_chains), np.int64)
        self.mean = np.zeros((2, num_chains, num_topics, vocab), dtype)
        self.m2 = np.zeros((2, num_chains, num_topics, vocab), dtype)

    def add(self, phis: np.ndarray, half: int) -> None:
        """Fold one draw per chain (``phis [C, K, V]``) into ``half`` (0/1)."""
        x = np.asarray(phis, self.mean.dtype)
        if x.shape != (self.c, self.k, self.v):
            raise ValueError(f"expected [C,K,V]={self.c, self.k, self.v}, got {x.shape}")
        self.n[half] += 1
        n = self.n[half][:, None, None]
        delta = x - self.mean[half]
        self.mean[half] += delta / n
        self.m2[half] += delta * (x - self.mean[half])

    @property
    def draws(self) -> int:
        return int(self.n.sum())

    def result(self, mass_floor: float = 0.5) -> dict:
        """Same summary dict as :func:`r_hat_phi` (max/p99/frac/n_cells/perms)."""
        n0, n1 = int(self.n[0].min()), int(self.n[1].min())
        if n0 < 2 or n1 < 2:
            return {"max": float("nan"), "p99": float("nan"),
                    "frac_gt_1_1": float("nan"), "n_cells": 0, "perms": []}
        if (self.n != self.n[0, 0]).any():
            # Unbalanced routing (e.g. an odd draw count on an alternating
            # schedule).  Welford moments cannot be truncated to the balanced
            # prefix, so no valid split-R̂ exists for THIS accumulator state;
            # report NaN with a note rather than crashing the run (round-4
            # verdict weak #1).  Callers wanting a value at every horizon
            # should record through :class:`PhiRhatWindowedAccumulator`.
            return {"max": float("nan"), "p99": float("nan"),
                    "frac_gt_1_1": float("nan"), "n_cells": 0, "perms": [],
                    "unbalanced_halves": self.n.tolist()}
        n = n0
        # align chains to chain 0 on the combined (both-half) mean
        combined = self.mean.mean(axis=0)          # [C, K, V]
        perms = [np.arange(self.k)]
        for ci in range(1, self.c):
            perms.append(align_topics(combined[0], combined[ci]))
        mean_a = np.stack([self.mean[:, ci, perms[ci], :] for ci in range(self.c)],
                          axis=1)                  # [2, C, K, V]
        m2_a = np.stack([self.m2[:, ci, perms[ci], :] for ci in range(self.c)],
                        axis=1)
        halves_mean = mean_a.reshape(2 * self.c, self.k, self.v)
        halves_var = (m2_a / (n - 1)).reshape(2 * self.c, self.k, self.v)
        w = halves_var.mean(axis=0)
        b = n * halves_mean.var(axis=0, ddof=1)
        var_plus = (n - 1) / n * w + b / n
        eps = 1e-30
        rh = np.sqrt(np.divide(var_plus, w, out=np.ones_like(w), where=w > eps))
        rh = np.where((w <= eps) & (b > eps), np.inf, rh)
        # mass mask over the ALIGNED mean (same cells as r_hat_phi's)
        mask = mean_a.mean(axis=(0, 1)) > (mass_floor / self.v)
        cells = rh[mask]
        if cells.size == 0:
            cells = rh.reshape(-1)
        return {
            "max": float(np.max(cells)),
            "p99": float(np.quantile(cells, 0.99)),
            "frac_gt_1_1": float(np.mean(cells > 1.1)),
            "n_cells": int(cells.size),
            "perms": [p.tolist() for p in perms],
        }


class PhiRhatWindowedAccumulator:
    """Pair-safe doubling-window driver over :class:`PhiRhatAccumulator`.

    The product path (CLI ``--chains N``) records one φ draw per sweep call
    with no known horizon, so two things must hold at EVERY draw count:

    - ``result()`` always returns (never raises) — the round-4 verdict's
      confirmed crash was an odd draw count on an alternating half schedule
      hitting ``PhiRhatAccumulator.result()``'s balance check mid-run.
    - early draws must not pollute the diagnostic — the sampler starts from a
      random ``z`` init, and split-R̂ folded from sweep 1 reports divergence
      long after the chains have mixed.

    Both are solved by the benchmark ladder's policy (``benchmarks/ladder.py``
    rung 4), made online: draws are recorded in windows of doubling length
    (4, 8, 16, … draws).  Within a window of length L, draw i routes to half 0
    if ``i < L/2`` else half 1 — the standard sequential split, balanced
    exactly at window completion.  When a window completes, its summary is
    cached and the accumulator resets; every earlier window becomes burn-in,
    so the reported window always covers roughly the second half of the run.
    ``result()`` returns the most recently completed window's summary (NaN
    before the first completes, i.e. < 4 draws — same contract as the trace
    path).
    """

    def __init__(self, num_chains: int, num_topics: int, vocab: int,
                 first_window: int = 4, dtype=np.float64) -> None:
        if first_window < 4 or first_window % 2:
            raise ValueError("first_window must be an even count >= 4")
        self._shape = (num_chains, num_topics, vocab)
        self._dtype = dtype
        self.window = first_window
        self.pos = 0            # draws folded into the current window
        self.total_draws = 0
        self.cur = PhiRhatAccumulator(num_chains, num_topics, vocab, dtype)
        self._completed: dict | None = None

    def add(self, phis: np.ndarray) -> None:
        """Fold one draw per chain (``phis [C, K, V]``); routing is internal."""
        half = 0 if self.pos < self.window // 2 else 1
        self.cur.add(phis, half)
        self.pos += 1
        self.total_draws += 1
        if self.pos == self.window:
            summary = self.cur.result()
            summary["window_draws"] = self.window
            summary["burn_in_draws"] = self.total_draws - self.window
            self._completed = summary
            self.window *= 2
            self.pos = 0
            self.cur = PhiRhatAccumulator(*self._shape, self._dtype)

    @property
    def draws(self) -> int:
        return self.total_draws

    def result(self) -> dict:
        """Summary of the last COMPLETED window — never raises."""
        if self._completed is not None:
            return dict(self._completed)
        return {"max": float("nan"), "p99": float("nan"),
                "frac_gt_1_1": float("nan"), "n_cells": 0, "perms": []}


def r_hat_phi(phi_draws: np.ndarray, mass_floor: float = 0.5) -> dict:
    """Split-R̂ on φ across chains, after topic alignment (BASELINE config 4).

    ``phi_draws``: [n_chains, n_draws, K, V] of per-save φ point estimates.
    Chains are aligned to chain 0 by matching their *mean* φ (greedy
    Bhattacharyya, :func:`align_topics`); R̂ is then computed elementwise on
    the aligned φ cells and summarized over cells with enough posterior mass
    (mean φ above ``mass_floor``/V — near-zero cells carry no convergence
    signal and only add float noise).

    Returns ``{"max", "p99", "frac_gt_1_1", "n_cells", "perms"}``.
    """
    x = np.asarray(phi_draws, np.float64)
    if x.ndim != 4:
        raise ValueError("phi_draws must be [n_chains, n_draws, K, V]")
    c, s, k, v = x.shape
    ref = x[0].mean(axis=0)
    perms = [np.arange(k)]
    aligned = [x[0]]
    for ci in range(1, c):
        perm = align_topics(ref, x[ci].mean(axis=0))
        perms.append(perm)
        aligned.append(x[ci][:, perm, :])
    xa = np.stack(aligned)                  # [C, S, K, V]
    mask = xa.mean(axis=(0, 1)) > (mass_floor / v)
    rh = r_hat_array(xa)                    # [K, V]
    cells = rh[mask]
    if cells.size == 0:
        cells = rh.reshape(-1)
    return {
        "max": float(np.max(cells)),
        "p99": float(np.quantile(cells, 0.99)),
        "frac_gt_1_1": float(np.mean(cells > 1.1)),
        "n_cells": int(cells.size),
        "perms": [p.tolist() for p in perms],
    }
