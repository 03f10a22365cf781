"""K1's three chains (``compute_dtype`` float32, bfloat16, bf16p) on both
snapshot types (bf16 and float32 rows) against the reference kernel,
``pallas_fused_block(..., interpret=True, emit_delta=False)``.

The float32 chain is held against the reference as it is, in this process
with default flags, as the other kernel tests hold it.

The bf16 chains are held against the reference run in ONE subprocess, this
file run as a script, with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_allow_excess_precision=false``.  By
default XLA on the CPU keeps excess precision in a jitted bf16 chain (it
computes the chain in float32 and rounds once at the end), which is not the
chain as the kernel is written; with the flag off every bf16 op rounds, as
PyTorch's bf16 ops do.  XLA reads the flag once per process, and the test
workers have started XLA long before, hence the subprocess.  The subprocess
first checks that the flag took effect (``per_op_chain``).

One more substitution there, and why: the CPU interpreter lowers
``pl.reciprocal(x, approx=True)`` as ``reciprocal(x.astype(bf16))``, a bf16
op, so with the flag off its quotient rounds to bf16 too, while with the
default flag (and in the port, since its first slice) it is the float32
quotient of the bf16-cast input; the TPU's estimate is a float32 value.  The
subprocess registers that float32-quotient lowering for the approx
reciprocal and keeps every other op as it is (``pinned``): the bf16 chains
must equal it exactly.  The reference without that substitution, with the
flag off (``unpinned``, same subprocess) and with default flags (this
process), is held to a bound: at most one of a case's 247 unmasked draws
differs from the port's (0 or 1 measured), and the reference's doc counts
and topic totals are those its own draws imply.

Tolerances: deterministic mode is bitwise (``z``, doc counts, topic
totals).  External noise: ``z`` equal on >= 99.9% of tokens, and exact for
the tested seeds (XLA's and PyTorch's float32 ``log`` may differ by one ulp,
which can move a bf16 rounding of ``1/E`` and flip a near-tie); the counts
then equal too.  K = 500 (padded to 512), 256 tokens in two tiles of 128,
counts above 256 so the bf16 roundings of counts are exercised.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, K_PAD, B, D_LOC, ROW_TILE = 500, 512, 256, 8, 128
ALPHA, BETA = 0.5, 0.1
VBETA = float(np.float32(50_000) * np.float32(BETA))
# K1's α, β and Vβ as the float32 device values it reads (the seed is not
# read: these cases have no internal noise)
K1_SCALARS = np.array([ALPHA, BETA, VBETA], np.float32)
CHAINS = ("float32", "bfloat16", "bf16p")
ROWS = ("bfloat16", "float32")
MODES = ("deterministic", "external")
CASES = [(c, r, m) for c in CHAINS for r in ROWS for m in MODES]
# the model-level cases: (chain, snapshot) of the deferred LdaModel
MODEL_CASES = [(c, m) for c in CHAINS for m in ("bfloat16", "float32")]
MODEL_K, MODEL_V, MODEL_SWEEPS = 5, 300, 3
# what the subprocess computes: the bf16 chains
BF16_CASES = [c for c in CASES if c[0] != "float32"]
BF16_MODEL_CASES = [c for c in MODEL_CASES if c[0] != "float32"]
# the reference without the pinned reciprocal: flag off, and default flags
VARIANTS = ("unpinned", "default")


def _seed(case) -> int:
    return CASES.index(case) + 11


def kernel_inputs(seed: int):
    """One block: rows ``[B, K_PAD]`` (token i reads row i; float32 values,
    bf16-exact for the bf16 snapshot), doc slab, topic totals, ``z_old``,
    ``d_local``, mask and uniforms.  Every token's own cells hold at least
    its own count."""
    rng = np.random.default_rng(seed)
    zold = rng.integers(0, K, B).astype(np.int32)
    d_local = np.sort(rng.integers(0, D_LOC, B)).astype(np.int32)
    msk = np.ones(B, np.int32)
    msk[-9:] = 0
    rows = np.zeros((B, K_PAD), np.float32)
    rows[:, :K] = rng.integers(0, 3000, (B, K))
    rows[np.arange(B), zold] += 1
    slab = np.zeros((D_LOC, K_PAD), np.float32)
    slab[:, :K] = rng.integers(0, 600, (D_LOC, K))
    np.add.at(slab, (d_local[msk > 0], zold[msk > 0]), 1)
    nk = np.zeros((1, K_PAD), np.float32)
    nk[0, :K] = slab[:, :K].sum(0) + rng.integers(1000, 200_000, K)
    u = rng.uniform(1e-7, 1 - 1e-7, (B, K_PAD)).astype(np.float32)
    return rows, slab, nk, zold, d_local, msk, u


def model_corpus(seed: int = 3):
    """Four long documents over a Zipf vocabulary: doc-topic and word-topic
    cells above 256 at K = 5."""
    rng = np.random.default_rng(seed)
    t, docs = 6000, 4
    tw = ((rng.zipf(1.3, size=t) - 1) % MODEL_V).astype(np.int32)
    td = (np.arange(t) * docs // t).astype(np.int32)
    ptr = np.zeros(docs + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=docs), out=ptr[1:])
    return tw, td, ptr


# ---------------------------------------------------------------------------
# the reference side (in this process with default flags, or in the
# subprocess: this file run as a script)
# ---------------------------------------------------------------------------


def reference_kernel_case(case):
    """``[z, slab, nk]`` of ``pallas_fused_block(interpret=True)`` on the
    inputs of ``case``, under this process's flags and lowerings."""
    import jax.numpy as jnp

    from ldagibbssampling_tpu.ops.pallas_gibbs import pallas_fused_block

    chain, rows_dtype, mode = case
    rows, slab, nk, zold, d_local, msk, u = kernel_inputs(_seed(case))
    res = pallas_fused_block(
        jnp.asarray(rows).astype(jnp.dtype(rows_dtype)), jnp.asarray(slab),
        jnp.asarray(nk), jnp.asarray(zold), jnp.asarray(d_local),
        jnp.asarray(msk), jnp.int32(3),
        jnp.asarray(u) if mode == "external" else None, alpha=ALPHA, beta=BETA,
        vbeta=VBETA, k_real=K, noise_mode=mode, interpret=True,
        row_tile=ROW_TILE, emit_delta=False, compute_dtype=chain)
    return [np.asarray(x) for x in res]


def reference_models(cases, prefix: str) -> dict:
    """The JAX deferred ``LdaModel`` (``pallas_interpret=True``) of each
    (chain, snapshot) in ``cases``, under this process's flags and
    lowerings: ``{prefix}/{chain}/{mirror}/{table}`` after the last sweep,
    ``.../z{s}`` after each sweep, and ``init/*``: the common start state and
    each sweep's uniforms."""
    import jax
    import jax.numpy as jnp

    from ldagibbssampling_tpu.config import LdaConfig
    from ldagibbssampling_tpu.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu.models.lda import LdaModel

    tw, td, ptr = model_corpus()
    fc = FlatCorpus(tw, td, ptr, MODEL_V)
    out = {}
    for chain, mirror in cases:
        key = f"{prefix}/{chain}/{mirror}"
        model = LdaModel(LdaConfig(
            topic_num=MODEL_K, seed=5, block_size=512, use_pallas="deferred",
            pallas_interpret=True, kernel_compute_dtype=chain,
            mirror_dtype=mirror), fc)
        assert model.kernel_tier == "deferred"
        st = model.state
        if "init/z" not in out:  # the same seed: every case starts here
            for name in ("z", "ndk", "nwk", "nk"):
                out[f"init/{name}"] = np.asarray(getattr(st, name))
            t_pad, k_pad = st.z.shape[0], 128
            for s in range(MODEL_SWEEPS):
                out[f"init/u{s}"] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(st.key, s), (t_pad, k_pad),
                    jnp.float32, minval=1e-7, maxval=1.0 - 1e-7))
        assert np.array_equal(np.asarray(st.z), out["init/z"])
        for s in range(MODEL_SWEEPS):
            model.sweep(1)
            out[f"{key}/z{s}"] = np.asarray(model.state.z)
        for name in ("z", "ndk", "nwk", "nk"):
            out[f"{key}/{name}"] = np.asarray(getattr(model.state, name))
    return out


def _reference_main(what: str, out_path: str) -> None:
    """The subprocess, with excess precision off: the bf16 chains' reference
    with its own approx-reciprocal lowering (``unpinned/``), then with that
    lowering pinned to the float32 quotient (``pinned/``)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from jax._src.interpreters import mlir
    from jax._src.pallas import primitives as pl_primitives

    out = {}
    # does this process compute a jitted bf16 chain op by op?
    rng = np.random.default_rng(0)
    a, b, c = (jnp.asarray(rng.uniform(1, 40, 4096), jnp.bfloat16)
               for _ in range(3))
    jitted = jax.jit(lambda a, b, c: (a * b * c).astype(jnp.float32))(a, b, c)
    per_op = ((a * b) * c).astype(jnp.float32)  # eager: one rounding per op
    out["per_op_chain"] = np.array(bool(jnp.all(jitted == per_op)))

    def run(prefix):
        if what == "kernel":
            for case in BF16_CASES:
                key = f"{prefix}/" + "/".join(case)
                z, slab, nk = reference_kernel_case(case)
                out[f"{key}/z"], out[f"{key}/ndk"], out[f"{key}/nk"] = z, slab, nk
        else:
            out.update(reference_models(BF16_MODEL_CASES, prefix))

    run("unpinned")

    def _reciprocal(ctx, x, *, approx=False):
        def f(x, *, approx=False):
            if approx:  # the float32 quotient of the bf16-cast input
                return jnp.reciprocal(x.astype(jnp.bfloat16).astype(jnp.float32))
            return jnp.reciprocal(x)
        return mlir.lower_fun(f, multiple_results=False)(ctx, x, approx=approx)

    mlir.register_lowering(pl_primitives.reciprocal_p, _reciprocal)
    jax.clear_caches()
    run("pinned")
    np.savez(out_path, **out)


def run_without_excess_precision(script, *args: str) -> None:
    """Run ``script`` (a test file run as a script) in a subprocess with
    ``JAX_PLATFORMS=cpu`` and XLA's excess precision off."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, str(script), *args], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def run_reference(what: str, tmp_dir: Path) -> dict:
    """The bf16 chains' reference results for ``what`` ("kernel" or
    "model"), from one subprocess with excess precision off."""
    out = tmp_dir / f"ref_{what}.npz"
    run_without_excess_precision(__file__, what, str(out))
    with np.load(out) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("kernel", tmp_path_factory.mktemp("chains"))


def _reference_result(reference, case, variant):
    """``(z, ndk [D_LOC, K], nk [K])`` of the reference for ``case``:
    ``default`` computed here, ``pinned``/``unpinned`` from the subprocess."""
    if variant == "default":
        z, ndk, nk = reference_kernel_case(case)
    else:
        key = f"{variant}/" + "/".join(case)
        z, ndk, nk = (reference[f"{key}/{n}"] for n in ("z", "ndk", "nk"))
    return z, ndk[:, :K].astype(np.int32), nk[0, :K].astype(np.int32)


def _moved_counts(case, z):
    """The case's doc slab and topic totals with every unmasked token moved
    from its old topic to its topic in ``z``."""
    _, slab, nk, zold, d_local, msk, _ = kernel_inputs(_seed(case))
    real = msk > 0
    slab, nk = slab[:, :K].astype(np.int32), nk[0, :K].astype(np.int32)
    for sign, topic in ((-1, zold[real]), (1, z[real])):
        np.add.at(slab, (d_local[real], topic), sign)
        np.add.at(nk, topic, sign)
    return slab, nk


def _port(case):
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

    chain, rows_dtype, mode = case
    rows, slab, nk, zold, d_local, msk, u = kernel_inputs(_seed(case))
    ndk = torch.from_numpy(slab[:, :K].astype(np.int32))
    nk_t = torch.from_numpy(nk[0, :K].astype(np.int32))
    znew = fk.gibbs_tiles(
        torch.from_numpy(rows).to(getattr(torch, rows_dtype)), ndk, nk_t,
        torch.from_numpy(zold), torch.arange(B, dtype=torch.int32),
        torch.from_numpy(d_local), torch.from_numpy(msk),
        scalars=torch.from_numpy(K1_SCALARS), row_tile=ROW_TILE, noise_mode=mode,
        uniforms=torch.from_numpy(u) if mode == "external" else None,
        compute_dtype=chain)
    return znew.numpy(), ndk.numpy(), nk_t.numpy()


def test_reference_computes_the_chain_op_by_op(reference):
    assert bool(reference["per_op_chain"])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_chain_matches_reference(reference, case):
    variant = "default" if case[0] == "float32" else "pinned"
    z_ref, ndk_ref, nk_ref = _reference_result(reference, case, variant)
    z, ndk, nk = _port(case)
    real = kernel_inputs(_seed(case))[5] > 0
    match = float((z[real] == z_ref[real]).mean())
    assert match >= 0.999, match
    assert match == 1.0  # exact for these seeds (see the module docstring)
    np.testing.assert_array_equal(z, z_ref)
    np.testing.assert_array_equal(ndk, ndk_ref)
    np.testing.assert_array_equal(nk, nk_ref)
    assert (z[real] != kernel_inputs(_seed(case))[3][real]).any()


@pytest.mark.parametrize("case,variant",
                         [(c, v) for c in BF16_CASES for v in VARIANTS],
                         ids=["-".join((*c, v)) for c in BF16_CASES for v in VARIANTS])
def test_bf16_chain_near_unpinned_reference(reference, case, variant):
    z_ref, ndk_ref, nk_ref = _reference_result(reference, case, variant)
    z = _port(case)[0]
    real = kernel_inputs(_seed(case))[5] > 0
    differ = int((z[real] != z_ref[real]).sum())
    print(f"{'/'.join(case)} {variant}: {differ} of {int(real.sum())} draws differ")
    assert differ <= 1
    ndk_want, nk_want = _moved_counts(case, z_ref)
    np.testing.assert_array_equal(ndk_ref, ndk_want)
    np.testing.assert_array_equal(nk_ref, nk_want)


def test_bf16_chains_draw_differently_from_float32():
    # the chains are different chains: on the same inputs some draw differs
    z = {c: _port((c, "float32", "external"))[0] for c in CHAINS}
    assert (z["bfloat16"] != z["float32"]).any()
    assert (z["bf16p"] != z["float32"]).any()


def test_float32_rows_equal_live_table_in_float32_chain():
    # exact counts: the float32 chain on a float32 snapshot draws what it
    # draws on the live int32 table with the same counts
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

    rows, slab, nk, zold, d_local, msk, u = kernel_inputs(40)
    common = (torch.from_numpy(slab[:, :K].astype(np.int32)),
              torch.from_numpy(nk[0, :K].astype(np.int32)),
              torch.from_numpy(zold), torch.arange(B, dtype=torch.int32),
              torch.from_numpy(d_local), torch.from_numpy(msk))
    kw = dict(scalars=torch.from_numpy(K1_SCALARS), noise_mode="external",
              uniforms=torch.from_numpy(u))
    z32 = fk.sample_plain(torch.from_numpy(rows), *common, **kw)
    zlive = fk.sample_plain(torch.from_numpy(rows[:, :K].astype(np.int32)),
                            *common, **kw)
    assert torch.equal(z32, zlive)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
