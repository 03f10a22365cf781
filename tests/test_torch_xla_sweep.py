"""The port's XLA tier (``use_pallas=False``, gumbel and inverse_cdf draws)
and v1-draw tier (``use_pallas=True``) against the JAX package's
``make_sweep_fn`` from the same state, the port fed the reference's own noise
rebuilt from the JAX state's key (``ldagibbssampling_tpu/ops/gibbs.py``):

- XLA gumbel: ``gumbel(fold_in(fold_in(key, sweep), i), (B, K))`` (:205-207);
- inverse_cdf: ``uniform(fold_in(fold_in(key, sweep), i), (B,))`` (:220-222);
- v1 under interpret: ``uniform(fold_in(sweep_key, i), (B, K), 1e-7,
  1 - 1e-7)`` (:177-181).

Tolerances: the count tables must equal the recount of the port's own ``z``
(exact, always).  ``z`` must match the reference's on at least 99.9% of the
tokens: XLA's and PyTorch's float32 ``log`` differ by one ulp on some CPU
inputs, and the gumbel draws take three or four of them per element, so a
near-tie can flip and the chains then drift apart.  For the seeds below the
match is exact, and then the tables must equal the reference's too.  The
fidelity path (block 1, inverse_cdf, float64, the oracle's uniforms) is
bitwise: ``z`` equals both oracles' after every sweep.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.models.oracle import OracleSampler as JaxOracleSampler
from ldagibbssampling_tpu.models.state import init_state as jax_init_state
from ldagibbssampling_tpu.ops.gibbs import gibbs_sweep as jax_gibbs_sweep
from ldagibbssampling_tpu.ops.gibbs import make_sweep_fn as jax_make_sweep_fn
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.oracle import OracleSampler
from ldagibbssampling_tpu_torch.models.state import SamplerState
from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep, make_sweep_fn

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K = 7
V = 300


def _setup(seed, block, num_docs=40, t_target=3000):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t_target) - 1) % V).astype(np.int32)
    td = (np.arange(t_target, dtype=np.int64) * num_docs // t_target).astype(np.int32)
    ptr = np.zeros(num_docs + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=num_docs), out=ptr[1:])
    pc, _ = FlatCorpus(tw, td, ptr, V).pad_to(block).sort_within_blocks(block)
    jst = jax_init_state(pc.token_word, pc.token_doc, pc.token_mask,
                         num_docs=num_docs, vocab_size=V, num_topics=K, seed=seed)
    return pc, np.diff(ptr), jst


def _recount(pc, z, m):
    real = pc.token_mask > 0
    nwk = np.zeros((V, K), np.int64)
    ndk = np.zeros((m, K), np.int64)
    np.add.at(nwk, (pc.token_word[real], z[real]), 1)
    np.add.at(ndk, (pc.token_doc[real], z[real]), 1)
    return ndk, nwk


def _jax_noise(jst, block, nb, draw):
    """``noise(sweep)``: the reference's noise for every block of a sweep."""
    def noise(sweep):
        sweep_key = jax.random.fold_in(jst.key, sweep)
        parts = []
        for i in range(nb):
            key = jax.random.fold_in(sweep_key, i)
            if draw == "gumbel":
                x = jax.random.gumbel(key, (block, K), jnp.float32)
            elif draw == "inverse_cdf":
                x = jax.random.uniform(key, (block,), jnp.float32)
            else:  # the v1 kernel's uniforms under interpret
                x = jax.random.uniform(key, (block, K), minval=1e-7,
                                       maxval=1.0 - 1e-7, dtype=jnp.float32)
            parts.append(np.asarray(x))
        return torch.from_numpy(np.concatenate(parts))
    return noise


def _port_state(jst):
    return interop.from_jax_state(
        {n: np.asarray(getattr(jst, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")}, device="cpu")


@pytest.mark.parametrize("use_pallas,draw,seed,block,sweeps", [
    (False, "gumbel", 0, 512, 2),
    (False, "gumbel", 1, 128, 1),
    (False, "inverse_cdf", 2, 512, 2),
    (True, "gumbel", 3, 512, 2),
    (True, "gumbel", 4, 256, 1),
])
def test_sweeps_match_reference(use_pallas, draw, seed, block, sweeps):
    pc, dl, jst = _setup(seed, block)
    ref = jax_make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=block, draw_method=draw, num_sweeps=sweeps,
        use_pallas=use_pallas, pallas_interpret=True, sorted_words=True)(jst)
    run = make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=block, draw_method=draw, num_sweeps=sweeps,
        use_pallas=use_pallas, num_topics=K, noise_mode="external", device="cpu")
    assert run.kernel_tier == ("pallas-draw" if use_pallas else "xla")
    nb = pc.num_tokens // block
    noise = _jax_noise(jst, block, nb, "v1" if use_pallas else draw)
    out = run(_port_state(jst), noise=noise)
    assert out.sweep == sweeps == int(ref.sweep)
    z = out.z.numpy()
    ndk, nwk = _recount(pc, z, dl.shape[0])
    np.testing.assert_array_equal(out.ndk.numpy(), ndk)
    np.testing.assert_array_equal(out.nwk.numpy(), nwk)
    np.testing.assert_array_equal(out.nk.numpy(), nwk.sum(axis=0))
    real = pc.token_mask > 0
    z_ref = np.asarray(ref.z)
    np.testing.assert_array_equal(z[~real], z_ref[~real])
    match = float((z[real] == z_ref[real]).mean())
    assert match >= 0.999, match
    assert match == 1.0  # exact for these seeds (see the module docstring)
    for name in ("ndk", "nwk", "nk"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("use_pallas,draw", [
    (False, "gumbel"), (False, "inverse_cdf"), (True, "gumbel")])
def test_internal_noise_counts_consistent_and_seeded(use_pallas, draw):
    pc, dl, jst = _setup(5, 256)
    st = _port_state(jst)
    run = make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=256, draw_method=draw, num_sweeps=2, use_pallas=use_pallas,
        num_topics=K, device="cpu")
    a = run(st, generator=torch.Generator().manual_seed(3))
    b = run(st, generator=torch.Generator().manual_seed(3))
    c = run(st, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.z, b.z) and not torch.equal(a.z, c.z)
    ndk, nwk = _recount(pc, a.z.numpy(), dl.shape[0])
    np.testing.assert_array_equal(a.ndk.numpy(), ndk)
    np.testing.assert_array_equal(a.nwk.numpy(), nwk)
    real = pc.token_mask > 0
    np.testing.assert_array_equal(a.z.numpy()[~real], st.z.numpy()[~real])
    assert np.array_equal(st.z.numpy(), np.asarray(jst.z))  # input untouched


def test_deterministic_gumbel_is_the_argmax_of_the_conditional():
    # no noise: the XLA and v1 draws are both the argmax of the conditional
    pc, dl, jst = _setup(6, 512)
    outs = [make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=512, use_pallas=up, num_topics=K,
        noise_mode="deterministic", device="cpu")(_port_state(jst)) for up in (False, True)]
    assert torch.equal(outs[0].z, outs[1].z)
    with pytest.raises(ValueError, match="deterministic"):
        make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask, dl,
                      alpha=0.5, beta=0.1, block_size=512, use_pallas=False,
                      draw_method="inverse_cdf", num_topics=K,
                      noise_mode="deterministic", device="cpu")(_port_state(jst))


def test_vocab_size_override_matches_reference():
    # V·β from a given vocabulary size (the reference's sharded-slab hook)
    pc, dl, jst = _setup(7, 512)
    arrays = [np.asarray(a) for a in (pc.token_word, pc.token_doc, pc.token_mask)]
    ref = jax_gibbs_sweep(jst, *(jnp.asarray(a) for a in arrays), jnp.asarray(dl),
                          alpha=0.5, beta=0.1, block_size=512, vocab_size=4 * V)
    out = gibbs_sweep(
        _port_state(jst), *(torch.from_numpy(a) for a in arrays),
        alpha=0.5, beta=0.1, block_size=512, vocab_size=4 * V,
        noise_mode="external",
        noise=_jax_noise(jst, 512, pc.num_tokens // 512, "gumbel")(0))
    np.testing.assert_array_equal(out.z.numpy(), np.asarray(ref.z))
    np.testing.assert_array_equal(out.nwk.numpy(), np.asarray(ref.nwk))


_RAGGED = [[0, 1, 2, 1], [2, 3, 3, 0, 1], [4, 4, 0], [1, 2, 4, 3, 3, 0]]


def test_block1_inverse_cdf_bit_matches_both_oracles():
    """The port of ``tests/test_gibbs.py:80``: block 1 + inverse_cdf +
    float64 + the oracle's own uniforms reproduces the serial chain, token
    for token, of the port's oracle and of the JAX package's."""
    fc = FlatCorpus.from_ragged(_RAGGED, vocab_size=5)
    jfc = JaxFlatCorpus.from_ragged(_RAGGED, vocab_size=5)
    oracle = OracleSampler(fc, num_topics=3, seed=42)
    joracle = JaxOracleSampler(jfc, num_topics=3, seed=42)
    np.testing.assert_array_equal(oracle.z, joracle.z)
    state = SamplerState(*(torch.from_numpy(np.asarray(a, np.int32)) for a in (
        oracle.z, oracle.ndk, oracle.nwk, oracle.nk)))
    tw, td = torch.from_numpy(fc.token_word), torch.from_numpy(fc.token_doc)
    tm = torch.ones_like(tw)
    dl = torch.from_numpy(fc.doc_lengths())
    for sweep in range(3):
        # continue the oracle's JavaRandom stream for this sweep's draws,
        # then rewind so oracle.sweep consumes the SAME draws internally
        saved = oracle.rng._seed
        uniforms = torch.tensor(
            [oracle.rng.next_double() for _ in range(fc.num_tokens)],
            dtype=torch.float64)
        state = gibbs_sweep(
            state, tw, td, tm, dl, alpha=0.5, beta=0.1, block_size=1,
            draw_method="inverse_cdf", prob_dtype=torch.float64,
            noise_mode="external", noise=uniforms)
        oracle.rng._seed = saved
        oracle.sweep(1)
        joracle.sweep(1)
        np.testing.assert_array_equal(state.z.numpy(), oracle.z,
                                      err_msg=f"diverged at sweep {sweep}")
        np.testing.assert_array_equal(state.z.numpy(), joracle.z)
    np.testing.assert_array_equal(state.nwk.numpy(), oracle.nwk)
    np.testing.assert_array_equal(state.ndk.numpy(), joracle.ndk)
