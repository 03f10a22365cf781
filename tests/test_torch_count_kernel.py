"""K2's plain version against the reference rebuild kernel in Pallas
interpret mode (``build_nwk(..., emit_mirror=True, interpret=True)``).

Also ``emit_mirror=False``, the float32-snapshot path: ``nwk`` and ``nk``
alone.

Tolerance: none.  ``nwk``, ``nk`` and the bf16 mirror are bitwise equal:
both sides count integers exactly (float32 below 2^24 in the reference,
int32 here) and round them to bf16 to nearest-even.  The assignments are
skewed so that cells exceed 256 and the bf16 rounding is exercised."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ldagibbssampling_tpu.ops import count_kernel as jax_ck
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.ops import count_kernel as ck

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K = 7
V = 300


def _plan_and_z(seed, t=4000, **plan_kw):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t) - 1) % V).astype(np.int32)
    td = (np.arange(t) * 60 // t).astype(np.int32)
    plan = ck.plan_deferred(tw, td, V, 512, **plan_kw)
    p = np.array([0.7, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03])
    z = rng.choice(K, size=plan.num_tokens, p=p).astype(np.int32)
    return plan, z


def _reference(plan, z, k_pad, emit_mirror=True):
    nt = plan.tile_stripe.shape[0]
    wl8 = jax_ck.replicate_rows(jnp.asarray(plan.w_local.reshape(nt, plan.tile)))
    out = jax_ck.build_nwk(
        jnp.asarray(z), jnp.asarray(plan.row_gather_idx), wl8,
        jnp.asarray(plan.tile_stripe), v_loc=plan.v_loc, v_pad=plan.v_pad,
        k_pad=k_pad, tile=plan.tile, interpret=True, emit_mirror=emit_mirror,
    )
    if not emit_mirror:
        return np.asarray(out[0]), np.asarray(out[1])
    nwk, nk, mirror = out
    return np.asarray(nwk), np.asarray(nk), np.asarray(mirror.astype(jnp.float32))


@pytest.mark.parametrize("seed,plan_kw", [(0, dict(v_loc=64, tile=128)), (1, dict())])
def test_build_nwk_bitwise_equals_reference(seed, plan_kw):
    plan, z = _plan_and_z(seed, **plan_kw)
    nwk_ref, nk_ref, mirror_ref = _reference(plan, z, 128)
    assert nwk_ref.max() > 256  # the bf16 rounding is exercised
    nwk, nk, mirror = ck.build_nwk(
        torch.from_numpy(z), torch.from_numpy(plan.token_word),
        torch.from_numpy(plan.token_mask), vocab_size=V, num_topics=K,
        v_pad=plan.v_pad, k_pad=128)
    assert nwk.shape == (V, K) and nk.shape == (K,)
    assert mirror.shape == (plan.v_pad, 128) and mirror.dtype == torch.bfloat16
    np.testing.assert_array_equal(nwk.numpy(), nwk_ref[:V, :K].astype(np.int32))
    np.testing.assert_array_equal(nk.numpy(), nk_ref[:K].astype(np.int32))
    np.testing.assert_array_equal(mirror.float().numpy(), mirror_ref)


@pytest.mark.parametrize("seed,plan_kw", [(6, dict(v_loc=64, tile=128)), (7, dict())])
def test_build_nwk_without_mirror_equals_reference(seed, plan_kw):
    # the float32-snapshot path: the rebuild alone, no bf16 snapshot
    plan, z = _plan_and_z(seed, **plan_kw)
    ref = _reference(plan, z, 128, emit_mirror=False)
    assert len(ref) == 2
    before = tracing.counters()
    out = ck.build_nwk(
        torch.from_numpy(z), torch.from_numpy(plan.token_word),
        torch.from_numpy(plan.token_mask), vocab_size=V, num_topics=K,
        v_pad=plan.v_pad, k_pad=128, emit_mirror=False)
    assert len(out) == 2
    after = tracing.counters()
    for name, calls in (("plain.cast_mirror", 0), ("plain.rebuild_counts", 1)):
        assert after.get(name, 0) == before.get(name, 0) + calls
    nwk, nk = out
    np.testing.assert_array_equal(nwk.numpy(), ref[0][:V, :K].astype(np.int32))
    np.testing.assert_array_equal(nk.numpy(), ref[1][:K].astype(np.int32))


def test_rebuild_padded_tables_equal_reference():
    plan, z = _plan_and_z(2)
    nwk_ref, nk_ref, _ = _reference(plan, z, 128)
    nwk, nk = ck.rebuild_counts(
        torch.from_numpy(z), torch.from_numpy(plan.token_word),
        torch.from_numpy(plan.token_mask), v_pad=plan.v_pad, k_pad=128)
    np.testing.assert_array_equal(nwk.numpy(), nwk_ref.astype(np.int32))
    np.testing.assert_array_equal(nk.numpy(), nk_ref.astype(np.int32))


def test_cast_mirror_rounds_like_reference():
    # every cell value below 2^24 that bf16 cannot hold exactly rounds to
    # nearest-even, as the reference's f32 -> bf16 cast
    rng = np.random.default_rng(3)
    x = np.concatenate([np.arange(0, 70000), rng.integers(0, 1 << 24, 200000)])
    x = x.astype(np.int32)[: 128 * (x.size // 128)].reshape(-1, 128)
    want = np.asarray(jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = ck.cast_mirror(torch.from_numpy(np.ascontiguousarray(x)))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_masked_tokens_are_not_counted():
    plan, z = _plan_and_z(4)
    word = torch.from_numpy(plan.token_word)
    mask = torch.from_numpy(plan.token_mask)
    nwk, nk = ck.rebuild_counts(torch.from_numpy(z), word, mask,
                                v_pad=plan.v_pad, k_pad=128)
    assert int(nk.sum()) == int(plan.token_mask.sum())
    z2 = z.copy()
    z2[plan.token_mask == 0] = 3  # moving padding changes nothing
    nwk2, nk2 = ck.rebuild_counts(torch.from_numpy(z2), word, mask,
                                  v_pad=plan.v_pad, k_pad=128)
    assert torch.equal(nwk, nwk2) and torch.equal(nk, nk2)


def test_wrappers_reject_bad_inputs():
    plan, z = _plan_and_z(5)
    word = torch.from_numpy(plan.token_word)
    mask = torch.from_numpy(plan.token_mask)
    with pytest.raises(ValueError, match="int32"):
        ck.rebuild_counts(torch.from_numpy(z).long(), word, mask,
                          v_pad=plan.v_pad, k_pad=128)
    with pytest.raises(ValueError, match="k_pad"):
        ck.rebuild_counts(torch.from_numpy(z), word, mask,
                          v_pad=plan.v_pad, k_pad=100)
    with pytest.raises(ValueError, match="int32"):
        ck.cast_mirror(torch.zeros((8, 128), dtype=torch.float32))


def test_rebuild_and_cast_write_into_given_tables():
    """``out=`` (the captured deferred sweep's padded tables and snapshot):
    the same values written into the given tensors, which are returned;
    a table of another shape, type or layout is refused."""
    plan, z = _plan_and_z(6)
    zt, word, mask = (torch.from_numpy(a) for a in (z, plan.token_word,
                                                      plan.token_mask))
    nwk, nk = ck.rebuild_counts(zt, word, mask, v_pad=plan.v_pad, k_pad=128)
    out = (torch.full((plan.v_pad, 128), 7, dtype=torch.int32),
           torch.full((128,), 7, dtype=torch.int32))
    got = ck.rebuild_counts(zt, word, mask, v_pad=plan.v_pad, k_pad=128, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], nwk) and torch.equal(out[1], nk)
    mirror = torch.empty((plan.v_pad, 128), dtype=torch.bfloat16)
    assert ck.cast_mirror(nwk, out=mirror) is mirror
    assert torch.equal(mirror, ck.cast_mirror(nwk))
    with pytest.raises(ValueError, match="nk"):
        ck.rebuild_counts(zt, word, mask, v_pad=plan.v_pad, k_pad=128,
                          out=(out[0], out[1][:K]))
    with pytest.raises(ValueError, match="contiguous"):
        ck.rebuild_counts(zt, word, mask, v_pad=plan.v_pad, k_pad=128,
                          out=(out[0].t().contiguous().t(), out[1]))
    with pytest.raises(ValueError, match="bfloat16"):
        ck.cast_mirror(nwk, out=torch.empty((plan.v_pad, 128)))
