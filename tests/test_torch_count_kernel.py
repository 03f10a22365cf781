"""K2's plain version against the reference rebuild kernel in Pallas
interpret mode (``build_nwk(..., emit_mirror=True, interpret=True)``).

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
from ldagibbssampling_tpu_torch.ops import count_kernel as ck

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


def _reference(plan, z, k_pad):
    nt = plan.tile_stripe.shape[0]
    wl8 = jax_ck.replicate_rows(jnp.asarray(plan.w_local.reshape(nt, plan.tile)))
    nwk, nk, mirror = jax_ck.build_nwk(
        jnp.asarray(z), jnp.asarray(plan.row_gather_idx), wl8,
        jnp.asarray(plan.tile_stripe), v_loc=plan.v_loc, v_pad=plan.v_pad,
        k_pad=k_pad, tile=plan.tile, interpret=True, emit_mirror=True,
    )
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
