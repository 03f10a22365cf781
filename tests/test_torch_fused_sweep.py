"""Fused-tier sweeps of the port against the JAX package's
``make_sweep_fn(use_pallas="fused", pallas_interpret=True)`` from the same
state and layout (``pad_to`` + ``sort_within_blocks``), the port fed the
reference's own external uniforms, ``uniform(fold_in(key, sweep), (T_pad,
k_pad), 1e-7, 1 - 1e-7)`` (``ldagibbssampling_tpu/ops/gibbs.py:365-370``).

Tolerances: the count tables must equal the recount of the port's own ``z``
(exact, always).  ``z`` must match the reference's on at least 99.9% of the
tokens: XLA's and PyTorch's float32 ``log`` differ by one ulp on some CPU
inputs, which can move the bf16 rounding of ``-log u`` and flip a near-tie.
For the seeds below the match is exact, and then the tables must equal the
reference's too."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.models.state import init_state as jax_init_state
from ldagibbssampling_tpu.ops.gibbs import make_sweep_fn as jax_make_sweep_fn
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
from ldagibbssampling_tpu_torch.ops._device import seed_word, sweep_scalars
from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

K = 7
V = 300


def _setup(seed, block, t_target, num_docs=60):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t_target) - 1) % V).astype(np.int32)
    td = (np.arange(t_target, dtype=np.int64) * num_docs // t_target).astype(np.int32)
    ptr = np.zeros(num_docs + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=num_docs), out=ptr[1:])
    pc, _ = FlatCorpus(tw, td, ptr, V).pad_to(block).sort_within_blocks(block)
    jst = jax_init_state(pc.token_word, pc.token_doc, pc.token_mask,
                         num_docs=num_docs, vocab_size=V, num_topics=K, seed=seed)
    return pc, np.diff(ptr), jst


def _port_state(jst):
    return interop.from_jax_state(
        {n: np.asarray(getattr(jst, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")}, device="cpu")


@pytest.mark.parametrize("seed,block,t_target,tiles", [
    (0, 4096, 12000, 2),   # two row tiles per block: tiles run in order
    (1, 1301, 1301, 1),    # no multiple-of-8 tile: one tile of the block
])
def test_fused_sweeps_match_reference(seed, block, t_target, tiles):
    pc, dl, jst = _setup(seed, block, t_target)
    ref = jax_make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=block, num_sweeps=2, use_pallas="fused",
        pallas_interpret=True, sorted_words=True, num_topics=K)(jst)
    run = make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=block, num_sweeps=2, use_pallas="fused", num_topics=K,
        noise_mode="external", device="cpu")
    assert run.kernel_tier == "fused" and block // run.row_tile == tiles
    t_pad = pc.num_tokens

    def noise(sweep):
        key = jax.random.fold_in(jst.key, sweep)
        return torch.from_numpy(np.asarray(jax.random.uniform(
            key, (t_pad, 128), jnp.float32, minval=1e-7, maxval=1.0 - 1e-7)))

    calls = tracing.counters()
    out = run(_port_state(jst), noise=noise)
    # per sweep and block: one ndk/nk move per tile, then the nwk move
    nb = t_pad // block
    moved = {n: tracing.counters().get(n, 0) - calls.get(n, 0)
             for n in ("plain.gibbs_tile_update", "plain.count_move")}
    assert moved == {"plain.gibbs_tile_update": 2 * nb * tiles,
                     "plain.count_move": 2 * nb}
    assert out.sweep == 2 == int(ref.sweep)
    z = out.z.numpy()
    real = pc.token_mask > 0
    nwk = np.zeros((V, K), np.int64)
    ndk = np.zeros((dl.shape[0], K), np.int64)
    np.add.at(nwk, (pc.token_word[real], z[real]), 1)
    np.add.at(ndk, (pc.token_doc[real], z[real]), 1)
    np.testing.assert_array_equal(out.ndk.numpy(), ndk)
    np.testing.assert_array_equal(out.nwk.numpy(), nwk)
    np.testing.assert_array_equal(out.nk.numpy(), nwk.sum(axis=0))
    z_ref = np.asarray(ref.z)
    match = float((z[real] == z_ref[real]).mean())
    assert match >= 0.999, match
    assert match == 1.0  # exact for these seeds (see the module docstring)
    for name in ("ndk", "nwk", "nk"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_block_reads_the_block_start_table():
    # the word-topic moves land after the block's last tile: drawing a block
    # against the live table must not see moves of the block's earlier tiles,
    # so the fused chain differs from one that applies nwk moves per tile
    pc, dl, jst = _setup(2, 4096, 12000)
    run = make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=4096, use_pallas="fused", num_topics=K,
        noise_mode="internal", device="cpu")
    st = _port_state(jst)
    a = run(st, generator=torch.Generator().manual_seed(5))
    b = run(st, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.z, b.z) and torch.equal(a.nwk, b.nwk)
    np.testing.assert_array_equal(st.nwk.numpy(), np.asarray(jst.nwk))
    # a per-tile nwk walk, by hand, from the same seed
    seed = int(torch.randint(0, 2**63 - 1, (),
                             generator=torch.Generator().manual_seed(5)))
    z, ndk, nwk, nk = (getattr(st, n).clone() for n in ("z", "ndk", "nwk", "nk"))
    tw, td, tm = (torch.from_numpy(x) for x in (pc.token_word, pc.token_doc,
                                                 pc.token_mask))
    for s in range(0, pc.num_tokens, 2048):
        sl = slice(s, s + 2048)
        zn = fk.gibbs_tiles(nwk, ndk, nk, z[sl], tw[sl], td[sl], tm[sl],
                            scalars=torch.from_numpy(sweep_scalars(0.5, 0.1, V, K)),
                            key=torch.tensor([seed_word(seed)]),
                            row_tile=2048, slot0=s)
        fk.count_move(z[sl], zn, tm[sl], nwk=nwk, token_word=tw[sl])
        z[sl] = zn
    assert not torch.equal(z, a.z)
