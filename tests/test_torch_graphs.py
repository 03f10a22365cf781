"""The captured sweeps (``ops/graphs.SweepGraph``: ``ops/gibbs.xla_sweep_graph``,
``draw_sweep_graph``, ``fused_sweep_graph`` and ``deferred_sweep_graph``)
run eagerly on the CPU, as the CPU runs them: the same body over the
graph's static buffers, α, β, V·β and K·α read from its ``params``
tensor, the seeds from its generators or its ``params``.

Against the JAX package's ``gibbs_sweep`` and ``make_sweep_fn``'s
``run(state, alpha, beta)`` from the same state, the port fed the
reference's own noise (gumbel: rebuilt from the JAX state's key;
``inverse_cdf``: the same uniforms given to both), with α and β changed
between calls.  Tolerances as in ``tests/test_torch_xla_sweep.py``: the
tables always equal the recount of the port's ``z``; ``z`` is exact for the
seeds below (XLA's and PyTorch's float32 ``log`` may differ by an ulp on
other inputs), and then every table equals the reference's.  Within the
port everything is bitwise: the batched graph against each chain alone,
the graphs against the eager sweeps, K3's plain version and its wrapper on
the scalar tensors against the formula on α, β and Vβ given by value.  The card's captured replays against
eager are ``tests/test_torch_cuda.py``'s ``cuda`` cases.

The kernel tiers: the deferred graph (the six (chain, snapshot) settings)
and the fused graph through ``make_sweep_fn`` against the eager
``_deferred_sweep_impl`` / ``fused_gibbs_sweep`` loop, bitwise, the
snapshot carried across calls; the same runs against the JAX package's
``make_sweep_fn(use_pallas="deferred"|"fused")`` with its Pallas kernels
interpreted (external noise; the deterministic mode through the sweep
functions it loops over), at ``tests/test_torch_deferred_sweep.py``'s
tolerance; and K1's plain walk and wrapper on the ``scalars``/``key``
tensors against the walk on α, β, Vβ and the seed by value, bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldagibbssampling_tpu.models.state import init_state as jax_init_state
from ldagibbssampling_tpu.ops.gibbs import gibbs_sweep as jax_gibbs_sweep
from ldagibbssampling_tpu.ops.gibbs import make_sweep_fn as jax_make_sweep_fn
from ldagibbssampling_tpu_torch import interop
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.models.chains import ChainSet
from ldagibbssampling_tpu_torch.models.state import SamplerState, init_state
from ldagibbssampling_tpu_torch.ops import _device, graphs
from ldagibbssampling_tpu_torch.ops import count_kernel as ck
from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
from ldagibbssampling_tpu_torch.ops.gibbs import (
    _deferred_sweep_impl, deferred_local_counts, draw_sweep_graph,
    fused_gibbs_sweep, gibbs_sweep, gibbs_sweep_chains, make_sweep_fn,
    snapshot, sweep_seed, xla_sweep_graph)

torch.set_num_threads(1)

K, V, M = 7, 300, 40
HYPERS = ((0.5, 0.1), (0.3, 0.25))  # α, β of the first call, then the second


def _setup(seed, block, t_target=3000):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t_target) - 1) % V).astype(np.int32)
    td = (np.arange(t_target, dtype=np.int64) * M // t_target).astype(np.int32)
    ptr = np.zeros(M + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=M), out=ptr[1:])
    pc, _ = FlatCorpus(tw, td, ptr, V).pad_to(block).sort_within_blocks(block)
    jst = jax_init_state(pc.token_word, pc.token_doc, pc.token_mask,
                         num_docs=M, vocab_size=V, num_topics=K, seed=seed)
    return pc, np.diff(ptr), jst


def _tokens(pc, dl=None):
    out = [torch.from_numpy(np.asarray(a, np.int32))
           for a in (pc.token_word, pc.token_doc, pc.token_mask)]
    return out + ([] if dl is None else [torch.from_numpy(np.asarray(dl, np.int32))])


def _port_state(jst):
    return interop.from_jax_state(
        {n: np.asarray(getattr(jst, n)) for n in ("z", "ndk", "nwk", "nk", "sweep")},
        device="cpu")


def _tables(st):
    return (st.z, st.ndk, st.nwk, st.nk)


def _jax_noise(jst, block, nb, draw):
    """The reference's noise of sweep ``sweep``, every block."""
    def noise(sweep):
        sweep_key = jax.random.fold_in(jst.key, sweep)
        parts = []
        for i in range(nb):
            key = jax.random.fold_in(sweep_key, i)
            if draw == "gumbel":
                x = jax.random.gumbel(key, (block, K), jnp.float32)
            else:  # K3's uniforms under interpret
                x = jax.random.uniform(key, (block, K), minval=1e-7,
                                       maxval=1.0 - 1e-7, dtype=jnp.float32)
            parts.append(np.asarray(x))
        return torch.from_numpy(np.concatenate(parts))
    return noise


def _assert_equal(got, want, names=("z", "ndk", "nwk", "nk")):
    for g, w, name in zip(got, want, names):
        assert torch.equal(g, w), name


def _assert_matches_reference(pc, out: SamplerState, ref):
    real = pc.token_mask > 0
    z = out.z.numpy()
    nwk = np.zeros((V, K), np.int64)
    ndk = np.zeros((M, K), np.int64)
    np.add.at(nwk, (pc.token_word[real], z[real]), 1)
    np.add.at(ndk, (pc.token_doc[real], z[real]), 1)
    np.testing.assert_array_equal(out.nwk.numpy(), nwk)
    np.testing.assert_array_equal(out.ndk.numpy(), ndk)
    match = float((z[real] == np.asarray(ref.z)[real]).mean())
    assert match >= 0.999, match
    assert match == 1.0  # exact for these seeds (see the module docstring)
    for name in ("z", "ndk", "nwk", "nk"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("use_pallas,seed,block", [
    (False, 0, 512), (False, 1, 128), (True, 3, 512)])
def test_graph_sweeps_match_reference_across_an_alpha_beta_change(use_pallas,
                                                                   seed, block):
    """The XLA graph (C = 1) and the v1-draw graph on the CPU against the
    reference's ``run(state, alpha, beta, n_sweeps)``: two sweeps in one
    call, then one more at other α and β, external noise."""
    pc, dl, jst = _setup(seed, block)
    tw, td, tm = _tokens(pc)
    nb = pc.num_tokens // block
    noise = _jax_noise(jst, block, nb, "v1" if use_pallas else "gumbel")
    ref_run = jax_make_sweep_fn(
        pc.token_word, pc.token_doc, pc.token_mask, dl, alpha=0.5, beta=0.1,
        block_size=block, use_pallas=use_pallas, pallas_interpret=True,
        sorted_words=True)
    st = _port_state(jst)
    if use_pallas:
        g = draw_sweep_graph(_tables(st), tw, td, tm, block_size=block,
                             noise_mode="external")

        def call(tables, a, b, n, sweep0):
            return g(tables, a, b, n, noise=lambda i: noise(sweep0 + i))
    else:
        g = xla_sweep_graph([t[None] for t in _tables(st)], tw, td, tm,
                            block_size=block, noise_mode="external")

        def call(tables, a, b, n, sweep0):
            out = g([t[None] for t in tables], a, b, n,
                    noise=lambda i: noise(sweep0 + i)[None])
            return tuple(t[0] for t in out)
    (a0, b0), (a1, b1) = HYPERS
    ref = ref_run(jst, a0, b0, n_sweeps=2)
    out = SamplerState(*call(_tables(st), a0, b0, 2, 0), sweep=2)
    _assert_matches_reference(pc, out, ref)
    ref = ref_run(ref, a1, b1, n_sweeps=1)
    out = SamplerState(*call(_tables(out), a1, b1, 1, 2), sweep=3)
    _assert_matches_reference(pc, out, ref)


def test_inverse_cdf_graph_sweep_matches_reference_with_its_uniforms():
    pc, dl, jst = _setup(2, 512)
    tw, td, tm, dlt = _tokens(pc, dl)
    rng = np.random.default_rng(12)
    us = [rng.random(pc.num_tokens, dtype=np.float32) for _ in range(2)]
    st = _port_state(jst)
    g = xla_sweep_graph([t[None] for t in _tables(st)], tw, td, tm, dlt,
                        block_size=512, draw_method="inverse_cdf",
                        noise_mode="external")
    ref = jst
    for i, (a, b) in enumerate(HYPERS):
        ref = jax_gibbs_sweep(ref, *(jnp.asarray(x) for x in (
            pc.token_word, pc.token_doc, pc.token_mask, dl)), alpha=a, beta=b,
            block_size=512, draw_method="inverse_cdf",
            uniforms=jnp.asarray(us[i]))
        out = g([t[None] for t in _tables(st)], a, b, 1,
                noise=lambda j, i=i: torch.from_numpy(us[i])[None])
        st = SamplerState(*(t[0] for t in out), sweep=i + 1)
        _assert_matches_reference(pc, st, ref)


def test_deterministic_graph_sweeps_are_the_argmax_of_the_conditional():
    """No noise: the XLA graph, the v1-draw graph and the eager sweep give
    the argmax of the conditional, bitwise, at each call's α and β."""
    pc, dl, jst = _setup(6, 512)
    tw, td, tm = _tokens(pc)
    st = _port_state(jst)
    xla = xla_sweep_graph([t[None] for t in _tables(st)], tw, td, tm,
                          block_size=512, noise_mode="deterministic")
    draw = draw_sweep_graph(_tables(st), tw, td, tm, block_size=512,
                            noise_mode="deterministic")
    for a, b in HYPERS:
        want = gibbs_sweep(st, tw, td, tm, alpha=a, beta=b, block_size=512,
                           noise_mode="deterministic")
        got_xla = tuple(t[0] for t in xla([t[None] for t in _tables(st)], a, b, 1))
        got_draw = draw(_tables(st), a, b, 1)
        _assert_equal(got_xla, _tables(want))
        _assert_equal(got_draw, _tables(want))
        st = want


def _chain_states(pc, chains, seed=0):
    return [init_state(pc.token_word, pc.token_doc, pc.token_mask, num_docs=M,
                       vocab_size=V, num_topics=K, seed=seed + c, device="cpu")
            for c in range(chains)]


@pytest.mark.parametrize("draw", ["gumbel", "inverse_cdf"])
@pytest.mark.parametrize("noise_mode", ["internal", "external"])
def test_batched_graph_equals_each_chain_alone(draw, noise_mode):
    """Three stacked chains through one graph against each chain through a
    graph of its own and through the eager sweep: bitwise, two calls at
    other α and β."""
    pc, dl, _ = _setup(8, 256)
    tw, td, tm, dlt = _tokens(pc, dl)
    states = _chain_states(pc, 3)
    stacked = [torch.stack([getattr(s, n) for s in states])
               for n in ("z", "ndk", "nwk", "nk")]
    rng = np.random.default_rng(5)
    shape = (pc.num_tokens, K) if draw == "gumbel" else (pc.num_tokens,)
    noises = rng.gumbel(size=(3, 3) + shape).astype(np.float32)
    seeds = [[sweep_seed(torch.Generator().manual_seed(100 * c + i))
              for c in range(3)] for i in range(3)]
    kw = dict(block_size=256, draw_method=draw, noise_mode=noise_mode)
    if draw == "inverse_cdf":
        noises = rng.random((3, 3) + shape, dtype=np.float32)
    batched = xla_sweep_graph(stacked, tw, td, tm, dlt, **kw)
    out = stacked
    for (a, b), sweeps in zip(HYPERS, ((0, 1), (2,))):
        out = batched(out, a, b, len(sweeps), seeds=[seeds[i] for i in sweeps],
                      noise=lambda j, s=sweeps: torch.from_numpy(noises[s[j]]))
    for c, st in enumerate(states):
        alone = xla_sweep_graph([t[None] for t in _tables(st)], tw, td, tm, dlt, **kw)
        got, eager = [t[None] for t in _tables(st)], [t[None] for t in _tables(st)]
        for (a, b), sweeps in zip(HYPERS, ((0, 1), (2,))):
            got = alone(got, a, b, len(sweeps), seeds=[(seeds[i][c],) for i in sweeps],
                        noise=lambda j, s=sweeps: torch.from_numpy(noises[s[j], c])[None])
            for i in sweeps:
                eager = gibbs_sweep_chains(
                    *eager, tw, td, tm, dlt, alpha=a, beta=b, seeds=(seeds[i][c],),
                    noise=torch.from_numpy(noises[i, c])[None], **kw)
        _assert_equal([t[c] for t in out], [t[0] for t in got])
        _assert_equal(got, eager)


def test_scalars_are_the_reference_float32_forms():
    """α, β, V·β and K·α as the graph's ``params`` hold them, bitwise the
    reference's ``jnp.asarray(v * beta, f32)`` forms of its f32 α and β."""
    for alpha, beta, v, k in ((0.5, 0.1, 50_000, 500), (0.013, 0.71, 300, 7),
                              (1 / 3, 0.2, 20_000, 10), (50 / 7, 0.01, 99_991, 100)):
        a, b = jnp.asarray(alpha, jnp.float32), jnp.asarray(beta, jnp.float32)
        want = np.array([a, b, jnp.asarray(v * b, jnp.float32),
                         jnp.asarray(k * a, jnp.float32)], np.float32)
        got = _device.sweep_scalars(alpha, beta, v, k)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        st = init_state(np.zeros(4, np.int32), np.zeros(4, np.int32),
                        np.ones(4, np.int32), num_docs=1, vocab_size=v,
                        num_topics=k, device="cpu")
        g = graphs.SweepGraph(lambda *args: None, _tables(st), vocab_size=v,
                              num_topics=k, noise_mode="internal", device_seeds=True)
        g._write_params(alpha, beta, [2**64 - 3, 5])
        assert g.scalars.numpy().tobytes() == want.tobytes()
        assert g.params[2:5].tolist() == [0, -3, 5]  # cursor, the seeds' bits


@pytest.mark.parametrize("use_pallas", [False, True])
def test_inputs_and_returned_states_never_change(use_pallas):
    """A state passed in, and a state returned earlier, keep their values
    under later calls; a returned state modified in place is copied in
    again."""
    pc, dl, jst = _setup(9, 256)
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask, dl,
                        alpha=0.5, beta=0.1, block_size=256, use_pallas=use_pallas,
                        num_topics=K, device="cpu")
    st = _port_state(jst)
    keep = [t.clone() for t in _tables(st)]
    gen = torch.Generator().manual_seed(1)
    first = run(st, generator=gen)
    first_keep = [t.clone() for t in _tables(first)]
    second = run(first, generator=gen)        # the buffers' own state
    third = run(second, 0.2, 0.3, n_sweeps=2, generator=gen)
    _assert_equal(_tables(st), keep)
    _assert_equal(_tables(first), first_keep)
    assert not torch.equal(second.z, first.z) and not torch.equal(third.z, second.z)
    assert second.sweep == 2 and third.sweep == 4
    # the last returned state, modified in place (now first's values): the
    # next call reads it, not what the buffers still hold
    for t, f in zip(_tables(third), first_keep):
        t.copy_(f)
    again = run(third, 0.2, 0.3, n_sweeps=2,
                generator=torch.Generator().manual_seed(1))
    want = run(SamplerState(*first_keep, sweep=4), 0.2, 0.3, n_sweeps=2,
               generator=torch.Generator().manual_seed(1))
    _assert_equal(_tables(again), _tables(want))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_run_reads_alpha_beta_at_every_call(use_pallas):
    """``run(state, alpha, beta)`` as the reference's: each call's α and β
    reach its sweeps (the eager sweeps at the same values, the same seeds)."""
    pc, dl, jst = _setup(10, 256)
    tw, td, tm, dlt = _tokens(pc, dl)
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask, dl,
                        alpha=0.5, beta=0.1, block_size=256, use_pallas=use_pallas,
                        num_topics=K, device="cpu")
    st = eager = _port_state(jst)
    gen, gen_eager = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for (a, b), n in zip(HYPERS * 2, (2, 1, 1, 3)):
        st = run(st, a, b, n_sweeps=n, generator=gen)
        for _ in range(n):
            eager = gibbs_sweep(eager, tw, td, tm, dlt, alpha=a, beta=b,
                                block_size=256, use_pallas=use_pallas,
                                seed=sweep_seed(gen_eager))
        _assert_equal(_tables(st), _tables(eager))
    assert st.sweep == eager.sweep == 7


def test_device_seeds_past_one_chunk(monkeypatch):
    """The v1-draw graph's seeds go to its ``params`` in chunks: a call of
    more sweeps than a chunk holds draws each sweep with its own seed."""
    monkeypatch.setattr(graphs, "SEED_CHUNK", 2)
    pc, dl, jst = _setup(11, 512)
    tw, td, tm = _tokens(pc)
    st = eager = _port_state(jst)
    g = draw_sweep_graph(_tables(st), tw, td, tm, block_size=512)
    assert g.params.shape == (2 + 1 + 2,)
    seeds = [(s,) for s in (3, 2**63 + 5, 7, 11, 13)]
    out = g(_tables(st), 0.5, 0.1, 5, seeds=seeds)
    for (s,) in seeds:
        eager = gibbs_sweep(eager, tw, td, tm, alpha=0.5, beta=0.1,
                            block_size=512, use_pallas=True, seed=s)
    _assert_equal(out, _tables(eager))


def test_chainset_sweeps_equal_eager_batched_sweeps_across_an_alpha_change():
    """``ChainSet`` on the CPU (its graph run eagerly) against
    ``gibbs_sweep_chains`` from the same stacked state and seeds, with the
    config's α and β changed between calls."""
    import dataclasses

    rng = np.random.default_rng(3)
    fc = FlatCorpus.from_ragged(
        [[int(x) for x in rng.integers(0, 60, size=int(rng.integers(10, 50)))]
         for _ in range(20)], vocab_size=60)
    cfg = LdaConfig(topic_num=5, block_size=128, chains=3, seed=3)
    cs = ChainSet(cfg, fc, device="cpu")
    st = cs._stacks[torch.device("cpu")]
    tables = _tables(st)
    gens = [torch.Generator().set_state(g.get_state()) for g in cs.generators]
    for a, b, n in ((0.5, 0.1, 2), (0.9, 0.02, 1)):
        cs.config = dataclasses.replace(cfg, alpha=a, beta=b)
        cs.sweep(n)
        for _ in range(n):
            tables = gibbs_sweep_chains(
                *tables, *cs._tokens[torch.device("cpu")], alpha=a, beta=b,
                block_size=cs.block_size, seeds=[sweep_seed(g) for g in gens])
    _assert_equal(_tables(cs._stacks[torch.device("cpu")]), tables)
    assert st.z is not cs._stacks[torch.device("cpu")].z


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
def test_k3_plain_takes_the_scalar_tensor_as_its_by_value_form(mode):
    rng = np.random.default_rng(2)
    k, v, m, n = 13, 50, 6, 400
    nwk = torch.from_numpy(rng.integers(0, 40, (v, k)).astype(np.int32))
    ndk = torch.from_numpy(rng.integers(0, 40, (m, k)).astype(np.int32))
    nk = nwk.sum(dim=0, dtype=torch.int32)
    z = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    u = torch.from_numpy(rng.random((n, k), dtype=np.float32) * 0.99 + 0.005)
    alpha, beta, seed = 0.31, 0.07, 2**63 + 12345
    scal = _device.sweep_scalars(alpha, beta, v, k)
    # the by-value form: α, β, Vβ as float32 tensors made from Python floats,
    # the Philox uniforms of the seed's 64 bits, in the kernel's order
    f32 = torch.float32
    a, b, vb = (torch.tensor(float(x), dtype=f32) for x in scal[:3])
    e = (torch.arange(k)[None, :] == z[:, None].long()).to(f32)
    score = (torch.log(nwk[w.long()].to(f32) - e + b)
             + torch.log(ndk[d.long()].to(f32) - e + a)) - torch.log(nk.to(f32)[None, :] - e + vb)
    if mode != "deterministic":
        uni = (u if mode == "external" else
               fk.philox_uniforms(seed, 9, n, -(-k // 4) * 4, "cpu")[:, :k])
        score = score + (-torch.log(-torch.log(uni)))
    by_value = score.argmax(dim=1).to(torch.int32)
    values = dict(scalars=torch.from_numpy(scal),
                  key=torch.tensor([_device.seed_word(seed)]))
    tensors = sk.sample_block_plain(nwk, ndk, nk, z, w, d, noise_mode=mode,
                                    uniforms=u, slot0=9, **values)
    wrapper = sk.sample_block(nwk, ndk, nk, z, w, d, noise_mode=mode,
                              uniforms=u, slot0=9, **values)
    assert torch.equal(by_value, tensors) and torch.equal(by_value, wrapper)


def test_graph_refuses_other_shapes_and_missing_inputs():
    pc, dl, jst = _setup(12, 512)
    tw, td, tm = _tokens(pc)
    st = _port_state(jst)
    g = draw_sweep_graph(_tables(st), tw, td, tm, block_size=512)
    with pytest.raises(ValueError, match="seeds"):
        g(_tables(st), 0.5, 0.1, 1)
    with pytest.raises(ValueError, match="at least one"):
        g(_tables(st), 0.5, 0.1, 0, seeds=[])
    with pytest.raises(ValueError, match="built for"):
        g((st.z, st.ndk[:-1], st.nwk, st.nk), 0.5, 0.1, 1, seeds=[(1,)])
    ext = draw_sweep_graph(_tables(st), tw, td, tm, block_size=512,
                           noise_mode="external")
    with pytest.raises(ValueError, match="noise"):
        ext(_tables(st), 0.5, 0.1, 1)


# --- the kernel tiers' graphs: the deferred tier (K1's walk against the
# snapshot, K2's rebuild and the next snapshot; ``deferred_sweep_graph``)
# and the fused tier (K1's walk and the count move per block;
# ``fused_sweep_graph``), through ``make_sweep_fn``


CHAIN_SNAPSHOTS = [(c, m) for c in ("float32", "bfloat16", "bf16p")
                   for m in ("bfloat16", "float32")]
KERNEL_TIER_CASES = (
    [("deferred", c, m, "internal") for c, m in CHAIN_SNAPSHOTS]
    + [("deferred", "float32", "bfloat16", mode) for mode in ("external", "deterministic")]
    + [("fused", "float32", "bfloat16", mode)
       for mode in ("internal", "external", "deterministic")])


def _deferred_setup(seed, block=512, t_target=3000):
    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.3, size=t_target) - 1) % V).astype(np.int32)
    td = (np.arange(t_target, dtype=np.int64) * M // t_target).astype(np.int32)
    plan = ck.plan_deferred(tw, td, V, block)
    jst = jax_init_state(plan.token_word, plan.token_doc, plan.token_mask,
                         num_docs=M, vocab_size=V, num_topics=K, seed=seed)
    return plan, np.bincount(td, minlength=M).astype(np.int32), jst


def _tier_setup(tier, seed):
    """``(layout, doc lengths, JAX start state)``: the deferred plan, or the
    fused tier's ``pad_to`` + ``sort_within_blocks`` layout."""
    if tier == "deferred":
        return _deferred_setup(seed)
    return _setup(seed, 512)


def _tier_run(tier, layout, dl, mode, chain="float32", mirror="bfloat16"):
    return make_sweep_fn(
        layout.token_word, layout.token_doc, layout.token_mask, dl, alpha=0.5,
        beta=0.1, block_size=512, use_pallas=tier, num_topics=K,
        deferred_plan=layout if tier == "deferred" else None, device="cpu",
        noise_mode=mode, kernel_compute_dtype=chain, mirror_dtype=mirror)


def _k1_uniforms(jst, t_pad):
    """The reference's external uniforms of a sweep (its kernel tiers'
    ``uniform(fold_in(key, sweep), (T_pad, k_pad), 1e-7, 1 - 1e-7)``)."""
    def noise(sweep):
        key = jax.random.fold_in(jst.key, sweep)
        return torch.from_numpy(np.array(jax.random.uniform(
            key, (t_pad, 128), jnp.float32, minval=1e-7, maxval=1.0 - 1e-7)))
    return noise


def _tier_calls(run, st, mode, noise, gen, mirror=None):
    """Two sweeps at the first α and β in one call, then one at the second;
    the deferred tier carries its snapshot.  Returns the state and snapshot
    after each call."""
    out = []
    for (a, b), n in zip(HYPERS, (2, 1)):
        kw = dict(n_sweeps=n, generator=gen if mode == "internal" else None,
                  noise=noise if mode == "external" else None)
        if hasattr(run, "with_mirror"):
            st, mirror = run.with_mirror(st, a, b, mirror, **kw)
        else:
            st = run(st, a, b, **kw)
        out.append((st, mirror))
    return out


@pytest.mark.parametrize("tier,chain,mirror,mode", KERNEL_TIER_CASES,
                         ids=["-".join(c) for c in KERNEL_TIER_CASES])
def test_kernel_tier_graphs_equal_eager_sweeps(tier, chain, mirror, mode):
    """``make_sweep_fn``'s deferred and fused runs (their graphs' bodies on
    the CPU) against the eager ``_deferred_sweep_impl`` /
    ``fused_gibbs_sweep`` loop from the same state, seeds and noise:
    bitwise, every table and the carried snapshot, across a change of α and
    β between calls."""
    layout, dl, jst = _tier_setup(tier, 20 + KERNEL_TIER_CASES.index(
        (tier, chain, mirror, mode)))
    tw, td, tm = _tokens(layout)
    run = _tier_run(tier, layout, dl, mode, chain, mirror)
    rng = np.random.default_rng(3)
    us = [torch.from_numpy(rng.random((layout.num_tokens, 128), dtype=np.float32)
                           * 0.999 + 5e-4) for _ in range(3)]
    st = _port_state(jst)
    got = _tier_calls(run, st, mode, lambda s: us[s],
                      torch.Generator().manual_seed(6))
    assert len(run.graphs) == 1
    gen = torch.Generator().manual_seed(6)
    want, snap = st, None
    for (a, b), n, (g_st, g_snap) in zip(HYPERS, (2, 1), got):
        for _ in range(n):
            kw = dict(noise_mode=mode,
                      uniforms=us[want.sweep] if mode == "external" else None,
                      seed=sweep_seed(gen) if mode == "internal" else 0)
            if tier == "deferred":
                want, snap = _deferred_sweep_impl(
                    want, tw, td, tm, a, b, row_tile=run.row_tile,
                    v_pad=layout.v_pad, mirror=snap, compute_dtype=chain,
                    mirror_dtype=mirror, **kw)
            else:
                want = fused_gibbs_sweep(want, tw, td, tm, a, b, block_size=512,
                                         row_tile=run.row_tile, **kw)
        assert g_st.sweep == want.sweep
        _assert_equal(_tables(g_st), _tables(want))
        if tier == "deferred":
            assert g_snap.dtype == getattr(torch, mirror)
            assert torch.equal(g_snap, snap)
            # the state's nwk and nk are the padded tables' corners, as the
            # eager sweep hands them out
            assert g_st.nwk.stride() == want.nwk.stride()
    assert not torch.equal(got[-1][0].z, st.z)


def _jax_deterministic_runner(tier, layout, dl):
    """The JAX package's sweep of ``tier`` as its ``make_sweep_fn`` runs it,
    Pallas in interpret mode, in the deterministic mode (``make_sweep_fn``
    fixes external noise under interpret, so this drives the same sweep
    functions with the same layout): ``runner(state, alpha, beta, mirror, n)
    -> (state, mirror)``."""
    import ldagibbssampling_tpu.ops.gibbs as jg
    from ldagibbssampling_tpu.corpus.flat import PaddedCorpus
    from ldagibbssampling_tpu.ops.count_kernel import replicate_rows

    tw, td, tm = (np.asarray(a, np.int32) for a in (
        layout.token_word, layout.token_doc, layout.token_mask))
    pc = PaddedCorpus(token_word=tw, token_doc=td, token_mask=tm,
                      num_real_tokens=int(tm.sum()), vocab_size=0,
                      num_docs=int(td.max()) + 1)
    d_local, d0, d_loc = pc.doc_slabs(512, d_loc_multiple=128)
    row_tile = jg._pick_row_tile(512, K)
    slab_split = int(np.bincount(td, weights=tm).max()) > 256
    args = [jnp.asarray(a) for a in (tw, d_local, tm, d0)]
    if tier == "fused":
        def runner(st, a, b, mirror, n):
            for _ in range(n):
                st = jg.fused_gibbs_sweep(
                    st, *args, alpha=a, beta=b, block_size=512, d_loc=d_loc,
                    row_tile=row_tile, sorted_words=True, noise_mode="deterministic",
                    pallas_interpret=True, slab_split=slab_split)
            return st, None
        return runner
    nt = layout.tile_stripe.shape[0]
    args += [jnp.asarray(layout.row_gather_idx),
             jax.jit(replicate_rows)(jnp.asarray(layout.w_local.reshape(nt, layout.tile))),
             jnp.asarray(layout.tile_stripe)]

    def runner(st, a, b, mirror, n):
        if mirror is None:
            mirror = jnp.pad(st.nwk, ((0, layout.v_pad - V), (0, 128 - K))
                             ).astype(jnp.bfloat16)
        for _ in range(n):
            st, mirror = jg._deferred_sweep_impl(
                st, *args, jnp.float32(a), jnp.float32(b), block_size=512,
                d_loc=d_loc, row_tile=row_tile, noise_mode="deterministic",
                pallas_interpret=True, vocab_size=None, v_loc=layout.v_loc,
                v_pad=layout.v_pad, tile=layout.tile, slab_split=slab_split,
                mirror=mirror)
        return st, mirror
    return runner


@pytest.mark.parametrize("tier,mode", [
    ("deferred", "external"), ("deferred", "deterministic"),
    ("fused", "external"), ("fused", "deterministic")])
def test_kernel_tier_graphs_match_reference(tier, mode):
    """The deferred and fused runs (their graphs' bodies on the CPU) against
    the JAX package's ``make_sweep_fn(use_pallas=tier)`` with its Pallas
    kernels interpreted, from the same state: two sweeps in one call, then
    one at other α and β, the deferred snapshot carried on both sides;
    external noise is the reference's own uniforms.  Tolerances as in
    ``tests/test_torch_deferred_sweep.py``."""
    layout, dl, jst = _tier_setup(tier, {"deferred": 30, "fused": 31}[tier])
    if mode == "external":
        ref_run = jax_make_sweep_fn(
            layout.token_word, layout.token_doc, layout.token_mask, dl,
            alpha=0.5, beta=0.1, block_size=512, use_pallas=tier,
            pallas_interpret=True, sorted_words=True, num_topics=K,
            deferred_plan=layout if tier == "deferred" else None)
        if tier == "deferred":
            runner = ref_run.with_mirror
        else:
            def runner(st, a, b, mirror, n):
                return ref_run(st, a, b, n_sweeps=n), None
    else:
        runner = _jax_deterministic_runner(tier, layout, dl)
    run = _tier_run(tier, layout, dl, mode)
    got = _tier_calls(run, _port_state(jst), mode,
                      _k1_uniforms(jst, layout.num_tokens), None)
    ref, ref_mirror = jst, None
    for (a, b), n, (out, _) in zip(HYPERS, (2, 1), got):
        ref, ref_mirror = runner(ref, a, b, ref_mirror, n)
        assert out.sweep == int(ref.sweep)
        _assert_matches_reference(layout, out, ref)


def _eager_deferred_inputs_never_change(layout, dl, jst):
    """``deferred_local_counts`` (the graph's body on clones) leaves the
    state and the snapshot it is given as they were, in both snapshot
    types, from a given snapshot and from a cold start."""
    tw, td, tm = _tokens(layout)
    row_tile = _tier_run("deferred", layout, dl, "internal").row_tile
    for mirror_dtype in ("bfloat16", "float32"):
        st = _port_state(jst)
        mirror = snapshot(st.nwk, layout.v_pad, 128, mirror_dtype)
        keep, mirror_keep = [t.clone() for t in _tables(st)], mirror.clone()
        for given in (mirror, None):
            z, ndk, nwk, nk, out = deferred_local_counts(
                st, tw, td, tm, 0.5, 0.1, row_tile=row_tile, v_pad=layout.v_pad,
                mirror=given, seed=1, mirror_dtype=mirror_dtype)
            _assert_equal(_tables(st), keep)
            assert torch.equal(mirror, mirror_keep)
            assert out.dtype == mirror.dtype and not torch.equal(out, mirror)
            assert not torch.equal(z, st.z) and not torch.equal(nwk, st.nwk)


@pytest.mark.parametrize("tier", ["deferred", "fused", "deferred_local_counts"])
def test_kernel_tier_inputs_and_returned_states_never_change(tier):
    """As ``test_inputs_and_returned_states_never_change`` for the deferred
    and fused graphs, the snapshot included: a state and snapshot passed in,
    or returned earlier, keep their values; one modified in place is copied
    in again; a cold start (``mirror=None``) equals the carried snapshot.
    The eager deferred sweep keeps its inputs too
    (``_eager_deferred_inputs_never_change``)."""
    if tier == "deferred_local_counts":
        _eager_deferred_inputs_never_change(*_tier_setup("deferred", 40))
        return
    layout, dl, jst = _tier_setup(tier, 40)
    run = _tier_run(tier, layout, dl, "internal")

    def call(st, mirror, seed, a=0.5, b=0.1, n=1):
        gen = torch.Generator().manual_seed(seed)
        if tier == "deferred":
            return run.with_mirror(st, a, b, mirror, n_sweeps=n, generator=gen)
        return run(st, a, b, n_sweeps=n, generator=gen), None

    st = _port_state(jst)
    keep = [t.clone() for t in _tables(st)]
    first, m1 = call(st, None, 1)
    first_keep = [t.clone() for t in _tables(first)]
    m1_keep = None if m1 is None else m1.clone()
    second, m2 = call(first, m1, 2)        # the buffers' own state
    third, m3 = call(second, m2, 3, 0.2, 0.3, 2)
    _assert_equal(_tables(st), keep)
    _assert_equal(_tables(first), first_keep)
    assert m1 is None or torch.equal(m1, m1_keep)
    assert not torch.equal(second.z, first.z) and not torch.equal(third.z, second.z)
    assert second.sweep == 2 and third.sweep == 4
    # the last returned state (and snapshot), modified in place to first's
    # values: the next call reads it, not what the buffers still hold
    for t, f in zip(_tables(third), first_keep):
        t.copy_(f)
    if m3 is not None:
        m3.copy_(m1_keep)
    again, m_again = call(third, m3, 4, 0.2, 0.3, 2)
    want, m_want = call(SamplerState(*first_keep, sweep=4), None, 4, 0.2, 0.3, 2)
    _assert_equal(_tables(again), _tables(want))
    assert m_want is None or torch.equal(m_again, m_want)
    assert len(run.graphs) == 1


def test_deferred_cold_start_equals_carried_snapshot():
    """A call with ``mirror=None`` casts the snapshot from ``nwk`` outside
    the graph: it is the snapshot the previous call carried out, and the
    sweeps from either are the same."""
    layout, dl, jst = _tier_setup("deferred", 41)
    for mirror_dtype in ("bfloat16", "float32"):
        run = _tier_run("deferred", layout, dl, "internal", mirror=mirror_dtype)
        st, carried = run.with_mirror(_port_state(jst), mirror=None, n_sweeps=2,
                                      generator=torch.Generator().manual_seed(5))
        cast = ck.cast_mirror_plain(torch.nn.functional.pad(
            st.nwk, (0, 128 - K, 0, layout.v_pad - V)).contiguous())
        assert torch.equal(carried.float(), cast.float())
        a, ma = run.with_mirror(st, 0.3, 0.2, carried, n_sweeps=1,
                                generator=torch.Generator().manual_seed(6))
        b, mb = run.with_mirror(SamplerState(*(t.clone() for t in _tables(st)),
                                             sweep=st.sweep), 0.3, 0.2, None,
                                n_sweeps=1, generator=torch.Generator().manual_seed(6))
        _assert_equal(_tables(a), _tables(b))
        assert torch.equal(ma, mb)


def _k1_formula(rows, ndk, nk, z, w, d, m, *, alpha, beta, vbeta, seed, mode,
                uniforms, slot0, row_tile, chain):
    """K1's walk with α, β, Vβ and the seed given by value, as the wrapper
    took them before they became device tensors: per tile the draw (the
    reference's op order, every operand a float32 made from the value) and
    the move of ``ndk``/``nk``."""
    f32, bf = torch.float32, torch.bfloat16
    k = ndk.shape[1]
    k_pad = fk.row_width(rows, k)
    a, b, vb = (torch.tensor(x, dtype=f32) for x in (alpha, beta, vbeta))
    cols = torch.arange(k_pad)
    parts = []
    for s in range(0, z.shape[0], row_tile):
        sl = slice(s, s + row_tile)
        zt, n = z[sl], z[sl].shape[0]
        e = (cols[None, :] == zt[:, None].long()).to(f32)
        wr = torch.nn.functional.pad(rows[w[sl].long()],
                                     (0, k_pad - rows.shape[1])).to(f32)
        dr = torch.nn.functional.pad(ndk[d[sl].long()], (0, k_pad - k)).to(f32)
        r32 = fk.approx_recip(torch.nn.functional.pad(nk, (0, k_pad - k)).to(f32) + vb)
        aa, bb, r, rr = a, b, r32, r32 * r32
        if chain != "float32":
            r, rr = r32.to(bf), (r32 * r32).to(bf)
            e, wr, dr, aa, bb = e.to(bf), wr.to(bf), dr.to(bf), a.to(bf), b.to(bf)
        p = ((wr - e + bb) * (dr - e + aa)) * (r + e * rr)
        score = p
        if mode != "deterministic":
            u = (fk.philox_uniforms(seed, slot0 + s, n, k_pad, "cpu")
                 if mode == "internal" else uniforms[sl])
            inv_e = fk.approx_recip(-torch.log(u))
            score = (p * inv_e.to(bf) if chain == "bfloat16"
                     else p.to(f32) * inv_e)
        score = torch.where(cols[None, :] < k, score,
                            torch.tensor(-1.0, dtype=score.dtype))
        zn = torch.where(m[sl] > 0, score.to(f32).argmax(dim=1).to(z.dtype), zt)
        real = m[sl] > 0
        one = torch.ones(int(real.sum()), dtype=torch.int32)
        for zz, sign in ((zt[real].long(), -one), (zn[real].long(), one)):
            ndk.index_put_((d[sl][real].long(), zz), sign, accumulate=True)
            nk.index_put_((zz,), sign, accumulate=True)
        parts.append(zn)
    return torch.cat(parts)


@pytest.mark.parametrize("mode", ["deterministic", "external", "internal"])
@pytest.mark.parametrize("chain,rows", [("float32", "bfloat16"), ("bfloat16", "float32"),
                                        ("bf16p", "bfloat16"), ("float32", "int32")])
def test_k1_plain_takes_the_scalar_tensors_as_its_by_value_form(mode, chain, rows):
    """K1's plain walk and its wrapper on the ``scalars``/``key`` tensors
    against the walk with α, β, Vβ and the seed by value: bitwise, ``z``,
    ``ndk`` and ``nk``, several tiles of one block."""
    rng = np.random.default_rng(7)
    k, v, m, n = 13, 50, 6, 400
    nwk = torch.from_numpy(rng.integers(0, 300, (v, k)).astype(np.int32))
    ndk = torch.from_numpy(rng.integers(0, 40, (m, k)).astype(np.int32))
    nk = nwk.sum(dim=0, dtype=torch.int32)
    z = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    d = torch.from_numpy(np.sort(rng.integers(0, m, n)).astype(np.int32))
    msk = torch.from_numpy((rng.random(n) < 0.95).astype(np.int32))
    u = torch.from_numpy(rng.random((n, 128), dtype=np.float32) * 0.99 + 0.005)
    padded = torch.nn.functional.pad(nwk, (0, 128 - k))
    table = {"int32": nwk, "bfloat16": padded.to(torch.bfloat16),
             "float32": padded.float()}[rows]
    alpha, beta, seed = 0.31, 0.07, 2**63 + 12345
    scal = _device.sweep_scalars(alpha, beta, v, k)
    by_ndk, by_nk = ndk.clone(), nk.clone()
    by_value = _k1_formula(table, by_ndk, by_nk, z, w, d, msk, alpha=float(scal[0]),
                           beta=float(scal[1]), vbeta=float(scal[2]), seed=seed,
                           mode=mode, uniforms=u, slot0=9, row_tile=128, chain=chain)
    values = dict(scalars=torch.from_numpy(scal),
                  key=torch.tensor([_device.seed_word(seed)]))
    for walk in (fk.gibbs_tiles_plain, fk.gibbs_tiles):
        t_ndk, t_nk = ndk.clone(), nk.clone()
        got = walk(table, t_ndk, t_nk, z, w, d, msk, noise_mode=mode, uniforms=u,
                   slot0=9, row_tile=128, compute_dtype=chain, **values)
        assert torch.equal(got, by_value)
        assert torch.equal(t_ndk, by_ndk) and torch.equal(t_nk, by_nk)
    assert (by_value != z).any()
