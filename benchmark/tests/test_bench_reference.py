"""The reference beside the program it judges, on the CPU: its layout is
the port's deferred plan (every slot), its noise the port's Philox
uniforms, its start the port's initial topics.  Only this test imports
both; the reference itself imports nothing of the program."""

import numpy as np
import torch

from benchmark import corpus, reference as ref
from benchmark.tests._tiny import TINY_CONFIG
from ldagibbssampling_tpu_torch.ops import count_kernel, fused_kernel
from ldagibbssampling_tpu_torch.models import state as state_lib


def _medium():
    cfg = dict(TINY_CONFIG, num_docs=900, vocab_size=20_000, num_tokens=300_000)
    return corpus.make_corpus(cfg, 2**31 + 21, "cpu")


def test_layout_is_the_programs_plan():
    c = _medium()
    plan = count_kernel.plan_deferred(c.token_word.numpy(), c.token_doc.numpy(),
                                      c.vocab_size, 16_384)
    lay = ref.plan_layout(c.token_word, c.token_doc, c.vocab_size, 16_384)
    assert np.array_equal(lay.perm.numpy(), plan.perm)
    assert np.array_equal(lay.mask.numpy().astype(np.int32), plan.token_mask)
    real = plan.token_mask > 0
    assert np.array_equal(lay.word.numpy()[real], plan.token_word[real])
    assert np.array_equal(lay.doc.numpy()[real], plan.token_doc[real])
    assert lay.v_pad == plan.v_pad


def test_philox_uniforms_are_the_programs():
    seed = 0x1234_5678_9ABC_DEF1
    slots = torch.arange(4096, 4096 + 300, dtype=torch.int64)
    ours = ref.philox_uniforms(seed, slots, 128)
    theirs = fused_kernel.philox_uniforms(seed, 4096, 300, 128, "cpu")
    assert torch.equal(ours, theirs)


def test_start_is_the_programs_initial_state():
    t_pad, k = 5000, 37
    z = torch.zeros(t_pad, dtype=torch.int32)
    st = state_lib.init_state(z.numpy(), z.numpy(), np.ones(t_pad, np.int32),
                              num_docs=1, vocab_size=1, num_topics=k, seed=99,
                              device="cpu")
    seeds = ref.ChainSeeds(99, t_pad, k)
    assert torch.equal(st.z, seeds.z0)
    gen = torch.Generator().manual_seed(st.seed)
    from ldagibbssampling_tpu_torch.ops.gibbs import sweep_seed
    assert [sweep_seed(gen) for _ in range(3)] == [seeds.sweep_seed(i) for i in (1, 2, 3)]


def test_row_tile_rule():
    assert ref.row_tile(65_536, 100) == 2048
    assert ref.row_tile(65_536, 500) == 512
    assert ref.row_tile(65_536, 1000) == 256
    assert ref.row_tile(512, 12) == 512
