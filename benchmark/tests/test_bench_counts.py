"""The count functions against values worked out by hand, at the shape of
the port's bench script (T = 2^20 Zipf(1.1) tokens, V = 50,000, M = 4,096,
block 65,536; its first block, from seed 0, holds 64,064 real tokens of
22,072 words and 251 documents), where ``PERF.md`` section 6 gives K1's
walk bound as 0.0297 ms at K = 500 and 0.0059 ms at K = 100."""

import pytest

from benchmark import roofline

BLOCK, REAL, WORDS, DOCS = 65_536, 64_064, 22_072, 251


def _block(k, row_tile, moved=REAL):
    return roofline.SweepCounts(
        num_topics=k, k_pad=max(128, (k + 127) // 128 * 128), v_pad=50_048,
        t_pad=BLOCK, block=BLOCK, row_tile=row_tile, blocks=1, real=REAL,
        block_words=WORDS, block_docs=DOCS, moved=moved, moved_cells=2 * moved,
        moved_topics=k)


@pytest.mark.parametrize("k, row_tile, ops, bound_ms", [
    # 64,064 x 500 x (48 + 10 + 4) + 128 tiles x 500 x 13 + 4 x 64,064
    (500, 512, 1_985_984_000 + 832_000 + 256_256, 0.0297),
    # 64,064 x 100 x 62 + 32 tiles x 100 x 13 + 4 x 64,064
    (100, 2048, 397_196_800 + 41_600 + 256_256, 0.0059),
])
def test_walk_bound_at_the_bench_shape(k, row_tile, ops, bound_ms):
    c = _block(k, row_tile)
    assert roofline.walk_ops(c) == ops
    assert round(roofline.walk_bound_s(c) * 1e3, 4) == bound_ms
    # bound by the operations: the bytes take about a quarter of the time
    assert roofline.walk_bytes(c) / roofline.HBM_BYTES_PER_S < ops / roofline.F32_OPS_PER_S


def test_walk_bytes_by_hand():
    c = _block(500, 512, moved=1000)
    rows = WORDS * 512 * 2            # each distinct word's bf16 row
    docs = DOCS * 500 * 4             # each distinct document's counts
    per_block = 500 * 4 + BLOCK * 20  # the totals, the slots' five int32
    moves = (2000 + 500) * 4          # each changed cell and total written
    assert roofline.walk_bytes(c) == rows + docs + per_block + moves


def test_counts_are_of_the_stated_chain():
    assert roofline.counts_chain({"kernel_compute_dtype": "float32",
                                  "mirror_dtype": "bfloat16"})
    assert not roofline.counts_chain({"kernel_compute_dtype": "bfloat16",
                                      "mirror_dtype": "bfloat16"})
    assert not roofline.counts_chain({"kernel_compute_dtype": "float32",
                                      "mirror_dtype": "float32"})


def test_counts_bound_by_hand():
    c = _block(100, 2048)
    table = 50_048 * 128
    rebuild = (BLOCK * 12 + table * 4 + 128 * 4) / 3.35e12
    cast = table * 6 / 3.35e12
    assert roofline.counts_bound_s(c) == pytest.approx(rebuild + cast, rel=1e-12)
    assert roofline.sweep_ops(c) == roofline.walk_ops(c) + 2 * REAL + table


def test_sweep_counts_from_a_layout():
    import torch

    word = torch.tensor([0, 0, 1, 2, 5, 5, 0, 0], dtype=torch.int32)
    doc = torch.tensor([0, 0, 1, 1, 2, 2, 0, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
    zb = torch.tensor([0, 1, 1, 2, 0, 0, 0, 0], dtype=torch.int32)
    za = torch.tensor([0, 2, 1, 0, 0, 1, 0, 0], dtype=torch.int32)
    c = roofline.sweep_counts(word, doc, mask, zb, za, block=4, row_tile=4,
                              num_topics=3, v_pad=128)
    assert (c.blocks, c.real, c.moved) == (2, 6, 3)
    assert c.block_words == 3 + 1        # {0, 1, 2} and {5}
    assert c.block_docs == 2 + 1         # {0, 1} and {2}
    # block 0 moves doc 0 1->2 and doc 1 2->0: four cells, three totals;
    # block 1 moves doc 2 0->1: two cells, two totals
    assert (c.moved_cells, c.moved_topics) == (6, 5)
