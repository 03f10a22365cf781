#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldagibbssampling_tpu_torch``) on
one NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero and nothing is caught and turned into
success:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every kernel source under ``ldagibbssampling_tpu_torch/
   csrc`` with nvcc for sm_90a, one process per source, all at once; prints
   each kernel's registers, shared memory and spills (ptxas) and the grid
   the occupancy query gives K1's walk;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes, on one block of 65,536 tokens: K1 reading the bf16
   snapshot (deferred layout) and K1 reading the live int32 table plus the
   block's word-topic count move (fused layout), each in the deterministic
   (must be equal), external and internal noise modes (z equal on >= 99.99%
   of tokens, differences printed); K3 in the same three modes, and again
   with the block's hottest word's and first document's counts at and past
   the end of its log tables (the kernel reading alpha, beta, V*beta and its
   seed from device tensors, the plain version taking them by value); the count move of all three tables with its
   write-back of z (bitwise); K2 (rebuild + bf16 snapshot) over the whole
   stream (bitwise).  Times each kernel (its device time per launch from
   ``torch.profiler``, the ``ms`` of the kernels line, beside CUDA events
   around its wrapper, which for a kernel of microseconds time the host's
   launch), its plain version and, where one exists, a single PyTorch
   library call (CUDA events, and its device time per call from the
   profiler, ``library_device_ms``).  K1's other chains on the
   same block: bf16 and bf16p on the bf16 snapshot, and f32, bf16 and bf16p
   on the float32 snapshot, each in the three noise modes (deterministic
   bitwise, z equal on >= 99.99% with noise), timed; K1's whole walk
   (draw and count move per tile, one cooperative launch) of each of its
   seven instantiations, and the same walk with every token masked, its
   fixed cost per tile; K2's ``build_nwk(emit_mirror=False)`` (bitwise); K4,
   the dtype probe, in float32 and bf16 (both bitwise) at [32768, 512]; K1
   at K = 100, where the sweep's row tile is 2,048 (four tokens a thread
   for each CTA's fold of a tile's records in the tagged walk): the block
   against the plain walk in the three modes (bitwise), its whole walk and
   its fixed cost per tile; the SMC
   resample's two gated kernels (``ops/smc_resample.py``) at SMC's shape in
   phase 9 (16 particles, K = 15, rung 5 at 0.01) against their plain
   versions with the flag true and false (bitwise, and the resample count),
   timed with the flag true (one resample) and false (every token's cost);
   CVB0's fixed-order scatter (``ops/cvb0_scatter.py``) along its plans at
   ``[graphs cvb0]``'s two shapes (rung 5 at 0.2, K = 15, block 8,192; and
   bench.py's, K = 500, block 65,536, where a frequent word's run holds
   thousands of a block's tokens), both tables (``ndk`` by document,
   ``nwk`` by word), and one word filling a block at K = 500, the first and
   the last (padded) block, against its plain version (the CPU's
   ``index_add_`` in token order) on copies of the same inputs (bitwise),
   timed beside ``index_put_(accumulate=True)`` and the atomic
   ``index_add_`` on the card, and with ``--scatter-parent DIR`` against
   the kernel of another checkout in turns (``scripts/scatter_parity.py``);
4. main paths: ``make_backend`` -> ``LdaModel`` -> ``run_inference`` at
   bench.py's shape (T = 2^20 Zipf(1.1) tokens, V = 50,000, M = 4,096
   documents, K = 500, block 65,536, alpha 0.5, beta 0.1): 10 sweeps each of
   the deferred, fused and v1-draw tiers and 2 sweeps of the XLA tier, each
   then ``check_counts_consistent``; each run must report the tier asked
   for, launch every kernel of its tier (and the exact number of launches
   its layout implies: one K1 walk per sweep and no count move in the
   deferred tier, one walk and one count move per block in the fused tier,
   in the v1-draw tier one K3 and one count move per block and sweep, the
   graph's warm-up sweep included: every tier replays one CUDA graph per
   sweep; the deferred tier's first snapshot is cast outside it), no other
   kernel and no plain version; prints
   tokens/s (on the graph paths also the graph's set-up, the first call's
   wall before its first replay, the rate less it, and a second call's
   rate); then profiles one more sweep of each tier with the port's
   ``trace`` (device time by kernel, busy share).  Then the deferred tier in
   its five other (chain, snapshot) settings, 10 sweeps each, the same
   checks (``cast_mirror`` only on the bf16 snapshot), and once more at
   K = 100 (tiles of 2,048); the chains' quality
   on a planted-topic corpus (2,048 documents, V = 5,000, K = 500, about
   2^19 tokens, alpha 0.1 and beta 0.05 as it was generated): each of the
   six deferred settings for 20 sweeps from the
   same seed with ``ll_every=5``, the training LL and perplexity at sweeps
   5-20 (finite, and the perplexity at 20 below that at 5); one run of 10
   sweeps with ``optimize_hyper_every=5`` at bench.py's shape (α and β move
   and stay finite), with the time of one device LL and one Minka update;
   the K4 probe's entry point (ms and Gops/s);
   then the held-out perplexity: 5% of the planted corpus's documents split
   off (``FlatCorpus.split_docs``), each of the six settings trained on the
   rest for 20 sweeps, ``heldout_perplexity_device`` on the card for each,
   and the host ``heldout_perplexity`` on the first 32 held-out documents
   for the default setting (beside the device's on the same documents);
5. CLI: the port's CLI on the generated minicorpus, as it is, with
   ``--pallas fused``, with ``--sampler serial`` and with ``--ll-every 5
   --optimize-hyper-every 5``, must write the five reference artifacts each
   time (and, the last, metrics rows with ``log_likelihood`` and ``alpha``);
   ``[resume]``: in the fused tier (the minicorpus's), and the deferred
   tier (block 256 through ``--config-json``) and the v1-draw tier with
   ``--optimize-hyper-every 5``, one uninterrupted run of 60 sweeps
   (artifacts at 50 and 60) and one run to sweep 30 with
   ``--checkpoint-every 10`` then ``--resume`` to 60: the resumed run's ten
   artifacts must be byte-identical to the uninterrupted run's, and each
   process's launches exact (per sweep and block, the graph's warm-up
   sweep once more);
   ``[infer]``: a CLI run with ``--infer-docs`` must write
   ``inferred.theta``, ``.tassign`` and ``.docs``;
6. parity: ``evaluation/parity.oracle_vs_blocked`` per tier (deferred,
   fused, v1 draw, XLA; ``use_pallas`` forced, each model's ``kernel_tier``
   checked) against the serial oracle, four seeds and 30 sweeps each at
   K = 5, block 256, on the minicorpus, or where the minicorpus resolves to
   another tier on a seeded planted corpus (``data/synthetic``); |z| >= 4 on
   the LL or the topic entropy fails;
7. bench: the port's bench script (``scripts/bench.py``) as a subprocess at
   bench.py's full shape in each ``LDA_BENCH_PALLAS`` tier (100 timed
   sweeps, 20 for the XLA tier), its one JSON line printed and its
   ``metric`` checked against bench.py's name.

8. multichain: rung 4's configuration of ``benchmarks/ladder.py`` (planted
   corpus, K = 10, block 8,192, 4 chains, mean length 80) at its full size,
   scale 1.0: 40,000 documents, V = 20,000, 3,437,212 tokens, through
   ``make_backend`` (``chains=4``) and ``run_inference`` for 20 sweeps with
   the LL every 5: every chain's counts equal a recount of its z, the
   chains differ pairwise, the rows carry finite ``r_hat`` and
   ``r_hat_phi_p99`` (printed), no kernel launches (the chains run the XLA
   tier, as the reference's), peak device memory, per sweep the time of the
   sweep, the chains' LL, the phi fold and the window summary, the runner's
   LL rows (``device_log_likelihood``, within relative 1e-9 of the host LL
   of chain 0), where the phi moments live (the card, and their bytes), and
   two unrecorded sweeps and a mid-window ``record_phi_auto`` run under
   CUDA's sync debug mode set to error (no host sync); prints tokens/s over
   chain-sweeps and the time of one LL recording of the four chains; one
   window of 4 phi draws folded on the card and on the CPU (moments
   bitwise, summary within relative 1e-9, perms and cell count equal).
   Then the batched chains (one ``gibbs_sweep_chains`` per sweep)
   against the same chains run in turn (one single-chain
   ``make_sweep_fn(use_pallas=False)`` each) from the same states and
   generators, in turn, batched, batched, in turn, 2 sweeps each: z and
   every table bitwise per chain, both forms' tokens/s, and their device
   operations per sweep of the four chains, counted from their graphs'
   nodes (the batched at most one chain's plus 5 per block; both forms
   replay CUDA graphs), and their host calls from one profiled sweep.  8c, ``[graphs]``:
   each captured path (``ops/graphs.SweepGraph``, one CUDA graph replayed
   per sweep) against its eager sweep from the same state, seeds and noise:
   the deferred tier (K = 500, tiles of 512, and K = 100, tiles of 2,048,
   both the tagged walk; its snapshot carried), the fused tier, the XLA tier
   and the v1-draw tier at bench.py's shape through ``make_sweep_fn`` on
   ``make_backend``'s layout, the chains at rung 4's full size and at
   K = 500 on bench.py's shape through ``ChainSet``; in internal and
   external noise, two sweeps in one call then one at other alpha and
   beta: z and every table bitwise (and the deferred snapshot); tokens/s
   eager (the
   comparison's 3 sweeps) and captured (one call); per sweep the host's
   calls and graph launches (one; ``torch.profiler``) and the card's
   operations (eager one per host call; captured the graph's nodes,
   counted by ``SweepGraph`` when it captured them, and the
   generators' fills), the set-up seconds (the first call before its first
   replay) and, of them, capture and instantiation, peak device memory allocated
   and reserved (the graph pools included).  8b, ``[multichain
   wide]``: the same at K = 500 and 4 chains on bench.py's shape (2^20
   Zipf(1.1) tokens, V = 50,000, M = 4,096, block 65,536; BASELINE's
   configuration 4's topic count and chains, its Wikipedia corpus not being
   in the repository), 10 sweeps.  8d, ``[graphs smc]``: SMC's captured
   absorb (``backends/smc.SmcGraph``, one replay a 64 tokens) against the
   eager ``smc_absorb`` on phase 9's SMC corpus: the pass's first noise
   block of 4,096 tokens eager, then captured from the same state and noise
   (z, the tables and the log-weights bitwise), then the rest of the pass
   captured; us a token eager and captured, host calls and graph launches
   a token (``torch.profiler`` over 1,024 tokens), nodes a replay,
   resamples in the pass, a resample's device time against its bound,
   set-up, peak memory; the resample kernels' launches exact (one a token
   and one for the graph's warm-up step).  8e, ``[graphs svi]``: SVI's
   captured step (``backends/svi.SviGraph``, one replay a minibatch) at
   phase 9's SVI shape: 20 steps alone (rho changing, a short batch) eager
   and captured from the same lambda, bitwise; ms and host calls a step;
   then one epoch with its host work captured (``SviModel.sweep``) and
   stepped eagerly, bitwise, seconds and tokens/s.  8f, ``[graphs cvb0]``:
   CVB0's sweep (``Cvb0Model.sweep``, one replay a sweep) against the eager
   ``cvb0_sweeps`` from the model's start at rung 5's 0.2 (K = 15, block
   8,192), 3 sweeps each (captured as a call of 2 and one of 1): gamma and
   the tables bitwise, the scatter's launches exact (two a block and sweep,
   the warm-up sweep's included), no plain call; ms a sweep and tokens/s,
   host calls a sweep, nodes, set-up and capture seconds, peak memory; then
   ``[graphs cvb0 wide]``, the same at bench.py's shape (K = 500, block
   65,536) from a start made on the card, 3 timed sweeps.  8g, ``[graphs
   warp]``: WarpLDA's sweep (``WarpModel.sweep``) against the eager
   ``_warp_sweep`` at rung 5's 0.2, external and internal noise, z and the
   tables bitwise, no kernel launched; the same numbers;
9. backends: rung 5's configuration (planted corpus, K = 15, block 8,192,
   5% of the documents held out) at scale 0.2: 16,400 documents, V =
   20,000, ~1.67M training tokens: gibbs (5 sweeps, the deferred tier, its
   kernels counted), cvb0 (5), warp (5), each the first untimed, svi (2
   epochs, batch 64, one graph replay a minibatch); smc one pass at scale
   0.01 (779 training documents, V = 1,000, 83,653 tokens: its absorb is
   one token at a time, one graph replay a 64; the resample kernels
   launched once a token, and once for the warm-up step, exactly); tokens/s,
   training and held-out perplexity each,
   training perplexity below V; CVB0's invariants and a second run from
   the seed bitwise equal; Warp's counts a recount of z; SMC's weights sum
   to 1 and z in range; SVI's lambda finite and positive; CVB0's scatter
   launched exactly twice a block and sweep (one replay a sweep);
10. backends resume: the CLI on the card (in this process), cvb0 and svi
   20 sweeps straight against 10 then ``--resume`` to 20 (the ten
   artifacts byte-identical); ``--backend smc|warp --checkpoint-every 5``
   and ``--backend cvb0 --check-counts`` exit 2 with the reference's words;
   ``--chains 4 --metrics-file`` writes rows with ``r_hat``;
11. ladder: ``python -m ldagibbssampling_tpu_torch.benchmarks.ladder
   --rungs 1,2,3,4,5 --scale 0.01`` as a subprocess (rung 3 floored at 2^24
   training tokens on the card): exit 0, no gate failure, each rung's dict
   printed;
12. mesh: the parallel runtimes (``parallel/``), each replaying one CUDA
   graph a sweep (``MeshRuntime.sweep``), each in the deferred tier
   with its kernels' launches counted exactly (the graph's warm-up sweep
   once per runtime), every table an exact
   recount: rung 3 through ``ladder.rung3`` at scale 0.2 (V = 100,000,
   K = 100, 60,000 NYT-shaped documents, ~17.1M training tokens, block
   65,536, on every position: one here; two warm-up sweeps and 10 timed;
   tokens/s, set-up seconds and, of those, ``plan_s``: the seconds of the
   deferred layouts, ``plan_timer``); the same corpus as four shards on the one
   card (5 timed sweeps, one sweep under CUDA's sync debug mode set to
   error); the four shards saved,
   run 3 sweeps on, restored and run the same 3 (bitwise); the 2x2 grid,
   token=4 and chain=2,data=2 at rung 3's 0.02 on four positions of the
   card (a call that captures, then 3 sweeps each, one sharded Minka
   update, one LL on the card: the
   chain mesh records both chains' and holds chain 0's to the host formula
   within relative 1e-9).  ``[graphs mesh ...]``: each runtime's graph
   against its eager sweep (``_eager_sweeps``, op by op from the host)
   from the same state, seeds and noise, 2 sweeps and then one at other
   alpha and beta each way, z and every table bitwise at every position:
   the four shards at 0.2, AD-LDA on four positions at 0.02 in the
   deferred, fused and XLA tiers, the grid, token=4 and chain=2,data=2,
   each in internal noise (ms and tokens/s a sweep both ways, 10 captured
   sweeps in one call, host calls and graph launches a sweep from
   ``torch.profiler``, one eager sweep's ``psum`` by CUDA events, nodes,
   set-up and capture seconds, peak memory) and in external noise (made
   on the card); then the CLI with
   ``--mesh data=-1`` killed at 30 and resumed to 60 (the ten artifacts
   byte-identical).  12b, ``[mesh two processes]``: the multi-process
   branch (``psum``'s ``all_reduce`` across processes, ``gather``,
   ``global_devices``) with the real kernels: two fresh processes, each
   bringing up gloo itself (NCCL refuses two ranks on one card) and then
   ``initialize_distributed``, one position each on the card, train
   ``ShardedLda`` over ``{"data": 2}`` on rung 3's corpus at 0.2 and
   ``GridLda`` over ``{"data": 1, "vocab": 2}`` at 0.02, 10 sweeps each
   in the deferred tier through the graphs' split form (per sweep the
   graph before the reduction, the ``all_reduce`` on the host, the graph
   after): counts exact, launches counted exactly (per
   process and sweep one walk, one rebuild, one snapshot, and the warm-up
   sweep's), z and every
   table bitwise the one-process run's on two positions of the card, both
   processes exit 0; tokens/s, graph launches and ``all_reduce`` ms per
   sweep (CUDA events) and
   set-up seconds (and ``plan_s``) beside the card's name and power limit.
   NCCL itself is not run here (one card).  12c, ``[rung3 full]``: the
   main path at rung 3's full size, the reference ladder's NYT-shaped corpus
   at scale 1.0 (300,000 documents, V = 100,000, 5% held out, 96,728,858
   training tokens; generated once): ``make_backend`` -> ``LdaModel`` ->
   ``run_inference``, K = 100, block 65,536, the deferred tier (f32 chain,
   bf16 snapshot), 2 untimed and 10 timed sweeps, then
   ``check_counts_consistent``; exactly 13 walks (K = 100, the tagged
   walk; 12 sweeps and the graph's warm-up), 13 rebuilds and 14 snapshots,
   no other kernel and no plain version; prints ``corpus_s``, ``plan_s``,
   ``setup_s`` (plan + state init + transfer), tokens/s, peak device
   memory (``max_memory_allocated``), the host's peak RSS and the held-out
   perplexity on the 15,000 held-out documents; one checkpoint saved
   (seconds, bytes) and restored bitwise (the state, and the next sweep
   from it); then ``ladder.rung3(1.0)`` on the same corpus (one shard),
   its report and launches, and its runtime's graph against its eager
   sweep (``[graphs mesh rung3 full]``, 3 sweeps each way, bitwise).
13. ingest: the CLI's corpus ingest (``corpus/native.py``, the host C++
   library of ``csrc/ldacorpus.cc``, built by ``g++`` here) and the CLI end
   to end at rung 3's corpus size: rung 3's whole corpus at scale 0.2
   (60,000 NYT-shaped Zipf documents, V = 100,000, ~20M tokens; reduced
   from the reference's 300,000 documents) written as one ASCII text file
   per document, each word id a fixed term of 5-9 letters; read in this
   process by ``read_docs_routed``, which must take the native route and
   give the generator's documents and ids (one bijection, first-seen
   order); at 0.02 (6,000 documents) a corpus with capitals, tabs, form
   feeds, CRLF line ends, stopwords, URLs and digit-only tokens read by
   both routes, token ids, documents, vocabulary and term counts bitwise
   equal; then the port's CLI as a subprocess on the 0.2 directory
   (``--topics 100 --block-size 65536 --iterations 10 --check-counts``):
   exit 0, ``ingest: native`` in its log, the deferred tier in its metrics
   header, the counts consistent, its launches counted exactly; prints the
   write seconds, each route's tokens/s and the CLI's ingest, set-up and
   sweep seconds and ``plan_s``, with the host CPU's model name.

Each phase group ends with a ``[wall]`` line, the script's seconds so far.
Then it prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

Bounds (``bound_ms``) use the published H100 SXM peaks: 3.35 TB/s of HBM,
67 TFLOP/s of float32 and 134 TFLOP/s of packed bf16 outside the tensor
cores, with the bytes and operations of this run's own inputs; a bound is
the larger of the bytes' time and the operations' time.  K1's walk bound
(``walk_bound_ms``) counts the draw's bytes and operations plus the writes
and integer operations of the count moves of that very walk.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "ldagibbssampling_tpu_torch"

T, V, M, K = 1 << 20, 50_000, 4_096, 500
# a topic count at which the sweep's row tile is 2,048 tokens: K1's
# tagged walk folds four of a tile's records a thread
K_GENERAL = 100
BLOCK, ALPHA, BETA, SWEEPS = 65_536, 0.5, 0.1, 10
HBM_BYTES_PER_S = 3.35e12
# a float32 add's latency in cycles: the floor of a chain of dependent adds
SCATTER_ADD_CYCLES = 4
F32_OPS_PER_S = 67e12
# packed bf16 outside the tensor cores: twice the float32 rate (133.8
# TFLOP/s in NVIDIA's H100 architecture whitepaper, SXM part)
BF16_OPS_PER_S = 2 * F32_OPS_PER_S
# K1's internal-noise draw per (token, real topic), counted from the kernel
# source.  The noise, in float32 in every chain: Philox4x32-10 ~25 integer
# ops per topic, uniform 3, log ~10, bf16 reciprocal ~10
SAMPLE_NOISE_OPS = 48
# the conditional ~10, then score and argmax ~4.  A bf16 chain needs no more
# operations than the float32 one: float32's 24-bit significand is at least
# 2*8+2 bits for bf16's 8, so a float32 add, subtract or multiply of bf16
# values rounded to bf16 has one native bf16 op's bits (the double-rounding
# condition); its ops are charged at the packed-bf16 rate
SAMPLE_CONDITIONAL_OPS, SAMPLE_SCORE_OPS = 10, 4
# per (tile, real topic): the nk reciprocal, ~13
SAMPLE_OPS_PER_TILE_TOPIC = 13
CHAIN_SETTINGS = (("bfloat16", "bfloat16"), ("bf16p", "bfloat16"),
                  ("float32", "float32"), ("bfloat16", "float32"),
                  ("bf16p", "float32"))
QUALITY_SWEEPS, LL_EVERY = 20, 5
# the quality runs use the planted corpus's own priors (data/synthetic.py):
# at bench.py's alpha 0.5, K*alpha = 250 outweighs a 256-token document and
# 20 sweeps barely move the perplexity
QUALITY_ALPHA, QUALITY_BETA = 0.1, 0.05
# per (token, topic) of K3's internal-noise draw, the work no design avoids:
# the Gumbel noise's two logf ~20, a quarter of Philox4x32-10 ~25, the
# uniform 3, the conditional's three table lookups (an index and a shared
# load each) ~3, the score's three adds 3 and the argmax ~4.  The
# conditional's three logf are not counted: they take 2K + 2 * LOG_TABLE
# distinct values per launch (ops/sample_kernel.py), so the kernel looks them
# up (the count before its tables was 90: five logf ~50)
BLOCK_SAMPLE_OPS_PER_ELEM = 58
MIN_MATCH = 0.9999
MODES = ("deterministic", "external", "internal")
# the kernels each tier's sweep launches, by use_pallas
# (the deferred tier's depend on its chain and snapshot: main_path)
TIER_KERNELS = {
    "fused": ("gibbs_tile_sample_live", "count_move"),
    True: ("gibbs_block_sample", "count_move"),
    False: (),
}
TIER_NAMES = {"deferred": "deferred", "fused": "fused", True: "pallas-draw",
              False: "xla"}
HELDOUT_FRAC, HELDOUT_HOST_DOCS = 0.05, 32
PARITY_K, PARITY_SWEEPS, PARITY_SEEDS, PARITY_BLOCK = 5, 30, (0, 1, 2, 3), 256
PARITY_MAX_Z = 4.0
# the bench script's tiers (LDA_BENCH_PALLAS) and timed sweeps: the XLA
# sweep takes ~96 ms at bench.py's shape
BENCH_RUNS = (("deferred", 100), ("fused", 100), ("1", 100), ("0", 20))
# the ladder's rung 4 (chains) and rung 5 (backends) configurations at a
# scale whose vocabulary is the rung's full V = 20,000; SMC at rung 5's
# scale 0.01 (820 documents, V = 1,000): its absorb is one token at a time.
# (backend, untimed warm-up sweeps, timed sweeps, scale): the warm-up takes
# the first sweep's allocations out of the timed ones
# the mesh phase: rung 3 at a scale whose vocabulary is the rung's full
# V = 100,000 (60,000 documents, ~17.1M training tokens), the four-shard run
# on its corpus, and the grid, token and chain meshes at rung 3's 0.02
MESH_SCALE, MESH_SMALL_SCALE = 0.2, 0.02
MESH_SWEEPS, MESH_FOUR_SWEEPS, MESH_SMALL_SWEEPS = 10, 5, 3
# [graphs mesh ...]: captured sweeps timed in one call after the comparison
MESH_GRAPH_TIMED = 10
# [rung3 full]: rung 3 at the reference's own size (300,000 documents,
# V = 100,000, 96,728,858 training tokens), two untimed sweeps and 10 timed
FULL_SCALE, FULL_WARMUP, FULL_SWEEPS = 1.0, 2, 10
# the modules that call the deferred planner, each under its own name for
# it (plan_timer wraps them)
PLAN_USERS = ("models.lda", "parallel.adlda", "parallel.grid", "parallel.tokenshard")
# [mesh two processes]: two processes on the one card (gloo), each run's
# sweeps; the worker's entry point, run by a fresh interpreter
MESH2_SWEEPS, MESH2_TIMEOUT_S = 10, 300
_MESH2_WORKER = (
    "import sys\n"
    "import chip_smoke\n"
    "sys.exit(chip_smoke.mesh2_worker(*sys.argv[1:]))\n")
# [multichain]: the ladder's rung 4 at its full size (40,000 documents,
# V = 20,000, 3,437,212 tokens); [multichain wide]: K = 500 and 4 chains on
# bench.py's shape (BASELINE's configuration 4's topic count and chains; its
# Wikipedia corpus is not in the repository).  Sweeps of the main run, and
# of each form per round of the batched-against-in-turn check
MULTICHAIN_SCALE, MULTICHAIN_SWEEPS, MULTICHAIN_COMPARE = 1.0, 20, 2
WIDE_SWEEPS, WIDE_COMPARE = 10, 2
# each phase's run with LL rows when the chains' phi R-hat and the runner's
# LL row ran on the host (numpy), in seconds, on an H100 80GB HBM3 at 700 W
HOST_DIAGNOSTICS_RUN_S = {"multichain": "6.68-7.38", "multichain wide": "44.17-48.13"}
# the CUDA runtime calls that enqueue device work, by name prefix
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
# SMC's runs ([kernels] smc_resample, [graphs smc], [backends] smc): rung 5
# at 0.01, the model's default 16 particles, rung 5's K = 15; [graphs smc]'s
# eager absorb covers one noise block; [graphs svi] times STEPS steps alone
SMC_SCALE, SMC_PARTICLES, BACKEND_K, SMC_PROFILED = 0.01, 16, 15, 1_024
SVI_SCALE, SVI_BATCH, SVI_STEPS = 0.2, 64, 20
# [backends], [graphs cvb0], [graphs warp] and [kernels] cvb0_scatter: rung 5
# at 0.2 (V = 20,000, ~1.67M training tokens, K = 15, block 8,192)
BACKEND_SCALE = 0.2
BACKEND_RUNS = (("gibbs", 1, 4, 0.2), ("cvb0", 1, 4, 0.2), ("svi", 0, 2, 0.2),
                ("warp", 1, 4, 0.2), ("smc", 0, 1, 0.01))
LADDER_SCALE = 0.01
# the ingest phase: rung 3's whole corpus (before its held-out split) at
# scale 0.2, reduced from the reference's 1 as the mesh phase's (60,000
# documents, V = 100,000, ~20M tokens), written as text and read by the
# CLI's ingest; the native and Python routes held bitwise at rung 3's 0.02
INGEST_SCALE, INGEST_SMALL_SCALE, INGEST_SWEEPS = 0.2, 0.02, 10
# what the messy 0.02 corpus puts between the generator's words: separators
# with CRLF line ends, and stopwords, URLs and digit-only tokens, which
# the ingest drops
INGEST_SEPS = (b" ", b"\t", b"\r\n", b" \t ", b"\f", b"  \r\n")
INGEST_DROPPED = (b"the", b"And", b"OF", b"http://example.org/a", b"www.news.net",
                  b"shop.com", b"SHOP.COM", b"2024", b"42", b"1.5", b"...")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def synth_corpus(seed: int):
    """bench.py's corpus: Zipf(1.1) word ids truncated to V, equal docs."""
    import numpy as np

    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

    rng = np.random.default_rng(seed)
    tw = ((rng.zipf(1.1, size=T).astype(np.int64) - 1) % V).astype(np.int32)
    td = (np.arange(T, dtype=np.int64) * M // T).astype(np.int32)
    doc_ptr = np.zeros(M + 1, np.int32)
    np.cumsum(np.bincount(td, minlength=M), out=doc_ptr[1:])
    return FlatCorpus(tw, td, doc_ptr, V)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events, after
    one warm-up call).  For a kernel of a few microseconds this is the
    host's time per launch of its wrapper: ``device_ms`` is the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, counter: str, reps: int = 5):
    """The device ms per launch of the kernel behind ``counter`` over
    ``reps`` calls of ``fn``, from ``torch.profiler``; raises where it
    recorded no launch of that kernel (a renamed kernel, or a counter
    mapped to the wrong one), so that no host time stands in for it."""
    from ldagibbssampling_tpu_torch.evaluation.tracing import kernel_device_ms

    # the CUDA kernel's name where it is not the counter's: K1's draws are
    # walks, and count_move launches gibbs_tile_update
    kernel = ("gibbs_walk" if counter.startswith("gibbs_tile_sample") else
              "gibbs_tile_update" if counter == "count_move" else counter)
    # the profiler has been seen to record no launch of a kernel in a
    # session now and then (K1's walk at K = 100): more tries before calling
    # the kernel's name wrong
    for _ in range(3):
        ms = kernel_device_ms(fn, kernel, reps)
        if ms is not None:
            return ms
    raise RuntimeError(f"the profiler recorded no device time of {kernel!r} "
                       f"({counter}) in three tries")


def call_device_ms(fn, reps: int = 20):
    """The device ms per call of ``fn`` (every kernel, memset and copy it
    launches) from ``torch.profiler``, for a library call beside a kernel's
    ``device_ms``; ``None`` (not measured) where three sessions recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            return sum(us) / reps / 1e3
    return None


def bound(nbytes: float, ops: float, bf16_ops: float = 0) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of HBM traffic, ``ops`` float32
    operations and ``bf16_ops`` packed-bf16 ones, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sample_ops(n_real: int, n_tiles: int, chain: str, k: int = K) -> tuple[int, int]:
    """(float32, packed-bf16) operations of K1's internal-noise draw of
    ``n_real`` tokens in ``n_tiles`` tiles at ``k`` topics in the chain
    ``chain``."""
    f32 = n_real * k * SAMPLE_NOISE_OPS + n_tiles * k * SAMPLE_OPS_PER_TILE_TOPIC
    cond, score = n_real * k * SAMPLE_CONDITIONAL_OPS, n_real * k * SAMPLE_SCORE_OPS
    if chain == "float32":
        return f32 + cond + score, 0
    if chain == "bf16p":  # bf16 conditional, float32 score
        return f32 + score, cond
    return f32, cond + score


def moved_cells(z, z_new, d, real, k: int = K) -> tuple[int, int, int]:
    """What the count moves of one block change: (doc cells, topic totals,
    moved tokens)."""
    import torch

    moved = (z_new != z) & real
    dk = d[moved].long() * k
    cells = torch.unique(torch.cat([dk + z[moved].long(), dk + z_new[moved].long()]))
    topics = torch.unique(torch.cat([z[moved], z_new[moved]]))
    return cells.numel(), topics.numel(), int(moved.sum())


def update_bound(z, z_new, d, real) -> tuple[float, str]:
    """The bound of K1's count moves of one block as a function of their
    own: token arrays read once, each changed doc cell and topic total read
    and written once, 4 integer operations per moved token."""
    cells, topics, moved = moved_cells(z, z_new, d, real)
    return bound(BLOCK * 4 * 4 + (cells + topics) * 8, 4 * moved)


def walk_bound(draw_bytes: int, draw_ops: tuple[int, int], z, z_new, d, real,
               k: int = K) -> tuple[float, str]:
    """The bound of K1's whole walk of one block: the draw's bytes and
    operations plus what its count moves add, a write of each doc cell and
    topic total they change (the draw already reads the block's doc rows,
    ``nk`` and token arrays) and 4 integer operations per moved token.
    Bytes and operations overlap, so one bound of the totals."""
    cells, topics, moved = moved_cells(z, z_new, d, real, k)
    f32, bf16 = draw_ops
    return bound(draw_bytes + (cells + topics) * 4, f32 + 4 * moved, bf16)


def sweep_values(seed: int, device: str = "cuda", k: int = K) -> dict:
    """K1's and K3's device values at bench.py's V: alpha, beta, V*beta and
    K*alpha as the sweep forms them (``scalars``), and the seed's word
    (``key``)."""
    import numpy as np

    from ldagibbssampling_tpu_torch.ops._device import (
        device_values, seed_word, sweep_scalars)

    return dict(scalars=device_values(sweep_scalars(ALPHA, BETA, V, k), device),
                key=device_values(np.array([seed_word(seed)], np.int64), device))


def walk_report(res: dict, name: str, rows, ndk, nk, z, w, d, m, *, chain: str,
                row_tile: int, values: dict, draw_cost: tuple, k: int = K,
                prefix: str = "") -> None:
    """K1's whole walk over one block (draw and count move per tile, one
    launch, internal noise at ``values``' scalars and seed) with its bound
    from that walk's own moves (``draw_cost``: the draw's bytes and
    operations), and its fixed cost: the same walk with every token masked
    (the waits between tiles, index loads), per tile, in device time
    (events where the profiler misses the launch: a walk shorter than its
    wrapper's host work times the host)."""
    import torch

    from ldagibbssampling_tpu_torch.evaluation.tracing import kernel_device_ms
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk

    ndk_w, nk_w = ndk.clone(), nk.clone()

    def reset():
        ndk_w.copy_(ndk)
        nk_w.copy_(nk)

    def walk(mask):
        return fk.gibbs_tiles(rows, ndk_w, nk_w, z, w, d, mask, row_tile=row_tile,
                              noise_mode="internal", compute_dtype=chain,
                              **values)

    def whole():
        reset()
        walk(m)

    reset()
    b_ms, _ = walk_bound(*draw_cost, z, walk(m), d, m > 0, k)
    masked = torch.zeros_like(m)
    n_tiles = -(-z.shape[0] // row_tile)
    res[f"{prefix}walk_ms"] = ms = cuda_ms(whole) - cuda_ms(reset)
    # an extra column beside walk_ms (events, which time a walk of tenths of
    # a ms well): None, "not measured", where the profiler missed the launch
    res[f"{prefix}walk_device_ms"] = dev_ms = kernel_device_ms(whole, "gibbs_walk")
    res[f"{prefix}walk_bound_ms"] = b_ms
    fixed_ms = kernel_device_ms(lambda: walk(masked), "gibbs_walk")
    res[f"{prefix}fixed_us_per_tile"] = fixed = (
        (cuda_ms(lambda: walk(masked)) if fixed_ms is None else fixed_ms)
        * 1e3 / n_tiles)
    log(f"[kernels] {name} walk (draw + move, one launch) at K={k}: {ms:.4f} ms "
        f"per block of {z.shape[0]} tokens, device "
        f"{'not measured' if dev_ms is None else dev_ms} ms per launch "
        f"(bound {b_ms:.4f} ms); all masked "
        f"{fixed:.3f} us per tile of {row_tile}")


def check_kernels(corpus, seed: int, device: str = "cuda") -> dict:
    """Phase 3: the deferred tier's kernels against their plain versions,
    and their times."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops import count_kernel as ck
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

    dev = torch.device(device)
    t0 = time.perf_counter()
    plan = ck.plan_deferred(corpus.token_word, corpus.token_doc, V, BLOCK)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K, seed=seed,
                    device=dev)
    log(f"[kernels] plan + init {time.perf_counter() - t0:.2f}s: "
        f"T_pad={plan.num_tokens} v_pad={plan.v_pad}")
    k_pad, v_pad = -(-K // 128) * 128, plan.v_pad
    row_tile = _pick_row_tile(BLOCK, K)
    # K1 and its plain version read alpha, beta, V*beta and the seed from
    # the same device tensors
    v1234, v7 = sweep_values(seed + 1234, device), sweep_values(7, device)

    def on_dev(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    tw, td, tm = (on_dev(a) for a in (plan.token_word, plan.token_doc,
                                      plan.token_mask))
    blk = slice(0, BLOCK)
    w, d, m, z = tw[blk], td[blk], tm[blk], st.z[blk].contiguous()
    real = m > 0
    n_real = int(real.sum())
    out: dict = {}

    # --- K2 cast_mirror (also makes the snapshot K1 reads)
    nwk_pad = F.pad(st.nwk, (0, k_pad - K, 0, v_pad - V)).contiguous()
    mirror = ck.cast_mirror(nwk_pad)
    mirror_p = ck.cast_mirror_plain(nwk_pad)
    torch.cuda.synchronize()
    err = float((mirror.float() - mirror_p.float()).abs().max())
    if not torch.equal(mirror, mirror_p):
        raise AssertionError(f"cast_mirror differs from its plain version: {err}")
    out["cast_mirror"] = dict(max_abs_err=err)

    # --- K1 walked over one block, per (chain, snapshot) and noise mode
    g = torch.Generator(device=dev).manual_seed(seed)
    uniforms = torch.rand((BLOCK, k_pad), generator=g, device=dev) * (1 - 2e-7) + 1e-7
    snaps = {"bfloat16": mirror, "float32": nwk_pad.float()}
    settings = {}  # counter name -> (chain, snapshot)
    for chain, rows in (("float32", "bfloat16"), *CHAIN_SETTINGS):
        name = fk.sample_name(snaps[rows].dtype, chain)
        settings[name] = (chain, rows)
        for mode in MODES:
            res = []
            for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
                ndk, nk = st.ndk.clone(), st.nk.clone()
                zn = walk(snaps[rows], ndk, nk, z, w, d, m, noise_mode=mode,
                          row_tile=row_tile, uniforms=uniforms,
                          compute_dtype=chain, **v1234)
                torch.cuda.synchronize()
                res.append((zn, ndk, nk))
            (zk, ndk_k, nk_k), (zp, ndk_p, nk_p) = res
            diff = ((zk != zp) & real).nonzero().flatten()
            match = 1.0 - diff.numel() / n_real
            moved = float(((zk != z) & real).float().mean())
            c_err = float(max((ndk_k - ndk_p).abs().max(), (nk_k - nk_p).abs().max()))
            log(f"[kernels] K1 chain {chain}, {rows} snapshot, {mode}: z equal on "
                f"{match:.6f} of {n_real} tokens, {moved:.3f} of tokens moved")
            for i in diff[:20].tolist():
                log(f"  token {i}: kernel z={int(zk[i])} plain z={int(zp[i])}")
            if mode == "deterministic":
                if diff.numel() or c_err:
                    raise AssertionError(
                        f"K1 {name} deterministic differs: z {diff.numel()} tokens, "
                        f"counts {c_err}")
                out[name] = dict(max_abs_err=float((zk - zp).abs().max()))
                if name == "gibbs_tile_sample":
                    out["gibbs_tile_update"] = dict(max_abs_err=c_err)
            elif match < MIN_MATCH:
                raise AssertionError(f"K1 {name} {mode}: z equal on only {match:.6f}")
            elif diff.numel() == 0 and c_err:
                raise AssertionError(f"K1 {name} {mode}: equal z, counts differ by {c_err}")
            else:
                out[name][f"z_match_{mode}"] = match

    # --- K2 rebuild over the whole stream
    nwk_k, nk_k = ck.rebuild_counts(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad)
    nwk_p, nk_p = ck.rebuild_counts_plain(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad)
    torch.cuda.synchronize()
    r_err = float(max((nwk_k - nwk_p).abs().max(), (nk_k - nk_p).abs().max()))
    if not (torch.equal(nwk_k, nwk_p) and torch.equal(nk_k, nk_p)):
        raise AssertionError(f"rebuild_counts differs from its plain version: {r_err}")
    out["rebuild_counts"] = dict(max_abs_err=r_err)
    # build_nwk without the mirror (the float32-snapshot path): one rebuild
    counted = tracing.counters()
    nwk_n, nk_n = ck.build_nwk(st.z, tw, tm, vocab_size=V, num_topics=K,
                               v_pad=v_pad, k_pad=k_pad, emit_mirror=False)
    torch.cuda.synchronize()
    n_err = float(max((nwk_n - nwk_p[:V, :K]).abs().max(),
                      (nk_n - nk_p[:K]).abs().max()))
    if n_err or kernel_counts(counted)[0]["cast_mirror"]:
        raise AssertionError(f"build_nwk(emit_mirror=False) differs ({n_err}) or "
                             "cast a mirror")
    out["rebuild_counts"]["no_mirror_max_abs_err"] = n_err
    log("[kernels] K2 rebuild_counts, cast_mirror and build_nwk(emit_mirror=False) "
        "bitwise equal to plain")

    # --- times (internal noise: the main path's mode)
    def sample_kernel(chain="float32", rows="bfloat16"):
        return fk.gibbs_tile_sample(snaps[rows], st.ndk, st.nk, z, w, d, m,
                                    noise_mode="internal", row_tile=row_tile,
                                    compute_dtype=chain, **v7)

    def sample_plain(chain="float32", rows="bfloat16"):
        for s in range(0, BLOCK, row_tile):
            sl = slice(s, s + row_tile)
            fk.sample_plain(snaps[rows], st.ndk, st.nk, z[sl], w[sl], d[sl], m[sl],
                            noise_mode="internal", slot0=s, compute_dtype=chain,
                            **v7)

    z_new = sample_kernel()
    ndk_c, nk_c = st.ndk.clone(), st.nk.clone()

    def update_kernel():
        fk.gibbs_tile_update(ndk_c, nk_c, z, z_new, d, m)

    def update_plain():
        for s in range(0, BLOCK, row_tile):
            sl = slice(s, s + row_tile)
            fk.update_plain(ndk_c, nk_c, z[sl], z_new[sl], d[sl], m[sl])

    key = (tw.long() * k_pad + st.z.long())[tm > 0]
    times = {  # (the kernel's call, plain ms, library ms)
        **{name: (lambda cr=cr: sample_kernel(*cr),
                  cuda_ms(lambda: sample_plain(*cr)), None)
           for name, cr in settings.items()},
        "gibbs_tile_update": (update_kernel, cuda_ms(update_plain), None),
        "rebuild_counts": (
            lambda: ck.rebuild_counts(st.z, tw, tm, v_pad=v_pad, k_pad=k_pad),
            cuda_ms(lambda: ck.rebuild_counts_plain(st.z, tw, tm, v_pad=v_pad,
                                                    k_pad=k_pad)),
            cuda_ms(lambda: torch.bincount(key, minlength=v_pad * k_pad))),
        "cast_mirror": (
            lambda: ck.cast_mirror(nwk_pad),
            cuda_ms(lambda: ck.cast_mirror_plain(nwk_pad)),
            cuda_ms(lambda: nwk_pad.to(torch.bfloat16))),
    }

    # --- bounds from this run's inputs
    wb = plan.token_word[blk][plan.token_mask[blk] > 0]
    db = plan.token_doc[blk][plan.token_mask[blk] > 0]
    u_words, u_docs = np.unique(wb).size, np.unique(db).size
    t_pad = plan.num_tokens
    draw_cost = {name: (u_words * k_pad * snaps[rows].element_size() + u_docs * K * 4
                        + K * 4 + BLOCK * 4 * 5,
                        sample_ops(n_real, BLOCK // row_tile, chain))
                 for name, (chain, rows) in settings.items()}
    bounds = {
        **{name: bound(nbytes, *ops) for name, (nbytes, ops) in draw_cost.items()},
        "gibbs_tile_update": update_bound(z, z_new, d, real),
        "rebuild_counts": bound(t_pad * 12 + v_pad * k_pad * 4 + k_pad * 4,
                                2 * int(tm.sum())),
        "cast_mirror": bound(v_pad * k_pad * 6, v_pad * k_pad),
    }
    units = {
        **{name: f"one block of {BLOCK} tokens ({BLOCK // row_tile} tiles, one launch)"
           for name in settings},
        "gibbs_tile_update": f"one block of {BLOCK} tokens (one launch)",
        "rebuild_counts": f"one rebuild of {t_pad} stream slots",
        "cast_mirror": f"one [{v_pad}, {k_pad}] table",
    }
    report(out, times, bounds, units)
    # the library calls' device time per call, beside their event times
    for name, lib in (
            ("rebuild_counts", lambda: torch.bincount(key, minlength=v_pad * k_pad)),
            ("cast_mirror", lambda: nwk_pad.to(torch.bfloat16))):
        out[name]["library_device_ms"] = ms = call_device_ms(lib)
        log(f"[kernels] {name}'s library call: device {ms} ms per call "
            f"(events {out[name]['library_ms']:.4f} ms)")
    for name, (chain, rows) in settings.items():
        walk_report(out[name], name, snaps[rows], st.ndk, st.nk, z, w, d, m,
                    chain=chain, row_tile=row_tile, values=v7,
                    draw_cost=draw_cost[name])
    return out


def check_general_walk(corpus, seed: int, device: str = "cuda") -> dict:
    """Phase 3d: K1 at K = 100, where the sweep's row tile is 2,048 and
    the tagged walk (walk_pipelined) folds four of a tile's records a
    thread, over 32 tiles: the first block of the deferred layout against
    the plain walk in the three noise modes (bitwise), then its whole walk
    and fixed cost per tile."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops import count_kernel as ck
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

    dev = torch.device(device)
    plan = ck.plan_deferred(corpus.token_word, corpus.token_doc, V, BLOCK)
    st = init_state(plan.token_word, plan.token_doc, plan.token_mask,
                    num_docs=M, vocab_size=V, num_topics=K_GENERAL, seed=seed,
                    device=dev)
    k_pad, row_tile = 128, _pick_row_tile(BLOCK, K_GENERAL)
    cfg = fk.walk_config(torch.bfloat16, "float32", "internal", k_pad, BLOCK,
                         row_tile, ndk_bytes=st.ndk.nbytes)
    if not cfg["pipelined"]:
        raise AssertionError(f"K={K_GENERAL}, row tile {row_tile}: {cfg}")
    mirror = ck.cast_mirror(F.pad(st.nwk, (0, k_pad - K_GENERAL, 0,
                                           plan.v_pad - V)).contiguous())
    w, d, m = (torch.from_numpy(np.array(a[:BLOCK], np.int32)).to(dev)
               for a in (plan.token_word, plan.token_doc, plan.token_mask))
    z = st.z[:BLOCK].contiguous()
    values = sweep_values(seed + 1234, device, K_GENERAL)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    uniforms = torch.rand((BLOCK, k_pad), generator=g, device=dev) * (1 - 2e-7) + 1e-7
    for mode in MODES:
        res = []
        for walk in (fk.gibbs_tiles, fk.gibbs_tiles_plain):
            ndk, nk = st.ndk.clone(), st.nk.clone()
            zn = walk(mirror, ndk, nk, z, w, d, m, row_tile=row_tile, noise_mode=mode,
                      uniforms=uniforms, **values)
            torch.cuda.synchronize()
            res.append((zn, ndk, nk))
        if not all(torch.equal(a, b) for a, b in zip(*res)):
            raise AssertionError(f"K1 at K={K_GENERAL} (walk_pipelined), {mode}: "
                                 "the walk differs from the plain walk")
    real = m > 0
    n_real = int(real.sum())
    log(f"[kernels] K1 at K={K_GENERAL}, row tile {row_tile} ({BLOCK // row_tile} "
        f"tiles, {cfg['team']} threads per token, tagged records): z, ndk "
        f"and nk equal to the plain walk in all three modes")
    nbytes = (torch.unique(w[real]).numel() * k_pad * 2
              + torch.unique(d[real]).numel() * K_GENERAL * 4 + K_GENERAL * 4
              + BLOCK * 4 * 5)
    out: dict = {}
    walk_report(out, "gibbs_tile_sample", mirror, st.ndk, st.nk, z, w, d, m,
                chain="float32", row_tile=row_tile,
                values=sweep_values(7, device, K_GENERAL),
                draw_cost=(nbytes, sample_ops(n_real, BLOCK // row_tile, "float32",
                                              K_GENERAL)),
                k=K_GENERAL, prefix=f"k{K_GENERAL}_")
    return out


def check_live_kernels(corpus, seed: int, device: str = "cuda") -> dict:
    """Phase 3b: the fused and v1 tiers' kernels against their plain
    versions, on the first block of their layout (``pad_to`` +
    ``sort_within_blocks``), and their times."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.models.state import init_state
    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile
    from ldagibbssampling_tpu_torch.ops._device import (
        device_values, seed_word, sweep_scalars)

    dev = torch.device(device)
    pc, _ = corpus.pad_to(BLOCK).sort_within_blocks(BLOCK)
    st = init_state(pc.token_word, pc.token_doc, pc.token_mask, num_docs=M,
                    vocab_size=V, num_topics=K, seed=seed + 1, device=dev)
    k_pad = -(-K // 128) * 128
    row_tile = _pick_row_tile(BLOCK, K)
    # K1, K3 and their plain versions read alpha, beta, V*beta and the seed
    # from the same device tensors
    k3_scalars = device_values(sweep_scalars(ALPHA, BETA, V, K), dev)
    v1234, v7 = sweep_values(seed + 1234, device), sweep_values(7, device)

    def k3_key(s: int):
        return device_values(np.array([seed_word(s)], np.int64), dev)

    def on_dev(a):
        return torch.from_numpy(np.array(a[:BLOCK], np.int32)).to(dev)

    w, d, m = (on_dev(a) for a in (pc.token_word, pc.token_doc, pc.token_mask))
    z = st.z[:BLOCK].contiguous()
    real = m > 0
    n_real = int(real.sum())
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    u_live = torch.rand((BLOCK, k_pad), generator=g, device=dev) * (1 - 2e-7) + 1e-7
    u_k3 = torch.rand((BLOCK, K), generator=g, device=dev) * (1 - 2e-7) + 1e-7
    out: dict = {}

    def compare(label, zk, zp):
        diff = ((zk != zp) & real).nonzero().flatten()
        match = 1.0 - diff.numel() / n_real
        moved = float(((zk != z) & real).float().mean())
        log(f"[kernels] {label}: z equal on {match:.6f} of {n_real} tokens, "
            f"{moved:.3f} of tokens moved")
        for i in diff[:20].tolist():
            log(f"  token {i}: kernel z={int(zk[i])} plain z={int(zp[i])}")
        return diff.numel(), match

    # --- K1 on the live int32 table, then the block's nwk count move
    for mode in MODES:
        res = []
        for walk, move in ((fk.gibbs_tiles, fk.count_move),
                           (fk.gibbs_tiles_plain, fk.count_move_plain)):
            nwk, ndk, nk = st.nwk.clone(), st.ndk.clone(), st.nk.clone()
            zn = walk(nwk, ndk, nk, z, w, d, m, row_tile=row_tile,
                      noise_mode=mode, uniforms=u_live, **v1234)
            move(z, zn, m, nwk=nwk, token_word=w)
            torch.cuda.synchronize()
            res.append((zn, nwk, ndk, nk))
        n_diff, match = compare(f"K1 live table + nwk move, {mode}", res[0][0], res[1][0])
        c_err = float(max((a - b).abs().max() for a, b in zip(res[0][1:], res[1][1:])))
        if mode == "deterministic":
            if n_diff or c_err:
                raise AssertionError(
                    f"K1 live deterministic differs: z {n_diff} tokens, counts {c_err}")
            out["gibbs_tile_sample_live"] = dict(
                max_abs_err=float((res[0][0] - res[1][0]).abs().max()))
            out["count_move"] = dict(max_abs_err=c_err)
        elif match < MIN_MATCH:
            raise AssertionError(f"K1 live {mode}: z equal on only {match:.6f}")
        else:
            if n_diff == 0 and c_err:
                raise AssertionError(f"K1 live {mode}: equal z, counts differ by {c_err}")
            out["gibbs_tile_sample_live"][f"z_match_{mode}"] = match

    # --- K3, all three noise modes
    draws = {}
    for mode in MODES:
        zk = sk.sample_block(st.nwk, st.ndk, st.nk, z, w, d, noise_mode=mode,
                             scalars=k3_scalars, key=k3_key(seed + 4321),
                             uniforms=u_k3)
        zp = sk.sample_block_plain(st.nwk, st.ndk, st.nk, z, w, d, noise_mode=mode,
                                   scalars=k3_scalars, key=k3_key(seed + 4321),
                                   uniforms=u_k3)
        torch.cuda.synchronize()
        n_diff, match = compare(f"K3 {mode}", zk, zp)
        draws[mode] = torch.where(real, zk, z)
        if mode == "deterministic":
            if n_diff:
                raise AssertionError(f"K3 deterministic differs on {n_diff} tokens")
            out["gibbs_block_sample"] = dict(
                max_abs_err=float(((zk - zp) * real).abs().max()))
        elif match < MIN_MATCH:
            raise AssertionError(f"K3 {mode}: z equal on only {match:.6f}")
        else:
            out["gibbs_block_sample"][f"z_match_{mode}"] = match

    # --- K3 where counts pass its log tables' end: the block's most frequent
    # word's row and its first document's row straddle the last entry and
    # every fifth cell lies far past it (the kernel computes those logs)
    hot_w = int(torch.bincount(w[real].long()).argmax())
    nwk_hot, ndk_hot = st.nwk.clone(), st.ndk.clone()
    g_hot = torch.Generator(device=dev).manual_seed(seed + 5)
    for table, row in ((nwk_hot, hot_w), (ndk_hot, int(d[0]))):
        table[row] = torch.randint(sk.LOG_TABLE - 3, sk.LOG_TABLE + 4, (K,),
                                   generator=g_hot, device=dev, dtype=torch.int32)
        table[row, ::5] = 5 * sk.LOG_TABLE
    for mode in MODES:
        zk = sk.sample_block(nwk_hot, ndk_hot, st.nk, z, w, d, noise_mode=mode,
                             scalars=k3_scalars, key=k3_key(seed + 4321),
                             uniforms=u_k3)
        zp = sk.sample_block_plain(nwk_hot, ndk_hot, st.nk, z, w, d,
                                   noise_mode=mode, scalars=k3_scalars,
                                   key=k3_key(seed + 4321), uniforms=u_k3)
        torch.cuda.synchronize()
        n_diff, match = compare(f"K3 {mode}, counts past the log tables", zk, zp)
        if (n_diff and mode == "deterministic") or match < MIN_MATCH:
            raise AssertionError(f"K3 {mode} past the tables: {n_diff} tokens differ")
        out["gibbs_block_sample"][f"z_match_past_table_{mode}"] = match

    # --- the count move of all three tables and the write-back of z (the
    # v1 tier's form)
    z_new = draws["internal"]
    z_raw = torch.where(real, z_new, z.flip(0))  # masked draws to discard
    tables = []
    for move in (fk.count_move, fk.count_move_plain):
        t = dict(nwk=st.nwk.clone(), ndk=st.ndk.clone(), nk=st.nk.clone())
        z_out = z.clone()
        move(z_out, z_raw, m, token_word=w, token_doc=d, z_out=z_out, **t)
        torch.cuda.synchronize()
        tables.append((t, z_out))
    m_err = float(max((tables[0][0][n] - tables[1][0][n]).abs().max()
                      for n in tables[0][0]))
    if m_err or not torch.equal(tables[0][1], tables[1][1]) or not torch.equal(
            tables[0][1], z_new):
        raise AssertionError(f"count move (three tables, z written back) differs "
                             f"from plain: {m_err}")
    out["count_move"]["max_abs_err"] = max(out["count_move"]["max_abs_err"], m_err)
    log("[kernels] count move of nwk, ndk and nk and its write-back of z bitwise "
        "equal to plain")

    # --- times (internal noise: the main paths' mode)
    def live_kernel():
        return fk.gibbs_tile_sample(st.nwk, st.ndk, st.nk, z, w, d, m,
                                    row_tile=row_tile, noise_mode="internal",
                                    **v7)

    def live_plain():
        for s in range(0, BLOCK, row_tile):
            sl = slice(s, s + row_tile)
            fk.sample_plain(st.nwk, st.ndk, st.nk, z[sl], w[sl], d[sl], m[sl],
                            noise_mode="internal", slot0=s, **v7)

    key7 = k3_key(7)
    nwk_c = st.nwk.clone()
    moved = (z_new != z) & real
    flat = torch.cat([(w.long() * K + z.long())[moved],
                      (w.long() * K + z_new.long())[moved]])
    ones = torch.ones(int(moved.sum()), dtype=torch.int32, device=dev)
    vals = torch.cat([-ones, ones])
    t3 = dict(nwk=nwk_c, ndk=st.ndk.clone(), nk=st.nk.clone())
    z_back = z.clone()

    def move_three():  # the v1-draw tier's form, z written back
        fk.count_move(z, z_new, m, token_word=w, token_doc=d, z_out=z_back, **t3)

    times = {  # (the kernel's call, plain ms, library ms)
        "gibbs_tile_sample_live": (live_kernel, cuda_ms(live_plain), None),
        "gibbs_block_sample": (
            lambda: sk.sample_block(st.nwk, st.ndk, st.nk, z, w, d,
                                    noise_mode="internal", scalars=k3_scalars,
                                    key=key7),
            cuda_ms(lambda: sk.sample_block_plain(st.nwk, st.ndk, st.nk, z, w, d,
                                                  noise_mode="internal",
                                                  scalars=k3_scalars, key=key7)),
            None),
        # the fused tier's form: the block's word-topic moves
        "count_move": (
            lambda: fk.count_move(z, z_new, m, nwk=nwk_c, token_word=w),
            cuda_ms(lambda: fk.count_move_plain(z, z_new, m, nwk=nwk_c, token_word=w)),
            cuda_ms(lambda: nwk_c.view(-1).index_put_((flat,), vals, accumulate=True))),
    }
    out["count_move"]["ms_three_tables"] = device_ms(move_three, "count_move")
    out["count_move"]["event_ms_three_tables"] = cuda_ms(move_three)

    # --- bounds from this run's inputs
    u_words = torch.unique(w[real]).numel()
    u_docs = torch.unique(d[real]).numel()
    cells = torch.unique(flat).numel()
    live_cost = (u_words * K * 4 + u_docs * K * 4 + K * 4 + BLOCK * 4 * 5,
                 sample_ops(n_real, BLOCK // row_tile, "float32"))
    bounds = {
        "gibbs_tile_sample_live": bound(live_cost[0], *live_cost[1]),
        "gibbs_block_sample": bound(
            u_words * K * 4 + u_docs * K * 4 + K * 4 + BLOCK * 4 * 4,
            BLOCK * K * BLOCK_SAMPLE_OPS_PER_ELEM),
        "count_move": bound(BLOCK * 4 * 4 + cells * 8, 2 * int(moved.sum())),
    }
    # the three tables' form: the token arrays, the changed cells of each
    # table read and written once, z written back; 6 integer ops per moved
    # token
    dk = d.long()[moved] * K
    d_cells = torch.unique(torch.cat([dk + z.long()[moved], dk + z_new.long()[moved]]))
    topics = torch.unique(torch.cat([z[moved], z_new[moved]]))
    out["count_move"]["bound_three_tables_ms"] = bound(
        BLOCK * 4 * 6 + (cells + d_cells.numel() + topics.numel()) * 8,
        6 * int(moved.sum()))[0]
    units = {
        "gibbs_tile_sample_live": f"one block of {BLOCK} tokens ({BLOCK // row_tile} tiles, one launch)",
        "gibbs_block_sample": f"one block of {BLOCK} tokens (one launch)",
        "count_move": f"one block of {BLOCK} tokens: its nwk moves (one launch)",
    }
    report(out, times, bounds, units)
    out["count_move"]["library_device_ms"] = lib_ms = call_device_ms(
        lambda: nwk_c.view(-1).index_put_((flat,), vals, accumulate=True))
    log(f"[kernels] count_move's library call (index_put_, accumulate): device "
        f"{lib_ms} ms per call (events {out['count_move']['library_ms']:.4f} ms)")
    walk_report(out["gibbs_tile_sample_live"], "gibbs_tile_sample_live", st.nwk,
                st.ndk, st.nk, z, w, d, m, chain="float32", row_tile=row_tile,
                values=v7, draw_cost=live_cost)
    log(f"[kernels] count_move of nwk, ndk and nk with z written back: device "
        f"{out['count_move']['ms_three_tables']} ms per launch, events "
        f"{out['count_move']['event_ms_three_tables']:.4f} ms (bound "
        f"{out['count_move']['bound_three_tables_ms']:.4f} ms) per block")
    return out


def report(out: dict, times: dict, bounds: dict, units: dict) -> None:
    """Each kernel's time: ``ms`` its device time per launch (the profiler),
    ``event_ms`` CUDA events around its wrapper (host launch time included),
    beside its plain version's and the library call's event times."""
    for name, (fn, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bounds[name]
        event_ms, dev_ms = cuda_ms(fn), device_ms(fn, name)
        out[name].update(ms=dev_ms, event_ms=event_ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, unit=units[name])
        log(f"[kernels] {name}: device {dev_ms} ms per launch, events "
            f"{event_ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{b_ms:.4f} ms by {b_by}) per {units[name]}")


def kernel_counts(before: dict) -> tuple:
    """The kernel launches and plain-version calls counted since ``before``
    (a ``tracing.counters()``): the moves of the recorder's
    ``launch.<kernel>`` and ``plain.<kernel>`` counters, by kernel name, as
    two ``collections.Counter`` (0 for a kernel that did not move)."""
    import collections

    from ldagibbssampling_tpu_torch.evaluation import tracing

    moved = (collections.Counter(), collections.Counter())
    for name, n in tracing.counters().items():
        kind, _, kernel = name.partition(".")
        if kind in ("launch", "plain") and n != before.get(name, 0):
            moved[kind == "plain"][kernel] = n - before.get(name, 0)
    return moved


def run_label(use_pallas, chain: str, mirror: str, k: int) -> str:
    label = TIER_NAMES[use_pallas]
    if (chain, mirror) != ("float32", "bfloat16"):
        label = f"{label} {chain}/{mirror}"
    return label if k == K else f"{label} K={k}"


def main_path(corpus, seed: int, smi: str, use_pallas, sweeps: int,
              device: str = "cuda", chain: str = "float32",
              mirror: str = "bfloat16", k: int = K):
    """Phase 4: the entry points a user calls, in the tier ``use_pallas``
    (the deferred tier in the given chain and snapshot type) at ``k``
    topics; returns tokens/s, the kernel launches of the run and the
    model."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.ops.fused_kernel import sample_name

    tier = TIER_NAMES[use_pallas]
    label = run_label(use_pallas, chain, mirror, k)
    cfg = LdaConfig(alpha=ALPHA, beta=BETA, topic_num=k, iteration=sweeps,
                    block_size=BLOCK, seed=seed, use_pallas=use_pallas,
                    kernel_compute_dtype=chain, mirror_dtype=mirror)
    t0 = time.perf_counter()
    model = make_backend(cfg, corpus, device=device)
    torch.cuda.synchronize()
    t_pad = model.state.z.shape[0]
    row_tile = model._run_sweeps.row_tile
    log(f"[main {label}] make_backend {time.perf_counter() - t0:.2f}s "
        f"(T_pad={t_pad}, row tile {row_tile})")
    if model.kernel_tier != tier:
        raise AssertionError(f"asked for {tier}, the model runs {model.kernel_tier}")
    graphs = getattr(model._run_sweeps, "graphs", {})
    counted = tracing.counters()
    t0 = time.perf_counter()
    run_inference(model, cfg, corpus)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = kernel_counts(counted)
    # a graph's first call runs one warm-up sweep, then replays per sweep
    warmups = sum(g.graph is not None for g in graphs.values())
    setup_s = sum(g.setup_s for g in graphs.values() if g.graph is not None)
    for g in graphs.values():
        log(f"[main {label}] graph: set-up {g.setup_s:.4f}s (copies, warm-up "
            f"sweep, capture and instantiation {g.capture_s:.4f}s), {g.replays} "
            f"replays, counters per replay "
            f"{g.per_replay}, {g.nodes:,} nodes")
    log(f"[main {label}] launches { {k: v for k, v in launches.items() if v} }, "
        f"plain calls { {k: v for k, v in plain.items() if v} }")
    if model.sweeps_done != sweeps:
        raise AssertionError(f"ran {model.sweeps_done} sweeps, not {sweeps}")
    draw = sample_name(getattr(torch, mirror), chain)
    if use_pallas == "deferred":  # cast_mirror makes the bf16 snapshot only
        expected = (draw, "rebuild_counts",
                    *(("cast_mirror",) if mirror == "bfloat16" else ()))
    else:
        expected = TIER_KERNELS[use_pallas]
    missing = [n for n in expected if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {tier} path: {missing}")
    stray = [n for n, c in launches.items() if c and n not in expected]
    if stray:
        raise AssertionError(f"kernels of other tiers launched on the {tier} path: {stray}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the {tier} path: {plain}")
    blocks = t_pad // BLOCK
    # K1: one walk launch per sweep (deferred) or per block (fused), its
    # count moves inside the walk: no update-only launch, no count move in
    # the deferred tier, one (the block's word-topic moves) per block in
    # the fused tier; every tier replays a graph, whose warm-up sweep counts
    # once more, and the deferred tier casts its first snapshot
    runs = sweeps + warmups
    want = {
        "deferred": {draw: runs, "gibbs_tile_update": 0, "count_move": 0,
                     "rebuild_counts": runs,
                     "cast_mirror": runs + 1 if mirror == "bfloat16" else 0},
        "fused": {"gibbs_tile_sample_live": runs * blocks,
                  "gibbs_tile_update": 0, "count_move": runs * blocks},
        "pallas-draw": {"gibbs_block_sample": runs * blocks,
                        "count_move": runs * blocks},
        "xla": {},
    }[tier]
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"{tier} launches {got}, its layout implies {want}")
    t1 = time.perf_counter()
    model.check_counts_consistent()
    phi, theta = model.phi(), model.theta()
    if not (np.isfinite(phi).all() and np.isfinite(theta).all()):
        raise AssertionError("phi/theta not finite")
    if phi.shape != (k, V) or theta.shape != (M, k):
        raise AssertionError(f"phi {phi.shape} theta {theta.shape}")
    np.testing.assert_allclose(phi.sum(axis=1, dtype=np.float64), 1.0, rtol=1e-3)
    check_s = time.perf_counter() - t1
    tok_s = sweeps * corpus.num_tokens / dt
    rest = ""
    if graphs:  # the first call against a second one, its graph made
        t2 = time.perf_counter()
        model.sweep(sweeps)
        torch.cuda.synchronize()
        rest = (f"; less the graph's set-up {(dt - setup_s) / sweeps * 1e3:.2f} ms/sweep,"
                f" a second call {(time.perf_counter() - t2) / sweeps * 1e3:.2f} ms/sweep")
    log(f"[main {label}] {sweeps} sweeps of {corpus.num_tokens} tokens in "
        f"{dt:.3f}s = {tok_s:,.0f} tokens/s ({dt / sweeps * 1e3:.2f} ms/sweep{rest}) "
        f"on {smi}; counts consistent (check {check_s:.2f}s)")
    return tok_s, {n: launches[n] for n in expected}, model


def profile_sweep(model, label: str) -> None:
    """Phase 4b: one more sweep under the port's ``trace`` (what the CLI's
    ``--profile-dir`` runs): device time by kernel and the device's busy
    share of the sweep's wall time."""
    import torch

    from ldagibbssampling_tpu_torch.evaluation.tracing import trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            t0 = time.perf_counter()
            model.sweep(1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if not (Path(tmp) / "trace.json").stat().st_size:
            raise AssertionError("trace() wrote an empty trace")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[profile {label}] the profiler recorded no device time (not measured)")
        return
    by_name: dict = {}
    for e in kernels:
        short = e.name.replace("(anonymous namespace)::", "")
        key = short.removeprefix("void ").split("(")[0].strip() or repr(e.name[:80])
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    log(f"[profile {label}] one sweep: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.3f} of wall)")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {key}: {n} launches, {us / 1e3:.3f} ms ({us / n:.2f} us each)")


def planted_corpus(seed: int, label: str):
    """The quality runs' corpus with planted topics (2,048 documents, V =
    5,000, K = 500, mean length 256)."""
    from ldagibbssampling_tpu_torch.data.synthetic import planted_topic_corpus

    t0 = time.perf_counter()
    corpus, _ = planted_topic_corpus(num_docs=2048, vocab_size=5000,
                                     num_topics=K, mean_doc_len=256, seed=seed)
    log(f"[{label}] planted corpus {corpus.num_tokens} tokens, V 5000, M 2048, "
        f"K {K} in {time.perf_counter() - t0:.1f}s")
    return corpus


def quality_phase(seed: int, device: str = "cuda") -> dict:
    """Phase 4c: the six deferred (chain, snapshot) settings on a corpus with
    planted topics, from the same seed and init, with the training LL every
    LL_EVERY sweeps through ``run_inference``; returns ``{setting: rows}``."""
    import numpy as np

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation.tracing import (
        MetricsLog, read_metrics)

    corpus = planted_corpus(seed, "quality")
    out = {}
    for chain, mirror in (("float32", "bfloat16"), *CHAIN_SETTINGS):
        cfg = LdaConfig(alpha=QUALITY_ALPHA, beta=QUALITY_BETA, topic_num=K,
                        iteration=QUALITY_SWEEPS, block_size=BLOCK, seed=seed,
                        kernel_compute_dtype=chain, mirror_dtype=mirror)
        model = make_backend(cfg, corpus, device=device)
        with tempfile.TemporaryDirectory() as tmp:
            with MetricsLog(Path(tmp) / "m.jsonl") as mlog:
                run_inference(model, cfg, corpus, metrics=mlog, metrics_every=0,
                              ll_every=LL_EVERY)
            rows = [r for r in read_metrics(Path(tmp) / "m.jsonl")
                    if "log_likelihood" in r]
        model.check_counts_consistent()
        rows[-1]["max_nwk_cell"] = int(model.state.nwk.max())
        out[f"{chain}/{mirror}"] = rows
        lls = [r["log_likelihood"] for r in rows]
        if [r["sweep"] + 1 for r in rows] != list(
                range(LL_EVERY, QUALITY_SWEEPS + 1, LL_EVERY)):
            raise AssertionError(f"LL rows at sweeps {[r['sweep'] for r in rows]}")
        if not np.isfinite(lls).all():
            raise AssertionError(f"{chain}/{mirror}: LL not finite: {lls}")
        if not rows[-1]["perplexity"] < rows[0]["perplexity"]:
            raise AssertionError(f"{chain}/{mirror}: perplexity did not fall "
                                 f"({rows[0]['perplexity']} -> {rows[-1]['perplexity']})")
    base = out["float32/bfloat16"]
    for key, rows in out.items():
        log(f"[quality] {key} (largest nwk cell {rows[-1]['max_nwk_cell']}): "
            + "; ".join(
            f"sweep {r['sweep'] + 1}: LL {r['log_likelihood']:.1f} ppl "
            f"{r['perplexity']:.3f} (gap {r['perplexity'] - b['perplexity']:+.3f})"
            for r, b in zip(rows, base)))
    return out


def hyper_phase(corpus, seed: int, device: str = "cuda") -> dict:
    """Phase 4d: a deferred run with Minka updates every 5 sweeps at
    bench.py's shape, and the time of one device LL and one update."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.config import LdaConfig

    cfg = LdaConfig(alpha=ALPHA, beta=BETA, topic_num=K, iteration=SWEEPS,
                    block_size=BLOCK, seed=seed)
    model = make_backend(cfg, corpus, device=device)
    run_inference(model, cfg, corpus, optimize_hyper_every=5)
    torch.cuda.synchronize()
    a, b = model.alpha, model.beta
    if not (np.isfinite([a, b]).all() and a != ALPHA and b != BETA):
        raise AssertionError(f"alpha {a}, beta {b} after {SWEEPS} sweeps")
    model.check_counts_consistent()
    times = {}
    for name, fn in (("device_log_likelihood", model.device_log_likelihood),
                     ("optimize_hyperparameters", model.optimize_hyperparameters)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        log(f"[hyper] {name}: {times[name]:.3f} ms (host clock around a "
            f"synchronise) -> {value}")
    log(f"[hyper] {SWEEPS} sweeps, Minka every 5: alpha {ALPHA} -> {a:.6f}, "
        f"beta {BETA} -> {b:.6f}; counts consistent")
    return dict(alpha=a, beta=b, **{f"{n}_ms": t for n, t in times.items()})


def check_probe(seed: int, device: str = "cuda") -> dict:
    """K4 against its plain version at [32768, 512], then its entry point's
    timing (the launches counted there)."""
    import torch

    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.scripts import vpu_dtype_probe as probe

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((probe.ROWS, probe.K), generator=g, device=dev)
    b = torch.rand((probe.ROWS, probe.K), generator=g, device=dev)
    out = {}
    for dtype in probe.DTYPES:
        got = probe.dtype_probe(a, b, dtype=dtype)
        want = probe.probe_plain(a, b, dtype=dtype)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_diff = int((got != want).sum())
        # bitwise in both: float32 has no contraction, and the native packed
        # bf16 ops give what PyTorch's float32-then-round bf16 ops give (the
        # double-rounding condition, csrc/dtype_probe.cu)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {dtype} differs from plain on {n_diff} "
                                 f"values, max abs err {err}")
        name = probe.counter_name(dtype)
        out[name] = dict(max_abs_err=err)
        log(f"[probe] {name}: {n_diff} of {got.numel()} values differ from "
            f"plain, max abs err {err}")
        out[name]["plain_ms"] = cuda_ms(lambda: probe.probe_plain(a, b, dtype=dtype))
        out[name]["device_ms"] = device_ms(lambda: probe.dtype_probe(a, b, dtype=dtype),
                                           name)
        out[name]["ms_64_reps"] = cuda_ms(
            lambda: probe.dtype_probe(a, b, dtype=dtype, reps=64))
    counted = tracing.counters()
    res = probe.measure(device)  # the entry point's own timing
    launches, _ = kernel_counts(counted)
    nbytes = 3 * probe.ROWS * probe.K * 4
    # per element: y - e + 0.5 once, then 5 operations per repeat
    ops = probe.ROWS * probe.K * (2 + probe.REPS * 5)
    for dtype, (ms, gops) in res.items():
        name = probe.counter_name(dtype)
        b_ms, b_by = bound(nbytes, *((ops, 0) if dtype == "float32" else (0, ops)))
        out[name].update(ms=ms, gops=gops, launches=launches[name], bound_ms=b_ms,
                         bound_by=b_by, library_ms=None,
                         unit=f"one [{probe.ROWS}, {probe.K}] pass, {probe.REPS} repeats")
        log(f"[probe] {name}: {ms:.4f} ms ({gops:.1f} Gops/s as the reference "
            f"counts), plain {out[name]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}; 64 repeats {out[name]['ms_64_reps']:.4f} ms "
            f"({probe.ops_counted(reps=64) / out[name]['ms_64_reps'] / 1e6:.1f} Gops/s)")
    return out


def cli_phase(flag_sets: tuple[tuple[str, ...], ...]) -> None:
    """Phase 5: the port's CLI writes the five artifacts on the card, once
    per set of flags, the processes run at once."""
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for i, flags in enumerate(flag_sets):
            run = Path(tmp, str(i))
            jobs.append(([sys.executable, "-m", f"{PKG}.cli", "--generate-minicorpus",
                          "--docs", f"{run}/docs", "--results", f"{run}/res", "-k",
                          "10", "--iterations", "60", "--save-step", "10",
                          "--begin-save-iters", "50", "--check-counts",
                          "--metrics-file", f"{run}/m.jsonl", "--metrics-every", "0",
                          *flags], REPO))
        t0 = time.perf_counter()
        outs = run_processes(jobs)
        wall_s = time.perf_counter() - t0
        for i, (flags, out) in enumerate(zip(flag_sets, outs)):
            run = Path(tmp, str(i))
            tail = [ln for ln in out.splitlines() if ln.startswith(("count", "Done"))]
            files = sorted(p.name for p in Path(run, "res").iterdir())
            want = sorted(f"lda_{i}.{e}" for i in (50, 60)
                          for e in ("params", "phi", "theta", "tassign", "twords"))
            if files != want:
                raise AssertionError(f"CLI {flags} artifacts {files} != {want}")
            rows = [json.loads(x) for x in Path(run, "m.jsonl").read_text().splitlines()]
            header = rows[0]
            if "--ll-every" in flags:
                ll_rows = [r for r in rows if "log_likelihood" in r]
                if not ll_rows or not all("alpha" in r for r in ll_rows):
                    raise AssertionError(f"CLI {flags}: no LL/alpha rows: {rows[:3]}")
                tail.append(f"LL {ll_rows[-1]['log_likelihood']:.1f}, alpha "
                            f"{ll_rows[-1]['alpha']:.4f}, beta {ll_rows[-1]['beta']:.4f}")
            log(f"[cli {' '.join(flags) or 'default'}] kernel tier "
                f"{header['kernel_tier']}, wrote {len(files)} artifacts; "
                f"{' | '.join(tail)} ({len(flag_sets)} processes at once, "
                f"{wall_s:.1f}s)")


def heldout_phase(seed: int, device: str = "cuda") -> dict:
    """Phase 4e: held-out perplexity of each deferred (chain, snapshot)
    setting trained on 95% of the planted corpus's documents, by the batched
    fold-in on the card; the host estimator on the first documents for the
    default setting."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
        heldout_perplexity_device)
    from ldagibbssampling_tpu_torch.evaluation.metrics import heldout_perplexity

    train, held = planted_corpus(seed, "heldout").split_docs(HELDOUT_FRAC, seed=seed)
    log(f"[heldout] {held.num_docs} held-out documents ({held.num_tokens} tokens), "
        f"{train.num_docs} trained on ({train.num_tokens} tokens)")
    out: dict = {}
    for chain, mirror in (("float32", "bfloat16"), *CHAIN_SETTINGS):
        cfg = LdaConfig(alpha=QUALITY_ALPHA, beta=QUALITY_BETA, topic_num=K,
                        iteration=QUALITY_SWEEPS, block_size=BLOCK, seed=seed,
                        kernel_compute_dtype=chain, mirror_dtype=mirror)
        model = make_backend(cfg, train, device=device)
        if model.kernel_tier != "deferred":
            raise AssertionError(f"held-out run in {model.kernel_tier}")
        run_inference(model, cfg, train)
        phi = model.phi()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl = heldout_perplexity_device(phi, held, model.alpha, seed=seed,
                                        device=device)
        dt = time.perf_counter() - t0
        if not (np.isfinite(ppl) and ppl > 1.0):
            raise AssertionError(f"{chain}/{mirror}: held-out perplexity {ppl}")
        key = f"{chain}/{mirror}"
        out[key] = dict(perplexity=ppl, seconds=dt)
        log(f"[heldout] {key}: {QUALITY_SWEEPS} sweeps, held-out perplexity "
            f"{ppl:.3f} on the card ({dt:.2f}s, 20 fold-in sweeps)")
        if (chain, mirror) == ("float32", "bfloat16"):
            few = held.select_docs(np.arange(min(HELDOUT_HOST_DOCS, held.num_docs)))
            t0 = time.perf_counter()
            host = heldout_perplexity(phi, few, model.alpha, seed=seed)
            host_s = time.perf_counter() - t0
            dev_few = heldout_perplexity_device(phi, few, model.alpha, seed=seed,
                                                device=device)
            if not np.isfinite(host):
                raise AssertionError(f"host held-out perplexity {host}")
            out[key].update(host_perplexity_first_docs=host,
                            device_perplexity_first_docs=dev_few,
                            host_seconds=host_s)
            log(f"[heldout] {key}, first {few.num_docs} held-out documents: host "
                f"{host:.3f} ({host_s:.1f}s), card {dev_few:.3f}")
        del model
    return out


def parity_corpus(use_pallas, seed: int):
    """The minicorpus where it resolves to the tier ``use_pallas`` names,
    else the first seeded planted corpus that does."""
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.corpus.documents import Documents
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu_torch.data import write_minicorpus
    from ldagibbssampling_tpu_torch.data.synthetic import planted_topic_corpus
    from ldagibbssampling_tpu_torch.models.lda import resolve_tier

    cfg = LdaConfig(topic_num=PARITY_K, block_size=PARITY_BLOCK,
                    use_pallas=use_pallas)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = FlatCorpus.from_documents(
            Documents().read_docs(write_minicorpus(Path(tmp) / "docs")))
    if resolve_tier(cfg, corpus).kernel_tier == TIER_NAMES[use_pallas]:
        return corpus, "minicorpus"
    for s in range(seed, seed + 64):
        corpus, _ = planted_topic_corpus(num_docs=24, vocab_size=120,
                                         num_topics=PARITY_K, mean_doc_len=56,
                                         seed=s)
        if resolve_tier(cfg, corpus).kernel_tier == TIER_NAMES[use_pallas]:
            return corpus, f"planted corpus (seed {s})"
    raise AssertionError(f"no parity corpus resolves to {TIER_NAMES[use_pallas]}")


def parity_phase(use_pallas, seed: int, device: str = "cuda") -> dict:
    """Phase 6: the tier's blocked chain against the serial oracle
    (``oracle_vs_blocked``); |z| >= PARITY_MAX_Z on either functional fails."""
    from ldagibbssampling_tpu_torch.evaluation.parity import oracle_vs_blocked

    tier = TIER_NAMES[use_pallas]
    corpus, name = parity_corpus(use_pallas, seed)
    t0 = time.perf_counter()
    rep = oracle_vs_blocked(corpus, PARITY_K, sweeps=PARITY_SWEEPS,
                            seeds=PARITY_SEEDS, block_size=PARITY_BLOCK,
                            use_pallas=use_pallas, device=device,
                            expect_tier=tier)
    log(f"[parity {tier}] {name}, {corpus.num_tokens} tokens, K={PARITY_K}, "
        f"{len(PARITY_SEEDS)} seeds x {PARITY_SWEEPS} sweeps: z_ll "
        f"{rep['z_ll']:+.3f}, z_entropy {rep['z_entropy']:+.3f} (LL/token oracle "
        f"{rep['oracle']['ll_per_token_mean']:.4f}, blocked "
        f"{rep['blocked']['ll_per_token_mean']:.4f}; entropy oracle "
        f"{rep['oracle']['topic_entropy_mean']:.4f}, blocked "
        f"{rep['blocked']['topic_entropy_mean']:.4f}) in "
        f"{time.perf_counter() - t0:.1f}s")
    if not (abs(rep["z_ll"]) < PARITY_MAX_Z and abs(rep["z_entropy"]) < PARITY_MAX_Z):
        raise AssertionError(f"parity {tier}: |z| >= {PARITY_MAX_Z}: {rep}")
    return dict(corpus=name, tokens=corpus.num_tokens, z_ll=rep["z_ll"],
                z_entropy=rep["z_entropy"])


def cli_command(args, counted: bool = False) -> list:
    """The port's CLI with ``args`` as a command (``counted``: run by
    ``_COUNTED_CLI``, which prints the process's kernel launches)."""
    cmd = ([sys.executable, "-c", _COUNTED_CLI] if counted
           else [sys.executable, "-m", f"{PKG}.cli"])
    return [*cmd, *args]


def run_processes(jobs, timeout: int = 600) -> list:
    """``(command, cwd)`` jobs as subprocesses started at once; their
    stdouts once all have ended.  One that fails or outlasts ``timeout``
    raises, and every process still running is killed first."""
    procs = [subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": str(REPO)})
             for cmd, cwd in jobs]
    try:
        outs = []
        for (cmd, _), proc in zip(jobs, procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{cmd[3:]} exit {proc.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(out)
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def run_cli(args, cwd: str, counted: bool = False) -> str:
    """The port's CLI on the card in a subprocess; its stdout."""
    return run_processes([(cli_command(args, counted), cwd)])[0]


# [resume]: each tier's kernels, by the counters' names; the first counts
# the sweeps (one launch per sweep and block)
RESUME_KERNELS = {"fused": ("gibbs_tile_sample_live", "count_move"),
                  "deferred": ("gibbs_tile_sample", "rebuild_counts"),
                  "pallas-draw": ("gibbs_block_sample", "count_move")}


def _resume_launches(tier: str, out: str, sweeps: int, blocks=None) -> int:
    """The kernel launches a counted CLI process of ``sweeps`` sweeps made:
    each of its tier's kernels (sweeps + 1) x blocks times, the graph's
    warm-up sweep the one more, and the deferred tier's snapshots once
    more than its sweeps (the first is cast from the state).  Returns the
    blocks (per sweep launches), which the tier's other runs must match."""
    line = [ln for ln in out.splitlines() if ln.startswith("[launches] ")][-1]
    launches, plain = json.loads(line.split(" ", 1)[1])
    got = {n: c for n, c in launches.items() if c}
    first = RESUME_KERNELS[tier][0]
    blocks = blocks if blocks is not None else got.get(first, 0) // (sweeps + 1)
    want = {n: (sweeps + 1) * blocks for n in RESUME_KERNELS[tier]}
    if tier == "deferred":
        want["cast_mirror"] = sweeps + 2
    if blocks < 1 or got != want or any(plain.values()):
        raise AssertionError(f"[resume {tier}] {sweeps} sweeps launched {got} "
                             f"(plain {plain}), want {want}")
    return blocks


def resume_phase() -> None:
    """Phase 5b: a killed and resumed CLI run writes the uninterrupted run's
    artifacts byte for byte, in the fused tier, and in the deferred and the
    v1-draw tiers with a Minka update every 5 sweeps (their graphs read the
    moved alpha and beta, and the restored state is copied in).  Each
    process's launches are counted exactly (``_resume_launches``)."""
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "deferred.json").write_text('{"block_size": 256}')
        common = ["--docs", "docs", "-k", "10", "--save-step", "10",
                  "--begin-save-iters", "50", "--seed", "3"]
        run_cli(["--generate-minicorpus", *common, "--no-save", "--iterations",
                 "1"], tmp)
        tiers = (("fused", []),
                 ("deferred", ["--config-json", "deferred.json",
                               "--optimize-hyper-every", "5"]),
                 ("pallas-draw", ["--pallas", "1", "--optimize-hyper-every", "5"]))
        # each tier's straight run and its run to sweep 30 at once, then the
        # resumed runs at once
        t0 = time.perf_counter()
        firsts = run_processes([job for tier, extra in tiers for job in (
            (cli_command([*common, *extra, "--results", f"{tier}_full",
                          "--iterations", "60", "--metrics-file", f"{tier}.jsonl",
                          "--metrics-every", "0"], True), tmp),
            (cli_command([*common, *extra, "--no-save", "--iterations", "30",
                          "--checkpoint-dir", f"{tier}_ck", "--checkpoint-every",
                          "10"], True), tmp))])
        resumed = run_processes([
            (cli_command([*common, *extra, "--results", f"{tier}_resumed",
                          "--iterations", "60", "--checkpoint-dir", f"{tier}_ck",
                          "--checkpoint-every", "10", "--resume"], True), tmp)
            for tier, extra in tiers])
        wall_s = time.perf_counter() - t0
        for i, (tier, _) in enumerate(tiers):
            header = json.loads(Path(tmp, f"{tier}.jsonl").read_text().splitlines()[0])
            if header["kernel_tier"] != tier:
                raise AssertionError(f"resume {tier}: ran {header['kernel_tier']}")
            blocks = _resume_launches(tier, firsts[2 * i], 60)
            _resume_launches(tier, firsts[2 * i + 1], 30, blocks)
            out = resumed[i]
            if "Resumed from sweep 30" not in out:
                raise AssertionError(f"resume {tier}: {out[-2000:]}")
            _resume_launches(tier, out, 30, blocks)
            full = sorted(p.name for p in Path(tmp, f"{tier}_full").iterdir())
            want = sorted(f"lda_{i}.{e}" for i in (50, 60)
                          for e in ("params", "phi", "theta", "tassign", "twords"))
            got = sorted(p.name for p in Path(tmp, f"{tier}_resumed").iterdir())
            if not full == got == want:
                raise AssertionError(f"resume {tier}: {full} / {got}")
            differ = [n for n in want if Path(tmp, f"{tier}_full", n).read_bytes()
                      != Path(tmp, f"{tier}_resumed", n).read_bytes()]
            if differ:
                raise AssertionError(f"resume {tier}: artifacts differ: {differ}")
            kept = sorted(int(p.name) for p in Path(tmp, f"{tier}_ck").iterdir())
            log(f"[resume {tier}] 60 sweeps straight, and 30 + resume from sweep 30 "
                f"to 60: the ten artifacts byte-identical (checkpoints kept "
                f"{kept}; launches per process exact, {blocks} a sweep and "
                f"kernel, the graph's warm-up once more; the three tiers' nine "
                f"processes, six then three at once, {wall_s:.1f}s)")


def infer_phase() -> None:
    """Phase 5c: train with the CLI, then fold unseen documents in."""
    with tempfile.TemporaryDirectory() as tmp:
        from ldagibbssampling_tpu_torch.data import write_minicorpus

        docs = write_minicorpus(Path(tmp) / "docs")
        new = Path(tmp) / "new"
        new.mkdir()
        for p in sorted(docs.iterdir())[:3]:
            (new / p.name).write_text(p.read_text() + "\nquokka zyzzyva\n")
        out = run_cli(["--docs", "docs", "--results", "res", "-k", "10",
                       "--iterations", "60", "--save-step", "10",
                       "--begin-save-iters", "50", "--infer-docs", "new"], tmp)
        line = [ln for ln in out.splitlines() if ln.startswith("Inferred")]
        names = ("inferred.theta", "inferred.tassign", "inferred.docs")
        if not line or not all(Path(tmp, "res", n).stat().st_size for n in names):
            raise AssertionError(f"infer: {out[-2000:]}")
        rows = [[float(x) for x in ln.split("\t")]
                for ln in Path(tmp, "res", "inferred.theta").read_text().splitlines()]
        if len(rows) != 3 or any(abs(sum(r) - 1) > 1e-4 or len(r) != 10 for r in rows):
            raise AssertionError(f"infer: theta rows {rows}")
        log(f"[infer] {line[0]}; wrote {', '.join(names)}")


def bench_phase(tier: str, sweeps: int) -> dict:
    """Phase 7: the port's bench script at bench.py's full shape; its one
    JSON line."""
    env = {**os.environ, "LDA_BENCH_PALLAS": tier, "LDA_BENCH_SWEEPS": str(sweeps),
           "PYTHONPATH": str(REPO)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.scripts.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"bench {tier} exit {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench {tier}: {len(lines)} lines on stdout: {lines}")
    row = json.loads(lines[0])
    if row.get("metric") != f"tokens_resampled_per_s_chip_K{K}" or list(row) != [
            "metric", "value", "unit", "vs_baseline"]:
        raise AssertionError(f"bench {tier}: {row}")
    device_line = [ln for ln in proc.stderr.splitlines() if ln.startswith("# device=")]
    log(f"[bench {tier}] {lines[0]}")
    log(f"[bench {tier}] {device_line[-1] if device_line else 'no # device line'} "
        f"({time.perf_counter() - t0:.1f}s with start-up)")
    return row


def launch_profile(fn, tries: int = 3) -> dict:
    """What ``fn()`` makes the host do, from ``torch.profiler``:
    ``host_calls`` the CUDA runtime calls that enqueue work on the card
    (kernel and graph launches, copies, fills; each eager one enqueues one
    device operation) and ``graph_launches`` the graph launches among them.
    Raises where ``tries`` profiled runs record no device operation.  The CUDA
    activity alone records the runtime calls, in less host time than
    recording the host's ops as well.  (The card's own events are not
    counted: the profiler misses some of them in some runs; a graph's
    operations are counted from its nodes, ``graph_ops``.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        calls = [e.name for e in events
                 if e.name.startswith((*LAUNCH_CALLS, "cudaGraphLaunch"))]
        device = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
        if device:
            return dict(host_calls=len(calls),
                        graph_launches=sum(n.startswith("cudaGraphLaunch")
                                           for n in calls))
    raise AssertionError(f"the profiler recorded no device operation in {tries} runs")


def chains_vs_in_turn(chains, sweeps: int, label: str) -> dict:
    """The batched chains of ``chains`` (``models/chains.ChainSet``) against
    the same chains run in turn, the path before the batched sweep: one
    single-chain ``make_sweep_fn(use_pallas=False)`` per chain, from the
    same states and generators, in internal noise.  Two rounds in the order
    in turn, batched, batched, in turn, ``sweeps`` sweeps each: every
    chain's z and tables bitwise after each pair; both forms' tokens/s over
    chain-sweeps; on the card each form's device operations per sweep of
    every chain, counted from its graphs' nodes (both forms replay CUDA
    graphs, so the host's launches no longer tell them apart), the batched
    form's held to one chain's plus C + 1 per block, and each form's host
    calls from one profiled sweep."""
    import dataclasses

    import torch

    from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

    dev = chains.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c_n, pc, cfg = chains.num_chains, chains._padded, chains.config
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                        chains.doc_lengths, alpha=cfg.alpha, beta=cfg.beta,
                        block_size=chains.block_size, draw_method=cfg.draw_method,
                        use_pallas=False, num_topics=cfg.topic_num, device=dev)
    turn = [dataclasses.replace(s, z=s.z.clone(), ndk=s.ndk.clone(),
                                nwk=s.nwk.clone(), nk=s.nk.clone())
            for s in chains.states]
    gens = [torch.Generator().set_state(g.get_state()) for g in chains.generators]
    secs = {"in turn": [], "batched": []}

    def timed(form, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[form].append(time.perf_counter() - t0)
        return out

    def in_turn(states, n):
        return [run(s, n_sweeps=n, generator=g) for s, g in zip(states, gens)]

    def check():
        for c, want in enumerate(turn):
            got = chains.chain_state(c)
            for name in ("z", "ndk", "nwk", "nk"):
                if not torch.equal(getattr(got, name), getattr(want, name)):
                    raise AssertionError(f"[{label}] chain {c}: the batched sweep's "
                                         f"{name} differs from the chain run in turn")

    turn = timed("in turn", lambda: in_turn(turn, sweeps))
    timed("batched", lambda: chains.sweep(sweeps))
    check()
    timed("batched", lambda: chains.sweep(sweeps))
    turn = timed("in turn", lambda: in_turn(turn, sweeps))
    check()
    tokens = chains.corpus.num_tokens * c_n * sweeps
    blocks = pc.num_tokens // chains.block_size
    rates = {form: [tokens / x for x in xs] for form, xs in secs.items()}
    out = dict(compare_sweeps=sweeps, blocks_per_sweep=blocks,
               batched_tokens_per_s=rates["batched"],
               in_turn_tokens_per_s=rates["in turn"])
    launches = "launches not counted off the card"
    if on_card:
        batched = launch_profile(lambda: chains.sweep(1))
        turned = launch_profile(lambda: in_turn(turn, 1))
        # both forms replay graphs: the card's operations are their nodes
        (single,) = run.graphs.values()
        batched_n = sum(graph_ops(g) for g in chains._graphs.values())
        turn_n = c_n * graph_ops(single)
        bound = turn_n / c_n + (c_n + 1) * blocks
        out.update(batched_device_ops_per_sweep=batched_n,
                   in_turn_device_ops_per_sweep=turn_n, launch_bound=bound,
                   batched_host_calls_per_sweep=batched["host_calls"],
                   in_turn_host_calls_per_sweep=turned["host_calls"])
        if batched_n > bound:
            raise AssertionError(
                f"[{label}] {batched_n} device operations per batched sweep of "
                f"{c_n} chains > one chain's {turn_n / c_n:.0f} + {c_n + 1} per "
                f"block x {blocks}")
        launches = (f"device operations per sweep of {c_n} chains: batched "
                    f"{batched_n:,}, in turn {turn_n:,} (bound {bound:,.0f}: one "
                    f"chain's + {c_n + 1} x {blocks} blocks); host calls batched "
                    f"{batched['host_calls']}, in turn {turned['host_calls']}")
    log(f"[{label} vs in turn] {c_n} chains x {sweeps} sweeps, twice each "
        f"(in turn, batched, batched, in turn): z, ndk, nwk, nk bitwise per chain; "
        f"tokens/s over chain-sweeps batched "
        f"{', '.join(f'{r:,.0f}' for r in rates['batched'])}, in turn "
        f"{', '.join(f'{r:,.0f}' for r in rates['in turn'])}; {launches}")
    return out


@contextlib.contextmanager
def chain_part_timer(model, sync):
    """Times every call of the chains' parts while the block runs, each
    synchronised before and after: the sweep (``ChainSet._advance``), the
    chains' LL recording (``record_ll``), the φ draw (``record_phi_auto``),
    the window summary (``PhiRhatAccumulator.result``) and the runner's LL
    row (``device_log_likelihood``).  Yields the ``(part, seconds)`` list
    in call order."""
    from ldagibbssampling_tpu_torch.evaluation import diagnostics

    calls: list = []

    def timed(part, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            calls.append((part, time.perf_counter() - t0))
            return out
        return run

    chains = model.chains
    patched = [(chains, "_advance", "sweep"), (chains, "record_ll", "ll"),
               (chains, "record_phi_auto", "phi"),
               (model, "device_log_likelihood", "ll_row")]
    for obj, name, part in patched:
        setattr(obj, name, timed(part, getattr(obj, name)))
    result = diagnostics.PhiRhatAccumulator.result
    diagnostics.PhiRhatAccumulator.result = timed("summary", result)
    try:
        yield calls
    finally:
        diagnostics.PhiRhatAccumulator.result = result
        for obj, name, _ in patched:
            delattr(obj, name)


def per_sweep_parts(calls: list) -> dict:
    """The timer's calls as per-sweep lists (a sweep starts at each
    ``sweep`` call): seconds of the sweep, the chains' LL and the φ fold
    (the draw less its summary), and the summaries and LL rows by sweep."""
    out = {"sweep_s": [], "ll_s": [], "phi_fold_s": [], "summary_s": {},
           "ll_row_s": {}}
    for part, secs in calls:
        i = len(out["sweep_s"])
        if part == "sweep":
            out["sweep_s"].append(secs)
            out["ll_s"].append(0.0)
            out["phi_fold_s"].append(0.0)
        elif part == "ll":
            out["ll_s"][-1] += secs
        elif part == "phi":
            out["phi_fold_s"][-1] += secs - out["summary_s"].get(i, 0.0)
        else:
            out[f"{part}_s"][i] = out[f"{part}_s"].get(i, 0.0) + secs
    return out


def _rel(a: float, b: float) -> float:
    if a == b or (a != a and b != b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def phi_rhat_card_vs_cpu(chains, label: str) -> dict:
    """One full window of 4 φ draws (a sweep before each, halves 0, 0, 1,
    1) into ``PhiRhatAccumulator`` on the chains' device and into the same
    class on CPU copies of the same draws: the moments bitwise equal, the
    summaries' ``perms`` and ``n_cells`` equal and their floats within
    relative 1e-9; the card's fold and summary times."""
    import torch

    from ldagibbssampling_tpu_torch.evaluation.diagnostics import PhiRhatAccumulator

    shape = (chains.num_chains, chains.config.topic_num, chains.corpus.vocab_size)
    card, cpu = PhiRhatAccumulator(*shape), PhiRhatAccumulator(*shape)
    fold_s = []
    for i in range(4):
        chains.sweep(1)
        draw = chains._phi_draw()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.add(draw, i // 2)
        torch.cuda.synchronize()
        fold_s.append(time.perf_counter() - t0)
        cpu.add([(ids, x.cpu()) for ids, x in draw], i // 2)
    for name in ("mean", "m2"):
        got = getattr(card, name)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), getattr(cpu, name)):
            raise AssertionError(f"[{label} phi R-hat] the card's {name} on "
                                 f"{got.device} differs from the CPU run's")
    t0 = time.perf_counter()
    got = card.result()
    summary_s = time.perf_counter() - t0
    want = cpu.result()
    errs = {k: _rel(got[k], want[k]) for k in ("max", "p99", "frac_gt_1_1")}
    if (got["perms"] != want["perms"] or got["n_cells"] != want["n_cells"]
            or max(errs.values()) > 1e-9):
        raise AssertionError(f"[{label} phi R-hat] card {got} vs CPU {want}")
    log(f"[{label} phi R-hat] 4 draws of {list(shape)} phi folded on "
        f"{card.mean.device} and on the CPU: mean and m2 bitwise equal; "
        f"summary perms and n_cells ({got['n_cells']:,}) equal, max/p99/frac "
        f"{got['max']:.6f}/{got['p99']:.6f}/{got['frac_gt_1_1']:.6f}, relative "
        f"differences {', '.join(f'{k} {v:.1e}' for k, v in errs.items())}; "
        f"card fold {', '.join(f'{x * 1e3:.2f}' for x in fold_s)} ms, summary "
        f"{summary_s * 1e3:.1f} ms")
    return dict(fold_ms=[x * 1e3 for x in fold_s], summary_ms=summary_s * 1e3,
                rel_err=errs, n_cells=got["n_cells"])


def multichain_phase(label: str, corpus, cfg, ll_every: int, compare_sweeps: int,
                     device: str = "cuda") -> dict:
    """Phases 8 and 8b: ``cfg.chains`` chains (``models/chains``) through
    ``make_backend`` and ``run_inference`` with the LL every ``ll_every``
    sweeps: counts equal recounts, the chains differ pairwise, the rows
    carry finite R-hat, no kernel launches (the XLA tier, as the
    reference's), peak device memory; per sweep of the run the time of the
    sweep, the chains' LL, the phi fold and the window summary, and the
    runner's LL row (``device_log_likelihood``, held to the host LL of
    chain 0 within relative 1e-9); the phi moments on the card; no host
    sync in unrecorded sweeps and a mid-window phi draw (CUDA's sync debug
    mode set to error); the unrecorded rate and the LL recording's time;
    then :func:`phi_rhat_card_vs_cpu` and :func:`chains_vs_in_turn`."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.evaluation import metrics
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c_n = cfg.chains
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = make_backend(cfg, corpus, device=device)
    if type(model).__name__ != "MultiChainModel" or model.kernel_tier != "xla":
        raise AssertionError(f"chains={c_n} built {type(model).__name__} "
                             f"({model.kernel_tier})")
    chains = model.chains
    counted = tracing.counters()
    with tempfile.TemporaryDirectory() as tmp:
        with chain_part_timer(model, sync) as calls:
            t0 = time.perf_counter()
            with MetricsLog(Path(tmp) / "m.jsonl") as mlog:
                run_inference(model, cfg, corpus, metrics=mlog, ll_every=ll_every)
            sync()
            run_s = time.perf_counter() - t0
        rows = read_metrics(Path(tmp) / "m.jsonl")
    parts = per_sweep_parts(calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    launches, plain = kernel_counts(counted)
    if any(launches.values()) or any(plain.values()):
        raise AssertionError(f"the chains' XLA tier launched kernels {launches} "
                             f"or plain versions {plain}")
    chains.check_counts_consistent()
    zs = [s.z.cpu().numpy() for s in chains.states]
    same = [(a, b) for a in range(c_n) for b in range(a + 1, c_n)
            if np.array_equal(zs[a], zs[b])]
    if same:
        raise AssertionError(f"chains equal: {same}")
    r_rows = [(r["sweep"], r["r_hat"], r["r_hat_phi_p99"]) for r in rows
              if "r_hat_phi_p99" in r]
    last = rows[-1]
    if not (r_rows and np.isfinite(last.get("r_hat", np.nan))
            and np.isfinite(last.get("r_hat_phi_p99", np.nan))):
        raise AssertionError(f"rows lack finite r_hat / r_hat_phi_p99: {last}")
    # the windowed phi moments live on the chains' device
    window = chains.phi_window
    moments = [(m.device, 2 * m.numel() * m.element_size()) for _, m, _ in window.cur._moments]
    if on_card and any(d.type != "cuda" for d, _ in moments):
        raise AssertionError(f"[{label}] the phi moments are on {moments}")
    if window.pos + 1 >= window.window:
        raise AssertionError(f"[{label}] no draw left mid-window ({window.pos} of "
                             f"{window.window})")
    if on_card:  # unrecorded sweeps and a mid-window phi draw: no host sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chains.sweep(2)
            chains.record_phi_auto()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # unrecorded sweeps, then the LL recording alone (every chain)
    sync()
    t0 = time.perf_counter()
    chains.sweep(ll_every)
    sync()
    t1 = time.perf_counter()
    for _ in range(ll_every):
        chains.record_ll()
    t2 = time.perf_counter()
    sweep_s, ll_s = (t1 - t0) / ll_every, (t2 - t1) / ll_every
    tok_s = corpus.num_tokens * ll_every * c_n / (t1 - t0)
    out = dict(tokens=corpus.num_tokens, docs=corpus.num_docs,
               vocab=corpus.vocab_size, topics=cfg.topic_num, chains=c_n,
               block=chains.block_size, sweeps=cfg.iteration, run_seconds=run_s,
               peak_device_gb=peak_gb, tokens_per_s_chain_sweeps=tok_s,
               seconds_per_sweep_all_chains=sweep_s,
               ll_record_seconds_per_sweep_all_chains=ll_s,
               r_hat_rows=r_rows, r_hat=last["r_hat"],
               r_hat_phi_p99=last["r_hat_phi_p99"],
               log_likelihood=last["log_likelihood"], parts=parts,
               phi_moments=[(str(d), n) for d, n in moments])
    host_ll = metrics.log_likelihood(model.phi(), model.theta(), corpus)
    if _rel(model.device_log_likelihood(), host_ll) > 1e-9:
        raise AssertionError(f"[{label}] device LL {model.device_log_likelihood()} "
                             f"vs host {host_ll}")

    def ms(xs):
        return ", ".join(f"{x * 1e3:.1f}" for x in xs)
    log(f"[{label}] {corpus.num_tokens} tokens, M {corpus.num_docs}, V "
        f"{corpus.vocab_size}, K {cfg.topic_num}, block {chains.block_size}, "
        f"{c_n} chains x {cfg.iteration} sweeps in {run_s:.2f}s (LL every sweep, "
        f"R-hat rows; with the diagnostics on the host "
        f"{HOST_DIAGNOSTICS_RUN_S[label]} s); counts = recounts, chains differ pairwise; R-hat rows "
        f"(sweep, LL, phi p99): "
        f"{', '.join(f'({s}, {a:.4f}, {b:.4f})' for s, a, b in r_rows)}; peak "
        f"device memory {'not measured' if peak_gb is None else f'{peak_gb:.3f} GB'}"
        f" (max_memory_allocated); unrecorded: {tok_s:,.0f} tokens/s over "
        f"chain-sweeps ({sweep_s * 1e3:.1f} ms per sweep of {c_n} chains), LL "
        f"recording {ll_s * 1e3:.2f} ms per sweep of {c_n} chains"
        + ("; no host sync in 2 unrecorded sweeps and a mid-window phi draw"
           if on_card else ""))
    log(f"[{label} parts] per sweep of the run, ms (synchronised): sweep "
        f"[{ms(parts['sweep_s'])}]; chains' LL [{ms(parts['ll_s'])}]; phi fold "
        f"[{ms(parts['phi_fold_s'])}]; window summary at sweep "
        f"{', '.join(f'{i}: {x * 1e3:.1f}' for i, x in parts['summary_s'].items())}; "
        f"runner's LL row (device_log_likelihood) at sweep "
        f"{', '.join(f'{i}: {x * 1e3:.1f}' for i, x in parts['ll_row_s'].items())}, "
        f"equal to the host LL of chain 0 within 1e-9; phi moments on "
        f"{', '.join(f'{d} ({n / 1e9:.3f} GB)' for d, n in moments)}")
    if on_card:
        out["phi_rhat_card_vs_cpu"] = phi_rhat_card_vs_cpu(chains, label)
    out.update(chains_vs_in_turn(chains, compare_sweeps, label))
    return out


def multichain_phases(seed: int, device: str = "cuda",
                      scale: float = MULTICHAIN_SCALE, wide_corpus=None) -> dict:
    """Phase 8, ``[multichain]``: the ladder's rung 4 (planted corpus, K = 10,
    block 8,192, 4 chains, mean length 80) at ``scale``, 20 sweeps; 8b,
    ``[multichain wide]``: K = 500 and 4 chains on ``wide_corpus`` (bench.py's
    shape, block 65,536), 10 sweeps."""
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig

    t0 = time.perf_counter()
    corpus, _ = rung_corpus(4, scale)
    log(f"[multichain] rung 4's corpus at scale {scale} in "
        f"{time.perf_counter() - t0:.1f}s")
    narrow = multichain_phase(
        "multichain", corpus,
        LdaConfig(topic_num=10, seed=seed, block_size=8_192, chains=4,
                  iteration=MULTICHAIN_SWEEPS),
        LL_EVERY, MULTICHAIN_COMPARE, device)
    del corpus
    wide = multichain_phase(
        "multichain wide", wide_corpus if wide_corpus is not None else synth_corpus(seed),
        LdaConfig(topic_num=K, seed=seed, block_size=BLOCK, alpha=ALPHA,
                  beta=BETA, chains=4, iteration=WIDE_SWEEPS),
        LL_EVERY, WIDE_COMPARE, device)
    return {"rung4": narrow, "wide": wide}


# (α, β) of a graph's first call, then of the next: a Minka-like change
GRAPH_HYPERS = ((ALPHA, BETA), (0.013, 0.71))
# captured sweeps timed per path (eager: the 3 sweeps of the comparison)
GRAPH_TIMED = {"xla": 10, "pallas-draw": 100, "multichain": 10, "multichain wide": 3,
               "cvb0": 20, "cvb0 wide": 3, "warp": 50,
               "deferred": 50, f"deferred K={K_GENERAL}": 50, "fused": 50}

def graph_ops(sweep_graph) -> int:
    """The card's operations per replay of an ``ops/graphs.SweepGraph``: the
    graph's nodes (counted when it was captured) and the two fills per
    generator that PyTorch's replay enqueues to hand it the generator's seed
    and offset."""
    return sweep_graph.nodes + 2 * len(sweep_graph.generators)


def card_noise(kind: str, shape: tuple, seed: int):
    """``noise(i, c=0)``: sweep ``i``'s (chain ``c``'s) external noise, made
    on the card from the seed: uniforms (K3, ``inverse_cdf``) or Gumbel
    values (the XLA gumbel draw)."""
    import torch

    def noise(i: int, c: int = 0):
        g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + 1_000 * c + i)
        u = torch.rand(shape, generator=g, device="cuda").mul_(1 - 2e-7).add_(1e-7)
        return -torch.log(-torch.log(u)) if kind == "gumbel" else u
    return noise


def _per_sweep(one: dict, five: dict) -> dict:
    """A profiled call's operations per sweep, less the call's own (copies in
    and out, the parameters): a call of 5 sweeps against a call of 1."""
    return {k: (five[k] - one[k]) / 4 for k in one}


def _graph_report(label: str, graph, eager_s: float, timed: tuple,
                  tokens_per_sweep: int, eager_prof: dict, captured: dict,
                  smi: str, checked: str = (
                      "(z, ndk, nwk, nk) in internal and external noise across "
                      f"an alpha/beta change {GRAPH_HYPERS[0]} -> {GRAPH_HYPERS[1]}")
                  ) -> dict:
    import torch

    n_timed, timed_s = timed
    rates = dict(eager_tokens_per_s=3 * tokens_per_sweep / eager_s,
                 captured_tokens_per_s=n_timed * tokens_per_sweep / timed_s)
    captured = dict(captured, device_ops=graph_ops(graph))
    eager_prof = dict(eager_prof, device_ops=eager_prof["host_calls"])
    out = dict(**rates, eager_ms_per_sweep=eager_s / 3 * 1e3,
               captured_ms_per_sweep=timed_s / n_timed * 1e3,
               setup_s=graph.setup_s, capture_s=graph.capture_s,
               graph_nodes=graph.nodes, captured_per_sweep=captured,
               eager_per_sweep=eager_prof,
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    if captured["graph_launches"] != 1:
        raise AssertionError(f"[graphs {label}] {captured['graph_launches']} graph "
                             "launches per sweep, not one")
    log(f"[graphs {label}] captured against eager bitwise {checked}; tokens/s eager "
        f"{rates['eager_tokens_per_s']:,.0f} ({out['eager_ms_per_sweep']:.2f} ms a "
        f"sweep), captured {rates['captured_tokens_per_s']:,.0f} "
        f"({out['captured_ms_per_sweep']:.2f} ms, {n_timed} sweeps in one call); per "
        f"sweep: host calls eager {eager_prof['host_calls']:,}, captured "
        f"{captured['host_calls']:g} ({captured['graph_launches']:g} graph launch); "
        f"device operations eager {eager_prof['device_ops']:,} (one per host call), "
        f"captured {captured['device_ops']:,} (the graph's {graph.nodes:,} nodes and the "
        f"generators' fills); set-up (the first call before its first replay: "
        f"copies, warm-up sweep, capture, instantiation) {graph.setup_s:.4f}s, of "
        f"it capture and instantiation {graph.capture_s:.4f}s; peak "
        f"device memory {out['peak_allocated_gb']:.3f} GB allocated, "
        f"{out['peak_reserved_gb']:.3f} GB reserved (the graph pools included); {smi}")
    return out


def _assert_tables(label: str, got, want) -> None:
    import torch

    for name, g, w in zip(("z", "ndk", "nwk", "nk"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"[graphs {label}] captured {name} differs from eager")


def graph_single_path(corpus, seed: int, use_pallas: bool, smi: str) -> tuple[dict, dict]:
    """``[graphs xla]`` / ``[graphs pallas-draw]``: ``make_sweep_fn``'s run
    (one replay a sweep) on ``make_backend``'s layout and state against the
    eager ``gibbs_sweep``, in internal and external noise; returns the report
    and the kernel launches of the captured runs."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep, make_sweep_fn, sweep_seed

    dev = torch.device("cuda")
    label = TIER_NAMES[use_pallas]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_backend(LdaConfig(alpha=ALPHA, beta=BETA, topic_num=K,
                                   block_size=BLOCK, seed=seed, use_pallas=use_pallas),
                         corpus, device=dev)
    pc, st0 = model._padded, model.state
    tw, td, tm = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                  for a in (pc.token_word, pc.token_doc, pc.token_mask))
    dl = torch.from_numpy(model.doc_lengths.astype(np.int32)).to(dev)
    (a0, b0), (a1, b1) = GRAPH_HYPERS
    launches: dict = {}
    report = None
    for mode in ("external", "internal"):
        run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                            model.doc_lengths, alpha=ALPHA, beta=BETA,
                            block_size=BLOCK, use_pallas=use_pallas, num_topics=K,
                            noise_mode=mode, device=dev)
        noise = (card_noise("uniform" if use_pallas else "gumbel",
                            (pc.num_tokens, K), seed + 11)
                 if mode == "external" else None)
        counted = tracing.counters()
        gen = torch.Generator().manual_seed(seed + 3)
        got = run(st0, a0, b0, n_sweeps=2, generator=gen, noise=noise)
        got = run(got, a1, b1, n_sweeps=1, generator=gen, noise=noise)
        torch.cuda.synchronize()
        for name, n in kernel_counts(counted)[0].items():
            launches[name] = launches.get(name, 0) + n
        gen = torch.Generator().manual_seed(seed + 3)

        def eager(s=st0, hypers=((a0, b0), (a0, b0), (a1, b1))):
            for a, b in hypers:
                s = gibbs_sweep(s, tw, td, tm, dl, alpha=a, beta=b, block_size=BLOCK,
                                use_pallas=use_pallas, noise_mode=mode,
                                seed=sweep_seed(gen) if mode == "internal" else 0,
                                noise=None if noise is None else noise(s.sweep))
            return s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        _assert_tables(f"{label} {mode}", (got.z, got.ndk, got.nwk, got.nk),
                       (want.z, want.ndk, want.nwk, want.nk))
        if mode == "external":
            continue
        counted = tracing.counters()
        n_timed = GRAPH_TIMED[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(got, n_sweeps=n_timed, generator=gen)
        torch.cuda.synchronize()
        timed = (n_timed, time.perf_counter() - t0)
        for name, n in kernel_counts(counted)[0].items():
            launches[name] = launches.get(name, 0) + n
        run(got, n_sweeps=1, generator=gen)  # both profiled calls copy got in
        one = launch_profile(lambda: run(got, n_sweeps=1, generator=gen))
        five = launch_profile(lambda: run(got, n_sweeps=5, generator=gen))
        eager_prof = launch_profile(lambda: eager(got, ((a0, b0),)))
        (graph,) = run.graphs.values()
        report = _graph_report(label, graph, eager_s, timed, corpus.num_tokens,
                               eager_prof, _per_sweep(one, five), smi)
    del model
    return report, {n: c for n, c in launches.items() if c}


def graph_kernel_tier_path(corpus, seed: int, tier: str, k: int,
                           smi: str) -> tuple[dict, dict]:
    """``[graphs deferred]`` / ``[graphs deferred K=100]`` / ``[graphs
    fused]``: ``make_sweep_fn``'s run (one replay a sweep; the deferred
    tier's ``with_mirror``, its snapshot carried) on ``make_backend``'s
    layout and state against the eager ``_deferred_sweep_impl`` /
    ``fused_gibbs_sweep``, in internal and external noise; returns the
    report and the kernel launches of the captured runs."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.ops.gibbs import (
        _deferred_sweep_impl, fused_gibbs_sweep, make_sweep_fn, sweep_seed)

    dev = torch.device("cuda")
    label = tier if k == K else f"{tier} K={k}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_backend(LdaConfig(alpha=ALPHA, beta=BETA, topic_num=k,
                                   block_size=BLOCK, seed=seed, use_pallas=tier),
                         corpus, device=dev)
    if model.kernel_tier != tier:
        raise AssertionError(f"[graphs {label}] the model runs {model.kernel_tier}")
    plan = model._plan
    layout, st0 = (plan if tier == "deferred" else model._padded), model.state
    tw, td, tm = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                  for a in (layout.token_word, layout.token_doc, layout.token_mask))
    k_pad = -(-k // 128) * 128
    (a0, b0), (a1, b1) = GRAPH_HYPERS
    launches: dict = {}
    report = None
    for mode in ("external", "internal"):
        run = make_sweep_fn(layout.token_word, layout.token_doc, layout.token_mask,
                            alpha=ALPHA, beta=BETA, block_size=BLOCK,
                            use_pallas=tier, num_topics=k, deferred_plan=plan,
                            noise_mode=mode, device=dev)
        noise = (card_noise("uniform", (layout.num_tokens, k_pad), seed + 11)
                 if mode == "external" else None)

        def call(st, mirror, a=ALPHA, b=BETA, n=1, gen=None):
            kw = dict(n_sweeps=n, generator=gen, noise=noise)
            if tier == "deferred":
                return run.with_mirror(st, a, b, mirror, **kw)
            return run(st, a, b, **kw), None
        counted = tracing.counters()
        gen = torch.Generator().manual_seed(seed + 3)
        got, snap = call(st0, None, a0, b0, 2, gen)
        got, snap = call(got, snap, a1, b1, 1, gen)
        torch.cuda.synchronize()
        for name, n in kernel_counts(counted)[0].items():
            launches[name] = launches.get(name, 0) + n
        gen = torch.Generator().manual_seed(seed + 3)

        def eager(s=st0, mirror=None, hypers=((a0, b0), (a0, b0), (a1, b1))):
            for a, b in hypers:
                kw = dict(noise_mode=mode,
                          seed=sweep_seed(gen) if mode == "internal" else 0,
                          uniforms=None if noise is None else noise(s.sweep))
                if tier == "deferred":
                    s, mirror = _deferred_sweep_impl(
                        s, tw, td, tm, a, b, row_tile=run.row_tile,
                        v_pad=plan.v_pad, mirror=mirror, **kw)
                else:
                    s = fused_gibbs_sweep(s, tw, td, tm, a, b, block_size=BLOCK,
                                          row_tile=run.row_tile, **kw)
            return s, mirror
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_snap = eager()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        _assert_tables(f"{label} {mode}", (got.z, got.ndk, got.nwk, got.nk),
                       (want.z, want.ndk, want.nwk, want.nk))
        if tier == "deferred" and not torch.equal(snap, want_snap):
            raise AssertionError(f"[graphs {label} {mode}] captured snapshot differs "
                                 "from eager")
        if mode == "external":
            continue
        counted = tracing.counters()
        n_timed = GRAPH_TIMED[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, snap = call(got, snap, n=n_timed, gen=gen)
        torch.cuda.synchronize()
        timed = (n_timed, time.perf_counter() - t0)
        for name, n in kernel_counts(counted)[0].items():
            launches[name] = launches.get(name, 0) + n
        # each profiled call takes the state the last one returned, as
        # LdaModel and the bench script pass it back: no copy in
        held = [got, snap]

        def calls(n):
            def fn():
                held[:] = call(*held, n=n, gen=gen)
            return fn
        one, five = launch_profile(calls(1)), launch_profile(calls(5))
        eager_prof = launch_profile(lambda: eager(got, snap, ((a0, b0),)))
        (graph,) = run.graphs.values()
        report = _graph_report(label, graph, eager_s, timed, corpus.num_tokens,
                               eager_prof, _per_sweep(one, five), smi)
        report["per_replay"] = graph.per_replay
    del model
    return report, {n: c for n, c in launches.items() if c}


def graph_chain_path(label: str, corpus, cfg, seed: int, smi: str) -> dict:
    """``[graphs multichain]`` / ``[graphs multichain wide]``: ``ChainSet``'s
    batched sweep (one replay a sweep) against the eager
    ``gibbs_sweep_chains`` from the same stacked state and seeds, in internal
    and external noise, with the config's alpha and beta changed between
    calls."""
    import dataclasses

    import torch

    from ldagibbssampling_tpu_torch.models.chains import ChainSet
    from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep_chains, sweep_seed

    dev = torch.device("cuda")
    (a0, b0), (a1, b1) = GRAPH_HYPERS
    c_n = cfg.chains
    report = None
    for mode in ("external", "internal"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cs = ChainSet(cfg, corpus, device=dev, noise_mode=mode)
        st0 = cs._stacks[dev]
        tables0 = (st0.z, st0.ndk, st0.nwk, st0.nk)
        gens = [torch.Generator().set_state(g.get_state()) for g in cs.generators]
        made = card_noise("gumbel", (cs._padded.num_tokens, cfg.topic_num), seed + 13)

        def noise(c, sweep):
            return made(sweep, c)
        ext = noise if mode == "external" else None
        cs.config = dataclasses.replace(cfg, alpha=a0, beta=b0)
        cs.sweep(2, noise=ext)
        cs.config = dataclasses.replace(cfg, alpha=a1, beta=b1)
        cs.sweep(1, noise=ext)
        cs.config = cfg

        def eager(tables=tables0, hypers=((a0, b0), (a0, b0), (a1, b1)), sweep=0):
            for a, b in hypers:
                tables = gibbs_sweep_chains(
                    *tables, *cs._tokens[dev], alpha=a, beta=b,
                    block_size=cs.block_size, noise_mode=mode,
                    seeds=[sweep_seed(g) for g in gens] if mode == "internal" else (),
                    noise=(torch.stack([noise(c, sweep) for c in range(c_n)])
                           if mode == "external" else None))
                sweep += 1
            return tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        st = cs._stacks[dev]
        _assert_tables(f"{label} {mode}", (st.z, st.ndk, st.nwk, st.nk), want)
        if mode == "internal":
            n_timed = GRAPH_TIMED[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.sweep(n_timed)
            torch.cuda.synchronize()
            timed = (n_timed, time.perf_counter() - t0)
            one = launch_profile(lambda: cs.sweep(1))
            five = launch_profile(lambda: cs.sweep(5))
            st = cs._stacks[dev]
            eager_prof = launch_profile(
                lambda: eager((st.z, st.ndk, st.nwk, st.nk), ((a0, b0),)))
            report = _graph_report(label, cs._graphs[dev], eager_s, timed,
                                   corpus.num_tokens * c_n, eager_prof,
                                   _per_sweep(one, five), smi)
        del cs, st0, tables0, want, st
    return report


def resample_tables(seed: int, corpus, device: str = "cuda") -> list:
    """SMC's four per-particle tables at the shape of its run on ``corpus``
    (``SMC_PARTICLES``, ``BACKEND_K``), random counts from the seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    p, k = SMC_PARTICLES, BACKEND_K
    return [torch.randint(0, 1 << 20, shape, generator=g, device=device,
                          dtype=torch.int32)
            for shape in ((p, corpus.num_docs, k), (p, corpus.vocab_size, k),
                          (p, k), (p, corpus.num_tokens))]


def check_resample_kernels(seed: int, device: str = "cuda") -> dict:
    """Phase 3e: the resample's two gated kernels (``ops/smc_resample.py``)
    against their plain versions at SMC's shape in ``[graphs smc]`` and
    ``[backends]`` (rung 5 at 0.01, P = 16, K = 15), with the flag true (a
    gather by drawn indices, then the write-back: bitwise, and the count)
    and false (nothing moves); each kernel's device time with the flag true
    (``ms``, a resample) and false (``ms_flag_false``, every token's cost),
    the plain versions' (events, the flag read on the host) and the bound:
    the tables' bytes read once and written once."""
    import torch

    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.ops import smc_resample as sr

    corpus, _ = rung_corpus(5, SMC_SCALE)
    tables = resample_tables(seed, corpus, device)
    p = SMC_PARTICLES
    idx = torch.randint(0, p, (p,), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed + 1))
    flags = {f: torch.tensor(f, device=device) for f in (True, False)}
    err = 0.0
    for flag, f in flags.items():
        out = []
        for gather, write in ((sr.resample_gather, sr.resample_write),
                              (sr.resample_gather_plain, sr.resample_write_plain)):
            tabs = [t.clone() for t in tables]
            scratch = [torch.zeros_like(t) for t in tables]
            count = torch.zeros(1, dtype=torch.int64, device=device)
            gather(f, idx, tabs, scratch, count)
            write(f, scratch, tabs)
            out.append([*tabs, count])
        torch.cuda.synchronize()
        for a, b in zip(*out):
            err = max(err, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"[kernels] smc_resample, flag {flag}: the "
                                     "kernels differ from the plain versions")
        if int(out[0][-1]) != flag or (not flag and not all(
                torch.equal(a, b) for a, b in zip(out[0], tables))):
            raise AssertionError(f"[kernels] smc_resample, flag {flag}: count "
                                 f"{int(out[0][-1])}, or the tables moved")
    log(f"[kernels] smc_resample: gather and write-back equal the plain versions "
        f"with the flag true and false, bitwise, at P {p}, M {corpus.num_docs}, V "
        f"{corpus.vocab_size}, K {BACKEND_K}, T {corpus.num_tokens}")
    scratch = [torch.empty_like(t) for t in tables]
    count = torch.zeros(1, dtype=torch.int64, device=device)
    fns = {"resample_gather": lambda f, plain=False: (
               sr.resample_gather_plain if plain else sr.resample_gather)(
                   f, idx, tables, scratch, count),
           "resample_write": lambda f, plain=False: (
               sr.resample_write_plain if plain else sr.resample_write)(
                   f, scratch, tables)}
    nbytes = 2 * sum(t.numel() * 4 for t in tables)
    out = {name: dict(max_abs_err=err) for name in fns}
    report(out, {name: (lambda fn=fn: fn(flags[True]),
                        cuda_ms(lambda fn=fn: fn(flags[True], plain=True)), None)
                 for name, fn in fns.items()},
           {name: bound(nbytes, 0) for name in fns},
           {name: f"one resample of the four tables ({nbytes / 2 / 1e6:.2f} MB, "
                  "flag true)" for name in fns})
    for name, fn in fns.items():
        out[name].update(ms_flag_false=device_ms(lambda fn=fn: fn(flags[False]), name),
                         event_ms_flag_false=cuda_ms(lambda fn=fn: fn(flags[False])))
        log(f"[kernels] {name} with the flag false (a token without a resample): "
            f"device {out[name]['ms_flag_false']} ms, events "
            f"{out[name]['event_ms_flag_false']:.4f} ms")
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi's ``clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def scatter_bound(plan, block: int, k: int, clock_hz: float) -> tuple[float, str]:
    """The least time of one block's scatter along ``plan``: the larger of
    the bytes' time (the block's rows, its plan entries and the table rows
    it touches read once, those rows written once) and the chain's floor,
    the longest run's dependent float32 adds at ``SCATTER_ADD_CYCLES`` each
    at the SM clock ("operations": no order of additions but the plan's
    keeps the bits)."""
    r0, r1 = plan.block_runs[block], plan.block_runs[block + 1]
    runs = r1 - r0
    b = plan.block_size
    t_bytes, _ = bound(4 * (b * k + b + 2 * runs + 1 + 2 * runs * k), 0)
    longest = int((plan.bounds[r0 + 1:r1 + 1] - plan.bounds[r0:r1]).max())
    t_chain = longest * SCATTER_ADD_CYCLES / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")


def check_cvb0_scatter(seed: int, rung5, wide_corpus, device: str = "cuda",
                       parent: Path | None = None) -> dict:
    """Phase 3f: CVB0's fixed-order scatter (``ops/cvb0_scatter.py``) along
    the plans of ``[graphs cvb0]``'s two shapes, rung 5 at 0.2 (``rung5``,
    K = 15, block 8,192) and bench.py's (Zipf(1.1), K = 500, block 65,536; a frequent
    word's run holds thousands of a block's tokens), each table (``ndk`` by
    document, ``nwk`` by word), and of one word filling a block of 65,536
    at K = 500 (then a padded block: the chain's floor): a random table and
    block of rows from the seed, the first and the last (padded) block,
    against the plain version (the CPU's ``index_add_`` in token order) on
    copies of the same inputs, bitwise.  Each scatter's device time per launch (``torch.profiler``),
    events, the plain version's host ms on the copies (the least of five
    calls: the host's clock varies), and the library's
    calls on the card: ``index_put_(accumulate=True)`` (sort-based: a fixed
    order) and the atomic ``index_add_`` (no fixed order), events and
    device time per call; the bound per block (``scatter_bound``).  With
    ``parent`` (the root of another checkout), the two kernels at the same
    shapes in turns, each in a process of its own, bitwise
    (``scripts/scatter_parity.compare``).  The kernels line's ``ms`` is
    ``nwk``'s at rung 5's shape."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.ops import cvb0_scatter as cs

    clock = sm_clock_hz()
    wide = wide_corpus.pad_to(BLOCK)
    one_word = np.concatenate([np.full(2 * BLOCK - 5_000, 7), np.zeros(5_000, np.int64)])
    shapes, err = {}, 0.0
    for label, k, block, tables in (
            ("rung5", BACKEND_K, 8_192, ((rung5.pad_to(8_192), "ndk"),
                                         (rung5.pad_to(8_192), "nwk"))),
            ("bench", K, BLOCK, ((wide, "ndk"), (wide, "nwk"))),
            ("one_word", K, BLOCK, ((one_word, "nwk"),))):
        g = torch.Generator(device=device).manual_seed(seed)
        rows = torch.rand((block, k), generator=g, device=device).sub_(0.5)
        for src, table_name in tables:
            if isinstance(src, np.ndarray):
                ids, n_rows = src, int(src.max()) + 1
            elif table_name == "ndk":
                ids, n_rows = src.token_doc, src.num_docs
            else:
                ids, n_rows = src.token_word, src.vocab_size
            plan = cs.scatter_plan(ids, block, device)
            host_plan = cs.scatter_plan(ids, block, "cpu")
            table = torch.rand((n_rows, k), generator=g, device=device)
            for b in (0, plan.num_blocks - 1):
                got, want = table.clone(), table.cpu()
                cs.cvb0_scatter(got, rows, plan, b)
                cs.cvb0_scatter(want, rows.cpu(), host_plan, b)
                got = got.cpu()
                err = max(err, float((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"[kernels] cvb0_scatter {label} {table_name} "
                                         f"block {b}: differs from the plain version")
            runs = plan.block_runs[1] - plan.block_runs[0]
            longest = int((host_plan.bounds[1:runs + 1] - host_plan.bounds[:runs]).max())
            units = plan.block_units[1] - plan.block_units[0]
            index = plan.index[:block]
            host = (table.cpu(), index.cpu(), rows.cpu())

            def fn(plan=plan, table=table):
                cs.cvb0_scatter(table, rows, plan, 0)

            def plain(host=host):
                cs.cvb0_scatter_plain(*host)

            def put(table=table, index=index):
                table.index_put_((index,), rows, accumulate=True)

            def add(table=table, index=index):
                table.index_add_(0, index, rows)
            plain()
            plain_ms = min(_timed(plain) for _ in range(5)) * 1e3
            b_ms, b_by = scatter_bound(host_plan, 0, k, clock)
            row = dict(ms=device_ms(fn, "cvb0_scatter"), event_ms=cuda_ms(fn),
                       plain_host_ms=plain_ms,
                       index_put_ms=cuda_ms(put), index_put_device_ms=call_device_ms(put),
                       index_add_ms=cuda_ms(add), index_add_device_ms=call_device_ms(add),
                       bound_ms=b_ms, bound_by=b_by, runs=runs, longest_run=longest,
                       units=units, k=k, block=block, rows=n_rows)
            shapes[f"{label} {table_name}"] = row
            log(f"[kernels] cvb0_scatter {label} {table_name} (K {k}, block {block}, "
                f"{runs} runs, the longest {longest}; {units} units): device "
                f"{row['ms']} ms per "
                f"launch, events {row['event_ms']:.4f} ms; plain (CPU index_add_, least of "
                f"5) {row['plain_host_ms']:.4f} ms; index_put_ accumulate events "
                f"{row['index_put_ms']:.4f} ms, device {row['index_put_device_ms']}; "
                f"atomic index_add_ events {row['index_add_ms']:.4f} ms, device "
                f"{row['index_add_device_ms']}; bound {b_ms:.5f} ms by {b_by} "
                f"(SM clock {clock / 1e6:.0f} MHz)")
            del plan, host_plan, table, host
    torch.cuda.synchronize()
    log(f"[kernels] cvb0_scatter: both tables at rung 5's and bench.py's shapes and "
        f"one word filling a block, the first and the last block, bitwise the plain "
        f"version on copies of the same inputs")
    main = shapes["rung5 nwk"]
    res = dict(
        max_abs_err=err, ms=main["ms"], event_ms=main["event_ms"],
        device_ms=main["ms"], plain_ms=main["plain_host_ms"],
        library_ms=main["index_put_ms"], library_device_ms=main["index_put_device_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        unit=(f"one block's nwk scatter at rung 5's 0.2 (K {BACKEND_K}, block 8,192); "
              "plain_ms: the CPU's index_add_ on the host, least of 5; library_ms: "
              "index_put_(accumulate=True) on the card"),
        scatter_shapes=shapes)
    if parent is not None:
        from ldagibbssampling_tpu_torch.scripts import scatter_parity

        turns = scatter_parity.compare(parent, seed)
        if not turns["equal"]:
            raise AssertionError(f"[kernels] cvb0_scatter differs from {parent}'s: "
                                 f"{turns['differ']}")
        for label in turns["device_ms"]["this"]:
            this, other = (turns["device_ms"][side][label] for side in ("this", "other"))
            log(f"[kernels] cvb0_scatter {label} in turns (other, this, this, other), "
                f"device ms per launch: this {this['min']:.5f}-{this['max']:.5f}, "
                f"{parent.name} {other['min']:.5f}-{other['max']:.5f}; bitwise")
        res["scatter_turns"] = turns
    return {"cvb0_scatter": res}


def graph_smc_phase(seed: int, smi: str, resample: dict,
                    device: str = "cuda") -> tuple[dict, dict]:
    """Phase 8d, ``[graphs smc]``: SMC's captured absorb (``SmcGraph``, one
    replay a ``GRAPH_STEPS`` tokens) against the eager ``smc_absorb`` on rung
    5 at 0.01 (P = 16, K = 15): the eager absorb of the pass's first noise
    block of 4,096 tokens, then the captured one of the same tokens from the
    same state and noise (bitwise), then the rest of the pass captured: µs
    a token eager and captured, host calls a token eager (the profiler, over
    ``GRAPH_STEPS`` tokens) and captured (and graph launches, over
    ``SMC_PROFILED`` tokens), nodes a replay, resamples in the pass,
    the resample's device time against its bound, set-up, peak memory, the
    resample kernels' launches exact (one a token, and the warm-up step's).
    Returns the report and the launches."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldagibbssampling_tpu_torch.backends.smc import (
        GRAPH_STEPS, NOISE_BLOCK, SmcModel, smc_absorb)
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing

    corpus, _ = rung_corpus(5, SMC_SCALE)
    cfg = LdaConfig(topic_num=BACKEND_K, seed=seed, block_size=8_192)
    t_total = corpus.num_tokens
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = SmcModel(cfg, corpus, num_particles=SMC_PARTICLES, device=device)
    ref = SmcModel(cfg, corpus, num_particles=SMC_PARTICLES, device=device)
    pass_seed = int(torch.randint(0, 2**63 - 1, (), generator=ref.generator))
    n0 = min(NOISE_BLOCK, t_total)
    g, rg = ref._noise(pass_seed, 0, n0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = smc_absorb(*ref._tables(), ref._tw, ref._td, True, 0, alpha=cfg.alpha,
                      beta=cfg.beta, ess_threshold=ref.ess_threshold, num_steps=n0,
                      gumbels=g, resample_gumbels=rg)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    # the eager absorb's host calls a token, over GRAPH_STEPS tokens on a copy
    g, rg = ref._noise(pass_seed, n0, GRAPH_STEPS)
    eager_prof = launch_profile(lambda: smc_absorb(
        *[x.clone() for x in want], ref._tw, ref._td, True, n0, alpha=cfg.alpha,
        beta=cfg.beta, ess_threshold=ref.ess_threshold, num_steps=GRAPH_STEPS,
        gumbels=g, resample_gumbels=rg))
    del g, rg, ref

    # the model's own absorb, as its sweep runs it: the pass's noise blocks
    # filled once, chunks of its chunk size
    if int(torch.randint(0, 2**63 - 1, (), generator=model.generator)) != pass_seed:
        raise AssertionError("[graphs smc] the two models' pass seeds differ")
    fill = functools.partial(model._fill_block, set(), pass_seed)
    sg = model.graph

    def absorb(tables, pos, c):
        for p0 in range(pos, pos + c, model.chunk_size):
            tables = sg.absorb(tables, True, p0, min(model.chunk_size, pos + c - p0),
                               fill, alpha=cfg.alpha, beta=cfg.beta)
        return tables
    counted = tracing.counters()
    sg.resamples.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = absorb(model._tables(), 0, n0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for name, a, b in zip(("ndk", "nwk", "nk", "z", "logw"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"[graphs smc] captured {name} differs from eager "
                                 f"after {n0} tokens")
    del want
    # host calls a token over SMC_PROFILED tokens of one absorb call (the
    # profiler records each replay's every node: a short window)
    n1 = min(SMC_PROFILED, t_total - n0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = absorb(got, n0, n1)
        torch.cuda.synchronize()
    calls = [e.name for e in prof.events()
             if e.name.startswith((*LAUNCH_CALLS, "cudaGraphLaunch"))]
    graph_launches = sum(n.startswith("cudaGraphLaunch") for n in calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = absorb(got, n0 + n1, t_total - n0 - n1)
    torch.cuda.synchronize()
    rest_s = time.perf_counter() - t0
    resamples = int(sg.resamples)
    launches, plain = kernel_counts(counted)
    want_launches = {"resample_gather": t_total + 1, "resample_write": t_total + 1}
    got_launches = {n: c for n, c in launches.items() if c}
    if got_launches != want_launches or any(plain.values()):
        raise AssertionError(f"[graphs smc] launches {got_launches}, want "
                             f"{want_launches} (one a token and the warm-up step's); "
                             f"plain {plain}")
    if graph_launches != -(-n1 // GRAPH_STEPS):
        raise AssertionError(f"[graphs smc] {graph_launches} graph launches for "
                             f"{n1} tokens, not one per {GRAPH_STEPS}")
    nk = got[2]
    if not (nk.sum(dim=1) == t_total).all():
        raise AssertionError("[graphs smc] the particles' counts do not cover the pass")
    steps = sg.graph
    pair_ms = resample["resample_gather"]["ms"] + resample["resample_write"]["ms"]
    out = dict(
        tokens=t_total, eager_tokens=n0,
        eager_us_per_token=eager_s / n0 * 1e6,
        captured_first_block_us_per_token=first_s / n0 * 1e6,
        captured_us_per_token=rest_s / (t_total - n0 - n1) * 1e6,
        host_calls_per_token=len(calls) / n1, graph_launches_per_token=graph_launches / n1,
        eager_host_calls_per_token=eager_prof["host_calls"] / GRAPH_STEPS,
        nodes={str(n): c for n, c in steps.nodes.items()},
        nodes_per_token=steps.nodes[GRAPH_STEPS] / GRAPH_STEPS,
        resamples_per_pass=resamples, setup_s=steps.setup_s,
        capture_s={str(n): c for n, c in steps.capture_s.items()},
        resample_pair_ms=pair_ms, resample_bound_ms=resample["resample_gather"]["bound_ms"],
        resample_flag_false_ms=(resample["resample_gather"]["ms_flag_false"]
                                + resample["resample_write"]["ms_flag_false"]),
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    log(f"[graphs smc] rung 5 at {SMC_SCALE} ({t_total} tokens, M {corpus.num_docs}, "
        f"V {corpus.vocab_size}, K {BACKEND_K}, P {SMC_PARTICLES}): captured against "
        f"eager bitwise (z, ndk, nwk, nk, logw) after the first {n0} tokens; us a "
        f"token eager {out['eager_us_per_token']:.1f}, captured "
        f"{out['captured_us_per_token']:.1f} (tokens {n0 + n1}-{t_total}; the first "
        f"block with the set-up {out['captured_first_block_us_per_token']:.1f}); host "
        f"calls a token eager {out['eager_host_calls_per_token']:.2f}, captured "
        f"{out['host_calls_per_token']:.4f} ({graph_launches} graph launches for {n1} "
        f"tokens); nodes {out['nodes']} "
        f"({out['nodes_per_token']:.2f} a token); resamples in the pass {resamples} "
        f"({resamples / t_total:.4f} a token); a resample's two kernels "
        f"{pair_ms:.4f} ms of device time against a {out['resample_bound_ms']:.4f} ms "
        f"bound (flag false: {out['resample_flag_false_ms']:.4f} ms a token); "
        f"set-up (warm-up step, capture, instantiation) {steps.setup_s:.4f}s, "
        f"captures {out['capture_s']}; peak device memory "
        f"{out['peak_allocated_gb']:.3f} GB allocated, {out['peak_reserved_gb']:.3f} GB "
        f"reserved; {smi}")
    del model, got
    return out, got_launches


def graph_svi_phase(seed: int, smi: str, device: str = "cuda") -> dict:
    """Phase 8e, ``[graphs svi]``: SVI's step (``SviGraph``, one replay a
    minibatch) at rung 5 at 0.2 (K = 15, V = 20,000, batch 64): ``SVI_STEPS``
    steps alone on batches already on the card (a changing rho, every
    fourth batch short), eager ``svi_step`` then captured from the same
    lambda, bitwise (lambda and each gamma); ms and host calls a step
    (``torch.profiler``); then one epoch with its host work (densify,
    copies, gamma to the host) captured (``SviModel.sweep``) and eager (the
    same model stepping ``svi_step``), bitwise."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.backends.svi import SviModel, svi_step
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.data.stream import minibatch_indices

    corpus, _ = rung_corpus(5, SVI_SCALE)
    cfg = LdaConfig(topic_num=BACKEND_K, seed=seed, block_size=8_192)
    model = SviModel(cfg, corpus, batch_size=SVI_BATCH, device=device)
    kw = dict(alpha=cfg.alpha, eta=model.eta, e_steps=model.e_steps,
              total_docs=corpus.num_docs)
    batches = []
    for i, (idx, real) in zip(range(4), minibatch_indices(
            corpus.num_docs, SVI_BATCH, np.random.default_rng(seed))):
        real = real if i < 3 else SVI_BATCH // 2 + 7  # a short batch
        batches.append((torch.from_numpy(model._batch_bow(idx, real)).to(device), real))
    rhos = [(1.0 + i) ** -0.7 for i in range(SVI_STEPS)]

    def run(step, lam, gammas):
        t0 = 0.0
        for i, rho in enumerate(rhos):
            if i == 1:  # the first step (the graph's set-up) untimed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            bow, real = batches[i % 4]
            lam, gamma = step(lam, bow, rho, real)
            gammas.append(gamma)
        torch.cuda.synchronize()
        return lam, (time.perf_counter() - t0) / (len(rhos) - 1) * 1e3

    def eager(lam, bow, rho, real):
        return svi_step(lam, bow, rho, real, **kw)
    want_g, got_g = [], []
    want, eager_ms = run(eager, model.lam, want_g)
    got, captured_ms = run(model.graph, model.lam, got_g)
    if not (torch.equal(got, want) and all(map(torch.equal, got_g, want_g))):
        raise AssertionError("[graphs svi] the captured steps differ from eager")
    bow, real = batches[0]
    eager_prof = launch_profile(lambda: eager(want, bow, 0.3, real))
    captured = launch_profile(lambda: model.graph(got, bow, 0.3, real))
    if captured["graph_launches"] != 1:
        raise AssertionError(f"[graphs svi] {captured['graph_launches']} graph "
                             "launches a step, not one")
    twin = SviModel(cfg, corpus, batch_size=SVI_BATCH, device=device)
    twin.graph = eager  # the same epoch, stepped eagerly
    epoch = {}
    for label, m in (("captured", model), ("eager", twin)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.sweep(1)
        torch.cuda.synchronize()
        epoch[label] = time.perf_counter() - t0
    if not (torch.equal(model.lam, twin.lam)
            and np.array_equal(model._gamma_full, twin._gamma_full)):
        raise AssertionError("[graphs svi] the captured epoch differs from eager")
    steps = model._step_idx
    sg = model.graph.graph
    out = dict(eager_ms_per_step=eager_ms, captured_ms_per_step=captured_ms,
               eager_host_calls_per_step=eager_prof["host_calls"],
               captured_host_calls_per_step=captured["host_calls"],
               captured_graph_launches_per_step=captured["graph_launches"],
               nodes=sg.nodes[1], setup_s=sg.setup_s, capture_s=sg.capture_s[1],
               epoch_steps=steps, tokens=corpus.num_tokens,
               epoch_captured_s=epoch["captured"], epoch_eager_s=epoch["eager"],
               epoch_captured_ms_per_step=epoch["captured"] / steps * 1e3,
               epoch_eager_ms_per_step=epoch["eager"] / steps * 1e3,
               epoch_captured_tokens_per_s=corpus.num_tokens / epoch["captured"],
               epoch_eager_tokens_per_s=corpus.num_tokens / epoch["eager"])
    log(f"[graphs svi] rung 5 at {SVI_SCALE} (K {BACKEND_K}, V {corpus.vocab_size}, "
        f"batch {SVI_BATCH}, {model.e_steps} E-steps): {SVI_STEPS} steps alone "
        f"captured against eager bitwise (lambda, each gamma; rho changing, a short "
        f"batch); ms a step eager {eager_ms:.3f}, captured {captured_ms:.3f}; host "
        f"calls a step eager {eager_prof['host_calls']}, captured "
        f"{captured['host_calls']} ({captured['graph_launches']} graph launch; the "
        f"graph's {sg.nodes[1]} nodes); set-up {sg.setup_s:.4f}s (capture "
        f"{sg.capture_s[1]:.4f}s); an epoch with its host work ({steps} steps, "
        f"{corpus.num_tokens} tokens; bitwise eager) captured {epoch['captured']:.3f}s "
        f"({out['epoch_captured_ms_per_step']:.3f} ms a step, "
        f"{out['epoch_captured_tokens_per_s']:,.0f} tokens/s), eager "
        f"{epoch['eager']:.3f}s ({out['epoch_eager_ms_per_step']:.3f} ms a step, "
        f"{out['epoch_eager_tokens_per_s']:,.0f} tokens/s); {smi}")
    return out


def _timed(fn) -> float:
    """Seconds of ``fn()`` on the host clock, the card waited for before
    and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def graph_cvb0_path(label: str, corpus, cfg, smi: str, gamma0=None) -> tuple[dict, dict]:
    """``[graphs cvb0]`` / ``[graphs cvb0 wide]``: ``Cvb0Model.sweep`` (one
    replay a sweep) against the eager ``cvb0_sweeps`` from the model's
    start, 3 sweeps each (the captured ones as a call of 2 and one of 1):
    gamma and the three tables bitwise; the scatter kernel's launches exact
    (two a block a sweep and the warm-up sweep's), no plain call; then
    ``GRAPH_TIMED[label]`` captured sweeps in one call, host calls a sweep
    from a profiled call of 1 and one of 5, an eager sweep's.  Returns the
    report and the launches."""
    import torch

    from ldagibbssampling_tpu_torch.backends.cvb0 import Cvb0Model, cvb0_sweeps
    from ldagibbssampling_tpu_torch.evaluation import tracing

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Cvb0Model(cfg, corpus, device="cuda", gamma0=gamma0)
    init_s = time.perf_counter() - t0
    blocks = model._padded.num_tokens // model.block_size

    def eager(tables, n):
        out = [t.clone() for t in tables]
        cvb0_sweeps(*out, model._tw, model._td, model._tm, model._plans, n,
                    alpha=cfg.alpha, beta=cfg.beta, block_size=model.block_size)
        return out
    want = []
    eager_s = _timed(lambda: want.extend(eager(model._tables(), 3)))
    counted = tracing.counters()
    model.sweep(2)
    model.sweep(1)
    torch.cuda.synchronize()
    for name, w in zip(("gamma", "ndk", "nwk", "nk"), want):
        if not torch.equal(getattr(model, name), w):
            raise AssertionError(f"[graphs {label}] captured {name} differs from eager")
    del want
    launches, plain = kernel_counts(counted)
    got = {n: c for n, c in launches.items() if c}
    if got != {"cvb0_scatter": 2 * blocks * 4} or any(plain.values()):
        raise AssertionError(f"[graphs {label}] launches {got}, want two scatters a "
                             f"block for 3 sweeps and the warm-up; plain {plain}")
    n_timed = GRAPH_TIMED[label]
    counted = tracing.counters()
    timed = (n_timed, _timed(lambda: model.sweep(n_timed)))
    if kernel_counts(counted)[0]["cvb0_scatter"] != 2 * blocks * n_timed:
        raise AssertionError(f"[graphs {label}] {kernel_counts(counted)[0]} in {n_timed} "
                             "replays, not two scatters a block a replay")
    got["cvb0_scatter"] += 2 * blocks * n_timed
    one = launch_profile(lambda: model.sweep(1))
    five = launch_profile(lambda: model.sweep(5))
    eager_prof = launch_profile(lambda: eager(model._tables(), 1))
    report = _graph_report(label, model.graph, eager_s, timed, corpus.num_tokens,
                           eager_prof, _per_sweep(one, five), smi,
                           checked="(gamma, ndk, nwk, nk)")
    report.update(init_s=init_s, blocks=blocks, sweeps_per_call=(2, 1))
    log(f"[graphs {label}] {corpus.num_tokens} tokens, K {cfg.topic_num}, block "
        f"{model.block_size} ({blocks} blocks a sweep): model built in {init_s:.3f}s "
        f"(the plans, the start, the copies to the card); scatter launches "
        f"{2 * blocks} a sweep; {smi}")
    del model
    return report, got


def graph_warp_phase(corpus, cfg, smi: str) -> dict:
    """``[graphs warp]``: ``WarpModel.sweep`` (one replay a sweep) against the
    eager ``_warp_sweep`` from the model's start, 3 sweeps each (the captured
    ones as a call of 2 and one of 1), in external noise (uniforms made on
    the card) and internal noise (each sweep's seed from a twin of the
    model's host generator, a fresh device generator seeded with it): z and
    the three tables bitwise, no kernel launched; then ``GRAPH_TIMED["warp"]``
    captured sweeps in one call, host calls a sweep (a profiled call of 1
    and one of 5), an eager sweep's."""
    import torch

    from ldagibbssampling_tpu_torch.backends.warp import WarpModel, _warp_sweep
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.ops.gibbs import sweep_seed

    report = None
    for mode in ("external", "internal"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = WarpModel(cfg, corpus, device="cuda", noise_mode=mode)
        st0 = model.state
        t_pad = st0.z.shape[0]
        uniforms = card_noise("uniform", (8, t_pad), cfg.seed + 17)
        gen = torch.Generator().manual_seed(st0.seed)

        def eager(state, n, gen=gen, uniforms=uniforms, mode=mode, model=model):
            for _ in range(n):
                if mode == "external":
                    u = uniforms(state.sweep)
                else:
                    g = torch.Generator(device="cuda").manual_seed(sweep_seed(gen))
                    u = torch.rand((8, t_pad), generator=g, device="cuda")
                state = _warp_sweep(state, u, alpha=model.alpha, beta=model.beta,
                                    **model._args)
            return state
        counted = tracing.counters()
        want = []
        eager_s = _timed(lambda: want.append(eager(st0, 3)))
        model.sweep(2, noise=uniforms)
        model.sweep(1, noise=uniforms)
        torch.cuda.synchronize()
        st = model.state
        _assert_tables(f"warp {mode}", (st.z, st.ndk, st.nwk, st.nk),
                       (want[0].z, want[0].ndk, want[0].nwk, want[0].nk))
        launches, plain = kernel_counts(counted)
        if any(launches.values()) or any(plain.values()):
            raise AssertionError(f"[graphs warp] launches {launches}, plain {plain}")
        if mode == "external":
            continue
        n_timed = GRAPH_TIMED["warp"]
        timed = (n_timed, _timed(lambda: model.sweep(n_timed)))
        one = launch_profile(lambda: model.sweep(1))
        five = launch_profile(lambda: model.sweep(5))
        eager_prof = launch_profile(lambda: eager(model.state, 1))
        report = _graph_report("warp", model.graph, eager_s, timed, corpus.num_tokens,
                               eager_prof, _per_sweep(one, five), smi,
                               checked="(z, ndk, nwk, nk) in external and internal noise")
        del model
    return report


def graph_backends_phase(seed: int, smi: str, rung5, wide_corpus) -> tuple[dict, dict]:
    """Phases 8f-8g: CVB0 (``[graphs cvb0]`` at rung 5's 0.2, ``rung5``;
    ``[graphs cvb0 wide]`` at bench.py's shape from a start made on the
    card) and WarpLDA (``[graphs warp]`` at rung 5's 0.2) captured against
    eager.  Returns the reports and the scatter's launches by path."""
    import torch

    from ldagibbssampling_tpu_torch.config import LdaConfig

    cfg = LdaConfig(topic_num=BACKEND_K, seed=seed, block_size=8_192)
    out, launches = {}, {}
    out["cvb0"], launches["cvb0"] = graph_cvb0_path("cvb0", rung5, cfg, smi)
    out["warp"] = graph_warp_phase(rung5, cfg, smi)
    # bench.py's shape: the start (normalised, masked) made on the card
    wide = LdaConfig(topic_num=K, seed=seed, block_size=BLOCK, alpha=ALPHA, beta=BETA)
    t_pad = -(-wide_corpus.num_tokens // BLOCK) * BLOCK
    g = torch.rand((t_pad, K), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(seed)).add_(0.5)
    g /= g.sum(dim=1, keepdim=True)
    g[wide_corpus.num_tokens:] = 0
    gamma0 = g.cpu().numpy()
    del g
    out["cvb0 wide"], launches["cvb0 wide"] = graph_cvb0_path(
        "cvb0 wide", wide_corpus, wide, smi, gamma0=gamma0)
    return out, launches


def graphs_phase(seed: int, smi: str, wide_corpus) -> tuple[dict, dict]:
    """Phase 8c, ``[graphs]``: each captured path against its eager sweep
    at full width: the deferred tier (K = 500 and K = 100), the fused tier,
    the XLA tier and the v1-draw tier at bench.py's shape, the chains at
    rung 4's full size and at K = 500 on bench.py's shape.  Returns the
    reports and the kernel launches of the captured runs, by path."""
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig

    out, launches = {}, {}
    for tier, k in (("deferred", K), ("deferred", K_GENERAL), ("fused", K)):
        label = tier if k == K else f"{tier} K={k}"
        out[label], launches[label] = graph_kernel_tier_path(wide_corpus, seed,
                                                             tier, k, smi)
    out["xla"], _ = graph_single_path(wide_corpus, seed, False, smi)
    out["pallas-draw"], launches["pallas-draw"] = graph_single_path(
        wide_corpus, seed, True, smi)
    rung4, _ = rung_corpus(4, MULTICHAIN_SCALE)
    out["multichain"] = graph_chain_path(
        "multichain", rung4,
        LdaConfig(topic_num=10, seed=seed, block_size=8_192, chains=4), seed, smi)
    del rung4
    out["multichain wide"] = graph_chain_path(
        "multichain wide", wide_corpus,
        LdaConfig(topic_num=K, seed=seed, block_size=BLOCK, alpha=ALPHA, beta=BETA,
                  chains=4), seed, smi)
    return out, launches


def backends_phase(seed: int, device: str = "cuda") -> tuple[dict, dict]:
    """Phase 9: the five backends at rung 5's configuration (scale 0.2; SMC
    at scale 0.01): tokens/s, training and held-out perplexity, and each
    backend's checks; returns the report and the Gibbs and SMC runs'
    kernel launches."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.backends import (
        Cvb0Model, SmcModel, SviModel, WarpModel)
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
        heldout_perplexity_device)
    from ldagibbssampling_tpu_torch.evaluation.metrics import perplexity
    from ldagibbssampling_tpu_torch.models.lda import LdaModel, _assert_recount

    cfg = LdaConfig(topic_num=BACKEND_K, seed=seed, block_size=8_192)
    out: dict = {}
    gibbs_launches: dict = {}
    smc_launches: dict = {}
    cvb0_launches: dict = {}
    for name, warm, n, scale in BACKEND_RUNS:
        corpus, held = rung_corpus(5, scale)
        build = {"gibbs": lambda: LdaModel(cfg, corpus, device=device),
                 "cvb0": lambda: Cvb0Model(cfg, corpus, device=device),
                 "svi": lambda: SviModel(cfg, corpus, batch_size=64, device=device),
                 "warp": lambda: WarpModel(cfg, corpus, device=device),
                 "smc": lambda: SmcModel(cfg, corpus, num_particles=SMC_PARTICLES,
                                         device=device)}[name]
        model = build()
        if warm:
            model.sweep(warm)
        torch.cuda.synchronize()
        counted = tracing.counters()
        t0 = time.perf_counter()
        model.sweep(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = kernel_counts(counted)
        if any(plain.values()):
            raise AssertionError(f"{name}: plain versions ran: {plain}")
        if name == "gibbs":
            # the graph's warm-up and the first snapshot came with the
            # untimed sweep: then one replay a sweep
            gibbs_launches = {k: v for k, v in launches.items() if v}
            want = {"gibbs_tile_sample": n, "rebuild_counts": n, "cast_mirror": n}
            if model.kernel_tier != "deferred" or gibbs_launches != want:
                raise AssertionError(f"gibbs ran {model.kernel_tier}: {launches}, "
                                     f"want {want}")
        elif name == "smc":
            # the resample's two kernels once a token, and once more for the
            # graph's warm-up step
            smc_launches = {k: v for k, v in launches.items() if v}
            want = {"resample_gather": n * corpus.num_tokens + 1,
                    "resample_write": n * corpus.num_tokens + 1}
            if smc_launches != want:
                raise AssertionError(f"smc launched {launches}, want {want}")
        elif name == "cvb0":
            # two scatters a block and sweep; the graph's warm-up came with
            # the untimed sweep
            cvb0_launches = {k: v for k, v in launches.items() if v}
            blocks = model._padded.num_tokens // model.block_size
            want = {"cvb0_scatter": 2 * blocks * n}
            if cvb0_launches != want:
                raise AssertionError(f"cvb0 launched {launches}, want {want}")
        elif any(launches.values()):
            raise AssertionError(f"{name} launched kernels {launches}")
        v = corpus.vocab_size
        phi, theta = model.phi(), model.theta()
        ppl = perplexity(phi, theta, corpus)
        held_ppl = float(heldout_perplexity_device(phi, held, cfg.alpha,
                                                   device=device))
        if not (1.0 < ppl < v and np.isfinite(held_ppl)):
            raise AssertionError(f"{name}: perplexity {ppl} (V {v}), held-out "
                                 f"{held_ppl}")
        checks = []
        if name == "cvb0":
            model.check_invariants()
            twin = Cvb0Model(cfg, corpus, device=device)
            twin.sweep(warm + n)
            for t in ("gamma", "ndk", "nwk", "nk"):
                if not torch.equal(getattr(twin, t), getattr(model, t)):
                    raise AssertionError(f"two CVB0 runs differ in {t}")
            checks.append(f"invariants hold; a second run from the seed bitwise "
                          f"equal; {dt / n * 1e3:.2f} ms a sweep captured (set-up "
                          f"{model.graph.setup_s:.4f}s in the untimed sweep); "
                          f"launches {cvb0_launches}")
        elif name == "warp":
            pc = model._padded
            real = pc.token_mask.astype(bool)
            st = model.state
            _assert_recount(pc.token_word[real], pc.token_doc[real],
                            st.z.cpu().numpy()[real], st.ndk.cpu().numpy(),
                            st.nwk.cpu().numpy(), st.nk.cpu().numpy())
            checks.append("counts = recount of z")
        elif name == "smc":
            w = model._weights()
            z = model.z.cpu().numpy()
            if abs(w.sum() - 1.0) > 1e-6 or z.min() < 0 or z.max() >= cfg.topic_num:
                raise AssertionError(f"smc weights sum {w.sum()}, z in "
                                     f"[{z.min()}, {z.max()}]")
            if not (model.nk.sum(dim=1) == corpus.num_tokens).all():
                raise AssertionError("smc particle counts do not cover the corpus")
            sg = model.graph.graph
            checks.append(f"weights sum to 1 ({w.sum():.8f}), z in range; "
                          f"{dt / corpus.num_tokens * 1e6:.1f} us per token captured "
                          f"(less the set-up {(dt - sg.setup_s) / corpus.num_tokens * 1e6:.1f}; "
                          f"set-up {sg.setup_s:.4f}s, {sg.replays} replays); "
                          f"{model.resamples} resamples; launches {smc_launches}")
        elif name == "svi":
            if not (torch.isfinite(model.lam).all() and float(model.lam.min()) > 0):
                raise AssertionError("svi lambda not finite and positive")
            checks.append("lambda finite and positive")
        elif name == "gibbs":
            model.check_counts_consistent()
            checks.append(f"counts consistent; launches {gibbs_launches}")
        tok_s = n * corpus.num_tokens / dt
        out[name] = dict(warm_up=warm, passes=n, tokens=corpus.num_tokens,
                         docs=corpus.num_docs,
                         vocab=v, seconds=dt, tokens_per_s=tok_s, perplexity=ppl,
                         held_out_ppl=held_ppl, held_out_docs=held.num_docs)
        if name == "smc":
            out[name].update(us_per_token=dt / corpus.num_tokens * 1e6,
                             setup_s=model.graph.graph.setup_s,
                             resamples=model.resamples, launches=smc_launches)
        log(f"[backends] {name}: {warm} + {n} timed "
            f"{'passes' if name in ('svi', 'smc') else 'sweeps'}"
            f" of {corpus.num_tokens} tokens (M {corpus.num_docs}, V {v}, K 15) "
            f"in {dt:.3f}s = {tok_s:,.0f} tokens/s; perplexity {ppl:.3f}, "
            f"held-out {held_ppl:.3f} ({held.num_docs} documents); "
            f"{'; '.join(checks)}")
        del model
        torch.cuda.empty_cache()
    return out, {"backends gibbs": gibbs_launches, "backends smc": smc_launches,
                 "backends cvb0": cvb0_launches}


def run_cli_inproc(args) -> tuple[int, str, str]:
    """The port's CLI ``main`` in this process (no start-up per call);
    ``(exit code, stdout, stderr)``."""
    import contextlib
    import io

    from ldagibbssampling_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in args])
    return rc, out.getvalue(), err.getvalue()


def backends_resume_phase() -> None:
    """Phase 10: through the CLI on the card, cvb0 and svi 20 sweeps
    straight against 10 then ``--resume`` to 20 (artifacts byte-identical);
    the reference's refusals exit 2; ``--chains 4`` writes R-hat rows."""
    from ldagibbssampling_tpu_torch.data import write_minicorpus

    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        docs = write_minicorpus(t / "docs")
        common = ["--docs", docs, "-k", "10", "--save-step", "5",
                  "--begin-save-iters", "15", "--seed", "3"]
        want = sorted(f"lda_{i}.{e}" for i in (15, 20)
                      for e in ("params", "phi", "theta", "tassign", "twords"))
        for backend in ("cvb0", "svi"):
            t0 = time.perf_counter()
            b = ["--backend", backend]
            runs = [[*common, *b, "--results", t / f"{backend}_full",
                     "--iterations", "20"],
                    [*common, *b, "--no-save", "--iterations", "10",
                     "--checkpoint-dir", t / f"{backend}_ck",
                     "--checkpoint-every", "5"],
                    [*common, *b, "--results", t / f"{backend}_resumed",
                     "--iterations", "20", "--checkpoint-dir", t / f"{backend}_ck",
                     "--checkpoint-every", "5", "--resume"]]
            for args in runs:
                rc, out, err = run_cli_inproc(args)
                if rc != 0:
                    raise AssertionError(f"CLI {backend} exit {rc}: {err[-2000:]}")
            if "Resumed from sweep 10" not in out:
                raise AssertionError(f"resume {backend}: {out[-2000:]}")
            full = sorted(p.name for p in (t / f"{backend}_full").iterdir())
            resumed = sorted(p.name for p in (t / f"{backend}_resumed").iterdir())
            if not full == resumed == want:
                raise AssertionError(f"resume {backend}: {full} / {resumed}")
            differ = [n for n in want if (t / f"{backend}_full" / n).read_bytes()
                      != (t / f"{backend}_resumed" / n).read_bytes()]
            if differ:
                raise AssertionError(f"resume {backend}: artifacts differ: {differ}")
            log(f"[backends resume] {backend}: 20 sweeps straight, and 10 + "
                f"resume to 20: the ten artifacts byte-identical "
                f"({time.perf_counter() - t0:.1f}s)")
        base = ["--docs", docs, "--no-save", "-k", "10", "--iterations", "5",
                "--checkpoint-dir", t / "refused_ck"]
        for flags, words in (
                (["--backend", "smc", "--checkpoint-every", "5"],
                 "does not support checkpointing"),
                (["--backend", "warp", "--checkpoint-every", "5"],
                 "does not support checkpointing"),
                (["--backend", "cvb0", "--check-counts"],
                 "has no count tables to check")):
            rc, _, err = run_cli_inproc([*base, *flags])
            if rc != 2 or words not in err:
                raise AssertionError(f"CLI {flags}: exit {rc}, {err[-500:]}")
            log(f"[backends resume] {' '.join(flags)}: exit 2, "
                f"\"{err.strip().splitlines()[-1]}\"")
        rc, out, err = run_cli_inproc(
            [*common, "--no-save", "--iterations", "10", "--chains", "4",
             "--metrics-file", t / "chains.jsonl", "--ll-every", "5"])
        rows = [json.loads(x) for x in (t / "chains.jsonl").read_text().splitlines()]
        if rc != 0 or not any("r_hat" in r for r in rows):
            raise AssertionError(f"--chains 4: exit {rc}, rows {rows[-2:]}: "
                                 f"{err[-1000:]}")
        log(f"[backends resume] --chains 4 --metrics-file: {len(rows)} rows, the "
            f"last {json.dumps({k: rows[-1][k] for k in ('sweep', 'r_hat', 'r_hat_phi_p99') if k in rows[-1]})}")


def ladder_phase(tmp_root: str) -> list:
    """Phase 11: the ladder (rungs 1 to 5 at scale 0.01; rung 3 floored at
    2^24 training tokens on the card) as a subprocess; exit 0 and no gate
    failure; returns the rungs' dicts."""
    out = Path(tmp_root) / "ladder.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.benchmarks.ladder", "--rungs", "1,2,3,4,5",
         "--scale", str(LADDER_SCALE), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    if proc.returncode != 0:
        raise AssertionError(f"ladder exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    report = json.loads(out.read_text())
    if report["gate_failures"] or [r["rung"] for r in report["rungs"]] != [1, 2, 3, 4, 5]:
        raise AssertionError(f"ladder: {report['gate_failures']}")
    for r in report["rungs"]:
        log(f"[ladder] {json.dumps(r)}")
    log(f"[ladder] rungs 1-5 at scale {LADDER_SCALE}: no gate failure "
        f"({time.perf_counter() - t0:.1f}s with start-up)")
    return report["rungs"]


def _sync(device: str = "cuda") -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _event_timer(module, name: str):
    """Wrap ``module.name`` with CUDA events (the host clock on the CPU);
    returns the list of each call's milliseconds and a function that
    restores the plain function."""
    import torch

    plain, times = getattr(module, name), []

    def timed(*args):
        if not torch.cuda.is_available():  # a rehearsal on the CPU
            t0 = time.perf_counter()
            out = plain(*args)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = plain(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        return out

    setattr(module, name, timed)

    def restore():
        setattr(module, name, plain)
    return times, restore


def _psum_timer():
    """``multihost.psum`` timed (the eager sweep's reconciliation)."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    return _event_timer(multihost, "psum")


def _reduce_timer():
    """``multihost.reduce_across`` timed: the ``all_reduce`` that a mesh
    graph runs between its replays where a group spans processes."""
    from ldagibbssampling_tpu_torch.parallel import multihost

    return _event_timer(multihost, "reduce_across")


@contextlib.contextmanager
def plan_timer():
    """Time every deferred layout that the model and the mesh runtimes plan
    (``plan_deferred`` under each of ``PLAN_USERS``' names, wrapped while
    the block runs); yields the list of each call's seconds."""
    import importlib

    mods = [importlib.import_module(f"{PKG}.{m}") for m in PLAN_USERS]
    plain, times = [m.plan_deferred for m in mods], []

    def timed(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                times.append(time.perf_counter() - t0)
        return call

    for m, fn in zip(mods, plain):
        m.plan_deferred = timed(fn)
    try:
        yield times
    finally:
        for m, fn in zip(mods, plain):
            m.plan_deferred = fn


def _mesh_launches(label: str, expect: dict, counted: dict) -> dict:
    """The run's kernel launches: each of ``expect`` exactly, no other
    kernel, no plain version."""
    launches, plain = kernel_counts(counted)
    got = {n: c for n, c in launches.items() if c}
    if got != expect or any(plain.values()):
        raise AssertionError(f"[mesh {label}] launches {got}, want {expect}; "
                             f"plain {plain}")
    return got


def mesh_noise(model, seed: int, device: str = "cuda"):
    """``noise(position, sweep)``: external noise made on the position's
    device from the seed, shaped for the runtime's tier (Gumbel values for
    the XLA tier, the kernels' uniforms)."""
    import torch

    k = model.config.topic_num

    def noise(p, sweep):
        g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1_000 * p + sweep)
        t = model._tokens[p][0].shape[0]
        if model.kernel_tier == "xla":
            u = torch.rand((t, k), generator=g, device=device).mul_(1 - 2e-7).add_(1e-7)
            return -torch.log(-torch.log(u))
        return torch.rand((t, -(-k // 128) * 128), generator=g,
                          device=device).mul_(1 - 2e-7).add_(1e-7)
    return noise


def mesh_graph_compare(label: str, model, smi: str, *, noise=None, timed: int = 0,
                       profile: bool = True, recount: bool = True,
                       device: str = "cuda") -> dict:
    """``[graphs mesh <label>]``: the runtime's graph (``MeshRuntime.sweep``,
    one replay a sweep) against its eager sweep (``_eager_sweeps``) from
    the runtime's present state, seeds and noise: 2 sweeps at
    ``GRAPH_HYPERS[0]`` and one at ``GRAPH_HYPERS[1]`` each way, z and every
    table bitwise, and (``recount``) the counts a recount of z.  Then, where
    asked, ``timed`` captured sweeps in one call, host calls and graph
    launches a sweep (``profile``: a profiled call of 1 and one of 5; an
    eager sweep's), one eager sweep's ``psum`` time (CUDA events), nodes,
    set-up, peak memory.  The eager comparison's state is
    thrown away: the runtime goes on from the captured one."""
    import torch

    from ldagibbssampling_tpu_torch.parallel.runtime import TABLES

    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # the real tokens a sweep resamples (every chain's)
    tokens = sum(int(model._tokens[p][2].sum()) for p in model.positions)
    start = {n: dict(getattr(model, n)) for n in TABLES}
    gen, idx, hyper = model.generator.get_state(), model.sweep_idx, (model.alpha, model.beta)

    def three(run):
        out = 0.0
        for (a, b), n in zip(GRAPH_HYPERS, (2, 1)):
            model.alpha, model.beta = a, b
            _sync(device)
            t0 = time.perf_counter()
            run(n, noise=noise)
            _sync(device)
            out += time.perf_counter() - t0
        return out
    eager_s = three(model._eager_sweeps)
    want = {n: dict(getattr(model, n)) for n in TABLES}
    for n in TABLES:
        setattr(model, n, dict(start[n]))
    model.generator.set_state(gen)
    model.sweep_idx = idx
    first_call = model.graph is None or model.graph.graph is None
    captured_s = three(model.sweep)
    for n in TABLES:
        for p in model.positions:
            if not torch.equal(getattr(model, n)[p], want[n][p]):
                raise AssertionError(f"[graphs mesh {label}] captured {n} differs "
                                     f"from eager at position {p}")
    if recount:
        model.check_counts_consistent()
    model.alpha, model.beta = hyper
    graph = model.graph
    out = dict(tokens=tokens, positions=len(model.positions), tier=model.kernel_tier,
               noise=model.noise_mode, eager_ms_per_sweep=eager_s / 3 * 1e3,
               eager_tokens_per_s=3 * tokens / eager_s,
               captured_ms_per_sweep_comparison=captured_s / 3 * 1e3,
               nodes=graph.nodes, graph_launches=graph.launches,
               setup_s=graph.setup_s, capture_s=graph.capture_s,
               per_replay=graph.per_replay)
    if graph.launches != 1:
        raise AssertionError(f"[graphs mesh {label}] {graph.launches} graph launches "
                             "a sweep in one process")
    if timed:
        dt = _timed(lambda: model.sweep(timed, noise=noise)) if on_card else None
        out.update(captured_ms_per_sweep=dt / timed * 1e3 if dt else None,
                   captured_tokens_per_s=timed * tokens / dt if dt else None)
    if profile and on_card:
        one = launch_profile(lambda: model.sweep(1, noise=noise))
        five = launch_profile(lambda: model.sweep(5, noise=noise))
        out["captured_per_sweep"] = _per_sweep(one, five)
        out["eager_per_sweep"] = launch_profile(lambda: model._eager_sweeps(1, noise))
        if out["captured_per_sweep"]["graph_launches"] != 1:
            raise AssertionError(f"[graphs mesh {label}] "
                                 f"{out['captured_per_sweep']} per sweep")
    times, restore = _psum_timer()
    try:
        model._eager_sweeps(1, noise)
    finally:
        restore()
    out["eager_psum_ms_per_sweep"] = sum(times)
    out["eager_psum_calls_per_sweep"] = len(times)
    if on_card:
        out.update(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    out["phase_s"] = time.perf_counter() - t_phase
    hc = out.get("captured_per_sweep", {})
    he = out.get("eager_per_sweep", {})
    log(f"[graphs mesh {label}] {out['positions']} positions, {model.kernel_tier}, "
        f"{model.noise_mode} noise, {tokens:,} tokens a sweep: captured against eager "
        f"bitwise (z, ndk, nwk, nk at every position) across an alpha/beta change "
        f"{GRAPH_HYPERS[0]} -> {GRAPH_HYPERS[1]}"
        f"{'; counts exact' if recount else ''}; eager "
        f"{out['eager_ms_per_sweep']:.2f} ms a sweep ({out['eager_tokens_per_s']:,.0f} "
        f"tokens/s), captured {out['captured_ms_per_sweep_comparison']:.2f} ms in the "
        f"comparison{' (its first call captures)' if first_call and on_card else ''}"
        + (f", {out['captured_ms_per_sweep']:.2f} ms ({out['captured_tokens_per_s']:,.0f} "
           f"tokens/s) over {timed} sweeps in one call" if out.get("captured_ms_per_sweep")
           else "")
        + (f"; host calls a sweep eager {he['host_calls']:,} -> captured "
           f"{hc['host_calls']:g} ({hc['graph_launches']:g} graph launch)" if hc else "")
        + f"; graph nodes {graph.nodes:,}, per replay {out['per_replay']}; "
        f"set-up {graph.setup_s if graph.setup_s is not None else float('nan'):.4f}s "
        f"(capture and instantiation "
        f"{graph.capture_s if graph.capture_s is not None else float('nan'):.4f}s"
        f"{'' if first_call else ', before this phase'}); eager psum "
        f"{out['eager_psum_ms_per_sweep']:.3f} ms a sweep ({len(times)} calls, CUDA "
        f"events; captured: inside the graph, not timed apart)"
        + (f"; peak device memory {out['peak_allocated_gb']:.3f} GB allocated, "
           f"{out['peak_reserved_gb']:.3f} GB reserved" if on_card else "")
        + f" ({out['phase_s']:.1f}s); {smi}")
    return out


def mesh_phase(seed: int, smi: str = "", device: str = "cuda") -> tuple[dict, dict]:
    """Phase 12: the parallel runtimes (``parallel/``) on the card, each a
    graph replayed per sweep (``MeshRuntime.sweep``).

    Rung 3 through ``ladder.rung3`` at scale 0.2 on every position (one
    here); the same corpus as four shards on one card; the 2x2 grid,
    four-way token sharding and the 2x2 chains x data mesh at rung 3's 0.02;
    every run in the deferred tier with exact counts and its launches
    counted (the graph's warm-up sweep once per runtime); a four-shard
    checkpoint restored bitwise; each runtime's graph against its eager
    sweep (``[graphs mesh ...]``: the four shards at 0.2, AD-LDA on four
    positions at 0.02 in the deferred, fused and XLA tiers and the other
    three runtimes, in internal and external noise); the CLI with
    ``--mesh data=-1`` killed and resumed byte-identical.  Returns the
    results (``graphs`` the comparisons) and each path's launches by
    kernel."""
    import dataclasses

    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.benchmarks import ladder
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.evaluation.tracing import block_on_backend
    from ldagibbssampling_tpu_torch.ops.fused_kernel import sample_name
    from ldagibbssampling_tpu_torch.parallel import multihost
    from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
    from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet
    from ldagibbssampling_tpu_torch.parallel.grid import GridLda
    from ldagibbssampling_tpu_torch.parallel.tokenshard import TokenShardedLda

    walk = sample_name(torch.bfloat16, "float32")
    out, by_path, graphs = {}, {}, {}
    pos0 = multihost.local_devices(device)[0]
    n_dev = len(multihost.local_devices(device))
    t0 = time.perf_counter()
    built = ladder.rung3_corpus(MESH_SCALE, floor=pos0.type == "cuda")
    corpus_s = time.perf_counter() - t0
    counted = tracing.counters()
    t0 = time.perf_counter()
    with plan_timer() as plans:
        r3 = ladder.rung3(MESH_SCALE, sweeps=MESH_SWEEPS, device=device, corpus=built)
    r3["plan_s"], r3["corpus_s"] = sum(plans), corpus_s
    wall = time.perf_counter() - t0
    runs = MESH_SWEEPS + 2 + 1  # the ladder's two warm-up calls, the graph's warm-up
    by_path["mesh rung3"] = _launches_match("rung3", {
        walk: runs * r3["shards"], "rebuild_counts": runs * r3["shards"],
        "cast_mirror": runs}, device, counted)
    if r3["kernel_tier"] != "deferred" or (pos0.type == "cuda"
                                           and r3["tokens"] < (1 << 24)):
        raise AssertionError(f"[mesh rung3] {r3}")
    out["rung3"] = r3
    log(f"[mesh rung3] scale {MESH_SCALE}: {r3['corpus']}, K 100, "
        f"{r3['tokens']} training tokens (>= 2^24), {r3['shards']} shard(s) on "
        f"{n_dev} device(s), tier {r3['kernel_tier']}, one graph replay a sweep: "
        f"{r3['tokens_per_s']:,.0f} tokens/s over {MESH_SWEEPS} sweeps; set-up: corpus "
        f"{r3['corpus_s']:.1f}s, sharding + layout + state {r3['setup_s']:.2f}s (plan_s "
        f"{r3['plan_s']:.3f}, {len(plans)} plan(s)), two warm-up calls (the first "
        f"captures) {r3['warmup_s']:.2f}s; check_counts_consistent passed; held-out "
        f"perplexity {r3['held_out_ppl']:.1f}; launches {by_path['mesh rung3']} "
        f"({wall:.1f}s)")

    # the same corpus as four shards on one card, in turn
    corpus = built[0]
    cfg = LdaConfig(topic_num=100, seed=seed, block_size=65_536)
    mesh4 = multihost.make_mesh({"data": 4}, [pos0] * 4)
    t0 = time.perf_counter()
    with plan_timer() as plans:
        four = ShardedLda(cfg, corpus, mesh=mesh4, device=device)
    block_on_backend(four)
    setup_s, plan_s = time.perf_counter() - t0, sum(plans)
    four.sweep(1)  # captures
    block_on_backend(four)
    if pos0.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")  # a sweep makes no host sync
    try:
        four.sweep(1)
    finally:
        if pos0.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    block_on_backend(four)
    counted = tracing.counters()
    t0 = time.perf_counter()
    four.sweep(MESH_FOUR_SWEEPS)
    block_on_backend(four)
    dt = time.perf_counter() - t0
    by_path["mesh four shards"] = _launches_match("four shards", {
        walk: 4 * MESH_FOUR_SWEEPS, "rebuild_counts": 4 * MESH_FOUR_SWEEPS,
        "cast_mirror": MESH_FOUR_SWEEPS}, device, counted)
    four.check_counts_consistent()
    tok_s = MESH_FOUR_SWEEPS * corpus.num_tokens / dt
    out["four_shards"] = dict(tokens=corpus.num_tokens, tokens_per_s=tok_s,
                              ms_per_sweep=dt / MESH_FOUR_SWEEPS * 1e3,
                              setup_s=setup_s, plan_s=plan_s,
                              kernel_tier=four.kernel_tier)
    log(f"[mesh four shards] the rung-3 corpus as 4 shards on {pos0} "
        f"({four.kernel_tier}): {tok_s:,.0f} tokens/s ({dt / MESH_FOUR_SWEEPS * 1e3:.2f}"
        f" ms per sweep, one graph replay each); set-up "
        f"{setup_s:.2f}s (plan_s {plan_s:.3f}, {len(plans)} plans); counts exact; "
        f"no host sync in a sweep; launches {by_path['mesh four shards']}")
    # the host calls a sweep are those of the runtime at 0.02 (below)
    graphs["four shards"] = mesh_graph_compare(
        "four shards", four, smi, timed=MESH_FOUR_SWEEPS, profile=False,
        device=device)
    out["four_shards"]["psum_ms_per_sweep"] = graphs["four shards"]["eager_psum_ms_per_sweep"]

    # the four shards saved, run 3 sweeps on; restored, run the same 3
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        step = four.save_checkpoint(tmp)
        four.sweep(3)
        b = ShardedLda(cfg, corpus, mesh=mesh4, device=device)
        if b.restore_checkpoint(tmp) != step:
            raise AssertionError("[mesh checkpoint] restored another step")
        b.sweep(3)
        xa, xb = four.arrays(), b.arrays()
        differ = [n for n in ("z", "ndk", "nwk", "nk")
                  if not np.array_equal(xa[n], xb[n])]
        if differ:
            raise AssertionError(f"[mesh checkpoint] restored run differs: {differ}")
        log(f"[mesh checkpoint] four shards saved at sweep {step} and run to "
            f"{step + 3}, restored and run to {step + 3}: z and every table "
            f"bitwise equal ({time.perf_counter() - t0:.1f}s)")
    del four, b, corpus, built
    if pos0.type == "cuda":
        torch.cuda.empty_cache()

    small, _, _, _ = ladder.rung3_corpus(MESH_SMALL_SCALE)

    def on(axes):
        return multihost.make_mesh(axes, [pos0] * 4)
    for label, build, per_sweep in (
            ("adlda deferred", lambda mode: ShardedLda(
                cfg, small, mesh=on({"data": 4}), device=device, noise_mode=mode), 1),
            ("adlda fused", lambda mode: ShardedLda(
                dataclasses.replace(cfg, use_pallas="fused"), small,
                mesh=on({"data": 4}), device=device, noise_mode=mode), None),
            ("adlda xla", lambda mode: ShardedLda(
                dataclasses.replace(cfg, use_pallas=False), small,
                mesh=on({"data": 4}), device=device, noise_mode=mode), None),
            ("grid 2x2", lambda mode: GridLda(
                cfg, small, mesh=on({"data": 2, "vocab": 2}), device=device,
                noise_mode=mode), 2),
            ("token=4", lambda mode: TokenShardedLda(
                cfg, small, mesh=on({"data": 4}), device=device, noise_mode=mode), 1),
            ("chain=2,data=2", lambda mode: ShardedChainSet(
                cfg, small, num_chains=2, mesh=on({"chain": 2, "data": 2}),
                device=device, noise_mode=mode), 2)):
        model = build("internal")
        tier = label.split()[1] if label.startswith("adlda") else "deferred"
        if model.kernel_tier != tier:
            raise AssertionError(f"[mesh {label}] tier {model.kernel_tier}")
        counted = tracing.counters()
        model.sweep(1)  # captures
        block_on_backend(model)
        t0 = time.perf_counter()
        model.sweep(MESH_SMALL_SWEEPS)
        block_on_backend(model)
        dt = time.perf_counter() - t0
        runs = MESH_SMALL_SWEEPS + 2  # the capturing call and its warm-up sweep
        want = ({walk: 4 * runs, "rebuild_counts": 4 * runs,
                 "cast_mirror": per_sweep * runs} if per_sweep else
                {n.removeprefix("launch."): c * runs
                 for n, c in model.graph.per_replay.items() if n.startswith("launch.")})
        by_path[f"mesh {label}"] = _launches_match(label, want, device, counted)
        model.check_counts_consistent()
        chains = getattr(model, "num_chains", 1)
        tok_s = MESH_SMALL_SWEEPS * chains * small.num_tokens / dt
        out[label] = dict(tokens=small.num_tokens, tokens_per_s=tok_s,
                          kernel_tier=model.kernel_tier)
        if not label.startswith("adlda"):  # one Minka update and one LL
            t1 = time.perf_counter()
            alpha, beta = model.optimize_hyperparameters()
            minka_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            if label.startswith("chain"):  # every chain's LL, recorded
                model.record(ll=True)
                ll = float(model.ll_trace[-1][0] * small.num_tokens)
            else:
                ll = model.device_log_likelihood()
            ll_s = time.perf_counter() - t1
            if label.startswith("chain"):  # once against the host formula
                from ldagibbssampling_tpu_torch.evaluation.metrics import log_likelihood

                a = model.arrays()
                host = log_likelihood(model.chain_phi(0, a), model.chain_theta(0, a),
                                      small)
                if _rel(ll, host) > 1e-9 or _rel(model.device_log_likelihood(),
                                                 host) > 1e-9:
                    raise AssertionError(f"[mesh {label}] device LL {ll} vs host {host}")
            if not (np.isfinite(ll) and np.isfinite(alpha) and np.isfinite(beta)):
                raise AssertionError(f"[mesh {label}] LL {ll}, alpha {alpha}, beta {beta}")
            out[label].update(ll=ll, ll_s=ll_s, alpha=alpha, beta=beta, minka_s=minka_s)
            log(f"[mesh {label}] scale {MESH_SMALL_SCALE} ({small.num_tokens} tokens, "
                f"V {small.vocab_size}, K 100) on 4 positions of {pos0}, deferred, one "
                f"graph replay a sweep: {tok_s:,.0f} tokens/s over {MESH_SMALL_SWEEPS} "
                f"sweeps (chain-sweeps for the chains) after the call that captures; counts "
                f"exact{' per chain' if label.startswith('chain') else ''}; Minka alpha "
                f"{alpha:.4f} beta {beta:.5f} ({minka_s * 1e3:.1f} ms); LL {ll:.1f} "
                f"({ll_s * 1e3:.1f} ms, device"
                f"{', both chains recorded, within 1e-9 of the host' if label.startswith('chain') else ''}); "
                f"launches {by_path[f'mesh {label}']}")
        graphs[label] = mesh_graph_compare(label, model, smi, timed=MESH_GRAPH_TIMED,
                                           device=device)
        del model
        model = build("external")
        graphs[f"{label} external"] = mesh_graph_compare(
            f"{label} external", model, smi, noise=mesh_noise(model, seed, device),
            profile=False, device=device)
        del model
        if pos0.type == "cuda":
            torch.cuda.empty_cache()
    out["graphs"] = graphs
    mesh_resume_phase(["--device", device])
    return out, by_path


def mesh_resume_phase(device_flags=()) -> None:
    """The CLI with ``--mesh data=-1`` (every position: one shard per card)
    killed at sweep 30 and resumed to 60 writes the uninterrupted run's
    artifacts byte for byte."""
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--docs", "docs", "-k", "10", "--save-step", "10",
                  "--begin-save-iters", "50", "--seed", "3", "--mesh", "data=-1",
                  "--block-size", "256", "--check-counts", *device_flags]
        run_cli(["--generate-minicorpus", *common, "--no-save", "--iterations",
                 "1"], tmp)
        t0 = time.perf_counter()
        run_processes([  # the straight run and the run to sweep 30 at once
            (cli_command([*common, "--results", "full", "--iterations", "60",
                          "--metrics-file", "m.jsonl", "--metrics-every", "0"]), tmp),
            (cli_command([*common, "--no-save", "--iterations", "30",
                          "--checkpoint-dir", "ck", "--checkpoint-every", "10"]), tmp)])
        header = json.loads(Path(tmp, "m.jsonl").read_text().splitlines()[0])
        if header["kernel_tier"] != "deferred":
            raise AssertionError(f"[mesh resume] ran {header['kernel_tier']}")
        out = run_cli([*common, "--results", "resumed", "--iterations", "60",
                       "--checkpoint-dir", "ck", "--checkpoint-every", "10",
                       "--resume"], tmp)
        if "Resumed from sweep 30" not in out:
            raise AssertionError(f"[mesh resume] {out[-2000:]}")
        want = sorted(f"lda_{i}.{e}" for i in (50, 60)
                      for e in ("params", "phi", "theta", "tassign", "twords"))
        full = sorted(p.name for p in Path(tmp, "full").iterdir())
        resumed = sorted(p.name for p in Path(tmp, "resumed").iterdir())
        if not full == resumed == want:
            raise AssertionError(f"[mesh resume] {full} / {resumed}")
        differ = [n for n in want if Path(tmp, "full", n).read_bytes()
                  != Path(tmp, "resumed", n).read_bytes()]
        if differ:
            raise AssertionError(f"[mesh resume] artifacts differ: {differ}")
        log(f"[mesh resume] CLI --mesh data=-1 (deferred, block 256, "
            f"--check-counts): 60 sweeps straight, and 30 + resume from sweep 30 "
            f"to 60: the ten artifacts byte-identical "
            f"({time.perf_counter() - t0:.1f}s)")


def mesh2_runs(seed: int, device: str, scale: float, small_scale: float) -> list:
    """The runs of ``[mesh two processes]``, each ``(label, axes, build,
    tokens)`` with ``build(mesh)`` its runtime: ``ShardedLda`` over
    ``{"data": 2}`` on rung 3's corpus at ``scale`` (as ``[mesh]`` builds
    it) and ``GridLda`` over ``{"data": 1, "vocab": 2}`` at
    ``small_scale``, K = 100, block 65,536, the deferred tier."""
    from ldagibbssampling_tpu_torch.benchmarks import ladder
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
    from ldagibbssampling_tpu_torch.parallel.grid import GridLda

    cfg = LdaConfig(topic_num=100, seed=seed, block_size=65_536)
    big, _, _, _ = ladder.rung3_corpus(scale, floor=device == "cuda")
    small, _, _, _ = ladder.rung3_corpus(small_scale)
    return [
        ("ShardedLda data=2", {"data": 2},
         lambda mesh: ShardedLda(cfg, big, mesh=mesh, device=device), big.num_tokens),
        ("GridLda data=1,vocab=2", {"data": 1, "vocab": 2},
         lambda mesh: GridLda(cfg, small, mesh=mesh, device=device), small.num_tokens),
    ]


def state_digests(arrays: dict) -> dict:
    """sha256 of each table (its dtype, shape and bytes)."""
    import hashlib

    return {n: hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()
            for n, a in sorted(arrays.items())}


def _launches_match(label: str, want: dict, device: str, counted: dict) -> dict:
    """The run's launches (on the CPU, a rehearsal: its plain calls, the
    plain walk tile by tile)."""
    if device == "cuda":
        return _mesh_launches(label, want, counted)
    launches, plain = kernel_counts(counted)
    got = {n: plain[n] for n in want}
    if not all(got.values()) or any(launches.values()):
        raise AssertionError(f"[mesh {label}] plain {plain}, launches {launches}")
    return got


def mesh2_worker(pid: str, addr: str, device: str, seed: str, scale: str,
                 small_scale: str, sweeps: str, want_path: str) -> int:
    """One of the two processes of ``[mesh two processes]``: brings up gloo
    itself (NCCL refuses two ranks on one card), then the port's topology
    through ``initialize_distributed``, which finds the group up and leaves
    it to this function; trains each run of :func:`mesh2_runs` for
    ``sweeps`` sweeps on its one position (one call that captures, then
    ``sweeps - 1`` timed with the ``all_reduce`` between the graphs timed),
    with its launches counted, its counts checked and its gathered state
    held bitwise against the one-process run's digests; prints one
    ``[mesh2 worker]`` JSON line."""
    import torch
    import torch.distributed as dist

    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.evaluation.tracing import block_on_backend
    from ldagibbssampling_tpu_torch.ops.fused_kernel import sample_name
    from ldagibbssampling_tpu_torch.parallel import multihost

    rank, n_sweeps = int(pid), int(sweeps)
    if device == "cpu":  # a rehearsal: two processes' thread pools on one host
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=addr, world_size=2, rank=rank)
    try:
        topo = multihost.initialize_distributed(addr, 2, rank, device=device)
        if (topo.process_index, topo.process_count, topo.local_device_count,
                topo.global_device_count) != (rank, 2, 1, 2):
            raise AssertionError(f"[mesh2 worker {rank}] topology {topo}")
        want = json.loads(Path(want_path).read_text())
        walk = sample_name(torch.bfloat16, "float32")
        out = {"pid": rank, "bringup_s": time.perf_counter() - t0, "runs": {}}
        for label, axes, build, tokens in mesh2_runs(int(seed), device, float(scale),
                                                     float(small_scale)):
            mesh = multihost.make_mesh(axes, device=device)
            if mesh.ranks != (0, 1) or len(set(mesh.devices)) != 1:
                raise AssertionError(f"[mesh2 worker {rank}] {label}: mesh {mesh}")
            t1 = time.perf_counter()
            with plan_timer() as plans:
                model = build(mesh)
            block_on_backend(model)
            setup_s = time.perf_counter() - t1
            if model.kernel_tier != "deferred" or model.positions != [rank]:
                raise AssertionError(f"[mesh2 worker {rank}] {label}: tier "
                                     f"{model.kernel_tier}, positions {model.positions}")
            counted = tracing.counters()
            model.sweep(1)  # captures the graphs (the warm-up sweep, one replay)
            block_on_backend(model)
            times, restore = _reduce_timer()
            try:
                t1 = time.perf_counter()
                model.sweep(n_sweeps - 1)
                block_on_backend(model)
                dt = time.perf_counter() - t1
            finally:
                restore()
            # this process's one shard: per sweep one walk, one rebuild and
            # the snapshot of its table; once more in the graph's warm-up
            launches = _launches_match(f"two processes {label}", {
                walk: n_sweeps + 1, "rebuild_counts": n_sweeps + 1,
                "cast_mirror": n_sweeps + 1}, device, counted)
            model.check_counts_consistent()
            got = state_digests(model.arrays())
            differ = [n for n in got if got[n] != want[label][n]]
            if differ:
                raise AssertionError(f"[mesh2 worker {rank}] {label}: {differ} differ "
                                     "from the one-process run")
            out["runs"][label] = dict(
                tokens=tokens, sweep_s=dt, setup_s=setup_s, plan_s=sum(plans),
                all_reduce_ms_per_sweep=sum(times) / (n_sweeps - 1),
                all_reduce_calls_per_sweep=len(times) / (n_sweeps - 1),
                graph_launches_per_sweep=model.graph.launches,
                graph_setup_s=model.graph.setup_s, launches=launches)
            del model
        print("[mesh2 worker] " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_two_process_phase(seed: int, smi: str, device: str = "cuda",
                           scale: float = MESH_SCALE,
                           small_scale: float = MESH_SMALL_SCALE,
                           sweeps: int = MESH2_SWEEPS) -> tuple[dict, dict]:
    """Phase 12b: the multi-process branch of ``parallel/`` (``psum``'s
    ``all_reduce`` across processes, ``gather``, ``global_devices``) on the
    card: two fresh processes over gloo, one position each on the one card,
    train :func:`mesh2_runs`; each must match the one-process run of the
    same mesh (two positions on the card, run here first) bitwise and exit
    0.  Returns the results and each run's launches, summed over the two
    processes."""
    import torch

    from ldagibbssampling_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    pos0 = multihost.local_devices(device)[0]
    want, ref_s = {}, {}
    for label, axes, build, _ in mesh2_runs(seed, device, scale, small_scale):
        t0 = time.perf_counter()
        model = build(multihost.make_mesh(axes, [pos0] * 2))
        model.sweep(sweeps)
        want[label] = state_digests(model.arrays())
        ref_s[label] = time.perf_counter() - t0
        del model
    if device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        want_path = Path(tmp, "want.json")
        want_path.write_text(json.dumps(want))
        addr = Path(tmp, "rendezvous").as_uri()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MESH2_WORKER, str(pid), addr, device, str(seed),
             str(scale), str(small_scale), str(sweeps), str(want_path)],
            cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in (0, 1)]
        outs, timed_out = [], False
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(
                    1.0, MESH2_TIMEOUT_S - (time.perf_counter() - t0)))[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                for q in procs:
                    q.kill()
                outs = [q.communicate()[0] for q in procs]
                break
        wall = time.perf_counter() - t0
    text = "\n".join(f"--- process {pid}, exit {p.returncode}:\n{o[-3000:]}"
                     for pid, (p, o) in enumerate(zip(procs, outs)))
    if timed_out or any(p.returncode != 0 for p in procs) or any(
            "terminate called" in o for o in outs):
        raise AssertionError(f"[mesh two processes] "
                             f"{'timed out' if timed_out else 'a worker failed'}:\n{text}")
    reports = [json.loads(next(ln for ln in o.splitlines()
                               if ln.startswith("[mesh2 worker] ")).split(" ", 2)[2])
               for o in outs]
    out, by_path = {}, {}
    for label, run in reports[0]["runs"].items():
        runs = [r["runs"][label] for r in reports]
        sweep_s = max(r["sweep_s"] for r in runs)
        launches = {n: sum(r["launches"][n] for r in runs) for n in runs[0]["launches"]}
        by_path[f"mesh two processes {label}"] = launches
        timed = sweeps - 1
        out[label] = dict(
            tokens=run["tokens"], tokens_per_s=timed * run["tokens"] / sweep_s,
            ms_per_sweep=sweep_s / timed * 1e3,
            all_reduce_ms_per_sweep=[r["all_reduce_ms_per_sweep"] for r in runs],
            all_reduce_calls_per_sweep=run["all_reduce_calls_per_sweep"],
            graph_launches_per_sweep=run["graph_launches_per_sweep"],
            graph_setup_s=[r["graph_setup_s"] for r in runs],
            setup_s=[r["setup_s"] for r in runs],
            plan_s=[r["plan_s"] for r in runs], one_process_s=ref_s[label],
            launches=launches)
        log(f"[mesh two processes] {label}: {run['tokens']} tokens, 2 processes "
            f"(gloo) x 1 position on {pos0}, deferred, {sweeps} sweeps (the first "
            f"captures; {timed} timed): {out[label]['tokens_per_s']:,.0f} tokens/s "
            f"({sweep_s / timed * 1e3:.2f} ms per sweep, the slower process); "
            f"{run['graph_launches_per_sweep']} graph launches a sweep with "
            f"{run['all_reduce_calls_per_sweep']:g} all_reduce(s) between them: "
            f"{', '.join(f'{x:.3f}' for x in out[label]['all_reduce_ms_per_sweep'])} "
            f"ms per sweep (CUDA events, processes 0 and 1); graph set-up "
            f"{', '.join(f'{x or 0:.3f}' for x in out[label]['graph_setup_s'])} s; set-up "
            f"{', '.join(f'{x:.2f}' for x in out[label]['setup_s'])} s (plan_s "
            f"{', '.join(f'{x:.3f}' for x in out[label]['plan_s'])} s); counts exact; z "
            f"and every table bitwise the one-process run's (2 positions on {pos0}, "
            f"{ref_s[label]:.1f} s); launches {launches}; nvidia-smi: {smi}")
    out["bringup_s"] = [r["bringup_s"] for r in reports]
    out["workers_wall_s"] = wall
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh two processes] both processes exit 0 (no abort); their wall "
        f"{wall:.1f} s (bring-up {', '.join(f'{x:.1f}' for x in out['bringup_s'])} s); "
        f"the phase {out['phase_s']:.1f} s with the one-process runs")
    return out, by_path


def host_peak_rss_gb() -> float:
    """This process's peak resident memory so far (``getrusage``), GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def rung3_full_phase(seed: int, smi: str, device: str = "cuda",
                     scale: float = FULL_SCALE, warmup: int = FULL_WARMUP,
                     sweeps: int = FULL_SWEEPS) -> tuple[dict, dict]:
    """Phase 12c: the main path at rung 3's full size (the reference
    ladder's NYT-shaped corpus at ``scale``, generated once): ``make_backend``
    -> ``LdaModel`` -> ``run_inference``, K = 100, block 65,536, the
    deferred tier (f32 chain, bf16 snapshot), ``warmup`` untimed and
    ``sweeps`` timed sweeps, its launches counted exactly, the counts a
    recount of z, held-out perplexity; one checkpoint saved and restored
    bitwise (the state, and the next sweep from it); then
    ``ladder.rung3(scale)`` on the same corpus.  Returns the results and
    each run's launches by kernel."""
    import dataclasses

    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch import make_backend, run_inference
    from ldagibbssampling_tpu_torch.benchmarks import ladder
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.evaluation import tracing
    from ldagibbssampling_tpu_torch.evaluation.device_metrics import (
        heldout_perplexity_device)
    from ldagibbssampling_tpu_torch.evaluation.tracing import block_on_backend
    from ldagibbssampling_tpu_torch.interop import to_numpy
    from ldagibbssampling_tpu_torch.ops.fused_kernel import sample_name

    on_card = device == "cuda"
    t0 = time.perf_counter()
    built = ladder.rung3_corpus(scale, floor=on_card)
    corpus, heldout, m, v = built
    out = {"scale": scale, "documents": m, "vocab": v, "tokens": corpus.num_tokens,
           "heldout_docs": heldout.num_docs, "corpus_s": time.perf_counter() - t0}
    log(f"[rung3 full] scale {scale}: {m} documents, V {v}, {corpus.num_tokens} "
        f"training tokens, {heldout.num_docs} held out (generated in "
        f"{out['corpus_s']:.1f}s)")

    # 1. the main path, its launches counted from make_backend on
    cfg = LdaConfig(topic_num=100, seed=seed, block_size=65_536, iteration=warmup)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    counted = tracing.counters()
    t0 = time.perf_counter()
    with plan_timer() as plans:
        model = make_backend(cfg, corpus, device=device)
    block_on_backend(model)
    out.update(setup_s=time.perf_counter() - t0, plan_s=sum(plans),
               kernel_tier=model.kernel_tier, slots=int(model.state.z.shape[0]))
    if model.kernel_tier != "deferred" or len(plans) != 1:
        raise AssertionError(f"[rung3 full] tier {model.kernel_tier}, {len(plans)} plans")
    run_inference(model, cfg, corpus)
    block_on_backend(model)
    t0 = time.perf_counter()
    run_inference(model, dataclasses.replace(cfg, iteration=warmup + sweeps), corpus)
    block_on_backend(model)
    dt = time.perf_counter() - t0
    runs = warmup + sweeps
    if model.sweeps_done != runs:
        raise AssertionError(f"[rung3 full] ran {model.sweeps_done} sweeps, not {runs}")
    # the first snapshot, then per sweep one walk (K = 100, the tagged
    # walk), one rebuild and one snapshot, and once more in the graph's
    # warm-up sweep
    launches = _launches_match("rung3 full", {
        sample_name(torch.bfloat16, "float32"): runs + 1,
        "rebuild_counts": runs + 1, "cast_mirror": runs + 2}, device, counted)
    out.update(sweep_s=dt, tokens_per_s=sweeps * corpus.num_tokens / dt,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card
               else None, launches=launches)
    t0 = time.perf_counter()
    model.check_counts_consistent()
    out["check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["heldout_ppl"] = float(heldout_perplexity_device(
        model.phi(), heldout, cfg.alpha, device=device))
    out["heldout_s"] = time.perf_counter() - t0
    if not np.isfinite(out["heldout_ppl"]):
        raise AssertionError(f"[rung3 full] held-out perplexity {out['heldout_ppl']}")
    out["host_peak_rss_gb"] = host_peak_rss_gb()
    log(f"[rung3 full] make_backend -> LdaModel -> run_inference, K 100, block "
        f"65,536, tier {model.kernel_tier} ({out['slots']} slots): corpus_s "
        f"{out['corpus_s']:.2f}, plan_s {out['plan_s']:.3f}, setup_s (plan + state "
        f"init + transfer) {out['setup_s']:.2f}; {sweeps} sweeps {dt:.3f}s = "
        f"{out['tokens_per_s']:,.0f} tokens/s after {warmup} untimed; "
        f"check_counts_consistent passed ({out['check_s']:.2f}s); held-out "
        f"perplexity {out['heldout_ppl']:.1f} on {heldout.num_docs} documents "
        f"({out['heldout_s']:.2f}s); peak device memory "
        f"{out['peak_device_gb'] or 0:.3f} GB (max_memory_allocated), host peak RSS "
        f"{out['host_peak_rss_gb']:.2f} GB; launches {launches}; nvidia-smi: {smi}")

    # 2. one checkpoint: saved, one sweep on; restored, the same sweep
    with tempfile.TemporaryDirectory() as tmp:
        saved = state_digests(to_numpy(model.state))
        t0 = time.perf_counter()
        step = model.save_checkpoint(tmp)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        model.sweep(1)
        after = state_digests(to_numpy(model.state))
        t0 = time.perf_counter()
        if model.restore_checkpoint(tmp) != step:
            raise AssertionError("[rung3 full] restored another step")
        block_on_backend(model)
        restore_s = time.perf_counter() - t0
        if state_digests(to_numpy(model.state)) != saved:
            raise AssertionError("[rung3 full] the restored state differs from the saved")
        model.sweep(1)
        if state_digests(to_numpy(model.state)) != after:
            raise AssertionError("[rung3 full] the sweep after the restore differs")
    out["checkpoint"] = dict(step=step, save_s=save_s, restore_s=restore_s,
                             bytes=nbytes)
    log(f"[rung3 full checkpoint] saved at sweep {step} in {save_s:.2f}s "
        f"({nbytes} bytes, {nbytes / save_s / 1e6:.0f} MB/s), restored in "
        f"{restore_s:.2f}s: z, ndk, nwk and nk bitwise the saved state, and the "
        f"next sweep bitwise the one after the save; nvidia-smi: {smi}")
    del model
    if on_card:
        torch.cuda.empty_cache()

    # 3. the ladder's rung 3 on the same corpus (its runtime kept for the
    # comparison of its graph with its eager sweep)
    from ldagibbssampling_tpu_torch.parallel import adlda

    made, plain_cls = [], adlda.ShardedLda

    class Kept(plain_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    counted = tracing.counters()
    adlda.ShardedLda = Kept
    try:
        with plan_timer() as plans:
            r3 = ladder.rung3(scale, sweeps=sweeps, device=device, corpus=built)
    finally:
        adlda.ShardedLda = plain_cls
    r3["plan_s"] = sum(plans)
    # the ladder's two warm-up calls and the graph's warm-up sweep
    shards, runs = r3["shards"], 2 + sweeps + 1
    r3["launches"] = _launches_match("rung3 full ladder", {
        sample_name(torch.bfloat16, "float32"): runs * shards,
        "rebuild_counts": runs * shards, "cast_mirror": runs}, device, counted)
    if r3["kernel_tier"] != "deferred" or r3["tokens"] != corpus.num_tokens \
            or not r3["counts_consistent"] or not np.isfinite(r3["held_out_ppl"]):
        raise AssertionError(f"[rung3 full ladder] {r3}")
    out["ladder"] = r3
    out["host_peak_rss_gb"] = host_peak_rss_gb()
    log(f"[rung3 full ladder] ladder.rung3({scale}): {r3['corpus']}, "
        f"{r3['tokens']} training tokens, {shards} shard(s), tier "
        f"{r3['kernel_tier']}: {r3['tokens_per_s']:,.0f} tokens/s over {sweeps} "
        f"sweeps; setup_s {r3['setup_s']:.2f} (plan_s {r3['plan_s']:.3f}); "
        f"counts consistent; held-out perplexity {r3['held_out_ppl']:.1f}; "
        f"launches {r3['launches']}; host peak RSS {out['host_peak_rss_gb']:.2f} GB; "
        f"nvidia-smi: {smi}")
    # the ladder recounted this runtime's tables (its counts_consistent)
    out["graph"] = mesh_graph_compare("rung3 full", made[0], smi, profile=False,
                                      recount=False, device=device)
    del made
    return out, {"rung3 full": launches, "rung3 full ladder": r3["launches"]}


def write_docs(root: Path, corpus, render) -> float:
    """One file per document, ``doc<m>.txt`` (name order is document
    order), its bytes ``render(word ids)``; returns the seconds taken."""
    t0 = time.perf_counter()
    root.mkdir(parents=True)
    tw, ptr = corpus.token_word.tolist(), corpus.doc_ptr.tolist()
    for m in range(corpus.num_docs):
        (root / f"doc{m:06d}.txt").write_bytes(render(tw[ptr[m]:ptr[m + 1]]))
    return time.perf_counter() - t0


def messy_render(terms: list[bytes], seed: int):
    """A renderer of the generator's words with capitals, tabs, form feeds,
    CRLF line ends, and stopwords, URLs and digit-only tokens between them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cased = (terms, [t.upper() for t in terms], [t.capitalize() for t in terms])

    def render(ids):
        n = len(ids)
        case = rng.integers(0, len(cased), size=n).tolist()
        sep = rng.integers(0, len(INGEST_SEPS), size=n).tolist()
        extra = rng.integers(0, 4 * len(INGEST_DROPPED), size=n).tolist()
        parts = []
        for j, i in enumerate(ids):
            if extra[j] < len(INGEST_DROPPED):
                parts += (INGEST_DROPPED[extra[j]], b" ")
            parts += (cased[case[j]][i], INGEST_SEPS[sep[j]])
        return b"".join(parts)
    return render


def match_generator(fc, corpus, terms: list[bytes], label: str) -> None:
    """The ingested corpus is the generator's: the same documents and
    token positions, its word ids under one bijection in first-seen order,
    V the number of distinct ids, each term the id's."""
    import numpy as np

    uniq, first = np.unique(corpus.token_word, return_index=True)
    order = uniq[np.argsort(first)]  # ingested id -> generator id
    bad = [n for n, ok in (
        ("doc_ptr", np.array_equal(fc.doc_ptr, corpus.doc_ptr)),
        ("token_doc", np.array_equal(fc.token_doc, corpus.token_doc)),
        ("vocab_size", fc.vocab_size == len(uniq)),
        ("token_word", fc.num_tokens == corpus.num_tokens
         and np.array_equal(order[fc.token_word], corpus.token_word)),
        ("vocab", list(fc.vocab) == [terms[g].decode() for g in order.tolist()]))
        if not ok]
    if bad:
        raise AssertionError(f"[ingest {label}] differs from the generator: {bad}")


_COUNTED_CLI = (
    "import json, sys\n"
    "import chip_smoke\n"
    "from ldagibbssampling_tpu_torch import cli\n"
    "from ldagibbssampling_tpu_torch.evaluation import tracing\n"
    "counted = tracing.counters()\n"
    "with chip_smoke.plan_timer() as plans:\n"
    "    rc = cli.main(sys.argv[1:])\n"
    "print('[launches] ' + json.dumps(chip_smoke.kernel_counts(counted)), flush=True)\n"
    "print('[plan] ' + json.dumps(plans), flush=True)\n"
    "sys.exit(rc)\n")


def host_cpu() -> str:
    """The host CPU as ``lscpu`` gives it: model name, family and model
    numbers, and the cores."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    fields = {k.strip(): v.strip() for k, v in (
        ln.split(":", 1) for ln in out.splitlines() if ":" in ln)}
    name, vendor, family, model = (fields.get(k, "?") for k in (
        "Model name", "Vendor ID", "CPU family", "Model"))
    return (f"lscpu model name {name} (vendor {vendor}, family {family}, "
            f"model {model}), {os.cpu_count()} cores")


def ingest_phase(seed: int, device: str = "cuda", scale: float = INGEST_SCALE,
                 small_scale: float = INGEST_SMALL_SCALE) -> tuple[dict, dict]:
    """Phase 13: the CLI's ingest on the card's host and the CLI end to end.

    a. rung 3's whole corpus at ``scale`` written as ASCII text, one file
       per document; b. read in this process by ``read_docs_routed``, which
       must take the native route and give the generator's corpus; c. a
       messy corpus at ``small_scale`` read by both routes, bitwise equal;
       d. the port's CLI (a subprocess) on the ``scale`` directory in the
       deferred tier, K = 100, with ``--check-counts``, its launches
       counted.  Returns the results and the CLI's launches by kernel."""
    import numpy as np
    import torch

    from ldagibbssampling_tpu_torch.benchmarks.ingest import rung3_terms
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung3_shape
    from ldagibbssampling_tpu_torch.corpus.documents import Documents
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu_torch.corpus.native import (
        ingest_texts, load_library, read_docs_routed, read_texts)
    from ldagibbssampling_tpu_torch.data.synthetic import zipf_corpus
    from ldagibbssampling_tpu_torch.ops.fused_kernel import sample_name

    cpu = host_cpu()
    t0 = time.perf_counter()
    if load_library() is None:  # built here, so that no ingest below times g++
        raise AssertionError("[ingest] the native library did not build")
    out = {"host_cpu": cpu, "library_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        # a. write
        m, v = rung3_shape(scale)
        t0 = time.perf_counter()
        corpus = zipf_corpus(m, v, mean_doc_len=300, seed=2)
        terms = rung3_terms(v)
        gen_s = time.perf_counter() - t0
        big = Path(tmp, "big")
        write_s = write_docs(big, corpus, lambda ids: b" ".join([terms[i] for i in ids]) + b"\n")
        nbytes = sum(f.stat().st_size for f in big.iterdir())
        log(f"[ingest] host {cpu}; library ready in {out['library_s']:.2f}s; "
            f"rung 3 at scale {scale}: {m} documents, "
            f"{corpus.num_tokens} tokens, V {v} (generated in {gen_s:.2f}s) "
            f"written as {nbytes} bytes of text in {write_s:.2f}s")

        # b. in-process ingest: the native route, the generator's corpus
        t0 = time.perf_counter()
        fc, route = read_docs_routed(big)
        native_s = time.perf_counter() - t0
        if route != "native":
            raise AssertionError(f"[ingest] read_docs_routed took {route!r}, not native")
        match_generator(fc, corpus, terms, f"scale {scale}")
        out.update(documents=m, tokens=fc.num_tokens, vocab=fc.vocab_size,
                   text_bytes=nbytes, write_s=write_s, native_s=native_s,
                   native_tokens_per_s=fc.num_tokens / native_s)
        log(f"[ingest native] {fc.num_tokens} tokens of {m} documents (V "
            f"{fc.vocab_size} distinct ids) in {native_s:.3f}s = "
            f"{fc.num_tokens / native_s:,.0f} tokens/s, "
            f"{nbytes / native_s / 1e6:.1f} MB/s; the generator's corpus "
            f"(doc_ptr, token_doc, ids under one first-seen bijection)")
        del fc

        # c. both routes on a messy corpus, bitwise
        sm, sv = rung3_shape(small_scale)
        small = zipf_corpus(sm, sv, mean_doc_len=300, seed=2)
        sterms = rung3_terms(sv)
        messy = Path(tmp, "messy")
        swrite_s = write_docs(messy, small, messy_render(sterms, seed))
        t0 = time.perf_counter()
        nat, route = read_docs_routed(messy)
        snative_s = time.perf_counter() - t0
        if route != "native":
            raise AssertionError(f"[ingest messy] took {route!r}, not native")
        t0 = time.perf_counter()
        docs = Documents().read_docs(messy)
        py = FlatCorpus.from_documents(docs)
        python_s = time.perf_counter() - t0
        # the library's own term counts
        _, _, vocab, counts = ingest_texts(read_texts(messy))
        py_counts = np.array([docs.term_count[t] for t in docs.index_to_term], np.int64)
        bad = [n for n, ok in (
            *((n, np.array_equal(getattr(nat, n), getattr(py, n))
               and getattr(nat, n).dtype == getattr(py, n).dtype)
              for n in ("token_word", "token_doc", "doc_ptr")),
            ("vocab", nat.vocab == py.vocab == vocab),
            ("term counts", np.array_equal(counts, py_counts)))
            if not ok]
        if bad:
            raise AssertionError(f"[ingest messy] the routes differ: {bad}")
        match_generator(nat, small, sterms, f"messy {small_scale}")
        out["messy"] = dict(documents=sm, tokens=nat.num_tokens, vocab=nat.vocab_size,
                            write_s=swrite_s, native_s=snative_s, python_s=python_s,
                            native_tokens_per_s=nat.num_tokens / snative_s,
                            python_tokens_per_s=nat.num_tokens / python_s)
        log(f"[ingest messy] scale {small_scale}: {sm} documents with capitals, "
            f"tabs, form feeds, CRLF, stopwords, URLs and digit-only tokens "
            f"(written in {swrite_s:.2f}s), {nat.num_tokens} tokens kept, V "
            f"{nat.vocab_size}: native {snative_s:.3f}s = "
            f"{nat.num_tokens / snative_s:,.0f} tokens/s, Python "
            f"{python_s:.3f}s = {nat.num_tokens / python_s:,.0f} tokens/s "
            f"({python_s / snative_s:.1f}x); token_word, token_doc, doc_ptr, "
            f"vocab and term counts bitwise equal")
        del nat, py, docs

        # d. the CLI end to end on the big directory, its launches counted
        metrics = Path(tmp, "m.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _COUNTED_CLI, "--docs", str(big), "--device",
             device, "--topics", "100", "--block-size", "65536", "--iterations",
             str(INGEST_SWEEPS), "--no-save", "--check-counts", "--metrics-file",
             str(metrics), "--seed", str(seed)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(REPO)})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[ingest cli] exit {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        ingest_line = next((ln for ln in lines if ln.startswith("ingest: ")), "")
        if not ingest_line.startswith("ingest: native"):
            raise AssertionError(f"[ingest cli] no native ingest: {ingest_line!r}")
        if "count tables bitwise-consistent" not in proc.stdout:
            raise AssertionError("[ingest cli] --check-counts did not pass")
        rows = [json.loads(x) for x in metrics.read_text().splitlines()]
        header = rows[0]
        if header["kernel_tier"] != "deferred" or header["ingest"] != "native":
            raise AssertionError(f"[ingest cli] header {header}")
        counted_lines = [ln for ln in lines if ln.startswith("[launches] ")]
        launches, plain = json.loads(counted_lines[-1].split(" ", 1)[1])
        plans = json.loads(next(ln for ln in lines if ln.startswith("[plan] "))
                           .split(" ", 1)[1])
        # in the process: the state's first snapshot, then per sweep one walk,
        # one rebuild and one snapshot, and once more in the graph's warm-up
        walk = sample_name(torch.bfloat16, "float32")
        want = {walk: INGEST_SWEEPS + 1, "rebuild_counts": INGEST_SWEEPS + 1,
                "cast_mirror": INGEST_SWEEPS + 2}
        if device == "cuda":
            got = {n: c for n, c in launches.items() if c}
            ok = got == want and not any(plain.values())
        else:  # a rehearsal: the plain walk runs tile by tile
            got = {n: plain[n] for n in want}
            ok = all(got.values()) and not any(launches.values())
        if not ok:
            raise AssertionError(f"[ingest cli] launches {launches}, plain {plain}; "
                                 f"want {want}")
        tokens = corpus.num_tokens
        sweep_times = [tokens / r["tokens_per_s"] for r in rows[1:]]
        sweep_s = sum(sweep_times)
        out["cli"] = dict(wall_s=wall, ingest_s=header["ingest_s"],
                          setup_s=header["setup_s"], plan_s=sum(plans),
                          sweep_s=sweep_s,
                          first_sweep_s=sweep_times[0],
                          tokens_per_s=INGEST_SWEEPS * tokens / sweep_s,
                          kernel_tier=header["kernel_tier"], launches=got)
        log(f"[ingest cli] {' '.join(proc.args[3:])}: exit 0 in {wall:.1f}s "
            f"wall; {ingest_line}; set-up (layout and state) "
            f"{header['setup_s']:.2f}s (plan_s {sum(plans):.3f}); "
            f"{INGEST_SWEEPS} sweeps {sweep_s:.3f}s "
            f"(first {sweep_times[0]:.3f}s) = "
            f"{INGEST_SWEEPS * tokens / sweep_s:,.0f} tokens/s, tier "
            f"{header['kernel_tier']}; counts bitwise-consistent; launches {got}")
    return out, {"ingest cli": got}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scatter-parent", type=Path, default=None,
                    help="root of another checkout: time its CVB0 scatter "
                         "against this one's in turns (scripts/scatter_parity.py)")
    args = ap.parse_args()
    t_main = time.perf_counter()

    def wall(phase: str) -> None:  # where the script's time goes, phase by phase
        log(f"[wall] {phase} done at {time.perf_counter() - t_main:.1f}s")

    if not (REPO / PKG / "csrc").is_dir():
        return fail(f"{PKG}/ not found beside {Path(__file__).name}: run it "
                    "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from ldagibbssampling_tpu_torch.benchmarks.ladder import rung_corpus
    from ldagibbssampling_tpu_torch.ops import _build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources built in {secs:.1f}s")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    from ldagibbssampling_tpu_torch.ops import fused_kernel as fk
    from ldagibbssampling_tpu_torch.ops import sample_kernel as sk
    from ldagibbssampling_tpu_torch.ops.gibbs import _pick_row_tile

    k_pad, row_tile = -(-K // 128) * 128, _pick_row_tile(BLOCK, K)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = sk.block_sample_config("internal", K, BLOCK)
    log(f"[build] K3 gibbs_block_sample: {cfg['grid']} CTAs ({cfg['grid'] // sms} "
        f"per SM, from the occupancy query) of {cfg['threads']} threads, "
        f"{cfg['smem']} bytes of log tables each")
    for rows, chain in ((torch.int32, "float32"), (torch.bfloat16, "float32"),
                        *((getattr(torch, r), c) for c, r in CHAIN_SETTINGS)):
        cfg = fk.walk_config(rows, chain, "internal", k_pad, BLOCK, row_tile,
                             ndk_bytes=M * K * 4)
        log(f"[build] walk {fk.sample_name(rows, chain)}: {cfg['grid']} CTAs "
            f"({cfg['grid'] // sms} per SM, from the occupancy query) of "
            f"{cfg['threads']} threads, {cfg['team']} threads per token, "
            f"{'tagged records' if cfg['pipelined'] else 'two barriers per tile'}")

    corpus = synth_corpus(args.seed)
    kernels = check_kernels(corpus, args.seed)             # 3.
    kernels.update(check_live_kernels(corpus, args.seed))  # 3b.
    kernels.update(check_probe(args.seed))                 # 3c.
    kernels["gibbs_tile_sample"].update(check_general_walk(corpus, args.seed))  # 3d.
    kernels.update(check_resample_kernels(args.seed))      # 3e.
    wall("kernels 3-3e")
    rung5, _ = rung_corpus(5, BACKEND_SCALE)
    kernels.update(check_cvb0_scatter(args.seed, rung5, corpus,  # 3f.
                                      parent=args.scatter_parent))
    wall("kernels")
    paths = {}
    runs = [(use_pallas, sweeps, "float32", "bfloat16", K)
            for use_pallas, sweeps in (("deferred", SWEEPS), ("fused", SWEEPS),
                                       (True, SWEEPS), (False, 2))]
    runs += [("deferred", SWEEPS, chain, mirror, K) for chain, mirror in CHAIN_SETTINGS]
    runs.append(("deferred", SWEEPS, "float32", "bfloat16", K_GENERAL))
    for use_pallas, sweeps, chain, mirror, k in runs:      # 4.
        tok_s, launches, model = main_path(corpus, args.seed, smi, use_pallas,
                                           sweeps, chain=chain, mirror=mirror, k=k)
        label = run_label(use_pallas, chain, mirror, k)
        profile_sweep(model, label)                        # 4b.
        paths[label] = (tok_s, launches)
        del model
        torch.cuda.empty_cache()
    wall("main paths")
    quality = quality_phase(args.seed)                     # 4c.
    heldout = heldout_phase(args.seed)                     # 4e.
    hyper = hyper_phase(corpus, args.seed)                 # 4d.
    wall("quality, heldout, hyper")
    cli_phase(((), ("--pallas", "fused"), ("--sampler", "serial"),  # 5.
               ("--ll-every", "5", "--optimize-hyper-every", "5")))
    resume_phase()                                         # 5b.
    infer_phase()                                          # 5c.
    wall("cli")
    parity = {TIER_NAMES[up]: parity_phase(up, args.seed)  # 6.
              for up in ("deferred", "fused", True, False)}
    wall("parity")
    bench = {tier: bench_phase(tier, sweeps) for tier, sweeps in BENCH_RUNS}  # 7.
    wall("bench")
    multichain = multichain_phases(args.seed, wide_corpus=corpus)  # 8, 8b.
    wall("multichain")
    graphs, graph_launches = graphs_phase(args.seed, smi, corpus)  # 8c.
    graphs["smc"], graph_launches["smc"] = graph_smc_phase(  # 8d.
        args.seed, smi, {n: kernels[n] for n in ("resample_gather", "resample_write")})
    graphs["svi"] = graph_svi_phase(args.seed, smi)         # 8e.
    wall("graphs 8c-8e")
    backend_graphs, backend_graph_launches = graph_backends_phase(  # 8f, 8g.
        args.seed, smi, rung5, corpus)
    del rung5
    graphs.update(backend_graphs)
    graph_launches.update(backend_graph_launches)
    wall("graphs")
    backends, backend_launches = backends_phase(args.seed)  # 9.
    backends_resume_phase()                                 # 10.
    wall("backends")
    with tempfile.TemporaryDirectory() as tmp:
        ladder = ladder_phase(tmp)                          # 11.
    wall("ladder")
    mesh, mesh_launches = mesh_phase(args.seed, smi)        # 12.
    wall("mesh")
    mesh2, mesh2_launches = mesh_two_process_phase(args.seed, smi)  # 12b.
    mesh_launches.update(mesh2_launches)
    mesh["two_processes"] = mesh2
    wall("mesh two processes")
    full, full_launches = rung3_full_phase(args.seed, smi)  # 12c.
    mesh_launches.update(full_launches)
    wall("rung3 full")
    ingest, ingest_launches = ingest_phase(args.seed)       # 13.
    wall("ingest")

    src = f"{PKG}/csrc"
    k1 = "ldagibbssampling_tpu/ops/pallas_gibbs.py:58"
    k4 = "scripts/vpu_dtype_probe.py:24"
    smc_cond = "ldagibbssampling_tpu/backends/smc.py:119 (lax.cond; not a TPU kernel)"
    meta = {
        "gibbs_tile_sample": (f"{src}/fused_kernel.cu", k1),
        **{name: (f"{src}/fused_kernel.cu", k1) for name in kernels
           if name.startswith("gibbs_tile_sample_") and name != "gibbs_tile_sample_live"},
        "gibbs_tile_sample_live": (f"{src}/fused_kernel.cu", k1),
        "gibbs_tile_update": (f"{src}/fused_kernel.cu", k1),
        "count_move": (f"{src}/fused_kernel.cu", k1),
        "rebuild_counts": (f"{src}/count_kernel.cu", "ldagibbssampling_tpu/ops/count_kernel.py:211"),
        "cast_mirror": (f"{src}/count_kernel.cu", "ldagibbssampling_tpu/ops/count_kernel.py:211"),
        "gibbs_block_sample": (f"{src}/sample_kernel.cu", "ldagibbssampling_tpu/ops/pallas_gibbs.py:311"),
        "dtype_probe_f32": (f"{src}/dtype_probe.cu", k4),
        "dtype_probe_bf16": (f"{src}/dtype_probe.cu", k4),
        # no TPU kernel: the reference's lax.cond resample inside its scan
        "resample_gather": (f"{src}/smc_resample.cu", smc_cond),
        "resample_write": (f"{src}/smc_resample.cu", smc_cond),
        # no TPU kernel: the reference's scatter-adds of CVB0's deltas
        "cvb0_scatter": (f"{src}/cvb0_scatter.cu",
                         "ldagibbssampling_tpu/backends/cvb0.py:69-70 "
                         "(.at[d].add, .at[w].add; not a TPU kernel)"),
    }
    rows = []
    for kname, (source, replaces) in meta.items():
        k = kernels[kname]
        by_path = {tier: n[kname] for tier, (_, n) in paths.items() if kname in n}
        for path, counts in backend_launches.items():  # phase 9's Gibbs, SMC, CVB0
            if kname in counts:
                by_path[path] = counts[kname]
        for label, counts in graph_launches.items():  # phase 8c-8g's captured runs
            if kname in counts:
                by_path[f"graphs {label}"] = counts[kname]
        for path, counts in (*mesh_launches.items(),  # phases 12, 12c, 13
                             *ingest_launches.items()):
            if kname in counts:
                by_path[path] = counts[kname]
        if kname.startswith("dtype_probe"):  # launched by the probe's entry point
            by_path = {"vpu_dtype_probe": k["launches"]}
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "unit": k["unit"], "launches_by_path": by_path,
            **{x: v for x, v in k.items()
               if x.startswith(("z_match", f"k{K_GENERAL}_")) or x in (
                   "ms_three_tables", "no_mirror_max_abs_err", "gops",
                   "ms_64_reps", "walk_ms", "walk_device_ms", "walk_bound_ms",
                   "fixed_us_per_tile", "event_ms", "device_ms",
                   "event_ms_three_tables", "bound_three_tables_ms",
                   "library_device_ms", "ms_flag_false", "event_ms_flag_false",
                   "scatter_shapes", "scatter_turns")},
        })
    print(json.dumps({"kernels": rows, "main_path_tokens_per_s": {
        tier: tok_s for tier, (tok_s, _) in paths.items()},
        "sweeps": {tier: SWEEPS if tier != "xla" else 2 for tier in paths},
        "quality": {key: [{n: r[n] for n in ("sweep", "log_likelihood", "perplexity")}
                          for r in rows_] for key, rows_ in quality.items()},
        "hyper": hyper, "heldout": heldout, "parity": parity,
        "bench": bench, "multichain": multichain, "graphs": graphs,
        "backends": backends,
        "ladder": ladder, "mesh": mesh, "rung3_full": full, "ingest": ingest}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
