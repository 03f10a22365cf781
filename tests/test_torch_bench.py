"""The port's bench script (``scripts/bench.py``) and driver hook
(``entry.py``) against the repository's ``bench.py`` and
``__graft_entry__.py``, on the CPU at a small shape.

``bench.py`` reads ``sys.argv`` and the ``LDA_BENCH_*`` variables when it is
imported (and JAX only inside ``main``), so it is imported here with
``sys.argv`` set to ``["bench.py"]``.  Exact: the port's ``synth_corpus``
returns ``bench.py``'s arrays bitwise; ``main(device="cpu")`` prints one
JSON line whose keys and ``metric`` name are ``bench.py``'s, in every
``LDA_BENCH_PALLAS`` tier; the knobs' defaults and refusals are
``bench.py``'s.
"""

from __future__ import annotations

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch import entry as entry_mod
from ldagibbssampling_tpu_torch.scripts import bench

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO_BENCH = "bench.py"
SMALL = dict(LDA_BENCH_VOCAB="300", LDA_BENCH_DOCS="16", LDA_BENCH_BLOCK="1024",
             LDA_BENCH_SWEEPS="2")


@pytest.fixture(scope="module")
def ref_bench():
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / REPO_BENCH
    argv = sys.argv
    sys.argv = ["bench.py"]
    try:
        spec = importlib.util.spec_from_file_location("_repo_bench", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


@pytest.mark.parametrize("t,v,m,seed", [(1 << 14, 50_000, 64, 0),
                                        (5000, 300, 7, 3)])
def test_synth_corpus_bitwise_bench_py(ref_bench, t, v, m, seed):
    got = bench.synth_corpus(t, v, m, seed)
    want = ref_bench.synth_corpus(t, v, m, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_settings_defaults_are_bench_py(ref_bench):
    s = bench.settings([], {})
    assert (s["num_tokens"], s["num_topics"], s["vocab"], s["num_docs"],
            s["block_size"], s["timed_sweeps"], s["use_pallas"],
            s["compute_dtype"], s["mirror_dtype"]) == (
        ref_bench.NUM_TOKENS, ref_bench.NUM_TOPICS, ref_bench.VOCAB,
        ref_bench.NUM_DOCS, ref_bench.BLOCK_SIZE, ref_bench.TIMED_SWEEPS,
        ref_bench.USE_PALLAS, ref_bench.COMPUTE_DTYPE, ref_bench.MIRROR_DTYPE)
    assert bench.BASELINE_TOKENS_PER_S == ref_bench.BASELINE_TOKENS_PER_S


@pytest.mark.parametrize("env,match", [
    ({"LDA_BENCH_COMPUTE": "float16"}, "LDA_BENCH_COMPUTE='float16'"),
    ({"LDA_BENCH_MIRROR": "int8"}, "LDA_BENCH_MIRROR='int8'"),
])
def test_settings_refuse_as_bench_py(env, match):
    with pytest.raises(SystemExit, match=match):
        bench.settings([], env)
    with pytest.raises(KeyError):
        bench.settings([], {"LDA_BENCH_PALLAS": "2"})


@pytest.mark.parametrize("tier,name", [("deferred", "deferred"), ("fused", "fused"),
                                       ("1", "pallas-draw"), ("0", "xla")])
def test_main_on_cpu_prints_bench_py_line(monkeypatch, capsys, tier, name):
    for key, value in {**SMALL, "LDA_BENCH_PALLAS": tier}.items():
        monkeypatch.setenv(key, value)
    bench.main(device="cpu", argv=["4096", "8"])
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert list(row) == ["metric", "value", "unit", "vs_baseline"]
    assert row["metric"] == "tokens_resampled_per_s_chip_K8"
    assert row["unit"] == "tokens/s" and row["value"] > 0
    assert row["vs_baseline"] == round(row["value"] / 2e4, 2)
    assert err.startswith("# device=cpu T=4096 K=8 V=300 block=1024")
    assert f"tier={name}" in err


def test_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(argv=["4096", "8"])


def test_entry_runs_one_deferred_sweep_on_cpu():
    fn, args = entry_mod.entry(device="cpu")
    assert fn.kernel_tier == "deferred"
    state = fn(*args)
    assert state.sweep == 1 and args[0].sweep == 0
    assert int(state.nk.sum()) == 64 * 64
    assert torch.equal(state.nwk.sum(dim=0), state.nk)
