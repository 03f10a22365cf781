"""The WarpLDA driver (``drivers/warp.py``) on the CPU through the port's
eager sweep: a tiny cell of the traffic ``warp.json`` under the limits of
``pubmed-k1000-warplda.warp`` is ``correct``; the bfloat16-uniform control
and each planted fault (``faults_warp.py``) fail by a number over its
limit."""

import time

import pytest

from benchmark import faults_warp, spec
from benchmark.drivers import warp
from benchmark.tests._tiny import TINY_CONFIG

CELL = "pubmed-k1000-warplda.warp"


def tiny_cell() -> spec.Cell:
    t = spec.load_json(spec.HERE / "traffic" / "warp.json")
    t["block_size"] = 512
    limits = spec.load_json(spec.HERE / "limits" / f"{CELL}.json")
    return spec.Cell(name="tiny.warp", chips=1, config=dict(TINY_CONFIG), traffic=t,
                     limits=limits, end_to_end=[], per_layer=[])


def _run(seed=2**31 + 11, **kw):
    return warp.run(tiny_cell(), seed=seed, seconds=0.0, trace=False, device="cpu",
                    t_start=time.perf_counter(), **kw)


def _over(res):
    return {n: c["value"] for n, c in res["checks"].items() if c["value"] > c["limit"]}


def test_the_cell_names_this_driver_and_its_files():
    cell = spec.load_cell(CELL)
    assert cell.traffic["driver"] == "warp" and cell.chips == 1
    assert set(cell.limits) == {"start_off", "first_draw_off", "last_draw_off",
                                "ndk_off", "nwk_off", "nk_off"}
    assert {m["name"] for m in cell.per_layer} == {
        "warp_roofline_pct", "warp_init_s", "word_csr_s", "warp_arg_bytes"}
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_run_on_cpu_is_correct_and_prints_no_device_metric(seed):
    res = _run(seed)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert {c["value"] for c in res["checks"].values()} == {0.0}


def test_control_bf16_uniforms_is_not_correct():
    res = _run(overrides=dict(warp.CONTROL))
    assert not res["correct"]
    assert set(_over(res)) == {"first_draw_off", "last_draw_off"}, res["checks"]


def test_another_override_is_refused():
    with pytest.raises(ValueError, match="override"):
        _run(overrides={"kernel_compute_dtype": "float16"})


@pytest.mark.parametrize("fault, over", [
    ("word_step_left_out", {"first_draw_off", "last_draw_off"}),
    ("word_pool_moved", {"first_draw_off", "last_draw_off"}),
    ("half_unreconciled", {"last_draw_off", "ndk_off", "nwk_off", "nk_off"}),
])
def test_a_planted_fault_fails_by_a_number_over_its_limit(fault, over):
    with faults_warp.planted(fault):
        res = _run()
    assert not res["correct"]
    assert over <= set(_over(res)), res["checks"]


def test_the_reference_and_its_bound_load_nothing_of_the_program():
    from benchmark.tests.test_bench_guard import JAX_SIDE, PROGRAM, _loaded_after, _top_imports

    loaded = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                           "import benchmark.reference_warp, benchmark.roofline_warp")
    assert not loaded & (JAX_SIDE | {PROGRAM})
    for name in ("reference_warp.py", "roofline_warp.py"):
        assert _top_imports(spec.HERE / name) <= {"__future__", "dataclasses", "numpy",
                                                  "torch", "benchmark"}, name


def test_roofline_counts_a_sweeps_least_bytes_and_its_reader_reads_them():
    from types import SimpleNamespace

    from benchmark import roofline_warp
    from benchmark.trace import Trace

    c = roofline_warp.SweepCounts(real=1000, moved=100)
    assert roofline_warp.sweep_bytes(c) == 1000 * (16 + 11 * 32) + 100 * 8 * 32
    reader = spec.reader("warp_roofline_pct")
    trace = Trace(window_s=1.0, sweeps=4, busy_s=0.8, kernels={}, gaps=[])
    want = 100.0 * roofline_warp.sweep_bound_s(c) / 0.2
    assert reader.read(SimpleNamespace(trace=trace, counts=c)) == pytest.approx(want)
    assert reader.read(SimpleNamespace(trace=None, counts=c)) is None
    assert reader.read(SimpleNamespace(trace=trace, counts=None)) is None
