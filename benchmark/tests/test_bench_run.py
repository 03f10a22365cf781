"""A whole run of the harness on the CPU through the kernels' plain versions:
``correct`` holds, no device metric is printed; and with the timed path
broken underneath, or the lower precision in the program's place,
``correct`` comes out false."""

import time

import pytest

from benchmark import faults
from benchmark.drivers import gibbs
from benchmark.tests._tiny import tiny_cell



def _run(cell, seed=2**31 + 11, **kw):
    return gibbs.run(cell, seed=seed, seconds=0.0, trace=False, device="cpu",
                     t_start=time.perf_counter(), **kw)


def test_run_on_cpu_is_correct_and_prints_no_device_metric():
    res = _run(tiny_cell())
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert {c["value"] for c in res["checks"].values()} == {0.0}


def test_control_lower_precision_chain_is_not_correct():
    res = _run(tiny_cell(), overrides={"kernel_compute_dtype": "bfloat16"})
    assert not res["correct"]
    assert res["checks"]["last_draw_off"]["value"] > res["checks"]["last_draw_off"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        res = _run(tiny_cell())
    assert not res["correct"], res["checks"]


def test_tier_fallback_fails_the_run():
    with pytest.raises(RuntimeError, match="tier"):
        _run(tiny_cell(use_pallas="fused"))
