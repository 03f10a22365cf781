"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench_run
from benchmark.spec import HERE, ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "ldagibbssampling_tpu"}
PROGRAM = "ldagibbssampling_tpu_torch"


def test_guard_compares_whole_top_level_names():
    assert bench_run.forbidden_loaded([PROGRAM, f"{PROGRAM}.ops", "jaxtyping",
                                       "flaxen", "numpy"]) == []
    assert bench_run.forbidden_loaded(["jax.numpy", "ldagibbssampling_tpu.ops",
                                       "flax"]) == ["flax", "jax", "ldagibbssampling_tpu"]


def _top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_harness_imports_the_jax_side():
    for path in HERE.rglob("*.py"):
        assert not _top_imports(path) & JAX_SIDE, path


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_of_the_harness_loads_no_jax_side_module():
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "from benchmark import spec\n"
        "from benchmark.tests._tiny import tiny_cell\n"
        "cell = tiny_cell()\n"
        "cell.per_layer = spec.load_cell('nytimes-k100.gibbs').per_layer\n"
        "[spec.reader(m['name']) for m in cell.per_layer]\n"
        "import benchmark.run, benchmark.control\n"
        "r = spec.driver(cell.traffic).run(cell, seed=5, seconds=0.0, trace=False,"
        " device='cpu', t_start=time.perf_counter())\n"
        "assert r['correct']\n")
    loaded = _loaded_after(code)
    assert PROGRAM in loaded          # the run did drive the port
    assert not loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                           "import benchmark.reference, benchmark.roofline, "
                           "benchmark.corpus, benchmark.check")
    assert not loaded & (JAX_SIDE | {PROGRAM})
    for name in ("reference.py", "roofline.py", "corpus.py", "check.py"):
        assert not _top_imports(HERE / name) & (JAX_SIDE | {PROGRAM}), name
