"""The port's mesh runtimes across two processes on ``torch.distributed``
(gloo, CPU), as ``tests/test_multiprocess_distributed.py`` holds the JAX
package's across two ``jax.distributed`` processes (its tests at ``:125``,
``:157``, ``:308`` and ``:447``):

- bring-up: ``initialize_distributed`` gives a topology of two processes
  and two global positions;
- ``ShardedLda`` in the XLA and the deferred tier, and the 2×1 grid, each
  with one position per process: ``z`` and every table (gathered from both
  processes) equal the one-process run on two positions bitwise.  Integer
  sums are exact in any order, and each shard's noise depends only on the
  seed, its position and the sweep, not on the process holding it.

Each test spawns two fresh interpreters (never ``dist.init`` in the
pytest worker itself), each with a free port and a 60 s timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
from ldagibbssampling_tpu_torch.parallel.grid import GridLda
from test_torch_mesh_sweep import K, mesh_corpora

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from test_torch_mesh_sweep import mesh_corpora
from ldagibbssampling_tpu_torch.parallel import multihost

pid, coord, case, tests, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
topo = multihost.initialize_distributed(coord, 2, pid, device="cpu")
assert (topo.process_index, topo.process_count) == (pid, 2), topo
assert (topo.local_device_count, topo.global_device_count) == (1, 2), topo
if case != "bringup":
    from test_torch_multiprocess import build
    model = build(case, multihost.make_mesh(
        {"data": 2, "vocab": 1} if case == "grid" else {"data": 2}, device="cpu"))
    assert model.positions == [pid]
    model.sweep(3)
    model.check_counts_consistent()
    arrays = model.arrays()
    if pid == 0:
        np.savez(out, **arrays)
print(f"proc {pid} ok", flush=True)
"""


def build(case: str, mesh):
    """The runtime of ``case`` on ``mesh`` (both processes build the same)."""
    _, pc = mesh_corpora(41)
    tier = {"xla": False, "deferred": "deferred", "grid": "deferred"}[case]
    cfg = LdaConfig(topic_num=K, block_size=256, seed=7, use_pallas=tier)
    cls = GridLda if case == "grid" else ShardedLda
    return cls(cfg, pc, mesh=mesh, device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(case: str, out: Path) -> None:
    coord = f"127.0.0.1:{_free_port()}"
    tests = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), tests, os.environ.get("PYTHONPATH", "")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), coord, case, tests, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=60)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two processes timed out")
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{text}"
        assert f"proc {pid} ok" in text


def test_two_process_bringup(tmp_path):
    _run_two("bringup", tmp_path / "unused.npz")


@pytest.mark.parametrize("case", ["xla", "deferred", "grid"])
def test_two_processes_equal_one_process_two_positions(tmp_path, case):
    out = tmp_path / "two.npz"
    _run_two(case, out)
    got = np.load(out)
    axes = {"data": 2, "vocab": 1} if case == "grid" else {"data": 2}
    one = build(case, multihost.make_mesh(axes, [torch.device("cpu")] * 2))
    one.sweep(3)
    want = one.arrays()
    assert one.kernel_tier == ("xla" if case == "xla" else "deferred")
    for name in ("z", "ndk", "nwk", "nk"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
