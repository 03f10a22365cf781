"""The port's mesh runtimes across several processes on ``torch.distributed``
(gloo, CPU), as ``tests/test_multiprocess_distributed.py`` holds the JAX
package's across two ``jax.distributed`` processes (its tests at ``:125``,
``:157``, ``:308`` and ``:447``):

- bring-up: ``initialize_distributed`` at a ``host:port`` address gives a
  topology of two processes and two global positions, and ``psum`` adds
  across them;
- exit: every process that finished its work exits 0, with no abort from
  gloo's threads at interpreter exit (``initialize_distributed`` tears
  down at exit the group it brought up, and only that group);
- ``ShardedLda`` in the XLA and the deferred tier, and the 2×1 grid, each
  with one position per process: ``z`` and every table (gathered from both
  processes) equal the one-process run on two positions bitwise.  Integer
  sums are exact in any order, and each shard's noise depends only on the
  seed, its position and the sweep, not on the process holding it;
- four processes, one position each: the 2×2 grid and the 2×2 chains ×
  data mesh, whose ``psum`` groups span two of the four processes; the
  same bitwise comparison with the one-process four-position run, and each
  of those groups made exactly once per process (``new_group`` counted);
- two processes holding one chain each of a 2×1 chains × data mesh: each
  receives the other's chain tables for φ, and both report the LL traces,
  R̂ on the LL and the summary of R̂ on φ of the one-process run, exactly
  (the same float64 operations on the same values).

Each test spawns fresh interpreters (never ``dist.init`` in the pytest
worker itself) that run this file as a script; every worker's output is
shown on any failure, a timeout included.  The sweep cases meet through a
``file://`` rendezvous under ``tmp_path``; the bring-up takes a free port
and, where a worker finds it taken meanwhile, tries again at another.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.parallel import multihost
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda
from ldagibbssampling_tpu_torch.parallel.chaingrid import ShardedChainSet
from ldagibbssampling_tpu_torch.parallel.grid import GridLda

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, V, SWEEPS, TIMEOUT_S = 7, 300, 3, 120
# each case's mesh and the axes its sweep reduces over
CASES = {
    "xla": ({"data": 2}, ("data",)),
    "deferred": ({"data": 2}, ("data",)),
    "grid": ({"data": 2, "vocab": 1}, ("data", "vocab")),
    "grid4": ({"data": 2, "vocab": 2}, ("data", "vocab")),
    "chain4": ({"chain": 2, "data": 2}, ("data",)),
    "chain_rhat": ({"chain": 2, "data": 1}, ("data",)),
}


def corpus(seed: int = 41, num_docs: int = 60) -> FlatCorpus:
    """A small Zipf-worded corpus (``test_torch_mesh_sweep.mesh_corpora``'s)."""
    rng = np.random.default_rng(seed)
    docs = [list((rng.zipf(1.3, size=int(rng.integers(20, 120))) - 1) % V)
            for _ in range(num_docs)]
    return FlatCorpus.from_ragged(docs, vocab_size=V)


def build(case: str, mesh):
    """The runtime of ``case`` on ``mesh`` (every process builds the same)."""
    tier = False if case == "xla" else "deferred"
    cfg = LdaConfig(topic_num=K, block_size=256, seed=7, use_pallas=tier)
    if case.startswith("chain"):
        return ShardedChainSet(cfg, corpus(), num_chains=2, mesh=mesh, device="cpu")
    cls = GridLda if case.startswith("grid") else ShardedLda
    return cls(cfg, corpus(), mesh=mesh, device="cpu")


def spanning_groups(case: str) -> set:
    """The process tuples of ``case``'s ``psum`` groups that span more than
    one process and not all of them (one position per process)."""
    axes, reduced = CASES[case]
    n = int(np.prod(list(axes.values())))
    mesh = multihost.make_mesh(axes, [torch.device("cpu")] * n, ranks=range(n))
    out = set()
    for name in reduced:
        for p in range(n):
            procs = tuple(sorted({mesh.ranks[q] for q in mesh.group(p, (name,))}))
            if 1 < len(procs) < n:
                out.add(procs)
    return out


# ---------------------------------------------------------------- workers
def worker(case: str, pid: int, n: int, addr: str, out: str) -> None:
    """One process of a test run: bring up the group, do the case's work,
    print ``proc <pid> ok`` and exit through the interpreter's own exit."""
    import torch.distributed as dist

    if case == "teardown":
        return teardown_worker(addr, out)
    made = []
    new_group = dist.new_group

    def counted(*args, **kwargs):
        made.append(args[0] if args else kwargs.get("ranks"))
        return new_group(*args, **kwargs)

    dist.new_group = counted
    topo = multihost.initialize_distributed(addr, n, pid, device="cpu")
    assert (topo.process_index, topo.process_count) == (pid, n), topo
    assert (topo.local_device_count, topo.global_device_count) == (1, n), topo
    if case == "chain_rhat":
        model = build(case, multihost.make_mesh(CASES[case][0], device="cpu"))
        assert model.positions == [pid]
        Path(f"{out}.{pid}.json").write_text(json.dumps(chain_diagnostics(model)))
    elif case == "bringup":
        mesh = multihost.make_mesh({"data": n}, device="cpu")
        for i in range(3):
            got = multihost.psum({pid: torch.full((64,), pid + i, dtype=torch.int32)},
                                 mesh, "data")
            assert got[pid].tolist() == [n * (n - 1) // 2 + n * i] * 64, got
    else:
        model = build(case, multihost.make_mesh(CASES[case][0], device="cpu"))
        assert model.positions == [pid]
        model.sweep(1)
        first = len(made)
        model.sweep(SWEEPS - 1)
        model.check_counts_consistent()
        arrays = model.arrays()
        if pid == 0:
            np.savez(out, **arrays)
        print(f"proc {pid} new_group calls {first} after one sweep, "
              f"{len(made)} after {SWEEPS}: {made}", flush=True)
    print(f"proc {pid} ok", flush=True)


def chain_diagnostics(model) -> dict:
    """Four sweeps of a chain mesh, each recorded (LL, and φ into the
    doubling window), then the LL traces and both R̂."""
    for _ in range(4):
        model.sweep(1, record_ll=True)
        model.record_phi_auto()
    return {"ll_trace": np.stack(model.ll_trace).tolist(),
            "r_hat_ll": model.r_hat_ll(), "r_hat_phi": model.r_hat_phi()}


def teardown_worker(addr: str, out: str) -> None:
    """``initialize_distributed`` registers its exit teardown for a group it
    brings up, and none for a group the caller brought up."""
    import atexit

    import torch.distributed as dist

    registered = []
    atexit.register = lambda fn, *a, **k: registered.append(fn)
    multihost.initialize_distributed(addr, 1, 0, device="cpu")
    assert registered == [multihost._teardown] and dist.is_initialized(), registered
    multihost._teardown()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=out, world_size=1, rank=0)
    multihost.initialize_distributed(out, 1, 0, device="cpu")
    assert registered == [multihost._teardown] and dist.is_initialized(), registered
    dist.destroy_process_group()
    print("proc 0 ok", flush=True)


# ---------------------------------------------------------------- the runs
def _start(case: str, n: int, addr: str, out) -> list[subprocess.Popen]:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
    return [subprocess.Popen(
        [sys.executable, __file__, case, str(pid), str(n), addr, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n)]


def _wait(procs: list[subprocess.Popen]) -> tuple[list[int], list[str], str]:
    """The workers' exit codes, their outputs and what went wrong ("" when
    every worker exited 0 after its ``ok`` line with no abort in its
    output); every worker is ended, a timeout included."""
    deadline, outs, wrong = time.monotonic() + TIMEOUT_S, [], ""
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            wrong = f"timed out after {TIMEOUT_S} s"
            for q in procs:
                q.kill()
            outs = [q.communicate()[0] for q in procs]
            break
    rcs = [p.returncode for p in procs]
    if not wrong:
        bad = [pid for pid, (rc, text) in enumerate(zip(rcs, outs))
               if rc != 0 or f"proc {pid} ok" not in text or "terminate called" in text]
        wrong = f"processes {bad} failed" if bad else ""
    return rcs, outs, wrong


def _report(case: str, rcs, outs, wrong: str) -> str:
    return f"{case}: {wrong}\n" + "\n".join(
        f"--- process {pid}, exit {rc}:\n{text}"
        for pid, (rc, text) in enumerate(zip(rcs, outs)))


def _run(case: str, n: int, addr: str, out) -> list[str]:
    rcs, outs, wrong = _wait(_start(case, n, addr, out))
    assert not wrong, _report(case, rcs, outs, wrong)
    return outs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_bringup(tmp_path):
    """At ``host:port``, the address users give; a port another process
    took between the probe and the bind is retried at a fresh one."""
    for attempt in range(3):
        rcs, outs, wrong = _wait(_start("bringup", 2, f"127.0.0.1:{_free_port()}",
                                        tmp_path / "unused"))
        in_use = any("EADDRINUSE" in t or "address already in use" in t.lower()
                     for t in outs)
        if not (wrong and in_use):
            break
    assert not wrong, _report("bringup", rcs, outs, wrong)


def test_processes_exit_cleanly_after_their_work(tmp_path):
    """Two processes bring up the group, ``psum`` and leave through the
    interpreter's exit; four such pairs at once, five times over: every exit
    code 0, no ``terminate called``.  Without the teardown at exit, gloo's
    threads outlive the interpreter and about one process in twenty of such
    a run aborts with SIGABRT after its ``ok`` line."""
    failures = []
    for r in range(5):
        runs = [_start("bringup", 2, (tmp_path / f"rendezvous{r}_{k}").as_uri(),
                       tmp_path / "unused") for k in range(4)]
        for procs in runs:
            rcs, outs, wrong = _wait(procs)
            if wrong:
                failures.append(_report(f"round {r}", rcs, outs, wrong))
    assert not failures, "\n".join(failures)


def test_initialize_distributed_tears_down_only_its_own_group(tmp_path):
    _run("teardown", 1, (tmp_path / "own").as_uri(), (tmp_path / "callers").as_uri())


def _equal_one_process(case: str, n: int, tmp_path) -> None:
    out = tmp_path / "many.npz"
    outs = _run(case, n, (tmp_path / "rendezvous").as_uri(), out)
    want_groups = len(spanning_groups(case))
    for pid, text in enumerate(outs):
        assert (f"new_group calls {want_groups} after one sweep, {want_groups} "
                f"after {SWEEPS}") in text, _report(case, [0] * n, outs, "new_group")
    got = np.load(out)
    one = build(case, multihost.make_mesh(CASES[case][0], [torch.device("cpu")] * n))
    one.sweep(SWEEPS)
    want = one.arrays()
    assert one.kernel_tier == ("xla" if case == "xla" else "deferred")
    for name in ("z", "ndk", "nwk", "nk"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", ["xla", "deferred", "grid"])
def test_two_processes_equal_one_process_two_positions(tmp_path, case):
    _equal_one_process(case, 2, tmp_path)


def test_two_processes_report_the_one_process_r_hat(tmp_path):
    out = tmp_path / "rhat"
    _run("chain_rhat", 2, (tmp_path / "rendezvous").as_uri(), out)
    one = build("chain_rhat", multihost.make_mesh(
        CASES["chain_rhat"][0], [torch.device("cpu")] * 2))
    want = json.loads(json.dumps(chain_diagnostics(one)))
    assert want["r_hat_phi"]["window_draws"] == 4 and want["r_hat_phi"]["n_cells"] > 0
    for pid in range(2):
        got = json.loads(Path(f"{out}.{pid}.json").read_text())
        assert got == want, pid


@pytest.mark.parametrize("case", ["grid4", "chain4"])
def test_four_processes_equal_one_process_four_positions(tmp_path, case):
    """The groups of two processes out of four (``new_group`` made once
    each, in every process, member or not) carry the sums bitwise."""
    assert len(spanning_groups(case)) == {"grid4": 4, "chain4": 2}[case]
    _equal_one_process(case, 4, tmp_path)


if __name__ == "__main__":
    torch.set_num_threads(1)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
