"""Faults planted under the WarpLDA cell's timed path, for the readings its
limits are checked against and for the tests: each wraps the program's
``backends.warp._warp_sweep_``, the body that the model's graph captures,
so that a sweep comes out wrong in one way.

    python3 benchmark/faults_warp.py --workload <name> --fault <name> --seeds 1,2

runs each seed as ``control.py`` does (set-up, ``--sweeps`` sweeps, the
judged sweep) with the fault planted, and prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the sweep's uniform rows: the doc step's and the word step's acceptance
DOC_ACCEPT, WORD_ACCEPT = 3, 7


def _move(ndk, nwk, nk, args: dict, z_from, z_to, one=None) -> None:
    """The tables moved from counting ``z_from`` to counting ``z_to`` (the
    tokens where ``one`` is 1; default: the real ones)."""
    from ldagibbssampling_tpu_torch.ops.gibbs import _scatter_counts

    k = ndk.shape[1]
    _scatter_counts(ndk[None], nwk[None], nk[None], args["token_doc"] * k,
                    args["token_word"] * k,
                    args["token_mask"] if one is None else one,
                    z_from[None], z_to[None])


def word_step_left_out(orig, z, ndk, nwk, nk, u, **args):
    """The word step never accepts: the doc step's topics are the sweep's."""
    u[WORD_ACCEPT].fill_(math.inf)
    orig(z, ndk, nwk, nk, u, **args)


def word_pool_moved(orig, z, ndk, nwk, nk, u, **args):
    """The word proposal draws from the doc step's new topics instead of
    the sweep's starting ones; the tables stay frozen and end exact."""
    start, accept = z.clone(), u[WORD_ACCEPT].clone()
    u[WORD_ACCEPT].fill_(math.inf)
    orig(z, ndk, nwk, nk, u, **args)       # the doc step alone: z moves
    doc_step = z.clone()
    _move(ndk, nwk, nk, args, doc_step, start)     # the frozen tables again
    u[WORD_ACCEPT].copy_(accept)
    u[DOC_ACCEPT].fill_(math.inf)
    orig(z, ndk, nwk, nk, u, **args)       # the word step from them, pooled on them
    _move(ndk, nwk, nk, args, start, doc_step)     # its move was from doc_step


def half_unreconciled(orig, z, ndk, nwk, nk, u, **args):
    """The reconciliation skipped for the second half of the stream: its
    tokens' moves are taken back out of the tables, their topics kept."""
    start = z.clone()
    orig(z, ndk, nwk, nk, u, **args)
    second = args["token_mask"].clone()
    second[:z.shape[0] // 2] = 0
    _move(ndk, nwk, nk, args, z, start, one=second)


FAULTS = {f.__name__: f for f in (word_step_left_out, word_pool_moved,
                                  half_unreconciled)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted in the program while the block runs."""
    import ldagibbssampling_tpu_torch.backends.warp as program

    fault, orig = FAULTS[name], program._warp_sweep_
    program._warp_sweep_ = lambda *a, **kw: fault(orig, *a, **kw)
    try:
        yield
    finally:
        program._warp_sweep_ = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--sweeps", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    driver = spec.driver(cell.traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with planted(args.fault):
            run = driver.build(cell, seed, args.device)
            driver.window(run, sweeps=args.sweeps)
            z_prev = driver.judged_sweep(run)
        values, _ = driver.judge(cell, run, seed, z_prev)
        del run
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "values": values, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
