"""The WarpLDA driver: the port's ``WarpModel.sweep`` in a closed loop over
a corpus drawn from the seed.

Set-up draws the corpus on the device, builds the model through the
program's normal path (``backends.make_backend`` with ``backend="warp"``:
the initial state, the host's word sort, the per-token arrays, the sweep's
graph), runs the first sweep (the graph's capture) and ``warm_sweeps``
more.  The window is the Gibbs driver's (``drivers/gibbs.window``): one
``sweep(1)`` queued ahead, until about ``--seconds`` have passed.

Once the window has closed (and the traced span, with ``--trace 1``) the
model runs one sweep more outside it, through the same graph, with its
topics copied aside before; the model is then freed and its outputs are
judged against ``benchmark/reference_warp.py`` on every real token: the
start, the topics after sweep 1 (the reference's sweep from its own start)
and after that last sweep (from the program's topics before it), and the
count tables after it.

The control (``control.py --chain bfloat16``): the program has no
lower-precision mode, so the same model takes its uniforms through its
external-noise path, each sweep's genuine uniforms rounded toward zero to
bfloat16 (to nearest could give 1.0, a topic past the last); the
acceptance test and the proposals' picks then run at bf16's precision.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check as check_lib
from benchmark import corpus as corpus_lib
from benchmark import reference as ref
from benchmark import reference_warp as ref_warp
from benchmark import roofline_warp
from benchmark import spec
from benchmark import trace as trace_lib
from benchmark.drivers import gibbs
from benchmark.drivers.gibbs import Run, judged_sweep, window

# the tables' scatter-adds (``scatter_add_``), launched by every sweep: a
# traced span that recorded none is profiled again
SCATTER_KERNEL = "scatter_gather_elementwise_kernel"
# the control's override, as control.py passes it
CONTROL = {"kernel_compute_dtype": "bfloat16"}


class _Fed:
    """A model in external-noise mode whose every ``sweep`` is fed by
    ``noise(sweep)``; everything else is the model's."""

    def __init__(self, model, noise: Callable[[int], torch.Tensor]) -> None:
        self.model, self.noise = model, noise

    def sweep(self, n: int = 1) -> None:
        self.model.sweep(n, noise=self.noise)

    def __getattr__(self, name):
        return getattr(self.model, name)


def _bf16_uniforms(seeds: ref.ChainSeeds, t_pad: int, device) -> Callable:
    """Sweep ``s``'s (from 0) genuine uniforms, rounded toward zero to
    bfloat16."""
    def noise(sweep: int) -> torch.Tensor:
        u = ref_warp.sweep_uniforms(seeds.sweep_seed(sweep + 1), t_pad, device)
        return (u.view(torch.int32) & -65536).view(torch.float32)
    return noise


def build(cell, seed: int, device, overrides: Optional[dict] = None) -> Run:
    """Set-up: the corpus from ``seed``, the model, its first sweep and the
    warm-up sweeps.  ``overrides`` is ``None`` or the control."""
    from ldagibbssampling_tpu_torch.backends import make_backend
    from ldagibbssampling_tpu_torch.backends.warp import WarpModel
    from ldagibbssampling_tpu_torch.config import LdaConfig
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus

    c, t = cell.config, cell.traffic
    if (t["backend"], t["noise_mode"]) != ("warp", "internal"):
        raise ValueError(f"this driver runs WarpLDA on its internal noise; the "
                         f"traffic asks {t['backend']!r}, {t['noise_mode']!r}")
    if overrides not in (None, CONTROL):
        raise ValueError(f"the only override is the control {CONTROL}; got {overrides}")
    dev = torch.device(device)
    drawn = corpus_lib.make_corpus(c, seed, dev)
    corpus = dataclasses.replace(drawn, token_word=drawn.token_word.cpu(),
                                 token_doc=drawn.token_doc.cpu())
    del drawn
    flat = FlatCorpus(corpus.token_word.numpy(), corpus.token_doc.numpy(),
                      corpus.doc_ptr.astype(np.int32), corpus.vocab_size)
    cfg = LdaConfig(backend="warp", topic_num=c["topic_num"], alpha=c["alpha"],
                    beta=c["beta"], block_size=t["block_size"], seed=int(seed))
    t0 = time.perf_counter()
    if overrides is None:
        model = make_backend(cfg, flat, device=dev)
    else:
        model = WarpModel(cfg, flat, device=dev, noise_mode="external")
    gibbs._sync(dev)
    model_init_s = time.perf_counter() - t0
    if overrides is not None:
        t_pad = int(model.state.z.shape[0])
        seeds = ref.ChainSeeds(seed, t_pad, c["topic_num"])
        model = _Fed(model, _bf16_uniforms(seeds, t_pad, dev))
    z0 = model.state.z.cpu()
    t0 = time.perf_counter()
    model.sweep(1)
    gibbs._sync(dev)
    first_sweep_s = time.perf_counter() - t0
    z1 = model.state.z.cpu()
    for _ in range(int(t["warm_sweeps"])):
        model.sweep(1)
    gibbs._sync(dev)
    return Run(model=model, corpus=corpus, device=dev, z0=z0, z1=z1,
               sweeps=1 + int(t["warm_sweeps"]), model_init_s=model_init_s,
               first_sweep_s=first_sweep_s)


def judge(cell, run: Run, seed: int, z_prev: torch.Tensor, counts: bool = False
          ) -> tuple[dict, Optional[roofline_warp.SweepCounts]]:
    """The numbers that decide ``correct`` (``benchmark/limits``) after the
    last sweep, which moved ``z_prev``, and, with ``counts``, what that
    sweep did, for the roofline.  Frees the model first: the program's
    outputs are kept, its state is not."""
    c, t = cell.config, cell.traffic
    k = c["topic_num"]
    dev = run.device
    state = run.model.state
    z_last, tables = state.z, (state.ndk, state.nwk, state.nk)
    if run.model.sweeps_done != run.sweeps:
        raise RuntimeError(f"the model counts {run.model.sweeps_done} sweeps, "
                           f"the driver ran {run.sweeps}")
    # the model's graph holds it in a reference cycle (its body is a method)
    run.model = state = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    real = run.corpus.num_tokens
    t_pad = int(z_last.shape[0])
    block = min(int(t["block_size"]), max(1, real))
    if t_pad != max(1, math.ceil(real / block)) * block:  # the stream's padding
        return {name: float(t_pad) for name in cell.limits}, None
    seeds = ref.ChainSeeds(seed, t_pad, k)
    hyper = ref_warp.Hyper(c["alpha"], c["beta"], c["vocab_size"], k)
    stream = ref_warp.Stream(run.corpus.token_word.to(dev), run.corpus.token_doc.to(dev),
                             run.corpus.num_docs, hyper)
    out = {"start_off": float((run.z0 != seeds.z0).sum())}
    for name, sweep, before, after in (
            ("first_draw_off", 1, seeds.z0.to(dev), run.z1.to(dev)),
            ("last_draw_off", run.sweeps, z_prev, z_last)):
        u = ref_warp.sweep_uniforms(seeds.sweep_seed(sweep), t_pad, dev)
        drawn = stream.sweep(before, u)
        del u
        out[name] = float((drawn[:real] != after[:real]).sum()) / max(real, 1)
        del drawn
    for name, want, got in zip(("ndk_off", "nwk_off", "nk_off"),
                               stream.tables(z_last), tables):
        out[name] = float((want != got).sum())
    sweep_counts = None
    if counts:
        sweep_counts = roofline_warp.SweepCounts(
            real=real, moved=int((z_prev[:real] != z_last[:real]).sum()))
    return out, sweep_counts


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        log: Callable[[str], None] = lambda s: None,
        overrides: Optional[dict] = None) -> dict:
    """One run of the cell: the result's keys, ``checks`` last.  On the CPU
    (for tests) the result holds no metric."""
    dev = torch.device(device)
    r = build(cell, seed, dev, overrides)
    setup_s = time.perf_counter() - t_start
    ends: list = []
    n, elapsed = window(r, seconds, ends=ends)
    each = np.diff([0.0] + ends)
    log(f"window: {n} sweeps in {elapsed:.6f} s after a set-up of {setup_s:.6f} s "
        f"(model {r.model_init_s:.6f} s, first sweep {r.first_sweep_s:.6f} s); "
        f"a sweep {each.min():.6f} / {np.median(each):.6f} / {each.max():.6f} s "
        "(least / median / most)")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = None
    if trace and dev.type == "cuda":
        traced_sweeps = max(2, math.ceil(cell.traffic["trace_seconds"] / (elapsed / n)))
        traced, ran = trace_lib.profile(
            lambda k: window(r, sweeps=k), traced_sweeps, SCATTER_KERNEL)
        log(f"traced span: {ran} sweeps; "
            + ("no scatter recorded" if traced is None else
               f"{traced.window_s:.6f} s, device busy {traced.busy_s:.6f} s"))
    t0 = time.perf_counter()
    z_prev = judged_sweep(r)
    values, counts = judge(cell, r, seed, z_prev, counts=trace)
    log(f"the check took {time.perf_counter() - t0:.3f} s")
    correct, checks = check_lib.verdict(values, cell.limits)
    result = {"correct": correct, "attempted": n, "failed": 0}
    if dev.type != "cuda":
        result.update(metrics={}, device={"platform": "cpu", "count": 0})
    elif not trace:
        result["metrics"] = gibbs._pick(cell.end_to_end, {
            "tokens_per_s": r.corpus.num_tokens * n / elapsed, "setup_s": setup_s})
        result["device"] = gibbs._device(dev, peak)
    else:
        ctx = SimpleNamespace(trace=traced, counts=counts, config=cell.config,
                              host={"model_init_s": r.model_init_s,
                                    "first_sweep_s": r.first_sweep_s})
        read = {m["name"]: spec.reader(m["name"]).read(ctx) for m in cell.per_layer}
        result["metrics"] = gibbs._pick(cell.per_layer, read)
        result["device"] = gibbs._device(dev, peak)
        if traced is not None:
            result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
            result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result
