"""The collapsed-Gibbs driver: the port's ``LdaModel.sweep`` in a closed
loop over a corpus drawn from the seed.

Set-up draws the corpus on the device, builds the model through its normal
path (``LdaModel``: ``resolve_tier`` → the deferred layout, the initial
state, the sweep function), runs the first sweep (the graph's capture) and
``warm_sweeps`` more.  The window then calls ``sweep(1)`` back to back and
keeps one sweep queued ahead: after queueing sweep n it waits for the end
of sweep n - 1 and reads the clock; it ends with the first sweep expected
to end past ``--seconds`` (the last one's length ahead), waited for, so
within about one sweep of it.

Once the window has closed (and the traced span, with ``--trace 1``) the
model runs one sweep more outside it, through the same graph, with its
topics copied aside before; the program's outputs are judged against
``benchmark/reference.py``: the start (the initial topics), the layout, the
draws of a sample of tiles of the first sweep (from the reference's own
start) and of that last sweep (from the program's topics before it), and
the count tables and the bf16 snapshot after it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check as check_lib
from benchmark import corpus as corpus_lib
from benchmark import reference as ref
from benchmark import roofline
from benchmark import spec
from benchmark import trace as trace_lib

# K1's CUDA kernel: a traced span that recorded none is profiled again
WALK_KERNEL = "gibbs_walk"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Run:
    """A built model and what set-up kept for the check."""

    model: object
    corpus: corpus_lib.Corpus     # on the host
    device: torch.device
    z0: torch.Tensor              # the program's topics before sweep 1 (host)
    z1: torch.Tensor              # after sweep 1 (host)
    sweeps: int                   # sweeps run so far
    model_init_s: float
    first_sweep_s: float


def lda_config(cell, seed: int, overrides: Optional[dict] = None):
    """The port's ``LdaConfig`` of a cell: the configuration's model and
    precision, the traffic's tier and block, the seed."""
    from ldagibbssampling_tpu_torch.config import LdaConfig

    c, t = cell.config, cell.traffic
    kw = dict(topic_num=c["topic_num"], alpha=c["alpha"], beta=c["beta"],
              kernel_compute_dtype=c["kernel_compute_dtype"],
              mirror_dtype=c["mirror_dtype"], use_pallas=t["use_pallas"],
              block_size=t["block_size"], seed=int(seed))
    kw.update(overrides or {})
    return LdaConfig(**kw)


def build(cell, seed: int, device, overrides: Optional[dict] = None) -> Run:
    """Set-up: the corpus from ``seed``, the model, its first sweep and the
    warm-up sweeps.  Raises where the tier that resolves is not the one the
    traffic runs."""
    from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
    from ldagibbssampling_tpu_torch.models.lda import LdaModel

    t = cell.traffic
    unsupported = {k: t[k] for k, ok in (("chains", 1), ("start", "uniform"),
                                         ("ll_every", 0), ("optimize_hyper_every", 0))
                   if t[k] != ok}
    if unsupported:
        raise ValueError(f"this driver runs one chain from a uniform start with "
                         f"no LL or hyperparameter update; the traffic asks {unsupported}")
    dev = torch.device(device)
    drawn = corpus_lib.make_corpus(cell.config, seed, dev)
    # the reference reads the corpus after the window: the host keeps it
    corpus = dataclasses.replace(drawn, token_word=drawn.token_word.cpu(),
                                 token_doc=drawn.token_doc.cpu())
    del drawn
    flat = FlatCorpus(corpus.token_word.numpy(), corpus.token_doc.numpy(),
                      corpus.doc_ptr.astype(np.int32), corpus.vocab_size)
    t0 = time.perf_counter()
    model = LdaModel(lda_config(cell, seed, overrides), flat, device=dev)
    _sync(dev)
    model_init_s = time.perf_counter() - t0
    want = cell.traffic["expect_tier"]
    if model.kernel_tier != want:
        raise RuntimeError(f"the model resolved the {model.kernel_tier!r} tier; "
                           f"this traffic runs {want!r}")
    z0 = model.state.z.cpu()
    t0 = time.perf_counter()
    model.sweep(1)
    _sync(dev)
    first_sweep_s = time.perf_counter() - t0
    z1 = model.state.z.cpu()
    for _ in range(int(cell.traffic["warm_sweeps"])):
        model.sweep(1)
    _sync(dev)
    return Run(model=model, corpus=corpus, device=dev, z0=z0, z1=z1,
               sweeps=1 + int(cell.traffic["warm_sweeps"]),
               model_init_s=model_init_s, first_sweep_s=first_sweep_s)


class _Done:
    """A sweep's end on the card (a CUDA event); on the CPU the sweep has
    ended when its call returns."""

    def __init__(self, dev: torch.device) -> None:
        self.event = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def window(run: Run, seconds: float = math.inf, sweeps: Optional[int] = None,
           ends: Optional[list] = None) -> tuple[int, float]:
    """Sweeps back to back, one queued ahead, until about ``seconds`` have
    passed (the last sweep is the one expected to end past them) or
    ``sweeps`` sweeps; returns the sweeps and their seconds, from the
    window's start to the end of its last sweep (each sweep's end, as the
    host saw it, appended to ``ends``)."""
    n, ahead, t0, seen = 0, None, time.perf_counter(), 0.0
    while True:
        with torch.profiler.record_function("bench.sweep"):
            run.model.sweep(1)
        done = _Done(run.device)
        n += 1
        run.sweeps += 1
        last = sweeps is not None and n >= sweeps
        if ahead is not None:
            with torch.profiler.record_function("bench.wait"):
                ahead.wait()
            elapsed = time.perf_counter() - t0
            if ends is not None:
                ends.append(elapsed)
            # the sweep queued now ends about one sweep after this one
            last = last or 2 * elapsed - seen >= seconds
            seen = elapsed
        if last:
            with torch.profiler.record_function("bench.wait"):
                done.wait()
                _sync(run.device)
            elapsed = time.perf_counter() - t0
            if ends is not None:
                ends.append(elapsed)
            return n, elapsed
        ahead = done


def judged_sweep(run: Run) -> torch.Tensor:
    """One sweep more, outside the window, through the same model and
    graph: returns the topics before it (a copy), for the check."""
    z_prev = run.model.state.z.clone()
    run.model.sweep(1)
    run.sweeps += 1
    _sync(run.device)
    return z_prev


def judge(cell, run: Run, seed: int, z_prev: torch.Tensor, counts: bool = False
          ) -> tuple[dict, Optional[roofline.SweepCounts]]:
    """The numbers that decide ``correct`` (``benchmark/limits``) after the
    last sweep, which moved ``z_prev``, and, with ``counts``, what that
    sweep did, for the rooflines.  Frees the model first: the program's
    outputs are kept, its state is not."""
    c, t = cell.config, cell.traffic
    k, v, block = c["topic_num"], c["vocab_size"], t["block_size"]
    model, dev = run.model, run.device
    z_last = model.state.z
    tables = (model.state.ndk, model.state.nwk, model.state.nk)
    mirror = getattr(model, "_mirror", None)  # the sweep-stale bf16 snapshot
    z_corpus = torch.from_numpy(np.ascontiguousarray(model.z())).to(dev)
    if model.sweeps_done != run.sweeps:
        raise RuntimeError(f"the model counts {model.sweeps_done} sweeps, "
                           f"the driver ran {run.sweeps}")
    run.model = model = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    word, doc = run.corpus.token_word.to(dev), run.corpus.token_doc.to(dev)
    layout = ref.plan_layout(word, doc, v, block)
    del word, doc
    if layout.t_pad != z_last.shape[0]:
        total = float(layout.t_pad + z_last.shape[0])
        return {name: total for name in cell.limits}, None
    seeds = ref.ChainSeeds(seed, layout.t_pad, k)
    index = ref.DocIndex(layout, run.corpus.num_docs)
    rows = ref.row_tile(block, k)
    hyper = ref.Hyper(c["alpha"], c["beta"], v, k)
    real = layout.mask
    out = {
        "start_off": float((run.z0 != seeds.z0).sum()),
        "layout_off": float((z_last[real] != z_corpus[layout.perm[real]]).sum()),
    }
    del z_corpus
    n_tiles = layout.t_pad // rows
    size = min(n_tiles, max(1, int(t["check_tokens"]) // rows))
    for name, sweep, before, after in (
            ("first_draw_off", 1, seeds.z0.to(dev), run.z1.to(dev)),
            ("last_draw_off", run.sweeps, z_prev, z_last)):
        rng = np.random.default_rng([int(seed) & (2**63 - 1), sweep])
        tiles = sorted(int(x) for x in rng.choice(n_tiles, size=size, replace=False))
        compared, differ = ref.tile_draws(layout, index, before, after, tiles, rows,
                                          seeds.sweep_seed(sweep), hyper)
        out[name] = differ / max(compared, 1)
    ndk, nwk, nk = tables
    out["ndk_off"] = float(ref.doc_topic_cells_off(layout, index, z_last, ndk))
    out["nwk_off"] = float((ref.word_topic_counts(layout, z_last, v, k)
                            != nwk.long()).sum())
    out["nk_off"] = float((torch.bincount(z_last[real].long(), minlength=k)
                           != nk.long()).sum())
    want = ref.snapshot(ref.word_topic_counts(layout, z_last, v, k), layout.v_pad,
                        ref.round_up(k, 128))
    out["mirror_off"] = (float((mirror.float() != want).sum())
                         if mirror is not None and mirror.shape == want.shape
                         else float(want.numel()))
    del want, mirror
    sweep_counts = None
    if counts:
        sweep_counts = roofline.sweep_counts(
            layout.word, layout.doc, real, z_prev, z_last, block=block,
            row_tile=rows, num_topics=k, v_pad=layout.v_pad)
    return out, sweep_counts


def _device(dev: torch.device, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        log: Callable[[str], None] = lambda s: None,
        overrides: Optional[dict] = None) -> dict:
    """One run of the cell: the result's keys, ``checks`` last.  On the CPU
    (the plain versions, for tests) the result holds no metric."""
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
        per_sweep = elapsed / n
        traced_sweeps = max(2, math.ceil(cell.traffic["trace_seconds"] / per_sweep))
        traced, ran = trace_lib.profile(
            lambda k: window(r, sweeps=k), traced_sweeps, WALK_KERNEL)
        log(f"traced span: {ran} sweeps; "
            + ("no walk recorded" if traced is None else
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
        tokens = r.corpus.num_tokens
        result["metrics"] = _pick(cell.end_to_end, {
            "tokens_per_s": tokens * n / elapsed, "setup_s": setup_s})
        result["device"] = _device(dev, peak)
    else:
        ctx = SimpleNamespace(trace=traced, counts=counts, config=cell.config,
                              host={"model_init_s": r.model_init_s,
                                    "first_sweep_s": r.first_sweep_s})
        read = {m["name"]: spec.reader(m["name"]).read(ctx) for m in cell.per_layer}
        result["metrics"] = _pick(cell.per_layer, read)
        result["device"] = _device(dev, peak)
        if traced is not None:
            result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
            result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def _pick(entries: list[dict], values: dict) -> dict:
    """``{name: {"value", "unit"}}`` of the entries with a value."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in entries if values.get(m["name"]) is not None}
