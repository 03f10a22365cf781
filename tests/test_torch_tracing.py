"""The port's span and counter recorder (``evaluation/tracing.py``) on the
CPU: the recorder itself, the set-up spans of ``LdaModel`` and of
``WarpModel``, the sweep graph's counters, the kernel libraries' load span,
the runner's spans and the CLI's operator output (``--metrics-file``,
``--profile-dir``), and the benchmark's readers of them
(``benchmark/metrics``)."""

from __future__ import annotations

import importlib.util
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.ops import _build
from ldagibbssampling_tpu_torch.runner import run_inference

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
SETUP = ("lda.init", "plan.deferred", "state.init", "sweep_fn.build")
# reader -> (what it reads, the value it gives from ``_populate``)
READERS = {
    "plan_s": ("plan.deferred", 0.25),
    "init_state_s": ("state.init", 1.5),
    "sweep_fn_s": ("sweep_fn.build", 0.75),
    "graph_warm_up_s": ("graph.warm_up", 2.0),
    "graph_capture_s": ("graph.capture", 0.5),
    "handout_bytes_per_sweep": (None, 600.0),
    "warp_init_s": ("warp.init", 3.0),
    "word_csr_s": ("warp.word_csr", 1.25),
    "warp_arg_bytes": (None, 4096.0),
}
WARP_SETUP = ("warp.init", "state.init", "warp.word_csr", "warp.args")


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _corpus(seed=6, docs=24, vocab=50, length=40):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, vocab, size=length)]
              for _ in range(docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def _model(**kw):
    return LdaModel(LdaConfig(topic_num=6, seed=4, block_size=128, **kw), _corpus(),
                    device="cpu")


def _named(name):
    return [s for s in tracing.spans() if s.name == name]


def _inside(child, parent):
    return (child.parent is parent and parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


# ---------------------------------------------------------------- recorder
def test_spans_nest_sum_and_give_self_time():
    with tracing.span("a.outer") as outer:
        with tracing.span("a.inner") as first:
            time.sleep(0.002)
        with tracing.span("a.inner") as second:
            time.sleep(0.002)
    with tracing.span("a.outer") as again:
        pass
    assert [s.name for s in tracing.spans()] == ["a.outer", "a.inner", "a.inner",
                                                 "a.outer"]
    assert first.parent is outer and second.parent is outer and outer.parent is None
    assert again.parent is None
    assert _inside(first, outer) and _inside(second, outer)
    assert tracing.span_seconds("a.inner") == first.seconds + second.seconds
    assert tracing.span_seconds("a.outer") == outer.seconds + again.seconds
    assert tracing.self_seconds("a.outer") == pytest.approx(
        outer.seconds + again.seconds - first.seconds - second.seconds, abs=1e-12)
    assert tracing.self_seconds("a.inner") == tracing.span_seconds("a.inner")
    assert tracing.span_seconds("a.none") is None and tracing.self_seconds("a.none") is None
    assert tracing.span_fields(1) == {"a_inner_s": first.seconds + second.seconds,
                                      "a_outer_s": again.seconds}
    assert tracing.span_fields(skip=("a.in",)) == {
        "a_outer_s": outer.seconds + again.seconds}


def test_open_span_is_kept_but_not_summed_and_exceptions_close_it():
    with tracing.span("b.open"):
        assert len(tracing.spans()) == 1 and tracing.span_seconds("b.open") is None
    with pytest.raises(KeyError):
        with tracing.span("b.raises", device="cpu") as s:
            raise KeyError("x")
    assert s.end_ns is not None and tracing.span_seconds("b.raises") >= 0
    with tracing.span("b.after") as after:
        pass
    assert after.parent is None  # the raising span left the stack


def test_each_thread_has_its_own_parents():
    seen = {}

    def other():
        with tracing.span("c.thread") as s:
            seen["span"] = s

    with tracing.span("c.main"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["span"].parent is None


def test_spans_past_the_cap_are_timed_and_counted(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    kept = []
    for i in range(5):
        with tracing.span(f"d.n{i}") as s:
            kept.append(s)
    assert [s.name for s in tracing.spans()] == ["d.n0", "d.n1", "d.n2"]
    assert tracing.dropped() == 2
    assert kept[4].seconds >= 0 and tracing.span_seconds("d.n4") is None
    tracing.reset()
    assert tracing.dropped() == 0 and tracing.spans() == []


def test_counters_add_and_reset():
    tracing.count("e.calls")
    tracing.count("e.calls")
    tracing.count("e.bytes", 4096)
    assert tracing.counters() == {"e.calls": 2, "e.bytes": 4096}
    copy = tracing.counters()
    copy["e.calls"] = 99
    assert tracing.counters()["e.calls"] == 2
    tracing.reset()
    assert tracing.counters() == {}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Recording:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recording)
    with tracing.span("f.quiet"):
        pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("f.profiled"):
            pass
    assert entered == ["f.profiled"]


def test_setup_spans_appear_in_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model = _model()
        model.sweep(1)
    names = {e.name for e in prof.events()}
    assert set(SETUP) | {"sweep.snapshot"} <= names


# ------------------------------------------------------- model and graph
def test_model_init_records_its_phases_inside_lda_init():
    model = _model()
    assert model.kernel_tier == "deferred"
    (init,) = _named("lda.init")
    for name in SETUP[1:]:
        (child,) = _named(name)
        assert _inside(child, init), name
    children = sum(tracing.span_seconds(n) for n in SETUP[1:])
    assert children <= tracing.span_seconds("lda.init")
    assert tracing.self_seconds("lda.init") == pytest.approx(
        init.seconds - children, abs=1e-9)


def test_model_off_the_deferred_tier_plans_nothing():
    _model(use_pallas="fused")
    assert tracing.span_seconds("plan.deferred") is None
    (init,) = _named("lda.init")
    assert all(_inside(_named(n)[0], init) for n in ("state.init", "sweep_fn.build"))


def test_steady_sweeps_record_no_span_and_count_the_handout():
    model = _model()
    model.sweep(1)  # casts the snapshot: sweep.snapshot
    assert [s.name for s in tracing.spans()][-1] == "sweep.snapshot"
    (graph,) = model._run_sweeps.graphs.values()
    handout = sum(b.numel() * b.element_size() for b in graph.buffers)
    spans, before = len(tracing.spans()), tracing.counters()
    for _ in range(3):
        model.sweep(1)
    after = tracing.counters()
    assert len(tracing.spans()) == spans
    assert after["graph.handout_bytes"] - before["graph.handout_bytes"] == 3 * handout
    # on the CPU nothing is captured or replayed, and back-to-back calls
    # copy nothing in
    assert "graph.replays" not in after and "graph.captures" not in after
    assert "graph.copy_in_bytes" not in after


def test_copy_in_counts_the_tables_a_caller_altered():
    model = _model()
    model.sweep(2)
    assert "graph.copy_in_bytes" not in tracing.counters()
    st = model.state
    model.state = st.__class__(z=st.z.clone(), ndk=st.ndk, nwk=st.nwk, nk=st.nk,
                               sweep=st.sweep, seed=st.seed)
    model.sweep(1)
    tables = (*(getattr(model.state, n) for n in ("z", "ndk", "nwk", "nk")),
              model._mirror)
    want = sum(t.numel() * t.element_size() for t in tables)
    assert tracing.counters()["graph.copy_in_bytes"] == want
    model.sweep(1)
    assert tracing.counters()["graph.copy_in_bytes"] == want


def _warp(**kw):
    from ldagibbssampling_tpu_torch.backends.warp import WarpModel

    return WarpModel(LdaConfig(backend="warp", topic_num=6, seed=4, block_size=128),
                     _corpus(), device="cpu", **kw)


def test_warp_init_records_its_phases_inside_warp_init():
    model = _warp()
    (init,) = _named("warp.init")
    for name in WARP_SETUP[1:]:
        (child,) = _named(name)
        assert _inside(child, init), name
    children = sum(tracing.span_seconds(n) for n in WARP_SETUP[1:])
    assert children <= init.seconds
    assert model.graph is not None


def test_warp_with_a_given_start_draws_no_state():
    start = _warp().state
    tracing.reset()
    _warp(state=start)
    assert tracing.span_seconds("state.init") is None
    assert {s.name for s in tracing.spans()} == set(WARP_SETUP) - {"state.init"}


def _upload_bytes(model):
    """What a construction uploads: the padded word, document and mask
    streams as int32 (12 B a slot) and the document lengths (4 B each)."""
    return 12 * model.state.z.shape[0] + 4 * model.corpus.num_docs


def test_warp_arg_bytes_counts_the_sweeps_arrays_once_a_construction():
    model = _warp()
    want = sum(a.numel() * a.element_size() for a in model._args.values())
    assert want == 52 * model.state.z.shape[0]  # five int64, three 4-byte
    assert tracing.counters() == {"warp.arg_bytes": want,
                                  "warp.upload_bytes": _upload_bytes(model)}
    model.sweep(2)
    assert tracing.counters()["warp.arg_bytes"] == want
    _warp()
    assert tracing.counters()["warp.arg_bytes"] == 2 * want


@pytest.mark.parametrize("given_start", [False, True])
def test_warp_upload_bytes_counts_the_streams_once_a_construction(given_start):
    start = _warp().state if given_start else None
    tracing.reset()
    model = _warp(state=start)
    t_pad, docs = model.state.z.shape[0], model.corpus.num_docs
    assert (t_pad, docs) == (1024, 24)  # 960 tokens padded to blocks of 128
    want = _upload_bytes(model)
    assert want == 12 * 1024 + 4 * 24
    assert tracing.counters()["warp.upload_bytes"] == want
    model.sweep(2)
    assert tracing.counters()["warp.upload_bytes"] == want
    _warp(state=start)
    assert tracing.counters()["warp.upload_bytes"] == 2 * want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_warp_word_csr_waits_for_the_card(cuda, monkeypatch):
    """Each set-up span of ``WarpModel`` waits for the card as it closes:
    the sort's time is ``warp.word_csr``'s, not the next phase's."""
    from ldagibbssampling_tpu_torch.backends.warp import WarpModel

    waited, synchronize = [], torch.cuda.synchronize

    def recording(device=None):
        synchronize(device)
        stack = getattr(tracing._open, "stack", None)
        waited.append(stack[-1].name if stack else None)

    monkeypatch.setattr(torch.cuda, "synchronize", recording)
    WarpModel(LdaConfig(backend="warp", topic_num=6, seed=4, block_size=128),
              _corpus(), device=cuda)
    assert [n for n in waited if n] == list(WARP_SETUP[1:]) + ["warp.init"]


@pytest.mark.parametrize("mode", ["internal", "external"])
def test_warp_sweeps_open_no_span(mode):
    model = _warp(noise_mode=mode)
    t_pad = model.state.z.shape[0]
    spans = len(tracing.spans())
    model.sweep(3, noise=lambda s: torch.full((8, t_pad), 0.5))
    assert len(tracing.spans()) == spans
    # on the CPU nothing is replayed; each call hands its tables out
    handout = sum(b.numel() * b.element_size() for b in model.graph.buffers)
    assert tracing.counters()["graph.handout_bytes"] == handout
    assert "graph.replays" not in tracing.counters()


# ------------------------------------------------------------- kernels
def test_kernel_library_load_is_a_span_only_on_a_miss(monkeypatch):
    from ldagibbssampling_tpu_torch.ops import count_kernel

    count_kernel._plan_lib()  # built and opened (or already)
    tracing.reset()
    count_kernel._plan_lib()
    assert tracing.spans() == [] and tracing.counters() == {}
    monkeypatch.setattr(_build, "_host_libs", {})
    count_kernel._plan_lib()
    assert [s.name for s in tracing.spans()] == ["kernels.load"]
    assert tracing.counters() == {"kernels.loaded": 1}
    count_kernel._plan_lib()
    assert len(tracing.spans()) == 1


def test_kernel_library_build_is_counted(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_libs", {})
    _build.load_host("deferred_plan", lambda lib: None)
    assert tracing.counters() == {"kernels.built": 1, "kernels.loaded": 1}
    (load,) = _named("kernels.load")
    assert load.seconds > 0


# -------------------------------------------------------------- runner
def test_runner_spans_stay_out_of_the_rows(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=4, save_step=2,
                    begin_save_iters=2)
    model = LdaModel(cfg, fc, device="cpu")
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(model, cfg, fc, tmp_path / "res", metrics=log,
                      metrics_every=0, ll_every=2, optimize_hyper_every=2,
                      checkpoint_dir=tmp_path / "ck", checkpoint_every=2)
    names = {s.name for s in tracing.spans()}
    assert {"runner.ll", "runner.hyper", "runner.checkpoint", "runner.save"} <= names
    rows = read_metrics(tmp_path / "m.jsonl")
    assert not any(k.startswith("runner_") for r in rows for k in r)
    # the first row after the first sweep carries the snapshot's cast
    assert "sweep_snapshot_s" in rows[1]
    assert all("sweep_snapshot_s" not in r for r in rows[2:])
    assert all("graph_copy_in_bytes" not in r for r in rows)


class _Altering:
    """A backend whose state a caller replaces before its third call."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def sweep(self, n=1):
        self.calls += 1
        if self.calls == 3:
            st = self.model.state
            self.model.state = st.__class__(
                z=st.z.clone(), ndk=st.ndk, nwk=st.nwk, nk=st.nk, sweep=st.sweep,
                seed=st.seed)
        self.model.sweep(n)


def test_runner_row_flags_a_copy_in_mid_run(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=5)
    backend = _Altering(LdaModel(cfg, fc, device="cpu"))
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(backend, cfg, fc, metrics=log, metrics_every=1)
    rows = read_metrics(tmp_path / "m.jsonl")
    flagged = [r["sweep"] for r in rows if "graph_copy_in_bytes" in r]
    assert flagged == [2]
    assert rows[3]["graph_copy_in_bytes"] == sum(
        t.numel() * t.element_size() for t in (
            *(getattr(backend.model.state, n) for n in ("z", "ndk", "nwk", "nk")),
            backend.model._mirror))


class _Walking:
    """A backend whose sweeps count K1's walks as a card's would: one in
    each form on its second call."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def sweep(self, n=1):
        self.calls += 1
        if self.calls == 2:
            tracing.count("walk.tagged_records")
            tracing.count("walk.two_barrier")
        self.model.sweep(n)


def test_runner_row_carries_the_walk_forms_where_they_moved(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=4)
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(_Walking(LdaModel(cfg, fc, device="cpu")), cfg, fc,
                      metrics=log, metrics_every=1)
    rows = read_metrics(tmp_path / "m.jsonl")
    flagged = [(r["sweep"], r["walk_tagged_records"], r["walk_two_barrier"])
               for r in rows if "walk_tagged_records" in r]
    assert flagged == [(1, 1, 1)]
    assert all(("walk_two_barrier" in r) == ("walk_tagged_records" in r) for r in rows)


# ----------------------------------------------------------------- CLI
def _cli(tmp_path, *extra):
    (tmp_path / "chain.json").write_text(json.dumps({"block_size": 256}))
    return cli.main([
        "--generate-minicorpus", "--docs", str(tmp_path / "docs"), "--no-save",
        "-k", "6", "--iterations", "3", "--device", "cpu",
        "--config-json", str(tmp_path / "chain.json"),
        "--metrics-file", str(tmp_path / "m.jsonl"), *extra])


def test_cli_header_carries_the_setup_spans(tmp_path, capsys):
    assert _cli(tmp_path) == 0
    out = capsys.readouterr().out
    header, *rows = read_metrics(tmp_path / "m.jsonl")
    assert header["kernel_tier"] == "deferred"
    assert header["ingest_s"] == tracing.span_seconds("cli.ingest")
    assert header["setup_s"] == tracing.span_seconds("cli.backend_init")
    assert f"in {header['ingest_s']:.3f}s" in out
    for name in SETUP:
        assert header[name.replace(".", "_") + "_s"] == tracing.span_seconds(name)
    assert not any(k.startswith("cli_") for k in header)
    assert header["kernels_built"] >= 0 and header["kernels_loaded"] >= 0
    (init,) = _named("lda.init")
    assert init.parent is _named("cli.backend_init")[0]
    assert "sweep_snapshot_s" in rows[0]


def test_cli_warp_header_carries_its_setup_spans(tmp_path):
    assert _cli(tmp_path, "--backend", "warp") == 0
    header, *rows = read_metrics(tmp_path / "m.jsonl")
    assert header["setup_s"] == tracing.span_seconds("cli.backend_init")
    for name in WARP_SETUP:
        assert header[name.replace(".", "_") + "_s"] == tracing.span_seconds(name)
    assert "lda_init_s" not in header
    (init,) = _named("warp.init")
    assert init.parent is _named("cli.backend_init")[0]
    assert not any(k.startswith("warp_") for r in rows for k in r)


def test_cli_profile_trace_holds_the_setup_spans(tmp_path):
    assert _cli(tmp_path, "--profile-dir", str(tmp_path / "prof")) == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"cli.backend_init", *SETUP, "sweep.snapshot"} <= names


# ------------------------------------------------- the benchmark's readers
def _reader(name):
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _populate():
    for name, seconds in ((n, s) for n, s in READERS.values() if n):
        with tracing.span(name) as s:
            pass
        s.start_ns, s.end_ns = 0, int(seconds * 1e9)
    tracing.count("graph.replays", 5)
    tracing.count("graph.handout_bytes", 3000)
    tracing.count("warp.arg_bytes", 4096)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_benchmark_reader_reads_the_recorder(metric):
    reader = _reader(metric)
    assert reader.read(None) is None
    _populate()
    assert reader.read(None) == pytest.approx(READERS[metric][1], rel=1e-12)


def test_benchmark_handout_reader_wants_a_replay():
    tracing.count("graph.handout_bytes", 3000)  # eager calls, no replay
    assert _reader("handout_bytes_per_sweep").read(None) is None


def test_counters_and_spans_lose_nothing_across_threads():
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                tracing.count("g.adds")
            for _ in range(20):
                with tracing.span("g.span"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counters() == {"g.adds": 16 * 2000}
    assert len(tracing.spans()) == 16 * 20
