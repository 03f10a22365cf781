"""The port's entry points on the CPU: ``LdaModel``, the artifacts, the CLI,
the device default and the import boundary (the port imports neither jax nor
the JAX package).  Artifacts must be byte-identical to the JAX writer's for
the same ``phi``/``theta``/``z`` (same code, same float formatting)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.documents import Documents as JaxDocuments
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.lda_io.artifacts import (
    save_iterated_model as jax_save_iterated_model)
from ldagibbssampling_tpu_torch import cli
from ldagibbssampling_tpu_torch.backends import make_backend
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.documents import Documents
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.evaluation.tracing import MetricsLog, read_metrics
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.runner import run_inference

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ldagibbssampling_tpu_torch"
ARTIFACTS = ("params", "phi", "theta", "tassign", "twords")


def _corpus(seed=6, docs=24, vocab=50, length=40):
    rng = np.random.default_rng(seed)
    ragged = [[int(x) for x in rng.integers(0, vocab, size=length)]
              for _ in range(docs)]
    return FlatCorpus.from_ragged(ragged, vocab_size=vocab)


def test_model_sweeps_and_counts_consistent():
    fc = _corpus()
    model = LdaModel(LdaConfig(topic_num=6, seed=4, block_size=128), fc,
                     device="cpu")
    assert model.kernel_tier == "deferred"
    model.sweep(3)
    assert model.sweeps_done == 3
    model.check_counts_consistent()
    z = model.z()
    assert z.shape == (fc.num_tokens,)
    nwk = np.zeros((50, 6), np.int64)
    np.add.at(nwk, (fc.token_word, z), 1)
    np.testing.assert_array_equal(model.state.nwk.numpy(), nwk)
    phi, theta = model.phi(), model.theta()
    assert phi.shape == (6, 50) and theta.shape == (24, 6)
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-4)


def test_batched_sweeps_match_looped():
    # sweep(5) carries the snapshot and draws five seeds from the model's
    # generator; five sweep(1) calls must give the same chain
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, seed=4, block_size=128)
    a = LdaModel(cfg, fc, device="cpu")
    a.sweep(5)
    b = LdaModel(cfg, fc, device="cpu")
    for _ in range(5):
        b.sweep(1)
    assert torch.equal(a.state.z, b.state.z)
    assert torch.equal(a.state.nwk, b.state.nwk)


def test_artifacts_byte_identical_to_reference_writer(tmp_path):
    fc = _corpus(seed=2)
    cfg = LdaConfig(topic_num=5, seed=1, block_size=256, iteration=60)
    model = LdaModel(cfg, fc, device="cpu")
    model.sweep(2)
    model.save_iterated_model(7, tmp_path / "port")
    jfc = JaxFlatCorpus(fc.token_word, fc.token_doc, fc.doc_ptr, fc.vocab_size)
    jcfg = JaxLdaConfig(topic_num=5, seed=1, block_size=256, iteration=60)
    jax_save_iterated_model(tmp_path / "ref", 7, model.phi(), model.theta(),
                            model.z(), jfc, jcfg)
    for ext in ARTIFACTS:
        got = (tmp_path / "port" / f"lda_7.{ext}").read_bytes()
        assert got == (tmp_path / "ref" / f"lda_7.{ext}").read_bytes(), ext


def test_ingest_equals_reference(tmp_path):
    docs = write_minicorpus(tmp_path / "docs")
    fc = FlatCorpus.from_documents(Documents().read_docs(docs))
    ref = JaxFlatCorpus.from_documents(JaxDocuments().read_docs(docs))
    for name in ("token_word", "token_doc", "doc_ptr"):
        np.testing.assert_array_equal(getattr(fc, name), getattr(ref, name))
    assert fc.vocab == ref.vocab and fc.vocab_size == ref.vocab_size


def test_cli_runs_end_to_end_on_cpu(tmp_path, capsys):
    rc = cli.main([
        "--generate-minicorpus", "--docs", str(tmp_path / "docs"),
        "--results", str(tmp_path / "res"), "-k", "10", "--iterations", "60",
        "--save-step", "10", "--begin-save-iters", "50", "--check-counts",
        "--device", "cpu", "--metrics-file", str(tmp_path / "m.jsonl"),
        "--metrics-every", "20",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "count tables bitwise-consistent" in out and "Iteration 59" in out
    for it in (50, 60):
        for ext in ARTIFACTS:
            assert (tmp_path / "res" / f"lda_{it}.{ext}").stat().st_size > 0
    rows = read_metrics(tmp_path / "m.jsonl")
    # the minicorpus's token count is no multiple of 8: no deferred layout,
    # so the port runs the reference's tier for it, the fused tier
    assert rows[0]["kernel_tier"] == "fused"
    assert [r["sweep"] for r in rows[1:]] == [19, 39, 49, 59]


@pytest.mark.parametrize("flags,name", [
    (["--checkpoint-every", "5"], "--checkpoint-every"),
    (["--backend", "cvb0"], "--backend"),
    (["--chains", "2"], "--chains"),
    (["--mesh", "data=2"], "--mesh"),
    (["--infer-docs", "x"], "--infer-docs"),
    (["--resume"], "--resume"),
])
def test_cli_refuses_unported_flags(tmp_path, monkeypatch, capsys, flags, name):
    """Named for the refusals the CLI once had: ``--backend``, ``--chains``,
    ``--mesh`` (one shard on the CPU's one position, as the reference on one
    device), the checkpoint and fold-in flags run, and ``--resume`` without
    ``--checkpoint-dir`` exits 2 with the reference's message."""
    monkeypatch.chdir(tmp_path)  # --no-save writes inferred.* here
    docs = write_minicorpus(tmp_path / "docs", num_docs=6)
    if name == "--infer-docs":
        flags = ["--infer-docs", str(docs)]
    base = ["--docs", str(docs), "--no-save", "-k", "3", "--iterations", "5",
            "--device", "cpu"]
    if name == "--checkpoint-every":
        base += ["--checkpoint-dir", str(tmp_path / "ck")]
    rc = cli.main([*base, *flags])
    out, err = capsys.readouterr()
    if name == "--resume":
        assert rc == 2
        assert "error: --resume requires --checkpoint-dir" in err
    else:
        assert rc == 0, err
        if name == "--checkpoint-every":
            assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["5"]
        elif name in ("--backend", "--chains", "--mesh"):
            assert "Done: 5 sweeps" in out
        else:
            assert "Inferred 6 new docs" in out
            assert (tmp_path / "inferred.theta").stat().st_size > 0


@pytest.mark.parametrize("flags", [["--chains", "4"], ["--mesh", "data=2"]])
def test_cli_serial_sampler_ignores_chains_and_mesh(tmp_path, capsys, flags):
    # as the reference: the oracle runs, chains and mesh unused
    rc = cli.main(["--generate-minicorpus", "--docs", str(tmp_path / "d"),
                   "--no-save", "-k", "3", "--iterations", "2", "--device",
                   "cpu", "--sampler", "serial", "--check-counts",
                   "--metrics-file", str(tmp_path / "m.jsonl"), *flags])
    assert rc == 0, capsys.readouterr().err
    assert read_metrics(tmp_path / "m.jsonl")[0]["kernel_tier"] == "serial-oracle"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LdaModel(cfg, fc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_backend(cfg, fc)


@pytest.mark.parametrize("field,value", [
    ("backend", "svi"), ("chains", 2), ("mesh", {"data": 2}),
    ("backend", "cvb0"), ("backend", "warp"), ("backend", "smc"),
])
def test_config_rejects_unported_paths(field, value):
    """Named for the mesh it once rejected: every path runs now.  Each
    builds through ``make_backend`` on the CPU and sweeps twice (a blocked
    sampler's mesh: the document-sharded runtime, one shard on the CPU's
    one position, its counts exact); the serial oracle ignores a mesh or
    chains, as the reference's ``make_backend``; the Pallas interpreter
    has no counterpart and is refused."""
    cfg = LdaConfig(topic_num=4, block_size=128, **{field: value})
    model = make_backend(cfg, _corpus(docs=6), device="cpu")
    model.sweep(2)
    assert model.sweeps_done == 2
    phi = model.phi()
    assert phi.shape == (4, 50) and np.isfinite(phi).all()
    if field == "mesh":
        assert type(model).__name__ == "ShardedLda" and model.mesh.size == 1
        model.check_counts_consistent()
        with pytest.raises(NotImplementedError, match="pallas_interpret"):
            LdaConfig(pallas_interpret=True, **{field: value})
    if field in ("chains", "mesh"):
        cfg = LdaConfig(sampler="serial", topic_num=4, **{field: value})
        model = make_backend(cfg, _corpus(docs=3), device="cpu")
        assert model.kernel_tier == "serial-oracle"
        model.sweep(2)
        assert model.sweeps_done == 2
        model.check_counts_consistent()


@pytest.mark.parametrize("field,value,tier", [
    ("use_pallas", "fused", "fused"), ("use_pallas", False, "xla"),
    ("sampler", "serial", "serial-oracle"), ("draw_method", "inverse_cdf", "xla"),
    ("kernel_compute_dtype", "bfloat16", "deferred"),
    ("mirror_dtype", "float32", "deferred"),
])
def test_config_of_ported_paths_builds_a_model_that_sweeps(field, value, tier):
    model = LdaModel(LdaConfig(topic_num=6, block_size=128, **{field: value}),
                     _corpus(), device="cpu")
    assert model.kernel_tier == tier
    model.sweep(2)
    assert model.sweeps_done == 2
    model.check_counts_consistent()
    assert model.z().shape == (960,)


@pytest.mark.parametrize("block,docs", [(64, 24), (2048, 2)])
def test_blocks_below_128_raise(block, docs):
    # a small configured block, or a corpus shorter than 128 tokens: the
    # reference runs its XLA sweep there, and so does the port
    fc = _corpus(docs=docs)
    model = LdaModel(LdaConfig(topic_num=6, block_size=block), fc, device="cpu")
    assert model.kernel_tier == "xla"
    assert model.block_size == min(block, fc.num_tokens)
    model.sweep(2)
    model.check_counts_consistent()


def test_runner_refuses_unported_branches(tmp_path):
    """The checkpoint branch: a save after every ``checkpoint_every``-th
    sweep, none without a directory or a cadence."""
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=7)
    model = LdaModel(cfg, fc, device="cpu")
    run_inference(model, cfg, fc, checkpoint_dir=tmp_path / "ck",
                  checkpoint_every=3)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["3", "6"]
    for kw in (dict(checkpoint_every=1), dict(checkpoint_dir=tmp_path / "no")):
        run_inference(LdaModel(cfg, fc, device="cpu"), cfg, fc, **kw)
    assert not (tmp_path / "no").exists()


def test_runner_runs_ll_and_hyper_branches(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=4)
    model = LdaModel(cfg, fc, device="cpu")
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(model, cfg, fc, metrics=log, metrics_every=0,
                      ll_every=2, optimize_hyper_every=2)
    rows = read_metrics(tmp_path / "m.jsonl")
    assert [r["sweep"] for r in rows] == [0, 1, 3]
    assert all(np.isfinite(r["log_likelihood"]) for r in rows[1:])
    assert (model.alpha, model.beta) != (0.5, 0.1)
    assert rows[-1]["alpha"] == model.alpha
    model.check_counts_consistent()


def test_runner_metrics_rows(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, block_size=128, iteration=6)
    model = LdaModel(cfg, fc, device="cpu")
    with MetricsLog(tmp_path / "m.jsonl") as log:
        run_inference(model, cfg, fc, metrics=log, metrics_every=3)
    rows = read_metrics(tmp_path / "m.jsonl")
    assert [r["sweep"] for r in rows] == [0, 2, 5]
    assert rows[1]["sweeps_in_chunk"] == 3 and rows[1]["tokens_per_s"] > 0
    assert model.sweeps_done == 6


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "ldagibbssampling_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {n}")
    assert not bad, bad


def test_package_imports_and_runs_with_jax_blocked(tmp_path):
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ldagibbssampling_tpu'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from ldagibbssampling_tpu_torch import cli\n"
        f"rc = cli.main(['--generate-minicorpus', '--docs', {str(tmp_path / 'd')!r},"
        f" '--no-save', '-k', '5', '--iterations', '2', '--device', 'cpu',"
        " '--check-counts'])\n"
        "assert rc == 0, rc\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ldagibbssampling_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_public_api_covers_the_jax_package():
    """Every symbol the JAX package exports, the port exports from a module
    of its own."""
    import ldagibbssampling_tpu as reference
    import ldagibbssampling_tpu_torch as port

    missing = sorted(set(reference._EXPORTS) - set(port._EXPORTS))
    assert not missing, missing
    assert sorted(port.__all__) == sorted([*port._EXPORTS, "__version__"])
    for name, module in port._EXPORTS.items():
        assert module.startswith("ldagibbssampling_tpu_torch."), (name, module)
        obj = getattr(port, name)
        assert obj.__module__.startswith("ldagibbssampling_tpu_torch."), (
            name, obj.__module__)


# JAX-package names the port deliberately has no counterpart of (ROADMAP.md's
# module map says why), by module
NO_COUNTERPART = {
    "ldagibbssampling_tpu.models.state": {"host_randint"},  # takes a JAX key
    "ldagibbssampling_tpu.ops.count_kernel": {"replicate_rows"},  # TPU sublanes
    "ldagibbssampling_tpu.ops.gibbs": {"warn_tier_downgrade"},  # platform rule
    "ldagibbssampling_tpu.utils.jaxcache": {"enable_compilation_cache"},  # ops/_build
}
JAX_PACKAGE = REPO / "ldagibbssampling_tpu"


def _lazy_names(init: Path) -> set[str]:
    """The names a package's ``__getattr__`` resolves lazily (the strings
    it compares ``name`` with)."""
    out = set()
    for node in ast.walk(ast.parse(init.read_text())):
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for cmp in (c for c in ast.walk(node) if isinstance(c, ast.Compare)):
                out |= {c.value for c in ast.walk(cmp)
                        if isinstance(c, ast.Constant) and isinstance(c.value, str)}
    return out


@pytest.mark.parametrize("subpackage", sorted(
    [p.name for p in JAX_PACKAGE.iterdir() if (p / "__init__.py").is_file()]
    + ["(top-level modules)"]))
def test_subpackage_names_resolve_in_the_port(subpackage):
    """Each module of a JAX subpackage: its exports (``__all__`` and the
    names its package resolves lazily) and the functions and classes it
    defines resolve in the port's module of the same path, each to an
    object of the port's own, apart from ``NO_COUNTERPART``."""
    import importlib
    import inspect

    paths = (sorted(JAX_PACKAGE.glob("*.py")) if subpackage.startswith("(")
             else sorted((JAX_PACKAGE / subpackage).rglob("*.py")))
    checked, missing = 0, []
    for path in paths:
        name = ".".join(path.relative_to(REPO).with_suffix("").parts)
        name = name.removesuffix(".__init__")
        if name == "ldagibbssampling_tpu":
            continue  # the root's exports: test_public_api_covers_the_jax_package
        ref = importlib.import_module(name)
        names = set(getattr(ref, "__all__", ())) | _lazy_names(path)
        names |= {n for n, v in vars(ref).items() if not n.startswith("_")
                  and (inspect.isfunction(v) or inspect.isclass(v))
                  and v.__module__ == name}
        names -= NO_COUNTERPART.get(name, set())
        if not names:
            continue
        port = importlib.import_module(name.replace(
            "ldagibbssampling_tpu", "ldagibbssampling_tpu_torch", 1))
        for n in sorted(names):
            obj = getattr(port, n, None)
            if obj is None or not getattr(obj, "__module__", port.__name__).startswith(
                    "ldagibbssampling_tpu_torch"):
                missing.append(f"{name}.{n}")
            checked += 1
    assert not missing, missing
    assert checked or subpackage == "benchmarks"
