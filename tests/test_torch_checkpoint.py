"""The port's checkpoints (``lda_io/checkpoint.py``, ``LdaModel``'s save and
restore, the runner's branch, ``--checkpoint-*``/``--resume``) against the
JAX package's orbax checkpoints, and kill-and-resume in every tier.

Tolerances, all exact: a state carried across the packages
(``interop.from_jax_state``) and through the port's ``save_run`` and
``restore_run`` equals the reference's orbax restore of the same state,
arrays bitwise and α, β as floats; ``latest_step`` and the kept steps equal
orbax's (``max_to_keep=3``); a resumed port chain equals its uninterrupted
run bitwise (``z`` and every count table, α and β), and a resumed CLI run's
artifacts equal the uninterrupted run's byte for byte.  This mirrors
``tests/test_checkpoint.py`` and ``tests/test_resume_cli.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ldagibbssampling_tpu.config import LdaConfig as JaxLdaConfig
from ldagibbssampling_tpu.corpus.flat import FlatCorpus as JaxFlatCorpus
from ldagibbssampling_tpu.lda_io import checkpoint as jax_ckpt
from ldagibbssampling_tpu.models.lda import LdaModel as JaxLdaModel
from ldagibbssampling_tpu_torch import cli, interop
from ldagibbssampling_tpu_torch.config import LdaConfig
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.data import write_minicorpus
from ldagibbssampling_tpu_torch.lda_io import checkpoint as ckpt
from ldagibbssampling_tpu_torch.models.lda import LdaModel
from ldagibbssampling_tpu_torch.models.state import init_state
from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn
from ldagibbssampling_tpu_torch.runner import run_inference

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

ARRAYS = ("z", "ndk", "nwk", "nk")
ARTIFACTS = ("params", "phi", "theta", "tassign", "twords")


def _ragged(seed=0, docs=10, vocab=30, length=20):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, size=length)]
            for _ in range(docs)], vocab


def _corpus(seed=6, docs=24, vocab=50, length=40):
    ragged, v = _ragged(seed, docs, vocab, length)
    return FlatCorpus.from_ragged(ragged, vocab_size=v)


def _assert_same_state(a, b):
    for name in ARRAYS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.sweep) == int(b.sweep)


def test_save_restore_run_equals_reference(tmp_path):
    ragged, v = _ragged()
    jfc = JaxFlatCorpus.from_ragged(ragged, vocab_size=v)
    jcfg = JaxLdaConfig(topic_num=4, seed=0, block_size=32)
    ref = JaxLdaModel(jcfg, jfc)
    ref.sweep(5)
    ref.optimize_hyperparameters()
    assert (ref.alpha, ref.beta) != (0.5, 0.1)
    assert jax_ckpt.save_run(tmp_path / "ref", ref.state, ref.alpha, ref.beta) == 5
    r_state, r_alpha, r_beta = jax_ckpt.restore_run(
        tmp_path / "ref", JaxLdaModel(jcfg, jfc).state)

    arrays = {n: np.asarray(getattr(ref.state, n)) for n in (*ARRAYS, "sweep")}
    state = interop.from_jax_state(arrays, seed=11, device="cpu")
    assert ckpt.save_run(tmp_path / "port", state, ref.alpha, ref.beta) == 5
    like = interop.from_jax_state({**arrays, "sweep": 0}, device="cpu")
    got, alpha, beta, gen_state = ckpt.restore_run(tmp_path / "port", like)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(r_state, name)))
    assert got.sweep == int(r_state.sweep) == 5 and got.seed == 11
    assert (alpha, beta) == (r_alpha, r_beta) == (ref.alpha, ref.beta)
    assert gen_state is None


def _kept(directory):
    return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit())


def test_latest_step_and_kept_steps_equal_orbax(tmp_path):
    ragged, v = _ragged()
    ref = JaxLdaModel(JaxLdaConfig(topic_num=4, seed=0, block_size=32),
                      JaxFlatCorpus.from_ragged(ragged, vocab_size=v))
    state = interop.from_jax_state(
        {n: np.asarray(getattr(ref.state, n)) for n in (*ARRAYS, "sweep")}, device="cpu")
    for step in (1, 2, 3, 4, 5, 3):  # the last: not above the latest, skipped
        ref.state = dataclasses.replace(ref.state, sweep=np.int32(step))
        state.sweep = step
        assert jax_ckpt.save_run(tmp_path / "ref", ref.state, 0.5, 0.1) == step
        assert ckpt.save_run(tmp_path / "port", state, 0.5, 0.1) == step
        assert ckpt.latest_step(tmp_path / "port") == jax_ckpt.latest_step(
            tmp_path / "ref")
    assert _kept(tmp_path / "port") == _kept(tmp_path / "ref") == [3, 4, 5]
    assert ckpt.latest_step(tmp_path / "port") == 5
    assert ckpt.restore_run(tmp_path / "port", state, step=4)[0].sweep == 4


@pytest.mark.parametrize("kind", ["missing", "empty"])
def test_latest_step_none_as_orbax(tmp_path, kind):
    d = tmp_path / "ckpt"
    if kind == "empty":
        d.mkdir()
    assert ckpt.latest_step(d) is None
    assert jax_ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, interop.from_jax_state(
            {"z": [0], "ndk": [[1]], "nwk": [[1]], "nk": [1], "sweep": 0}, device="cpu"))


def test_kill_and_resume_reproduces_chain(tmp_path):
    # tests/test_checkpoint.py:35 at the sweep function, the generator that
    # seeds each sweep saved beside the state
    fc = FlatCorpus.from_ragged([[0, 1, 2, 1], [2, 3, 3, 0, 1], [4, 4, 0],
                                 [1, 2, 4, 3, 3, 0]], vocab_size=5)
    pc = fc.pad_to(4)
    state = init_state(pc.token_word, pc.token_doc, pc.token_mask,
                       num_docs=pc.num_docs, vocab_size=pc.vocab_size,
                       num_topics=3, seed=9, device="cpu")
    run = make_sweep_fn(pc.token_word, pc.token_doc, pc.token_mask,
                        fc.doc_lengths(), alpha=0.5, beta=0.1, block_size=4,
                        use_pallas=False, num_topics=3, device="cpu")
    gen = torch.Generator().manual_seed(state.seed)
    straight = run(state, n_sweeps=6, generator=gen)

    gen = torch.Generator().manual_seed(state.seed)
    s = run(state, n_sweeps=3, generator=gen)
    assert ckpt.save_run(tmp_path / "ckpt", s, 0.5, 0.1, generator=gen) == 3
    assert ckpt.latest_step(tmp_path / "ckpt") == 3
    restored, _, _, gen_state = ckpt.restore_run(tmp_path / "ckpt", like=state)
    _assert_same_state(restored, s)
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    _assert_same_state(run(restored, n_sweeps=3, generator=gen2), straight)


def test_save_checkpoint_round_trips_the_state(tmp_path):
    fc = _corpus()
    model = LdaModel(LdaConfig(topic_num=6, seed=2, block_size=128), fc,
                     device="cpu")
    model.sweep(2)
    assert ckpt.save_checkpoint(tmp_path / "c", model.state) == 2
    fresh = LdaModel(LdaConfig(topic_num=6, seed=3, block_size=128), fc,
                     device="cpu")
    got = ckpt.restore_checkpoint(tmp_path / "c", fresh.state)
    _assert_same_state(got, model.state)
    assert got.seed == model.state.seed != fresh.state.seed
    bad = LdaModel(LdaConfig(topic_num=5, seed=2, block_size=128), fc,
                   device="cpu")
    with pytest.raises(ValueError, match="ndk"):
        ckpt.restore_checkpoint(tmp_path / "c", bad.state)


@pytest.mark.parametrize("use_pallas,tier", [
    ("deferred", "deferred"), ("fused", "fused"), (True, "pallas-draw"),
    (False, "xla")])
def test_model_kill_and_resume_is_bitwise_in_each_tier(tmp_path, use_pallas, tier):
    # tests/test_resume_cli.py:33 in every tier, with a Minka update
    # between the halves: the checkpoint carries the moved alpha and beta
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, seed=7, block_size=128, use_pallas=use_pallas)
    ref = LdaModel(cfg, fc, device="cpu")
    assert ref.kernel_tier == tier
    ref.sweep(3)
    ref.optimize_hyperparameters()
    ref.sweep(3)

    a = LdaModel(cfg, fc, device="cpu")
    a.sweep(3)
    a.optimize_hyperparameters()
    assert a.save_checkpoint(tmp_path / "ckpt") == 3
    b = LdaModel(cfg, fc, device="cpu")
    assert b.restore_checkpoint(tmp_path / "ckpt") == 3
    assert (b.alpha, b.beta) == (a.alpha, a.beta) != (0.5, 0.1)
    b.sweep(3)
    _assert_same_state(b.state, ref.state)
    assert (b.alpha, b.beta) == (ref.alpha, ref.beta)
    b.check_counts_consistent()


def test_runner_checkpoints_and_resumes_mid_schedule(tmp_path):
    fc = _corpus()
    cfg = LdaConfig(topic_num=6, seed=1, block_size=128, iteration=6)
    ref = LdaModel(cfg, fc, device="cpu")
    run_inference(ref, cfg, fc, optimize_hyper_every=2)
    a = LdaModel(cfg.replace(iteration=4), fc, device="cpu")
    run_inference(a, cfg.replace(iteration=4), fc, optimize_hyper_every=2,
                  checkpoint_dir=tmp_path / "c", checkpoint_every=2)
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["2", "4"]
    b = LdaModel(cfg, fc, device="cpu")
    assert b.restore_checkpoint(tmp_path / "c") == 4
    run_inference(b, cfg, fc, optimize_hyper_every=2)
    _assert_same_state(b.state, ref.state)
    assert (b.alpha, b.beta) == (ref.alpha, ref.beta)


def test_serial_oracle_refuses_checkpoints(tmp_path):
    model = LdaModel(LdaConfig(topic_num=4, sampler="serial"), _corpus(docs=4),
                     device="cpu")
    for call in (model.save_checkpoint, model.restore_checkpoint):
        with pytest.raises(NotImplementedError, match="serial-oracle"):
            call(tmp_path / "c")


def _cli(docs, *flags):
    return cli.main(["--docs", str(docs), "-k", "3", "--seed", "1",
                     "--device", "cpu", *flags])


@pytest.mark.parametrize("tier", ["fused", "deferred"])
def test_cli_resume_writes_the_uninterrupted_artifacts(tmp_path, capsys, tier):
    # tests/test_resume_cli.py:51, and the resumed run's artifacts byte for
    # byte the uninterrupted run's; a block of 256 gives the minicorpus a
    # deferred layout
    docs = write_minicorpus(tmp_path / "docs", num_docs=8)
    flags = ["--save-step", "2", "--begin-save-iters", "4"]
    if tier == "deferred":
        (tmp_path / "c.json").write_text('{"block_size": 256}')
        flags += ["--config-json", str(tmp_path / "c.json")]
    assert _cli(docs, *flags, "--results", str(tmp_path / "full"),
                "--iterations", "8", "--metrics-file", str(tmp_path / "m.jsonl"),
                "--metrics-every", "0") == 0
    assert f'"kernel_tier": "{tier}"' in (tmp_path / "m.jsonl").read_text()
    assert _cli(docs, *flags, "--no-save", "--iterations", "4",
                "--checkpoint-dir", str(tmp_path / "ck"),
                "--checkpoint-every", "2") == 0
    assert ckpt.latest_step(tmp_path / "ck") == 4
    capsys.readouterr()
    assert _cli(docs, *flags, "--results", str(tmp_path / "resumed"),
                "--iterations", "8", "--checkpoint-dir", str(tmp_path / "ck"),
                "--resume") == 0
    out = capsys.readouterr().out
    assert "Resumed from sweep 4" in out
    assert "Iteration 3" not in out.split("Resumed from sweep 4")[1]
    names = sorted(p.name for p in (tmp_path / "resumed").iterdir())
    assert names == sorted(f"lda_{i}.{e}" for i in (4, 6, 8) for e in ARTIFACTS)
    for name in names:
        assert ((tmp_path / "resumed" / name).read_bytes()
                == (tmp_path / "full" / name).read_bytes()), name


def test_cli_resume_requires_dir(tmp_path, capsys):
    docs = write_minicorpus(tmp_path / "docs", num_docs=6)
    assert _cli(docs, "--no-save", "--resume") == 2
    assert "--resume requires --checkpoint-dir" in capsys.readouterr().err


def test_cli_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    docs = write_minicorpus(tmp_path / "docs", num_docs=6)
    assert _cli(docs, "--no-save", "--iterations", "2", "--resume",
                "--checkpoint-dir", str(tmp_path / "none")) == 0
    out = capsys.readouterr().out
    assert "Resumed" not in out and "Iteration 0" in out
