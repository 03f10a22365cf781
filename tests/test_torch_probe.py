"""K4, the elementwise-rate probe: the port's plain version against the
reference kernel ``scripts/vpu_dtype_probe.py::_kernel`` (imported by path;
the script is not a package module), wrapped here in a
``pl.pallas_call(..., interpret=True)`` over 1,024 rows in tiles of 512.
The reference runs in a subprocess (this file run as a script) with XLA's
excess precision off, so that its bf16 chain rounds after every op
(``tests/test_torch_chains.py`` says why).

Tolerances: bf16 bitwise.  float32: rtol 1e-6 with no absolute floor
(measured 4.7e-7), except column 3, where ``e = 1`` and XLA on the CPU
contracts the repeat's last multiply and add into one FMA (the reference's
column equals an FMA emulation of the chain bitwise), which PyTorch does
not: rtol 1.5e-5 there (measured 5.9e-6, the FMA's one rounding carried
through eight repeats of ``(acc - 0.9) * (y - 0.5) + acc``)."""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from ldagibbssampling_tpu_torch.evaluation import tracing
from ldagibbssampling_tpu_torch.scripts import vpu_dtype_probe as probe
from test_torch_chains import run_without_excess_precision

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ROWS, TILE = 1024, 512
RTOL_F32, RTOL_F32_FMA_COLUMN = 1e-6, 1.5e-5


def _reference_module():
    spec = importlib.util.spec_from_file_location(
        "vpu_dtype_probe_ref", REPO / "scripts" / "vpu_dtype_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(a, b, dtype):
    ref = _reference_module()
    assert (ref.K, ref.REPS, ref.TILE) == (probe.K, probe.REPS, TILE)
    spec = pl.BlockSpec((TILE, ref.K), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        functools.partial(ref._kernel, dtype=getattr(jnp, dtype)),
        grid=(a.shape[0] // TILE,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((ROWS, probe.K), np.float32),
            rng.random((ROWS, probe.K), np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("probe") / "ref.npz"
    run_without_excess_precision(__file__, str(out))
    with np.load(out) as f:
        return dict(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_probe_matches_reference(reference, dtype):
    a, b = _inputs()
    want = reference[dtype]
    got = probe.probe_plain(torch.from_numpy(a), torch.from_numpy(b),
                            dtype=dtype).numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        fma = np.arange(probe.K) == 3
        np.testing.assert_allclose(got[:, ~fma], want[:, ~fma], rtol=RTOL_F32)
        np.testing.assert_allclose(got[:, fma], want[:, fma],
                                   rtol=RTOL_F32_FMA_COLUMN)
    assert np.isfinite(got).all() and float(np.abs(got).max()) > 1


def test_wrapper_cpu_path_is_plain_and_counts():
    a, b = (torch.from_numpy(x) for x in _inputs(1))
    before = tracing.counters().get("plain.dtype_probe_bf16", 0)
    out = probe.dtype_probe(a, b, dtype="bfloat16", reps=3)
    assert tracing.counters()["plain.dtype_probe_bf16"] == before + 1
    assert torch.equal(out, probe.probe_plain(a, b, dtype="bfloat16", reps=3))
    assert probe.ops_counted() == 32768 * 512 * 8 * 5


def test_wrapper_rejects_bad_inputs():
    a, b = (torch.from_numpy(x) for x in _inputs(2))
    with pytest.raises(ValueError, match="dtype"):
        probe.dtype_probe(a, b, dtype="float16")
    with pytest.raises(ValueError, match="float32"):
        probe.dtype_probe(a.double(), b)
    with pytest.raises(ValueError, match="512"):
        probe.dtype_probe(a[:, :256].contiguous(), b[:, :256].contiguous())


def test_main_on_cpu_prints_both_rates(capsys):
    assert probe.main(["--device", "cpu", "--rows", "64", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "float32:" in out and "bfloat16:" in out and "Gops/s" in out


if __name__ == "__main__":
    np.savez(sys.argv[1], **{d: _reference(*_inputs(), d)
                             for d in ("float32", "bfloat16")})
