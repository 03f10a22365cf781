"""The kernel build's cache key (``ops/_build.py``), on the CPU: a library's
digest covers its source and every ``csrc`` header the source includes, so
an edit to a shared header rebuilds every library that includes it and no
other."""

from __future__ import annotations

import shutil
import tomllib
from pathlib import Path

from ldagibbssampling_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def test_every_source_is_built_and_shipped():
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    shipped = data["tool"]["setuptools"]["package-data"]["ldagibbssampling_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh"} <= set(shipped)


def test_header_edit_changes_the_digest_of_its_includers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build._inputs("fused_kernel")] == [
        "fused_kernel.cu", "philox.cuh"]
    before = {n: _build._lib_path(n)[1].name for n in _build.SOURCES}
    header = csrc / "philox.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: _build._lib_path(n)[1].name for n in _build.SOURCES}
    assert after["fused_kernel"] != before["fused_kernel"]
    assert after["sample_kernel"] != before["sample_kernel"]
    assert after["count_kernel"] == before["count_kernel"]
    # a header included by a header counts too
    (csrc / "extra.cuh").write_text("// v1\n")
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    mid = _build._lib_path("sample_kernel")[1].name
    (csrc / "extra.cuh").write_text("// v2\n")
    assert _build._lib_path("sample_kernel")[1].name != mid
