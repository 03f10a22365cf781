"""Checkpoint / resume of the full sampler state, on ``torch.save``.

Counterpart of ``ldagibbssampling_tpu/lda_io/checkpoint.py:22-124``, which
keeps the run with orbax.  The reference has no resume path (its
``saveIteratedModel`` text artifacts are never re-read); here the whole
``SamplerState`` ``(z, ndk, nwk, nk, sweep, seed)`` round-trips losslessly,
with the live (α, β) and the state of the host ``torch.Generator`` that
seeds each sweep (``models/lda.py``, ``ops/gibbs.py``).  The JAX state
folds its key with the sweep index and needs no such generator; without its
state a resumed port chain would draw other seeds.

Layout, as orbax's ``CheckpointManager(max_to_keep=3)`` keeps it: one
sub-directory per step, named by the step, holding ``run.pt``.  A save is
written under a temporary name and renamed into place, so a run killed
mid-save never leaves a half-written checkpoint as the latest.  As with
orbax, a save at a step not above the latest is skipped, and only the
newest ``max_to_keep`` steps are kept.  Files are read back with
``torch.load(weights_only=True)``: tensors, numbers, strings, ``None`` and
lists and dicts of them only.

The backend form (reference ``:200-249``), :func:`save_backend_run` and
:func:`restore_backend_run`, keeps the CVB0 and SVI runs in the same
layout: a dict of tensors (or numpy arrays) and a ``meta`` dict of plain
Python values, such as SVI's numpy ``bit_generator.state``.  The mesh form
(reference ``:135-197``) comes with the port's parallel runtimes (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ldagibbssampling_tpu_torch.models.state import SamplerState

_FILE = "run.pt"
_ARRAYS = ("z", "ndk", "nwk", "nk")


def _steps(directory: Path) -> list[int]:
    """The complete checkpoints' steps under ``directory``, ascending."""
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / _FILE).is_file())


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest step saved under ``directory``; ``None`` for a missing or
    empty directory."""
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def _save(directory: str | Path, step: int, payload: dict,
          max_to_keep: int) -> int:
    d = Path(directory).absolute()
    d.mkdir(parents=True, exist_ok=True)
    last = latest_step(d)
    if last is not None and last >= step:
        return step  # orbax's should_save: not above the latest, no save
    tmp = d / f".{step}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    with open(tmp / _FILE, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, d / str(step))
    for old in _steps(d)[:-max_to_keep]:
        shutil.rmtree(d / str(old))
    return step


def _load(directory: str | Path, step: Optional[int]) -> dict:
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    path = Path(directory) / str(step) / _FILE
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=True)


def _state_payload(state: SamplerState) -> dict:
    out: dict[str, Any] = {n: getattr(state, n).detach().cpu() for n in _ARRAYS}
    out.update(sweep=int(state.sweep), seed=int(state.seed))
    return out


def _state_like(saved: dict, like: SamplerState) -> SamplerState:
    """The saved state on ``like``'s device, checked against its shapes."""
    arrays = {}
    for name in _ARRAYS:
        ref, got = getattr(like, name), saved[name]
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint {name} is {got.dtype} {tuple(got.shape)}, the "
                f"model's {ref.dtype} {tuple(ref.shape)}")
        arrays[name] = got.to(ref.device)
    return SamplerState(sweep=int(saved["sweep"]), seed=int(saved["seed"]),
                        **arrays)


def save_checkpoint(directory: str | Path, state: SamplerState, *,
                    max_to_keep: int = 3) -> int:
    """Save ``state`` at step ``state.sweep``; returns the step saved."""
    step = int(state.sweep)
    return _save(directory, step, {"state": _state_payload(state)}, max_to_keep)


def restore_checkpoint(
    directory: str | Path,
    like: SamplerState,
    step: Optional[int] = None,
) -> SamplerState:
    """Restore a state with the same shapes and dtypes as ``like``, on its
    device (the latest step unless ``step`` is given)."""
    return _state_like(_load(directory, step)["state"], like)


def save_run(
    directory: str | Path,
    state: SamplerState,
    alpha: float,
    beta: float,
    *,
    generator: Optional[torch.Generator] = None,
    max_to_keep: int = 3,
) -> int:
    """Save the sampler state, the live (α, β) and, when given, the state of
    the generator that seeds the sweeps; returns the step saved."""
    step = int(state.sweep)
    payload = {
        "state": _state_payload(state),
        "hyper": {"alpha": float(alpha), "beta": float(beta)},
        "generator": None if generator is None else generator.get_state(),
    }
    return _save(directory, step, payload, max_to_keep)


def restore_run(
    directory: str | Path,
    like: SamplerState,
    step: Optional[int] = None,
) -> tuple[SamplerState, float, float, Optional[torch.Tensor]]:
    """Restore ``(state, alpha, beta, generator_state)`` saved by
    :func:`save_run` (``generator_state`` is ``None`` where none was saved;
    the reference returns the first three)."""
    saved = _load(directory, step)
    hyper = saved["hyper"]
    return (_state_like(saved["state"], like), float(hyper["alpha"]),
            float(hyper["beta"]), saved["generator"])


def save_backend_run(
    directory: str | Path,
    arrays: dict,
    meta: dict,
    step: int,
    *,
    max_to_keep: int = 3,
) -> int:
    """Save a dict of tensors or numpy arrays plus a ``meta`` dict of plain
    Python values (numbers, strings, lists, dicts, ``None``) at ``step``;
    returns the step."""
    payload = {
        "arrays": {n: torch.as_tensor(a).detach().cpu().clone()
                   for n, a in arrays.items()},
        "meta": dict(meta),
    }
    return _save(directory, int(step), payload, max_to_keep)


def restore_backend_run(
    directory: str | Path,
    like: dict,
    step: Optional[int] = None,
) -> tuple[dict, dict]:
    """Restore ``(arrays, meta)`` saved by :func:`save_backend_run` (the
    latest step unless ``step`` is given).  ``like`` gives each array's
    shape and dtype: a tensor entry comes back as a tensor on that tensor's
    device, a numpy entry as a numpy array."""
    saved = _load(directory, step)
    out = {}
    for name, ref in like.items():
        got = saved["arrays"][name]
        ref_t = torch.as_tensor(ref)
        if tuple(got.shape) != tuple(ref_t.shape) or got.dtype != ref_t.dtype:
            raise ValueError(
                f"checkpoint {name} is {got.dtype} {tuple(got.shape)}, the "
                f"model's {ref_t.dtype} {tuple(ref_t.shape)}")
        out[name] = (got.to(ref.device) if torch.is_tensor(ref)
                     else np.asarray(got.numpy()))
    return out, dict(saved["meta"])
