"""Faults planted under the timed path, for the control's readings and the
tests: each wraps a function of the program's ``ops.gibbs`` that the
deferred sweep calls and its graph captures, K1's walk (``gibbs_tiles``) so
that the sweep's new topics come out wrong in one way, or K2's snapshot
(``cast_mirror``)."""

from __future__ import annotations

import contextlib

import torch


def unchanged(orig, rows, ndk, nk, z, *a, **kw):
    """A step that returns its state unchanged (the walk's counts move, its
    topics do not)."""
    orig(rows, ndk, nk, z, *a, **kw)
    return z.clone()


def half_left_out(orig, rows, ndk, nk, z, *a, **kw):
    """The second half of the stream left out: its topics kept."""
    z_new = orig(rows, ndk, nk, z, *a, **kw)
    half = z.shape[0] // 2
    return torch.cat((z_new[:half], z[half:]))


def one_altered_per_tile(orig, rows, ndk, nk, z, *a, **kw):
    """One topic in each tile altered where it is drawn (the next topic)."""
    z_new = orig(rows, ndk, nk, z, *a, **kw).clone()
    tile = kw["row_tile"]
    at = torch.arange(tile // 3, z.shape[0], tile, device=z.device)
    z_new[at] = (z_new[at] + 1) % ndk.shape[1]
    return z_new


def snapshot_stale(orig, nwk, out=None):
    """The snapshot's cast after each sweep left out: the next sweep reads
    the one before (the cold start's cast is kept)."""
    return orig(nwk) if out is None else out


# name: (the function of ops.gibbs it wraps, the fault)
FAULTS = {"unchanged": ("gibbs_tiles", unchanged),
          "half_left_out": ("gibbs_tiles", half_left_out),
          "one_altered_per_tile": ("gibbs_tiles", one_altered_per_tile),
          "snapshot_stale": ("cast_mirror", snapshot_stale)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted in the program while the block runs."""
    import ldagibbssampling_tpu_torch.ops.gibbs as program

    target, fault = FAULTS[name]
    orig = getattr(program, target)
    setattr(program, target, lambda *a, **kw: fault(orig, *a, **kw))
    try:
        yield
    finally:
        setattr(program, target, orig)
