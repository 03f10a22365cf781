"""Device positions, named meshes and the one reduction of the mesh runtimes.

Counterpart of ``ldagibbssampling_tpu/parallel/multihost.py`` and of
``jax.sharding.Mesh``.  The reference's runtimes are single-controller SPMD
(``shard_map`` over a ``Mesh``); the port holds the shards itself:

- a :class:`Mesh` names its axes and gives each position (row-major over the
  axes) a ``torch.device`` and the rank of the process that holds it.
  Positions may repeat a device: ``[cuda:0] * 4`` places four shards on one
  card, ``[cpu] * 8`` gives the tests the eight positions that the JAX
  tests get from eight virtual CPU devices;
- :func:`local_devices` is where every entry point takes its positions
  from: every CUDA device, or one ``cpu``, as the reference takes them from
  ``jax.devices()``;
- :func:`initialize_distributed` brings up ``torch.distributed``
  (``tcp://`` init; NCCL for CUDA devices, gloo for the CPU) and returns the
  :class:`HostTopology`; with one process it is a no-op.  A group it brings
  up itself is torn down at interpreter exit, as ``jax.distributed`` shuts
  its client down: a process that leaves gloo's threads running when the
  interpreter exits can abort after its work is done.  A group the caller
  brought up is the caller's to tear down;
- :func:`psum` sums the shards' tensors over a named axis, in shard order,
  and is the only collective the runtimes call.  With several processes
  each holds only its own positions' shards, and ``psum`` adds one
  ``all_reduce(SUM)`` over the processes that span the group.  It is made
  of two halves, which the runtimes' captured sweeps run apart:
  :func:`local_sum`, this process's positions of a group added on one
  device (capturable), and :func:`reduce_across`, the ``all_reduce``
  (between the graph replays).  Each process group that a group spanning
  several processes needs is made once per process (``_groups``, in the same order in
  every process, as ``new_group`` is collective) and looked up afterwards.
"""

from __future__ import annotations

import atexit
import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """This process's place in the cluster after bring-up."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world() -> tuple[int, int]:
    """``(rank, world size)`` of this process (``(0, 1)`` without a group)."""
    dist = _dist()
    return (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)


def local_devices(device: Any = "cuda") -> list[torch.device]:
    """This process's device positions: every CUDA device for ``cuda``
    (raising without CUDA), one ``cpu`` for ``cpu``."""
    from ldagibbssampling_tpu_torch.models.lda import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices(device: Any = "cuda") -> tuple[list[torch.device], list[int]]:
    """Every process's positions in rank order, and the rank holding each."""
    local = local_devices(device)
    rank, size = world()
    if size == 1:
        return local, [rank] * len(local)
    gathered: list = [None] * size
    _dist().all_gather_object(gathered, [str(d) for d in local])
    devices, ranks = [], []
    for r, devs in enumerate(gathered):
        devices += [torch.device(d) for d in devs]
        ranks += [r] * len(devs)
    return devices, ranks


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Any = "cuda",
) -> HostTopology:
    """Bring up ``torch.distributed`` (idempotent; a no-op for one process).

    ``coordinator_address`` is ``host:port`` or any ``init_method`` URL
    (``tcp://host:port``, ``file:///path``); the group uses NCCL for
    ``cuda`` and gloo for ``cpu``, and is destroyed at interpreter exit.
    Where a group is up already (the caller's own, e.g. gloo for several
    processes on one card, which NCCL refuses), it is used as it is and
    left to the caller.
    """
    import torch.distributed as dist

    multi = (num_processes or 1) > 1 or coordinator_address
    if multi and not dist.is_initialized():
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("several processes need coordinator_address, "
                             "num_processes and process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=addr,
                                world_size=int(num_processes), rank=int(process_id))
        atexit.register(_teardown)
    rank, size = world()
    devices, _ = global_devices(device)
    return HostTopology(process_index=rank, process_count=size,
                        local_device_count=len(local_devices(device)),
                        global_device_count=len(devices))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over device positions (row-major), as ``jax.sharding.Mesh``."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]  # one per position
    ranks: tuple[int, ...]             # the process that holds each position

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")
        if len(self.devices) != self.size or len(self.ranks) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} positions, "
                             f"have {len(self.devices)}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, pos: int) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(pos, self.shape))

    def coord(self, pos: int, name: str) -> int:
        return self.coords(pos)[self.axis_names.index(name)]

    @property
    def local_positions(self) -> list[int]:
        """The positions this process holds, ascending."""
        rank = world()[0]
        return [p for p in range(self.size) if self.ranks[p] == rank]

    def group(self, pos: int, axes: Sequence[str]) -> list[int]:
        """The positions that differ from ``pos`` only along ``axes``."""
        c = self.coords(pos)
        fixed = [i for i, n in enumerate(self.axis_names) if n not in axes]
        return [p for p in range(self.size)
                if all(self.coords(p)[i] == c[i] for i in fixed)]


def line_mesh(n: Optional[int], axis: str = "data", device: Any = "cuda") -> Mesh:
    """The runtimes' default mesh: the first ``n`` global positions (all of
    them when ``n`` is ``None``) on one axis.  As the reference's
    ``Mesh(devs[:n])``, a list shorter than ``n`` gives fewer shards."""
    devices, ranks = global_devices(device)
    n = len(devices) if n is None else n
    return Mesh((axis,), (len(devices[:n]),), tuple(devices[:n]), tuple(ranks[:n]))


def make_mesh(axis_sizes: Mapping[str, int],
              devices: Optional[Sequence[Any]] = None,
              ranks: Optional[Sequence[int]] = None, *,
              device: Any = "cuda") -> Mesh:
    """A named mesh over the (global) positions.

    ``axis_sizes`` maps axis name to size in declaration order, e.g.
    ``{"data": 4, "vocab": 2}``; a size of ``-1`` on at most one axis means
    "whatever is left".  The product must equal the number of positions.
    ``devices`` defaults to every process's positions (``global_devices``);
    given ones belong to this process unless ``ranks`` says otherwise.
    """
    if devices is None:
        devs, rks = global_devices(device)
    else:
        devs = [torch.device(d) for d in devices]
        rks = list(ranks) if ranks is not None else [world()[0]] * len(devs)
    names = list(axis_sizes)
    sizes = [int(axis_sizes[n]) for n in names]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    if wild:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if len(devs) % known:
            raise ValueError(f"device count {len(devs)} not divisible by {known}")
        sizes[wild[0]] = len(devs) // known
    total = int(np.prod(sizes)) if sizes else 1
    if total != len(devs):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, have {len(devs)}")
    return Mesh(tuple(names), tuple(sizes), tuple(devs[:total]), tuple(rks[:total]))


def mesh_from_config(config, devices: Optional[Sequence[Any]] = None, *,
                     device: Any = "cuda") -> Mesh:
    """The mesh described by ``LdaConfig.mesh`` (empty: one ``data`` axis
    over every position)."""
    axes = dict(config.mesh) if config.mesh else {}
    if not axes:
        n = len(devices) if devices is not None else len(global_devices(device)[0])
        axes = {"data": n}
    return make_mesh(axes, devices, device=device)


# this process's groups by process tuple (cleared with the group at teardown)
_GROUPS: dict = {}


def _teardown() -> None:
    """Destroy the process group (registered at exit by
    :func:`initialize_distributed` for a group it brought up)."""
    _GROUPS.clear()
    dist = _dist()
    if dist:
        dist.destroy_process_group()


def _groups(mesh: Mesh, axes: tuple[str, ...]) -> list[list[int]]:
    """Every group of ``axes`` in ``mesh``, ordered by its first position.
    With several processes a group that spans more than one process, and
    not all of them, gets its process group here the first time it is seen:
    every process walks the groups in this order and calls ``new_group``
    for each (it is collective, members or not)."""
    groups, seen = [], set()
    for p in range(mesh.size):
        g = tuple(mesh.group(p, axes))
        if g not in seen:
            seen.add(g)
            groups.append(list(g))
    size = world()[1]
    if size > 1:
        for g in groups:
            procs = tuple(sorted({mesh.ranks[p] for p in g}))
            if 1 < len(procs) < size and procs not in _GROUPS:
                _GROUPS[procs] = _dist().new_group(list(procs))
    return groups


@dataclasses.dataclass(frozen=True)
class Group:
    """One ``psum`` group with a position in this process: ``local`` its
    positions that this process holds, in shard order, and ``procs`` the
    processes that hold any of its positions."""

    positions: tuple[int, ...]
    local: tuple[int, ...]
    procs: tuple[int, ...]

    @property
    def spans(self) -> bool:
        """Whether the group's sum needs an ``all_reduce`` across processes."""
        return len(self.procs) > 1


def local_groups(mesh: Mesh, axis) -> list[Group]:
    """The groups of ``axis`` (a name or a tuple of names) that hold a
    position of this process, ordered by their first position; makes each
    spanning group's process group the first time it is seen
    (``_groups``)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    rank, out = world()[0], []
    for g in _groups(mesh, axes):
        local = tuple(p for p in g if mesh.ranks[p] == rank)
        if local:
            out.append(Group(tuple(g), local,
                             tuple(sorted({mesh.ranks[p] for p in g}))))
    return out


def local_sum(parts: Sequence[torch.Tensor],
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``psum``'s first half: ``parts`` (one device, in shard order) added
    left to right, into ``out`` where it is given (one add per part after
    the second; a copy for one part), else into a new tensor (the one part
    itself, uncopied).  It reads no value on the host, so a CUDA graph can
    capture it."""
    if out is None:
        total = parts[0]
        for t in parts[1:]:
            total = total + t
        return total
    if len(parts) == 1:
        return out.copy_(parts[0])
    torch.add(parts[0], parts[1], out=out)
    for t in parts[2:]:
        out.add_(t)
    return out


def reduce_across(total: torch.Tensor, group: Group) -> None:
    """``psum``'s second half: ``all_reduce(SUM)`` of ``total`` in place
    over the processes that span ``group`` (nothing for a group that one
    process holds).  The runtimes' graphs run it between their replays."""
    if not group.spans:
        return
    pg = None if len(group.procs) == world()[1] else _GROUPS[group.procs]
    _dist().all_reduce(total, group=pg)


def psum(parts: Mapping[int, torch.Tensor], mesh: Mesh, axis) -> dict[int, torch.Tensor]:
    """Sum ``parts`` (this process's positions -> tensor) over ``axis`` (a
    name or a tuple of names): each position gets the sum over its group,
    added in shard order on the device of the group's first local position
    (:func:`local_sum`) and placed on the position's device.  Positions of
    a group on one device share the result tensor: callers never write
    into it.  A group that spans several processes adds one
    ``all_reduce(SUM)`` over them (:func:`reduce_across`)."""
    out: dict[int, torch.Tensor] = {}
    for group in local_groups(mesh, axis):
        dev0 = parts[group.local[0]].device
        total = local_sum([parts[p].to(dev0) for p in group.local])
        if group.spans:
            if len(group.local) == 1:
                total = total.clone()  # all_reduce writes in place
            reduce_across(total, group)
        placed: dict[torch.device, torch.Tensor] = {}
        for p in group.local:
            dev = mesh.devices[p]
            if dev not in placed:
                placed[dev] = total if total.device == dev else total.to(dev)
            out[p] = placed[dev]
    return out


def gather(parts: Mapping[int, Any], mesh: Mesh) -> dict[int, np.ndarray]:
    """Host copies of every position's value (this process's ``parts`` and,
    with several processes, everyone else's), keyed by position."""
    mine = {p: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for p, v in parts.items()}
    if world()[1] == 1:
        return mine
    gathered: list = [None] * world()[1]
    _dist().all_gather_object(gathered, mine)
    out: dict[int, np.ndarray] = {}
    for d in gathered:
        out.update(d)
    return out
