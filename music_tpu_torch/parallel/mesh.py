"""Device mesh over ``torch.distributed`` ranks (counterpart of
:mod:`music_tpu.parallel.mesh`).

A JAX mesh is an array of devices with the named axes ``("data", "seq",
"model")``.  In the port a device is a process, one rank of a process
group, so a :class:`Mesh` is the same array holding ranks: rank ``r`` sits
where device ``r`` sits in JAX's ``np.array(devices).reshape((data, seq,
model))``, ``model`` varying fastest.  Each rank holds its own ``Mesh``:
the array, its coordinates, its device, and one process group for each
line of ranks it lies on: along ``data``, ``seq`` or ``model``, over
``(data, seq)`` (the loss mean and the gradient sum) and over the whole mesh.

- ``data``  splits the batch (data parallelism);
- ``seq``   splits the time axis of a window (sequence parallelism);
- ``model`` splits the 512-wide skip path's channels (tensor parallelism).

Shardings.  A spec names, for each dimension of an array, the mesh axis it
is split over, or None: ``P(None, None, "model")`` as JAX's
``PartitionSpec``.  A sharding is this rank's index into the global array:
:func:`batch_sharding` is the rows of its data coordinate (JAX's
``P("data")``: contiguous blocks in data-coordinate order), and ranks
along ``seq`` and ``model`` get the same rows.

A mesh of one rank needs no process group: :func:`make_mesh` then works
without ``torch.distributed`` (JAX's "degrade to one device"), every group
is None and every collective of :mod:`.collectives` is the identity.  In
an initialised process group every line has its group, one of one rank
too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")
GROUPS = (("data",), ("seq",), ("model",), ("data", "seq"), AXES)
"""The axis sets a mesh holds a process group for."""


def P(*names: str | None) -> tuple:
    """A partition spec: the mesh axis each dimension is split over."""
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axis size -1 means 'all remaining devices'."""

    data: int = -1
    seq: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        sizes = [self.data, self.seq, self.model]
        free = [i for i, s in enumerate(sizes) if s == -1]
        fixed = int(np.prod([s for s in sizes if s != -1]))
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free:
            sizes[free[0]] = n_devices // fixed
        if int(np.prod(sizes)) != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return tuple(sizes)


def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """One rank's view of a ``(data, seq, model)`` mesh of ranks."""

    def __init__(self, ranks: np.ndarray, rank: int, device: torch.device,
                 groups: dict[tuple[str, ...], Any]):
        self.ranks = ranks
        self.rank = rank
        self.device = device
        self._groups = groups
        coords = np.argwhere(ranks == rank)[0]
        self.coords = dict(zip(AXES, (int(c) for c in coords)))
        self.shape = dict(zip(AXES, ranks.shape))

    def size(self, axes: str | Sequence[str]) -> int:
        """The product of the sizes of ``axes``."""
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (JAX's ``axis_index``)."""
        return self.coords[axis]

    def line(self, axis: str) -> list[int]:
        """The ranks along ``axis`` through this rank, in coordinate order."""
        idx = [self.coords[a] if a != axis else slice(None) for a in AXES]
        return [int(r) for r in self.ranks[tuple(idx)]]

    def group(self, axes: str | Sequence[str]):
        """The process group of this rank's line over ``axes`` (one of
        :data:`GROUPS`); None when there is no process group."""
        return self._groups[_axes(axes)]

    @property
    def is_main(self) -> bool:
        """Whether this rank is the mesh's first, the one that writes
        checkpoints and logs."""
        return self.rank == int(self.ranks.flat[0])


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` for ``"cuda"`` (the local
    rank being the rank modulo the host's cards), else ``device``.  A CUDA
    device must exist (the caller asks for the CPU with ``"cpu"``)."""
    from music_tpu_torch.generate.wavenet_generate import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _line_groups(arr: np.ndarray, axes: tuple[str, ...], me: int):
    """Create a process group for every line of ``arr`` over ``axes`` (every
    rank must call this, in the same order) and return the one holding
    ``me``; None without a process group.  A line of one rank gets its group
    too, so a mesh of one rank in a process group still runs every
    collective through the backend."""
    if not dist.is_initialized():
        return None
    n = int(np.prod([arr.shape[AXES.index(a)] for a in axes]))
    moved = np.moveaxis(arr, [AXES.index(a) for a in axes],
                        list(range(arr.ndim - len(axes), arr.ndim)))
    mine = None
    for line in moved.reshape(-1, n):
        group = dist.new_group([int(r) for r in line])
        if me in line:
            mine = group
    return mine


def make_mesh(spec: MeshSpec | None = None, ranks: Sequence[int] | None = None,
              device: str | torch.device = "cuda") -> Mesh | None:
    """A ``(data, seq, model)`` mesh over ``ranks`` (default: every rank of
    the initialised process group, or this process alone), laid out as
    JAX's ``make_mesh`` lays out devices.  ``device``: ``"cuda"`` (each rank
    on ``cuda:<local rank>``; raises without a card) or ``"cpu"``.

    Every rank of the process group must call it: ``torch.distributed``
    creates each group on every rank.  A rank outside ``ranks`` gets None.
    ``ranks`` must increase, so a group's ranks are in coordinate order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if ranks != sorted(set(ranks)):
        raise ValueError(f"mesh ranks must increase: {ranks}")
    arr = np.array(ranks).reshape((spec or MeshSpec()).resolve(len(ranks)))
    me = dist.get_rank() if dist.is_initialized() else 0
    if arr.size > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh of {arr.size} ranks needs an initialised process group "
                           "(parallel.multihost.initialize)")
    device = rank_device(device)
    groups = {axes: _line_groups(arr, axes, me) for axes in GROUPS}
    if me not in arr:
        return None
    return Mesh(arr, me, device, groups)


def block(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``n`` items split into ``parts`` equal contiguous
    blocks."""
    if n % parts:
        raise ValueError(f"{n} not divisible by {parts}")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def local_index(mesh: Mesh, spec: tuple, shape: Sequence[int]) -> tuple[slice, ...]:
    """This rank's block of a global array of ``shape`` split as ``spec``
    (the index of its addressable shard, in JAX's terms)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(slice(None) if a is None else block(n, mesh.shape[a], mesh.index(a))
                 for a, n in zip(spec, shape))


def replicated(mesh: Mesh) -> tuple:
    """The spec of an array every rank holds whole."""
    return P()


def batch_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """Shard the leading (batch) dim over ``data``; replicate the rest."""
    return P("data", *([None] * (ndim - 1)))


def batch_seq_sharding(mesh: Mesh, ndim: int) -> tuple:
    """Shard dim 0 over ``data`` and dim 1 (time) over ``seq``."""
    assert ndim >= 2
    return P("data", "seq", *([None] * (ndim - 2)))


def shard(mesh: Mesh, x, spec: tuple) -> torch.Tensor:
    """This rank's block of the global array ``x`` (numpy or a tensor) as a
    tensor on the mesh's device."""
    x = torch.as_tensor(x)
    return x[local_index(mesh, spec, x.shape)].to(mesh.device).contiguous()


def shard_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's rows of a global host batch (``batch_sharding``)."""
    return shard(mesh, batch, batch_sharding(mesh, np.ndim(batch)))


def shard_params(mesh: Mesh, params: dict, specs: dict | None = None) -> dict:
    """Global parameters as this rank's blocks by ``specs`` (name -> spec;
    default: replicated), on the mesh's device."""
    specs = specs or {}
    return {k: shard(mesh, v, specs.get(k, P())) for k, v in params.items()}


@torch.no_grad()
def gather(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The global array of which ``x`` is this rank's block by ``spec``:
    gathered over the axis of each split dimension (every rank of those
    groups must call it)."""
    for dim, axis in enumerate(spec):
        group = None if axis is None else mesh.group(axis)
        if group is None:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
    return x
