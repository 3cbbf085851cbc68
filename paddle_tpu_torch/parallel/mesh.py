"""The device mesh: named axes laid over the ranks, with one
``torch.distributed`` process group for each slice of each axis.

Counterpart of ``paddle_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over the devices of a single program, and XLA
inserts the collectives. Here every rank is its own process, as in Paddle,
and a mesh axis is a set of process groups: the ranks whose coordinates
differ only along that axis. Ranks are laid out row-major over the axes,
as the JAX package reshapes its device array (mesh.py:38-44): rank
``r`` sits at ``np.unravel_index(r, dims)``. ``DeviceMesh`` makes every
group of every axis above 1 once, at ``init_mesh``; every rank must call
``init_mesh`` with the same shape, since ``torch.distributed.new_group``
is collective.

Each group uses the backend that ``distributed.init_parallel_env``
chose (``nccl`` on ``cuda``, ``gloo`` on the CPU, unless the caller named
one). Under ``nccl`` a mesh also holds a ``gloo`` twin of each group, for
what must travel on the CPU (``all_gather_object``).

Two names of the JAX module have no counterpart, by design:

- ``shard_constraint`` is a GSPMD annotation: it asks XLA to lay an array
  out over the mesh and XLA inserts the collectives. Eager PyTorch has no
  layout pass to ask; each layer of the port holds its shard of a weight
  and moves activations with an explicit collective
  (``distributed.fleet.meta_parallel.mp_layers``,
  ``parallel.context_parallel``). A caller that needs a layout change
  calls that collective.
- ``named_sharding`` builds the ``NamedSharding`` that ``device_put`` and
  ``jit`` read; no PyTorch API takes one. ``DeviceMesh.axis_ranks`` and
  ``DeviceMesh.group`` say who holds what.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DeviceMesh", "HYBRID_ORDER", "init_mesh", "set_mesh", "get_mesh",
           "has_mesh", "mesh_axis_size", "axis_index", "elastic_mesh_shape",
           "elastic_mesh", "reform_world"]

# canonical hybrid-parallel axis order, outermost first (topology.py:30)
HYBRID_ORDER = ("dp", "pp", "sharding", "sep", "mp")

Axes = Union[str, Tuple[str, ...], None]


class DeviceMesh:
    """Named axes over ``size`` ranks; this process is ``rank``.

    Construction does the coordinate arithmetic only; ``build_groups``
    makes the process groups. ``group(axis)`` is the process group of this
    rank's slice of ``axis`` (a name, a tuple of names, or None for every
    rank), or None when that slice holds this rank alone: a collective
    over it is the identity.
    """

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        self.axis_names = tuple(str(a) for a in shape)
        self.dims = tuple(int(v) for v in shape.values())
        if any(d < 1 for d in self.dims):
            raise ValueError(f"mesh axes must be >= 1, got {dict(shape)}")
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = math.prod(self.dims)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   self.rank, self.dims))))
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.backend = backend
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._cpu_groups: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        # (c10d store, key prefix, timeout s) of a world still to be formed
        # (``elastic_mesh``); None for a mesh over the current world
        self.rendezvous = None

    def build_groups(self) -> "DeviceMesh":
        """Make the process groups of every axis and of every rank
        (collective; ``init_mesh`` calls it once)."""
        if self.size > 1:
            for a in self.axis_names:
                self._build((a,))
            if self.axis_names not in self._groups:
                self._build(self.axis_names)
        return self

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # ---- coordinates ----
    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"mesh {self.shape} has no axis {a!r}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's coordinate along ``axes`` (row-major over several)."""
        axes = self._axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_ranks(self, axes: Axes, rank: Optional[int] = None) -> list:
        """The global ranks of ``rank``'s slice of ``axes`` (default: this
        rank's), in the order of their coordinate along ``axes``."""
        axes = self._axes(axes)
        base = self.coords if rank is None else dict(zip(
            self.axis_names, np.unravel_index(rank, self.dims)))
        out = []
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in axes)):
            c = dict(base)
            c.update(zip(axes, combo))
            out.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], self.dims)))
        return out

    # ---- process groups ----
    def _build(self, axes: Tuple[str, ...]) -> None:
        """Make every slice's group of ``axes`` (collective: every rank runs
        the same calls in the same order) and keep this rank's."""
        n = self.axis_size(axes)
        if n == 1:
            self._groups[axes] = self._cpu_groups[axes] = None
            return
        if n == self.size:
            pg = dist.group.WORLD
            cpu = pg if self.backend == "gloo" else dist.new_group(
                list(range(self.size)), backend="gloo")
            self._groups[axes], self._cpu_groups[axes] = pg, cpu
            return
        others = [a for a in self.axis_names if a not in axes]
        seen = set()
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            c = dict(zip(others, combo))
            c.update({a: 0 for a in axes})
            first = int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], self.dims))
            ranks = self.axis_ranks(axes, first)
            if tuple(ranks) in seen:
                continue
            seen.add(tuple(ranks))
            pg = dist.new_group(ranks, backend=self.backend)
            cpu = pg if self.backend == "gloo" else dist.new_group(
                ranks, backend="gloo")
            if self.rank in ranks:
                self._groups[axes], self._cpu_groups[axes] = pg, cpu

    def group(self, axes: Axes = None):
        """This rank's process group over ``axes``, or None for a slice of
        one. A tuple of axes not seen before makes its groups here, which
        is collective: every rank must ask for it at the same point."""
        axes = self._axes(axes)
        with self._lock:
            if axes not in self._groups:
                if self.size == 1:
                    return None
                self._build(axes)
            return self._groups[axes]

    def cpu_group(self, axes: Axes = None):
        """The gloo twin of ``group(axes)`` (the group itself under gloo)."""
        self.group(axes)
        return self._cpu_groups[self._axes(axes)]


_state = {"mesh": None}


def init_mesh(shape: Union[Dict[str, int], Sequence[int]],
              axis_names: Optional[Sequence[str]] = None,
              devices=None, *, backend: Optional[str] = None) -> DeviceMesh:
    """Make and install the mesh: ``init_mesh({"dp": 2, "mp": 2})`` or
    ``init_mesh([2, 2], ["dp", "mp"])``. Axes of size 1 are kept, so code
    can always name them. The mesh must span the world of
    ``torch.distributed`` (``distributed.init_parallel_env`` first); a
    mesh of one rank needs no process group. ``devices`` is one device
    per rank of the mesh (this rank takes its own), or this rank's device;
    it and ``backend`` default to what ``init_parallel_env`` chose."""
    if isinstance(shape, dict):
        shape = {str(k): int(v) for k, v in shape.items()}
    else:
        if axis_names is None or len(axis_names) != len(shape):
            raise ValueError("a list shape needs one axis name per dim")
        shape = dict(zip((str(a) for a in axis_names),
                         (int(v) for v in shape)))
    n = math.prod(shape.values())
    from ..distributed import env
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n != world:
            raise RuntimeError(f"mesh {shape} needs {n} ranks, the world "
                               f"has {world}")
        rank = dist.get_rank()
        backend = backend or dist.get_backend()
    elif n == 1:
        rank = 0
    else:
        raise RuntimeError(f"mesh {shape} needs {n} ranks: call "
                           "distributed.init_parallel_env() first")
    if devices is None:
        dev = env.current_device()
    elif isinstance(devices, (list, tuple)):
        if len(devices) != n:
            raise ValueError(f"mesh {shape} needs {n} devices, got "
                             f"{len(devices)}")
        dev = devices[rank]
    else:
        dev = devices
    mesh = DeviceMesh(shape, rank=rank, device=dev,
                      backend=backend).build_groups()
    _state["mesh"] = mesh
    return mesh


def elastic_mesh_shape(template: dict, n_devices: int,
                       elastic_axis: str = "dp") -> dict:
    """Re-derive a mesh shape for a new rank count after an elastic shrink
    or grow: every other axis keeps its extent and ``elastic_axis``
    absorbs the change. Raises when the count cannot host the fixed axes
    (mesh.py:48-67)."""
    fixed = math.prod(int(v) for k, v in template.items()
                      if k != elastic_axis)
    if elastic_axis not in template:
        raise ValueError(f"elastic axis {elastic_axis!r} not in mesh "
                         f"template {template}")
    if n_devices <= 0 or n_devices % fixed != 0:
        raise ValueError(
            f"{n_devices} devices cannot host mesh template {template}: "
            f"non-elastic axes need a multiple of {fixed}")
    out = dict(template)
    out[elastic_axis] = n_devices // fixed
    return out


def elastic_mesh(shape: Dict[str, int], rank: int, *, store, prefix: str,
                 timeout: float = 60.0, device=None,
                 backend: Optional[str] = None) -> DeviceMesh:
    """A mesh over a world that is still to be formed: the ranks of a new
    roster after an elastic shrink or grow. ``rank`` is this process's
    position in the roster, ``store`` a ``torch.distributed`` store that
    outlives every rank (hosted by the job's master), and ``prefix`` a key
    prefix no earlier world used (one per supervision epoch): a
    ``PrefixStore`` over it is the new world's rendezvous, so keys of a
    world that lost a rank are never read again. ``TrainStep.reshard``
    (through ``reform_world``) forms it; ``timeout`` becomes the process
    group's timeout, the bound of a collective blocked on a dead peer.
    ``device`` and ``backend`` default to the current ones."""
    from ..distributed import env
    dev = device if device is not None else env.current_device()
    if backend is None:
        backend = env.get_backend() or (
            "nccl" if torch.device(dev).type == "cuda" else "gloo")
    mesh = DeviceMesh({str(k): int(v) for k, v in shape.items()}, rank=rank,
                      device=dev, backend=backend)
    mesh.rendezvous = (store, str(prefix), float(timeout))
    return mesh


def reform_world(mesh: DeviceMesh) -> DeviceMesh:
    """Leave the current process group and form ``mesh``'s world (an
    ``elastic_mesh``): ``torch.distributed`` cannot shrink or grow a
    group, so the old one is destroyed (gloo's destroy returns at once
    after a peer's death) and ``init_process_group`` runs again over a
    ``PrefixStore`` with rank = position in the new roster; then the
    mesh's groups are built and the mesh installed. Collective over the
    new roster."""
    import datetime
    from ..distributed import env
    if mesh.rendezvous is None:
        raise ValueError("reform_world needs a mesh from elastic_mesh()")
    store, prefix, timeout = mesh.rendezvous
    if dist.is_initialized():
        dist.destroy_process_group()
    kw = dict(backend=mesh.backend, rank=mesh.rank, world_size=mesh.size,
              store=dist.PrefixStore(prefix, store),
              timeout=datetime.timedelta(seconds=timeout))
    if mesh.backend == "nccl":
        kw["device_id"] = mesh.device
    dist.init_process_group(**kw)
    env._env["device"], env._env["backend"] = mesh.device, mesh.backend
    mesh.rendezvous = None
    mesh.build_groups()
    _state["mesh"] = mesh
    return mesh


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    _state["mesh"] = mesh


def get_mesh() -> Optional[DeviceMesh]:
    return _state["mesh"]


def has_mesh() -> bool:
    return get_mesh() is not None


def mesh_axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """The extent of ``axis`` on the mesh (1 with no mesh or no such
    axis)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or axis not in mesh.shape:
        return 1
    return mesh.shape[axis]


def axis_index(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate along ``axis`` (0 with no mesh or no such
    axis); the JAX function reads the bound axis inside ``shard_map``."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or axis not in mesh.shape:
        return 0
    return mesh.coords[axis]
