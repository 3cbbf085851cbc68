"""Paddle's collective API over ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/collective.py``. A ``Group`` is a
view of a mesh axis (or of every rank), as there; its process group comes
from the mesh (``parallel.mesh.DeviceMesh``). Every collective goes through
the comms layer (``distributed.comms``), so it is recorded as a CommOp and,
for an eligible all-reduce inside ``comms.quantized()``, rides the
quantized wire.

One difference in meaning: the JAX functions outside ``shard_map`` act on
GLOBAL arrays, while these act on each rank's LOCAL tensor, as Paddle's
do. Where the JAX function defines a per-rank pattern by a permutation
(``send``/``recv`` with a list or callable of peers), the port takes the
same list or callable and evaluates it at this rank. Peers and roots
(``src``, ``dst``) are indices within the group, as the JAX functions take
them (an axis index), not global ranks.

- ``all_reduce``, ``broadcast``, ``scatter`` and ``recv`` write into their
  tensor argument in place; ``reduce`` all-reduces (every rank gets the
  result, as in the JAX package); ``gather`` all-gathers into
  ``gather_list`` on every rank.
- ``all_gather_object`` pickles over the gloo twin of the group, on the
  CPU, so it works on an NCCL mesh too.
- ``barrier`` is ``torch.distributed.barrier`` over the group.
- Every call is recorded as a CommOp (``comms.comm_info()``).
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_mod
from . import comms
from .comms.api import Link

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "all_to_all", "reduce_scatter", "broadcast", "reduce",
    "scatter", "gather", "send", "recv", "isend", "irecv", "barrier",
    "batch_isend_irecv", "P2POp", "wait", "destroy_process_group",
    "get_backend",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communication group: a mesh axis (``axis``: a name or a tuple of
    names), or every rank (``axis=None``)."""

    _next_id = 0

    def __init__(self, axis=None, ranks=None, gid=None, pg=None):
        self.axis = axis
        self._pg = pg
        Group._next_id += 1
        self.id = gid if gid is not None else Group._next_id
        self._ranks = list(ranks) if ranks is not None else None

    def link(self) -> Link:
        if self._pg is not None:
            r = dist.get_rank()
            return Link(self._pg, len(self._ranks), self._ranks.index(r),
                        "group%d" % self.id, dist.get_backend(self._pg))
        return comms.link(self.axis)

    @property
    def nranks(self) -> int:
        return self.link().n

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's index in the group."""
        return self.link().rank

    @property
    def ranks(self) -> list:
        """The global ranks of the group, in group order."""
        if self._ranks is not None:
            return list(self._ranks)
        mesh = mesh_mod.get_mesh()
        return [0] if mesh is None else mesh.axis_ranks(self.axis)

    @property
    def process_group(self):
        return self.link().pg

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(axis={self.axis}, nranks={self.nranks})"


_lock = threading.RLock()
_groups: dict = {}


def _default_group() -> Group:
    with _lock:
        if 0 not in _groups:
            _groups[0] = Group(None, gid=0)
        return _groups[0]


def new_group(ranks=None, backend=None, timeout=None, axis=None) -> Group:
    """``axis=`` binds a mesh axis. A rank list is mapped onto the mesh
    axis along which those ranks' coordinates vary while the others stay
    fixed; a list that is no such slice gets its own process group, which
    every rank must create (``torch.distributed.new_group`` is
    collective)."""
    pg = None
    if axis is None and ranks is not None:
        axis = _axis_from_ranks(sorted(ranks))
        if axis is None and len(ranks) > 1:
            pg = dist.new_group(sorted(ranks), backend=backend)
    g = Group(axis, ranks=sorted(ranks) if pg is not None else None, pg=pg)
    with _lock:
        _groups[g.id] = g
    return g


def _axis_from_ranks(ranks):
    mesh = mesh_mod.get_mesh()
    if mesh is None or not ranks:
        return None
    for a in mesh.axis_names:
        if mesh.shape[a] == len(ranks) > 1 and \
                mesh.axis_ranks(a, ranks[0]) == list(ranks):
            return a
    return None


def get_group(id: int = 0) -> Group:
    with _lock:
        return _groups.get(id) or _default_group()


def get_backend(group=None) -> Optional[str]:
    lk = comms.link(group)
    return lk.backend


def destroy_process_group(group=None) -> None:
    with _lock:
        _groups.clear()
    if group is None and dist.is_initialized():
        mesh_mod.set_mesh(None)
        dist.destroy_process_group()


class _Task:
    """A finished collective (the calls here complete before returning)."""

    def __init__(self, tensor=None):
        self._tensor = tensor

    def wait(self) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


def wait(tensor, group=None, use_calc_stream=True) -> None:
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def _set(dst: torch.Tensor, src: torch.Tensor) -> None:
    with torch.no_grad():
        dst.copy_(src)


# ---------------- collectives ----------------

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Each rank's ``tensor`` replaced, in place, by the reduction over the
    group."""
    out = comms.wire_all_reduce(tensor, group, op,
                                owner="collective.all_reduce")
    if out is not tensor:
        _set(tensor, out)
    return _Task(tensor)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis_concat=0):
    """Every rank's ``tensor``, in group order: appended to
    ``tensor_list``, or stacked ``[n, ...]`` and returned when
    ``tensor_list`` is None."""
    stacked = comms.wire_all_gather(tensor, group,
                                    owner="collective.all_gather")
    if isinstance(tensor_list, list):
        tensor_list.extend(stacked.unbind(0))
        return _Task(tensor)
    return stacked


def all_gather_object(object_list, obj, group=None) -> None:
    """Every rank's picklable ``obj`` appended to ``object_list``, in group
    order (over the gloo twin of the group, on the CPU; recorded with this
    rank's pickled size as its payload)."""
    lk = comms.link(group)
    if lk.n == 1:
        object_list.append(obj)
        return
    if isinstance(group, Group) and group._pg is not None:
        pg = group._pg
    else:
        mesh = mesh_mod.get_mesh()
        pg = mesh.cpu_group(group.axis if isinstance(group, Group)
                            else group)
    from .comms import api
    dl = api._deadline("collective.all_gather_object", None)
    api._phase(api.SITE_COLLECTIVE, dl, "collective.all_gather_object")
    t0 = time.perf_counter()
    out = [None] * lk.n
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    size = torch.empty(len(pickle.dumps(obj)), dtype=torch.uint8)
    api._record("collective.all_gather_object", "all_gather_object", lk,
                size, lk.n - 1, None, dl, api._state.block, t0=t0)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank j's ``tensor`` gets, in place, the reduction over the group of
    every rank's ``tensor_list[j]`` (or of row block j of a tensor)."""
    src = torch.cat(list(tensor_list), dim=0) \
        if isinstance(tensor_list, (list, tuple)) else tensor_list
    out = comms.wire_reduce_scatter(src, group, op,
                                    owner="collective.reduce_scatter")
    _set(tensor, out.reshape(tensor.shape))
    return _Task(tensor)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Group rank ``src``'s ``tensor`` written into every rank's."""
    out = comms.wire_broadcast(tensor, src, group,
                               owner="collective.broadcast")
    if out is not tensor:
        _set(tensor, out)
    return _Task(tensor)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As the JAX package: every rank computes the reduction (``dst``
    among them)."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank j's ``tensor`` gets group rank ``src``'s ``tensor_list[j]``."""
    lk = comms.link(group)
    if lk.n == 1:
        if tensor_list:
            _set(tensor, tensor_list[0])
        return _Task(tensor)
    if tensor_list is None or len(tensor_list) != lk.n:
        raise ValueError(f"scatter needs {lk.n} tensors on every rank "
                         f"(src's are the ones sent)")
    stacked = torch.stack(list(tensor_list))
    auth = comms.wire_broadcast(stacked, src, group,
                                owner="collective.scatter")
    _set(tensor, auth[lk.rank])
    return _Task(tensor)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    out = []
    all_gather(out, tensor, group=group)
    if gather_list is not None:
        gather_list.extend(out)
    return _Task(tensor)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """``in_tensor_list[j]`` goes to group rank j; ``out_tensor_list``
    receives, in group order, the tensor each rank addressed here."""
    stacked = torch.stack(list(in_tensor_list))
    out = comms.wire_all_to_all(stacked, group, exact=True,
                                owner="collective.all_to_all")
    out_tensor_list.extend(out.unbind(0))
    return _Task(out_tensor_list[0] if out_tensor_list else None)


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    return all_to_all(out_tensor_list, in_tensor_list, group, sync_op)


# ------------- point to point -------------

def _peer(peer, lk: Link, inverse: bool = False) -> Optional[int]:
    """This rank's peer: a scalar, or a list / callable giving every group
    rank's peer (for ``recv``, rank j receives from ``peer[j]``)."""
    if callable(peer):
        return int(peer(lk.rank)) % lk.n
    if isinstance(peer, (list, tuple)):
        if len(peer) != lk.n:
            raise ValueError(f"peer list must have length {lk.n}, got "
                             f"{len(peer)}")
        return int(peer[lk.rank]) % lk.n
    return int(peer) % lk.n


def _exchange(send_t, dst, recv_t, src, group, owner):
    """One batched send/recv pair over the group (either side may be
    None)."""
    lk = comms.link(group)
    if lk.n == 1:
        if recv_t is not None and send_t is not None:
            _set(recv_t, send_t)
        return
    from .comms import api
    dl = api._deadline(owner, None)
    api._phase(api.SITE_COLLECTIVE, dl, owner)
    ref = send_t if send_t is not None else recv_t
    st = api._Stager(lk, "sendrecv", ref)
    ops, staged_recv = [], None
    t0 = time.perf_counter()
    if send_t is not None:
        ops.append(dist.P2POp(dist.isend, st.out(send_t.contiguous()),
                              api._global(lk, dst), lk.pg))
    if recv_t is not None:
        staged_recv = torch.empty_like(recv_t, device="cpu") if st.on \
            else (recv_t if recv_t.is_contiguous()
                  else torch.empty_like(recv_t))
        ops.append(dist.P2POp(dist.irecv, staged_recv,
                              api._global(lk, src), lk.pg))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if recv_t is not None and staged_recv is not recv_t:
        _set(recv_t, st.back(staged_recv, recv_t))
    api._record(owner, "sendrecv", lk, ref, 1, None, dl,
                api._state.block, staged=st.bytes, t0=t0)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to group rank ``dst`` (a scalar, or a list /
    callable of every rank's destination). Pair it with the peer's
    ``recv``, or use ``batch_isend_irecv`` for a ring."""
    lk = comms.link(group)
    _exchange(tensor, _peer(dst, lk), None, None, group, "collective.send")
    return _Task(tensor)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor``, in place, from group rank ``src`` (a
    scalar, or a list / callable of every rank's source)."""
    lk = comms.link(group)
    _exchange(None, None, tensor, _peer(src, lk), group, "collective.recv")
    return _Task(tensor)


def isend(tensor, dst, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=None, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list: List[P2POp]):
    """The sends and receives of the list as one exchange per group, so a
    ring of sends and receives cannot deadlock."""
    by_group = {}
    for p in p2p_op_list:
        by_group.setdefault(id(p.group), []).append(p)
    for ops in by_group.values():
        group = ops[0].group
        lk = comms.link(group)
        sends = [p for p in ops if p.op in (send, isend)]
        recvs = [p for p in ops if p.op in (recv, irecv)]
        if len(sends) > 1 or len(recvs) > 1 or len(sends) + len(recvs) != \
                len(ops):
            raise ValueError("batch_isend_irecv takes at most one send and "
                             "one recv per group")
        s = sends[0] if sends else None
        r = recvs[0] if recvs else None
        _exchange(s.tensor if s else None,
                  _peer(s.peer, lk) if s else None,
                  r.tensor if r else None,
                  _peer(r.peer, lk) if r else None, group,
                  "collective.batch_isend_irecv")
    return [_Task(p.tensor) for p in p2p_op_list]


def barrier(group=None) -> None:
    """Block until every rank of the group reaches the barrier (recorded,
    with nothing on the wire)."""
    lk = comms.link(group)
    from .comms import api
    dl = api._deadline("collective.barrier", None)
    api._phase(api.SITE_COLLECTIVE, dl, "collective.barrier")
    t0 = time.perf_counter()
    if lk.n > 1:
        dist.barrier(group=lk.pg)
    api._record("collective.barrier", "barrier", lk, torch.empty(0), 0,
                None, dl, api._state.block, t0=t0)
