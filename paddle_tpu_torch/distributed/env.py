"""The distributed environment: one process per rank.

Counterpart of ``paddle_tpu/distributed/env.py``. The JAX package runs one
program over every device and boots the JAX runtime only across hosts;
here, as in Paddle (``python/paddle/distributed/parallel.py:925``), each
rank is a process that joins a ``torch.distributed`` process group.

``init_parallel_env`` reads the rank, the world size and the local rank
from Paddle's variables (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_MASTER``) or torchrun's (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or from
its arguments. The device defaults to ``cuda`` (the local rank's card) and
raises without one; the backend defaults to ``nccl`` on ``cuda`` and
``gloo`` on the CPU. A caller who wants gloo with CUDA tensors (ranks that
share one card, which NCCL refuses) names it: ``backend="gloo"``. Nothing
switches backend on its own.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..utils.deadline import env_timeout

__all__ = ["ParallelEnv", "init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "current_device", "get_backend"]

_env = {"device": None, "backend": None}


def _env_int(*names, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


class ParallelEnv:
    """Rank information of this process (``paddle.distributed.ParallelEnv``)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=get_rank())

    @property
    def device_id(self) -> int:
        return self.local_rank

    @property
    def dev_id(self) -> int:
        return self.local_rank


def init_parallel_env(backend: Optional[str] = None,
                      mesh_shape: Optional[dict] = None, *, device=None,
                      store=None, rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      timeout: Optional[float] = None) -> ParallelEnv:
    """Join the process group, then install a mesh: ``mesh_shape``, or
    ``{"dp": world_size}`` (pure data parallelism, as the JAX function).

    ``device`` defaults to ``cuda`` (``cuda:<local rank mod the card
    count>``), ``backend`` to ``nccl`` on ``cuda`` and ``gloo`` on the CPU.
    The rendezvous is ``store`` (a ``torch.distributed.Store``, e.g. a
    ``FileStore``), else ``env://`` from ``MASTER_ADDR``/``MASTER_PORT``
    (or ``PADDLE_MASTER``); a world of one
    with none of these uses an in-process store. ``timeout`` (seconds,
    default ``PT_COMM_DEADLINE`` or 60) bounds every wait of the group, so
    a stalled peer raises instead of hanging."""
    from ..parallel import mesh as mesh_mod
    if rank is None:
        rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    if world_size is None:
        world_size = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local_rank = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=rank)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a cuda device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        secs = timeout if timeout is not None else env_timeout(
            "PT_COMM_DEADLINE", 60.0)
        kw = dict(backend=backend, rank=rank, world_size=world_size,
                  timeout=datetime.timedelta(seconds=secs))
        if backend == "nccl":       # bind the card: no guess from the rank
            kw["device_id"] = dev
        if store is not None:
            kw["store"] = store
        elif world_size == 1 and "MASTER_ADDR" not in os.environ \
                and "PADDLE_MASTER" not in os.environ:
            kw["store"] = dist.HashStore()
        else:
            if "MASTER_ADDR" not in os.environ and "PADDLE_MASTER" in \
                    os.environ:
                host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
                os.environ["MASTER_ADDR"] = host
                os.environ.setdefault("MASTER_PORT", port)
            kw["init_method"] = "env://"
        dist.init_process_group(**kw)
    _env["device"], _env["backend"] = dev, dist.get_backend()
    if mesh_mod.get_mesh() is None or mesh_shape is not None:
        mesh_mod.init_mesh(mesh_shape or {"dp": dist.get_world_size()},
                           device=dev, backend=_env["backend"])
    return ParallelEnv()


def current_device() -> torch.device:
    """The device ``init_parallel_env`` chose; before it, the default entry
    point device (``cuda``, raising without one)."""
    return _env["device"] if _env["device"] is not None \
        else resolve_device(None)


def get_backend(group=None) -> Optional[str]:
    """The backend of the process group (None before it exists)."""
    if not dist.is_initialized():
        return None
    return dist.get_backend(group) if group is not None \
        else dist.get_backend()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank: in the world, or in ``group`` (a
    ``collective.Group``)."""
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() else 1
