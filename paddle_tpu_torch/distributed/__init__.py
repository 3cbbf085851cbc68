"""paddle_tpu_torch.distributed: counterpart of ``paddle_tpu.distributed``.

Ported so far: the environment (``init_parallel_env``, ``ParallelEnv``,
``spawn``), ``shard_batch`` and ``DataParallel``, Paddle's collective API
over the mesh's process groups (``collective``), the quantized,
accounted comms layer (``comms``), the fleet (``fleet``: the facade, its
topology and strategy, the tensor-parallel, pipeline and ZeRO layers,
``recompute``, the RNG tracker, MoE over an ep axis and the utilities),
the ``sharding`` facade, sharded checkpoints (``checkpoint``) and their
durable generations (``CheckpointManager``), crash and fault injection
(``chaos``), and the elastic tier: the ``TCPStore`` on the host runtime,
``rpc``, live resharding (``reshard``), the elastic ``Supervisor`` and the
launcher with its elastic membership (``launch``), and the row-sharded
embedding tables (``embedding``). The auto-parallel API and the gloo
compat names wait for later slices (ROADMAP.md).
"""
from . import chaos  # noqa: F401
from . import checkpoint  # noqa: F401
from . import comms  # noqa: F401
from . import embedding  # noqa: F401
from .embedding import ShardedEmbedding  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, ReduceOp, Group, all_gather, all_gather_object, all_reduce,
    all_to_all, alltoall, barrier, batch_isend_irecv, broadcast,
    destroy_process_group, gather, get_backend, get_group, irecv, isend,
    new_group, recv, reduce, reduce_scatter, scatter, send, wait,
)
from .env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .checkpoint import (  # noqa: F401
    CheckpointCorruptionError, load_state_dict, save_state_dict,
)
from .ckpt_manager import CheckpointManager  # noqa: F401
# the live-resharding submodule owns the name `reshard` (calling it, the
# JAX package's auto-parallel API, raises NotInThisSlice)
from . import reshard  # noqa: F401
from . import supervisor  # noqa: F401
from .supervisor import Supervisor, SupervisedParam  # noqa: F401
from .store import TCPStore  # noqa: F401
from . import rpc  # noqa: F401
from . import launch  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
from .fleet.topology import ParallelMode  # noqa: F401
from .parallel import DataParallel, shard_batch  # noqa: F401
from ..parallel.mesh import get_mesh, init_mesh  # noqa: F401


def _spawn_main(index, func, args, nprocs, master):
    """One spawned rank: the launcher's variables, then ``func(*args)``."""
    import os
    host, port = master
    os.environ.update({
        "PADDLE_TRAINER_ID": str(index), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_LOCAL_RANK": str(index), "RANK": str(index),
        "WORLD_SIZE": str(nprocs), "LOCAL_RANK": str(index),
        "MASTER_ADDR": host, "MASTER_PORT": str(port),
        "PADDLE_MASTER": f"{host}:{port}"})
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes (default: one per visible card,
    ``env.parallel_device_count()``) that each run ``func(*args)`` with the
    launcher's variables set (rank, world size, local rank and a
    rendezvous on a free localhost port), so ``init_parallel_env()``
    inside ``func`` joins them (Paddle's ``distributed.spawn``; the JAX
    function runs ``func`` once in its one process). ``func`` must be
    importable by the children (the ``spawn`` start method). ``join``
    waits and raises if a rank failed; otherwise the
    ``torch.multiprocessing`` context is returned."""
    import socket

    import torch.multiprocessing as mp
    from .env import parallel_device_count
    n = parallel_device_count() if nprocs in (None, -1) else int(nprocs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return mp.start_processes(_spawn_main,
                              args=(func, tuple(args), n,
                                    ("127.0.0.1", port)),
                              nprocs=n, join=join, daemon=daemon,
                              start_method=options.get("start_method",
                                                       "spawn"))
