"""paddle_tpu_torch.distributed: counterpart of ``paddle_tpu.distributed``.

Ported so far: the environment (``init_parallel_env``, ``ParallelEnv``),
``shard_batch``, Paddle's collective API over the mesh's process groups
(``collective``), the quantized, accounted comms layer (``comms``), the
tensor- and sequence-parallel layers (``fleet.meta_parallel``) and fault
injection (``chaos``). The pipeline layers, ZeRO, the fleet wrappers,
checkpoints, the store, rpc and the supervisor wait for later slices
(ROADMAP.md).
"""
from . import chaos  # noqa: F401
from . import comms  # noqa: F401
from . import env  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, ReduceOp, Group, all_gather, all_gather_object, all_reduce,
    all_to_all, alltoall, barrier, batch_isend_irecv, broadcast,
    destroy_process_group, gather, get_backend, get_group, irecv, isend,
    new_group, recv, reduce, reduce_scatter, scatter, send, wait,
)
from .env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .parallel import shard_batch  # noqa: F401
from ..parallel.mesh import get_mesh, init_mesh  # noqa: F401
