"""Counterpart of ``paddle_tpu.distributed.fleet``: the fleet facade
(``init``, ``distributed_model``, ``distributed_optimizer``), the
strategy, the role makers, the topology and ``meta_parallel`` (the
tensor-parallel layers, the pipeline layers and wrappers, the ZeRO
wrappers). ``recompute``, ``util`` and ``moe`` wait for a later slice
(ROADMAP.md)."""
from . import meta_parallel  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet import (  # noqa: F401
    distributed_model, distributed_optimizer, get_hybrid_communicate_group,
    init, is_first_worker, is_server, is_worker, worker_endpoints,
    worker_index, worker_num,
)
from .hybrid_optimizer import HybridParallelOptimizer  # noqa: F401
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode, get_hcg,
    set_hcg,
)
