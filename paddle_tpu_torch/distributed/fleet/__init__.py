"""Counterpart of ``paddle_tpu.distributed.fleet``: the fleet facade
(``init``, ``distributed_model``, ``distributed_optimizer``), the
strategy, the role makers, the topology, ``meta_parallel`` (the
tensor-parallel layers, the RNG tracker, the pipeline layers and
wrappers, the ZeRO wrappers), ``recompute``, the mixture-of-experts layer
over an ep axis (``moe``), ``util`` (``UtilBase``, the data generators,
``Fleet``) and ``utils`` (``LocalFS``, ...)."""
from . import meta_parallel  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet import (  # noqa: F401
    distributed_model, distributed_optimizer, get_hybrid_communicate_group,
    init, is_first_worker, is_server, is_worker, worker_endpoints,
    worker_index, worker_num,
)
from .hybrid_optimizer import HybridParallelOptimizer  # noqa: F401
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate  # noqa: F401
from .recompute import (  # noqa: F401
    recompute, recompute_hybrid, recompute_sequential,
)
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode, get_hcg,
    set_hcg,
)
from .util import (  # noqa: F401
    DataGenerator, Fleet, MultiSlotDataGenerator,
    MultiSlotStringDataGenerator, UtilBase,
)
from . import utils  # noqa: F401
