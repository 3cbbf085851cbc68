"""The fleet facade: ``init``, ``distributed_model``,
``distributed_optimizer`` and the worker queries.

Counterpart of ``paddle_tpu/distributed/fleet/fleet.py`` (after Paddle's
``fleet/fleet.py`` and ``fleet/model.py``). ``init`` joins the process
group (``init_parallel_env``, unless it is up already), builds the
strategy's topology and installs its mesh (``HybridCommunicateGroup``:
every rank calls it). ``distributed_optimizer`` applies the strategy's
optimizer swaps and wraps it in a ``HybridParallelOptimizer``, whose tags
(ZeRO stage and axis, accumulation) ``build_hybrid_train_step`` and
``TrainStep`` read on the installed mesh (``hcg.mesh``).
"""
from __future__ import annotations

from typing import Optional

from ..env import init_parallel_env, is_initialized
from .distributed_strategy import DistributedStrategy
from .meta_parallel.parallel_wrappers import (PipelineParallel,
                                              ShardingParallel,
                                              TensorParallel)
from .meta_parallel.pp_layers import PipelineLayer
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       ParallelMode, get_hcg, set_hcg)

__all__ = ["init", "distributed_model", "distributed_optimizer",
           "worker_num", "worker_index", "is_worker", "is_server",
           "worker_endpoints", "is_first_worker",
           "get_hybrid_communicate_group"]


class _FleetState:
    def __init__(self):
        self.strategy: Optional[DistributedStrategy] = None
        self.is_collective = True
        self.initialized = False
        self.role_maker = None


_state = _FleetState()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    if strategy is None:
        strategy = DistributedStrategy()
    if not is_initialized():
        init_parallel_env()
    if role_maker is None:
        from .role_maker import PaddleCloudRoleMaker
        role_maker = PaddleCloudRoleMaker(is_collective=is_collective)
    _state.strategy = strategy
    _state.is_collective = is_collective
    _state.role_maker = role_maker
    hc = strategy.hybrid_configs
    order = hc.get("order", ["dp", "pp", "sharding", "sep", "mp"])
    name_map = {"dp": "data", "pp": "pipe", "sharding": "sharding",
                "sep": "sep", "mp": "model"}
    deg = {"dp": hc.get("dp_degree", 1), "pp": hc.get("pp_degree", 1),
           "sharding": hc.get("sharding_degree", 1),
           "sep": hc.get("sep_degree", 1), "mp": hc.get("mp_degree", 1)}
    names = [name_map[a] for a in order if a in name_map]
    dims = [int(deg.get(a, 1)) for a in order if a in name_map]
    set_hcg(HybridCommunicateGroup(CommunicateTopology(names, dims)))
    _state.initialized = True
    return None


def distributed_model(model):
    """The model wrapped for the parallel mode (fleet/model.py:30)."""
    hcg = get_hcg()
    if hcg is None:
        return model
    strategy = _state.strategy
    mode = hcg.get_parallel_mode()
    if mode == ParallelMode.DATA_PARALLEL:
        from ..parallel import DataParallel
        return DataParallel(model)
    if mode == ParallelMode.PIPELINE_PARALLEL:
        if isinstance(model, PipelineLayer):
            return PipelineParallel(model, hcg, strategy)
        raise TypeError("pipeline parallel requires a PipelineLayer model")
    if mode == ParallelMode.SHARDING_PARALLEL:
        return ShardingParallel(model, hcg, strategy)
    return TensorParallel(model, hcg, strategy)


def distributed_optimizer(optimizer, strategy=None):
    from .hybrid_optimizer import (HybridParallelOptimizer,
                                   apply_meta_optimizers)
    strategy = strategy or _state.strategy
    optimizer = apply_meta_optimizers(optimizer, strategy)
    hcg = get_hcg()
    if hcg is None:
        return optimizer
    return HybridParallelOptimizer(optimizer, hcg, strategy)


def worker_num():
    if _state.role_maker is not None:
        return _state.role_maker._worker_num()
    from ..env import get_world_size
    return get_world_size()


def worker_index():
    if _state.role_maker is not None:
        return _state.role_maker._worker_index()
    from ..env import get_rank
    return get_rank()


def is_worker():
    return _state.role_maker is None or _state.role_maker._is_worker()


def is_server():
    return _state.role_maker is not None and _state.role_maker._is_server()


def worker_endpoints(to_string=False):
    eps = _state.role_maker._get_trainer_endpoints() \
        if _state.role_maker is not None else []
    return ",".join(eps) if to_string else eps


def is_first_worker():
    return worker_index() == 0


def get_hybrid_communicate_group():
    return get_hcg()
