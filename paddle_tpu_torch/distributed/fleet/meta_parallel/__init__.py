"""Tensor- and sequence-parallel layers (``mp_layers``), the named RNG
states (``random_state``), the pipeline layers (``pp_layers``) and model
wrappers (``parallel_wrappers``), and the ZeRO wrappers
(``sharding_optimizer``)."""
from .mp_layers import (  # noqa: F401
    AllGatherOp, ColumnParallelLinear, ColumnSequenceParallelLinear,
    GatherOp, ParallelCrossEntropy, ReduceScatterOp, RowParallelLinear,
    RowSequenceParallelLinear, ScatterOp, VocabParallelEmbedding,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
from .random_state import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .sharding_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, GroupShardedOptimizerStage2, GroupShardedStage2,
    GroupShardedStage3, group_sharded_parallel, save_group_sharded_model,
    shard_layer_params,
)
from .pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc,
)
from .parallel_wrappers import (  # noqa: F401
    PipelineParallel, PipelineParallelWithInterleave, SegmentParallel,
    ShardingParallel, TensorParallel,
)
