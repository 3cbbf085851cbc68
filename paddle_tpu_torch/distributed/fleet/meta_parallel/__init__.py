"""Tensor- and sequence-parallel layers (``mp_layers``)."""
from .mp_layers import (  # noqa: F401
    AllGatherOp, ColumnParallelLinear, ColumnSequenceParallelLinear,
    GatherOp, ParallelCrossEntropy, ReduceScatterOp, RowParallelLinear,
    RowSequenceParallelLinear, ScatterOp, VocabParallelEmbedding,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
