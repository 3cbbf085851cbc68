"""paddle_tpu_torch.distributed.embedding: sharded embedding tables.

Counterpart of ``paddle_tpu.distributed.embedding``: rows hash-bucketed and
row-sharded over a named mesh axis, a rank holding its block, and a lookup
the redistribution of arxiv 2112.01075 (local unique -> id all_to_all ->
local gather -> wire return), both legs through ``distributed.comms``.
"""
from .sharded import (  # noqa: F401
    ShardedEmbedding, hash_bucket, sharded_lookup, table_param_spec,
    unique_static,
)
