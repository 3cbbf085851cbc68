"""``paddle.distributed.sharding``: re-exports the group-sharded API
(counterpart of ``paddle_tpu/distributed/sharding.py``)."""
from .fleet.meta_parallel.sharding_optimizer import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
