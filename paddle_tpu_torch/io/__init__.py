"""paddle_tpu_torch.io: counterpart of ``paddle_tpu/io`` (Paddle's
python/paddle/io/: datasets, samplers, the DataLoader and the streaming
ingestion with its exactly-once cursors). Batches come out as torch
tensors on an explicit device."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler, BatchSampler,
    DistributedBatchSampler,
)
from ..utils.deadline import DataLoaderTimeout  # noqa: F401 — sibling of
# DataLoaderWorkerError: both halves of the DataLoader failure contract
# are importable from paddle_tpu_torch.io
from .dataloader import (  # noqa: F401
    DataLoader, DataLoaderWorkerError, WorkerInfo, default_collate_fn,
    get_worker_info,
)
from .streaming import (  # noqa: F401
    ShardedSampleStream, StreamLoader, restore_stream_checkpoint,
    save_stream_checkpoint, save_stream_sharded,
)
