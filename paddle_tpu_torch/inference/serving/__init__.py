"""paddle_tpu_torch.inference.serving: continuous-batching inference.

A paged KV-cache pool with capacity-based admission and ref-counted
committed pages (``kv_pool``), a scheduler that joins and evicts requests
strictly between decode steps (``scheduler``), the request lifecycle with
typed per-request TTLs (``request``), the engine that drives bucketed
prefill and batch-slot decode through the ragged decode kernel, each step
a CUDA graph on the card (``engine``), speculative-decoding drafters
(``speculative``), prefix sharing over committed pages (``prefix``), and
the socket front end (``gateway``: ServingGateway and GatewayClient).
"""
from .engine import SamplingUnsupported, ServingEngine, serving_info  # noqa: F401
from .kv_pool import (  # noqa: F401
    KVPagePool, Page, PageUncommitted, PoolExhausted)
from .prefix import PrefixCache  # noqa: F401
from .request import Request, RequestState  # noqa: F401
from .scheduler import ContinuousBatchingScheduler  # noqa: F401
from .speculative import (  # noqa: F401
    Drafter, DraftModelDrafter, NGramDrafter, build_drafter)

__all__ = ["SamplingUnsupported", "ServingEngine", "serving_info",
           "KVPagePool", "Page", "PageUncommitted", "PoolExhausted",
           "PrefixCache", "Request", "RequestState",
           "ContinuousBatchingScheduler", "Drafter", "NGramDrafter",
           "DraftModelDrafter", "build_drafter"]
