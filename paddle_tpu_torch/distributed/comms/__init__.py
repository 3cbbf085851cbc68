"""paddle_tpu_torch.distributed.comms: quantized, accounted collectives.

Counterpart of ``paddle_tpu/distributed/comms``: the blockwise int8/fp8
wire format (``quantize``), the routed collectives with the opt-in
``quantized()`` context, the two-shot all-reduce and the trainer's
``grad_sync`` (``api``), and the CommOp records behind ``comm_info()``
(``schedule``).
"""
from .api import (  # noqa: F401
    GLOO_CUDA_NATIVE, comm_deadline, comms_cache_key, grad_sync, link,
    quant_state, quantized, quantized_all_reduce, wire_all_gather,
    wire_all_reduce, wire_all_to_all, wire_broadcast, wire_exchange,
    wire_reduce_scatter, wire_sendrecv,
)
from .quantize import (  # noqa: F401
    DEFAULT_BLOCK, dequantize_blockwise, logical_bytes, quantize_blockwise,
    wire_bytes,
)
from .schedule import (  # noqa: F401
    CommOp, CommSchedule, comm_clear, comm_info, current_schedule, record,
    step_schedule,
)
