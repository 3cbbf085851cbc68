"""Incubating APIs: counterpart of ``paddle_tpu/incubate``. ``nn`` (the
fused transformer layers and functionals, fused RoPE, masked decode
attention, the fused linear + cross-entropy on K5-K7), ``asp`` (2:4
pruning), ``autograd``, ``optimizer``, and the segment, graph and fused
softmax-mask ops with ``LookAhead`` and ``ModelAverage``."""
from . import asp  # noqa: F401
from . import autograd  # noqa: F401
from . import optimizer  # noqa: F401
from . import nn  # noqa: F401
from .ops import (  # noqa: F401
    LookAhead, ModelAverage, graph_khop_sampler, graph_reindex,
    graph_sample_neighbors, graph_send_recv, identity_loss, segment_max,
    segment_mean, segment_min, segment_sum, softmax_mask_fuse,
    softmax_mask_fuse_upper_triangle,
)
