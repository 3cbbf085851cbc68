"""Incubating operators (counterpart of ``paddle_tpu.incubate``); only
``nn.functional.fused_linear_cross_entropy`` is ported so far."""
