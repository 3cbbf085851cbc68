"""Counterpart of ``paddle_tpu.distributed.fleet``: the tensor-parallel
layers so far (``meta_parallel``). The fleet wrappers, the topology and
the pipeline layers wait for a later slice (ROADMAP.md)."""
from . import meta_parallel  # noqa: F401
