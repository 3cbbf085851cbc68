"""A capture backend for the CPU: stands in for CUDA graphs in the tests
of ``paddle_tpu_torch.jit.capture`` and of the engine's captured path.

``capture`` runs the step once on the wrapper's static inputs (the
inplace caches hold the values the warm-up just wrote, so the writes
repeat them) and keeps its outputs; ``replay`` runs it again on the same
static inputs and writes the results into those outputs, as a graph
replay writes its static output buffers. A graph replay runs no Python,
so the kernel launch counters the re-run bumps are put back (the wrapper
adds the captured counts itself). It imports no JAX.
"""
import torch
from torch.utils._pytree import tree_leaves

from paddle_tpu_torch.jit.capture import _kernel_counters


class ReplayBackend:
    def __init__(self):
        self.warmups = 0
        self.captures = 0
        self.replays = 0

    def warmup(self, fn, args, kwargs):
        self.warmups += 1
        return fn(*args, **kwargs)

    def capture(self, fn, args, kwargs):
        self.captures += 1
        out = fn(*args, **kwargs)
        return (fn, args, kwargs, out), out

    def replay(self, graph):
        self.replays += 1
        fn, args, kwargs, out = graph
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        new = fn(*args, **kwargs)
        for c, b in zip(counters, before):
            c.launches = b
        for dst, src in zip(tree_leaves(out), tree_leaves(new)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def pool_bytes(self):
        return 0
