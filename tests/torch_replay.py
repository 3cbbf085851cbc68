"""A capture backend for the CPU: stands in for CUDA graphs in the tests
of ``paddle_tpu_torch.jit.capture`` and of the engine's and the train
step's captured paths.

``capture`` runs the step once on the wrapper's static inputs and keeps
its outputs; a graph capture records kernels without running them, so
every tensor of the arguments is put back afterwards to what it held
before (a train step's parameters and moments take one update, not two;
the inplace caches of a serving step get the values the warm-up wrote).
``replay`` runs it again on the same static inputs and writes the results
into those outputs, as a graph replay writes its static output buffers. A
graph replay runs no Python, so the kernel launch counters the re-run
bumps are put back and the comms records it makes are held back (the
wrapper adds the captured ones itself). ``holds_graphs = True`` on an
instance makes it refuse a step's declared hazards as the card's backend
does. It imports no JAX.
"""
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.distributed.comms import held_records
from paddle_tpu_torch.jit.capture import _kernel_counters


class ReplayBackend:
    holds_graphs = False

    def __init__(self):
        self.warmups = 0
        self.captures = 0
        self.replays = 0

    def warmup(self, fn, args, kwargs):
        self.warmups += 1
        return fn(*args, **kwargs)

    def capture(self, fn, args, kwargs):
        self.captures += 1
        state = [t for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)]
        saved = [t.detach().clone() for t in state]
        out = fn(*args, **kwargs)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        return (fn, args, kwargs, out), out

    def replay(self, graph):
        self.replays += 1
        fn, args, kwargs, out = graph
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        with held_records():
            new = fn(*args, **kwargs)
        for c, b in zip(counters, before):
            c.launches = b
        for dst, src in zip(tree_leaves(out), tree_leaves(new)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def pool_bytes(self):
        return 0


class _OpTape(TorchDispatchMode):
    """Every op dispatched inside, with its arguments and outputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _same_view(a, b) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class GraphReplayBackend(ReplayBackend):
    """A CPU stand-in that replays as a CUDA graph does: ``capture``
    records every op the step dispatches (forward, backward, update and
    collectives, each with its Python arguments frozen) and then puts the
    arguments' tensors back; ``replay`` runs those ops again in order on
    the same tensors, writing each result into the tensor the capture
    produced, with no Python of the step. A value the step read on the
    host at capture time (a learning rate as a Python float, a step count)
    stays baked into every replay, as on the card."""

    def capture(self, fn, args, kwargs):
        self.captures += 1
        state = [t for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)]
        saved = [t.detach().clone() for t in state]
        tape = _OpTape()
        with tape:
            out = fn(*args, **kwargs)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        return (tape.ops, out), out

    def replay(self, graph):
        self.replays += 1
        ops, _ = graph
        with torch.no_grad():
            for func, args, kwargs, out in ops:
                res = func(*args, **kwargs)
                for dst, src in zip(tree_leaves(out), tree_leaves(res)):
                    if isinstance(dst, torch.Tensor):
                        if dst is not src and not _same_view(dst, src):
                            dst.copy_(src)
                    elif hasattr(src, "wait"):
                        src.wait()
