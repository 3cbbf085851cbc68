"""The general train step: ``TrainStep`` and ``compile_train_step``, on
one device or over a mesh (dp, mp, sep, pp and sharding axes, ZeRO).

Counterpart of ``paddle_tpu/parallel/trainer.py`` (:127-546), where the
whole step (forward, backward, clip, update, the grad-finite skip and the
dynamic loss scale) is one jitted program with donated buffers, built
through ``jit/capture.py``'s ``lower_step``. Here too: the first call is
the eager warm-up of ``jit.capture.lower_step`` and the step is then one
CUDA graph (forward, backward, U1, U2 or the rule's ops), replayed by
every later call with the same batch signature (``captured_program``,
``lower_text``, ``memory_stats``). To make that possible the step keeps
everything that decides it on the device, with no host read inside it,
and reads the learning rate and the step count from 0-dim device tensors
that ``__call__`` writes before each call:

- ``loss_fn(model, batch)`` gives the loss (a scalar, or a ``LossSum``);
  with a scaler it is multiplied
  by the loss scale inside the differentiated function, and after the
  backward the grads are unscaled by ``1 / scale`` (:295-327);
- ``accumulate_steps``: the batch's leaves are split along dim 0, the
  mean loss and the mean grads taken;
- one pass over the unscaled grads (kernel U1 on the card) gives the
  global grad-finite flag, judged on the raw grads (:329-338), and the
  sums of squares for a ``ClipGradByGlobalNorm``, whose scale stays on the
  device; a ``ClipGradByValue`` clamps the unscaled grads (:350-359);
- the optimizer's ``_multi_update`` applies the unscale, the clip scale
  and the rule in place (kernel U2 for Adam and AdamW on the card), and
  under a non-finite flag writes nothing: params and moments stay bit for
  bit what they were (:365-373);
- the health state (loss scale, good and bad streaks, skipped steps) is
  0-dim device tensors, updated branch-free as ``AmpScaler.update`` with
  the floor at 1.0 and the cap at ``MAX_LOSS_SCALE`` (:375-392);
- the step count advances on a skipped step too (:446-448).

Over a mesh (``mesh``, default the installed one) with dp and mp axes:
every rank passes the GLOBAL batch, splits it into micro-batches as the
JAX step does, and keeps its block of each on the dp axis (``batch_spec``'s
first axis on the mesh, dim 0 of every leaf). The JAX step evaluates
``loss_fn`` on the global batch. A scalar loss here is a rank's own: the
loss is the mean of the dp ranks' losses and the grads are averaged over
dp (``_comms_grad_sync``: exact, or the quantized two-shot inside
``comms.quantized()``), as Paddle's DataParallel does. That is the JAX
step's loss only when every rank's share weighs the same; a mean over
tokens with ignored labels does not. Such a loss returns a ``LossSum``
(e.g. ``LlamaForCausalLM.loss_sum``): the step divides each rank's sum by
the count summed over dp and sums loss and grads over dp, which is the
JAX step's mean over the global batch. The model's tensor-parallel layers do their own mp collectives; the
grads of sequence-parallel parameters are summed over mp. The global-norm
clip sums the squares of the sharded grads over the axes they are split
over and counts the replicated ones once. The grad-finite flag is judged
on each rank's raw grads before the sync and all-reduced over every rank,
so all ranks skip a step together; the clip's sums come from a second U1
launch over the synced grads.

A sep axis (the model's ``context_parallel``): each rank also keeps its
chunk of the sequence (dim 1 of every leaf with two dims or more), a
``LossSum`` count is summed over dp and sep, and loss and grads are
synced over both. A pp or ``sharding`` axis is what the JAX step makes of
it (:249-257): params keep their own spec, the batch is split over
``batch_spec`` only, so those ranks compute the same step. ZeRO
(``optimizer._shard_stage`` >= 1, the axis ``_resolve_zero_axis`` picks):
each rank holds the slice ``_zero_state_spec`` gives of every state leaf
and updates its slice of the parameter (``ZeroShards``); stage 2
reduce-scatters the grads over a dp ZeRO axis; stage 3 keeps the params
sharded between steps: the model's parameters are released, and a read
through ``param_value`` (``paddle_tpu_state``, a checkpoint) gathers or
takes the slices (``write_back()`` makes them whole).

``reshard(new_mesh, state=None)`` moves the step onto a new mesh after an
elastic shrink or grow of the dp (or sharding) axis (trainer.py:459-490).
In the JAX package every device's shard still exists in the one program
and a ``device_put`` moves it. Here a rank is a process and its shards die
with it, so the step re-forms the process groups over the new roster
(``mesh.reform_world`` for a mesh from ``mesh.elastic_mesh``), re-partitions
the parameters and every optimizer state to the new ZeRO degree, keeps the
health scalars (loss scale, streaks, skipped steps) as they are, and drops
the old mesh's ``ZeroShards``. A value this rank does not hold comes from
``state`` (a name -> array dict in ``supervised_state()``'s names, each
array this rank's block on the new mesh; the supervisor passes its
resharded host state). ``supervised_state()`` gives those names with
their ``SupervisedParam`` layouts and this rank's blocks as host arrays
read on demand. ``reshard`` drops the captured graph (its addresses
name the old tensors); the next call captures anew.

What a CUDA graph cannot hold runs eagerly, counted as a capture bailout
with its reason (``jit.capture.capture_info()``): a step over a gloo
mesh (its collectives go through the host) and a ZeRO step (its gathers
are not captured in this slice). ``PT_STEP_CAPTURE=0`` runs every step
eagerly. On the CPU the step runs eagerly unless a capture backend is
installed (the tests install one that re-runs the step).

A row-sharded parameter (``row_sharded``, set by
``distributed.embedding.ShardedEmbedding`` on a live axis) holds this
rank's block of rows, and its grad is complete on its owner: the
exchange's backward summed every rank's row gradients there. It is left
out of the dp grad sync and of ZeRO; under a mean over dp its grad is
divided by the axis size (the JAX step gets all this from GSPMD).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..distributed import comms
from ..distributed.parallel import shard_batch
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from ..ops.kernels.multi_tensor import multi_tensor_sumsq_finite
from . import mesh as mesh_mod

__all__ = ["TrainStep", "compile_train_step", "LossSum", "MAX_LOSS_SCALE",
           "ZeroShards", "param_value", "StepMemoryStats"]

# Dynamic loss scaling never grows past this: with tiny gradients the
# overflow signal that normally bounds growth never fires, and a scale
# doubled past the fp32 range is inf, which every later step would skip on.
MAX_LOSS_SCALE = 2.0 ** 31


class LossSum(NamedTuple):
    """A loss that ``loss_fn`` hands back as this rank's sum over rows
    (e.g. tokens) and their count (e.g. the labels that are not -100).
    The step takes the sum over dp of ``total`` over the sum over dp of
    ``count`` (at least 1): the mean over the global batch's rows."""
    total: torch.Tensor
    count: torch.Tensor


class StepMemoryStats(NamedTuple):
    """``TrainStep.memory_stats``: bytes by XLA's field names."""
    argument_size_in_bytes: int
    alias_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int


def _array_leaves(tree, out: list) -> None:
    """The tensor and numpy array leaves of nested dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        for v in tree.values():
            _array_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _array_leaves(v, out)
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append(tree)


def _mesh_axes(mesh) -> dict:
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _comms_grad_sync(grads, mesh, axis="dp", op="avg"):
    """The data-parallel grad sync (trainer.py:119-124): the mean (or, for
    a ``LossSum``, the sum) over ``axis``, exact or quantized by the comms
    context."""
    return comms.grad_sync(grads, mesh=mesh, axis=axis, op=op)


def _resolve_zero_axis(axis, mesh):
    """The ZeRO axis on the live mesh (trainer.py:84): ``axis`` when it is
    on the mesh above 1, else ``dp`` when that is above 1 (Fleet's default
    sharding degree is the dp degree), else None (states stay whole)."""
    if axis is None or mesh is None:
        return axis
    shape = dict(getattr(mesh, "shape", {}))
    if shape.get(axis, 1) > 1:
        return axis
    if shape.get("dp", 1) > 1:
        return "dp"
    return None


def _zero_state_spec(param_spec, shape, axis, mesh):
    """The spec of an optimizer-state leaf sharded over the ZeRO axis
    (trainer.py:100): the largest dim not already sharded whose size the
    axis divides; the param's spec when it already rides the axis (stage
    3) or no dim fits. Specs are tuples of axis names (or None) per
    dim."""
    shape_of = dict(getattr(mesh, "shape", {}))
    if axis not in shape_of or shape_of[axis] == 1:
        return tuple(param_spec)
    n = shape_of[axis]
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if any(axis == s or (isinstance(s, tuple) and axis in s) for s in spec):
        return tuple(param_spec)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % n == 0 and shape[i] >= n:
            spec[i] = axis
            return tuple(spec)
    return tuple(param_spec)


def zero_config(optimizer, mesh):
    """``(axis, stage)`` of the optimizer's ZeRO tags on ``mesh``: the
    axis resolved by ``_resolve_zero_axis``; ``(None, 0)`` when nothing is
    sharded."""
    base = optimizer
    tags = [optimizer]
    while hasattr(base, "inner_opt"):
        base = base.inner_opt
        tags.append(base)
    axis = next((getattr(o, "_shard_axis", None) for o in reversed(tags)
                 if getattr(o, "_shard_axis", None)), None)
    stage = max(int(getattr(o, "_shard_stage", 0) or 0) for o in tags)
    axis = _resolve_zero_axis(axis, mesh)
    if not axis or stage < 1 or mesh is None \
            or dict(mesh.shape).get(axis, 1) <= 1:
        return None, 0
    return axis, stage


def param_spec(p, mesh=None) -> tuple:
    """A port parameter's spec as the JAX package cleans it
    (``_param_sharding_spec``): ``mp`` on its tensor-parallel dim
    (``split_axis``), overlaid with an explicit ``_sharding`` tuple
    (``shard_layer_params``) whose axes are on the mesh above 1 and divide
    the dim."""
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if getattr(p, "row_sharded", None) is not None:
        return tuple(p.dist_layout.spec)
    shape = dict(getattr(mesh, "shape", {}) or {})
    spec = [None] * p.dim()
    split = getattr(p, "split_axis", None)
    if split is not None:
        spec[split] = "mp"
    for i, s in enumerate(getattr(p, "_sharding", None) or ()):
        if s is not None and i < len(spec) and spec[i] is None \
                and shape.get(s, 1) > 1 and p.shape[i] % shape[s] == 0:
            spec[i] = s
    return tuple(spec)


def _global_shape(p, mp: int) -> tuple:
    """A parameter's global shape: its ``split_axis`` dim times mp; a
    row-sharded table's from its ``dist_layout``."""
    if getattr(p, "row_sharded", None) is not None:
        return tuple(p.dist_layout.shape)
    shape = list(p.shape)
    split = getattr(p, "split_axis", None)
    if split is not None:
        shape[split] *= mp
    return tuple(shape)


class ZeroShards:
    """ZeRO over one mesh axis for a list of trained tensors.

    ``layouts[k]`` is ``(global shape, JAX spec, local dim of each global
    dim or None)`` for tensor k; ``_zero_state_spec`` picks the dim. Rank r
    of the axis holds rows ``[r m, (r+1) m)`` of that dim of every state
    leaf, as a contiguous tensor (the rule's dim is rarely the first, so
    the slice is strided in the full tensor: it is copied in and out).

    - Stage 1: the grads are synced whole; each rank updates its slice of
      the parameter (one U2 launch over all slices and the unsharded
      tensors) and the slices are all-gathered into every full tensor.
    - Stage 2: the grads of sharded tensors are reduce-scattered over the
      axis when it carries data (dp); over a ``sharding`` axis, whose
      ranks see the same data, each rank takes its slice.
    - Stage 3: the parameter itself is sharded at rest: the rank keeps its
      fp32 slice (the master) and the full tensor exists only inside a
      step (``gather``, then ``release``).
    """

    GATHER_BYTES = 256 << 20

    def __init__(self, tensors, layouts, axis: str, stage: int, mesh):
        self.tensors = list(tensors)
        self.axis, self.stage, self.mesh = axis, int(stage), mesh
        self.n = mesh.shape[axis]
        self.r = mesh.coords[axis]
        self.layouts = list(layouts)
        self.dims, self.state_specs = [], []
        for t, (gshape, spec, local) in zip(self.tensors, layouts):
            zspec = _zero_state_spec(spec, gshape, axis, mesh)
            gd = next((i for i, s in enumerate(zspec)
                       if s == axis or (isinstance(s, tuple) and axis in s)),
                      None)
            d = None if gd is None else local[gd]
            if d is not None and t.shape[d] % self.n:
                d = None
            if getattr(t, "row_sharded", None) is not None:
                d, zspec = None, tuple(spec)   # its block is its own
            self.dims.append(d)
            self.state_specs.append(tuple(spec) if d is None else zspec)
        self.slices = [None] * len(self.tensors)
        if self.stage >= 3:
            from ..distributed.checkpoint import set_layout
            for k, (t, d) in enumerate(zip(self.tensors, self.dims)):
                if d is not None:
                    self.slices[k] = self._slice(t.detach(), k).clone()
                    set_layout(self.slices[k], self.layouts[k][0],
                               self.state_specs[k], mesh)
                    # the slice is the master: a checkpoint saves and
                    # loads it, and param_value gathers from it
                    t.zero_master = self.slices[k]
                    t.zero_ref = (self, k)
            self.release()

    def _slice(self, t, k):
        d = self.dims[k]
        m = t.shape[d] // self.n
        return t.narrow(d, self.r * m, m)

    def shard_shape(self, k):
        t = self.tensors[k]
        d = self.dims[k]
        if d is None:
            return tuple(t.shape)
        shape = list(self.full_shape(k))
        shape[d] //= self.n
        return tuple(shape)

    def full_shape(self, k):
        if self.slices[k] is not None:
            shape = list(self.slices[k].shape)
            shape[self.dims[k]] *= self.n
            return tuple(shape)
        return tuple(self.tensors[k].shape)

    def state_like(self, k):
        """A tensor of the shape and dtype this rank's state of tensor k
        has (its slice, or the whole tensor)."""
        t = self.tensors[k]
        return torch.empty(self.shard_shape(k), dtype=t.dtype,
                           device=t.device)

    # ---- stage 3: the full parameters exist only inside a step ----
    def gather(self) -> None:
        if self.stage < 3:
            return
        idx = [k for k, d in enumerate(self.dims) if d is not None]
        for k, full in zip(idx, self._all_gather([self.slices[k]
                                                   for k in idx], idx)):
            self.tensors[k].data = full

    def release(self) -> None:
        """Drop the full parameters (stage 3). Reading one between steps
        goes through ``param_value``, which gathers it from the slices."""
        if self.stage < 3:
            return
        for k, d in enumerate(self.dims):
            if d is not None:
                t = self.tensors[k]
                t.data = torch.empty(0, dtype=t.dtype, device=t.device)

    def full(self, k) -> torch.Tensor:
        """Tensor k's current full value, all-gathered from the slices at
        stage 3 (collective over the ZeRO axis), else the tensor itself."""
        if self.slices[k] is None:
            return self.tensors[k].detach()
        return self._all_gather([self.slices[k]], [k])[0]

    def annotate(self, states) -> None:
        """Tag every tensor and its state leaves with their place in the
        global arrays (``checkpoint.set_layout``): tensor k is its layout's
        block, and its state leaves (and its stage-3 slice) the block the
        ZeRO spec gives."""
        annotate_layouts(self.tensors, self.layouts, states, self.mesh,
                         self.state_specs)

    # ---- the step ----
    def sync_grads(self, grads, data_axes, op: str, owner: str, skip=()):
        """The grads each rank updates with: the data-parallel sync over
        ``data_axes`` (``op`` sum or avg), and at stage >= 2 this rank's
        slice of each sharded one (reduce-scattered when the ZeRO axis is
        a data axis). The grads at the indices ``skip`` stay as given."""
        from ..distributed import comms
        grads = list(grads)
        if self.stage < 2:
            if not data_axes:
                return grads
            idx = [k for k in range(len(grads)) if k not in skip]
            for k, g in zip(idx, comms.grad_sync([grads[k] for k in idx],
                                                 self.mesh, data_axes, owner,
                                                 op=op)):
                grads[k] = g
            return grads
        sharded = [k for k, d in enumerate(self.dims) if d is not None]
        scatter = self.axis in (data_axes or ())
        rest_axes = tuple(a for a in (data_axes or ()) if a != self.axis) \
            if scatter else data_axes
        whole = [k for k in range(len(grads))
                 if k not in sharded and k not in skip]
        if data_axes and whole:
            synced = comms.grad_sync([grads[k] for k in whole], self.mesh,
                                     data_axes, owner, op=op)
            for k, g in zip(whole, synced):
                grads[k] = g
        if rest_axes and sharded:
            synced = comms.grad_sync([grads[k] for k in sharded], self.mesh,
                                     rest_axes, owner, op=op)
            for k, g in zip(sharded, synced):
                grads[k] = g
        for k in sharded:
            d = self.dims[k]
            if scatter:
                moved = grads[k].movedim(d, 0).contiguous()
                red = comms.wire_reduce_scatter(moved, self.axis, "sum",
                                                owner=owner + ".scatter",
                                                mesh=self.mesh)
                if op == "avg":
                    red = red / self.n
                grads[k] = red.movedim(0, d).contiguous()
            else:
                grads[k] = self._slice(grads[k], k).contiguous()
        return grads

    def update(self, optimizer, grads, states, lr, step, **kw) -> None:
        """One ``_multi_update`` over every tensor's slice (or whole
        tensor), then the updated slices all-gathered into the full
        tensors (stage 1, 2; at stage 3 the slices are the masters)."""
        params = []
        for k, (t, d) in enumerate(zip(self.tensors, self.dims)):
            if d is None:
                params.append(t)
            elif self.stage >= 3:
                params.append(self.slices[k])
            else:
                params.append(self._slice(t.detach(), k).contiguous())
        if self.stage < 2:
            grads = [g if d is None else self._slice(g, k).contiguous()
                     for k, (g, d) in enumerate(zip(grads, self.dims))]
        optimizer._multi_update(params, grads, states, lr, step, **kw)
        if self.stage >= 3:
            return
        idx = [k for k, d in enumerate(self.dims) if d is not None]
        with torch.no_grad():
            for k, full in zip(idx, self._all_gather([params[k]
                                                       for k in idx], idx)):
                self.tensors[k].copy_(full)

    def _all_gather(self, slices, idx):
        """Full tensors from every rank's slices (one exact all-gather a
        dtype and bucket of ``GATHER_BYTES``)."""
        from ..distributed import comms
        out = [None] * len(idx)
        buckets, size = [[]], 0
        for j, s in enumerate(slices):
            nbytes = s.numel() * s.element_size()
            if buckets[-1] and (size + nbytes > self.GATHER_BYTES or
                                s.dtype != slices[buckets[-1][0]].dtype):
                buckets.append([])
                size = 0
            buckets[-1].append(j)
            size += nbytes
        for b in buckets:
            if not b:
                continue
            flat = torch.cat([slices[j].reshape(-1) for j in b])
            parts = comms.wire_all_gather(flat, self.axis, exact=True,
                                          mesh=self.mesh,
                                          owner="zero.param_gather")
            off = 0
            for j in b:
                s = slices[j]
                pieces = [parts[r, off:off + s.numel()].view(s.shape)
                          for r in range(self.n)]
                out[j] = torch.cat(pieces, dim=self.dims[idx[j]])
                off += s.numel()
        return out

    def state_bytes(self, states) -> int:
        return sum(v.numel() * v.element_size() for st in states
                   for v in st.values() if isinstance(v, torch.Tensor))


def annotate_layouts(tensors, layouts, states, mesh,
                     state_specs=None) -> None:
    """Tag tensors (``layouts[k]``: global shape, spec, local dims) and
    their parameter-shaped state leaves with their global layout for the
    checkpoint; ``state_specs[k]`` overrides the states' spec (ZeRO)."""
    from ..distributed.checkpoint import set_layout
    for k, (t, (gshape, spec, _)) in enumerate(zip(tensors, layouts)):
        if t.numel():
            set_layout(t, gshape, spec, mesh)
        sspec = spec if state_specs is None else state_specs[k]
        for v in states[k].values():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                set_layout(v, gshape, sspec, mesh)


def param_value(p: torch.Tensor) -> torch.Tensor:
    """``p``'s current value: a parameter that ZeRO stage 3 released
    between steps is all-gathered from its slices (collective over the
    ZeRO axis: every rank of it must call this for the same parameter)."""
    ref = getattr(p, "zero_ref", None)
    if ref is not None and p.numel() == 0:
        zs, k = ref
        return zs.full(k)
    return p.detach()


def split_global_sumsq(sums: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The global sum of squares from per-tensor sums ``sums`` [n] (fp32)
    and, per tensor, the mesh axes it is split over: the tensors of one
    set of axes are summed, all-reduced over each of its axes, and the
    sets added (a replicated tensor counted once). Every rank passes the
    same sets in the same order."""
    from ..distributed import comms
    total = torch.zeros((), dtype=torch.float32, device=sums.device)
    keys = sorted(set(tuple(a) for a in axes))
    for key in keys:
        mask = torch.tensor([tuple(a) == key for a in axes],
                            device=sums.device)
        part = torch.where(mask, sums, torch.zeros_like(sums)).sum()
        for a in key:
            part = comms.wire_all_reduce(part, a, "sum", exact=True,
                                         mesh=mesh, owner="trainer.clip")
        total = total + part
    return total


def _to_device(tree, device):
    """The batch's arrays and tensors as tensors on device (nested dicts,
    lists and tuples)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _seq_chunk(tree, mesh):
    """This rank's chunk of the sequence (dim 1) of every tensor leaf with
    two dims or more, over the sep axis (the context-parallel model reads
    its own chunk at its RoPE offset)."""
    if isinstance(tree, dict):
        return {k: _seq_chunk(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_seq_chunk(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 2:
        return shard_batch(tree, "sep", 1, mesh)
    return tree


def _split(tree, k: int, i: int):
    """The i-th of k micro-batches: each leaf's rows [i B/k, (i+1) B/k)."""
    if isinstance(tree, dict):
        return {key: _split(v, k, i) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, k, i) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.shape[0] % k:
            raise ValueError(f"batch dim {tree.shape[0]} is not a multiple "
                             f"of accumulate_steps={k}")
        n = tree.shape[0] // k
        return tree[i * n:(i + 1) * n]
    return tree


class _HostView:
    """One tensor of a train step read as a host numpy array on demand
    (``np.asarray(view)``): what ``TrainStep.supervised_state`` hands the
    supervisor, so the device-to-host copy happens only when a commit or
    a scale event reads the state, and reads the values current then."""

    __slots__ = ("_get",)

    def __init__(self, get):
        self._get = get

    def __array__(self, dtype=None, copy=None):
        t = self._get()
        a = np.asarray(t) if not isinstance(t, torch.Tensor) \
            else t.detach().to("cpu", copy=True).numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def _np_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        raise TypeError("a bfloat16 tensor has no numpy dtype: supervise "
                        "fp32 masters")
    return torch.empty((), dtype=dt).numpy().dtype


def _piece_index(zero, k, full_shape) -> tuple:
    """The global (start, stop) per dim of this rank's piece of tensor k's
    ZeRO-sharded values (its state leaves; its parameter at stage 3), or
    the whole tensor."""
    idx = [(0, int(d)) for d in full_shape]
    if zero is not None and zero.dims[k] is not None:
        d = zero.dims[k]
        m = int(full_shape[d]) // zero.n
        idx[d] = (zero.r * m, (zero.r + 1) * m)
    return tuple(idx)


def _cut(t: torch.Tensor, have: tuple, want: tuple):
    """The block ``want`` of a tensor that holds the block ``have`` (global
    (start, stop) per dim), or None when ``have`` does not cover it."""
    for (a, b), (c, d) in zip(have, want):
        if c < a or d > b:
            return None
    for dim, ((a, _), (c, d)) in enumerate(zip(have, want)):
        t = t.narrow(dim, c - a, d - c)
    return t


class TrainStep:
    """Callable train step over the model's own parameters (trained in
    place) and the optimizer state it holds (``_opt_state``)."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 batch_spec=("dp",), loss_has_aux=False, remat: bool = False,
                 accumulate_steps: Optional[int] = None, scaler=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._batch_axes = (batch_spec,) if isinstance(batch_spec, str) \
            else tuple(batch_spec)
        self._bind_mesh(mesh)
        self._step_count = 0
        self.captured_program = None
        self._dispatcher = None
        self._loss_bytes = 4          # a 0-dim fp32 loss until a step says

        inner = model
        for attr in ("_layers", "_layer"):
            while hasattr(inner, attr):
                inner = getattr(inner, attr)
        self._inner = inner
        named = [(n, p) for n, p in inner.named_parameters()
                 if p.requires_grad]
        self._param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        if not self._params:
            raise ValueError("the model has no trainable parameter")
        self._sp = [i for i, p in enumerate(self._params)
                    if getattr(p, "sequence_parallel", False)]
        self._rows = [i for i, p in enumerate(self._params)
                      if getattr(p, "row_sharded", None) is not None]
        self._device = self._params[0].device

        base_opt = optimizer
        while hasattr(base_opt, "inner_opt"):
            base_opt = base_opt.inner_opt
        self._base_opt = base_opt
        self._shard_states(lambda k, like: base_opt._init_state(like))
        if accumulate_steps is None:
            accumulate_steps = int(getattr(base_opt, "_accumulate_steps", 1)
                                   or getattr(optimizer, "_accumulate_steps",
                                              1) or 1)
        self._accumulate_steps = max(int(accumulate_steps), 1)
        self._grad_clip = getattr(base_opt, "_grad_clip", None)

        self._scaler = scaler
        self._use_scaling = bool(scaler is not None and scaler.is_enable())
        self._dynamic_scaling = bool(
            self._use_scaling and scaler.is_use_dynamic_loss_scaling())
        init_scale = float(scaler._scale) if self._use_scaling else 1.0
        self._scale_cfg = dict(
            incr_ratio=float(getattr(scaler, "_incr_ratio", 2.0)),
            decr_ratio=float(getattr(scaler, "_decr_ratio", 0.5)),
            incr_every=int(getattr(scaler, "_incr_every", 1000)),
            decr_every=int(getattr(scaler, "_decr_every", 1)),
        )
        dev = self._device
        self._health = {
            "loss_scale": torch.tensor(init_scale, dtype=torch.float32,
                                       device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "bad_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "skipped": torch.zeros((), dtype=torch.int32, device=dev),
        }
        # the step's learning rate and count, written before each call
        # and read on the device (a captured step replays with them)
        self._lr_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._step_t = torch.zeros((), dtype=torch.int32, device=dev)

    def _bind_mesh(self, mesh) -> None:
        """The mesh and what the step derives from it: the dp sync axis,
        the sep and mp extents."""
        mesh = mesh if mesh is not None else mesh_mod.get_mesh()
        big = {k: v for k, v in _mesh_axes(mesh).items() if v > 1}
        if big and not isinstance(mesh, mesh_mod.DeviceMesh):
            raise TypeError(f"a mesh with axes above 1 ({big}) must be a "
                            "DeviceMesh (parallel.init_mesh)")
        self.mesh = mesh
        self._sync_axis = next((a for a in self._batch_axes if a in big),
                               None)
        self._sep = big.get("sep", 1) > 1
        self._data_axes = tuple(a for a in (self._sync_axis,
                                            "sep" if self._sep else None)
                                if a is not None)
        self._mp = big.get("mp", 1)
        self._big = big

    def _shard_states(self, make) -> None:
        """ZeRO on the bound mesh (trainer.py:228-247: the optimizer's
        tags, the axis resolved on the mesh; each param's state sharded by
        its spec) and the optimizer state, ``make(k, like)`` giving tensor
        k's state leaves for a tensor like its piece; then the layouts for
        checkpoints and the axes each grad is split over (for the clip)."""
        mesh = self.mesh
        zaxis, zstage = zero_config(self.optimizer, mesh)
        self._zero = None
        if zstage:
            layouts = [(_global_shape(p, self._mp), param_spec(p, mesh),
                        list(range(p.dim()))) for p in self._params]
            self._zero = ZeroShards(self._params, layouts, zaxis, zstage,
                                    mesh)
            self._opt_state = [make(k, self._zero.state_like(k))
                               for k in range(len(self._params))]
            self._zero.annotate(self._opt_state)
        else:
            self._opt_state = [make(k, p) for k, p in enumerate(self._params)]
            if self._big:
                annotate_layouts(self._params, [
                    (_global_shape(p, self._mp), param_spec(p, mesh),
                     list(range(p.dim()))) for p in self._params],
                    self._opt_state, mesh)
        zsplit = self._zero is not None and self._zero.stage >= 2
        self._split_axes = [
            (("mp",) if getattr(p, "split_axis", None) is not None else ())
            + ((self._zero.axis,) if zsplit and self._zero.dims[k] is not None
               else ())
            + ((p.row_sharded,) if getattr(p, "row_sharded", None) else ())
            for k, p in enumerate(self._params)]

    # ---- one step ----
    def _loss_and_grads(self, batch, scale):
        """The mean loss (scaled), every parameter's grad (scaled, the mean
        over micro-batches; zeros for a parameter the loss does not reach)
        and whether the loss came as a ``LossSum`` (then both are this
        rank's share of a sum over dp)."""
        for p in self._params:
            p.grad = None
        acc = self._accumulate_steps
        total, summed = None, False
        for i in range(acc):
            mb = _split(batch, acc, i) if acc > 1 else batch
            if self._sync_axis is not None:
                mb = shard_batch(mb, self._sync_axis, 0, self.mesh)
            if self._sep:
                mb = _seq_chunk(mb, self.mesh)
            loss = self.loss_fn(self._inner, mb)
            if isinstance(loss, LossSum):
                count = loss.count.to(torch.float32)
                if self._data_axes:
                    count = comms.wire_all_reduce(
                        count, self._data_axes, "sum", exact=True,
                        mesh=self.mesh, owner="trainer.loss_count")
                loss = loss.total / count.clamp_min(1.0)
                summed = True
            if self._use_scaling:
                loss = loss * scale.to(loss.dtype)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        for p in self._params:
            p.grad = None
        if acc > 1:
            k = torch.full((), acc, dtype=total.dtype, device=total.device)
            total = total / k
            grads = [g / k.to(g.dtype) for g in grads]
        return total, grads, summed

    def _update_health(self, finite):
        """The health scalars' next values, written into them in place (a
        captured step replays into the same tensors)."""
        h, cfg = self._health, self._scale_cfg
        ok = finite.to(torch.int32)
        new = dict(h)
        new["skipped"] = h["skipped"] + (1 - ok)
        if self._dynamic_scaling:
            fin = finite.bool()
            zero = torch.zeros_like(h["good_steps"])
            good = torch.where(fin, h["good_steps"] + 1, zero)
            bad = torch.where(fin, zero, h["bad_steps"] + 1)
            grow = good >= cfg["incr_every"]
            shrink = bad >= cfg["decr_every"]
            scale = h["loss_scale"]
            new["loss_scale"] = torch.where(
                shrink, torch.clamp_min(scale * cfg["decr_ratio"], 1.0),
                torch.where(grow, torch.clamp_max(scale * cfg["incr_ratio"],
                                                  MAX_LOSS_SCALE), scale))
            new["good_steps"] = torch.where(grow, zero, good)
            new["bad_steps"] = torch.where(shrink, zero, bad)
        with torch.no_grad():
            for k, v in new.items():
                if v is not h[k]:
                    h[k].copy_(v)

    def _capture_hazards(self) -> list:
        """Why a CUDA graph cannot hold this step (empty when it can)."""
        out = []
        if self._big and getattr(self.mesh, "backend", None) == "gloo":
            out.append("gloo collectives go through the host and cannot "
                       "be held in a CUDA graph")
        if self._zero is not None:
            out.append(f"ZeRO stage {self._zero.stage}: its parameter "
                       f"gathers are not captured in this slice")
        return out

    def __call__(self, batch):
        batch = _to_device(batch, self._device)
        self._step_count += 1
        self._lr_t.fill_(self._base_opt.get_lr())
        self._step_t.fill_(self._step_count)
        args = (self._params, self._opt_state, self._health, batch,
                self._lr_t, self._step_t)
        if self._dispatcher is None:
            from ..jit import capture
            self._dispatcher, self.captured_program = capture.lower_step(
                self._step, args, inplace=(0, 1, 2, 4, 5), name="TrainStep",
                hazards=self._capture_hazards())
            loss = self._dispatcher.first_result
        else:
            loss = self._dispatcher(*args)
        self._loss_bytes = loss.element_size()
        # a replay's loss is the graph's static buffer: hand out a copy
        return loss.clone()

    def _step(self, params, states, health, batch, lr, step):
        """One step over the bound state (``params``, ``states`` and
        ``health`` are the step's own lists, passed so that a capture
        holds them by address); returns the loss."""
        scale = health["loss_scale"]
        if self._zero is not None:
            self._zero.gather()
        loss, grads, summed = self._loss_and_grads(batch, scale)
        inv = None
        if self._use_scaling:
            inv = torch.reciprocal(scale)
        if self._big:
            # judged on the raw local grads, before the sync (the quantized
            # wire's inf/nan guard would make a poisoned grad look finite,
            # trainer.py:340-347), then every rank skips together: the
            # non-finite flag's max over all ranks
            _, _, finite = multi_tensor_sumsq_finite(grads, inv)
            bad = comms.wire_all_reduce(1 - finite, None, "max", exact=True,
                                        mesh=self.mesh,
                                        owner="trainer.grad_finite")
            finite = 1 - bad
        op = "sum" if summed else "avg"
        if self._data_axes:
            loss = comms.wire_all_reduce(loss, self._data_axes, op,
                                         exact=True, mesh=self.mesh,
                                         owner="trainer.loss")
        rows = set(self._rows)
        if self._zero is not None:
            grads = self._zero.sync_grads(grads, self._data_axes, op,
                                          "trainer.grad_sync", skip=rows)
        elif self._data_axes:
            dense = [k for k in range(len(grads)) if k not in rows]
            for k, g in zip(dense, _comms_grad_sync(
                    [grads[k] for k in dense], self.mesh, self._data_axes,
                    op)):
                grads[k] = g
        if rows and self._data_axes:
            grads = self._sync_rows(grads, op)
        if self._sp:
            red = comms.grad_sync([grads[i] for i in self._sp], self.mesh,
                                  "mp", op="sum", exact=True,
                                  owner="trainer.sequence_parallel.grad")
            for i, g in zip(self._sp, red):
                grads[i] = g
        if self._use_scaling:
            loss = loss * inv.to(loss.dtype)
        clip, clip_scale = self._grad_clip, None
        if not self._big or isinstance(clip, ClipGradByGlobalNorm):
            sums, total, synced_finite = multi_tensor_sumsq_finite(grads,
                                                                   inv)
            if not self._big:
                finite = synced_finite
        if isinstance(clip, ClipGradByGlobalNorm):
            if any(self._split_axes):
                total = split_global_sumsq(sums, self._split_axes, self.mesh)
            clip_scale = clip.scale_from_sumsq(total)
        elif isinstance(clip, ClipGradByValue):
            with torch.no_grad():
                if inv is not None:
                    grads = [g * inv.to(g.dtype) for g in grads]
                    inv = None
                grads = [torch.clamp(g, clip.min, clip.max) for g in grads]
        kw = dict(grad_scale=inv, clip_scale=clip_scale, finite=finite)
        if self._zero is not None:
            self._zero.update(self._base_opt, grads, states, lr, step, **kw)
            self._zero.release()
        else:
            self._base_opt._multi_update(params, grads, states, lr, step,
                                         **kw)
        self._update_health(finite)
        return loss

    def _sync_rows(self, grads, op: str):
        """The grads of row-sharded parameters: complete on their owner
        over their own axis (the exchange's backward summed every rank's
        there); synced over the other data axes, and divided by the axis
        size for a mean over it."""
        grads = list(grads)
        for k in self._rows:
            axis = self._params[k].row_sharded
            rest = tuple(a for a in self._data_axes if a != axis)
            g = grads[k]
            if rest:
                g = comms.grad_sync([g], self.mesh, rest, op=op)[0]
            if op == "avg" and axis in self._data_axes:
                n = torch.full((), self._big.get(axis, 1), dtype=g.dtype,
                               device=g.device)
                g = g / n
            grads[k] = g
        return grads

    def write_back(self):
        """Make every parameter whole in the model (ZeRO stage 3 keeps
        only this rank's slice between steps: ``param_value``, and so
        ``paddle_tpu_state``, gathers it on read without this); returns
        the model."""
        if self._zero is not None:
            self._zero.gather()
        return self.model

    # ---- self-healing telemetry (host reads, outside the step) ----
    @property
    def skipped_steps(self) -> int:
        """Steps whose update was skipped because a grad went nan/inf."""
        return int(self._health["skipped"])

    @property
    def loss_scale(self) -> float:
        """The current (device-side) dynamic loss scale."""
        return float(self._health["loss_scale"])

    def sync_scaler(self):
        """Copy the device-side scale into the attached GradScaler, so that
        its state_dict() sees what the step did."""
        if self._scaler is not None and self._use_scaling:
            self._scaler._scale = float(self._health["loss_scale"])
        return self._scaler

    # ---- live resharding ----
    def _full_shape(self, k) -> tuple:
        return tuple(self._zero.full_shape(k)) if self._zero is not None \
            else tuple(self._params[k].shape)

    def _param_piece(self, k):
        """(tensor, global index) of this rank's piece of parameter k: its
        ZeRO-3 slice between steps, else the whole parameter."""
        full = self._full_shape(k)
        z = self._zero
        if z is not None and z.slices[k] is not None:
            return z.slices[k], _piece_index(z, k, full)
        return self._params[k].detach(), tuple((0, d) for d in full)

    def supervised_state(self):
        """``(params, state)`` for a ``Supervisor``: name ->
        ``SupervisedParam`` (global shape, dtype, and ``spec`` naming the
        ZeRO axis on the dim it shards, else replicated) and name -> this
        rank's block as a host array read on demand. Names:
        ``params.<name>`` (the fp32 masters), ``opt.<name>.<leaf>`` (the
        optimizer's state leaves) and ``step`` (the step count); the same
        names ``reshard(new_mesh, state)`` reads."""
        from ..distributed.supervisor import SupervisedParam
        z = self._zero
        params, views = {}, {}

        def spec_of(k, full, sharded):
            if not sharded or z is None or z.dims[k] is None:
                return ()
            return tuple(z.axis if i == z.dims[k] else None
                         for i in range(len(full)))

        for k, name in enumerate(self._param_names):
            full = self._full_shape(k)
            p = self._params[k]
            params[f"params.{name}"] = SupervisedParam(
                full, _np_dtype(p.dtype),
                spec_of(k, full, z is not None and z.stage >= 3))
            views[f"params.{name}"] = _HostView(
                lambda k=k: self._param_piece(k)[0])
            for leaf, v in self._opt_state[k].items():
                if not isinstance(v, torch.Tensor):
                    continue
                key = f"opt.{name}.{leaf}"
                shape = full if v.dim() else ()
                params[key] = SupervisedParam(
                    shape, _np_dtype(v.dtype), spec_of(k, shape, v.dim() > 0))
                views[key] = _HostView(
                    lambda k=k, leaf=leaf: self._opt_state[k][leaf])
        params["step"] = SupervisedParam((), np.int64, ())
        views["step"] = _HostView(
            lambda: np.asarray(self._step_count, np.int64))
        return params, views

    def reshard(self, new_mesh, state=None) -> None:
        """Move the step onto ``new_mesh``, which changes only the dp (or
        sharding) extent: an installed ``DeviceMesh`` over the current
        world, or an ``elastic_mesh`` whose world is formed here
        (``mesh.reform_world``: the old process group destroyed, the new
        one initialised over a fresh ``PrefixStore``, rank = position in
        the new roster). The parameters and every optimizer state leaf are
        re-partitioned to the new ZeRO degree; a block this rank does not
        hold comes from ``state`` (names of ``supervised_state()``, each
        value this rank's block on the new mesh), which, where given, is
        taken as it is (after a rollback it is the committed generation,
        not the live values); ``state["step"]`` sets the step count. Values
        are moved, never recomputed: bitwise. The health scalars (loss
        scale, streaks, skipped steps) stay as they are, and the old
        mesh's ZeRO shards are dropped."""
        if new_mesh is None:
            raise ValueError("reshard needs a mesh (got None)")
        new_big = {k: v for k, v in _mesh_axes(new_mesh).items() if v > 1}
        for a in ("mp", "pp", "sep"):
            if self._big.get(a, 1) != new_big.get(a, 1):
                raise ValueError(
                    f"reshard changes only the dp/sharding extent: {a} is "
                    f"{self._big.get(a, 1)} here and {new_big.get(a, 1)} "
                    f"on the new mesh")
        state = {} if state is None else dict(state)
        dev = self._device

        def host(name, shape, dtype):
            a = np.asarray(state[name])
            if tuple(a.shape) != tuple(shape):
                raise ValueError(f"reshard: state[{name!r}] has shape "
                                 f"{a.shape}, this rank's block is {shape}")
            # a copy even on the CPU: the step trains it in place, and the
            # caller's arrays (the supervisor's state) must not move
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype, copy=True)

        # this rank's pieces as they stand, read before the old groups go
        full = [self._full_shape(k) for k in range(len(self._params))]
        old_states = [(st, _piece_index(self._zero, k, full[k]))
                      for k, st in enumerate(self._opt_state)]
        values = []
        for k, name in enumerate(self._param_names):
            key = f"params.{name}"
            whole = tuple((0, d) for d in full[k])
            if key in state:
                values.append(host(key, full[k], self._params[k].dtype))
                continue
            t, have = self._param_piece(k)
            if have == whole:
                values.append(None)          # whole here already: kept
                continue
            if _cut(t, have, whole) is None:
                raise ValueError(f"reshard: this rank holds only {have} of "
                                 f"{key} and state has no {key!r}")
        if getattr(new_mesh, "rendezvous", None) is not None:
            mesh_mod.reform_world(new_mesh)
        elif isinstance(new_mesh, mesh_mod.DeviceMesh):
            mesh_mod.set_mesh(new_mesh)
        self._bind_mesh(new_mesh)
        for m in self.model.modules():
            if "mesh" in vars(m):
                m.mesh = new_mesh
        with torch.no_grad():
            for p, v in zip(self._params, values):
                for attr in ("zero_master", "zero_ref"):
                    if hasattr(p, attr):
                        delattr(p, attr)
                if v is not None:
                    p.data = v
        del values

        def make(k, like):
            name = self._param_names[k]
            fresh = self._base_opt._init_state(like)
            old, have = old_states[k]
            want = _piece_index(self._zero, k, full[k])
            out = {}
            for leaf, v in fresh.items():
                key = f"opt.{name}.{leaf}"
                if not isinstance(v, torch.Tensor):
                    out[leaf] = old.get(leaf, v)
                elif key in state:
                    out[leaf] = host(key, tuple(v.shape), v.dtype)
                elif v.dim() == 0:
                    out[leaf] = old[leaf].detach().clone()
                else:
                    got = _cut(old[leaf].detach(), have, want)
                    if got is None:
                        raise ValueError(
                            f"reshard: this rank holds {have} of {key}, "
                            f"needs {want} and state has no {key!r}")
                    out[leaf] = got.contiguous().clone()
            return out

        self._shard_states(make)
        del old_states
        if "step" in state:
            self._step_count = int(np.asarray(state["step"]))
        self._drop_capture()

    def _drop_capture(self) -> None:
        """Forget the captured graph (the next call captures anew)."""
        if self._dispatcher is not None:
            self._dispatcher.release()
        self._dispatcher = None
        self.captured_program = None

    # ---- the captured program ----
    def lower_text(self, batch):
        """The captured program's ``describe()``: the ops the warm-up
        dispatched, the kernels and collectives of one step, the pass
        report. The program exists once a step has run (its first call is
        the capture's warm-up); before that, and after a bailout, the text
        says so and why. ``batch`` is the JAX method's argument (it builds
        there); nothing runs here."""
        del batch
        if self.captured_program is not None:
            return self.captured_program.describe()
        if self._dispatcher is None:
            return ("TrainStep: not captured yet (the first call is the "
                    "capture's warm-up)")
        return ("TrainStep: not captured, runs eagerly: "
                + (self._dispatcher.reason or "step capture is off or the "
                   "step runs on the CPU"))

    def memory_stats(self, batch) -> "StepMemoryStats":
        """This rank's bytes of the step, by XLA's ``CompiledMemoryStats``
        names where they mean something: ``argument_size_in_bytes`` the
        step's inputs (this rank's parameters, their pieces under ZeRO-3
        and row sharding; its optimizer state; the health scalars, the
        learning rate and step count; its block of ``batch``),
        ``alias_size_in_bytes`` those it updates in place (all but the
        batch), ``output_size_in_bytes`` the 0-dim loss,
        ``temp_size_in_bytes``
        the captured graph's memory pool (0 before the capture and when
        the step runs eagerly)."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))
        params = [self._param_piece(k)[0] for k in range(len(self._params))]
        states = [v for st in self._opt_state for v in st.values()]
        scalars = list(self._health.values()) + [self._lr_t, self._step_t]
        inplace = nbytes(params) + nbytes(states) + nbytes(scalars)
        leaves = []
        _array_leaves(batch, leaves)
        split = 1
        if self._sync_axis is not None:
            split *= self._big.get(self._sync_axis, 1)
        local = 0
        for t in leaves:
            b = (t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                 else t.nbytes) // split
            if self._sep and t.ndim >= 2:
                b //= self._big.get("sep", 1)
            local += b
        pool = 0 if self._dispatcher is None else \
            (self._dispatcher.pool_bytes() or 0)
        return StepMemoryStats(argument_size_in_bytes=inplace + local,
                               alias_size_in_bytes=inplace,
                               output_size_in_bytes=self._loss_bytes,
                               temp_size_in_bytes=int(pool))


def compile_train_step(model, loss_fn, optimizer, mesh=None,
                       **kw) -> TrainStep:
    """``loss_fn(model, batch) -> scalar loss tensor`` (or a ``LossSum``,
    for a mean whose rows differ in number across the dp ranks). Returns a
    TrainStep
    whose ``__call__(batch)`` runs one step and returns the loss.

    Pass ``scaler=amp.GradScaler(...)`` for dynamic loss scaling on the
    device (scale, unscale, skip on overflow, backoff and growth, no host
    read). Even without a scaler the step skips an update whose grads hold
    inf or nan (params and optimizer state bit-exact) and counts it in
    ``step.skipped_steps``."""
    return TrainStep(model, loss_fn, optimizer, mesh=mesh, **kw)
