"""The rest of ``paddle.static``: backward/gradients, program and state
serialization, EMA, name scopes, py_func/Print, places, build/execution
strategies, the IPU stubs and the metric ops.

Counterpart of ``paddle_tpu/static/compat.py``. Where the JAX module and
the port differ:

- ``save`` writes ``.pdparams`` (a pickle of name -> numpy array, the JAX
  layout) first, then tries to pickle the Program into ``.pdmodel``. A
  recorded op holds a torch function or a closure of the op library, which
  pickle cannot always carry; then ``save`` raises
  ``ProgramNotSerializable`` (a ``TypeError``) naming
  ``save_inference_model``, the format that carries a program. The JAX
  ``save`` fails there too, with pickle's ``AttributeError``.
  ``serialize_program`` does the same.
- ``py_func`` runs the host callable on numpy copies of its inputs (a
  host sync: a CUDA graph of such a program bails out to eager); ``Print``
  prints when the op runs.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import threading
from typing import Dict, List

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ..ops.dispatch import apply
from . import framework as fw
from .framework import GradientRecord, Program, Variable, default_main_program

__all__ = [
    "append_backward", "gradients", "name_scope", "py_func", "Print",
    "create_global_var", "ExponentialMovingAverage", "WeightNormParamAttr",
    "BuildStrategy", "ExecutionStrategy", "save", "load", "load_program_state",
    "serialize_program", "serialize_persistables", "save_to_file",
    "deserialize_program", "deserialize_persistables", "load_from_file",
    "cpu_places", "cuda_places", "xpu_places", "ipu_shard_guard",
    "IpuCompiledProgram", "IpuStrategy", "create_parameter", "accuracy",
    "auc", "ctr_metric_bundle", "device_guard", "set_ipu_shard",
    "ProgramNotSerializable",
]


class ProgramNotSerializable(TypeError):
    """A recorded Program holds an op that pickle cannot carry."""


# ---- backward (python/paddle/fluid/backward.py append_backward) ----

def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Record the gradients of ``loss``; returns ``[(param_name,
    grad_name)]``, each grad fetchable as ``<param>@GRAD``."""
    prog = default_main_program()
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else
                 (prog.capture(p) if isinstance(p, torch.Tensor) else str(p))
                 for p in parameter_list]
    else:
        names = list(prog.captured.keys())
    if no_grad_set:
        drop = {getattr(v, "name", v) for v in no_grad_set}
        names = [n for n in names if n not in drop]
    prog.global_block().append_op(GradientRecord(loss.name, names))
    return [(n, n + "@GRAD") for n in names]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) as fetchable ``@GRAD`` Variables."""
    prog = default_main_program()
    tgt = targets[0] if isinstance(targets, (list, tuple)) else targets
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    names = [v.name if isinstance(v, Variable) else str(v) for v in ins]
    prog.global_block().append_op(GradientRecord(tgt.name, names))
    return [Variable(getattr(v, "shape", []), getattr(v, "dtype", "float32"),
                     name=n + "@GRAD") for n, v in zip(names, ins)]


# ---- misc graph utilities ----

class _ScopeStack:
    """The name-scope stack (module state on a locked instance)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stack: List[str] = []

    def push(self, prefix: str):
        with self._lock:
            self._stack.append(prefix)

    def pop(self):
        with self._lock:
            if self._stack:
                self._stack.pop()


_name_scopes = _ScopeStack()


@contextlib.contextmanager
def name_scope(prefix=None):
    """Hierarchical op-name prefix (kept for profiler grouping)."""
    _name_scopes.push(prefix or "")
    try:
        yield
    finally:
        _name_scopes.pop()


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Run the host callable ``func`` on numpy copies of ``x`` as an op of
    the program; ``out`` gives the result's shapes and dtypes."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    specs = [(tuple(o.shape), dtypes.convert_dtype(o.dtype)) for o in outs]

    def f(*vals):
        if vals and vals[0].device.type == "meta":
            res = [torch.empty(s, dtype=d, device="meta") for s, d in specs]
        else:
            got = func(*[v.detach().cpu().numpy() for v in vals])
            got = got if isinstance(got, (list, tuple)) else [got]
            dev = vals[0].device if vals else "cpu"
            res = [torch.as_tensor(np.asarray(g)).to(device=dev, dtype=d)
                   .reshape(s) for g, (s, d) in zip(got, specs)]
        return tuple(res) if len(res) > 1 else res[0]
    return apply(f, *xs, op_name="py_func")


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Print a tensor when the op runs (a host read: a CUDA graph of such
    a program bails out to eager)."""
    msg = message or getattr(input, "name", "var")

    def f(v):
        if v.device.type != "meta":
            print(f"{msg}: {v.detach().cpu().numpy()}")
        return v.clone()
    return apply(f, input, op_name="print")


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A persistable captured tensor with a constant initial value."""
    from ..core.device import resolve_device
    prog = default_main_program()
    dev = torch.device("cpu") if force_cpu else resolve_device(None)
    t = Tensor(torch.full(tuple(int(s) for s in shape), value,
                          dtype=dtypes.convert_dtype(dtype), device=dev))
    t.persistable = persistable
    vname = prog.capture(t) if name is None else name
    if name is not None:
        prog.captured[name] = t
    return Variable(list(shape), dtype, name=vname)


# ---- EMA (python/paddle/static/ema.py ExponentialMovingAverage) ----

class ExponentialMovingAverage:
    """EMA of the trainable parameters with ``apply()`` / ``restore()``
    swap contexts."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema: Dict[int, torch.Tensor] = {}
        self._backup: Dict[int, torch.Tensor] = {}
        self._params = []
        self._step = 0

    def _tracked(self):
        if not self._params:
            self._params = [t for t in
                            default_main_program().captured.values()
                            if isinstance(t, Tensor) and not t.stop_gradient]
            if not self._params:
                raise RuntimeError("no trainable parameters to track; build "
                                   "the program (or pass params) first")
        return self._params

    def track(self, parameters):
        self._params = list(parameters)

    def update(self):
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        with torch.no_grad():
            for p in self._tracked():
                v = p.detach().as_subclass(torch.Tensor)
                prev = self._ema.get(id(p), v)
                self._ema[id(p)] = d * prev + (1 - d) * v

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            for p in self._tracked():
                self._backup[id(p)] = p.detach().clone()
                if id(p) in self._ema:
                    torch.Tensor.copy_(p, self._ema[id(p)].to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._tracked():
                if id(p) in self._backup:
                    torch.Tensor.copy_(p, self._backup.pop(id(p)))


class WeightNormParamAttr:
    """ParamAttr asking for weight normalization: ``dim`` and the usual
    ParamAttr fields."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


class BuildStrategy:
    """Graph-build knobs, accepted and recorded so reference configs
    construct unchanged (each Executor entry is one CUDA graph already)."""

    def __init__(self):
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.fuse_all_reduce_ops = True
        self.enable_addto = False
        self.build_cinn_pass = False
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.num_iteration_per_run = 1


# ---- program/persistables serialization (static/io.py) ----

def _state(program) -> Dict[str, np.ndarray]:
    from .executor import _to_numpy
    return {n: _to_numpy(t) for n, t in program.captured.items()}


def _pickle_program(program, protocol=4) -> bytes:
    try:
        return pickle.dumps(program, protocol=protocol)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise ProgramNotSerializable(
            f"this Program holds an op pickle cannot carry ({e}); save it "
            f"for deployment with static.save_inference_model, which "
            f"exports the replayed program") from e


def serialize_program(feed_vars, fetch_vars, program=None) -> bytes:
    from .io import normalize_program
    prog = program or default_main_program()
    return _pickle_program(normalize_program(prog, feed_vars, fetch_vars))


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None) -> bytes:
    return pickle.dumps(_state(program or default_main_program()))


def save_to_file(path: str, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data: bytes):
    return pickle.loads(data)


def deserialize_persistables(program, data: bytes, executor=None):
    state = pickle.loads(data)
    fw.set_program_state(program, state)
    return state


def save(program, model_prefix: str, protocol=4):
    """Write the program's parameter state (``.pdparams``), then the
    program itself (``.pdmodel``), or raise ``ProgramNotSerializable``
    (module docstring)."""
    with open(model_prefix + ".pdparams", "wb") as f:
        pickle.dump(_state(program), f, protocol=protocol)
    blob = _pickle_program(program, protocol)
    with open(model_prefix + ".pdmodel", "wb") as f:
        f.write(blob)


def load(program, model_prefix: str, executor=None, var_list=None):
    fw.set_program_state(program, load_program_state(model_prefix, var_list))


def load_program_state(model_prefix: str, var_list=None):
    path = model_prefix if model_prefix.endswith(".pdparams") \
        else model_prefix + ".pdparams"
    with open(path, "rb") as f:
        state = pickle.load(f)
    if var_list is not None:
        keep = {getattr(v, "name", v) for v in var_list}
        state = {k: v for k, v in state.items() if k in keep}
    return state


# ---- places ----

def cpu_places(device_count=None):
    from ..framework_compat import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    from ..framework_compat import CUDAPlace
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ids = device_ids if device_ids is not None else range(max(n, 1))
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


# ---- IPU (Graphcore hardware: explicit stubs) ----

@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise NotImplementedError(
        "IPU sharding targets Graphcore hardware; on the card use "
        "paddle_tpu_torch.distributed's sharding or pipeline stages")
    yield  # pragma: no cover


class IpuStrategy:
    def __init__(self):
        raise NotImplementedError(
            "IpuStrategy targets Graphcore IPUs; this port targets CUDA "
            "(use DistributedStrategy / a mesh)")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "IpuCompiledProgram targets Graphcore IPUs; programs here run "
            "through static.Executor")


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A trainable parameter registered with the current program."""
    from ..core.device import resolve_device
    from ..core.tensor import Parameter
    from ..nn.initializer import Constant, XavierNormal
    init = default_initializer
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    p = Parameter(torch.zeros(tuple(int(s) for s in shape),
                              dtype=dtypes.convert_dtype(dtype),
                              device=resolve_device(None)))
    init(p)
    if attr is not None and getattr(attr, "name", None):
        p.name = attr.name
    default_main_program().capture(p)
    return p


def accuracy(input, label, k=1, correct=None, total=None):
    """Batch top-k accuracy op."""
    def f(pred, lab):
        topk = torch.argsort(pred, dim=-1)[..., -k:]
        hit = (topk == lab.reshape(-1, 1)).any(dim=-1)
        return hit.float().mean()
    return apply(f, input, label, op_name="accuracy")


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """Batch AUC by threshold buckets; returns ``(auc, batch_auc, [])``."""
    def f(pred, lab):
        pos_score = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
            else pred.reshape(-1)
        labf = lab.reshape(-1).float()
        bucket = torch.clamp((pos_score * num_thresholds).to(torch.int32),
                             0, num_thresholds).long()
        z = torch.zeros(num_thresholds + 1, device=pred.device)
        pos = z.index_add(0, bucket, labf)
        neg = z.index_add(0, bucket, 1.0 - labf)
        tp = torch.cumsum(pos.flip(0), 0)
        fp = torch.cumsum(neg.flip(0), 0)
        tpr = tp / torch.clamp_min(tp[-1], 1.0)
        fpr = fp / torch.clamp_min(fp[-1], 1.0)
        return torch.trapezoid(tpr, fpr)
    a = apply(f, input, label, op_name="auc")
    return a, a, []


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR batch sums ``(sqrerr, abserr, prob, q, pos, total)``."""
    def f(pred, lab):
        p = pred.reshape(-1)
        l2 = lab.reshape(-1).to(p.dtype)
        total = torch.full((), p.shape[0], dtype=p.dtype, device=p.device)
        return (torch.sum(torch.square(p - l2)), torch.sum(torch.abs(p - l2)),
                torch.sum(p), torch.sum(p * p), torch.sum(l2), total)
    return apply(f, input, label, op_name="ctr_metric_bundle")


@contextlib.contextmanager
def device_guard(device=None):
    """The reference pins ops to cpu/gpu inside a program; a program here
    runs on its Executor's device, so this validates and does nothing."""
    if device is not None and device.split(":")[0] not in (
            "cpu", "gpu", "xpu", "tpu", "npu"):
        raise ValueError(f"unsupported device {device!r} in device_guard")
    yield


def set_ipu_shard(layer, index=-1, stage=-1):
    raise NotImplementedError(
        "set_ipu_shard targets Graphcore IPUs; use pipeline-parallel stage "
        "assignment (fleet hybrid_configs pp_degree)")
