"""Static-graph world: Program / Block / Variable / Operator.

Counterpart of ``paddle_tpu/static/framework.py``. A Program is a linear
record of op applications over symbolic Variables; the Executor
(``executor.py``) replays it with real tensors.

- A ``Variable`` is a port ``Tensor`` on the ``meta`` device: it has a
  shape and a dtype and no values. ``.shape`` reports a dynamic (None /
  -1) dim as -1; inside shape inference it has the placeholder extent 2,
  and a second inference at 3 tells which output dims are dynamic (the
  JAX module's ``_DYN_PLACEHOLDER`` pair). ``.device`` is the device the
  program runs on (the default device when the Variable was made), so a
  layer's ``torch.arange(..., device=x.device)`` makes a real constant.
- Ops enter the Program two ways, and none is dropped:

  * the op library's ``dispatch.apply`` consults the recorder first
    (``dispatch.set_static_recorder``): an op with a Variable among its
    arguments is appended as one Operator, with the amp cast it would
    have had;
  * any other torch call that touches a Variable (a port layer calling
    ``torch`` directly, a ``torch.library`` kernel operator) reaches
    ``Variable.__torch_function__`` and is appended too. A call whose
    result holds no tensor (``dtype``, ``dim()``) is answered from the
    meta tensors and not recorded; an in-place call is recorded as a
    write to the Variable (or captured tensor) it mutates.

  Outside static mode an op on a Variable raises. Shapes come from
  running the op on meta tensors (the ``jax.eval_shape`` of the JAX
  recorder); the kernel operators have fake bodies for that.
- Parameters that a layer creates under ``program_guard`` are ordinary
  tensors on the layer's device; an op that reads one captures it as a
  persistable variable of the Program (``Program.capture``).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Parameter, Tensor
from ..ops import dispatch as _dispatch

__all__ = [
    "Variable", "Operator", "Block", "Program", "program_guard",
    "default_main_program", "default_startup_program", "enable_static",
    "disable_static", "in_dynamic_mode", "in_static_mode", "data",
    "set_program_state", "CompiledProgram", "BackwardRecord",
    "GradientRecord",
]

_static_mode = False
_name_counter = itertools.count(1)
# placeholder extents for dynamic dims during shape inference; inferring
# with two distinct extents and diffing the results propagates
# dynamic-ness through ops
_DYN_PLACEHOLDER = 2
_DYN_PLACEHOLDER_B = 3
# tensor methods that would read a value: a Variable has none
_VALUE_READS = frozenset(["item", "tolist", "numpy", "__bool__", "__int__",
                          "__float__", "__index__", "cpu", "cuda"])


def _unique_name(prefix: str) -> str:
    return f"{prefix}_{next(_name_counter)}"


class Variable(Tensor):
    """Symbolic tensor of a static Program: a port ``Tensor`` on the meta
    device (module docstring)."""

    _pt_symbolic = True

    def __new__(cls, shape, dtype, name=None, block=None, is_data=False,
                stop_gradient=False, dynamic_dims=(), device=None):
        dyn = frozenset(i for i, s in enumerate(shape) if s in (None, -1)) \
            | frozenset(dynamic_dims)
        shp = tuple(_DYN_PLACEHOLDER if i in dyn else int(s)
                    for i, s in enumerate(shape))
        dt = dtypes.convert_dtype(dtype) or dtypes.get_default_dtype()
        base = torch.empty(shp, dtype=dt, device="meta")
        out = torch.Tensor._make_subclass(cls, base, False)
        out.__dict__.update(
            _pt_name=name or _unique_name("var"), block=block, op=None,
            is_data=is_data, dynamic_dims=dyn, _pt_stop=bool(stop_gradient),
            _pt_device=resolve_device(device), _pt_dims=shp, _pt_dtype=dt)
        return out

    def __init__(self, *a, **k):
        pass

    @property
    def shape(self):
        return [-1 if i in self.dynamic_dims else int(s)
                for i, s in enumerate(self._pt_dims)]

    @property
    def dtype(self):
        return self._pt_dtype

    @property
    def device(self):
        return self._pt_device

    @property
    def place(self) -> str:
        return str(self._pt_device)

    @property
    def stop_gradient(self) -> bool:
        return self._pt_stop

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.__dict__["_pt_stop"] = bool(v)

    def _meta(self, alt: bool = False) -> torch.Tensor:
        """A plain meta tensor of this Variable's shape (``alt``: its
        dynamic dims at the second placeholder extent)."""
        shp = tuple(_DYN_PLACEHOLDER_B if alt and i in self.dynamic_dims
                    else s for i, s in enumerate(self._pt_dims))
        return torch.empty(shp, dtype=self._pt_dtype, device="meta")

    def numpy(self):
        raise RuntimeError(
            f"Variable {self.name!r} has no value in static mode; run it "
            "through paddle_tpu_torch.static.Executor first")

    def backward(self, *a, **k):
        raise TypeError(
            f"backward() on Variable {self.name!r} has no static form; in "
            f"static mode record training with Optimizer.minimize or "
            f"static.append_backward")

    def __repr__(self, *, tensor_contents=None):
        return (f"Variable(name={self.name}, shape={self.shape}, dtype="
                f"{dtypes.dtype_name(self._pt_dtype)})")

    def __reduce_ex__(self, proto):
        return (_rebuild_var, (self.shape, dtypes.dtype_name(
            self._pt_dtype), self.name, self.is_data,
            self.stop_gradient, str(self._pt_device)))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _record(func, args, kwargs or {}, _func_name(func), None,
                       torch_level=True)


def _rebuild_var(shape, dtype, name, is_data, stop_gradient, device):
    return Variable(shape, dtype, name=name, is_data=is_data,
                    stop_gradient=stop_gradient, device=device)


def _func_name(func) -> str:
    name = getattr(func, "__name__", None) or str(func)
    if name == "__get__":                      # a property's getter
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    return name


class Operator:
    """One recorded op: ``fn`` over the call template. ``args`` holds the
    flat leaves of ``(args, kwargs)`` with Variables and captured tensors
    replaced by ``("var", name)`` / ``("param", name)`` markers and
    literals as ``("lit", value)``; ``spec`` rebuilds the call.
    ``out_names`` name the tensor leaves of the result (None for a
    non-tensor leaf), ``out_spec`` rebuilds it; ``amp`` is the dtype the
    dispatch cast the floating positional inputs to when it was
    recorded."""

    __slots__ = ("fn", "args", "spec", "kwargs", "out_names", "out_spec",
                 "type", "multi", "amp")

    def __init__(self, fn, args, kwargs, out_names, op_type, multi=False,
                 spec=None, out_spec=None, amp=None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.spec = spec
        self.out_names = out_names
        self.out_spec = out_spec
        self.type = op_type
        self.multi = multi
        self.amp = amp

    def __repr__(self):
        return f"<op {self.type} -> {self.out_names}>"


class BackwardRecord:
    """``minimize()``'s marker: backward and the optimizer's update over
    the forward before it (replayed by the Executor)."""
    __slots__ = ("loss_name", "optimizer", "param_names", "type")

    def __init__(self, loss_name, optimizer, param_names):
        self.loss_name = loss_name
        self.optimizer = optimizer
        self.param_names = param_names
        self.type = "backward_and_update"

    def __repr__(self):
        return (f"<backward+update loss={self.loss_name} "
                f"params={len(self.param_names)}>")


class GradientRecord:
    """``append_backward()`` / ``gradients()``'s marker: d(loss)/d(wrt),
    each published as ``<name>@GRAD`` (fetchable), with no update."""
    __slots__ = ("loss_name", "wrt_names", "type")

    def __init__(self, loss_name, wrt_names):
        self.loss_name = loss_name
        self.wrt_names = list(wrt_names)
        self.type = "gradients"

    def __repr__(self):
        return f"<gradients loss={self.loss_name} wrt={len(self.wrt_names)}>"


class Block:
    """A program's single block (control flow lives inside ops)."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.ops: List[Any] = []
        self.vars: Dict[str, Variable] = {}

    def var(self, name: str) -> Variable:
        if name not in self.vars:
            raise ValueError(f"variable {name!r} not in block")
        return self.vars[name]

    def create_var(self, shape, dtype, name=None, **kw) -> Variable:
        v = Variable(shape, dtype, name=name, block=self, **kw)
        self.vars[v.name] = v
        return v

    def append_op(self, op) -> None:
        self.ops.append(op)
        self.program._version += 1


class Program:
    """A recorded program: one block, the tensors it captured by name, a
    version that every appended op bumps (the Executor's cache key)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._version = 0
        self.captured: Dict[str, torch.Tensor] = {}
        self._capture_ids: Dict[int, str] = {}

    def global_block(self) -> Block:
        return self.blocks[0]

    @property
    def ops(self):
        return self.global_block().ops

    def capture(self, t: torch.Tensor) -> str:
        """Register a real tensor (parameter, buffer, constant) as a named
        persistable variable of this program; returns its scope name."""
        key = id(t)
        if key in self._capture_ids:
            return self._capture_ids[key]
        name = getattr(t, "name", None) if isinstance(t, Tensor) else None
        if not name or name in self.captured:
            name = _unique_name("param" if isinstance(t, Parameter)
                                else "capt")
        self._capture_ids[key] = name
        self.captured[name] = t
        return name

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        b = p.global_block()
        src = self.global_block()
        b.vars = dict(src.vars)
        b.ops = [o for o in src.ops if not isinstance(o, BackwardRecord)] \
            if for_test else list(src.ops)
        p.captured = dict(self.captured)
        p._capture_ids = dict(self._capture_ids)
        p.random_seed = self.random_seed
        p._version = self._version
        return p

    def list_vars(self):
        return list(self.global_block().vars.values())

    def __repr__(self):
        return (f"Program(ops={len(self.ops)}, vars="
                f"{len(self.global_block().vars)}, "
                f"captured={len(self.captured)})")


class CompiledProgram:
    """The reference's CompiledProgram: tags the wrapped program;
    ``Executor.run`` unwraps it (each cache entry is one CUDA graph on the
    card already)."""

    def __init__(self, program: Program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy


class _ProgramDefaults:
    """The ambient default programs, swapped by ``program_guard``."""

    __slots__ = ("_lock", "main", "startup")

    def __init__(self):
        self._lock = threading.Lock()
        self.main = Program()
        self.startup = Program()

    def push(self, main: Program, startup: Optional[Program]):
        with self._lock:
            prev = (self.main, self.startup)
            self.main = main
            if startup is not None:
                self.startup = startup
            return prev

    def pop(self, prev):
        with self._lock:
            self.main, self.startup = prev


_defaults = _ProgramDefaults()


def default_main_program() -> Program:
    return _defaults.main


def default_startup_program() -> Program:
    return _defaults.startup


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    prev = _defaults.push(main_program, startup_program)
    try:
        yield
    finally:
        _defaults.pop(prev)


def in_static_mode() -> bool:
    return _static_mode


def in_dynamic_mode() -> bool:
    return not _static_mode


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _is_var(a) -> bool:
    return isinstance(a, Variable)


def _meta_of(x, alt: bool):
    if isinstance(x, Variable):
        return x._meta(alt)
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(tuple(x.shape), x.stride(),
                                   dtype=x.dtype, device="meta")
    return x


def _cast(args, dt):
    return [a.to(dt) if isinstance(a, torch.Tensor) and a.is_floating_point()
            and a.dtype != dt else a for a in args]


def _infer(fn, leaves, spec, amp, alt: bool, torch_level: bool):
    """``fn`` on meta stand-ins of the call's leaves; returns (result,
    stand-ins)."""
    metas = [_meta_of(x, alt) for x in leaves]
    args, kwargs = pytree.tree_unflatten(metas, spec)
    if amp is not None:
        args = _cast(args, amp)
    if torch_level:
        with torch._C.DisableTorchFunctionSubclass():
            return fn(*args, **kwargs), metas
    return fn(*args, **kwargs), metas


def _has_tensor(tree) -> bool:
    return any(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(tree))


def _record(fn, args, kwargs, name: str, amp, torch_level: bool):
    """Append ``fn(*args, **kwargs)`` to the current Program as one
    Operator and return its symbolic result (module docstring)."""
    leaves, spec = pytree.tree_flatten((tuple(args), dict(kwargs)))
    var = next((x for x in leaves if _is_var(x)), None)
    if torch_level and name in _VALUE_READS:
        raise TypeError(
            f"{name}() of Variable {var.name!r}: a Variable has no value "
            f"in static mode; fetch it through static.Executor.run")
    try:
        meta_out, metas = _infer(fn, leaves, spec, amp, False, torch_level)
    except Exception as e:  # noqa: BLE001 — name the op and the Variable
        raise type(e)(f"static recorder: op {name!r} on Variable "
                      f"{var.name!r} failed shape inference: {e}") from e
    mutates = name == "__setitem__" or (name.endswith("_") and
                                        not name.startswith("__"))
    if torch_level and not _has_tensor(meta_out) and not mutates:
        if meta_out is None:        # a side effect (backward, ...): refuse
            raise TypeError(
                f"{name}() on Variable {var.name!r} has no static form; "
                f"in static mode record training with Optimizer.minimize "
                f"or static.append_backward")
        return meta_out                         # metadata: dtype, dim(), ...
    if not _static_mode:
        raise RuntimeError(
            f"op {name!r} on Variable {var.name!r} outside static mode: a "
            f"Variable has no value; run the Program through "
            f"static.Executor")
    prog = _defaults.main
    block = prog.global_block()
    tmpl, by_meta = [], {}
    any_dynamic = False
    for x, m in zip(leaves, metas):
        if _is_var(x):
            tmpl.append(("var", x.name))
            block.vars.setdefault(x.name, x)
            any_dynamic |= bool(x.dynamic_dims)
            by_meta[id(m)] = (("var", x.name), x)
        elif isinstance(x, torch.Tensor):
            nm = prog.capture(x)
            tmpl.append(("param", nm))
            by_meta[id(m)] = (("param", nm), x)
        else:
            tmpl.append(("lit", x))
    out_leaves, out_spec = pytree.tree_flatten(meta_out)
    if any_dynamic:
        meta_b, _ = _infer(fn, leaves, spec, amp, True, torch_level)
        out_b = pytree.tree_leaves(meta_b)
    else:
        out_b = out_leaves
    dev = var.device
    names, results = [], []
    for o, ob in zip(out_leaves, out_b):
        if not isinstance(o, torch.Tensor):
            names.append(None)
            results.append(o)
        elif id(o) in by_meta:                  # in place: the input itself
            (kind, nm), orig = by_meta[id(o)]
            names.append(nm)
            results.append(orig)
        else:
            dyn = tuple(i for i, (a, b) in enumerate(zip(o.shape, ob.shape))
                        if a != b)
            v = block.create_var(tuple(o.shape), o.dtype,
                                 name=_unique_name(name), dynamic_dims=dyn,
                                 device=dev)
            names.append(v.name)
            results.append(v)
    op = Operator(fn, tmpl, {}, names, name, multi=len(out_leaves) != 1
                  or out_spec.type is not None, spec=spec, out_spec=out_spec,
                  amp=amp)
    block.append_op(op)
    for r in results:
        if _is_var(r) and r.op is None:
            r.__dict__["op"] = op
    return pytree.tree_unflatten(results, out_spec)


def _recorder(fn, args, static_kwargs, name, amp):
    """Installed on ``ops.dispatch``: record the op when any argument is a
    Variable; otherwise fall through to eager."""
    if not _static_mode or not any(
            _is_var(x) for x in pytree.tree_leaves((args, static_kwargs))):
        return NotImplemented
    return _record(fn, args, static_kwargs, name, amp, torch_level=False)


def enable_static():
    """Switch to static-graph mode (``paddle.enable_static``): the
    recorder goes onto the op dispatch, ahead of its fast path."""
    global _static_mode
    _static_mode = True
    _dispatch.set_static_recorder(_recorder)


def disable_static():
    global _static_mode
    _static_mode = False
    _dispatch.set_static_recorder(None)


# ---------------------------------------------------------------------------
# feed placeholders & minimize hook
# ---------------------------------------------------------------------------

def data(name: str, shape, dtype="float32", lod_level=0) -> Variable:
    """``paddle.static.data``: declare a feed Variable. Dynamic (None /
    -1) dims take their extent from the fed array at ``Executor.run``
    (each feed shape is its own cache entry); ``.shape`` reports them as
    -1."""
    v = Variable(shape, dtype, name=name,
                 block=_defaults.main.global_block(), is_data=True,
                 stop_gradient=True)
    v.block.vars[v.name] = v
    return v


def append_backward_and_update(loss: Variable, optimizer) -> None:
    """Record ``minimize()`` (``Optimizer.minimize`` under static mode)."""
    prog = _defaults.main
    names = [prog.capture(p) for p in optimizer._params if p.requires_grad]
    prog.global_block().append_op(BackwardRecord(loss.name, optimizer, names))


def set_program_state(program: Program, state: Dict[str, np.ndarray]) -> None:
    """Load numpy state into the captured tensors of a program, in place."""
    for name, arr in state.items():
        t = program.captured.get(name)
        if t is None:
            continue
        src = torch.as_tensor(np.asarray(arr)).to(device=t.device,
                                                   dtype=t.dtype)
        with torch.no_grad():
            torch.Tensor.copy_(t, src.reshape(t.shape))
