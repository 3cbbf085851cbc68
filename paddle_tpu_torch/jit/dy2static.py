"""Data-dependent control flow for to_static.

Counterpart of ``paddle_tpu/jit/dy2static.py``: the same single AST pass,
which rewrites

    if <test>:  ...          (a, b) = ___pt_if(<test>, true_fn, false_fn,
    else:       ...    ->                      ('a', 'b'), locals())

    while <test>: ...  ->    (a, b) = ___pt_while(cond_fn, body_fn,
                                                  ('a', 'b'), locals())

with ``and``/``or``/``not`` inside a converted test as tensor-aware
helpers, and the same conservative skips (an ``if``/``while`` holding
``return``, ``break``, ``continue``, ``global``/``nonlocal``, attribute
or subscript stores, or assigning no names stays plain Python).

What "traced" means changes in the port. The runtime helpers dispatch on
the predicate:

- a concrete predicate (a Python value, or a tensor with values on the
  CPU or the card) runs the chosen branch as plain Python;
- under ``torch.export`` (a FakeTensor predicate) ``if`` becomes
  ``torch.cond`` and ``while`` becomes ``while_loop``, so an exported
  program (``jit.save``) keeps both branches;
- under a CUDA-graph capture (``to_static`` on the card) reading a device
  predicate is a host sync: the capture tier's warm-up refuses it and
  that call signature runs eagerly from then on, with the reason counted,
  so a graph never replays a stale branch.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import warnings
from typing import Callable

import torch

__all__ = ["convert_control_flow"]


class _Undefined:
    """Placeholder for names not yet bound when a converted branch runs."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"

    def __bool__(self):
        raise NameError(
            "variable used before assignment in converted control flow")


_UNDEF = _Undefined()


def _is_traced(x) -> bool:
    """A tensor of a ``torch.export`` trace (no values to branch on)."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def _pred(p) -> torch.Tensor:
    t = p if isinstance(p, torch.Tensor) else torch.as_tensor(p)
    return t.reshape(()).to(torch.bool)


def _fetch(names, lcls):
    return tuple(lcls.get(n, _UNDEF) for n in names)


def _check_defined(names, ops, what):
    bad = [n for n, o in zip(names, ops) if o is _UNDEF]
    if bad:
        raise ValueError(
            f"to_static control-flow conversion: variable(s) {bad} must be "
            f"defined before a tensor-dependent {what} that assigns them")


def _as_tensor(o, like=None):
    if isinstance(o, torch.Tensor):
        return o
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(o, device=dev)


def _split(ops):
    """The tensor operands' positions and a function that puts new
    tensors back among the other values."""
    pos = [i for i, o in enumerate(ops) if isinstance(o, torch.Tensor)]

    def put(tensors):
        full = list(ops)
        for i, t in zip(pos, tensors):
            full[i] = t
        return tuple(full)
    return pos, put


def ___pt_if(pred, true_fn, false_fn, names, needs_input, lcls):
    ops = _fetch(names, lcls)
    if not _is_traced(pred):
        return (true_fn if bool(pred) else false_fn)(*ops)
    # names assigned in BOTH branches need no prior binding; a name
    # assigned in one branch passes its inbound value through the other
    needed = [n for n, need in zip(names, needs_input) if need]
    needed_ops = [o for o, need in zip(ops, needs_input) if need]
    _check_defined(needed, needed_ops, "if")
    ops = tuple(torch.zeros((), device=pred.device) if o is _UNDEF else o
                for o in ops)
    pos, put = _split(ops)

    def branch(fn):
        def g(*tensors):
            out = fn(*put(tensors))
            return tuple(_as_tensor(o, pred).clone() for o in out)
        return g

    try:
        return torch.cond(_pred(pred), branch(true_fn), branch(false_fn),
                          tuple(ops[i] for i in pos))
    except Exception as e:  # noqa: BLE001 — name the converted variables
        raise TypeError(
            f"to_static: the branches of a tensor-dependent `if` must "
            f"produce matching shapes/dtypes for {names}: {e}") from None


def ___pt_while(cond_fn, body_fn, names, lcls):
    ops = _fetch(names, lcls)
    pred = cond_fn(*ops)
    if not _is_traced(pred):
        vals = ops
        while bool(pred):
            vals = body_fn(*vals)
            pred = cond_fn(*vals)
        return vals
    _check_defined(names, ops, "while")
    from torch._higher_order_ops.while_loop import while_loop
    ops = tuple(_as_tensor(o, pred) for o in ops)

    def c(*vals):
        return _pred(cond_fn(*vals))

    def b(*vals):
        out = body_fn(*vals)
        return tuple(_as_tensor(o, pred).clone() for o in out)

    return tuple(while_loop(c, b, ops))


def ___pt_and(*thunks):
    val = thunks[0]()
    for t in thunks[1:]:
        if _is_traced(val):
            val = torch.logical_and(val, _as_tensor(t(), val))
        else:
            if not val:
                return val
            val = t()
    return val


def ___pt_or(*thunks):
    val = thunks[0]()
    for t in thunks[1:]:
        if _is_traced(val):
            val = torch.logical_or(val, _as_tensor(t(), val))
        else:
            if val:
                return val
            val = t()
    return val


def ___pt_not(x):
    if _is_traced(x):
        return torch.logical_not(x)
    return not x


_HELPERS = {"___pt_if": ___pt_if, "___pt_while": ___pt_while,
            "___pt_and": ___pt_and, "___pt_or": ___pt_or,
            "___pt_not": ___pt_not}

_SKIP_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _stored_names(nodes):
    """Names assigned in a statement list; None if unconvertible stores or
    control-flow escapes are present (conservative)."""
    names, ok = set(), [True]

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            if isinstance(n.ctx, (ast.Store, ast.Del)):
                names.add(n.id)

        def visit_Attribute(self, n):
            if isinstance(n.ctx, ast.Store):
                ok[0] = False
            self.generic_visit(n)

        def visit_Subscript(self, n):
            if isinstance(n.ctx, ast.Store):
                ok[0] = False
            self.generic_visit(n)

        def visit_Return(self, n):
            ok[0] = False

        def visit_Break(self, n):
            ok[0] = False

        def visit_Continue(self, n):
            ok[0] = False

        def visit_Global(self, n):
            ok[0] = False

        def visit_Nonlocal(self, n):
            ok[0] = False

        def visit_Yield(self, n):
            ok[0] = False

        def visit_YieldFrom(self, n):
            ok[0] = False

        def generic_visit(self, n):
            if isinstance(n, _SKIP_SCOPES):
                return  # nested scopes keep their own control flow
            super().generic_visit(n)

    for nd in nodes:
        V().visit(nd)
    return sorted(names) if ok[0] else None


class _TestTransformer(ast.NodeTransformer):
    """and/or/not inside a converted test -> tensor-aware helpers with
    Python short-circuit preserved via thunks."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "___pt_and" if isinstance(node.op, ast.And) else "___pt_or"
        thunks = [ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=v) for v in node.values]
        return ast.Call(func=ast.Name(id=fn, ctx=ast.Load()),
                        args=thunks, keywords=[])

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=ast.Name(id="___pt_not", ctx=ast.Load()),
                            args=[node.operand], keywords=[])
        return node

    def generic_visit(self, node):
        if isinstance(node, _SKIP_SCOPES):
            return node
        return super().generic_visit(node)


def _fn_args(names):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names],
        kwonlyargs=[], kw_defaults=[], defaults=[])


def _names_tuple(names, ctx):
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names],
                     ctx=ctx())


def _const_names(names):
    return ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                     ctx=ast.Load())


def _locals_call():
    return ast.Call(func=ast.Name(id="locals", ctx=ast.Load()), args=[],
                    keywords=[])


class _CtrlFlow(ast.NodeTransformer):
    def __init__(self):
        self.n = 0

    def _visit_body(self, stmts):
        out = []
        for s in stmts:
            r = self.visit(s)
            out.extend(r if isinstance(r, list) else [r])
        return out

    def generic_visit(self, node):
        if isinstance(node, _SKIP_SCOPES):
            return node
        return super().generic_visit(node)

    def visit_If(self, node):
        body = self._visit_body(node.body)
        orelse = self._visit_body(node.orelse)
        names_t = _stored_names(body)
        names_e = _stored_names(orelse)
        if names_t is None or names_e is None:
            node.body, node.orelse = body, orelse
            return node
        names = sorted(set(names_t) | set(names_e))
        if not names:
            node.body, node.orelse = body, orelse
            return node
        both = set(names_t) & set(names_e)
        needs_input = ast.Tuple(
            elts=[ast.Constant(value=n not in both) for n in names],
            ctx=ast.Load())
        self.n += 1
        i = self.n
        test = _TestTransformer().visit(node.test)
        ret = ast.Return(value=_names_tuple(names, ast.Load))
        tdef = ast.FunctionDef(name=f"___pt_true_{i}", args=_fn_args(names),
                               body=body + [ret], decorator_list=[])
        fdef = ast.FunctionDef(
            name=f"___pt_false_{i}", args=_fn_args(names),
            body=(orelse or []) + [ast.Return(value=_names_tuple(
                names, ast.Load))],
            decorator_list=[])
        assign = ast.Assign(
            targets=[_names_tuple(names, ast.Store)],
            value=ast.Call(func=ast.Name(id="___pt_if", ctx=ast.Load()),
                           args=[test,
                                 ast.Name(id=tdef.name, ctx=ast.Load()),
                                 ast.Name(id=fdef.name, ctx=ast.Load()),
                                 _const_names(names), needs_input,
                                 _locals_call()],
                           keywords=[]))
        return [tdef, fdef, assign]

    def visit_While(self, node):
        body = self._visit_body(node.body)
        if node.orelse:
            node.body = body
            return node
        names = _stored_names(body)
        if not names:  # None (unconvertible) or no loop vars
            node.body = body
            return node
        self.n += 1
        i = self.n
        test = _TestTransformer().visit(node.test)
        cdef = ast.FunctionDef(name=f"___pt_cond_{i}", args=_fn_args(names),
                               body=[ast.Return(value=test)],
                               decorator_list=[])
        bdef = ast.FunctionDef(
            name=f"___pt_body_{i}", args=_fn_args(names),
            body=body + [ast.Return(value=_names_tuple(names, ast.Load))],
            decorator_list=[])
        assign = ast.Assign(
            targets=[_names_tuple(names, ast.Store)],
            value=ast.Call(func=ast.Name(id="___pt_while", ctx=ast.Load()),
                           args=[ast.Name(id=cdef.name, ctx=ast.Load()),
                                 ast.Name(id=bdef.name, ctx=ast.Load()),
                                 _const_names(names), _locals_call()],
                           keywords=[]))
        return [cdef, bdef, assign]


def _has_ctrl_flow(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While)):
            return True
    return False


@functools.lru_cache(maxsize=256)
def _convert_cached(fn):
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    if not _has_ctrl_flow(fdef):
        return fn
    fdef.decorator_list = []  # do not re-apply decorators on exec

    t = _CtrlFlow()
    fdef.body = t._visit_body(fdef.body)
    if t.n == 0:
        return fn

    freevars = fn.__code__.co_freevars
    if freevars:
        # rebuild the closure: wrap the def in a factory taking the free
        # variables as parameters, then call it with the live cell contents
        factory = ast.FunctionDef(
            name="___pt_factory", args=_fn_args(list(freevars)),
            body=[fdef, ast.Return(value=ast.Name(id=fdef.name,
                                                  ctx=ast.Load()))],
            decorator_list=[])
        mod = ast.Module(body=[factory], type_ignores=[])
    else:
        mod = ast.Module(body=[fdef], type_ignores=[])
    ast.fix_missing_locations(mod)

    glb = dict(fn.__globals__)
    glb.update(_HELPERS)
    code = compile(mod, filename=getattr(fn.__code__, "co_filename",
                                         "<dy2static>"), mode="exec")
    ns: dict = {}
    exec(code, glb, ns)  # noqa: S102 — recompiling the user's own source
    if freevars:
        cells = [c.cell_contents for c in fn.__closure__]
        new_fn = ns["___pt_factory"](*cells)
    else:
        new_fn = ns[fdef.name]
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn)
    return new_fn


def convert_control_flow(fn: Callable) -> Callable:
    """Rewrite tensor-dependent if/while in ``fn`` to the runtime helpers
    (module docstring).

    Returns `fn` unchanged when its source is unavailable or conversion is
    not applicable; never raises."""
    try:
        return _convert_cached(fn)
    except (OSError, TypeError, SyntaxError, ValueError):
        return fn
    except Exception as e:  # noqa: BLE001 — conversion must never break jit
        warnings.warn(f"to_static control-flow conversion failed for "
                      f"{getattr(fn, '__name__', fn)!r}: {e}")
        return fn
