"""The op library against the JAX package's, name by name.

Every public name of
``paddle_tpu.ops.{creation,math,manip,linalg,random,breadth}``
has a case here (``test_every_public_name_has_a_case`` fails on one
without). A case feeds the same numpy inputs, made from a seed, to the JAX
function and to the port's and compares:

- values: ``rtol=1e-5, atol=1e-6`` (float32; float64 at 1e-10), exact for
  integers and bools;
- dtype names (``float32``, ``int64``, ...): the port follows the JAX
  package's promotion rules (x64 on), not torch's defaults;
- grads, where the op is differentiable: ``sum(out * w)`` for a fixed
  random ``w``, through ``Tensor.backward()`` in the port and the JAX tape,
  at the same tolerance.

Factors defined up to sign or phase (QR, SVD, eigenvectors, PCA) are held
by their reconstructions and invariants; random ops by shape, dtype and,
in ``test_random_*``, by moments and reproducibility under ``seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
import paddle_tpu_torch.ops as pops
from paddle_tpu_torch.core import device as pdev
from torch_op_cases import A, C, CASES, MODULES, _rng, module_of


@pytest.fixture(scope="module", autouse=True)
def _jax_uncached():
    """The JAX side op by op: its per-op compiled cache would compile a
    forward and a vjp executable for every case, most of this file's
    time otherwise."""
    jops.dispatch.set_op_cache_enabled(False)
    yield
    jops.dispatch.set_op_cache_enabled(True)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _public():
    names = []
    for m in MODULES:
        names += [(m, n) for n in getattr(jops, m).__all__]
    return names


def test_every_public_name_has_a_case():
    missing = [f"{m}.{n}" for m, n in _public() if n not in CASES]
    assert not missing, missing
    assert len(_public()) == 424


def _args(case, pkg, grads):
    def conv(a):
        if isinstance(a, A):
            diff = case.grad and a.grad and a.arr.dtype.kind == "f"
            if pkg is J:
                t = J.to_tensor(a.arr.copy(), stop_gradient=not diff)
            else:
                t = P.to_tensor(a.arr.copy(), stop_gradient=not diff)
            if diff:
                grads.append(t)
            return t
        if isinstance(a, list):
            return [conv(x) for x in a]
        if isinstance(a, tuple):
            return tuple(conv(x) for x in a)
        return a
    return [conv(a) for a in case.args]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy(), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return a, a.dtype.name


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


def _close(got, want, case, label):
    g, gd = _np(got)
    w, wd = _np(want)
    assert gd == wd, f"{label}: dtype {gd} != {wd}"
    assert g.shape == w.shape, f"{label}: shape {g.shape} != {w.shape}"
    if case.shape_only:
        return
    if g.dtype.kind in "fc":
        rtol = 1e-10 if gd in ("float64", "complex128") else case.rtol
        atol = 1e-12 if gd in ("float64", "complex128") else case.atol
        np.testing.assert_allclose(g, w, rtol=max(rtol, case.rtol),
                                   atol=max(atol, case.atol),
                                   err_msg=label)
    else:
        np.testing.assert_array_equal(g, w, err_msg=label)


def _check_factors(kind, pin, pout, jout, case):
    a = pin[0].detach().numpy().astype(np.float64)
    po = [o.detach().numpy() for o in _flat(pout)]
    jo = [np.asarray(o.numpy()) for o in jout]
    assert [o.dtype.name for o in po] == [o.dtype.name for o in jo]
    assert [o.shape for o in po] == [o.shape for o in jo]
    tol = dict(rtol=1e-4, atol=1e-5)
    if kind == "qr":
        q, r = po
        np.testing.assert_allclose(q @ r, a, **tol)
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), **tol)
        np.testing.assert_allclose(np.abs(r), np.abs(jo[1]), **tol)
    elif kind == "svd":
        u, s, vh = po
        np.testing.assert_allclose(u * s @ vh, a, **tol)
        np.testing.assert_allclose(s, jo[1], **tol)
    elif kind == "eig":
        w, v = po
        np.testing.assert_allclose(a @ v, v * w, **tol)
        np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(jo[0]),
                                   **tol)
    elif kind == "eigh":
        w, v = po
        np.testing.assert_allclose(v * w @ v.T, a, **tol)
        np.testing.assert_allclose(w, jo[0], **tol)
    elif kind == "eigvals":
        np.testing.assert_allclose(np.sort_complex(po[0]),
                                   np.sort_complex(jo[0]), **tol)
    elif kind == "pca":
        u, s, v = po
        np.testing.assert_allclose(s, jo[1], **tol)
        np.testing.assert_allclose(np.abs(u.T @ jo[0]), np.eye(2), **tol)
    elif kind == "lu_unpack":
        pass


# The JAX side of most cases runs inside one ``jax.jit`` per op module
# (the JAX package's ops and tape trace, as under ``to_static``): one XLA
# compile a module instead of a few a case, most of this file's time
# otherwise. Ops the JAX package computes on the host (and the random,
# raising and ``lu_unpack`` cases) run eagerly; a module whose trace
# fails falls back to eager case by case.
_HOST = {"eig", "eigvals", "masked_select", "nonzero", "unique",
         "unique_consecutive", "bincount", "histogram", "tolist"}


def _traceable(name):
    c = CASES[name]
    return not (name in _HOST or c.raises or c.shape_only
                or c.check == "lu_unpack")


def _jax_case(name, arrays=None):
    """(flat outputs, grad per differentiable input, index of the output
    the grads were taken of) of the JAX function; ``arrays`` (traced)
    replace the case's arrays in order."""
    import jax.numpy as jnp
    mod, base = module_of(name, jops)
    case = CASES[name]
    it = iter(arrays) if arrays is not None else None
    grads = []

    def conv(a):
        if isinstance(a, A):
            diff = case.grad and a.grad and a.arr.dtype.kind == "f"
            v = next(it) if it is not None else a.arr.copy()
            t = J.to_tensor(v, stop_gradient=not diff)
            if diff:
                grads.append(t)
            return t
        if isinstance(a, list):
            return [conv(x) for x in a]
        if isinstance(a, tuple):
            return tuple(conv(x) for x in a)
        return a
    args = [conv(a) for a in case.args]
    out = getattr(getattr(jops, mod), base)(*args, **case.kw)
    flat = _flat(out)
    head = None
    if case.grad and grads:
        for k, o in enumerate(flat):
            if isinstance(o, J.Tensor) and not o.stop_gradient and \
                    jnp.issubdtype(o._value.dtype, jnp.floating):
                head = k
                wt = _rng(name + "w").uniform(-1, 1, tuple(o.shape)).astype(
                    np.dtype(o._value.dtype))
                J.sum(J.multiply(o, J.to_tensor(wt))).backward()
                break
    vals = [o._value if isinstance(o, J.Tensor) else o for o in flat]
    gvals = [None if t.grad is None else t.grad._value for t in grads]
    return vals, gvals, head


def _case_arrays(name):
    out = []

    def walk(a):
        if isinstance(a, A):
            out.append(a.arr.copy())
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
    for a in CASES[name].args:
        walk(a)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    import jax
    refs = {}
    for mod in MODULES:
        names = [n for n in sorted(CASES) if _traceable(n)
                 and module_of(n, jops)[0] == mod]
        statics = {}

        def group(arrays, names=names, statics=statics):
            res = {}
            for n in names:
                vals, gvals, head = _jax_case(n, arrays[n])
                statics[n] = ([v if not isinstance(v, jax.Array) else None
                               for v in vals], head)
                res[n] = ([v if isinstance(v, jax.Array) else None
                           for v in vals], gvals)
            return res
        try:
            got = jax.jit(group)({n: _case_arrays(n) for n in names})
        except Exception:  # noqa: BLE001 — this module's cases run eagerly
            continue
        for n in names:
            (vals, gvals), (st, head) = got[n], statics[n]
            refs[n] = ([np.asarray(v) if v is not None else s
                        for v, s in zip(vals, st)],
                       [None if g is None else np.asarray(g)
                        for g in gvals], head)
    return refs


def _jax_eager(name):
    vals, gvals, head = _jax_case(name)
    return ([np.asarray(v) if hasattr(v, "shape") and not isinstance(
        v, (list, tuple)) else v for v in vals],
        [None if g is None else np.asarray(g) for g in gvals], head)


class _Out:
    """A JAX output as ``_check_factors`` reads it."""

    def __init__(self, a):
        self.a = a

    def numpy(self):
        return self.a


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_against_jax(name, jax_refs):
    mod, base = module_of(name, jops)
    case = CASES[name]
    jfn = getattr(getattr(jops, mod), base)
    pmod, _ = module_of(name, pops)
    pfn = getattr(getattr(pops, pmod), base)
    jg, pg = [], []
    if case.raises:
        with pytest.raises(NotImplementedError):
            jfn(*_args(case, J, jg), **case.kw)
        with pytest.raises(NotImplementedError):
            pfn(*_args(case, P, pg), **case.kw)
        return
    if case.check == "lu_unpack":
        jargs, pargs = _args(case, J, jg), _args(case, P, pg)
        jlu, jpiv = J.linalg.lu(jargs[0])
        plu, ppiv = P.linalg.lu(pargs[0])
        jout, pout = jfn(jlu, jpiv), pfn(plu, ppiv)
        a = case.args[0].arr.astype(np.float64)
        pp, ll, uu = [o.numpy() for o in pout]
        np.testing.assert_allclose(pp @ ll @ uu, a, rtol=1e-4, atol=1e-5)
        for g, w in zip(pout, jout):
            _close(g, w.numpy(), C(rtol=1e-4, atol=1e-5), name)
        return
    jf, jgrads, jhead = jax_refs[name] if name in jax_refs \
        else _jax_eager(name)
    pargs = _args(case, P, pg)
    pout = pfn(*pargs, **case.kw)
    if case.check:
        _check_factors(case.check, pargs, pout, [_Out(v) for v in jf], case)
        return
    pf = _flat(pout)
    assert len(jf) == len(pf), f"{name}: {len(pf)} outputs, JAX {len(jf)}"
    for k, (g, w) in enumerate(zip(pf, jf)):
        if isinstance(w, (bool, int, float)) and not isinstance(
                g, torch.Tensor):
            assert g == w, name
            continue
        _close(g, w, case, f"{name}[{k}]")
    if case.grad and pg:
        heads = [k for k, g in enumerate(pf)
                 if isinstance(g, torch.Tensor) and g.is_floating_point()
                 and g.requires_grad]
        assert (heads[0] if heads else None) == jhead, name
        if not heads:
            return
        g0 = pf[heads[0]]
        wt = _rng(name + "w").uniform(-1, 1, tuple(g0.shape)).astype(
            _np(g0)[0].dtype)
        P.sum(P.multiply(g0, P.to_tensor(wt))).backward()
        for k, (pt, jt) in enumerate(zip(pg, jgrads)):
            if jt is None:
                assert pt.grad is None or not np.any(pt.grad.numpy()), name
                continue
            _close(pt.grad, jt, case, f"{name} grad[{k}]")


# ---- dtype rules with Python scalars and mixed tensors ----

def _dtype_cases():
    i64 = np.array([3, -7, 5])
    i32 = np.array([3, -7, 5], np.int32)
    f32 = np.array([1.5, -2.5, 0.5], np.float32)
    b = np.array([True, False, True])
    return {
        "int+float": ("add", i64, 2.5), "int+int": ("add", i64, 2),
        "int/int": ("divide", i64, 2), "int32/int": ("divide", i32, 2),
        "int//neg": ("floor_divide", i64, -2), "int%neg": ("mod", i64, -2),
        "neg%int": ("mod", i64, 3), "float%int": ("mod", f32, 2),
        "int32*float": ("multiply", i32, 1.5), "bool+int": ("add", b, 1),
        "float32+int": ("add", f32, 2), "int**float": ("pow", i64, 0.5),
        "sum int32": ("sum", i32), "sum bool": ("sum", b),
        "prod int32": ("prod", i32), "cumsum int32": ("cumsum", i32),
        "cumsum bool": ("cumsum", b), "mean int64": ("mean", i64),
        "mean int32": ("mean", i32), "exp int32": ("exp", i32),
        "sqrt int64": ("sqrt", np.abs(i64)), "sin bool": ("sin", b),
        "f32+f64 0-d": ("add", f32, np.array(2.0)),
        "maximum int32 int64": ("maximum", i32, i64),
        "argmax": ("argmax", f32), "abs int32": ("abs", i32),
        "floor int": ("floor", i64), "std": ("std", f32),
        "float//0.0": ("floor_divide", f32, 0.0),
        "heaviside int": ("heaviside", i64, np.array([1, 0, 1])),
    }


@pytest.mark.parametrize("label", sorted(_dtype_cases()))
def test_dtype_rules_follow_jax(label):
    op, *args = _dtype_cases()[label]

    def conv(pkg, a):
        if isinstance(a, np.ndarray) and a.ndim:
            return pkg.to_tensor(a)
        if isinstance(a, np.ndarray):
            return pkg.to_tensor(a)
        return a
    got = getattr(P, op)(*[conv(P, a) for a in args])
    want = getattr(J, op)(*[conv(J, a) for a in args])
    assert str(got.dtype).replace("torch.", "") == np.dtype(want.dtype).name
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


# ---- random ops: moments and reproducibility ----

@pytest.mark.parametrize("name", ["rand", "randn", "uniform", "normal",
                                  "randint", "bernoulli", "randperm"])
def test_random_moments_and_seed(name):
    n = 20000
    draw = {
        "rand": lambda: P.rand([n]),
        "randn": lambda: P.randn([n]),
        "uniform": lambda: P.uniform([n], min=-2.0, max=2.0),
        "normal": lambda: P.normal(1.0, 2.0, [n]),
        "randint": lambda: P.randint(0, 10, [n]),
        "bernoulli": lambda: P.bernoulli(P.full([n], 0.3)),
        "randperm": lambda: P.randperm(n),
    }[name]
    P.seed(7, "cpu")
    a = draw().numpy()
    P.seed(7, "cpu")
    b = draw().numpy()
    np.testing.assert_array_equal(a, b)
    mean, std = {"rand": (.5, 12 ** -.5), "randn": (0, 1),
                 "uniform": (0, 4 * 12 ** -.5), "normal": (1, 2),
                 "randint": (4.5, (99 / 12) ** .5),
                 "bernoulli": (.3, (.21) ** .5),
                 "randperm": ((n - 1) / 2, n / 12 ** .5)}[name]
    assert abs(a.mean() - mean) < 5 * std / n ** .5
    assert abs(a.std() - std) < 0.05 * std
    if name == "randperm":
        assert sorted(a.tolist()) == list(range(n))
