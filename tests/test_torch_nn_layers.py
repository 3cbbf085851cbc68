"""The port's ``nn`` functionals, layers and initializers against the JAX
package's, on the CPU.

The same numpy inputs (a seed per case) go through both packages; float
inputs are differentiated, ``sum(out * w)`` for a fixed random ``w``
through ``Tensor.backward()`` in the port and the JAX tape. Values and
grads: ``rtol=1e-5, atol=1e-6`` (float32) unless a case states its own.
A layer is built in both packages and the port's takes the JAX layer's
``state_dict`` (the keys are the same), then forward and every
parameter's grad are compared. Random functionals (dropout in training,
``rrelu``) and the initializers cannot equal the JAX key streams: their
keep rates, scaling, moments and bounds are held instead, and their
reproducibility under ``seed``. The in-place family's gradients through
a non-leaf are held against the JAX tape.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev

import torch_op_cases as oc
from torch_nn_cases import (ATOL, FCASES, LAYER_TOL, LCASES, RTOL, _f32,
                            _flat, _rng)


@pytest.fixture(scope="module", autouse=True)
def _jax_uncached():
    jops.dispatch.set_op_cache_enabled(False)
    yield
    jops.dispatch.set_op_cache_enabled(True)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _run(pkg, fn, arrays, name):
    """(outputs, input grads) of ``fn(pkg, F, *tensors)``."""
    ts = [pkg.to_tensor(a.copy(), stop_gradient=a.dtype.kind != "f")
          for a in arrays]
    out = fn(pkg, pkg.nn.functional, *ts)
    flat = _flat(out)
    head = next((o for o in flat if o is not None and not o.stop_gradient),
                None)
    if head is not None:
        w = _rng(name + "w").uniform(-1, 1, tuple(head.shape)).astype(
            np.float32)
        pkg.sum(pkg.multiply(head, pkg.to_tensor(w))).backward()
    grads = [None if t.stop_gradient or t.grad is None else _np(t.grad)
             for t in ts]
    return [_np(o) for o in flat], grads


def _close(got, want, label, rtol=RTOL, atol=ATOL):
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{label}: {got.dtype} != {want.dtype}"
    if got.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=label)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)




def _jax_fn(fn, arrays, name, values):
    """(outputs, input grads) of the JAX side as jax arrays; ``values``
    (traced, under ``jax.jit``) stand for ``arrays``."""
    ts = [J.to_tensor(v, stop_gradient=a.dtype.kind != "f")
          for a, v in zip(arrays, values)]
    flat = _flat(fn(J, J.nn.functional, *ts))
    head = next((o for o in flat if o is not None and not o.stop_gradient),
                None)
    if head is not None:
        w = _rng(name + "w").uniform(-1, 1, tuple(head.shape)).astype(
            np.float32)
        J.sum(J.multiply(head, J.to_tensor(w))).backward()
    return ([o._value for o in flat],
            [None if t.stop_gradient or t.grad is None else t.grad._value
             for t in ts])


def _traced_refs(names, run):
    """The JAX side of ``names`` traced under one ``jax.jit`` a chunk of
    16 (one XLA compile a chunk instead of a few a case); a chunk that
    fails is split in halves that are traced again, down to the cases
    that cannot be traced, which the tests run eagerly. A traced chunk
    compiles and runs on a worker thread while the next one is traced
    (XLA compiles without holding the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    def trace(chunk):
        arrs = {n: run.arrays(n) for n in chunk}
        try:
            lowered = jax.jit(lambda a: {n: run(n, a[n])
                                         for n in chunk}).lower(arrs)
        except Exception:  # noqa: BLE001 — split, or run eagerly
            return split(chunk)
        return [(chunk, pool.submit(lambda: lowered.compile()(arrs)))]

    def split(chunk):
        half = len(chunk) // 2
        return trace(chunk[:half]) + trace(chunk[half:]) if half else []

    refs = {}
    with ThreadPoolExecutor(4) as pool:
        jobs = [job for i in range(0, len(names), 16)
                for job in trace(names[i:i + 16])]
        while jobs:
            chunk, fut = jobs.pop(0)
            try:
                got = fut.result()
            except Exception:  # noqa: BLE001 — split, or run eagerly
                jobs += split(chunk)
                continue
            refs.update({n: jax.tree_util.tree_map(np.asarray, got[n])
                         for n in chunk})
    return refs


class _FRun:
    def __init__(self, table=FCASES):
        self.table = table

    def arrays(self, name):
        return self.table[name][1](_rng(name))

    def __call__(self, name, values):
        return _jax_fn(self.table[name][0], self.arrays(name), name, values)


def functional_refs(table):
    """The JAX side of every case of ``table``, traced a chunk at a time
    (in halves where a chunk fails to trace)."""
    return _traced_refs(sorted(table), _FRun(table))


@pytest.fixture(scope="module")
def jax_frefs():
    return functional_refs(FCASES)


@pytest.mark.parametrize("name", sorted(FCASES))
def test_functional_against_jax(name, jax_frefs):
    check_functional(name, FCASES, jax_frefs)


def check_functional(name, table, jax_frefs):
    """One case of ``table``: the port's outputs and input grads against
    the JAX side's (``jax_frefs``, else run eagerly here)."""
    fn, build, (rtol, atol) = table[name]
    arrays = build(_rng(name))
    if name in jax_frefs:
        jo, jg = jax_frefs[name]
    else:
        jo, jg = jax.tree_util.tree_map(np.asarray, _jax_fn(
            fn, arrays, name, [a.copy() for a in arrays]))
    po, pg = _run(P, fn, arrays, name)
    assert len(po) == len(jo), name
    for k, (g, w) in enumerate(zip(po, jo)):
        _close(g, w, f"{name}[{k}]", rtol, atol)
    for k, (g, w) in enumerate(zip(pg, jg)):
        if w is None or g is None:     # no grad on one side: none at all
            assert not np.any(g if w is None else w), f"{name} grad[{k}]"
            continue
        _close(g, w, f"{name} grad[{k}]", rtol, atol)




def _layer_run(pkg, layer, arrays, call, name, values=None):
    """(output, parameter grads, input grads); ``values`` (traced) stand
    for ``arrays`` on the JAX side, which then returns jax arrays."""
    vals = values if values is not None else [a.copy() for a in arrays]
    ts = [pkg.to_tensor(v, stop_gradient=a.dtype.kind != "f")
          for a, v in zip(arrays, vals)]
    out = call(layer, *ts)
    w = _rng(name + "w").uniform(-1, 1, tuple(out.shape)).astype(np.float32)
    pkg.sum(pkg.multiply(out, pkg.to_tensor(w))).backward()
    raw = (lambda t: t._value) if pkg is J else _np
    grads = {n: raw(p.grad) for n, p in layer.named_parameters()
             if p.grad is not None}
    xg = [None if t.grad is None else raw(t.grad) for t in ts]
    return raw(out), grads, xg


class _LRun:
    """The JAX layers of every case (built once, here, so the state the
    port takes is the one the refs were computed with)."""

    def __init__(self, table=LCASES):
        self.table = table
        self.layers = {n: table[n][0](J) for n in sorted(table)}

    def arrays(self, name):
        return self.table[name][1](_rng(name))

    def __call__(self, name, values):
        return _layer_run(J, self.layers[name], self.arrays(name),
                          self.table[name][2], name, values)


def layer_refs(table):
    """(JAX states, traced refs, runner) of every layer case of
    ``table``."""
    run = _LRun(table)
    states = {n: {k: np.asarray(v.numpy()).copy() for k, v in
                  layer.state_dict().items()}
              for n, layer in run.layers.items()}
    return states, _traced_refs(sorted(table), run), run


@pytest.fixture(scope="module")
def jax_lrefs():
    return layer_refs(LCASES)


@pytest.mark.parametrize("name", sorted(LCASES))
def test_layer_against_jax(name, jax_lrefs):
    check_layer(name, LCASES, jax_lrefs)


def check_layer(name, table, jax_lrefs, tol=None):
    """One layer case of ``table``: built in the port from the JAX
    layer's state, its output, parameter grads and input grads against
    the JAX side's."""
    states, refs, run = jax_lrefs
    build, inputs, call = table[name]
    pl = build(P)
    state = states[name]
    assert sorted(state) == sorted(pl.state_dict()), name
    pl.set_state_dict(state)
    arrays = inputs(_rng(name))
    if name in refs:
        jo, jg, jx = refs[name]
    else:
        jo, jg, jx = jax.tree_util.tree_map(np.asarray, run(
            name, [a.copy() for a in arrays]))
    po, pg, px = _layer_run(P, pl, arrays, call, name)
    tol = tol or LAYER_TOL.get(name, (RTOL, ATOL))
    _close(po, jo, name, *tol)
    assert sorted(pg) == sorted(jg), name
    for k in jg:
        _close(pg[k], jg[k], f"{name} grad {k}", *tol)
    for k, (g, w) in enumerate(zip(px, jx)):
        if w is not None:
            _close(g, w, f"{name} input grad[{k}]", *tol)


def test_batch_norm_running_stats_after_three_steps():
    """Paddle's momentum (0.9 keeps 0.9 of the old value) and the biased
    batch variance, against the JAX layer over three training steps."""
    r = _rng("bn")
    jl, pl = J.nn.BatchNorm2D(3, momentum=0.8), P.nn.BatchNorm2D(
        3, momentum=0.8)
    for _ in range(3):
        x = _f32(r, 4, 3, 2, 2, lo=-2, hi=3)
        jo = jl(J.to_tensor(x))
        po = pl(P.to_tensor(x))
        _close(_np(po), _np(jo), "batch_norm train out")
    _close(_np(pl._mean), np.asarray(jl._mean.numpy()), "running mean")
    _close(_np(pl._variance), np.asarray(jl._variance.numpy()),
           "running var")
    pl.eval()
    jl.eval()
    x = _f32(r, 2, 3, 2, 2)
    _close(_np(pl(P.to_tensor(x))), _np(jl(J.to_tensor(x))), "eval")


# ---- random functionals: rates, scaling, reproducibility ----

@pytest.mark.parametrize("mode,axis", [("upscale_in_train", None),
                                       ("downscale_in_infer", None),
                                       ("upscale_in_train", [0])])
def test_dropout_keep_rate_and_scaling(mode, axis):
    F = P.nn.functional
    x = P.ones([400, 50])
    P.seed(3, "cpu")
    a = F.dropout(x, 0.3, axis=axis, mode=mode).numpy()
    P.seed(3, "cpu")
    b = F.dropout(x, 0.3, axis=axis, mode=mode).numpy()
    np.testing.assert_array_equal(a, b)
    kept = a != 0
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(a[kept], scale, rtol=1e-6)
    if axis == [0]:
        assert (kept == kept[:, :1]).all()       # one draw per row
        assert abs(kept[:, 0].mean() - 0.7) < 0.1
    else:
        assert abs(kept.mean() - 0.7) < 0.02
    infer = F.dropout(x, 0.3, training=False, mode=mode).numpy()
    np.testing.assert_allclose(infer, 1.0 if mode == "upscale_in_train"
                               else 0.7)


def test_dropout2d_rrelu_alpha_dropout_draws():
    F = P.nn.functional
    x = P.ones([64, 8, 3, 3])
    d = F.dropout2d(x, 0.5).numpy()
    assert (d == d[:, :, :1, :1]).all()          # whole channels
    assert 0.3 < (d != 0).mean() < 0.7
    v = -P.ones([5000])
    rr = F.rrelu(v, 0.1, 0.3, training=True).numpy()
    assert (rr <= -0.1).all() and (rr >= -0.3).all()
    assert abs(rr.mean() + 0.2) < 0.01
    ad = F.alpha_dropout(P.randn([20000]), 0.2).numpy()
    assert abs(ad.mean()) < 0.05 and abs(ad.std() - 1) < 0.05


# ---- initializers: moments, bounds, structure, seed ----

def _draw(init, shape):
    p = P.create_parameter(shape, "float32")
    init(p)
    return p.numpy()


def test_initializers_moments_bounds_and_seed():
    I = P.nn.initializer
    n = (200, 300)
    fi, fo = n
    P.seed(11, "cpu")
    a = _draw(I.XavierNormal(), n)
    P.seed(11, "cpu")
    np.testing.assert_array_equal(a, _draw(I.XavierNormal(), n))
    assert abs(a.std() - np.sqrt(2 / (fi + fo))) < 0.02 * a.std()
    u = _draw(I.XavierUniform(), n)
    lim = np.sqrt(6 / (fi + fo))
    assert np.abs(u).max() <= lim and abs(u.std() - lim / 3 ** .5) < 0.02
    k = _draw(I.KaimingNormal(), n)
    assert abs(k.std() - np.sqrt(2 / fi)) < 0.02 * k.std()
    ku = _draw(I.KaimingUniform(negative_slope=0.1), n)
    assert np.abs(ku.max()) <= np.sqrt(2 / 1.01) * np.sqrt(3 / fi)
    t = _draw(I.TruncatedNormal(1.0, 2.0), n)
    assert t.min() >= 1.0 - 4.0 and t.max() <= 1.0 + 4.0
    assert abs(t.mean() - 1.0) < 0.05
    nm = _draw(I.Normal(0.5, 0.1), n)
    assert abs(nm.mean() - 0.5) < 0.01 and abs(nm.std() - 0.1) < 0.005
    un = _draw(I.Uniform(-2, 3), n)
    assert un.min() >= -2 and un.max() < 3 and abs(un.mean() - 0.5) < 0.05
    q = _draw(I.Orthogonal(2.0), (6, 10))
    np.testing.assert_allclose(q @ q.T, 4 * np.eye(6), atol=1e-5)
    q = _draw(I.Orthogonal(), (10, 6))
    np.testing.assert_allclose(q.T @ q, np.eye(6), atol=1e-5)
    np.testing.assert_array_equal(_draw(I.Constant(0.25), (3,)), 0.25)
    np.testing.assert_array_equal(_draw(I.Assign([1, 2, 3]), (3,)),
                                  [1, 2, 3])
    assert I.calculate_gain("leaky_relu", 0.2) == \
        J.nn.initializer.calculate_gain("leaky_relu", 0.2)


@pytest.mark.parametrize("name,shape", [("Dirac", (4, 2, 3, 3)),
                                        ("Bilinear", (2, 2, 4, 4))])
def test_structured_initializers_equal_jax(name, shape):
    want = J.create_parameter(list(shape), "float32")
    getattr(J.nn.initializer, name)()(want)
    got = _draw(getattr(P.nn.initializer, name)(), shape)
    np.testing.assert_array_equal(got, np.asarray(want.numpy()))


def test_global_initializer_and_regularizers():
    I = P.nn.initializer
    I.set_global_initializer(I.Constant(0.5), I.Constant(-1.0))
    try:
        lin = P.nn.LayerNorm(3)         # weight: Constant(1) after create
        bil = P.nn.Bilinear(2, 2, 3)    # bias from the global initializer
    finally:
        I.set_global_initializer(None, None)
    np.testing.assert_array_equal(_np(lin.bias), -1.0)
    np.testing.assert_array_equal(_np(bil.bias), -1.0)
    import paddle_tpu.regularizer as jreg
    w = np.array([1.5, -2.0, 0.0], np.float32)
    for name in ("L1Decay", "L2Decay"):
        got = getattr(P.regularizer, name)(0.1)(torch.from_numpy(w))
        want = getattr(jreg, name)(0.1)(w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---- the in-place family through a non-leaf, against the JAX tape ----

INPLACE = {
    "sin_": lambda p, y, z: p.sin_(y),
    "add_": lambda p, y, z: p.add_(y, z),
    "multiply_": lambda p, y, z: p.multiply_(y, z),
    "clip_": lambda p, y, z: p.clip_(y, -0.5, 0.5),
    "scale_": lambda p, y, z: p.scale_(y, 2.0, 0.5),
    "pow_": lambda p, y, z: p.pow_(y, 2.0),
    "where_": lambda p, y, z: p.where_(p.greater_than(z, y), y, z),
    "tanh_": lambda p, y, z: p.tanh_(y),
}


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_grad_through_a_non_leaf(name):
    r = _rng(name)
    xa, za = _f32(r, 3, 4), _f32(r, 3, 4)
    w = _f32(r, 3, 4)
    res = {}
    for pkg in (J, P):
        x = pkg.to_tensor(xa, stop_gradient=False)
        z = pkg.to_tensor(za, stop_gradient=False)
        y = pkg.multiply(x, pkg.to_tensor(np.float32(1.5)))
        before = y.data_ptr() if pkg is P else None
        out = INPLACE[name](pkg, y, z)
        assert out is y
        if pkg is P:
            assert y.data_ptr() == before     # the same storage
        pkg.sum(pkg.multiply(y, pkg.to_tensor(w))).backward()
        res[pkg] = (_np(y), _np(x.grad), None if z.grad is None
                    else _np(z.grad))
    _close(res[P][0], res[J][0], f"{name} value")
    _close(res[P][1], res[J][1], f"{name} grad x")
    if res[J][2] is not None:
        _close(res[P][2], res[J][2], f"{name} grad z")


def test_inplace_refuses_a_leaf_and_rebinds_a_dtype_change():
    x = P.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf"):
        P.sin_(x)
    y = P.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
    out = P.less_than_(y, P.to_tensor(np.float32(2.5)))
    assert out is y and str(y.dtype) == "torch.bool"
    np.testing.assert_array_equal(y.numpy(), [True, True, False])
    j = J.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
    J.less_than_(j, J.to_tensor(np.float32(2.5)))
    assert np.asarray(j.numpy()).dtype == np.bool_


def _breadth_inplace():
    return sorted(n for n in oc.CASES if n.endswith("_")
                  and oc.module_of(n, P.ops)[0] == "breadth")


@pytest.mark.parametrize("name", _breadth_inplace())
def test_inplace_writes_in_place_unless_listed_to_rebind(name):
    """Each in-place case of the op table writes into its target's
    storage, except those of INPLACE_REBINDS, which change its dtype or
    shape and rebind it."""
    assert oc.inplace_keeps_storage(P, name, "cpu") == \
        (name not in oc.INPLACE_REBINDS)


def test_inplace_rebind_list_names_real_cases():
    assert set(oc.INPLACE_REBINDS) <= set(_breadth_inplace())
