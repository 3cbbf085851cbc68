"""The port's autograd (over torch's engine) against the JAX tape:
``backward`` seeding, ``grad`` with ``create_graph`` and ``allow_unused``,
hooks, ``PyLayer``, ``saved_tensors_hooks``, grad modes and the
functional transforms (``jvp``, ``vjp``, ``jacobian``, ``hessian``,
``vhp``, ``Jacobian``, ``Hessian``), at rtol 1e-5 on float32."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev

R = dict(rtol=1e-5, atol=1e-6)
X = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _both(fn):
    return fn(P), fn(J)


def test_backward_seeds_size_one_roots_with_ones_and_refuses_others():
    def run(pkg):
        x = pkg.to_tensor(X, stop_gradient=False)
        pkg.sum(pkg.multiply(x, x), axis=[0, 1], keepdim=True).backward()
        return x.grad.numpy()
    g, w = _both(run)
    np.testing.assert_allclose(g, w, **R)
    for pkg in (P, J):
        x = pkg.to_tensor(X, stop_gradient=False)
        with pytest.raises(RuntimeError, match="non-scalar"):
            pkg.multiply(x, 2.0).backward()


def test_grad_create_graph_double_backward_and_allow_unused():
    def run(pkg):
        x = pkg.to_tensor(X, stop_gradient=False)
        z = pkg.to_tensor(X, stop_gradient=False)
        y = pkg.sum(pkg.multiply(pkg.multiply(x, x), x))
        (gx,) = pkg.grad(y, [x], create_graph=True)
        pkg.sum(gx).backward()
        y2 = pkg.sum(pkg.multiply(x, 2.0))
        gz = pkg.grad(y2, [x, z], allow_unused=True)
        assert gz[1] is None
        return gx.numpy(), x.grad.numpy(), gz[0].numpy()
    for g, w in zip(*_both(run)):
        np.testing.assert_allclose(g, w, **R)
    for pkg in (P, J):
        x = pkg.to_tensor(X, stop_gradient=False)
        z = pkg.to_tensor(X, stop_gradient=False)
        with pytest.raises(RuntimeError, match="no gradient"):
            pkg.grad(pkg.sum(x), [z])


def test_grad_leaves_the_inputs_grad_alone():
    x = P.to_tensor(X, stop_gradient=False)
    P.sum(x).backward()
    before = x.grad.numpy().copy()
    P.grad(P.sum(P.multiply(x, 3.0)), [x])
    np.testing.assert_array_equal(x.grad.numpy(), before)


def test_no_grad_enable_grad_set_grad_enabled():
    x = P.to_tensor(X, stop_gradient=False)
    with P.no_grad():
        assert P.multiply(x, 2.0).stop_gradient
        assert not P.is_grad_enabled()
        with P.enable_grad():
            assert not P.multiply(x, 2.0).stop_gradient

    @P.no_grad()
    def f():
        return P.multiply(x, 2.0)
    assert f().stop_gradient
    P.autograd.set_grad_enabled(False)
    assert not torch.is_grad_enabled()
    P.autograd.set_grad_enabled(True)
    with P.set_grad_enabled(False):
        assert not P.is_grad_enabled()
    assert P.is_grad_enabled()


def test_pylayer_forward_backward_match_jax():
    def run(pkg):
        class Cube(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k=3.0):
                ctx.save_for_backward(x)
                ctx.k = k
                return pkg.multiply(pkg.multiply(pkg.multiply(x, x), x), k)

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor
                return pkg.multiply(dy, pkg.multiply(pkg.multiply(x, x),
                                                     3.0 * ctx.k))
        x = pkg.to_tensor(X, stop_gradient=False)
        y = Cube.apply(x, k=2.0)
        pkg.sum(y).backward()
        return y.numpy(), x.grad.numpy()
    for g, w in zip(*_both(run)):
        np.testing.assert_allclose(g, w, **R)


def test_saved_tensors_hooks_pack_and_unpack_pylayer_saves():
    calls = []

    def pack(t):
        calls.append("pack")
        assert isinstance(t, P.Tensor)
        return t.numpy()

    def unpack(a):
        calls.append("unpack")
        return torch.from_numpy(a)

    class Sq(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 2 * x
    x = P.to_tensor(X, stop_gradient=False)
    with P.autograd.saved_tensors_hooks(pack, unpack):
        y = Sq.apply(x)
    P.sum(y).backward()
    assert "pack" in calls and "unpack" in calls
    np.testing.assert_allclose(x.grad.numpy(), 2 * X, **R)


def _f(pkg):
    def f(x):
        return pkg.sum(pkg.multiply(pkg.sin(x), x), axis=1)
    return f


def _g(pkg):
    def g(x):
        return pkg.sum(pkg.multiply(pkg.multiply(x, x), pkg.cos(x)))
    return g


@pytest.mark.parametrize("name", ["jvp", "vjp", "jacobian", "hessian",
                                  "vhp", "Jacobian", "Hessian"])
def test_functional_transforms_match_jax(name):
    def run(pkg):
        x = pkg.to_tensor(X)
        fa = pkg.autograd
        if name == "jvp":
            return fa.jvp(_f(pkg), x, pkg.to_tensor(X * 2))
        if name == "vjp":
            return fa.vjp(_f(pkg), x)
        if name == "jacobian":
            return fa.jacobian(_f(pkg), x)
        if name == "hessian":
            return fa.hessian(_g(pkg), x)
        if name == "vhp":
            return fa.vhp(_g(pkg), x, pkg.to_tensor(X))
        if name == "Jacobian":
            return fa.Jacobian(_f(pkg), x)[:, :]
        return fa.Hessian(_g(pkg), x)[:, :]
    got, want = _both(run)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.shape) == list(w.shape)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **R)
