"""The port's ``Tensor`` and ``Parameter`` against the JAX classes.

``Tensor`` is a ``torch.Tensor`` subclass: every op on one gives one
(``.grad`` too), and it carries the JAX class's attributes. Values are
compared exactly, dtypes by name.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.jit import capture


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _name(t):
    return str(t.dtype).replace("torch.", "") if isinstance(
        t, torch.Tensor) else np.dtype(t.dtype).name


@pytest.mark.parametrize("data", [1.0, 3, True, [1, 2], [1.5, 2.5],
                                  np.array([1.0]), np.array([1], np.int32),
                                  [[1, 2], [3, 4]]])
def test_to_tensor_dtype_rules_equal_jax(data):
    got, want = P.to_tensor(data), J.to_tensor(data)
    assert _name(got) == _name(want)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.stop_gradient and want.stop_gradient


def test_attributes_match_the_jax_class():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    p, j = P.to_tensor(a), J.to_tensor(a)
    assert list(p.shape) == j.shape and p.ndim == j.ndim
    assert p.size == j.size == 6 and p.size() == (2, 3) and p.size(1) == 3
    assert p.numel() == j.numel()
    assert p.item() if False else True
    assert P.to_tensor(2.5).item() == J.to_tensor(2.5).item()
    assert p.tolist() == j.tolist()
    assert _name(p.astype("int32")) == _name(j.astype("int32")) == "int32"
    assert p.place == "cpu" and isinstance(p, P.Tensor) and P.is_tensor(p)
    assert not P.is_tensor(torch.ones(1))
    np.testing.assert_array_equal(np.asarray(p), np.asarray(j))
    b = P.to_tensor(a).astype("bfloat16")
    assert b.numpy().dtype == np.float32      # numpy has no bfloat16


def test_ops_on_a_tensor_give_tensors_and_grad_is_a_tensor():
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    assert not x.stop_gradient and x.requires_grad
    y = (x * x).sum()
    assert isinstance(y, P.Tensor) and isinstance(torch.exp(x), P.Tensor)
    assert isinstance(x.max(0).values, P.Tensor)
    y.backward()
    assert isinstance(x.grad, P.Tensor)
    np.testing.assert_array_equal(x.gradient(), [2.0, 4.0, 6.0])
    x.clear_grad()
    assert x.grad is None
    x.stop_gradient = True
    assert not x.requires_grad


def test_detach_hooks_retain_grads_against_jax():
    def run(pkg):
        x = pkg.to_tensor([1.0, -2.0, 3.0], stop_gradient=False)
        h = pkg.multiply(x, 3.0)
        h.retain_grads()
        seen = []
        x.register_hook(lambda g: seen.append(g.numpy().copy()) or g * 2)
        d = h.detach()
        assert d.stop_gradient
        pkg.sum(pkg.multiply(h, h)).backward()
        return x.grad.numpy(), h.grad.numpy(), seen[0]
    for g, w in zip(run(P), run(J)):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_detach_inplace_set_value_and_copy():
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    x.detach_()
    assert x.stop_gradient
    x.set_value(np.array([5.0, 6.0]))
    np.testing.assert_array_equal(x.numpy(), [5.0, 6.0])
    assert _name(x) == "float32"
    x.copy_(P.to_tensor([7.0, 8.0]))
    np.testing.assert_array_equal(x.numpy(), [7.0, 8.0])
    j = J.to_tensor([1.0, 2.0])
    j.set_value(np.array([5.0, 6.0]))
    assert j.numpy().tolist() == [5.0, 6.0]


def test_parameter_is_an_nn_parameter_and_trains():
    p = P.Parameter(torch.ones(3), name="w")
    jp = J.Parameter(np.ones(3, np.float32), name="w")
    assert p.stop_gradient == jp.stop_gradient is False
    assert p.persistable and jp.persistable and p.name == "w"
    assert isinstance(p, torch.nn.Parameter)
    m = torch.nn.Module()
    m.w = p
    assert list(m.state_dict()) == ["w"]
    assert type(p * 2) is P.Tensor
    frozen = P.Parameter(torch.ones(2), trainable=False)
    assert frozen.stop_gradient
    q = copy.deepcopy(p)
    assert type(q) is P.Parameter and not q.stop_gradient
    r = pickle.loads(pickle.dumps(p))
    assert type(r) is P.Parameter and r.name == "w"
    np.testing.assert_array_equal(r.numpy(), p.numpy())


def test_creation_places_on_the_card_by_default():
    """With no device set, creation asks for the card: raises here."""
    pdev._state.device = None
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: P.to_tensor([1.0]), lambda: P.zeros([2]),
                 lambda: P.arange(3), lambda: P.randn([2]),
                 lambda: P.create_parameter([2, 2], "float32")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    t = P.to_tensor([1.0], place="cpu")
    assert t.place == "cpu"


def test_numpy_and_item_trip_the_capture_sync_guard():
    x = P.to_tensor([1.0, 2.0])
    with capture._SyncGuard():
        with pytest.raises(capture.HostSync):
            x.numpy()
        with pytest.raises(capture.HostSync):
            x.sum().item()


def test_methods_installed_from_the_op_tables():
    x = P.to_tensor(np.arange(6.0, dtype=np.float32).reshape(2, 3))
    j = J.to_tensor(np.arange(6.0, dtype=np.float32).reshape(2, 3))
    for name, args in (("take_along_axis", (P.to_tensor([[0], [2]]), 1)),
                       ("masked_select", (x > 2,)),
                       ("logit", ()), ("scale", (2.0, 1.0)),
                       ("cast", ("int64",))):
        jargs = [J.to_tensor(a.numpy()) if isinstance(a, torch.Tensor)
                 else a for a in args]
        np.testing.assert_allclose(getattr(x, name)(*args).numpy(),
                                   getattr(j, name)(*jargs).numpy(),
                                   rtol=1e-6)
    # operators follow the JAX promotion rules
    i = P.to_tensor([1, 2])
    assert _name(i + 2.5) == _name(J.to_tensor([1, 2]) + 2.5) == "float64"
    assert _name(2.5 - i) == _name(2.5 - J.to_tensor([1, 2]))
    np.testing.assert_array_equal((7 // i).numpy(),
                                  (7 // J.to_tensor([1, 2])).numpy())


@pytest.mark.parametrize("value", [1.5, 3, np.float32(2), np.int64(7),
                                   np.array(2.5), True])
def test_a_scalar_stays_0_d_as_in_jax(value):
    """A Python or numpy scalar gives a 0-d tensor through ``to_tensor``,
    ``Tensor``, ``Parameter`` and ``set_value``, as in the JAX package."""
    want = list(J.to_tensor(value).shape)
    assert want == []
    assert list(P.to_tensor(value).shape) == want
    assert list(P.Tensor(value).shape) == want
    if not isinstance(value, bool):
        assert list(P.Parameter(value).shape) == want
    t = P.to_tensor(np.float32(0.0))
    assert list(t.set_value(value).shape) == want
    j = J.to_tensor(np.float32(1.0))
    assert list((P.mean(P.ones([3])) * P.to_tensor(2.0)).shape) == \
        list((J.mean(J.ones([3])) * j).shape)
