"""The port's convolutions and pools against the JAX package's, on the CPU.

Every case of ``CONV_POOL_FCASES`` and ``CONV_POOL_LCASES``
(``tests/torch_nn_cases.py``: SAME with stride 2, asymmetric pads,
channel-last, dilation, groups, transposed convolutions with
``output_size`` / ``output_padding``, pools with ``ceil_mode`` including
a window wholly in the padding, ``return_mask``, adaptive bins) goes
through both packages on the same numpy inputs: outputs and input grads
(and, for the layers, parameter grads, the port layer loaded with the
JAX layer's state) at ``rtol=1e-5, atol=1e-6`` in float32. The JAX
package's caveats hold in the port too: a grouped transposed convolution
raises ``ValueError``, and the all-padding ``ceil_mode`` window gives
``-inf`` (max) and ``nan`` (exclusive avg).
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev

from test_torch_nn_layers import (check_functional, check_layer,
                                  functional_refs, layer_refs)
from torch_nn_cases import CONV_POOL_FCASES, CONV_POOL_LCASES, _f32, _rng


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


@pytest.fixture(scope="module")
def frefs():
    return functional_refs(CONV_POOL_FCASES)


@pytest.fixture(scope="module")
def lrefs():
    return layer_refs(CONV_POOL_LCASES)


@pytest.mark.parametrize("name", sorted(CONV_POOL_FCASES))
def test_functional_against_jax(name, frefs):
    check_functional(name, CONV_POOL_FCASES, frefs)


@pytest.mark.parametrize("name", sorted(CONV_POOL_LCASES))
def test_layer_against_jax(name, lrefs):
    check_layer(name, CONV_POOL_LCASES, lrefs)


@pytest.mark.parametrize("fn", ["conv1d_transpose", "conv2d_transpose",
                                "conv3d_transpose"])
def test_grouped_transposed_conv_raises_in_both(fn):
    n = int(fn[4])
    r = _rng(fn)
    x = _f32(r, 1, 4, *([5] * n))
    w = _f32(r, 4, 3, *([3] * n))
    for pkg in (J, P):
        with pytest.raises(ValueError):
            getattr(pkg.nn.functional, fn)(pkg.to_tensor(x),
                                           pkg.to_tensor(w), groups=2)


def test_ceil_mode_keeps_the_window_that_starts_in_padding():
    """L=5, k=2, s=2, p=1, ceil_mode: 4 windows in both packages (torch's
    own ceil_mode gives 3); the last holds only padding."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5)
    for pkg in (J, P):
        F = pkg.nn.functional
        mx = np.asarray(F.max_pool1d(pkg.to_tensor(x), 2, 2, 1,
                                     ceil_mode=True).numpy())
        av = np.asarray(F.avg_pool1d(pkg.to_tensor(x), 2, 2, 1,
                                     ceil_mode=True).numpy())
        vals, mask = F.max_pool1d(pkg.to_tensor(x), 2, 2, 1,
                                  return_mask=True, ceil_mode=True)
        np.testing.assert_array_equal(mx, [[[0, 2, 4, -np.inf]]])
        np.testing.assert_array_equal(av[..., :3], [[[0, 1.5, 3.5]]])
        assert np.isnan(av[0, 0, 3])
        np.testing.assert_array_equal(np.asarray(mask.numpy()),
                                      [[[0, 2, 4, 5]]])
        assert "int32" in str(mask.dtype)


@pytest.mark.parametrize("n,fmt", [(1, "NLC"), (2, "NHWC"), (3, "NDHWC")])
def test_return_mask_refuses_channel_last_in_both(n, fmt):
    x = np.zeros((1,) + (4,) * n + (2,), np.float32)
    for pkg in (J, P):
        with pytest.raises(NotImplementedError):
            getattr(pkg.nn.functional, f"max_pool{n}d")(
                pkg.to_tensor(x), 2, return_mask=True, data_format=fmt)


def test_output_size_out_of_reach_raises_the_jax_message():
    r = _rng("osize")
    x, w = _f32(r, 1, 2, 4, 4), _f32(r, 2, 3, 3, 3)
    msgs = []
    for pkg in (J, P):
        with pytest.raises(ValueError) as e:
            pkg.nn.functional.conv2d_transpose(
                pkg.to_tensor(x), pkg.to_tensor(w), stride=2, padding=1,
                output_size=[10, 7])
        msgs.append(str(e.value).rsplit(": ", 2)[-2:])
    assert msgs[0] == msgs[1]


def test_conv_layers_initialise_as_the_jax_layers():
    """KaimingUniform weights within sqrt(6 / fan_in), biases within
    1 / sqrt(fan_in), no bias with bias_attr=False, and the JAX keys."""
    P.seed(4, "cpu")
    for cls, args, fan_in in (("Conv2D", (6, 8, 3), 6 * 9),
                              ("Conv2DTranspose", (6, 8, 3), 6 * 9),
                              ("Conv1D", (4, 8, 5, 1, 0, 1, 2), 2 * 5)):
        pl, jl = getattr(P.nn, cls)(*args), getattr(J.nn, cls)(*args)
        assert list(pl.state_dict()) == list(jl.state_dict())
        assert tuple(pl.weight.shape) == tuple(jl.weight.shape)
        w, b = pl.weight.numpy(), pl.bias.numpy()
        assert np.abs(w).max() <= np.sqrt(6 / fan_in)
        assert np.abs(w).max() > 0.8 * np.sqrt(6 / fan_in)
        assert np.abs(b).max() <= 1 / np.sqrt(fan_in)
    assert P.nn.Conv2D(3, 4, 3, bias_attr=False).bias is None


def test_conv_pool_under_amp_cast_as_the_jax_package():
    """O1 bf16: conv2d is on the white list (bf16 out), the pools keep
    their input's dtype; the values agree at bf16 rounding."""
    r = _rng("amp")
    x, w = _f32(r, 2, 3, 8, 8), _f32(r, 4, 3, 3, 3)
    outs = {}
    for pkg in (J, P):
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            y = pkg.nn.functional.conv2d(pkg.to_tensor(x), pkg.to_tensor(w),
                                         padding=1)
            z = pkg.nn.functional.max_pool2d(y, 2)
        outs[pkg] = ("bfloat16" in str(y.dtype), "bfloat16" in str(z.dtype),
                     np.asarray(z.astype("float32").numpy()))
    assert outs[P][:2] == outs[J][:2] == (True, True)
    np.testing.assert_allclose(outs[P][2], outs[J][2], rtol=2 ** -7,
                               atol=1e-2)
