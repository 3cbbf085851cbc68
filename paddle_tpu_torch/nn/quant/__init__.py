"""paddle_tpu_torch.nn.quant: counterpart of ``paddle_tpu/nn/quant``.

``weight_quantize`` stores a weight as int8 with per-column absmax scales
(int4 in int8 storage, values in [-8, 7]; another algorithm raises
``ValueError``). ``weight_only_linear`` dequantises into the product;
``llm_int8_linear`` runs the activation columns with an element above
``threshold`` apart from the rest, the same math as the JAX functions.
Plain torch: the JAX package has no kernel for them. ``Stub`` is the
identity a quantisation-aware pass would replace.
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor, as_torch
from ...nn.layer.layers import Layer
from ...ops.dispatch import apply

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear",
           "weight_quantize"]


class Stub(Layer):
    """Quantisation insertion point: the identity in a float graph."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x


def weight_quantize(x, algo="weight_only_int8", arch=None):
    """``(int8 weight, float32 per-column scales)``: ``round(x / scale)``
    clipped to the signed range of 8 bits (4 for ``weight_only_int4``),
    ``scale = max|column| / qmax``."""
    v = as_torch(x).detach()
    if algo not in ("weight_only_int8", "llm.int8", "weight_only_int4"):
        raise ValueError(f"unsupported algo {algo!r}")
    bits = 4 if algo == "weight_only_int4" else 8
    qmax = (1 << (bits - 1)) - 1
    scale = torch.amax(torch.abs(v), dim=0) / qmax
    q = torch.clamp(torch.round(v / torch.clamp_min(scale, 1e-10)),
                    -qmax - 1, qmax)
    return Tensor(q.to(torch.int8)), Tensor(scale.to(torch.float32))


def _dequant(xv, wq, scale):
    w = wq.to(xv.dtype)
    return w if scale is None else torch.mul(w, scale[None, :].to(xv.dtype))


def _args(x, weight, bias, weight_scale):
    return (x, weight) + ((weight_scale,) if weight_scale is not None
                          else ()) + ((bias,) if bias is not None else ())


def _split(rest, weight_scale, bias):
    scale = rest[0] if weight_scale is not None else None
    b = rest[-1] if bias is not None else None
    return scale, b


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``x @ dequant(weight) + bias``."""
    def f(xv, wq, *rest):
        scale, b = _split(rest, weight_scale, bias)
        out = torch.matmul(xv, _dequant(xv, wq, scale))
        return out if b is None else torch.add(out, b)
    return apply(f, *_args(x, weight, bias, weight_scale),
                 op_name="weight_only_linear")


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """llm.int8: the activation columns holding an element above
    ``threshold`` go through their own product, the rest through the
    dequantised int8 one (the JAX function's math: both use the same
    dequantised weight)."""
    def f(xv, wq, *rest):
        scale, b = _split(rest, weight_scale, bias)
        w = _dequant(xv, wq, scale)
        outlier = torch.any(torch.gt(torch.abs(xv), threshold),
                            dim=tuple(range(xv.dim() - 1)))
        if xv.dim() == 2:
            x_in = torch.where(outlier[None, :], 0.0, xv)
        else:
            x_in = torch.mul(xv, torch.logical_not(outlier))
        x_out = torch.sub(xv, x_in)
        out = torch.add(torch.matmul(x_in, w), torch.matmul(x_out, w))
        return out if b is None else torch.add(out, b)
    return apply(f, *_args(x, weight, bias, weight_scale),
                 op_name="llm_int8_linear")
