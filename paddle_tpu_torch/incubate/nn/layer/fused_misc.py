"""Fused miscellaneous layers: counterpart of
``paddle_tpu/incubate/nn/layer/fused_misc.py`` (``FusedLinear``,
``FusedDropoutAdd``, ``FusedEcMoe``), each one op of the library. Every
layer with parameters takes a keyword-only ``device`` (default: the
card)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ....core import generator as gen
from ....core.tensor import as_port, plain_views
from ....nn.layer.layers import Layer
from ....ops.dispatch import apply

__all__ = ["FusedLinear", "FusedDropoutAdd", "FusedEcMoe"]


class FusedLinear(Layer):
    """``x @ W + b`` as one op (``fused_linear``); W is ``[in, out]``, or
    ``[out, in]`` with ``transpose_weight``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.create_parameter(shape, attr=weight_attr,
                                            device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        from ..functional import fused_linear
        return fused_linear(x, self.weight, self.bias,
                            transpose_weight=self.transpose_weight)


class FusedDropoutAdd(Layer):
    """``dropout(x) + y`` in one op while training; ``x + y`` otherwise
    (as the JAX layer: no ``downscale_in_infer`` scaling in eval)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        if not self.training or self.p == 0:
            from ....ops.math import add
            return add(x, y)
        key = gen.next_key(device=x.device)
        p, mode = self.p, self.mode

        def f(*ts):
            xv, yv = plain_views(ts)
            keep = torch.rand(xv.shape, generator=key, device=xv.device) \
                < 1.0 - p
            kept = xv / (1.0 - p) if mode == "upscale_in_train" else xv
            return as_port(torch.where(keep, kept, 0.0) + yv)
        return apply(f, x, y, op_name="fused_dropout_add")

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedEcMoe(Layer):
    """Expert-choice MoE feed-forward as one pair of batched products over
    the expert axis: the gate-weighted mixture of every expert's FFN (the
    JAX layer's ``jax.nn.gelu``: the tanh form)."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type,
                 weight_attr=None, bias_attr=None, *, device=None):
        super().__init__()
        if act_type not in ("gelu", "relu"):
            raise ValueError(f"unsupported act_type {act_type!r}")
        self.act_type = act_type
        kw = dict(device=device)
        self.bmm_weight0 = self.create_parameter(
            [num_experts, hidden_size, inter_size], attr=weight_attr, **kw)
        self.bmm_bias0 = self.create_parameter(
            [num_experts, 1, inter_size], attr=bias_attr, is_bias=True, **kw)
        self.bmm_weight1 = self.create_parameter(
            [num_experts, inter_size, hidden_size], attr=weight_attr, **kw)
        self.bmm_bias1 = self.create_parameter(
            [num_experts, 1, hidden_size], attr=bias_attr, is_bias=True,
            **kw)

    def forward(self, x, gate):
        act = (lambda v: TF.gelu(v, approximate="tanh")) \
            if self.act_type == "gelu" else torch.relu

        def f(*ts):
            xv, gv, w0, b0, w1, b1 = plain_views(ts)
            probs = torch.softmax(gv, -1)                     # (B, S, E)
            h = act(torch.einsum("bsd,edi->bsei", xv, w0) + b0[:, 0])
            out = torch.einsum("bsei,eih->bseh", h, w1) + b1[:, 0]
            return as_port(torch.einsum("bseh,bse->bsh", out, probs))
        return apply(f, x, gate, self.bmm_weight0, self.bmm_bias0,
                     self.bmm_weight1, self.bmm_bias1, op_name="fused_ec_moe")
