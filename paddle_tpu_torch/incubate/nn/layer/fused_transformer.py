"""Fused transformer layers: counterpart of
``paddle_tpu/incubate/nn/layer/fused_transformer.py``
(``FusedBiasDropoutResidualLayerNorm``, ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedTransformerEncoderLayer``,
``FusedMultiTransformer``).

The parameters keep the JAX layers' names, shapes and state-dict keys
(the qkv weight ``[3, H, D, E]``; ``FusedMultiTransformer``'s twelve
per-layer lists registered as ``p{i}_{j}``, list i, layer j), so
``Layer.set_state_dict`` of the JAX layer's numpy state gives the same
function. Compute goes through ``incubate.nn.functional``. Every layer
takes a keyword-only ``device`` (default: the card).
"""
from __future__ import annotations

import torch

from ....core.device import resolve_device
from ....core.tensor import Tensor
from ....nn.initializer import Constant
from ....nn.layer.layers import Layer
from .. import functional as IF

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedMultiTransformer"]


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + linear_bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None):
        super().__init__()
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=bias_attr, is_bias=True, device=device)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr, default_initializer=Constant(1.0),
            device=device)
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True,
                                             device=device)

    def forward(self, x, residual):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self._dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)


class FusedMultiHeadAttention(Layer):
    """Self-attention with fused qkv and output projections, pre- or
    post-LN (``normalize_before``)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self._dropout_rate = dropout_rate
        self._attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        one = Constant(1.0)

        def param(shape, attr=None, **kw):
            return self.create_parameter(shape, attr=attr, device=device,
                                         **kw)
        self.qkv_weight = param([3, num_heads, self.head_dim, embed_dim],
                                qkv_weight_attr)
        self.qkv_bias = param([3, num_heads, self.head_dim], qkv_bias_attr,
                              is_bias=True)
        self.linear_weight = param([embed_dim, embed_dim],
                                   linear_weight_attr)
        self.linear_bias = param([embed_dim], linear_bias_attr, is_bias=True)
        self.pre_ln_scale = param([embed_dim], pre_ln_scale_attr,
                                  default_initializer=one)
        self.pre_ln_bias = param([embed_dim], is_bias=True)
        self.ln_scale = param([embed_dim], ln_scale_attr,
                              default_initializer=one)
        self.ln_bias = param([embed_dim], is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache, attn_mask=attn_mask,
            dropout_rate=self._dropout_rate,
            attn_dropout_rate=self._attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"normalize_before={self.normalize_before}")


class FusedFeedForward(Layer):
    """``linear2(dropout(act(linear1(x))))`` with the residual, pre- or
    post-LN."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, device=None):
        super().__init__()
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._activation = activation
        self._epsilon = epsilon
        self.normalize_before = normalize_before
        one = Constant(1.0)

        def param(shape, attr=None, **kw):
            return self.create_parameter(shape, attr=attr, device=device,
                                         **kw)
        self.linear1_weight = param([d_model, dim_feedforward],
                                    linear1_weight_attr)
        self.linear1_bias = param([dim_feedforward], linear1_bias_attr,
                                  is_bias=True)
        self.linear2_weight = param([dim_feedforward, d_model],
                                    linear2_weight_attr)
        self.linear2_bias = param([d_model], linear2_bias_attr, is_bias=True)
        self.ln1_scale = param([d_model], ln1_scale_attr,
                               default_initializer=one)
        self.ln1_bias = param([d_model], is_bias=True)
        self.ln2_scale = param([d_model], ln2_scale_attr,
                               default_initializer=one)
        self.ln2_bias = param([d_model], is_bias=True)

    def forward(self, src, cache=None):
        return IF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate, activation=self._activation,
            ln1_epsilon=self._epsilon, ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, device=device)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=device)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


# FusedMultiTransformer's per-layer lists, in registration order (list i
# of the state-dict key p{i}_{j})
_LISTS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
          "linear_weights", "linear_biases", "ffn_ln_scales",
          "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
          "ffn2_biases")


class FusedMultiTransformer(Layer):
    """``num_layers`` pre-LN transformer layers in one fused call, with
    static-length KV caches for generation (``init_caches``). Each list
    (``qkv_weights``, ``ffn1_biases``, ...) reads the registered
    parameters ``p{i}_{j}``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, dropout_rate=0.0,
                 activation="gelu", normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, *, device=None):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN "
                             "(normalize_before=True)")
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) if isinstance(
                qkv_weight_attrs, (list, tuple)) else 1
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self._dropout_rate = dropout_rate
        self._activation = activation
        self._epsilon = epsilon
        E, H, D, F = embed_dim, num_heads, self.head_dim, dim_feedforward
        shapes = {"ln_scales": ([E], False), "ln_biases": ([E], True),
                  "qkv_weights": ([3, H, D, E], False),
                  "qkv_biases": ([3, H, D], True),
                  "linear_weights": ([E, E], False),
                  "linear_biases": ([E], True),
                  "ffn_ln_scales": ([E], False), "ffn_ln_biases": ([E], True),
                  "ffn1_weights": ([E, F], False),
                  "ffn1_biases": ([F], True),
                  "ffn2_weights": ([F, E], False),
                  "ffn2_biases": ([E], True)}
        for i, lst in enumerate(_LISTS):
            shape, is_bias = shapes[lst]
            init = Constant(1.0) if lst in ("ln_scales", "ffn_ln_scales") \
                else None
            for j in range(num_layers):
                self.add_parameter(f"p{i}_{j}", self.create_parameter(
                    shape, is_bias=is_bias, default_initializer=init,
                    device=device))

    def _list(self, i):
        return [self._parameters[f"p{i}_{j}"] for j in range(self.num_layers)]

    def init_caches(self, batch_size, max_len, dtype=None, *, device=None):
        """``num_layers`` zero caches ``[2, batch_size, H, max_len, D]`` of
        ``dtype`` (default: the qkv weights') on ``device`` (default: the
        layer's)."""
        w = self.qkv_weights[0]
        dev = resolve_device(device) if device is not None else w.device
        dt = dtype or w.dtype
        if isinstance(dt, str):
            from ....core import dtype as dtypes
            dt = dtypes.convert_dtype(dt)
        shape = (2, batch_size, self.num_heads, max_len, self.head_dim)
        return [Tensor(torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None):
        return IF.fused_multi_transformer(
            src, self.ln_scales, self.ln_biases, self.qkv_weights,
            self.qkv_biases, self.linear_weights, self.linear_biases,
            self.ffn_ln_scales, self.ffn_ln_biases, self.ffn1_weights,
            self.ffn1_biases, self.ffn2_weights, self.ffn2_biases,
            pre_layer_norm=True, epsilon=self._epsilon, cache_kvs=caches,
            pre_caches=pre_caches, rotary_embs=rotary_embs,
            rotary_emb_dims=rotary_emb_dims, seq_lens=seq_lens,
            time_step=time_step, attn_mask=attn_mask,
            dropout_rate=self._dropout_rate, activation=self._activation,
            training=self.training)


for _i, _name in enumerate(_LISTS):
    setattr(FusedMultiTransformer, _name,
            property(lambda self, i=_i: self._list(i)))
