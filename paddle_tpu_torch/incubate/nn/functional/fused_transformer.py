"""Fused transformer functionals: counterpart of
``paddle_tpu/incubate/nn/functional/fused_transformer.py``.

Each functional is one op of the library (``ops.dispatch.apply`` under
the JAX op name: ``fused_layer_norm``, ``fused_multi_head_attention``,
``fused_mha_decode``, ``fused_feedforward``, ...), so the amp lists, the
profiler's spans and the static recorder see it as they see the JAX one.
The functions the dispatch runs compute on plain torch views of their
inputs, as the JAX ones compute on raw arrays. No Pallas kernel sits on
this path in the JAX package (attention is an einsum and a softmax over
the whole cache), and none does here: these are its plain counterparts.

Semantics kept from the JAX package: the qkv weight ``[3, H, D, E]`` (or
the flat ``[E, 3 H D]`` form under ``transpose_qkv_wb``), the cache
``[2, B, H, S_max, D]`` written at ``time_step`` (0 in a prefill) with
the key mask ``j <= i + pos``, or per example at ``seq_lens`` in a decode
step (``q_len == 1`` only), an additive ``attn_mask`` zero-padded on the
key axis up to ``S_max``, softmax in fp32 rounded to the input dtype, the
exact (erf) gelu, ``downscale_in_infer``, and two distinct dropout draws
for the attention probabilities and the output. The caches come back as
new tensors; the ones passed in are not written. Dropout draws come from
``core.generator.next_key`` on the input's device: the port's streams
differ from the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ....core import generator as gen
from ....core.tensor import as_port, plain_views
from ....ops.dispatch import apply

__all__ = ["fused_layer_norm", "fused_rms_norm", "fused_matmul_bias",
           "fused_linear", "fused_linear_activation", "fused_dropout_add",
           "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "fused_multi_head_attention", "fused_multi_transformer"]

_ACT = {
    "relu": torch.relu,
    "gelu": lambda v: TF.gelu(v, approximate="none"),   # exact (erf)
    "silu": TF.silu,
}


def _key(training, rate, x):
    """A dropout generator on ``x``'s device when a draw is due."""
    return gen.next_key(device=x.device) if (training and rate > 0.0) \
        else None


def _dropout(x, rate, key, training, mode="upscale_in_train"):
    if rate == 0.0:
        return x
    if not training or key is None:
        # downscale_in_infer scales at inference time
        if mode == "downscale_in_infer":
            return x * (1.0 - rate)
        return x
    keep = torch.rand(x.shape, generator=key, device=x.device) < 1.0 - rate
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _rms_norm(x, scale, eps):
    # accumulate in >= fp32 without down-casting fp64 inputs
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc)
    y = xa * torch.rsqrt(xa.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.to(acc)
    return y.to(x.dtype)


def _pick(names, present, rest):
    """``{name: tensor}`` of the optional inputs that were given, in the
    order they were passed to the dispatch."""
    it = iter(rest)
    return {n: next(it) for n, here in zip(names, present) if here}


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     residual=None, bias=None, **kw):
    """LayerNorm of ``x (+ bias) (+ residual)`` in one op."""
    names = ("w", "b", "r", "bb")
    given = [norm_weight, norm_bias, residual, bias]
    present = [a is not None for a in given]

    def f(*ts):
        v, *rest = plain_views(ts)
        d = _pick(names, present, rest)
        if "bb" in d:
            v = v + d["bb"]
        if "r" in d:
            v = v + d["r"]
        return as_port(_layer_norm(v, d.get("w"), d.get("b"), epsilon))
    return apply(f, x, *[a for a in given if a is not None],
                 op_name="fused_layer_norm")


def fused_rms_norm(x, norm_weight=None, epsilon=1e-6, residual=None,
                   bias=None, **kw):
    """RMSNorm of ``x (+ bias) (+ residual)`` in one op: the mean square
    in >= fp32, ``x * rsqrt(ms + eps) * weight`` rounded once to x's
    dtype."""
    names = ("w", "r", "bb")
    given = [norm_weight, residual, bias]
    present = [a is not None for a in given]

    def f(*ts):
        v, *rest = plain_views(ts)
        d = _pick(names, present, rest)
        if "bb" in d:
            v = v + d["bb"]
        if "r" in d:
            v = v + d["r"]
        return as_port(_rms_norm(v, d.get("w"), epsilon))
    return apply(f, x, *[a for a in given if a is not None],
                 op_name="fused_rms_norm")


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y (+ bias)``, either operand transposed on its last two
    axes."""
    def f(*ts):
        a, b, *mb = plain_views(ts)
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = a @ b
        if mb:
            out = out + mb[0]
        return as_port(out)
    args = (x, y) if bias is None else (x, y, bias)
    return apply(f, *args, op_name="fused_matmul_bias")


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """``act(x @ y + bias)``; an unknown or None activation is none."""
    act = _ACT.get(activation or "none")
    out = fused_matmul_bias(x, y, bias, transpose_x=trans_x,
                            transpose_y=trans_y)
    if act is None:
        return out
    return apply(lambda v: as_port(act(plain_views((v,))[0])), out,
                 op_name=f"fused_{activation}")


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """``dropout(x) + y`` in one op."""
    key = _key(training, p, x)

    def f(*ts):
        a, b = plain_views(ts)
        return as_port(_dropout(a, p, key, training, mode) + b)
    return apply(f, x, y, op_name="fused_dropout_add")


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None, dropout_rate=0.5,
        ln_epsilon=1e-5, training=True, mode="upscale_in_train", name=None):
    """``layer_norm(residual + dropout(x + bias))``."""
    key = _key(training, dropout_rate, x)
    names = ("bb", "w", "b")
    given = [bias, ln_scale, ln_bias]
    present = [a is not None for a in given]

    def f(*ts):
        v, r, *rest = plain_views(ts)
        d = _pick(names, present, rest)
        if "bb" in d:
            v = v + d["bb"]
        v = _dropout(v, dropout_rate, key, training, mode)
        return as_port(_layer_norm(r + v, d.get("w"), d.get("b"),
                                   ln_epsilon))
    return apply(f, x, residual, *[a for a in given if a is not None],
                 op_name="fused_bias_dropout_residual_ln")


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None):
    """``residual + dropout2(linear2(dropout1(act(linear1(ln1(x))))))``
    with ln1 under ``pre_layer_norm``, else ln2 after the residual."""
    act = _ACT.get(activation, torch.relu)
    k1 = _key(training, dropout1_rate, x)
    k2 = _key(training, dropout2_rate, x)
    named = {"w1": linear1_weight, "w2": linear2_weight, "b1": linear1_bias,
             "b2": linear2_bias, "ln1w": ln1_scale, "ln1b": ln1_bias,
             "ln2w": ln2_scale, "ln2b": ln2_bias}
    keys = [k for k, v in named.items() if v is not None]

    def f(*ts):
        v, *rest = plain_views(ts)
        d = dict(zip(keys, rest))
        residual = v
        out = _layer_norm(v, d.get("ln1w"), d.get("ln1b"), ln1_epsilon) \
            if pre_layer_norm else v
        out = out @ d["w1"]
        if "b1" in d:
            out = out + d["b1"]
        out = _dropout(act(out), dropout1_rate, k1, training, mode)
        out = out @ d["w2"]
        if "b2" in d:
            out = out + d["b2"]
        out = _dropout(out, dropout2_rate, k2, training, mode)
        if add_residual:
            out = residual + out
        if not pre_layer_norm:
            out = _layer_norm(out, d.get("ln2w"), d.get("ln2b"), ln2_epsilon)
        return as_port(out)
    return apply(f, x, *[named[k] for k in keys], op_name="fused_feedforward")


def _rope_bhsd(q, k, sincos, pos):
    """Rotate q and k ``[B, H, S, D]`` over interleaved lanes (GPT-J, as
    fused_rotary_position_embedding with use_neox_rotary_style=False) with
    the table ``sincos [2, S_max, D/2]`` from position ``pos``: an int, a
    0-dim tensor or one position an example (``[B]``)."""
    d2 = q.shape[-1] // 2
    s = q.shape[2]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=q.device)
    idx = torch.arange(s, device=q.device)[None, :] \
        + pos.to(torch.int64).reshape(-1, 1)               # [1|B, S]
    sin = sincos[0][idx][:, None, :, :d2].float()
    cos = sincos[1][idx][:, None, :, :d2].float()

    def rot(t):
        tf = t.float()
        x1, x2 = tf[..., 0::2], tf[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(t.shape).to(t.dtype)
    return rot(q), rot(k)


def _pad_mask_to(mask, klen):
    """Zero-pad a ``[..., q, S]`` additive mask on the key axis up to
    ``klen`` (the cache columns past S are governed by the length
    mask)."""
    if mask.shape[-1] == klen:
        return mask
    return TF.pad(mask, (0, klen - mask.shape[-1]))


def _mha_core(x, d, num_heads, pre_layer_norm, pre_ln_epsilon, ln_epsilon,
              attn_mask, attn_dropout_rate, dropout_rate, add_residual,
              training, mode, ka, kd, cache_kv=None, time_step=None,
              rotary_sincos=None, seq_lens=None):
    """The fused attention block on plain tensors: qkv weight ``[3, H, D,
    E]``, cache ``[2, B, H, S_max, D]``, ``seq_lens [B]`` the per-example
    write positions of a decode step. Returns ``(out, new_cache)``."""
    residual = x
    out = _layer_norm(x, d.get("pre_ln_w"), d.get("pre_ln_b"),
                      pre_ln_epsilon) if pre_layer_norm else x
    # [B, S, E] x [3, H, D, E] -> [3, B, H, S, D]
    qkv = torch.einsum("bse,thde->tbhsd", out, d["qkv_w"])
    if "qkv_b" in d:
        qkv = qkv + d["qkv_b"][:, None, :, None, :]
    q, k, v = qkv[0], qkv[1], qkv[2]
    pos0 = 0 if time_step is None else int(time_step)
    if rotary_sincos is not None:
        q, k = _rope_bhsd(q, k, rotary_sincos,
                          seq_lens if seq_lens is not None else pos0)
    new_cache = None
    if cache_kv is not None:
        kc, vc = cache_kv[0], cache_kv[1]
        s_max = kc.shape[2]
        if seq_lens is not None:
            if q.shape[2] != 1:
                raise NotImplementedError(
                    "per-example seq_lens requires single-token decode "
                    "(q_len == 1)")
            posb = seq_lens.to(device=kc.device, dtype=torch.int64)
            idx = posb.reshape(-1, 1, 1, 1).expand(k.shape)
            kc = kc.scatter(2, idx, k.to(kc.dtype))
            vc = vc.scatter(2, idx, v.to(vc.dtype))
            jj = torch.arange(s_max, device=kc.device)[None, None, None, :]
            lm = torch.where(jj <= posb[:, None, None, None], 0.0, -1e30)
        else:
            end = pos0 + q.shape[2]
            kc = torch.slice_scatter(kc, k.to(kc.dtype), dim=2, start=pos0,
                                     end=end)
            vc = torch.slice_scatter(vc, v.to(vc.dtype), dim=2, start=pos0,
                                     end=end)
            j = torch.arange(s_max, device=kc.device)[None, :]
            i = torch.arange(q.shape[2], device=kc.device)[:, None] + pos0
            lm = torch.where(j <= i, 0.0, -1e30)[None, None]
        new_cache = torch.stack([kc, vc])
        k, v = kc, vc
        attn_mask = lm if attn_mask is None \
            else _pad_mask_to(attn_mask, s_max) + lm
    dt = torch.promote_types(q.dtype, k.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * scale).to(dt), k.to(dt))
    if attn_mask is not None:
        logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    probs = _dropout(probs, attn_dropout_rate, ka, training, mode)
    pdt = torch.promote_types(probs.dtype, v.dtype)
    ctx = torch.einsum("bhqk,bhkd->bhqd", probs.to(pdt), v.to(pdt))
    b, h, s, hd = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, h * hd)
    out = ctx @ d["lin_w"]
    if "lin_b" in d:
        out = out + d["lin_b"]
    out = _dropout(out, dropout_rate, kd, training, mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _layer_norm(out, d.get("ln_w"), d.get("ln_b"), ln_epsilon)
    return out, new_cache


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False, pre_ln_scale=None,
        pre_ln_bias=None, ln_scale=None, ln_bias=None, pre_ln_epsilon=1e-5,
        qkv_bias=None, linear_bias=None, cache_kv=None, attn_mask=None,
        dropout_rate=0.5, attn_dropout_rate=0.5, ln_epsilon=1e-5,
        training=True, mode="upscale_in_train", ring_id=-1, add_residual=True,
        num_heads=-1, transpose_qkv_wb=False, name=None):
    """The fused self-attention block: qkv weight ``[3, num_heads,
    head_dim, embed_dim]`` (or ``[E, 3 E]`` with ``transpose_qkv_wb``,
    which needs ``num_heads``); a ``cache_kv [2, B, H, S_max, D]`` is
    written from position 0 and returned with the output."""
    if transpose_qkv_wb and num_heads <= 0:
        raise ValueError(
            "num_heads must be given when transpose_qkv_wb=True (the flat "
            "[E, 3*E] weight layout cannot imply the head count)")
    ka = _key(training, attn_dropout_rate, x)
    kd = _key(training, dropout_rate, x)
    nh = num_heads
    named = {"qkv_w": qkv_weight, "lin_w": linear_weight, "qkv_b": qkv_bias,
             "lin_b": linear_bias, "pre_ln_w": pre_ln_scale,
             "pre_ln_b": pre_ln_bias, "ln_w": ln_scale, "ln_b": ln_bias}
    keys = [k for k, v in named.items() if v is not None]
    extra = [t for t in (attn_mask, cache_kv) if t is not None]

    def f(*ts):
        v, *rest = plain_views(ts)
        d = dict(zip(keys, rest[:len(keys)]))
        rem = rest[len(keys):]
        m = rem.pop(0) if attn_mask is not None else None
        ck = rem.pop(0) if cache_kv is not None else None
        w = d["qkv_w"]
        if transpose_qkv_wb:
            e = v.shape[-1]
            hd = e // nh
            w = w.reshape(e, 3, nh, hd).permute(1, 2, 3, 0)
            if "qkv_b" in d:
                d["qkv_b"] = d["qkv_b"].reshape(3, nh, hd)
        d["qkv_w"] = w
        out, nc = _mha_core(v, d, w.shape[1], pre_layer_norm, pre_ln_epsilon,
                            ln_epsilon, m, attn_dropout_rate, dropout_rate,
                            add_residual, training, mode, ka, kd,
                            cache_kv=ck)
        if nc is not None:
            return as_port(out), as_port(nc)
        return as_port(out)

    res = apply(f, x, *[named[k] for k in keys], *extra,
                op_name="fused_multi_head_attention")
    if cache_kv is not None:
        return res[0], res[1]
    return res



def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights, ffn1_biases,
        ffn2_weights, ffn2_biases, pre_layer_norm=True, epsilon=1e-5,
        cache_kvs=None, pre_caches=None, seq_lens=None, rotary_embs=None,
        time_step=None, attn_mask=None, dropout_rate=0.0, rotary_emb_dims=0,
        activation="gelu", training=False, mode="upscale_in_train",
        trans_qkvw=True, ring_id=-1, name=None):
    """Stacked fused transformer layers with optional KV caches (a list
    of ``[2, B, H, S_max, D]`` a layer). ``time_step`` (an int) writes the
    caches from that position; ``seq_lens [B]`` writes one decode token an
    example at its own position. Returns ``out``, or ``(out,
    new_cache_kvs)`` when caches are given."""
    if not trans_qkvw:
        raise ValueError(
            "trans_qkvw=False ([E, 3*H*D] weight layout) is not supported; "
            "pass weights as [3, num_heads, head_dim, embed_dim]")
    if pre_caches is not None:
        raise NotImplementedError("pre_caches is not supported")

    def opt(lst, i):
        return None if lst is None else lst[i]

    out = x
    new_caches = [] if cache_kvs is not None else None
    for i in range(len(qkv_weights)):
        ck = cache_kvs[i] if cache_kvs is not None else None
        if ck is not None:
            out_i, nc = _attn_with_step(
                out, qkv_weights[i], linear_weights[i], opt(ln_scales, i),
                opt(ln_biases, i), opt(qkv_biases, i), opt(linear_biases, i),
                ck, time_step, epsilon, pre_layer_norm, dropout_rate,
                training, mode, attn_mask=attn_mask,
                rotary_embs=rotary_embs if rotary_emb_dims > 0 else None,
                seq_lens=seq_lens)
            new_caches.append(nc)
        elif rotary_embs is not None and rotary_emb_dims > 0:
            out_i, _ = _attn_with_step(
                out, qkv_weights[i], linear_weights[i], opt(ln_scales, i),
                opt(ln_biases, i), opt(qkv_biases, i), opt(linear_biases, i),
                None, time_step, epsilon, pre_layer_norm, dropout_rate,
                training, mode, attn_mask=attn_mask, rotary_embs=rotary_embs)
        else:
            out_i = fused_multi_head_attention(
                out, qkv_weights[i], linear_weights[i],
                pre_layer_norm=pre_layer_norm,
                pre_ln_scale=opt(ln_scales, i), pre_ln_bias=opt(ln_biases, i),
                ln_scale=opt(ln_scales, i), ln_bias=opt(ln_biases, i),
                pre_ln_epsilon=epsilon, qkv_bias=opt(qkv_biases, i),
                linear_bias=opt(linear_biases, i), attn_mask=attn_mask,
                dropout_rate=dropout_rate, attn_dropout_rate=dropout_rate,
                ln_epsilon=epsilon, training=training, mode=mode)
        out = fused_feedforward(
            out_i, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=opt(ffn1_biases, i), linear2_bias=opt(ffn2_biases, i),
            ln1_scale=opt(ffn_ln_scales, i), ln1_bias=opt(ffn_ln_biases, i),
            ln2_scale=opt(ffn_ln_scales, i), ln2_bias=opt(ffn_ln_biases, i),
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, ln1_epsilon=epsilon, ln2_epsilon=epsilon,
            pre_layer_norm=pre_layer_norm, training=training, mode=mode)
    if new_caches is not None:
        return out, new_caches
    return out


def _attn_with_step(x, qkv_w, lin_w, ln_w, ln_b, qkv_b, lin_b, cache_kv,
                    time_step, epsilon, pre_layer_norm, dropout_rate,
                    training, mode, attn_mask=None, rotary_embs=None,
                    seq_lens=None):
    """The attention sub-block with the cache written at ``time_step`` (or
    at ``seq_lens``), rotary embeddings and a user ``attn_mask``: one op,
    ``fused_mha_decode``."""
    named = {"qkv_w": qkv_w, "lin_w": lin_w, "pre_ln_w": ln_w,
             "pre_ln_b": ln_b, "qkv_b": qkv_b, "lin_b": lin_b, "ln_w": ln_w,
             "ln_b": ln_b}
    named = {k: v for k, v in named.items() if v is not None}
    keys = list(named)
    ts = 0 if time_step is None else time_step
    present = [t is not None for t in (cache_kv, attn_mask, rotary_embs,
                                       seq_lens)]
    # distinct draws for the attention probabilities and the output
    ka = _key(training, dropout_rate, x)
    kd = _key(training, dropout_rate, x)

    def f(*ts_):
        v, *rest = plain_views(ts_)
        n = sum(present)
        o = _pick(("ck", "m", "rt", "sl"), present, rest[:n])
        d = dict(zip(keys, rest[n:]))
        out, nc = _mha_core(v, d, d["qkv_w"].shape[1], pre_layer_norm,
                            epsilon, epsilon, o.get("m"), dropout_rate,
                            dropout_rate, True, training, mode, ka, kd,
                            cache_kv=o.get("ck"), time_step=ts,
                            rotary_sincos=o.get("rt"), seq_lens=o.get("sl"))
        return (as_port(out), as_port(nc)) if nc is not None \
            else as_port(out)

    extra = [t for t in (cache_kv, attn_mask, rotary_embs, seq_lens)
             if t is not None]
    res = apply(f, x, *extra, *[named[k] for k in keys],
                op_name="fused_mha_decode")
    if cache_kv is not None:
        return res[0], res[1]
    return res, None
