"""Common functionals: counterpart of
``paddle_tpu/nn/functional/common.py``.

``linear`` takes Paddle's ``[in, out]`` weight (``y = x @ W + b``).
Dropout's keep masks are Bernoulli(1 - p) draws from the input's device's
default generator (or ``key``, a ``torch.Generator``): the JAX package's
keys cannot be matched, the modes (``upscale_in_train``,
``downscale_in_infer``) and the broadcast ``axis`` are its. ``interpolate``
samples as ``jax.image.resize`` does (half-pixel centres; linear and
cubic as separable weight matrices with the Keys cubic and the antialiased
kernel when shrinking; nearest at ``floor((i + 0.5) * in / out)``), and
with ``align_corners`` as the JAX module's corner-aligned linear gather.
``class_center_sample`` runs on the host, as there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core import dtype as dtypes
from ...core.tensor import Tensor
from ...ops.dispatch import apply

__all__ = [
    "linear", "embedding", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "unfold", "fold", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "pad",
    "cosine_similarity", "label_smooth", "bilinear", "class_center_sample",
    "zeropad2d",
]


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with W ``[in, out]``."""
    if bias is None:
        return apply(_linear, x, weight, op_name="linear")
    return apply(_linear, x, weight, bias, op_name="linear")


def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    return out if bias is None else torch.add(out, bias)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; rows at ``padding_idx`` are
    zeros. ``sparse`` asks Paddle for a sparse grad; the JAX function and
    this one take the dense one."""
    return apply(_embedding, x, weight, padding_idx, op_name="embedding")


def _embedding(x, weight, padding_idx):
    out = weight[x]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def _keep(v, p, shape, key):
    return torch.rand(shape, generator=key, device=v.device) < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, key=None):
    if p == 0.0:
        return x
    if not training:
        # downscale_in_infer scales at inference time
        if mode == "downscale_in_infer":
            return x * (1.0 - p)
        return x

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            keep_axes = [a % v.dim() for a in axes]
            shape = [s if i in keep_axes else 1
                     for i, s in enumerate(v.shape)]
        keep = _keep(v, p, shape, key)
        if mode == "upscale_in_train":
            return torch.where(keep, v / (1.0 - p), torch.zeros_like(v))
        return torch.where(keep, v, torch.zeros_like(v))
    return apply(f, x, op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              key=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training, key=key)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              key=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training, key=key)


def alpha_dropout(x, p=0.5, training=True, name=None, key=None):
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def f(v):
        keep = _keep(v, p, v.shape, key)
        a = float(np.float32(1.0 / np.sqrt((1.0 - p)
                                           * (1.0 + p * alpha_p ** 2))))
        b = -a * alpha_p * p
        return a * torch.where(keep, v, torch.full_like(v, alpha_p)) + b
    return apply(f, x, op_name="alpha_dropout")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    from ...ops.manip import pad as _pad
    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW"):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C, H, W]`` to ``[N, C*kh*kw, L]``; ``paddings`` of 4
    are (top, left, bottom, right)."""
    ks, st = _pair(kernel_sizes), _pair(strides)
    pd, dl = _pair(paddings), _pair(dilations)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]

    def f(v):
        v = TF.pad(v, (pd[1], pd[3], pd[0], pd[2]))
        return TF.unfold(v, ks, dilation=dl, padding=0, stride=st)
    return apply(f, x, op_name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the sum of overlapping patches: ``unfold``'s adjoint."""
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, pd, dl = _pair(strides), _pair(paddings), _pair(dilations)
    return apply(lambda v: TF.fold(v, os_, ks, dilation=dl, padding=pd[:2],
                                   stride=st), x, op_name="fold")


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0.0)


def _weight_mat(in_d, out_d, kernel, device):
    """``jax.image``'s resampling weights ``[in, out]`` for scale
    ``out / in`` (antialiased when shrinking), in float64."""
    inv = in_d / out_d
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_d, dtype=torch.float64, device=device)
              + 0.5) * inv - 0.5
    xs = (sample[None, :] - torch.arange(in_d, dtype=torch.float64,
                                         device=device)[:, None]).abs()
    w = kernel(xs / kscale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_d - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(v, out_shape, mode):
    for ax, (i, o) in enumerate(zip(v.shape, out_shape)):
        if i == o:
            continue
        if mode == "nearest":
            idx = torch.floor((torch.arange(o, dtype=torch.float32)
                               + 0.5) * i / o).to(torch.int64)
            v = torch.index_select(v, ax, idx.to(v.device))
            continue
        w = _weight_mat(i, o, _keys_cubic if mode == "cubic" else _triangle,
                        v.device).to(v.dtype)
        v = torch.movedim(torch.tensordot(v, w, dims=([ax], [0])), -1, ax)
    return v


def _resize_align_corners(v, out_shape, chan_last):
    nd = v.dim()
    axes = list(range(1, nd - 1)) if chan_last else list(range(2, nd))
    out = v
    for ax in axes:
        in_d, out_d = out.shape[ax], out_shape[ax]
        if in_d == out_d:
            continue
        if out_d == 1:
            idx = torch.zeros(1, dtype=torch.float32, device=v.device)
        else:
            idx = torch.linspace(0.0, in_d - 1, out_d, device=v.device)
        i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, in_d - 1)
        i1 = torch.clamp(i0 + 1, 0, in_d - 1)
        shape = [1] * out.dim()
        shape[ax] = out_d
        w = (idx - i0).to(v.dtype).reshape(shape)
        a = torch.index_select(out, ax, i0)
        b = torch.index_select(out, ax, i1)
        out = a * (1 - w) + b * w
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    def f(v):
        chan_last = data_format in ("NHWC", "NWC", "NDHWC")
        spatial = v.shape[1:-1] if chan_last else v.shape[2:]
        if size is not None:
            from ...ops._static_shape import static_int_list
            out_spatial = static_int_list(
                size if isinstance(size, (list, tuple)) else [size],
                "interpolate size")
        else:
            sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
                else [scale_factor] * len(spatial)
            out_spatial = [int(d * s) for d, s in zip(spatial, sf)]
        if chan_last:
            out_shape = (v.shape[0], *out_spatial, v.shape[-1])
        else:
            out_shape = (v.shape[0], v.shape[1], *out_spatial)
        kind = {"nearest": "nearest", "bilinear": "linear",
                "trilinear": "linear", "linear": "linear",
                "bicubic": "cubic", "area": "linear"}[mode]
        if kind == "nearest":
            return _resize(v, out_shape, kind)
        if align_corners:
            return _resize_align_corners(v, out_shape, chan_last)
        return _resize(v.to(dtypes.to_inexact(v.dtype)), out_shape, kind)
    return apply(f, x, op_name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode=align_mode, data_format=data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = int(upscale_factor)

    def f(v):
        if data_format == "NCHW":
            return TF.pixel_shuffle(v, r)
        n, h, w, c = v.shape
        v = v.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
        return v.reshape(n, h * r, w * r, c // (r * r))
    return apply(f, x, op_name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = int(downscale_factor)

    def f(v):
        if data_format == "NCHW":
            return TF.pixel_unshuffle(v, r)
        n, h, w, c = v.shape
        v = v.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
        return v.reshape(n, h // r, w // r, c * r * r)
    return apply(f, x, op_name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW"):
    g = int(groups)

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            return v.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
                n, c, h, w)
        n, h, w, c = v.shape
        return v.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(
            n, h, w, c)
    return apply(f, x, op_name="channel_shuffle")


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def f(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp_min(na * nb, eps)
    return apply(f, x1, x2, op_name="cosine_similarity")


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return apply(lambda lab, pd: (1 - epsilon) * lab + epsilon * pd,
                     label, prior_dist, op_name="label_smooth")
    return apply(lambda lab: (1 - epsilon) * lab + epsilon / lab.shape[-1],
                 label, op_name="label_smooth")


def bilinear(x1, x2, weight, bias=None):
    def f(a, b, w, *bb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bb[0] if bb else out
    if bias is not None:
        return apply(f, x1, x2, weight, bias, op_name="bilinear")
    return apply(f, x1, x2, weight, op_name="bilinear")


def class_center_sample(label, num_classes, num_samples, group=None):
    """On the host: the labels' classes plus random others up to
    ``num_samples`` (numpy's global generator, as the JAX function),
    and the labels remapped into the sample."""
    lab = label.detach().cpu().numpy() if isinstance(label, torch.Tensor) \
        else np.asarray(label)
    dev = label.device if isinstance(label, torch.Tensor) else None
    pos = np.unique(lab)
    if pos.size >= num_samples:
        sampled = pos
    else:
        neg = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.choice(neg, num_samples - pos.size, replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (Tensor(torch.from_numpy(remap[lab]).to(dev)),
            Tensor(torch.from_numpy(sampled.astype(np.int64)).to(dev)))
