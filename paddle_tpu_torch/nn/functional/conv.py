"""Convolutions: counterpart of ``paddle_tpu/nn/functional/conv.py``.

The JAX functions call ``lax.conv_general_dilated``; these call torch's
convolutions (cuDNN on the card). Paddle's layouts and padding rules are
kept:

- Weights are ``[out, in/groups, *k]``; a transposed convolution takes
  ``[in, out/groups, *k]`` and computes the gradient of a convolution, as
  ``conv_transpose`` does.
- ``padding`` is an int, ``n`` ints (symmetric), ``2n`` ints
  (``[lo0, hi0, lo1, hi1, ...]``) or ``"SAME"`` / ``"VALID"``. ``"SAME"``
  follows XLA's rule for any stride: ``out = ceil(in / s)``, the total
  pad split with ``total // 2`` low (torch's ``"same"`` refuses a stride
  above 1). Asymmetric pads go through ``F.pad``.
- Channel-last formats (``NLC``, ``NHWC``, ``NDHWC``) run as a
  channel-first view and come back; the bias goes on the channel axis.
- A transposed convolution's ``"SAME"`` pad is ``d (k - 1) // 2`` on both
  sides; ``output_size`` fixes the output padding, with the JAX message
  when it is out of reach. ``groups > 1`` raises ``ValueError``, as the
  JAX function does (it passes the ``[in, out/groups, k]`` weight to
  ``feature_group_count``, which refuses it): a reference caveat, kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _padding(padding, n):
    """``[(lo, hi)] * n``, or ``"SAME"`` / ``"VALID"``."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(spatial, k, st, dil):
    """XLA's ``"SAME"``: ``out = ceil(in / s)``, ``total // 2`` low."""
    pads = []
    for i, size in enumerate(spatial):
        out = -(-size // st[i])
        eff_k = dil[i] * (k[i] - 1) + 1
        total = max((out - 1) * st[i] + eff_k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """``F.pad``'s list (last dim first) of per-dim ``(lo, hi)``."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _to_channel_first(v, channel_last):
    return v.movedim(-1, 1) if channel_last else v


def _from_channel_first(v, channel_last):
    return v.movedim(1, -1) if channel_last else v


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          channel_last, name):
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    pad = _padding(padding, n)
    conv = getattr(TF, f"conv{n}d")

    def f(v, w, *b):
        v = _to_channel_first(v, channel_last)
        k = w.shape[2:]
        if pad == "VALID":
            pads = [(0, 0)] * n
        elif pad == "SAME":
            pads = _same_pads(v.shape[2:], k, strides, dil)
        else:
            pads = pad
        if all(lo == hi for lo, hi in pads):
            sym = [lo for lo, _ in pads]
        else:
            v = TF.pad(v, _torch_pad(pads))
            sym = [0] * n
        out = conv(v, w, b[0] if b else None, strides, sym, dil, groups)
        return _from_channel_first(out, channel_last)
    if bias is not None:
        return apply(f, x, weight, bias, op_name=name)
    return apply(f, x, weight, op_name=name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format in ("NLC",), "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format == "NDHWC", "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, channel_last, name,
                    output_size=None):
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    opad = _tuple(output_padding, n)
    osize = _tuple(output_size, n) if output_size is not None else None
    conv_t = getattr(TF, f"conv_transpose{n}d")

    def f(v, w, *b):
        if groups != 1:
            raise ValueError(
                f"{name}: groups={groups} is refused, as the reference "
                f"refuses it (its [in, out/groups, *k] weight does not "
                f"meet feature_group_count)")
        v = _to_channel_first(v, channel_last)
        k = w.shape[2:]
        if isinstance(padding, str) and padding.upper() == "SAME":
            p = [((dil[i] * (k[i] - 1)) // 2,) * 2 for i in range(n)]
        elif isinstance(padding, str):      # VALID
            p = [(0, 0)] * n
        else:
            p = _padding(padding, n)
        eff_opad = list(opad)
        if osize is not None:
            # output_size picks among the stride-ambiguous sizes by fixing
            # the output padding:
            # out = (in-1)*s - (p_lo+p_hi) + d*(k-1) + 1 + output_padding
            in_sp = v.shape[2:]
            for i in range(n):
                base = ((in_sp[i] - 1) * strides[i] - p[i][0] - p[i][1]
                        + dil[i] * (k[i] - 1) + 1)
                extra = osize[i] - base
                if not 0 <= extra < max(strides[i], 1):
                    raise ValueError(
                        f"{name}: output_size[{i}]={osize[i]} unreachable "
                        f"(valid range [{base}, {base + strides[i] - 1}])")
                eff_opad[i] = extra
        bias_t = b[0] if b else None
        if all(lo == hi and eff_opad[i] < max(strides[i], dil[i])
               for i, (lo, hi) in enumerate(p)):
            out = conv_t(v, w, bias_t, strides, [lo for lo, _ in p],
                         eff_opad, 1, dil)
        else:
            # the full transposed convolution, then each dim cropped by its
            # pads and extended by its output padding (zeros, then bias)
            out = conv_t(v, w, None, strides, 0, 0, 1, dil)
            out = TF.pad(out, _torch_pad([(-lo, -hi + eff_opad[i])
                                          for i, (lo, hi) in enumerate(p)]))
            if bias_t is not None:
                out = torch.add(out, bias_t.reshape([-1] + [1] * n))
        return _from_channel_first(out, channel_last)
    if bias is not None:
        return apply(f, x, weight, bias, op_name=name)
    return apply(f, x, weight, op_name=name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding,
                           output_padding, dilation, groups, 1,
                           data_format == "NLC",
                           "conv1d_transpose", output_size=output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding,
                           output_padding, dilation, groups, 2,
                           data_format == "NHWC",
                           "conv2d_transpose", output_size=output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding,
                           output_padding, dilation, groups, 3,
                           data_format == "NDHWC",
                           "conv3d_transpose", output_size=output_size)
