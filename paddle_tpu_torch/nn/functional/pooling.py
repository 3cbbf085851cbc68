"""Pooling: counterpart of ``paddle_tpu/nn/functional/pooling.py``.

The JAX functions reduce windows with ``lax.reduce_window``; these pad
explicitly and call torch's pools (cuDNN on the card), so the JAX
semantics hold where torch's own options differ:

- ``ceil_mode`` extends the right pad until floor-mode windows give the
  ceil-mode count (``_ceil_adjust``), as the JAX function does; torch's
  ``ceil_mode`` would drop a last window that starts in the padding
  (``L=5, k=2, s=2, p=1``: 4 windows here and in the JAX package, 3 in
  torch's). Such a window lies wholly in padding: max gives ``-inf``,
  exclusive avg ``nan`` (0 / 0), as in the JAX package.
- Max pads with ``-inf`` (integers: ``iinfo.min``); avg sums the
  zero-padded windows (torch's pool with ``divisor_override=1``) and
  divides by the window size, or, ``exclusive``, by the count of real
  cells. ``divisor_override`` is accepted and ignored, as there.
- ``return_mask`` gives int32 flat indices within each (N, C) plane: the
  first maximum of the window's real cells (a padded cell is never
  chosen unless the window holds no other). Channel-last raises.
- Adaptive bins run from ``floor(i in / out)`` to ``ceil((i + 1) in /
  out)``, reduced one spatial dim at a time as the JAX function does;
  ``return_mask`` of the adaptive max pools is accepted and ignored,
  as there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply
from .conv import _padding as _pad_cfg
from .conv import _same_pads, _torch_pad, _tuple

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]


def _ceil_adjust(pad, spatial, ks, st):
    """Extend the right pads so floor-mode windows give the ceil-mode
    output sizes (the reference's ``ceil_mode=True``)."""
    out = []
    for d in range(len(ks)):
        lo, hi = pad[d]
        L = spatial[d] + lo + hi
        ceil_n = -(-(L - ks[d]) // st[d]) + 1
        floor_n = (L - ks[d]) // st[d] + 1
        if ceil_n > floor_n:
            hi += (ceil_n - 1) * st[d] + ks[d] - L
        out.append((lo, hi))
    return out


def _window_pads(pad, spatial, ks, st, ceil_mode):
    """Per-dim ``(lo, hi)``: XLA's ``"SAME"`` / ``"VALID"`` for a string
    (no ceil adjustment, as ``reduce_window`` takes the string as is),
    else the pads, ceil-adjusted when asked."""
    if pad == "VALID":
        return [(0, 0)] * len(ks)
    if pad == "SAME":
        return _same_pads(spatial, ks, st, (1,) * len(ks))
    return _ceil_adjust(pad, spatial, ks, st) if ceil_mode else list(pad)


def _lowest(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return int(torch.iinfo(dtype).min)


def _windows(v, ks, st):
    """``[N, C, *out, prod(ks)]``: every window's cells, the window dims
    flattened in row-major order."""
    n = len(ks)
    for d in range(n):
        v = v.unfold(2 + d, ks[d], st[d])
    return v.reshape(*v.shape[:2 + n], -1)


def _max(v, ks, st, pads):
    n = len(ks)
    v = TF.pad(v, _torch_pad(pads), value=_lowest(v.dtype))
    if v.is_floating_point():
        return getattr(TF, f"max_pool{n}d")(v, ks, st)
    return torch.amax(_windows(v, ks, st), dim=-1)


def _window_sum(v, ks, st):
    """Each window's sum (torch's avg pool with divisor 1; 1-D through the
    2-D pool)."""
    if len(ks) == 1:
        return TF.avg_pool2d(v[..., None], (ks[0], 1), (st[0], 1),
                             divisor_override=1)[..., 0]
    return getattr(TF, f"avg_pool{len(ks)}d")(v, ks, st, divisor_override=1)


def _avg(v, ks, st, pads, count_real):
    summed = _window_sum(TF.pad(v, _torch_pad(pads)), ks, st)
    if not count_real:
        return torch.div(summed, float(np.prod(ks)))
    ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                      device=v.device)
    counts = _window_sum(TF.pad(ones, _torch_pad(pads)), ks, st)
    return torch.div(summed, counts)


def _pool(x, kernel, stride, padding, n, channel_last, reducer, name,
          ceil_mode=False, count_include_pad=True, exclusive=None):
    ks = _tuple(kernel, n)
    st = _tuple(stride if stride is not None else kernel, n)
    pad = _pad_cfg(padding, n)

    def f(v):
        if channel_last:
            v = v.movedim(-1, 1)
        pads = _window_pads(pad, v.shape[2:], ks, st, ceil_mode)
        if reducer == "max":
            out = _max(v, ks, st, pads)
        else:
            out = _avg(v, ks, st, pads,
                       not count_include_pad or exclusive is True)
        return out.movedim(1, -1) if channel_last else out
    return apply(f, x, op_name=name)


def _max_pool_with_mask(x, kernel, stride, padding, n, name,
                        ceil_mode=False):
    """Max pool with the flat within-(N, C)-plane index of each window's
    maximum: the mask ``max_unpoolNd`` consumes."""
    ks = _tuple(kernel, n)
    st = _tuple(stride if stride is not None else kernel, n)
    pad = _pad_cfg(padding, n)

    def f(v):
        spatial = v.shape[2:]
        eff = _ceil_adjust(pad, spatial, ks, st) if ceil_mode else list(pad)
        neg = _lowest(v.dtype)
        win = _windows(TF.pad(v, _torch_pad(eff), value=neg), ks, st)
        out_sp = win.shape[2:2 + n]
        kprod = int(np.prod(ks))
        # each window slot's input coordinate, and whether it is a real
        # cell (a padded one must never win, even where its value ties)
        coords = np.stack(np.unravel_index(np.arange(kprod), ks), 0)
        valid = torch.ones(*out_sp, kprod, dtype=torch.bool, device=v.device)
        flat = torch.zeros(*out_sp, kprod, dtype=torch.int64, device=v.device)
        mult = 1
        for d in range(n - 1, -1, -1):
            starts = torch.arange(out_sp[d], device=v.device) * st[d] \
                - pad[d][0]
            idx = starts[:, None] + torch.as_tensor(
                coords[d], device=v.device)[None, :]     # (out_d, kprod)
            shape = [1] * n + [kprod]
            shape[d] = out_sp[d]
            idx = idx.reshape(shape)
            valid = valid & (idx >= 0) & (idx < spatial[d])
            flat = flat + idx * mult
            mult *= spatial[d]
        win = torch.where(valid, win, torch.full((), neg, dtype=v.dtype,
                                                 device=v.device))
        am = torch.argmax(win, dim=-1, keepdim=True)
        vals = torch.gather(win, -1, am)[..., 0]
        index = torch.gather(flat.expand(win.shape), -1, am)[..., 0]
        return vals, index.to(torch.int32)
    return apply(f, x, op_name=name)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None, data_format="NCL"):
    return _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                 "avg", "avg_pool1d", ceil_mode, not exclusive, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                 "avg", "avg_pool2d", ceil_mode, not exclusive, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3, data_format == "NDHWC",
                 "avg", "avg_pool3d", ceil_mode, not exclusive, exclusive)


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, n, last):
    name = f"max_pool{n}d"
    if return_mask:
        if data_format == last:
            raise NotImplementedError("return_mask requires channel-first")
        return _max_pool_with_mask(x, kernel_size, stride, padding, n, name,
                                   ceil_mode)
    return _pool(x, kernel_size, stride, padding, n, data_format == last,
                 "max", name, ceil_mode)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None, data_format="NCL"):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 1, "NLC")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 2, "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 3, "NDHWC")


def _adaptive(x, output_size, n, channel_last, mode, name):
    os_ = output_size if isinstance(output_size, (list, tuple)) \
        else (output_size,) * n

    def f(v):
        off = 1 if channel_last else 2
        out = v
        for d in range(n):
            ax = off + d
            in_d, out_d = out.shape[ax], os_[d]
            if out_d is None or in_d == out_d:
                continue
            out_d = int(out_d)
            starts = (np.arange(out_d) * in_d) // out_d
            ends = ((np.arange(out_d) + 1) * in_d + out_d - 1) // out_d
            pieces = []
            for s, e in zip(starts, ends):
                seg = out.narrow(ax, int(s), int(e - s))
                pieces.append(torch.amax(seg, ax, keepdim=True)
                              if mode == "max"
                              else torch.mean(seg, ax, keepdim=True))
            out = torch.cat(pieces, ax) if len(pieces) > 1 else pieces[0]
        return out
    return apply(f, x, op_name=name)


def adaptive_avg_pool1d(x, output_size, name=None, data_format="NCL"):
    return _adaptive(x, output_size, 1, data_format == "NLC", "avg",
                     "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive(x, output_size, 2, data_format == "NHWC", "avg",
                     "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive(x, output_size, 3, data_format == "NDHWC", "avg",
                     "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None,
                        data_format="NCL"):
    return _adaptive(x, output_size, 1, data_format == "NLC", "max",
                     "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None,
                        data_format="NCHW"):
    return _adaptive(x, output_size, 2, data_format == "NHWC", "max",
                     "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None,
                        data_format="NCDHW"):
    return _adaptive(x, output_size, 3, data_format == "NDHWC", "max",
                     "adaptive_max_pool3d")
