"""ASP, automatic structured (2:4) pruning: counterpart of
``paddle_tpu/incubate/asp.py`` (``calculate_density``, ``create_mask``,
``check_sparsity``, ``prune_model``, ``decorate``, the excluded layers).

Masks are computed on the host in numpy: in every group of 4 weights
along the flattened tensor the 2 of largest magnitude are kept.
``prune_model`` zeroes the rest of every prunable weight (2-D, named
``*weight``, first dimension a multiple of 4, not excluded) and keeps
its mask; ``decorate`` re-applies the masks after each optimizer step.
Dense products stay dense: the masks keep the matmul shapes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..utils.memo import LockedLRU

__all__ = ["calculate_density", "create_mask", "check_sparsity",
           "set_excluded_layers", "reset_excluded_layers", "prune_model",
           "decorate"]

_EXCLUDED: set = set()
# the mask registry, keyed by parameter identity
_MASKS: LockedLRU = LockedLRU(maxsize=None)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def calculate_density(x) -> float:
    a = _np(x)
    return float(np.count_nonzero(a)) / max(a.size, 1)


def _best_2in4_mask_1d(w: np.ndarray) -> np.ndarray:
    """In each group of 4, the 2 largest |w|."""
    pad = (-w.size) % 4
    flat = np.concatenate([w.ravel(), np.zeros(pad, w.dtype)])
    groups = flat.reshape(-1, 4)
    order = np.argsort(-np.abs(groups), axis=1)
    mask = np.zeros_like(groups, dtype=bool)
    rows = np.arange(groups.shape[0])[:, None]
    mask[rows, order[:, :2]] = True
    return mask.ravel()[:w.size].reshape(w.shape)


def create_mask(tensor, func_name: str = "get_mask_2d_best", n: int = 2,
                m: int = 4):
    """The 2:4 mask of ``tensor`` (the three mask functions give the 1-D
    best mask, as in the JAX package), in its dtype and on its device."""
    if func_name not in ("get_mask_1d", "get_mask_2d_best",
                         "get_mask_2d_greedy"):
        raise ValueError(f"unknown mask func {func_name!r}")
    mask = _best_2in4_mask_1d(_np(tensor))
    if isinstance(tensor, torch.Tensor):
        return Tensor(torch.from_numpy(mask).to(device=tensor.device,
                                                dtype=tensor.dtype))
    return Tensor(mask.astype(np.asarray(tensor).dtype))


def check_sparsity(tensor, n: int = 2, m: int = 4, func_name="check_mask_1d"):
    """Whether every group of ``m`` holds at most ``n`` non-zeros."""
    w = _np(tensor)
    pad = (-w.size) % m
    groups = np.concatenate([w.ravel(), np.zeros(pad, w.dtype)]).reshape(
        -1, m)
    return bool(np.all(np.count_nonzero(groups, axis=1) <= n))


def _prunable(name: str, p) -> bool:
    return (p.ndim == 2 and name.endswith("weight")
            and id(p) not in _EXCLUDED and p.shape[0] % 4 == 0)


def set_excluded_layers(model, layer_names):
    for name, sub in model.named_sublayers(include_self=True):
        if name in layer_names:
            for _, p in sub.named_parameters(include_sublayers=False):
                _EXCLUDED.add(id(p))


def reset_excluded_layers(model=None):
    _EXCLUDED.clear()


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Zero all but the 2 largest of every 4 weights of each prunable
    parameter; returns ``{name: mask}``."""
    masks = {}
    for name, p in model.named_parameters():
        if not _prunable(name, p):
            continue
        mask = create_mask(p, n=n, m=m)
        with torch.no_grad():
            p.mul_(mask)
        masks[name] = mask
        _MASKS.put(id(p), mask)
    return masks


def decorate(optimizer):
    """Wrap ``optimizer.step`` so that each step ends by re-applying the
    masks of ``prune_model`` (training stays inside the 2:4 support)."""
    inner_step = optimizer.step

    def step(*a, **k):
        out = inner_step(*a, **k)
        with torch.no_grad():
            for p in getattr(optimizer, "_params", None) or []:
                mask = _MASKS.get(id(p))
                if mask is not None:
                    p.mul_(mask)
        return out

    optimizer.step = step
    return optimizer
