"""Losses: counterpart of ``paddle_tpu/nn/functional/loss.py``.

Each runs through ``ops.dispatch.apply`` under the JAX package's op name
(the black-listed ones in float32 under ``amp.auto_cast``), in the JAX
function's op order. ``reduction`` is ``mean``, ``sum`` or ``none``
(``kl_div`` also ``batchmean``); ``ignore_index`` rows count 0 and leave
the mean's denominator. ``ctc_loss`` is the forward algorithm in log
space over ``[T, B, C]`` log-probabilities, a loop over time.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import apply

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "ctc_loss", "square_error_cost", "sigmoid_focal_loss", "log_loss",
    "huber_loss",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None, label_smoothing=0.0):
    """Cross entropy over the class axis ``axis``: ``log_softmax`` in the
    logits' dtype, or ``log(max(input, 1e-30))`` with
    ``use_softmax=False``.

    - Hard labels (integer ids, with or without a size-1 class axis): rows
      whose label is ``ignore_index`` contribute 0; ``label_smoothing``
      mixes in the mean of -log p over the classes; ``weight`` (one per
      class) multiplies each row's loss, and ``mean`` then divides by
      ``max(sum of the valid rows' weights, 1e-12)``, else by ``max(valid
      count, 1)``.
    - ``soft_label=True``: ``-sum(label * log p)`` over the class axis, no
      row ignored and no weight; ``mean`` over the rows."""
    return apply(_cross_entropy, input, label, weight, ignore_index,
                 reduction, soft_label, axis, use_softmax, label_smoothing,
                 op_name="cross_entropy")


def _cross_entropy(input, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax, label_smoothing):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    ax = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=ax)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        loss = -torch.sum(label * logp, dim=ax)
        valid = torch.ones(loss.shape, dtype=torch.bool, device=loss.device)
    else:
        ids = label
        if ids.dim() == logp.dim() and ids.shape[ax] == 1:
            ids = ids.squeeze(ax)
        ids = ids.to(torch.int64)
        valid = ids != ignore_index
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0.0:
            smooth = -torch.mean(logp, dim=ax)
            loss = (1 - label_smoothing) * loss + label_smoothing * smooth
        if weight is not None:
            loss = loss * weight[safe]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None and not soft_label:
            ww = torch.where(valid, weight[safe], torch.zeros_like(loss))
            return loss.sum() / ww.sum().clamp_min(1e-12)
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from ...ops.manip import unsqueeze
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = unsqueeze(loss, axis)     # the class axis kept, of size 1
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    def f(p, y, *w):
        loss = -(y * torch.log(torch.clamp_min(p, 1e-12))
                 + (1 - y) * torch.log(torch.clamp_min(1 - p, 1e-12)))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(f, *args, op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The numerically stable form, in the JAX function's op order:
    ``(1 - y) z + m + log(exp(-m) + exp(-z - m))`` with ``m = max(-z,
    0)``; ``pos_weight`` scales the log term by ``(pw - 1) y + 1``;
    ``weight`` multiplies each element's loss before the reduction."""
    return apply(_bce_with_logits, logit, label, weight, reduction,
                 pos_weight, op_name="bce_with_logits")


def _bce_with_logits(logit, label, weight, reduction, pos_weight):
    z, y = logit, label
    max_val = torch.clamp_min(-z, 0.0)
    soft = torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * y + 1.0
        loss = (1 - y) * z + log_w * (soft + max_val)
    else:
        loss = (1 - y) * z + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    def f(logp, lab, *w):
        ids = lab.to(torch.int64)
        valid = ids != ignore_index
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        loss = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
        if w:
            loss = loss * w[0][safe]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        if reduction == "mean":
            denom = (torch.sum(w[0][safe] * valid) if w
                     else torch.sum(valid.to(loss.dtype)))
            return torch.sum(loss) / torch.clamp_min(denom, 1e-12)
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(f, *args, op_name="nll_loss")


def mse_loss(input, label, reduction="mean"):
    return apply(lambda a, b: _reduce(torch.square(a - b), reduction),
                 input, label, op_name="mse_loss")


def square_error_cost(input, label):
    return apply(lambda a, b: torch.square(a - b), input, label,
                 op_name="square_error_cost")


def l1_loss(input, label, reduction="mean"):
    return apply(lambda a, b: _reduce(torch.abs(a - b), reduction), input,
                 label, op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """Huber: ``0.5 d^2`` below ``delta``, ``delta (d - 0.5 delta)``
    above."""
    def f(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="smooth_l1_loss")


def huber_loss(input, label, delta=1.0, reduction="mean"):
    return smooth_l1_loss(input, label, reduction, delta)


def kl_div(input, label, reduction="mean"):
    def f(logp, y):
        loss = y * (torch.log(torch.clamp_min(y, 1e-12)) - logp)
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="kl_div")


def log_loss(input, label, epsilon=1e-4):
    return apply(lambda p, y: -y * torch.log(p + epsilon)
                 - (1 - y) * torch.log(1 - p + epsilon),
                 input, label, op_name="log_loss")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return apply(lambda a, b, y: _reduce(
        torch.clamp_min(-y * (a - b) + margin, 0.0), reduction),
        input, other, label, op_name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return apply(lambda a, y: _reduce(torch.where(
        y == 1, a, torch.clamp_min(margin - a, 0.0)), reduction),
        input, label, op_name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    def f(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1),
            1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
        return _reduce(loss, reduction)
    return apply(f, input1, input2, label, op_name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def f(a, pos, neg):
        dp = torch.sum(torch.abs(a - pos) ** p, -1) ** (1 / p)
        dn = torch.sum(torch.abs(a - neg) ** p, -1) ** (1 / p)
        if swap:
            dn = torch.minimum(dn, torch.sum(torch.abs(pos - neg) ** p, -1)
                               ** (1 / p))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)
    return apply(f, input, positive, negative, op_name="triplet_margin_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    def f(z, y, *nrm):
        p = torch.sigmoid(z)
        ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if nrm:
            loss = loss / nrm[0]
        return _reduce(loss, reduction)
    args = [logit, label] + ([normalizer] if normalizer is not None else [])
    return apply(f, *args, op_name="sigmoid_focal_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space: ``log_probs`` ``[T, B,
    C]`` (Paddle's layout), ``labels`` ``[B, S]``; ``mean`` divides each
    sequence's loss by its label length (at least 1) and averages."""
    def f(lp, lab, in_len, lab_len):
        T, B, _ = lp.shape
        S = lab.shape[1]
        dev = lp.device
        rows = torch.arange(B, device=dev)
        ext = torch.full((B, 2 * S + 1), blank, dtype=torch.int64,
                         device=dev)
        ext[:, 1::2] = lab.to(torch.int64)
        ext_len = 2 * lab_len.to(torch.int64) + 1
        neg_inf = torch.full((), -1e30, dtype=lp.dtype, device=dev)
        alpha = torch.full((B, 2 * S + 1), -1e30, dtype=lp.dtype,
                           device=dev)
        alpha = torch.cat([lp[0, rows, blank][:, None],
                           torch.where(lab_len > 0, lp[0, rows, ext[:, 1]],
                                       neg_inf)[:, None],
                           alpha[:, 2:]], dim=1)
        same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                           ext[:, 2:] == ext[:, :-2]], dim=1)
        pad1 = neg_inf.expand(B, 1)
        pad2 = neg_inf.expand(B, 2)
        for t in range(1, T):
            s1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
            s2 = torch.where(same2, neg_inf,
                             torch.cat([pad2, alpha[:, :-2]], dim=1))
            merged = torch.logaddexp(torch.logaddexp(alpha, s1), s2)
            new = merged + torch.gather(lp[t], 1, ext)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
        prev = torch.gather(alpha, 1,
                            torch.clamp_min(ext_len - 2, 0)[:, None])[:, 0]
        loss = -torch.logaddexp(last, prev)
        if reduction == "mean":
            return torch.mean(loss / torch.clamp_min(
                lab_len.to(loss.dtype), 1.0))
        return _reduce(loss, reduction)
    return apply(f, log_probs, labels, input_lengths, label_lengths,
                 op_name="ctc_loss")
