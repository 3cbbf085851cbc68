"""The port's ``cross_entropy`` options against
``paddle_tpu.nn.functional.cross_entropy`` (loss.py:27-67) on the CPU, in
fp32 at rtol 1e-6 / atol 1e-6 (both take log_softmax and the same sums):
class weights (with the weighted mean's denominator and ignored rows),
soft labels, label smoothing, the class axis at 1, ``use_softmax=False``
(``log(max(p, 1e-30))``, zeros included) and their mixes, each with every
reduction; and the grads of the weighted, smoothed loss.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.nn.functional import cross_entropy as jax_ce
from paddle_tpu_torch.nn.functional import cross_entropy

C = 7


def _inputs(axis, seed=0):
    r = np.random.RandomState(seed)
    logits = r.randn(3, 5, C).astype(np.float32)
    labels = r.randint(0, C, (3, 5))
    labels[0, 1] = labels[2, 4] = -100
    soft = r.rand(3, 5, C).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[1, 2, 3] = 0.0                      # log(max(0, 1e-30))
    weight = (0.5 + r.rand(C)).astype(np.float32)
    if axis == 1:           # classes along axis 1: [3, C, 5]
        logits, soft, probs = (np.moveaxis(a, -1, 1).copy()
                               for a in (logits, soft, probs))
    return logits, labels, soft, probs, weight


CASES = {
    "weight": dict(weight=True),
    "weight_smoothing": dict(weight=True, label_smoothing=0.2),
    "soft_label": dict(soft_label=True),
    "smoothing": dict(label_smoothing=0.1),
    "axis1": dict(axis=1),
    "axis1_weight_smoothing": dict(axis=1, weight=True, label_smoothing=0.3),
    "axis1_soft_label": dict(axis=1, soft_label=True),
    "no_softmax": dict(use_softmax=False),
    "no_softmax_soft_label": dict(use_softmax=False, soft_label=True),
    "no_softmax_weight": dict(use_softmax=False, weight=True),
    "label_with_class_dim": dict(label_dim=True),
}


def _call(fn, to, case, reduction):
    c = dict(case)
    axis = c.pop("axis", -1)
    logits, labels, soft, probs, weight = _inputs(axis)
    x = probs if c.get("use_softmax") is False else logits
    lab = soft if c.get("soft_label") else labels
    if c.pop("label_dim", False):
        lab = labels[..., None]
    if c.pop("weight", False):
        c["weight"] = to(weight)
    return fn(to(x), to(lab), reduction=reduction, axis=axis, **c)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cross_entropy_option_matches_jax(name, reduction):
    want = np.asarray(_call(jax_ce, P.to_tensor, CASES[name],
                            reduction).numpy())
    got = _call(cross_entropy, torch.from_numpy, CASES[name],
                reduction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_weighted_smoothed_loss_grads_match_jax():
    logits, labels, _, _, weight = _inputs(-1, seed=1)
    jx = P.to_tensor(logits)
    jx.stop_gradient = False
    jax_ce(jx, P.to_tensor(labels), weight=P.to_tensor(weight),
           label_smoothing=0.2).backward()
    tx = torch.from_numpy(logits).requires_grad_()
    cross_entropy(tx, torch.from_numpy(labels),
                  weight=torch.from_numpy(weight),
                  label_smoothing=0.2).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-7)
    assert np.all(tx.grad.numpy()[0, 1] == 0.0)     # the ignored row
