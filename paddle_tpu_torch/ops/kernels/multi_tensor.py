"""Multi-tensor optimizer kernels U1 and U2: their wrappers and plain
PyTorch versions.

Neither is the port of a Pallas kernel. The JAX package runs every
parameter's update rule in one jitted program with donated buffers
(``paddle_tpu/optimizer/optimizer.py:81-97``), and its train steps fuse the
global-norm clip, the grad-finite flag and the update into the step
(``paddle_tpu/models/llama.py:886-913``,
``paddle_tpu/parallel/trainer.py:329-373``): XLA writes that fused code.
The port writes it by hand in ``paddle_tpu_torch/csrc/multi_tensor.cu``,
since no PyTorch call computes the reference's rule
(``torch.optim.AdamW(fused=True)`` folds ``lr / bc1`` and decays before the
moments, so it rounds otherwise):

- ``multi_tensor_sumsq_finite`` (U1): over a list of grads, each optionally
  times ``inv_scale`` rounded to its dtype, the fp32 sum of squares of each
  tensor, their sum in list order, and one int32 flag for whether every
  element is finite. Deterministic: the same grads give the same bits on
  every run (per-CTA partials, then a fixed-order final stage; no float
  atomics).
- ``multi_tensor_adam`` (U2): the Adam / AdamW rule
  (``paddle_tpu/optimizer/optimizers.py:63-76``) over lists p, g, m, v,
  in place, after multiplying the grads by the optional device scalars
  ``inv_scale`` and then ``clip_scale``; under a device ``finite`` flag of
  0 it writes nothing. The learning rate and the step count are 0-dim
  device tensors (fp32 and int32; a Python number is written into one),
  and the bias corrections are taken from the step on the device, so a
  CUDA graph that holds the update reads the values of each replay. Every
  op rounds as the plain rule's, so on the card U2 equals
  ``multi_tensor_adam_ref`` bit for bit.

Each wrapper takes its plain version (``*_ref``) for tensors on the CPU,
and launches its kernel for tensors on the card, or raises: there is no
fallback from the card to the plain version. A launch takes its tensors'
pointers in its parameters (up to 128 grads for U1, 80 tensors of one
dtype for U2; longer lists take several launches), syncs nothing and
copies nothing to the card, so it can be captured in a CUDA graph.
``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .flash_attention import _DTYPE_CODE, _device_gate, _launch

__all__ = ["AdamScalars", "adam_scalars", "adam_rule", "round_to_dtype",
           "device_scalar", "multi_tensor_sumsq_finite",
           "multi_tensor_sumsq_finite_ref", "multi_tensor_adam",
           "multi_tensor_adam_ref"]

# Tensors per launch: the tables in multi_tensor.cu (kSumsqMax, kAdamMax).
SUMSQ_MAX, ADAM_MAX = 128, 80


def round_to_dtype(x, dtype: torch.dtype) -> float:
    """The scalar x rounded to float32 and then to dtype (round to
    nearest even), as a Python float: how the JAX rule's weakly typed
    scalars enter an op in the parameter's dtype. Host arithmetic only (no
    tensor: a captured step's guard would take a tensor's read for a host
    sync)."""
    f = np.float32(x)
    if dtype == torch.float32 or np.isnan(f):
        return float(f)
    if dtype == torch.float16:
        with np.errstate(over="ignore"):
            return float(np.float16(f))
    if dtype == torch.bfloat16:
        b = int(np.array(f).view(np.uint32))
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        return float(np.array(b, dtype=np.uint32).view(np.float32))
    return float(torch.tensor(float(f), dtype=torch.float32).to(dtype))


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``dtype`` on ``device``: a tensor is cast
    and moved (no copy when it is one already), a Python number is written
    by a fill on the device (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def pow_from_step(beta, t: torch.Tensor) -> torch.Tensor:
    """``beta ** t`` in float32 on t's device (t a float32 0-dim tensor):
    the JAX rule's weakly typed beta to the float32 step."""
    return torch.pow(torch.full((), float(np.float32(beta)),
                                dtype=torch.float32, device=t.device), t)


class AdamScalars(NamedTuple):
    """The rule's scalars, each rounded to the parameters' dtype: the
    constants as Python floats, the step's ``lr``, ``bc1`` and ``bc2`` as
    0-dim tensors on the step's device."""
    lr: torch.Tensor
    b1: float
    omb1: float        # 1 - beta1, taken in double, then rounded
    b2: float
    omb2: float
    bc1: torch.Tensor  # 1 - beta1 ** step, in float32
    bc2: torch.Tensor
    eps: float
    wd: float
    decoupled: bool


def adam_scalars(dtype: torch.dtype, lr, beta1, beta2, epsilon,
                 weight_decay, step, decoupled,
                 device=None) -> AdamScalars:
    """The scalars of one step of the rule for parameters of dtype, each
    as the op in dtype sees it. ``lr`` and ``step`` are 0-dim tensors (or
    numbers, written into such on ``device``, default theirs or the CPU),
    and the bias corrections are float32 ``torch.pow`` on their device:
    no host read, so a captured step reads each replay's values."""
    def r(x):
        return round_to_dtype(x, dtype)
    if device is None:
        device = next((x.device for x in (lr, step)
                       if isinstance(x, torch.Tensor)), "cpu")
    t = device_scalar(step, torch.int32, device).to(torch.float32)
    return AdamScalars(
        device_scalar(lr, torch.float32, device).to(dtype), r(beta1),
        r(1 - beta1), r(beta2), r(1 - beta2),
        (1 - pow_from_step(beta1, t)).to(dtype),
        (1 - pow_from_step(beta2, t)).to(dtype), r(epsilon),
        r(weight_decay or 0.0), bool(decoupled))


def adam_rule(p, g, m, v, sc: AdamScalars, inv_scale=None, clip_scale=None):
    """One application of the rule to one tensor, out of place: the new
    ``(p, m, v)``; g in p's dtype. The op order of optimizers.py:63-76,
    after ``g * inv_scale`` and then ``g * clip_scale``, each scalar
    rounded to g's dtype (trainer.py:325, 356)."""
    if inv_scale is not None:
        g = g * inv_scale.to(g.dtype)
    if clip_scale is not None:
        g = g * clip_scale.to(g.dtype)
    if sc.wd and not sc.decoupled:
        g = g + sc.wd * p
    m = sc.b1 * m + sc.omb1 * g
    v = sc.b2 * v + sc.omb2 * torch.square(g)
    # the bias corrections are 0-dim tensors of the dtype on the device:
    # each division is rounded once (PyTorch divides a CUDA tensor by a
    # Python scalar as a multiply by its reciprocal, an ulp off at times)
    upd = (m / sc.bc1) / (torch.sqrt(v / sc.bc2) + sc.eps)
    if sc.wd and sc.decoupled:
        upd = upd + sc.wd * p
    return p - sc.lr * upd, m, v


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def multi_tensor_sumsq_finite_ref(grads: Sequence[torch.Tensor],
                                  inv_scale: Optional[torch.Tensor] = None):
    """Plain U1: ``(sumsq fp32 [n], total fp32 [], finite int32 [])``, the
    total added in list order from 0."""
    if not grads:
        raise ValueError("multi_tensor_sumsq_finite needs a tensor")
    dev = grads[0].device
    ok = torch.ones((), dtype=torch.bool, device=dev)
    sums = []
    for g in grads:
        x = g if inv_scale is None else g * inv_scale.to(g.dtype)
        ok = ok & torch.isfinite(x).all()
        sums.append(torch.sum(torch.square(x.float())))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in sums:
        total = total + s
    return torch.stack(sums), total, ok.to(torch.int32)


def multi_tensor_adam_ref(params, grads, exp_avgs, exp_avg_sqs, *, lr, beta1,
                          beta2, epsilon, weight_decay, decoupled, step,
                          inv_scale=None, clip_scale=None, finite=None):
    """Plain U2: ``adam_rule`` per tensor, written into p, m and v in place;
    with ``finite`` 0 every tensor keeps its value. ``lr`` and ``step``
    are read from 0-dim tensors on the parameters' device (numbers are
    written into such)."""
    keep = None if finite is None else finite.bool()
    if params:
        lr = device_scalar(lr, torch.float32, params[0].device)
        step = device_scalar(step, torch.int32, params[0].device)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
            sc = adam_scalars(p.dtype, lr, beta1, beta2, epsilon,
                              weight_decay, step, decoupled)
            new = adam_rule(p, g.to(p.dtype), m, v, sc, inv_scale,
                            clip_scale)
            for dst, val in zip((p, m, v), new):
                dst.copy_(val if keep is None else torch.where(keep, val,
                                                               dst))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _scalar_ptr(t, dev, dtype, name) -> Optional[int]:
    if t is None:
        return None
    if t.device != dev or t.dtype != dtype or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element {dtype} tensor on "
                        f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}")
    return t.data_ptr()


def _array(ctype, values):
    return (ctype * max(len(values), 1))(*values)


def multi_tensor_sumsq_finite(grads: Sequence[torch.Tensor],
                              inv_scale: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(sumsq fp32 [n], total fp32 [], finite int32 [])`` over grads (fp32,
    bf16 or fp16, any mix), each first times ``inv_scale`` (a one-element
    fp32 tensor) rounded to its dtype when given. CPU tensors take the plain
    version; CUDA tensors launch U1 (once per 128 grads) or raise."""
    grads = list(grads)
    if not grads:
        raise ValueError("multi_tensor_sumsq_finite needs a tensor")
    if _device_gate(grads[0], "multi-tensor sum of squares"):
        return multi_tensor_sumsq_finite_ref(grads, inv_scale)
    dev = grads[0].device
    for i, g in enumerate(grads):
        if g.device != dev:
            raise ValueError(f"grad {i} is on {g.device}, grad 0 on {dev}")
        if g.dtype not in _DTYPE_CODE:
            raise TypeError(f"kernel takes float32/float16/bfloat16, got "
                            f"{g.dtype} (grad {i})")
    inv = _scalar_ptr(inv_scale, dev, torch.float32, "inv_scale")
    grads = [g.contiguous() for g in grads]
    sumsq = torch.empty(len(grads), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.int32, device=dev)
    from ._build import library
    lib = library()
    for base in range(0, len(grads), SUMSQ_MAX):
        part = grads[base:base + SUMSQ_MAX]
        n = _array(ctypes.c_longlong, [g.numel() for g in part])
        nbytes = lib.pt_multi_tensor_sumsq_workspace(n, len(part))
        if nbytes < 0:
            raise ValueError("multi_tensor_sumsq_finite: tensors too large "
                             "for one launch")
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        _launch("pt_multi_tensor_sumsq_finite", grads[0],
                _array(ctypes.c_void_p, [g.data_ptr() for g in part]), n,
                _array(ctypes.c_int, [_DTYPE_CODE[g.dtype] for g in part]),
                len(part), inv, sumsq.data_ptr() + 4 * base,
                total.data_ptr(), finite.data_ptr(), int(base == 0),
                work.data_ptr(), nbytes)
        multi_tensor_sumsq_finite.launches += 1
    return sumsq, total, finite


def multi_tensor_adam(params: List[torch.Tensor], grads, exp_avgs,
                      exp_avg_sqs, *, lr, beta1, beta2, epsilon, weight_decay,
                      decoupled, step, inv_scale=None, clip_scale=None,
                      finite=None) -> None:
    """The Adam (``decoupled=False``) or AdamW rule over every parameter, in
    place, for step ``step`` (counted from 1). ``lr`` and ``step`` are
    0-dim tensors (or numbers, written into such on the device) that the
    launch reads on the card. p, m and v are contiguous and
    of one shape and dtype per parameter; a grad of another dtype is cast
    to its parameter's. ``inv_scale`` and ``clip_scale`` are one-element
    fp32 tensors and ``finite`` a one-element int32 tensor, all on the
    parameters' device. CPU tensors take the plain version; CUDA tensors
    launch U2 (once per dtype and 80 parameters) or raise."""
    params = list(params)
    if not params:
        return
    if not len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs):
        raise ValueError("params, grads and moments differ in length")
    if _device_gate(params[0], "multi-tensor Adam"):
        return multi_tensor_adam_ref(
            params, grads, exp_avgs, exp_avg_sqs, lr=lr, beta1=beta1,
            beta2=beta2, epsilon=epsilon, weight_decay=weight_decay,
            decoupled=decoupled, step=step, inv_scale=inv_scale,
            clip_scale=clip_scale, finite=finite)
    dev = params[0].device
    groups = {}
    for i, (p, g, m, v) in enumerate(zip(params, grads, exp_avgs,
                                         exp_avg_sqs)):
        for name, t in (("grad", g), ("moment1", m), ("moment2", v)):
            if t.device != dev or p.device != dev:
                raise ValueError(f"parameter {i}: its {name} or itself is "
                                 f"not on {dev}")
            if t.shape != p.shape:
                raise ValueError(f"parameter {i}: {name} shape "
                                 f"{tuple(t.shape)} != {tuple(p.shape)}")
        if p.dtype not in _DTYPE_CODE:
            raise TypeError(f"kernel takes float32/float16/bfloat16, got "
                            f"{p.dtype} (parameter {i})")
        if m.dtype != p.dtype or v.dtype != p.dtype:
            raise TypeError(f"parameter {i}: moments must be {p.dtype}")
        for name, t in (("parameter", p), ("moment1", m), ("moment2", v)):
            if not t.is_contiguous():
                raise ValueError(f"parameter {i}: {name} must be contiguous")
        groups.setdefault(p.dtype, []).append(
            (p, g.to(p.dtype).contiguous(), m, v))
    inv = _scalar_ptr(inv_scale, dev, torch.float32, "inv_scale")
    clip = _scalar_ptr(clip_scale, dev, torch.float32, "clip_scale")
    fin = _scalar_ptr(finite, dev, torch.int32, "finite")
    lr_t = device_scalar(lr, torch.float32, dev)
    step_t = device_scalar(step, torch.int32, dev)
    b32 = [float(np.float32(beta1)), float(np.float32(beta2))]
    for dtype, rows in groups.items():
        consts = b32 + [round_to_dtype(x, dtype) for x in (
            beta1, 1 - beta1, beta2, 1 - beta2, epsilon, weight_decay or 0.0)]
        for base in range(0, len(rows), ADAM_MAX):
            part = rows[base:base + ADAM_MAX]
            ptrs = [_array(ctypes.c_void_p, [r[k].data_ptr() for r in part])
                    for k in range(4)]
            n = [r[0].numel() for r in part]
            _launch("pt_multi_tensor_adam", params[0], *ptrs,
                    _array(ctypes.c_longlong, n), len(part),
                    _DTYPE_CODE[dtype], *consts, int(bool(decoupled)),
                    lr_t.data_ptr(), step_t.data_ptr(), inv, clip, fin)
            multi_tensor_adam.launches += int(sum(n) > 0)


multi_tensor_sumsq_finite.launches = 0
multi_tensor_adam.launches = 0
