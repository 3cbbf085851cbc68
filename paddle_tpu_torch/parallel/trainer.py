"""The general train step, single device: ``TrainStep`` and
``compile_train_step``.

Counterpart of ``paddle_tpu/parallel/trainer.py`` (:127-546), where the
whole step (forward, backward, clip, update, the grad-finite skip and the
dynamic loss scale) is one jitted program with donated buffers. Here the
step runs eagerly and keeps everything that decides the step on the
device, with no host read inside it:

- ``loss_fn(model, batch)`` gives the loss; with a scaler it is multiplied
  by the loss scale inside the differentiated function, and after the
  backward the grads are unscaled by ``1 / scale`` (:295-327);
- ``accumulate_steps``: the batch's leaves are split along dim 0, the
  mean loss and the mean grads taken;
- one pass over the unscaled grads (kernel U1 on the card) gives the
  global grad-finite flag, judged on the raw grads (:329-338), and the
  sums of squares for a ``ClipGradByGlobalNorm``, whose scale stays on the
  device; a ``ClipGradByValue`` clamps the unscaled grads (:350-359);
- the optimizer's ``_multi_update`` applies the unscale, the clip scale
  and the rule in place (kernel U2 for Adam and AdamW on the card), and
  under a non-finite flag writes nothing: params and moments stay bit for
  bit what they were (:365-373);
- the health state (loss scale, good and bad streaks, skipped steps) is
  0-dim device tensors, updated branch-free as ``AmpScaler.update`` with
  the floor at 1.0 and the cap at ``MAX_LOSS_SCALE`` (:375-392);
- the step count advances on a skipped step too (:446-448).

A mesh with an axis above 1 (data, tensor or pipeline parallelism, ZeRO),
``reshard``, ``lower_text`` and ``memory_stats`` wait for the multi-device
and capture slices (ROADMAP.md Queue 1) and raise ``NotInThisSlice``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.errors import NotInThisSlice
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from ..ops.kernels.multi_tensor import multi_tensor_sumsq_finite

__all__ = ["TrainStep", "compile_train_step", "MAX_LOSS_SCALE"]

# Dynamic loss scaling never grows past this: with tiny gradients the
# overflow signal that normally bounds growth never fires, and a scale
# doubled past the fp32 range is inf, which every later step would skip on.
MAX_LOSS_SCALE = 2.0 ** 31


def _mesh_axes(mesh) -> dict:
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _to_device(tree, device):
    """The batch's arrays and tensors as tensors on device (nested dicts,
    lists and tuples)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _split(tree, k: int, i: int):
    """The i-th of k micro-batches: each leaf's rows [i B/k, (i+1) B/k)."""
    if isinstance(tree, dict):
        return {key: _split(v, k, i) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, k, i) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.shape[0] % k:
            raise ValueError(f"batch dim {tree.shape[0]} is not a multiple "
                             f"of accumulate_steps={k}")
        n = tree.shape[0] // k
        return tree[i * n:(i + 1) * n]
    return tree


class TrainStep:
    """Callable train step over the model's own parameters (trained in
    place) and the optimizer state it holds (``_opt_state``)."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 batch_spec=("dp",), loss_has_aux=False, remat: bool = False,
                 accumulate_steps: Optional[int] = None, scaler=None):
        big = {k: v for k, v in _mesh_axes(mesh).items() if v > 1}
        if big:
            raise NotInThisSlice("multi-device TrainStep (mesh axes > 1, "
                                 "ZeRO, comms)", f"mesh={big}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self._step_count = 0
        self.captured_program = None

        inner = model
        for attr in ("_layers", "_layer"):
            while hasattr(inner, attr):
                inner = getattr(inner, attr)
        self._inner = inner
        self._params = [p for p in inner.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("the model has no trainable parameter")
        self._device = self._params[0].device

        base_opt = optimizer
        while hasattr(base_opt, "inner_opt"):
            base_opt = base_opt.inner_opt
        self._base_opt = base_opt
        self._opt_state = [base_opt._init_state(p) for p in self._params]
        if accumulate_steps is None:
            accumulate_steps = int(getattr(base_opt, "_accumulate_steps", 1)
                                   or getattr(optimizer, "_accumulate_steps",
                                              1) or 1)
        self._accumulate_steps = max(int(accumulate_steps), 1)
        self._grad_clip = getattr(base_opt, "_grad_clip", None)

        self._scaler = scaler
        self._use_scaling = bool(scaler is not None and scaler.is_enable())
        self._dynamic_scaling = bool(
            self._use_scaling and scaler.is_use_dynamic_loss_scaling())
        init_scale = float(scaler._scale) if self._use_scaling else 1.0
        self._scale_cfg = dict(
            incr_ratio=float(getattr(scaler, "_incr_ratio", 2.0)),
            decr_ratio=float(getattr(scaler, "_decr_ratio", 0.5)),
            incr_every=int(getattr(scaler, "_incr_every", 1000)),
            decr_every=int(getattr(scaler, "_decr_every", 1)),
        )
        dev = self._device
        self._health = {
            "loss_scale": torch.tensor(init_scale, dtype=torch.float32,
                                       device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "bad_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "skipped": torch.zeros((), dtype=torch.int32, device=dev),
        }

    # ---- one step ----
    def _loss_and_grads(self, batch, scale):
        """The mean loss (scaled) and every parameter's grad (scaled, the
        mean over micro-batches); zeros for a parameter the loss does not
        reach."""
        for p in self._params:
            p.grad = None
        acc = self._accumulate_steps
        total = None
        for i in range(acc):
            mb = _split(batch, acc, i) if acc > 1 else batch
            loss = self.loss_fn(self._inner, mb)
            if self._use_scaling:
                loss = loss * scale.to(loss.dtype)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        for p in self._params:
            p.grad = None
        if acc > 1:
            k = torch.full((), acc, dtype=total.dtype, device=total.device)
            total = total / k
            grads = [g / k.to(g.dtype) for g in grads]
        return total, grads

    def _update_health(self, finite):
        h, cfg = self._health, self._scale_cfg
        ok = finite.to(torch.int32)
        new = dict(h)
        new["skipped"] = h["skipped"] + (1 - ok)
        if self._dynamic_scaling:
            fin = finite.bool()
            zero = torch.zeros_like(h["good_steps"])
            good = torch.where(fin, h["good_steps"] + 1, zero)
            bad = torch.where(fin, zero, h["bad_steps"] + 1)
            grow = good >= cfg["incr_every"]
            shrink = bad >= cfg["decr_every"]
            scale = h["loss_scale"]
            new["loss_scale"] = torch.where(
                shrink, torch.clamp_min(scale * cfg["decr_ratio"], 1.0),
                torch.where(grow, torch.clamp_max(scale * cfg["incr_ratio"],
                                                  MAX_LOSS_SCALE), scale))
            new["good_steps"] = torch.where(grow, zero, good)
            new["bad_steps"] = torch.where(shrink, zero, bad)
        self._health = new

    def __call__(self, batch):
        batch = _to_device(batch, self._device)
        self._step_count += 1
        lr = self._base_opt.get_lr()
        scale = self._health["loss_scale"]
        loss, grads = self._loss_and_grads(batch, scale)
        inv = None
        if self._use_scaling:
            inv = torch.reciprocal(scale)
            loss = loss * inv.to(loss.dtype)
        _, total, finite = multi_tensor_sumsq_finite(grads, inv)
        clip, clip_scale = self._grad_clip, None
        if isinstance(clip, ClipGradByGlobalNorm):
            clip_scale = clip.scale_from_sumsq(total)
        elif isinstance(clip, ClipGradByValue):
            with torch.no_grad():
                if inv is not None:
                    grads = [g * inv.to(g.dtype) for g in grads]
                    inv = None
                grads = [torch.clamp(g, clip.min, clip.max) for g in grads]
        self._base_opt._multi_update(
            self._params, grads, self._opt_state, lr, self._step_count,
            grad_scale=inv, clip_scale=clip_scale, finite=finite)
        self._update_health(finite)
        return loss

    # ---- self-healing telemetry (host reads, outside the step) ----
    @property
    def skipped_steps(self) -> int:
        """Steps whose update was skipped because a grad went nan/inf."""
        return int(self._health["skipped"])

    @property
    def loss_scale(self) -> float:
        """The current (device-side) dynamic loss scale."""
        return float(self._health["loss_scale"])

    def sync_scaler(self):
        """Copy the device-side scale into the attached GradScaler, so that
        its state_dict() sees what the step did."""
        if self._scaler is not None and self._use_scaling:
            self._scaler._scale = float(self._health["loss_scale"])
        return self._scaler

    # ---- legs of later slices ----
    def reshard(self, new_mesh) -> None:
        raise NotInThisSlice("live resharding (elastic multi-device)",
                             "TrainStep.reshard")

    def lower_text(self, batch):
        raise NotInThisSlice("whole-step capture", "TrainStep.lower_text")

    def memory_stats(self, batch):
        raise NotInThisSlice("whole-step capture", "TrainStep.memory_stats")


def compile_train_step(model, loss_fn, optimizer, mesh=None,
                       **kw) -> TrainStep:
    """``loss_fn(model, batch) -> scalar loss tensor``. Returns a TrainStep
    whose ``__call__(batch)`` runs one step and returns the loss.

    Pass ``scaler=amp.GradScaler(...)`` for dynamic loss scaling on the
    device (scale, unscale, skip on overflow, backoff and growth, no host
    read). Even without a scaler the step skips an update whose grads hold
    inf or nan (params and optimizer state bit-exact) and counts it in
    ``step.skipped_steps``."""
    return TrainStep(model, loss_fn, optimizer, mesh=mesh, **kw)
