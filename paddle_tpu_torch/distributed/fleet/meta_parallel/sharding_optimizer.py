"""ZeRO sharding stages.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
sharding_optimizer.py`` (after Paddle's ``DygraphShardingOptimizer``,
``GroupShardedStage2`` / ``GroupShardedOptimizerStage2``,
``GroupShardedStage3`` and ``group_sharded_parallel``). The wrappers tag
the optimizer with ``_shard_stage`` and ``_shard_axis`` ("sharding"), and
the train steps read the tags (``parallel.trainer.zero_config``):
``build_hybrid_train_step`` and ``TrainStep`` shard every state leaf over
the axis ``_resolve_zero_axis`` picks (``sharding``, or dp when the mesh
has no sharding axis above 1), update each rank's slice of the parameter
and all-gather it; stage 2 reduce-scatters the grads over a dp axis;
stage 3 keeps the parameters sharded between steps.

The wrappers' own ``step()`` (eager training) does the same with the
grads the caller synced (``DataParallel``): each rank keeps its slice of
the optimizer state (stage 1, 2) and takes its slice of each grad (stage
2), updates its slice and all-gathers the parameter. Stage 3's at-rest
sharding is the train steps'; in eager mode ``shard_layer_params`` only
marks the parameters (``_sharding``), because an eager forward reads the
whole parameter.
"""
from __future__ import annotations

import os

import torch
from torch import nn

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model",
           "shard_layer_params", "SHARDING_AXIS"]

SHARDING_AXIS = "sharding"


def _mesh_with_axis(axis=SHARDING_AXIS):
    """The installed mesh if it has ``axis`` above 1, else None."""
    from ....parallel import mesh as mesh_mod
    mesh = mesh_mod.get_mesh()
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return mesh


class _EagerZero:
    """The eager ZeRO update of one optimizer: built at its first step over
    the parameters that have grads, on the installed mesh."""

    def __init__(self, optim):
        self.optim = optim
        self.shards = None
        self.params = None

    def step(self) -> bool:
        """One sharded update; False when there is nothing to shard over
        (the caller then runs the plain step)."""
        from ....nn.clip import ClipGradByGlobalNorm
        from ....parallel import mesh as mesh_mod
        from ....parallel.trainer import (ZeroShards, param_spec,
                                          zero_config)
        opt = self.optim
        mesh = mesh_mod.get_mesh()
        axis, stage = zero_config(opt, mesh)
        if not stage:
            return False
        params = [p for p in opt._params
                  if p.requires_grad and p.grad is not None]
        if self.shards is None or self.params != params:
            mp = mesh.shape.get("mp", 1)
            layouts = []
            for p in params:
                g = list(p.shape)
                if getattr(p, "split_axis", None) is not None:
                    g[p.split_axis] *= mp
                layouts.append((tuple(g), param_spec(p, mesh),
                                list(range(p.dim()))))
            self.shards = ZeroShards(params, layouts, axis, min(stage, 2),
                                     mesh)
            self.params = params
            for k, p in enumerate(params):
                if id(p) not in opt._states:
                    opt._states[id(p)] = opt._init_state(
                        self.shards.state_like(k))
        grads = [p.grad for p in params]
        clip, scale = opt._grad_clip, None
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = clip.scale(grads)
        elif clip is not None:
            clipped = {id(p): g for p, g in clip(list(zip(params, grads)))}
            grads = [clipped.get(id(p), g) for p, g in zip(params, grads)]
        grads = self.shards.sync_grads(grads, (), "avg", "zero.eager")
        opt._global_step += 1
        self.shards.update(opt, grads, [opt._states[id(p)] for p in params],
                           opt.get_lr(), opt._global_step, clip_scale=scale)
        return True


def _tag(optim, stage: int) -> None:
    optim._shard_stage = stage
    optim._shard_axis = SHARDING_AXIS


class _ShardedOptimizer:
    """What the optimizer wrappers share: the inner optimizer's attributes,
    ``step`` through the eager ZeRO update, ``minimize``, ``clear_grad``
    and ``inner_opt``."""

    def __init__(self, optim):
        self._zero_eager = _EagerZero(optim)

    def _inner(self):
        raise NotImplementedError

    def __getattr__(self, item):
        if item.startswith("__"):
            raise AttributeError(item)
        return getattr(self._inner(), item)

    def step(self):
        if not self._zero_eager.step():
            self._inner().step()

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, *a, **k):
        self._inner().clear_grad(*a, **k)

    @property
    def inner_opt(self):
        return self._inner()


class DygraphShardingOptimizer(_ShardedOptimizer):
    """Stage 1: optimizer states sharded over the sharding axis."""

    def __init__(self, optimizer, hcg=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        _tag(optimizer, 1)
        super().__init__(optimizer)

    def _inner(self):
        return self.__dict__["_inner_opt"]


class GroupShardedOptimizerStage2(_ShardedOptimizer):
    """Stage 2: states sharded and grads reduce-scattered (a dp axis) or
    sliced (a sharding axis) before the update."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kw):
        self._optim = optim
        self._group = group
        _tag(optim, 2)
        super().__init__(optim)

    def _inner(self):
        return self.__dict__["_optim"]


class _LayerWrapper(nn.Module):
    """A model wrapper that forwards to, and reads through to, its
    layer."""

    def __init__(self, layer):
        super().__init__()
        self._layer = layer

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def __getattr__(self, item):
        try:
            return super().__getattr__(item)
        except AttributeError:
            return getattr(super().__getattr__("_layer"), item)


class GroupShardedStage2(_LayerWrapper):
    """Stage-2 model wrapper (the grads' reduce-scatter is the
    optimizer's)."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="gpu", **kw):
        super().__init__(layer)
        self._sharding_optimizer = sharding_optimizer


def shard_layer_params(layer):
    """Mark every trainable parameter for FSDP-style sharding along its
    largest dim the sharding axis divides (``p._sharding``, which the
    train steps' ZeRO reads); on a mesh without a sharding axis above 1
    every dim fits and the largest is marked."""
    mesh = _mesh_with_axis()
    n = mesh.shape[SHARDING_AXIS] if mesh is not None else 1
    for p in layer.parameters():
        if getattr(p, "_sharding", None) is None and p.dim() >= 1:
            cand = [i for i in range(p.dim()) if p.shape[i] % n == 0]
            if not cand:
                continue
            big = int(max(cand, key=lambda i: p.shape[i]))
            spec = [None] * p.dim()
            spec[big] = SHARDING_AXIS
            p._sharding = tuple(spec)


class GroupShardedStage3(_LayerWrapper):
    """Stage 3 (FSDP): the parameters themselves sharded between steps."""

    def __init__(self, layer, optimizer, group=None, sync_buffers=False,
                 device="gpu", segment_size=2 ** 20, offload=False, **kw):
        super().__init__(layer)
        self._optimizer = optimizer
        _tag(optimizer, 3)
        shard_layer_params(layer)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``level``: ``os`` (stage 1), ``os_g`` (stage 2) or ``p_g_os``
    (stage 3); returns ``(model, optimizer, scaler)``."""
    if level == "os":
        return model, DygraphShardingOptimizer(optimizer), scaler
    if level == "os_g":
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer,
                                          group)
        return GroupShardedStage2(model, opt, group), opt, scaler
    if level == "p_g_os":
        return GroupShardedStage3(model, optimizer, group), optimizer, scaler
    raise ValueError(f"unknown group_sharded level {level!r}")


def save_group_sharded_model(model, output, optimizer=None):
    """The layer's state dict to ``output/model.pdparams`` (rank 0) and the
    optimizer's to ``output/model.pdopt``; with ZeRO each rank holds its
    slice of the optimizer state, so rank r > 0 writes
    ``model.pdopt.<r>``."""
    from ..env import get_rank
    os.makedirs(output, exist_ok=True)
    layer = getattr(model, "_layer", model)
    rank = get_rank()
    if rank == 0:
        torch.save(layer.state_dict(), os.path.join(output,
                                                    "model.pdparams"))
    if optimizer is not None:
        inner = getattr(optimizer, "inner_opt", optimizer)
        name = "model.pdopt" if rank == 0 else f"model.pdopt.{rank}"
        torch.save(inner.state_dict(), os.path.join(output, name))
