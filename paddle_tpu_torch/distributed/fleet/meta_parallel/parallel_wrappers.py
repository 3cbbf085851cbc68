"""Model wrappers per parallel mode.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_wrappers.py`` (after Paddle's ``meta_parallel/{tensor_parallel,
sharding_parallel,pipeline_parallel}.py``). The tensor-parallel layers
hold their own shards and the train steps do the syncs, so the wrappers
carry the API: ``TensorParallel`` and ``SegmentParallel`` forward to the
model, ``ShardingParallel`` marks the parameters for stage 3,
``PipelineParallel.train_batch`` runs the microbatches one after another
(the same numbers as a 1F1B schedule, eager), as the JAX wrapper does.
"""
from __future__ import annotations

import torch
from torch import nn

from .pp_layers import PipelineLayer

__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "SegmentParallel", "PipelineParallel",
           "PipelineParallelWithInterleave"]


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)


class TensorParallel(MetaParallelBase):
    """mp wrapper: each rank's layers already hold its shards."""


class ShardingParallel(MetaParallelBase):
    """Stage 3 marks the parameters for sharding; stages 1 and 2 act
    through the optimizer."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        from ..hybrid_optimizer import _strategy_stage
        if _strategy_stage(strategy) >= 3:
            from .sharding_optimizer import shard_layer_params
            shard_layer_params(layers)


class SegmentParallel(MetaParallelBase):
    pass


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", 1)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over ``accumulate_steps`` microbatches of
        ``data = (x, y)``; each microbatch's loss weighs its share of the
        rows. Returns the weighted loss."""
        x, y = data
        n = self.accumulate_steps
        bsz = x.shape[0]
        mb = max(bsz // n, 1)
        weighted = 0.0
        for i in range(0, bsz, mb):
            xi, yi = x[i:i + mb], y[i:i + mb]
            size = xi.shape[0]
            loss = self._layers._loss_fn(self._layers(xi), yi)
            scaled = loss * (size / bsz)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            weighted += float(loss.detach()) * size / bsz
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(weighted)

    def eval_batch(self, data, compute_loss=True):
        x, y = data
        with torch.no_grad():
            out = self._layers(x)
            if compute_loss and self._layers._loss_fn is not None:
                return self._layers._loss_fn(out, y)
        return out


class PipelineParallelWithInterleave(PipelineParallel):
    """VPP: the same eager semantics (the interleaved schedule is
    ``parallel.pipeline``'s vpp)."""
