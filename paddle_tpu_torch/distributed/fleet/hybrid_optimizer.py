"""``HybridParallelOptimizer`` and the strategy's optimizer swaps.

Counterpart of ``paddle_tpu/distributed/fleet/hybrid_optimizer.py`` (after
Paddle's ``hybrid_parallel_optimizer.py``). The wrapper carries the
strategy to the train steps as tags on the BASE optimizer (:96-163):
``_shard_stage`` / ``_shard_axis`` ("sharding") from
``strategy.sharding``, ``_accumulate_steps`` from gradient merge or the
pipeline's ``accumulate_steps``; ``build_hybrid_train_step`` and
``TrainStep`` read them. Its eager ``step()`` honours the ZeRO stage as
the sharding wrappers do. ``apply_meta_optimizers`` swaps Momentum for
Lars (``strategy.lars``) and Adam / AdamW for Lamb (``strategy.lamb``);
``dgc``, ``localsgd`` and ``fp16_allreduce`` warn and change nothing.
"""
from __future__ import annotations

import warnings

__all__ = ["HybridParallelOptimizer", "apply_meta_optimizers"]


def _base(optimizer):
    while hasattr(optimizer, "inner_opt"):
        optimizer = optimizer.inner_opt
    return optimizer


def apply_meta_optimizers(optimizer, strategy):
    """The optimizer with the strategy's lars / lamb swap applied at its
    base (the wrappers keep wrapping it)."""
    from ...optimizer import Adam, AdamW, Lamb, Lars, Momentum

    if strategy is None:
        return optimizer
    for flag in ("dgc", "localsgd", "fp16_allreduce"):
        if getattr(strategy, flag, False):
            warnings.warn(
                f"DistributedStrategy.{flag} is not implemented by the "
                "port (its compressed gradient wire is "
                "distributed.comms.quantized) and is ignored",
                stacklevel=3)
    base = _base(optimizer)
    new_base = None
    # lars only swaps Momentum (not bare SGD), as the reference
    if getattr(strategy, "lars", False) and type(base) is Momentum:
        cfg = dict(getattr(strategy, "lars_configs", {}) or {})
        new_base = Lars(
            learning_rate=base._learning_rate, momentum=base._momentum,
            lars_coeff=float(cfg.get("lars_coeff", 0.001)),
            lars_weight_decay=float(cfg.get("lars_weight_decay", 0.0005)),
            epsilon=float(cfg.get("epsilon", 0.0)),
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay"),
            parameters=base._params, grad_clip=base._grad_clip)
    elif getattr(strategy, "lamb", False) and type(base) in (Adam, AdamW):
        cfg = dict(getattr(strategy, "lamb_configs", {}) or {})
        exclude = tuple(cfg.get("exclude_from_weight_decay") or ())
        new_base = Lamb(
            learning_rate=base._learning_rate,
            lamb_weight_decay=float(cfg.get("lamb_weight_decay", 0.01)),
            beta1=getattr(base, "_beta1", 0.9),
            beta2=getattr(base, "_beta2", 0.999),
            exclude_from_weight_decay_fn=(
                (lambda p: any(t in (getattr(p, "name", "") or "")
                               for t in exclude)) if exclude else None),
            parameters=base._params, grad_clip=base._grad_clip)
    if new_base is None:
        return optimizer
    for tag in ("_shard_stage", "_shard_axis", "_accumulate_steps"):
        if hasattr(base, tag):
            setattr(new_base, tag, getattr(base, tag))
    if base is optimizer:
        return new_base
    holder = optimizer
    while getattr(holder, "inner_opt", None) is not base:
        holder = holder.inner_opt
    for attr in ("_inner_opt", "_optim"):
        if holder.__dict__.get(attr) is base:
            holder.__dict__[attr] = new_base
            holder.__dict__["_zero_eager"].optim = new_base
            break
    else:
        raise RuntimeError(
            f"cannot apply {'lars' if strategy.lars else 'lamb'}: wrapper "
            f"{type(holder).__name__} has no inner-optimizer slot")
    return optimizer


def _strategy_stage(strategy) -> int:
    """The ZeRO stage a strategy asks for (0: sharding off)."""
    if strategy is None or not getattr(strategy, "sharding", False):
        return 0
    return int(strategy.sharding_configs.get("stage", 1))


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        from .meta_parallel.sharding_optimizer import SHARDING_AXIS, \
            _EagerZero
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        base = _base(optimizer)
        stage = _strategy_stage(strategy)
        if stage:
            base._shard_stage = stage
            base._shard_axis = SHARDING_AXIS
        if strategy is not None:
            k = 1
            if getattr(strategy, "gradient_merge", False):
                k = int(strategy.gradient_merge_configs.get("k_steps", 1))
            pk = int(getattr(strategy, "pipeline_configs",
                             {}).get("accumulate_steps", 1) or 1) \
                if getattr(strategy, "pipeline", False) else 1
            k = max(k, pk)
            if k > 1:
                base._accumulate_steps = k
        self._zero_eager = _EagerZero(base)

    def __getattr__(self, item):
        if item.startswith("__"):
            raise AttributeError(item)
        return getattr(self.__dict__["_inner_opt"], item)

    def step(self):
        """The eager step: the ZeRO stage the strategy tagged (the
        sharding wrappers' update), else the inner optimizer's."""
        inner = self._inner_opt
        if hasattr(inner, "_zero_eager") or not self._zero_eager.step():
            inner.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    @property
    def inner_opt(self):
        return self._inner_opt
