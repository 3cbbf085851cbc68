"""``DistributedStrategy``: the fleet's configuration.

Counterpart of ``paddle_tpu/distributed/fleet/distributed_strategy.py``
(after Paddle's proto-backed ``fleet/base/distributed_strategy.py``):
plain Python with the same field names, so fleet configurations carry
over. ``hybrid_configs`` sets the mesh; ``sharding`` with
``sharding_configs["stage"]`` the ZeRO stage; ``pipeline_configs
["accumulate_steps"]`` and ``gradient_merge_configs["k_steps"]`` the
accumulation; ``lars`` / ``lamb`` swap the optimizer
(``hybrid_optimizer.apply_meta_optimizers``). ``dgc``, ``localsgd`` and
``fp16_allreduce`` are accepted, warn and change nothing (the port's
compressed wire is ``distributed.comms.quantized``).
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005, "epsilon": 0.0,
                             "exclude_from_weight_decay": []}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.fp16_allreduce = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def __repr__(self):
        return f"DistributedStrategy(hybrid_configs={self.hybrid_configs})"
