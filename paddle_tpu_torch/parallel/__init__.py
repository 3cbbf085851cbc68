"""The general train step: ``TrainStep`` and ``compile_train_step``
(single device). The mesh, ring and Ulysses attention and pipeline
schedules of ``paddle_tpu.parallel`` wait for the multi-device slice
(ROADMAP.md Queue 1)."""
from .trainer import MAX_LOSS_SCALE, TrainStep, compile_train_step  # noqa: F401

__all__ = ["TrainStep", "compile_train_step", "MAX_LOSS_SCALE"]
