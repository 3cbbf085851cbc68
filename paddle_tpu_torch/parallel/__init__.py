"""paddle_tpu_torch.parallel: the device mesh (``mesh``), ring and Ulysses
attention (``context_parallel``), the pipeline schedules (``pipeline``)
and the general train step (``TrainStep``, ``compile_train_step``) over
dp, mp, sep, pp and sharding axes with ZeRO (``trainer``)."""
from . import pipeline  # noqa: F401
from .mesh import (  # noqa: F401
    DeviceMesh, axis_index, get_mesh, has_mesh, init_mesh, mesh_axis_size,
    set_mesh,
)
from .trainer import (  # noqa: F401
    MAX_LOSS_SCALE, LossSum, TrainStep, compile_train_step,
)
from .context_parallel import (  # noqa: F401
    ring_attention, sdpa_context_parallel, ulysses_attention,
)

__all__ = ["DeviceMesh", "init_mesh", "get_mesh", "set_mesh",
           "mesh_axis_size", "has_mesh", "axis_index", "TrainStep",
           "compile_train_step", "LossSum", "MAX_LOSS_SCALE", "ring_attention",
           "ulysses_attention", "sdpa_context_parallel"]
