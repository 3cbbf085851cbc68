"""``paddle_tpu_torch.static``: the static-graph world.

Counterpart of ``paddle_tpu/static``: Programs record op applications over
symbolic Variables (``framework``), the Executor replays a Program with
real tensors, each cache entry one CUDA graph on the card (``executor``),
and the saved-model format is a ``torch.export`` of the replayed program
(``io``).
"""
from ..jit.api import InputSpec  # noqa: F401
from . import nn  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .framework import (  # noqa: F401
    BackwardRecord, Block, CompiledProgram, GradientRecord, Operator, Program,
    Variable, data, default_main_program, default_startup_program,
    disable_static, enable_static, in_dynamic_mode, in_static_mode,
    program_guard, set_program_state,
)
from .compat import (  # noqa: F401
    BuildStrategy, ExecutionStrategy, ExponentialMovingAverage,
    IpuCompiledProgram, IpuStrategy, Print, ProgramNotSerializable,
    WeightNormParamAttr, accuracy, append_backward, auc, cpu_places,
    create_global_var, create_parameter, ctr_metric_bundle, cuda_places,
    device_guard, deserialize_persistables, deserialize_program, gradients,
    ipu_shard_guard, load, load_from_file, load_program_state, name_scope,
    py_func, save, save_to_file, serialize_persistables, serialize_program,
    set_ipu_shard, xpu_places,
)
from .io import (  # noqa: F401
    InferenceProgram, load_inference_model, normalize_program,
    save_inference_model,
)

__all__ = [
    "InputSpec", "nn", "Executor", "Scope", "global_scope", "scope_guard",
    "Program", "CompiledProgram", "Variable", "data", "default_main_program",
    "default_startup_program", "program_guard", "enable_static",
    "disable_static", "in_dynamic_mode", "in_static_mode",
    "save_inference_model", "load_inference_model", "normalize_program",
    "set_program_state", "append_backward", "gradients", "name_scope",
    "py_func", "Print", "create_global_var", "ExponentialMovingAverage",
    "WeightNormParamAttr", "BuildStrategy", "ExecutionStrategy", "save",
    "load", "load_program_state", "serialize_program",
    "serialize_persistables", "save_to_file", "deserialize_program",
    "deserialize_persistables", "load_from_file", "cpu_places", "cuda_places",
    "xpu_places", "ipu_shard_guard", "IpuCompiledProgram", "IpuStrategy",
]
