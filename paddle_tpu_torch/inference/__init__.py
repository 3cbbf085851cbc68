"""``paddle_tpu_torch.inference``: the deployment predictor, and the
continuous-batching serving engine (``serving``).

Counterpart of ``paddle_tpu/inference/__init__.py``: ``Config`` and
``create_predictor`` over a ``jit.save`` artifact (``.pdmodel``, the
exported program; ``.pdiparams``, the weights). The predictor places the
weights on its device once, exposes the handle API (``get_input_handle``,
``copy_from_cpu``, ``run``, ``copy_to_cpu``) and ``run(inputs)``, and its
``clone()`` and ``PredictorPool`` share the weight storage.

``Config`` runs on the card unless ``disable_gpu()`` asks for the CPU;
without a card the card's predictor raises. ``convert_to_mixed_precision``
works on the port's own files (the JAX one opens ``.pdiparams`` with
pickle where its ``jit.save`` wrote ``.pdiparams.npz``, and fails).
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Tensor
from ..jit import save_load as _sl


class Config:
    """``paddle.inference.Config``: a ``jit.save`` prefix (or its
    ``.pdmodel`` path) and the device."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self.model_prefix = prog_file
        self._device = "gpu"
        self._device_id = 0
        self._memory_pool_mb = 0
        self._enable_memory_optim = True
        self._switch_ir_optim = True

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._device = "gpu"
        self._device_id = device_id
        self._memory_pool_mb = memory_pool_init_size_mb

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self.model_prefix = prog_file

    def model_dir(self):
        return self.model_prefix

    def switch_ir_optim(self, on: bool = True):
        self._switch_ir_optim = on

    def enable_memory_optim(self, on: bool = True):
        self._enable_memory_optim = on

    def summary(self) -> str:
        return (f"Config(model={self.model_prefix!r}, device={self._device}:"
                f"{self._device_id})")

    def device(self) -> torch.device:
        """The torch device the predictor runs on (raises for the card
        without one)."""
        if self._device == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._device_id}")


class _IOHandle:
    """A named input or output tensor (``ZeroCopyTensor``)."""

    def __init__(self, name: str, shape=None, dtype=None, device=None):
        self.name = name
        self._shape = shape
        self._dtype = dtype
        self._device = device
        self._value = None

    def reshape(self, shape):
        self._shape = list(shape)

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = Tensor(np.asarray(arr), place=self._device) \
            if self._device is not None else Tensor(np.asarray(arr))

    def copy_to_cpu(self) -> np.ndarray:
        return self._value.numpy()

    def share_external_data(self, tensor):
        self._value = tensor if isinstance(tensor, Tensor) else Tensor(tensor)

    def shape(self):
        v = self._value
        return list(v.shape) if v is not None else self._shape


class Predictor:
    def __init__(self, config: Config, _shared=None):
        self.config = config
        if _shared is not None:
            self._layer = _shared
        else:
            if config.model_prefix is None:
                raise ValueError("Config has no model path")
            self._layer = _sl.load(config.model_prefix,
                                   device=config.device())
        meta = getattr(self._layer, "_meta", {}) or {}
        self._meta = meta
        dev = self._layer._device
        n_in = len(meta.get("input_shapes", [])) or 1
        self._input_names = list(meta.get("input_names", [])) or \
            [f"input_{i}" for i in range(n_in)]
        shapes = meta.get("input_shapes", [None] * n_in)
        dts = meta.get("input_dtypes", [None] * n_in)
        self._inputs = {n: _IOHandle(n, shape=s, dtype=d, device=dev)
                        for n, s, d in zip(self._input_names, shapes, dts)}
        self._output_names: List[str] = list(meta.get("output_names", []))
        self._outputs = {}

    # -- handle API --
    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name: str) -> _IOHandle:
        return self._inputs[name]

    def get_output_names(self):
        return list(self._output_names)

    def get_output_handle(self, name: str) -> _IOHandle:
        return self._outputs[name]

    def _validate(self, vals):
        """Count, dtype and shape against the exported signature (None
        dims are dynamic): fail naming the feed."""
        meta = self._meta
        if not meta.get("input_dtypes"):
            return
        if len(vals) != len(self._input_names):
            raise ValueError(
                f"Predictor.run(): model takes {len(self._input_names)} "
                f"input(s) {self._input_names}, got {len(vals)}")
        for n, v, dt, shp in zip(self._input_names, vals,
                                 meta["input_dtypes"], meta["input_shapes"]):
            got = dtypes.dtype_name(v.dtype)
            if got != dt:
                raise TypeError(
                    f"Predictor.run(): input {n!r} expects dtype {dt}, got "
                    f"{got}")
            if len(v.shape) != len(shp) or any(
                    e is not None and e != g for e, g in zip(shp, v.shape)):
                raise ValueError(
                    f"Predictor.run(): input {n!r} expects shape {shp} "
                    f"(None = any), got {list(v.shape)}")

    def run(self, inputs: Optional[list] = None):
        """Run the program. With ``inputs`` (tensors or arrays) return the
        outputs; otherwise read the input handles and fill the output
        handles."""
        if inputs is not None:
            vals = [i if isinstance(i, torch.Tensor) else
                    Tensor(np.asarray(i)) for i in inputs]
        else:
            missing = [n for n in self._input_names
                       if self._inputs[n]._value is None]
            if missing:
                raise ValueError(
                    f"Predictor.run(): input handle(s) {missing} were never "
                    f"filled: call get_input_handle(name).copy_from_cpu(...) "
                    f"for each input first")
            vals = [self._inputs[n]._value for n in self._input_names]
        self._validate(vals)
        out = self._layer(*vals)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        self._output_names = self._meta.get(
            "output_names") or [f"output_{i}" for i in range(len(outs))]
        self._outputs = {}
        for n, o in zip(self._output_names, outs):
            h = _IOHandle(n)
            h.share_external_data(o)
            self._outputs[n] = h
        if inputs is not None:
            return outs
        return True

    def clone(self) -> "Predictor":
        """A second predictor over the same program and weight storage."""
        return Predictor(self.config, _shared=self._layer)

    def try_shrink_memory(self):
        if self._layer._device.type == "cuda":
            torch.cuda.empty_cache()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


from . import serving  # noqa: E402  (continuous-batching engine subpackage)

__all__ = ["Config", "Predictor", "create_predictor", "serving"]


# ---- enums + version/introspection surface ----

class DataType:
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT64 = "int64"
    INT32 = "int32"
    INT8 = "int8"
    UINT8 = "uint8"
    BOOL = "bool"


class PlaceType:
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3
    TPU = 4


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


_DTYPE_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "int64": 8,
                "int32": 4, "int8": 1, "uint8": 1, "bool": 1}


def get_num_bytes_of_data_type(dtype) -> int:
    return _DTYPE_BYTES[str(dtype)]


def get_version() -> str:
    return (f"paddle_tpu_torch inference (torch {torch.__version__}, "
            f"torch.export)")


def _get_phi_kernel_name(op_name: str) -> str:
    """Kernel-name mapping hook: an op here is its own kernel name."""
    return op_name


def get_trt_compile_version():
    """TensorRT is not part of the port (its kernels are hand-written)."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision,
                               backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """Re-save a ``jit.save``d model with its floating weights in
    float16 (``"float16"`` / ``PrecisionType.Half``) or bfloat16 (any
    other precision), on the port's own files (module docstring)."""
    prefix = model_file[:-8] if model_file.endswith(".pdmodel") \
        else model_file
    out_prefix = mixed_model_file[:-8] \
        if mixed_model_file.endswith(".pdmodel") else mixed_model_file
    dt = {"float16": torch.float16, PrecisionType.Half: torch.float16}.get(
        mixed_precision, torch.bfloat16)
    for ext in (".pdmodel", ".pdmeta"):
        if os.path.exists(prefix + ext):
            shutil.copy(prefix + ext, out_prefix + ext)
    with np.load(prefix + ".pdiparams") as npz:
        state = {k: _sl.tensor_of(npz[k], "cpu") for k in npz.files}
    state = {k: (v.to(dt) if v.is_floating_point() else v)
             for k, v in state.items()}
    _sl.write_npz(out_prefix + ".pdiparams", state)


class PredictorPool:
    """Predictor clones sharing one loaded program and its weights."""

    def __init__(self, config, size=1):
        base = create_predictor(config)
        self._preds = [base] + [base.clone() for _ in range(int(size) - 1)]

    def retrieve(self, idx):
        return self._preds[idx]


class XpuConfig:
    """Accepted for the config surface (Kunlun XPU is not a target)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
