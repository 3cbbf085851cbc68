"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for an NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package is held
against it slice by slice (ROADMAP.md). It imports torch, numpy and the
standard library, never jax and nothing of ``paddle_tpu``. Entry points run
on the card (``cuda``) unless the caller passes ``device="cpu"``; with no
CUDA device they raise. Every Pallas kernel on a ported path is a kernel
written by hand for Hopper under ``csrc/``, built with nvcc at first use.

Ported so far: serving LLaMA (``models.llama.LlamaForCausalLM``,
``inference.serving.ServingEngine``) and training: the LLaMA step
``models.build_hybrid_train_step`` and the general
``parallel.compile_train_step``, with the optimizers, LR schedulers and
LBFGS of ``optimizer``, the clips of ``nn.clip`` and ``amp.GradScaler``,
on one card or over a mesh of ranks with dp, mp (with sequence
parallelism) and sep (ring or Ulysses) axes (``distributed``,
``parallel.mesh``); and the Paddle-style eager core: ``Tensor`` (a
``torch.Tensor`` subclass), ``Parameter``, the op library
(``to_tensor``, the creation, math, manipulation, linalg and random ops)
through a dispatch that applies ``amp.auto_cast``'s lists, autograd over
torch's engine (``backward``, ``grad``, ``PyLayer``, the functional
transforms), ``nn.Layer``, flags, ``save``/``load``; the measurement
API (``device``: counters, streams, events; ``profiler``: ``Profiler``,
``RecordEvent``, the summaries, ``benchmark()``), the op library's
breadth and its in-place ``*_`` family, ``nn``'s functionals,
initializers and the activation, common, norm, loss, container and
transformer layers, ``regularizer``, and GPT (``models.gpt``); the
static-graph world (``static``: ``Program``, ``Executor``,
``enable_static``) and the compile/export tier (``to_static``,
``jit.save`` / ``jit.load``, ``inference.Predictor``); the rest of the
core API (``LazyGuard``, ``flops``, ``utils.run_check``, ...), the serving
C ABI (``utils.native.build_capi``) and ``incubate`` (the fused
transformer functionals and layers, masked decode attention, fused RoPE,
segment and graph ops, ASP, ``LookAhead`` / ``ModelAverage``).
"""
from .core.device import (  # noqa: F401
    device_count, get_device, is_compiled_with_tpu, resolve_device,
    set_device,
)
from .core.generator import Generator, default_generator, seed  # noqa: F401
from .core.dtype import (  # noqa: F401
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128, set_default_dtype, get_default_dtype,
)
from .core.tensor import Parameter, Tensor, is_tensor  # noqa: F401
from .autograd.grad_mode import (enable_grad, is_grad_enabled,  # noqa: F401
                                 no_grad)
from .autograd.backward import grad  # noqa: F401

from .ops import *  # noqa: F401,F403
from .ops import linalg  # noqa: F401
from . import autograd  # noqa: F401
from . import amp  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import io  # noqa: F401
from . import device  # noqa: F401
from . import profiler  # noqa: F401
from . import regularizer  # noqa: F401
from . import jit  # noqa: F401
from .jit.api import to_static  # noqa: F401
from . import utils  # noqa: F401
from . import observability  # noqa: F401


def __getattr__(name):
    # loaded on first use, as in the JAX package
    if name == "distributed":
        import importlib
        return importlib.import_module(".distributed", __name__)
    if name == "DataParallel":
        from .distributed.parallel import DataParallel
        return DataParallel
    if name in ("static", "inference", "incubate"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name in ("enable_static", "disable_static", "in_dynamic_mode"):
        from .static import framework as _sfw
        return getattr(_sfw, name)
    if name == "CompiledProgram":
        from .static import CompiledProgram
        return CompiledProgram
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
from .utils.flags import get_flags, set_flags  # noqa: F401
from .framework_io import load, save  # noqa: F401
from .framework_compat import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, LazyGuard, ParamAttr, TPUPlace,
    batch, bool, check_shape, disable_signal_handler, dtype, finfo, flops,
    get_cuda_rng_state, get_rng_state, iinfo, set_cuda_rng_state,
    set_grad_enabled, set_printoptions, set_rng_state,
)

__version__ = "0.1.0"
