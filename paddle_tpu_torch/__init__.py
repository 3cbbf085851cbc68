"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for an NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package is held
against it slice by slice (ROADMAP.md). It imports torch, numpy and the
standard library, never jax and nothing of ``paddle_tpu``. Entry points run
on the card (``cuda``) unless the caller passes ``device="cpu"``; with no
CUDA device they raise. Every Pallas kernel on a ported path is a kernel
written by hand for Hopper under ``csrc/``, built with nvcc at first use.

Ported so far: serving LLaMA (``models.llama.LlamaForCausalLM``,
``inference.serving.ServingEngine``) and training on one device: the
LLaMA step ``models.build_hybrid_train_step`` and the general
``parallel.compile_train_step``, with the optimizers, LR schedulers and
LBFGS of ``optimizer``, the clips of ``nn.clip`` and ``amp.GradScaler``.
"""
from .core.device import get_device, resolve_device, set_device  # noqa: F401
from .core.generator import seed  # noqa: F401

__all__ = ["get_device", "set_device", "resolve_device", "seed"]
