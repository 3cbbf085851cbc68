"""Models: LLaMA and DeepFM."""
from .deepfm import DeepFM  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    build_hybrid_train_step, load_paddle_tpu_state)

__all__ = ["DeepFM", "LlamaConfig", "LlamaForCausalLM",
           "build_hybrid_train_step", "load_paddle_tpu_state"]
