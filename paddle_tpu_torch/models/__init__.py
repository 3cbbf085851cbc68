"""Models: LLaMA, GPT and DeepFM."""
from .deepfm import DeepFM  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import (LlamaConfig, LlamaDecoderLayer,  # noqa: F401
                    LlamaForCausalLM, LlamaModel, build_hybrid_train_step,
                    load_paddle_tpu_state)

__all__ = ["DeepFM", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM",
           "LlamaModel", "build_hybrid_train_step", "load_paddle_tpu_state"]
