"""Models: LLaMA, GPT, BERT / ERNIE, DeepFM and the OCR pair (DBNet,
CRNN)."""
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel, ErnieConfig,
                   ErnieForSequenceClassification, ErnieModel,
                   bert_pretraining_loss)
from .deepfm import DeepFM  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import (LlamaConfig, LlamaDecoderLayer,  # noqa: F401
                    LlamaForCausalLM, LlamaModel, build_hybrid_train_step,
                    load_paddle_tpu_state)
from .ocr import CRNN, DBNet, ctc_rec_loss, db_loss  # noqa: F401

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "CRNN", "DBNet",
           "DeepFM", "ErnieConfig", "ErnieForSequenceClassification",
           "ErnieModel", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM",
           "LlamaModel", "bert_pretraining_loss", "build_hybrid_train_step",
           "ctc_rec_loss", "db_loss", "load_paddle_tpu_state"]
