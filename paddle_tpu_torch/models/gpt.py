"""GPT: a decoder-only transformer with learned positions.

Counterpart of ``paddle_tpu/models/gpt.py``, built from the port's
``nn`` layers: the word and position ``Embedding``s, ``Dropout``, a
``TransformerEncoder`` of pre-norm ``TransformerEncoderLayer``s (GELU,
the causal mask of ``Transformer.generate_square_subsequent_mask``
added to the logits) and the final ``LayerNorm``. ``GPTForCausalLM``
ties its head to the word embedding (``gpt_logits``: ``h @ Wᵀ``) and its
loss is the mean next-token cross entropy (``gpt_lm_loss``). With the
additive mask, attention takes the plain ``sdpa_ref`` in both packages,
so GPT runs no flash-attention kernel. ``generate`` decodes greedily, or
samples (``temperature``, ``top_k``) from the device's default generator
by the Gumbel-max trick, as ``jax.random.categorical`` does.
``load_paddle_tpu_state`` / ``paddle_tpu_state`` carry weights by the
JAX model's ``state_dict`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.generator import default_generator
from ..core.tensor import Tensor
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import (Transformer, TransformerEncoder,
                                    TransformerEncoderLayer)
from ..ops.dispatch import apply

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "load_paddle_tpu_state", "paddle_tpu_state"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64)
        d.update(kw)
        return cls(**d)


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = cfg
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=dev)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, device=dev)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob,
            normalize_before=True, device=dev)
        self.decoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.final_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, device=dev)

    def forward(self, input_ids, position_ids=None):
        seq = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = Tensor(torch.arange(seq, device=dev)[None, :])
        h = self.dropout(self.word_embeddings(input_ids)
                         + self.position_embeddings(position_ids))
        causal = Transformer.generate_square_subsequent_mask(
            seq, device=dev)[None, None]
        return self.final_norm(self.decoder(h, causal))


# the functions the dispatch runs call torch directly, as the JAX ones
# compute on raw arrays (an operator on a port Tensor is an op of the
# library, with its own dispatch)
def _logits(h, w):
    return torch.matmul(h, w.t())


def _lm_loss(lg, lab):
    logp = torch.log_softmax(lg[:, :-1], -1)
    return torch.neg(torch.mean(torch.gather(logp, -1, lab[:, 1:, None])))


class GPTForCausalLM(Layer):
    def __init__(self, cfg: GPTConfig, *, device=None):
        super().__init__()
        self.gpt = GPTModel(cfg, device=device)

    def forward(self, input_ids, position_ids=None, labels=None):
        h = self.gpt(input_ids, position_ids)
        # the tied head reads the embedding through self.gpt, so the weight
        # keeps its one state-dict key (gpt.word_embeddings.weight)
        logits = apply(_logits, h, self.gpt.word_embeddings.weight,
                       op_name="gpt_logits")
        if labels is None:
            return logits
        loss = apply(_lm_loss, logits, labels, op_name="gpt_lm_loss")
        return logits, loss

    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0):
        """Greedy (``temperature`` 0) or sampled decoding of
        ``max_new_tokens``, each step a forward over the last
        ``max_position_embeddings`` ids."""
        ids = input_ids
        limit = self.gpt.config.max_position_embeddings
        with torch.no_grad():
            for _ in range(max_new_tokens):
                window = ids if ids.shape[1] <= limit else ids[:, -limit:]
                last = self.forward(window)[:, -1]
                if temperature <= 0:
                    nxt = apply(lambda lv: torch.argmax(lv, -1)[:, None],
                                last, op_name="greedy_pick")
                else:
                    gen = default_generator(last.device).generator
                    nxt = apply(lambda lv: _sample(lv, temperature, top_k,
                                                   gen),
                                last, op_name="sample_pick")
                ids = Tensor(torch.cat([ids, nxt.to(ids.dtype)], dim=1))
        return ids


def _sample(lv, temperature, top_k, gen):
    lv = torch.div(lv, temperature)
    if top_k:
        kth = torch.sort(lv, -1).values[:, -top_k][:, None]
        lv = torch.where(torch.lt(lv, kth), float("-inf"), lv)
    u = torch.rand(lv.shape, generator=gen, device=lv.device,
                   dtype=torch.float32).clamp_min(1e-20)
    gumbel = torch.neg(torch.log(torch.neg(torch.log(u))))
    return torch.argmax(torch.add(lv, gumbel.to(lv.dtype)), -1)[:, None]


def load_paddle_tpu_state(model: nn.Module,
                          state: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``{name: np.ndarray}`` (the JAX model's ``state_dict()`` as
    numpy) into ``model`` by the same keys, onto its device and dtype. A
    missing key, an unexpected key or a shape mismatch raises."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: state shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            torch.Tensor.copy_(p, torch.from_numpy(
                np.ascontiguousarray(arr)).to(device=p.device,
                                              dtype=p.dtype))
    return model


def paddle_tpu_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's ``state_dict()`` as ``{name: np.ndarray}`` in float32,
    by the JAX keys."""
    return {name: t.detach().float().cpu().numpy().copy()
            for name, t in model.state_dict().items()}
