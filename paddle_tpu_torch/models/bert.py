"""BERT / ERNIE: counterpart of ``paddle_tpu/models/bert.py``.

Built from the port's ``nn`` layers: the word, position and token-type
``Embedding``s, ``LayerNorm`` and ``Dropout``; a ``TransformerEncoder``
of post-norm ``TransformerEncoderLayer``s (``hidden_act``) and the tanh
pooler. ``position_ids`` and the zero ``token_type_ids`` are built on the
input's device. With no ``attention_mask`` the pad ids give an additive
``-1e9`` mask ``[B, 1, 1, S]`` (the ``bert_pad_mask`` op), so attention
takes the plain ``sdpa_ref`` in both packages and no flash-attention
kernel runs. ``BertForPretraining``'s MLM head reads the word embedding
as a stashed, unregistered reference, so its one state-dict key stays
``bert.embeddings.word_embeddings.weight``; its activation is
``getattr(F, hidden_act)``. ``ErnieConfig``, ``ErnieModel`` and
``ErnieForSequenceClassification`` are the BERT classes, as there.
Every constructor takes a keyword-only ``device`` (default: the card);
``load_paddle_tpu_state`` / ``paddle_tpu_state`` (``models/gpt.py``)
carry weights by the JAX keys.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device
from ..core.tensor import Tensor
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..ops.dispatch import apply

__all__ = ["BertConfig", "ErnieConfig", "BertEmbeddings", "BertPooler",
           "BertModel", "BertForSequenceClassification",
           "BertLMPredictionHead", "BertForPretraining",
           "bert_pretraining_loss", "ErnieModel",
           "ErnieForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64, type_vocab_size=2)
        d.update(kw)
        return cls(**d)


# ERNIE shares the architecture; its configs differ (vocab, act).
ErnieConfig = BertConfig


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=dev)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, device=dev)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, device=dev)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, device=dev)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = Tensor(torch.arange(seq, device=dev)[None, :])
        if token_type_ids is None:
            token_type_ids = Tensor(torch.zeros_like(
                input_ids.as_subclass(torch.Tensor)))
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, device=dev)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            layer_norm_eps=cfg.layer_norm_eps, device=dev)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, device=dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            pad = self.config.pad_token_id
            attention_mask = apply(
                lambda ids: torch.where(torch.eq(ids, pad), -1e9, 0.0)[
                    :, None, None, :], input_ids, op_name="bert_pad_mask")
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, attention_mask)
        return seq_out, self.pooler(seq_out)


class BertForSequenceClassification(Layer):
    """The GLUE fine-tuning head: dropout and a linear layer over the
    pooled output."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, *,
                 device=None):
        super().__init__()
        self.bert = BertModel(cfg, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


class BertLMPredictionHead(Layer):
    def __init__(self, cfg: BertConfig, embedding_weights=None, *,
                 device=None):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, device=device)
        self.act = cfg.hidden_act
        # the tied [vocab, hidden] weight, stashed WITHOUT registering it
        # here: its state-dict key stays bert.embeddings.word_embeddings.weight
        object.__setattr__(self, "_tied", embedding_weights)
        self.decoder_bias = self.create_parameter([cfg.vocab_size],
                                                  device=device)

    def forward(self, hidden):
        h = self.layer_norm(getattr(F, self.act)(self.transform(hidden)))
        return apply(lambda hv, wv, b: torch.add(torch.matmul(hv, wv.t()), b),
                     h, self._tied, self.decoder_bias, op_name="mlm_logits")


class BertForPretraining(Layer):
    """The MLM and NSP heads (BertPretrainingCriterion's pairing)."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.bert = BertModel(cfg, device=device)
        self.cls = BertLMPredictionHead(
            cfg, self.bert.embeddings.word_embeddings.weight, device=device)
        self.nsp = Linear(cfg.hidden_size, 2, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        return self.cls(seq_out), self.nsp(pooled)


def _pretraining_loss(ml, nl, mlab, nlab, ignore_index):
    logp = torch.log_softmax(ml, -1)
    mask = torch.ne(mlab, ignore_index)
    lab = torch.where(mask, mlab, 0)
    nll = torch.neg(torch.gather(logp, -1, lab[..., None])[..., 0])
    mlm = torch.div(torch.sum(torch.mul(nll, mask)),
                    torch.clamp_min(torch.sum(mask), 1))
    nlogp = torch.log_softmax(nl, -1)
    nsp = torch.neg(torch.mean(torch.gather(nlogp, -1, nlab[:, None])))
    return torch.add(mlm, nsp)


def bert_pretraining_loss(mlm_logits, nsp_logits, masked_labels, nsp_labels,
                          ignore_index: int = -100):
    """The mean MLM cross entropy over the labelled positions plus the mean
    NSP cross entropy (BertPretrainingCriterion)."""
    return apply(_pretraining_loss, mlm_logits, nsp_logits, masked_labels,
                 nsp_labels, ignore_index, op_name="bert_pretraining_loss")


ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification
