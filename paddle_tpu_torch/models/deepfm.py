"""DeepFM: the FM and DNN towers over two row-sharded embedding tables.

Counterpart of ``paddle_tpu/models/deepfm.py:23-86`` (PaddleRec's
deepfm). Both tables are ``distributed.embedding.ShardedEmbedding``s:
with no mesh, or an extent of 1 on ``shard_axis``, they are the dense
``nn.Embedding``; on a live axis each rank holds its block of rows and a
lookup is the comms-routed exchange. The FM term and the DNN are torch
ops and cuBLAS products on the card.

``load_paddle_tpu_state`` / ``paddle_tpu_state`` carry the JAX model's
parameters across as numpy arrays, by the JAX names (``emb_first.weight``,
``dnn.0.weight``, ...): a row-sharded table takes (and gives back,
all-gathered over its axis) this rank's rows.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.embedding import ShardedEmbedding
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.container import LayerList
from ..nn.layer.layers import Layer

__all__ = ["DeepFM", "load_paddle_tpu_state", "paddle_tpu_state"]


class DeepFM(Layer):
    """``sparse_field_num`` categorical fields and ``dense_feature_dim``
    numeric features: ``forward(sparse_ids [B, F], dense [B, D]) -> logits
    [B, 1]``.

    ``shard_axis`` row-shards both tables over that mesh axis (``mesh``,
    default the installed one); ``hash_ids=True`` admits any id space by
    hash-bucketing into ``sparse_feature_number`` rows. Weights are drawn
    on ``device`` (default: the card) from a generator seeded with
    ``seed``, in the JAX model's order."""

    def __init__(self, sparse_feature_number: int, sparse_feature_dim: int = 9,
                 dense_feature_dim: int = 13, sparse_field_num: int = 26,
                 layer_sizes=(512, 256, 128), shard_axis: str = "dp",
                 hash_ids: bool = False, lookup_capacity=None, *,
                 device=None, dtype=torch.float32, seed: int = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.sparse_field_num = sparse_field_num
        self.dense_feature_dim = dense_feature_dim
        k = sparse_feature_dim
        self.emb_first = ShardedEmbedding(
            sparse_feature_number, 1, shard_axis=shard_axis,
            hash_ids=hash_ids, capacity=lookup_capacity, mesh=mesh, **kw)
        self.emb_factor = ShardedEmbedding(
            sparse_feature_number, k, shard_axis=shard_axis,
            hash_ids=hash_ids, capacity=lookup_capacity, mesh=mesh, **kw)
        self.dense_first = Linear(dense_feature_dim, 1, **kw)
        self.dense_factor = Linear(dense_feature_dim, dense_feature_dim * k,
                                   **kw)
        dnn_in = (sparse_field_num + dense_feature_dim) * k
        self.dnn = LayerList()
        sizes = [dnn_in] + list(layer_sizes)
        for i in range(len(layer_sizes)):
            self.dnn.append(Linear(sizes[i], sizes[i + 1], **kw))
        self.dnn_out = Linear(sizes[-1], 1, **kw)

    def forward(self, sparse_ids, dense):
        k = self.emb_factor.embedding_dim
        first_sparse = self.emb_first(sparse_ids)          # [B, F, 1]
        factors_sparse = self.emb_factor(sparse_ids)       # [B, F, k]
        first_dense = self.dense_first(dense)              # [B, 1]
        fd = self.dense_factor(dense)                      # [B, D*k]
        factors_dense = fd.reshape(dense.shape[0], self.dense_feature_dim, k)
        v = torch.cat([factors_sparse, factors_dense], dim=1)  # [B, F+D, k]
        # second order: 0.5 * (square of the sum - sum of squares), over k
        s = torch.sum(v, dim=1)
        second = 0.5 * torch.sum(s * s - torch.sum(v * v, dim=1), dim=-1,
                                 keepdim=True)
        fm_out = torch.sum(first_sparse, dim=1) + first_dense + second
        h = v.reshape(v.shape[0], -1)
        for lin in self.dnn:
            h = F.relu(lin(h))
        return fm_out + self.dnn_out(h)

    def predict(self, sparse_ids, dense):
        return F.sigmoid(self.forward(sparse_ids, dense))


def _row_block(p):
    """``(axis, rank, rows a rank)`` of a row-sharded table, else None."""
    axis = getattr(p, "row_sharded", None)
    if axis is None:
        return None
    lay = p.dist_layout
    n = int(lay.shape[0]) // int(p.shape[0])
    r = int(lay.index[0][0]) // int(p.shape[0])
    return axis, r, n


def load_paddle_tpu_state(model: nn.Module,
                          state: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``{name: np.ndarray}`` (the JAX model's ``named_parameters()``
    as numpy) into ``model``: a row-sharded table takes this rank's rows.
    A missing or unexpected key or a shape mismatch raises."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in own.items():
        arr = np.asarray(state[name])
        block = _row_block(p)
        if block is not None:
            _, r, n = block
            arr = np.split(arr, n, axis=0)[r]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: state shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=p.device, dtype=p.dtype))
    return model


def paddle_tpu_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as ``{name: np.ndarray}`` in float32 by the
    JAX names; a row-sharded table is all-gathered over its axis, so every
    rank of that axis must call this."""
    from ..distributed import comms
    meshes = {id(m.weight): m.mesh for m in model.modules()
              if isinstance(m, ShardedEmbedding)}
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        block = _row_block(p)
        if block is not None:
            parts = comms.wire_all_gather(t.contiguous(), block[0],
                                          exact=True, mesh=meshes[id(p)],
                                          owner="deepfm.paddle_tpu_state")
            t = torch.cat(parts.unbind(0), dim=0)
        out[name] = t.float().cpu().numpy().copy()
    return out
