"""LLaMA causal LM for serving and training, in PyTorch.

Counterpart of ``paddle_tpu/models/llama.py`` (:42-977): the config, the
interleaved-pair RoPE, attention with and without a KV cache, the SwiGLU
MLP, the decoder stack, the lm head, the KV-cache steps the serving engine
drives, greedy/temperature ``generate``, ``compute_loss`` and the
dp, mp and sep legs of ``build_hybrid_train_step``. Layer and parameter
names match the JAX model's, so ``load_paddle_tpu_state`` carries its
weights across (sliced per rank for a tensor-parallel model).

Attention dispatch follows the JAX model's own conditions: a single-token
cached step (``s == 1``) in float32/bfloat16/float16 goes through
``ragged_decode_attention``, the decode kernel (llama.py:172); every other
cached step (prefill) takes the masked plain attention, as XLA does there;
the cache-free forward (training, ``generate(use_cache=False)``) goes
through ``F.scaled_dot_product_attention(is_causal=True)``, which is flash
attention: K2 forward, K3/K4 backward (llama.py:205, attention.py:66-68).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, resolve_device
from ..core.errors import NotInThisSlice
from ..distributed import comms
from ..distributed.fleet.meta_parallel.mp_layers import (
    AllGatherOp, ColumnParallelLinear, ParallelCrossEntropy, ReduceScatterOp,
    RowParallelLinear, ScatterOp, VocabParallelEmbedding, copy_to_mp,
    gather_from_mp, mark_as_sequence_parallel_parameter, mp_degree,
    reduce_from_mp)
from ..jit.capture import capture_step
from ..nn import functional as F
from ..nn.clip import ClipGradByGlobalNorm
from ..nn.layers import RMSNorm
from ..ops.kernels.decode_attention import ragged_decode_attention
from ..ops.kernels.fused_ce import fused_linear_cross_entropy
from ..ops.kernels.multi_tensor import multi_tensor_sumsq_finite
from ..parallel import mesh as mesh_mod
from ..parallel.context_parallel import sdpa_context_parallel
from ..parallel.trainer import LossSum, mp_global_sumsq

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "load_paddle_tpu_state",
           "paddle_tpu_state", "build_hybrid_train_step"]

KVCache = Tuple[torch.Tensor, torch.Tensor]
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    sequence_parallel: bool = False
    # long-context attention over the mesh's 'sep' axis: "ring" or
    # "ulysses" (parallel/context_parallel.py)
    context_parallel: Optional[str] = None
    recompute: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @staticmethod
    def llama_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, inter=128, seq=64):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=inter, num_hidden_layers=layers,
                           num_attention_heads=heads,
                           max_position_embeddings=seq)


def _offsets(position_offset, b: int, device) -> torch.Tensor:
    """A scalar or ``[B]`` offset as an int64 ``[B]`` tensor on device."""
    off = torch.as_tensor(position_offset, device=device).to(torch.int64)
    return off.reshape(-1).expand(b) if off.numel() == 1 else off.reshape(b)


def _rope(q, k, theta: float, position_offset=0):
    """Rotary embeddings on ``[B, S, H, D]`` over interleaved pairs
    ``x[..., 0::2]``, ``x[..., 1::2]`` with fp32 trig (llama.py:77-97).
    ``position_offset`` is a scalar or a ``[B]`` vector: one phase per
    slot in the serving engine's batch-slot decode."""
    b, s, h, d = q.shape
    dev = q.device
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=dev) / d))
    off = torch.as_tensor(position_offset, device=dev).to(torch.float32)
    pos = torch.arange(s, dtype=torch.float32, device=dev)[None, :] \
        + off.reshape(-1, 1)
    freqs = pos[:, :, None] * inv[None, None, :]          # [1|B, S, D/2]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]

    def rot(x):
        x1 = x[..., 0::2].float()
        x2 = x[..., 1::2].float()
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)
    return rot(q), rot(k)


def _mp_in(x, sp: bool, mesh):
    """A block's input for its column-parallel projections: gathered along
    the sequence under sequence parallelism (grad reduce-scattered), else
    copied to mp (grad all-reduced)."""
    return AllGatherOp.apply(x, 1, mesh) if sp else copy_to_mp(x, mesh)


def _mp_out(y, sp: bool, mesh):
    """A row-parallel projection's partial product, reduce-scattered along
    the sequence under sequence parallelism, else all-reduced."""
    return ReduceScatterOp.apply(y, 1, mesh) if sp else \
        reduce_from_mp(y, mesh)


class LlamaAttention(nn.Module):
    """q/k/v column-parallel and o row-parallel over the mesh's mp axis:
    each rank holds ``H / mp`` query and ``Hkv / mp`` kv heads (JAX
    llama.py:100-113); ``num_key_value_heads`` must divide by mp."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        mp, _ = mp_degree(mesh)
        h = config.hidden_size
        H, Hkv = config.num_attention_heads, config.num_key_value_heads
        if H % mp or Hkv % mp:
            raise ValueError(f"{H} query and {Hkv} kv heads do not split "
                             f"over mp={mp}")
        self.num_heads = H // mp
        self.num_kv_heads = Hkv // mp
        self.head_dim = h // H
        self.sp = bool(config.sequence_parallel) and mp > 1
        kv_out = Hkv * self.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator,
                  has_bias=False, mesh=mesh)
        self.q_proj = ColumnParallelLinear(h, h, gather_output=False, **kw)
        self.k_proj = ColumnParallelLinear(h, kv_out, gather_output=False,
                                           **kw)
        self.v_proj = ColumnParallelLinear(h, kv_out, gather_output=False,
                                           **kw)
        self.o_proj = RowParallelLinear(h, h, input_is_parallel=True, **kw)

    def forward(self, x, position_offset=0,
                kv_cache: Optional[KVCache] = None):
        x = _mp_in(x, self.sp, self.mesh)
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj.local(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj.local(x).reshape(b, s, self.num_kv_heads,
                                         self.head_dim)
        v = self.v_proj.local(x).reshape(b, s, self.num_kv_heads,
                                         self.head_dim)
        q, k = _rope(q, k, self.config.rope_theta, position_offset)
        if kv_cache is None:
            cp = self.config.context_parallel
            if cp:
                attn = sdpa_context_parallel(q, k, v, mesh=self.mesh,
                                             mode=cp, is_causal=True)
            else:
                attn = F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
            return _mp_out(self.o_proj.local(attn.reshape(b, s, -1)),
                           self.sp, self.mesh)
        k_cache, v_cache = kv_cache
        s_max = k_cache.shape[1]
        off = _offsets(position_offset, b, x.device)
        # Write the new K/V rows, then attend (llama.py:148-165). The JAX
        # step donated the caches and rebuilt them with dynamic_update_slice;
        # here they are updated in place. The start clamps to
        # [0, S_max - s] as dynamic_update_slice does.
        start = off.clamp(0, s_max - s)
        pos = start[:, None] + torch.arange(s, device=x.device)[None, :]
        rows = torch.arange(b, device=x.device)[:, None]
        k_cache[rows, pos] = k.to(k_cache.dtype)
        v_cache[rows, pos] = v.to(v_cache.dtype)
        if s == 1 and q.dtype in _KERNEL_DTYPES:
            # single-token decode: every slot attends exactly its own live
            # prefix, off + 1 rows (llama.py:172-187)
            lengths = (off + 1).to(torch.int32)
            attn = ragged_decode_attention(q, k_cache, v_cache, lengths)
        else:
            j = torch.arange(s_max, device=x.device)[None, None, :]
            i = torch.arange(s, device=x.device)[None, :, None] \
                + off.reshape(-1, 1, 1)
            mask = torch.where(j <= i, 0.0, -1e30)[:, None]  # [B,1,S,S_max]
            attn = F.sdpa_ref(q, k_cache, v_cache, mask=mask)
        return _mp_out(self.o_proj.local(attn.reshape(b, s, -1)), self.sp,
                       self.mesh)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.sp = bool(config.sequence_parallel) and mp_degree(mesh)[0] > 1
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator,
                  has_bias=False, mesh=mesh)
        self.gate_proj = ColumnParallelLinear(h, m, gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(h, m, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(m, h, input_is_parallel=True,
                                           **kw)

    def forward(self, x):
        x = _mp_in(x, self.sp, self.mesh)
        y = F.silu(self.gate_proj.local(x)) * self.up_proj.local(x)
        return _mp_out(self.down_proj.local(y), self.sp, self.mesh)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None, mesh=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype, generator,
                                        mesh)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device, dtype)
        self.mlp = LlamaMLP(config, device, dtype, generator, mesh)
        if self.self_attn.sp:
            mark_as_sequence_parallel_parameter(self.input_layernorm.weight)
            mark_as_sequence_parallel_parameter(
                self.post_attention_layernorm.weight)

    def forward(self, x, position_offset=0,
                kv_cache: Optional[KVCache] = None):
        h = x + self.self_attn(self.input_layernorm(x),
                               position_offset=position_offset,
                               kv_cache=kv_cache)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    """The decoder stack. ``config.recompute`` checkpoints each layer of the
    cache-free forward (``torch.utils.checkpoint``, as the reference's
    ``recompute``, llama.py:272-274). Over a mesh: the layers are
    tensor-parallel over mp; ``sequence_parallel`` keeps the activations
    between blocks split along the sequence over mp (Megatron-SP, JAX
    llama.py:232-244); ``context_parallel`` ("ring" or "ulysses") runs
    attention over the sequence chunks of the mesh's sep axis, each rank
    feeding its own chunk of ``input_ids`` at its RoPE positions."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.sp = bool(config.sequence_parallel) and mp_degree(mesh)[0] > 1
        if config.context_parallel not in (None, "ring", "ulysses"):
            raise ValueError(f"unknown context_parallel "
                             f"{config.context_parallel!r}")
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device, dtype, generator,
            mesh=mesh)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype, generator, mesh)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)
        if self.sp:
            mark_as_sequence_parallel_parameter(self.norm.weight)

    def cp_offset(self, local_len: int) -> int:
        """RoPE position of this rank's first token under context
        parallelism (its sep coordinate times the chunk length)."""
        if not self.config.context_parallel:
            return 0
        return mesh_mod.axis_index("sep", self.mesh) * int(local_len)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset=0):
        x = self.embed_tokens(input_ids)
        if self.sp:
            x = ScatterOp.apply(x, 1, self.mesh)
        if caches is None:
            off = self.cp_offset(input_ids.shape[1])
            for layer in self.layers:
                if self.config.recompute and torch.is_grad_enabled():
                    x = checkpoint(layer, x, off, use_reentrant=False)
                else:
                    x = layer(x, off)
        else:
            for layer, cache in zip(self.layers, caches):
                x = layer(x, position_offset=position_offset, kv_cache=cache)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``LlamaForCausalLM(cfg, device=None, dtype=torch.float32, seed=0,
    mesh=None)``.

    With no device it runs on ``cuda`` and raises when CUDA is absent;
    ``device="cpu"`` runs on the CPU. Weights are drawn from an explicit
    generator seeded with ``seed`` on that device (XavierNormal
    projections and embedding, ones for the norms); load the JAX model's
    weights with ``load_paddle_tpu_state``. The serving entry points
    (``forward``, the cached and slot steps, ``generate``) run under
    ``torch.inference_mode()``; ``logits`` and ``compute_loss`` build an
    autograd graph for training.

    ``mesh`` (default: the installed one, ``parallel.mesh.get_mesh()``)
    makes the model tensor-parallel over its mp axis: every rank holds its
    shard of each projection, of the embedding and of the head, drawn as
    slices of the weights the mp=1 model draws from the same seed.
    """

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 mesh=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        mesh = mesh if mesh is not None else mesh_mod.get_mesh()
        self.config = config
        self.mesh = mesh
        self.llama = LlamaModel(config, dev, dtype, gen, mesh)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, device=dev, dtype=dtype,
            generator=gen, has_bias=False, gather_output=True, mesh=mesh)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @torch.inference_mode()
    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset=0):
        """Logits ``[B, S, vocab]``; with ``caches`` (updated in place) the
        pair ``(logits, caches)``."""
        if caches is not None:
            h = self.llama(input_ids, caches=caches,
                           position_offset=position_offset)
            return self._head(h, gather=True), caches
        return self.logits(input_ids)

    def _head(self, h, gather: bool):
        """The lm head on the final hidden states: this rank's vocab shard
        of the logits, or (``gather``) all of them."""
        out = self.lm_head.local(_mp_in(h, self.llama.sp, self.mesh))
        return gather_from_mp(out, -1, self.mesh) if gather else out

    def logits(self, input_ids) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` of the cache-free forward, building an
        autograd graph (``forward`` runs under inference mode)."""
        return self._head(self.llama(input_ids), gather=True)

    def compute_loss(self, input_ids, labels) -> torch.Tensor:
        """Mean cross entropy of the logits against ``labels``
        (llama.py:296-299) over this rank's tokens; labels of -100 are
        ignored. Over mp the vocab-sharded logits go through
        ``ParallelCrossEntropy`` without being gathered."""
        if mp_degree(self.mesh)[0] == 1:
            return F.cross_entropy(self.logits(input_ids), labels,
                                   reduction="mean")
        rows = ParallelCrossEntropy(self.mesh)(
            self._head(self.llama(input_ids), gather=False), labels)
        valid = (labels != -100).sum().clamp_min(1)
        return rows.sum() / valid

    def loss_sum(self, input_ids, labels) -> LossSum:
        """``compute_loss`` as its two parts: the cross entropy summed over
        this rank's tokens and the count of labels that are not -100. A
        ``TrainStep`` over dp divides the sum by the count summed over the
        dp ranks: the mean over the global batch's valid tokens."""
        valid = (labels != -100).sum()
        if mp_degree(self.mesh)[0] == 1:
            total = F.cross_entropy(self.logits(input_ids), labels,
                                    reduction="sum")
        else:
            total = ParallelCrossEntropy(self.mesh)(
                self._head(self.llama(input_ids), gather=False),
                labels).sum()
        return LossSum(total, valid)

    @torch.inference_mode()
    def init_kv_caches(self, batch_size: int, max_len: int,
                       dtype: Optional[torch.dtype] = None) -> List[KVCache]:
        """Per-layer (k, v) caches ``[B, S_max, H_kv / mp, D]``, zeroed."""
        cfg = self.config
        d = cfg.hidden_size // cfg.num_attention_heads
        shape = (batch_size, max_len,
                 cfg.num_key_value_heads // mp_degree(self.mesh)[0], d)
        kw = dict(dtype=dtype or self.dtype, device=self.device)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(cfg.num_hidden_layers)]

    def _captured(self, name: str, impl):
        """The model's capture wrapper for one step kind, built once and
        stashed on the model (llama.py:285-306 stashes ``_slot_step`` and
        ``_verify_step``), so every engine and drafter over these weights
        shares its graphs. A graph reads the parameters by address: when
        one is replaced (``.to()``, a new ``.data``), the stash is
        rebuilt."""
        stash = self.__dict__.get(name)
        if stash is None or any(p.data_ptr() != ptr
                                for p, ptr in zip(*stash[:2])):
            plist = list(self.parameters())
            stash = (plist, [p.data_ptr() for p in plist],
                     capture_step(impl, inplace=(1,), name=f"llama{name}"))
            self.__dict__[name] = stash
        return stash[2]

    def captured_step(self, name: str):
        """The capture wrapper of one step kind (``"_decode_step"``,
        ``"_slot_step"``, ``"_slot_step_logits"``, ``"_verify_step"``), or
        None before that step's first call."""
        stash = self.__dict__.get(name)
        return None if stash is None else stash[2]

    def cached_step(self, tok, caches: List[KVCache], off) -> torch.Tensor:
        """One prefill (``[B, P]``) or decode (``[B, 1]``) step at a scalar
        offset; returns the last position's logits ``[B, vocab]``
        (llama.py:310-343). Captured per signature (``jit.capture``): give
        the offset as a tensor, a Python int makes one graph per value."""
        return self._captured("_decode_step", self._cached_step)(
            tok, caches, off)

    @torch.inference_mode()
    def _cached_step(self, tok, caches, off):
        logits, _ = self.forward(tok, caches=caches, position_offset=off)
        return logits[:, -1, :]

    def slot_step(self, tok, caches: List[KVCache], off, last_pos,
                  return_logits: bool = False):
        """Batch-slot serving step (llama.py:345-391): ``off`` is a ``[B]``
        int32 vector (each slot at its own position) and ``last_pos``
        selects each slot's last real token (bucketed prefill pads on the
        right). Returns the greedy next token per slot, ``[B]`` int32 on
        the device (``torch.argmax`` takes the first maximum, as
        ``np.argmax`` does); with ``return_logits`` also the last-token
        logits rows ``[B, vocab]`` for host-side sampling. Captured per
        signature: on the card a replay's outputs are the graph's buffers,
        valid until the next call."""
        if return_logits:
            step = self._captured("_slot_step_logits", self._slot_last)
        else:
            step = self._captured("_slot_step", self._slot_greedy)
        return step(tok, caches, off, last_pos)

    @torch.inference_mode()
    def _slot_last(self, tok, caches, off, last_pos):
        logits, _ = self.forward(tok, caches=caches, position_offset=off)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      last_pos.to(torch.int64)]
        return torch.argmax(last, dim=-1).to(torch.int32), last

    def _slot_greedy(self, tok, caches, off, last_pos):
        return self._slot_last(tok, caches, off, last_pos)[0]

    def verify_step(self, tok, caches: List[KVCache], off) -> torch.Tensor:
        """Speculative-verify / prefill-window step (llama.py:393-437):
        scores a ``[B, W]`` window per slot at the slot's write cursor
        ``off`` ``[B]``; window position i attends positions
        ``<= off[b] + i``, so its argmax is the token a sequential decode
        would emit there. Returns the per-position greedy argmax ``[B, W]``
        int32. Captured per signature, like ``slot_step``."""
        return self._captured("_verify_step", self._verify)(tok, caches, off)

    @torch.inference_mode()
    def _verify(self, tok, caches, off):
        logits, _ = self.forward(tok, caches=caches, position_offset=off)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 0.0, use_cache: bool = True,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy / temperature sampling (llama.py:439-499).

        ``use_cache=True`` prefills once, then decodes one token per step
        through the KV caches; ``use_cache=False`` recomputes the whole
        sequence every step. With ``eos_token_id`` each row stops at its
        first EOS (kept), then emits ``pad_token_id`` (default: the EOS id),
        and the loop ends once every row has finished."""
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids,
            device=self.device).to(torch.int64)
        finished = None
        if eos_token_id is not None:
            finished = np.zeros(int(ids.shape[0]), dtype=bool)
            pad_id = eos_token_id if pad_token_id is None else pad_token_id

        def mask_eos(nxt):
            if finished is None:
                return nxt, False
            row = nxt.reshape(-1).cpu().numpy()
            emitted = np.where(finished, pad_id, row)
            finished[:] = finished | (emitted == eos_token_id)
            return (torch.as_tensor(emitted.reshape(-1, 1),
                                    device=self.device),
                    bool(finished.all()))

        if use_cache:
            b, p_len = ids.shape
            caches = self.init_kv_caches(b, p_len + max_new_tokens)
            # the offset rides a device tensor: one decode signature for
            # every position (a Python int would be one per value)
            off = torch.zeros((), dtype=torch.int64, device=self.device)
            last = self.cached_step(ids, caches, off)
            for t in range(max_new_tokens):
                nxt, done = mask_eos(self._sample(last, temperature,
                                                  generator))
                ids = torch.cat([ids, nxt.to(ids.dtype)], dim=1)
                if done or t == max_new_tokens - 1:
                    break
                off.fill_(p_len + t)
                last = self.cached_step(nxt, caches, off)
            return ids
        for _ in range(max_new_tokens):
            logits = self.forward(ids)
            nxt, done = mask_eos(self._sample(logits[:, -1, :], temperature,
                                              generator))
            ids = torch.cat([ids, nxt.to(ids.dtype)], dim=1)
            if done:
                break
        return ids

    @staticmethod
    def _sample(last, temperature, generator):
        if temperature and temperature > 0.0:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return torch.argmax(last, dim=-1, keepdim=True)


def load_paddle_tpu_state(model: nn.Module,
                          state: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``{name: np.ndarray}`` (as ``{n: np.asarray(p._value) for n, p
    in jax_model.named_parameters()}`` gives it) into the port model, onto
    its device and dtype. Names and ``[in, out]`` shapes match by
    construction; a tensor-parallel parameter (``split_axis`` set) takes
    this rank's slice of the full array. A missing key, an unexpected key
    or a shape mismatch raises."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in own.items():
        arr = np.asarray(state[name])
        split = getattr(p, "split_axis", None)
        if split is not None:
            n, r = mp_degree(getattr(model, "mesh", None))
            if arr.ndim <= split or arr.shape[split] != p.shape[split] * n:
                raise ValueError(f"{name}: state shape {tuple(arr.shape)} "
                                 f"does not split into {tuple(p.shape)} over "
                                 f"mp={n}")
            arr = np.split(arr, n, axis=split)[r]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: state shape {tuple(arr.shape)} != "
                             f"model shape {tuple(p.shape)}")
        if arr.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            arr = arr.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.tensor(np.ascontiguousarray(arr), device=p.device,
                                 dtype=p.dtype))
    return model


def paddle_tpu_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The other direction of ``load_paddle_tpu_state``: the model's
    parameters as ``{name: np.ndarray}`` in float32, keyed as the JAX
    model's ``named_parameters()``. A tensor-parallel parameter is
    all-gathered over mp first, so every rank of the mp group must call
    this."""
    out = {}
    mesh = getattr(model, "mesh", None)
    for n, p in model.named_parameters():
        t = p.detach()
        split = getattr(p, "split_axis", None)
        if split is not None:
            parts = comms.wire_all_gather(t.contiguous(), "mp", exact=True,
                                          mesh=mesh,
                                          owner="llama.paddle_tpu_state")
            t = torch.cat(parts.unbind(0), dim=split)
        out[n] = t.float().cpu().numpy()
    return out


def _mesh_axes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def _check_mesh(mesh, optimizer) -> Dict[str, int]:
    """The axes above 1 of a mesh the step runs on; pipeline and ZeRO axes
    raise NotInThisSlice."""
    big = {k: v for k, v in _mesh_axes(mesh).items() if v > 1}
    later = {k: v for k, v in big.items() if k not in ("dp", "mp", "sep")}
    if later:
        raise NotInThisSlice("pipeline parallelism and ZeRO (multi-GPU "
                             "training, part 2)", f"mesh={later}")
    if int(getattr(optimizer, "_shard_stage", 0) or 0) >= 1:
        raise NotInThisSlice("ZeRO optimizer-state sharding (multi-GPU "
                             "training, part 2)",
                             f"stage={optimizer._shard_stage}")
    if big and not isinstance(mesh, mesh_mod.DeviceMesh):
        raise TypeError(f"a mesh with axes above 1 ({big}) must be a "
                        "DeviceMesh (parallel.init_mesh)")
    return big


def build_hybrid_train_step(model: LlamaForCausalLM, optimizer, mesh=None,
                            n_microbatches: int = 1, remat: bool = True,
                            amp: bool = False, schedule: str = "1f1b",
                            n_virtual: int = 1,
                            accumulate_steps: Optional[int] = None,
                            fused_loss: bool = False):
    """The dp, mp and sep legs of ``build_hybrid_train_step``
    (llama.py:534-977): ``step(batch_dict) -> loss`` over the GLOBAL batch
    ``{"input_ids": [B, S], "labels": [B, S]}`` (numpy or tensors), which
    every rank passes; each keeps its rows of the dp axis and its sequence
    chunk of the sep axis.

    Per step: embedding, the decoder blocks (each under
    ``torch.utils.checkpoint`` when ``remat``, as ``jax.checkpoint`` wraps
    the scanned block), the final norm, the lm head and the cross entropy
    (``_head_ce``, :587-608; logits in fp32 under amp); then backward. With
    ``amp`` every floating parameter is cast to bfloat16 inside the step
    by a differentiable cast (``_amp_cast``, :666-671) and the embedding
    output is bfloat16, so grads land on the fp32 masters;
    ``torch.autocast`` is not used (its cast lists differ).
    ``fused_loss=True`` replaces the lm head and the loss by
    ``fused_linear_cross_entropy`` (:584-603: kernels K5-K7) over the rows
    whose label is not -100; as in the JAX step it is off when mp > 1.
    ``accumulate_steps > 1`` splits the global batch into micro-batches
    (then each over dp) and takes the mean loss and the mean grads
    (:857-880), syncing the grads once per step.

    Over a mesh (``mesh``, default the installed one; the model must have
    been built on it): the model's layers are tensor-parallel over mp (the
    head's loss is ``ParallelCrossEntropy`` on the vocab-sharded logits);
    the loss is the mean over the global batch's valid tokens, as the JAX
    step's: each rank divides its tokens' loss sum by the valid count
    all-reduced over dp and sep, and the grads are SUMMED over dp and sep
    (``comms.grad_sync``: one exact all-reduce per dtype, or the quantized
    two-shot per grad inside ``comms.quantized()``, read at every call);
    under sequence parallelism the norms' grads (computed on sequence
    shards) are summed over mp. A ``ClipGradByGlobalNorm`` clip takes the
    global norm over the synced grads: one U1 launch gives every grad's
    sum of squares, the sharded ones' are all-reduced over mp and the
    replicated ones (the norms) counted once (:888-897; any other clip is
    not honoured, as there). Then the optimizer's ``_multi_update``
    updates every local shard in place (for Adam and AdamW one kernel
    launch on the card, U2), weight decay included on norms and
    embeddings, with the step counted from 1 and the lr read by
    ``get_lr()`` every step (:898-926).

    The step trains the model's own parameters in place, so they are the
    fp32 masters and ``step.write_back()`` has nothing to copy (the JAX
    step holds donated copies and needs it); ``step.state`` holds
    ``params`` (name -> parameter), ``opt`` (name -> moments) and
    ``step``. A mesh with a pipeline or ZeRO axis above 1, or a ZeRO
    optimizer, waits for part 2 of the multi-GPU slice and raises
    ``NotInThisSlice``; the pipeline arguments (``n_microbatches``,
    ``schedule``, ``n_virtual``) have nothing to schedule without one.
    """
    if schedule not in ("gpipe", "1f1b", "1f1b_fused", "1f1b_compact",
                        "vpp"):
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         "(gpipe | 1f1b | 1f1b_compact | vpp)")
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    big = _check_mesh(mesh, optimizer)
    mp = big.get("mp", 1)
    if big and getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model was not built on this mesh: build it "
                         "with LlamaForCausalLM(..., mesh=mesh)")
    if big.get("sep", 1) > 1 and not model.config.context_parallel:
        raise ValueError("a sep axis above 1 needs "
                         "LlamaConfig.context_parallel ('ring' or "
                         "'ulysses')")
    data_axes = tuple(a for a in ("dp", "sep") if a in big)
    if accumulate_steps is None:
        accumulate_steps = int(getattr(optimizer, "_accumulate_steps", 1)
                               or 1)
    use_fused_loss = fused_loss and mp <= 1
    from torch.func import functional_call
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from ..distributed.parallel import shard_batch

    params = dict(model.named_parameters())
    plist = list(params.values())
    layers = list(model.llama.layers)
    layer_names = [[n for n, _ in layer.named_parameters()]
                   for layer in layers]
    sp_params = [i for i, p in enumerate(plist)
                 if getattr(p, "sequence_parallel", False)]
    sharded = [getattr(p, "split_axis", None) is not None for p in plist]
    state = {"params": params,
             "opt": {n: optimizer._init_state(p) for n, p in params.items()},
             "step": 0}
    pce = ParallelCrossEntropy(mesh)

    def cast(p):
        return p.to(torch.bfloat16) if amp and p.is_floating_point() else p

    def block(i, x, off, *vals):
        return functional_call(layers[i], dict(zip(layer_names[i], vals)),
                               (x, off))

    def loss_sum(ids, labels):
        """This rank's tokens' summed loss (ignored labels add 0)."""
        vals = {n: cast(p) for n, p in params.items()}
        x = model.llama.embed_tokens(ids,
                                     vals["llama.embed_tokens.weight"])
        if amp:
            x = x.to(torch.bfloat16)
        if model.llama.sp:
            x = ScatterOp.apply(x, 1, mesh)
        off = model.llama.cp_offset(ids.shape[1])
        for i in range(len(layers)):
            lv = [vals[f"llama.layers.{i}.{n}"] for n in layer_names[i]]
            if remat:
                x = checkpoint(block, i, x, off, *lv, use_reentrant=False)
            else:
                x = block(i, x, off, *lv)
        h = F.rms_norm(x, vals["llama.norm.weight"], model.llama.norm.epsilon)
        if use_fused_loss:
            flat = labels.reshape(-1)
            valid = flat != -100
            losses = fused_linear_cross_entropy(
                h.reshape(-1, h.shape[-1]), vals["lm_head.weight"],
                torch.where(valid, flat, 0))
            return (losses * valid.to(losses.dtype)).sum()
        logits = model.lm_head.local(_mp_in(h, model.llama.sp, mesh),
                                     vals["lm_head.weight"])
        if amp:       # softmax / CE in fp32 for numeric stability
            logits = logits.float()
        if mp > 1:
            return pce(logits, labels).sum()
        return F.cross_entropy(logits, labels, reduction="sum")

    def as_ids(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(device=model.device, dtype=torch.int64)

    def local(t):
        t = shard_batch(t, "dp", 0, mesh)
        return shard_batch(t, "sep", 1, mesh)

    def step(batch):
        ids, labels = as_ids(batch["input_ids"]), as_ids(batch["labels"])
        state["step"] += 1
        lr = optimizer.get_lr()
        for p in plist:
            p.grad = None
        k = accumulate_steps
        micro = [(local(a), local(b)) for a, b in zip(ids.chunk(k),
                                                      labels.chunk(k))]
        counts = torch.stack([(lab != -100).sum() for _, lab in micro])
        counts = comms.wire_all_reduce(counts, data_axes or None, "sum",
                                       exact=True, mesh=mesh,
                                       owner="llama.valid_tokens") \
            if data_axes else counts
        counts = counts.to(torch.float32).clamp_min(1.0)
        total = torch.zeros((), device=model.device)
        with set_checkpoint_early_stop(not big):
            for (mi, ml), cnt in zip(micro, counts):
                loss = loss_sum(mi, ml) / cnt
                loss.backward()
                total = total + loss.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in plist]
        if k > 1:
            total = total / k
            grads = [g / k for g in grads]
        if data_axes:
            total = comms.wire_all_reduce(total, data_axes, "sum",
                                          exact=True, mesh=mesh,
                                          owner="llama.loss")
            grads = comms.grad_sync(grads, mesh, data_axes, op="sum")
        if sp_params:
            red = comms.grad_sync([grads[i] for i in sp_params], mesh, "mp",
                                  op="sum", exact=True,
                                  owner="llama.sequence_parallel.grad")
            for i, g in zip(sp_params, red):
                grads[i] = g
        clip = getattr(optimizer, "_grad_clip", None)
        scale = None
        if isinstance(clip, ClipGradByGlobalNorm):
            sums, sumsq, _ = multi_tensor_sumsq_finite(grads)
            if mp > 1:
                sumsq = mp_global_sumsq(sums, sharded, mesh)
            scale = clip.scale_from_sumsq(sumsq)
        optimizer._multi_update(plist, grads, list(state["opt"].values()),
                                lr, state["step"], clip_scale=scale)
        for p in plist:
            p.grad = None
        return total

    step.state = state
    step.write_back = lambda: model
    return step
