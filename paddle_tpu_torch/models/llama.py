"""LLaMA causal LM for serving and training, in PyTorch.

Counterpart of ``paddle_tpu/models/llama.py`` (:42-977): the config, the
interleaved-pair RoPE, attention with and without a KV cache, the SwiGLU
MLP, the decoder stack, the lm head, the KV-cache steps the serving engine
drives, greedy/temperature ``generate``, ``compute_loss`` and the
single-device leg of ``build_hybrid_train_step``. Layer and parameter
names match the JAX model's, so ``load_paddle_tpu_state`` carries its
weights across unchanged.

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
from ..jit.capture import capture_step
from ..nn import functional as F
from ..nn.clip import ClipGradByGlobalNorm
from ..nn.layers import (ColumnParallelLinear, RMSNorm, RowParallelLinear,
                         VocabParallelEmbedding)
from ..ops.kernels.decode_attention import ragged_decode_attention
from ..ops.kernels.fused_ce import fused_linear_cross_entropy

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
    # long-context attention over a mesh axis ("ring" or "ulysses"); with
    # sequence_parallel it waits for the multi-GPU slice (ROADMAP.md)
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


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        kv_out = self.num_kv_heads * self.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = ColumnParallelLinear(h, h, **kw)
        self.k_proj = ColumnParallelLinear(h, kv_out, **kw)
        self.v_proj = ColumnParallelLinear(h, kv_out, **kw)
        self.o_proj = RowParallelLinear(h, h, **kw)

    def forward(self, x, position_offset=0,
                kv_cache: Optional[KVCache] = None):
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = _rope(q, k, self.config.rope_theta, position_offset)
        if kv_cache is None:
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.o_proj(attn.reshape(b, s, -1))
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
        return self.o_proj(attn.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate_proj = ColumnParallelLinear(h, m, **kw)
        self.up_proj = ColumnParallelLinear(h, m, **kw)
        self.down_proj = RowParallelLinear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype, generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device, dtype)
        self.mlp = LlamaMLP(config, device, dtype, generator)

    def forward(self, x, position_offset=0,
                kv_cache: Optional[KVCache] = None):
        h = x + self.self_attn(self.input_layernorm(x),
                               position_offset=position_offset,
                               kv_cache=kv_cache)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    """The decoder stack. ``config.recompute`` checkpoints each layer of the
    cache-free forward (``torch.utils.checkpoint``, as the reference's
    ``recompute``, llama.py:272-274); ``sequence_parallel`` and
    ``context_parallel`` shard over a mesh and raise ``NotInThisSlice``."""

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        for knob in ("sequence_parallel", "context_parallel"):
            if getattr(config, knob):
                raise NotInThisSlice("sequence/context-parallel LLaMA",
                                     f"{knob}={getattr(config, knob)!r}")
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device, dtype, generator)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype, generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)

    def forward(self, input_ids, caches: Optional[List[KVCache]] = None,
                position_offset=0):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                if self.config.recompute and torch.is_grad_enabled():
                    x = checkpoint(layer, x, use_reentrant=False)
                else:
                    x = layer(x)
        else:
            for layer, cache in zip(self.layers, caches):
                x = layer(x, position_offset=position_offset, kv_cache=cache)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``LlamaForCausalLM(cfg, device=None, dtype=torch.float32, seed=0)``.

    With no device it runs on ``cuda`` and raises when CUDA is absent;
    ``device="cpu"`` runs on the CPU. Weights are drawn from an explicit
    generator seeded with ``seed`` on that device (XavierNormal
    projections and embedding, ones for the norms); load the JAX model's
    weights with ``load_paddle_tpu_state``. The serving entry points
    (``forward``, the cached and slot steps, ``generate``) run under
    ``torch.inference_mode()``; ``logits`` and ``compute_loss`` build an
    autograd graph for training.
    """

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.config = config
        self.llama = LlamaModel(config, dev, dtype, gen)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, device=dev, dtype=dtype,
            generator=gen)

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
            return self.lm_head(h), caches
        return self.logits(input_ids)

    def logits(self, input_ids) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` of the cache-free forward, building an
        autograd graph (``forward`` runs under inference mode)."""
        return self.lm_head(self.llama(input_ids))

    def compute_loss(self, input_ids, labels) -> torch.Tensor:
        """Mean cross entropy of the logits against ``labels``
        (llama.py:296-299); labels of -100 are ignored."""
        return F.cross_entropy(self.logits(input_ids), labels,
                               reduction="mean")

    @torch.inference_mode()
    def init_kv_caches(self, batch_size: int, max_len: int,
                       dtype: Optional[torch.dtype] = None) -> List[KVCache]:
        """Per-layer (k, v) caches ``[B, S_max, H_kv, D]``, zeroed."""
        cfg = self.config
        d = cfg.hidden_size // cfg.num_attention_heads
        shape = (batch_size, max_len, cfg.num_key_value_heads, d)
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
    construction; a missing key, an unexpected key or a shape mismatch
    raises."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: state shape {tuple(arr.shape)} != "
                             f"model shape {tuple(p.shape)}")
        if arr.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            arr = arr.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.tensor(arr, device=p.device, dtype=p.dtype))
    return model


def paddle_tpu_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The other direction of ``load_paddle_tpu_state``: the model's
    parameters as ``{name: np.ndarray}`` in float32, keyed as the JAX
    model's ``named_parameters()``."""
    return {n: p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()}


def _mesh_axes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    shape = getattr(mesh, "shape", mesh)
    return {str(k): int(v) for k, v in dict(shape).items()}


def build_hybrid_train_step(model: LlamaForCausalLM, optimizer, mesh=None,
                            n_microbatches: int = 1, remat: bool = True,
                            amp: bool = False, schedule: str = "1f1b",
                            n_virtual: int = 1,
                            accumulate_steps: Optional[int] = None,
                            fused_loss: bool = False):
    """The single-device leg of ``build_hybrid_train_step``
    (llama.py:534-977): ``step(batch_dict) -> loss`` over
    ``{"input_ids": [B, S], "labels": [B, S]}`` (numpy or tensors).

    Per step: embedding, the decoder blocks (each under
    ``torch.utils.checkpoint`` when ``remat``, as ``jax.checkpoint`` wraps
    the scanned block), the final norm, the lm head and the mean cross
    entropy (``_head_ce``, :587-608; logits in fp32 under amp); then
    backward. With ``amp`` every floating parameter is cast to bfloat16
    inside the step by a differentiable cast (``_amp_cast``, :666-671) and
    the embedding output is bfloat16, so grads land on the fp32 masters;
    ``torch.autocast`` is not used (its cast lists differ).
    ``fused_loss=True`` replaces the lm head and the loss by
    ``fused_linear_cross_entropy`` (:584-603: kernels K5-K7; the logits
    stay unrounded fp32 sums, where the unfused leg rounds them to bf16
    under amp), over the rows whose label is not -100.
    ``accumulate_steps > 1`` splits the batch into micro-steps and takes the
    mean loss and mean grads (:857-880). A ``ClipGradByGlobalNorm`` grad
    clip is honoured, any other is not (:888-897): its norm is one pass
    over every grad (kernel U1 on the card) and its scale stays on the
    device. Then the optimizer's ``_multi_update`` updates every parameter
    in place (for Adam and AdamW one kernel launch on the card, U2),
    weight decay included on norms and embeddings, with the step counted
    from 1 and the lr read by ``get_lr()`` every step, so an
    ``LRScheduler`` works here (:898-926).

    The step trains the model's own parameters in place, so they are the
    fp32 masters and ``step.write_back()`` has nothing to copy (the JAX
    step holds donated copies and needs it); ``step.state`` holds
    ``params`` (name -> parameter), ``opt`` (name -> moments) and
    ``step``. A mesh with an axis above 1 (hybrid parallelism, pipeline
    schedules, the vocab-parallel fused loss) waits for a later slice and
    raises ``NotInThisSlice``.
    """
    if schedule not in ("gpipe", "1f1b", "1f1b_fused", "1f1b_compact",
                        "vpp"):
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         "(gpipe | 1f1b | 1f1b_compact | vpp)")
    big = {k: v for k, v in _mesh_axes(mesh).items() if v > 1}
    if big:
        raise NotInThisSlice("hybrid-parallel train step (mesh axes > 1, "
                             "pipeline schedules)", f"mesh={big}")
    if accumulate_steps is None:
        accumulate_steps = int(getattr(optimizer, "_accumulate_steps", 1)
                               or 1)
    from torch.func import functional_call

    params = dict(model.named_parameters())
    layers = list(model.llama.layers)
    layer_names = [[n for n, _ in layer.named_parameters()]
                   for layer in layers]
    state = {"params": params,
             "opt": {n: optimizer._init_state(p) for n, p in params.items()},
             "step": 0}

    def cast(p):
        return p.to(torch.bfloat16) if amp and p.is_floating_point() else p

    def block(i, x, *vals):
        return functional_call(layers[i], dict(zip(layer_names[i], vals)),
                               (x,))

    def loss_fn(ids, labels):
        vals = {n: cast(p) for n, p in params.items()}
        x = F.embedding(ids, vals["llama.embed_tokens.weight"])
        if amp:
            x = x.to(torch.bfloat16)
        for i in range(len(layers)):
            lv = [vals[f"llama.layers.{i}.{n}"] for n in layer_names[i]]
            if remat:
                x = checkpoint(block, i, x, *lv, use_reentrant=False)
            else:
                x = block(i, x, *lv)
        h = F.rms_norm(x, vals["llama.norm.weight"], model.llama.norm.epsilon)
        if fused_loss:
            # ignore_index (-100) rows add nothing; the mean divides by the
            # valid count only (F.cross_entropy's semantics)
            flat = labels.reshape(-1)
            valid = flat != -100
            losses = fused_linear_cross_entropy(
                h.reshape(-1, h.shape[-1]), vals["lm_head.weight"],
                torch.where(valid, flat, 0))
            vf = valid.to(losses.dtype)
            return (losses * vf).sum() / vf.sum().clamp_min(1.0)
        logits = F.linear(h, vals["lm_head.weight"])
        if amp:       # softmax / CE in fp32 for numeric stability
            logits = logits.float()
        return F.cross_entropy(logits, labels, reduction="mean")

    def as_ids(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(device=model.device, dtype=torch.int64)

    def step(batch):
        ids, labels = as_ids(batch["input_ids"]), as_ids(batch["labels"])
        state["step"] += 1
        lr = optimizer.get_lr()
        for p in params.values():
            p.grad = None
        k = accumulate_steps
        if k > 1:
            total = torch.zeros((), device=model.device)
            for mi, ml in zip(ids.chunk(k), labels.chunk(k)):
                loss = loss_fn(mi, ml)
                loss.backward()
                total = total + loss.detach()
            loss = total / k
            for p in params.values():
                p.grad.div_(k)
        else:
            loss = loss_fn(ids, labels)
            loss.backward()
        grads = [p.grad for p in params.values()]
        clip = getattr(optimizer, "_grad_clip", None)
        scale = clip.scale(grads) \
            if isinstance(clip, ClipGradByGlobalNorm) else None
        optimizer._multi_update(list(params.values()), grads,
                                list(state["opt"].values()), lr,
                                state["step"], clip_scale=scale)
        for p in params.values():
            p.grad = None
        return loss.detach()

    step.state = state
    step.write_back = lambda: model
    return step
