"""Blockwise wire quantization for collectives (EQuARX, arxiv 2506.17615).

Counterpart of ``paddle_tpu/distributed/comms/quantize.py``: the same wire
format, in plain torch ops (XLA fuses this work in the JAX package; it has
no Pallas kernel)::

    payload  int8 / float8_e4m3fn, one value per element
    scales   float32, one per block of ``block`` consecutive elements
             (flat order, the payload zero-padded to whole blocks)

``wire_bytes`` counts what one pass of a quantized payload moves,
``logical_bytes`` what the full-precision one would.

Contracts (known-answer tests in tests/test_torch_comms.py, after
tests/test_comms.py):

- **all-zero block**: the scale is 1.0 and the block round-trips to exact
  zeros.
- **inf/nan guard**: the scale is taken over finite values only; ``nan``
  quantizes to 0 and ``+/-inf`` saturates to the block's finite absmax.
- **odd tail block**: a size that ``block`` does not divide is zero-padded
  for the blocked math and sliced back after dequantize, so the round trip
  keeps the shape.
- **stochastic rounding** (int8 only): ``uniform(-0.5, 0.5)`` noise before
  the rounding makes its error zero-mean. The noise comes from an explicit
  ``torch.Generator`` (the JAX function takes a key), so a seed repeats it.
  On fp8's uneven grid the noise would bias the rounding, so fp8 with
  stochastic rounding raises ``ValueError``.

Deterministic int8 and fp8 payloads and scales equal the JAX package's bit
for bit: the same fp32 operations in the same order, round half to even
(``torch.round`` as ``jnp.round``), and e4m3's round to nearest even on
the cast.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["DEFAULT_BLOCK", "WIRE_DTYPES", "n_blocks", "quantize_blockwise",
           "dequantize_blockwise", "wire_bytes", "logical_bytes"]

DEFAULT_BLOCK = 256
_INT8_MAX = 127.0          # symmetric: -128 stays unused
_FP8_MAX = 448.0           # float8_e4m3fn's largest finite value
WIRE_DTYPES = ("int8", "fp8")


def _wire_dtype(dtype: str) -> Tuple[torch.dtype, float]:
    if dtype == "int8":
        return torch.int8, _INT8_MAX
    if dtype == "fp8":
        return torch.float8_e4m3fn, _FP8_MAX
    raise ValueError(f"unknown wire dtype {dtype!r}; pick from {WIRE_DTYPES}")


def n_blocks(size: int, block: int = DEFAULT_BLOCK) -> int:
    return -(-int(size) // int(block))


def quantize_blockwise(x: torch.Tensor, dtype: str = "int8",
                       block: int = DEFAULT_BLOCK, stochastic: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payload [n_blocks * block], scales [n_blocks] fp32)`` for ``x``
    flattened; the caller keeps ``x.shape`` for ``dequantize_blockwise``.
    ``stochastic`` needs int8 and a ``generator`` on x's device."""
    wire, qmax = _wire_dtype(dtype)
    block = int(block)
    flat = x.reshape(-1).to(torch.float32)
    size = flat.shape[0]
    nb = n_blocks(size, block)
    pad = nb * block - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(nb, block)
    finite = torch.isfinite(blocks)
    absfin = torch.where(finite, blocks.abs(), torch.zeros_like(blocks))
    absmax = absfin.amax(dim=1, keepdim=True) if nb else \
        blocks.new_zeros(0, 1)
    scale = torch.where(absmax > 0.0, absmax / qmax, torch.ones_like(absmax))
    guarded = torch.where(torch.isnan(blocks), torch.zeros_like(blocks),
                          torch.clamp(blocks, -absmax, absmax))
    scaled = guarded / scale
    if stochastic:
        if wire != torch.int8:
            raise ValueError(
                "stochastic rounding is defined on int8's uniform grid "
                "only; fp8's non-uniform steps would turn the +/-0.5 noise "
                "into bias: use dtype='int8' with stochastic=True")
        if generator is None:
            raise ValueError("stochastic rounding needs an explicit "
                             "torch.Generator")
        noise = torch.rand(blocks.shape, generator=generator,
                           device=blocks.device, dtype=torch.float32) - 0.5
        scaled = scaled + noise
    if wire == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(wire)
    return q.reshape(nb * block), scale.reshape(nb)


def dequantize_blockwise(payload: torch.Tensor, scales: torch.Tensor,
                         shape: Sequence[int], dtype=torch.float32,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Payload and scales back to a tensor of ``shape`` in ``dtype`` (the
    tail padding sliced off)."""
    block = int(block)
    nb = scales.shape[0]
    vals = payload.to(torch.float32).reshape(nb, block) \
        * scales.reshape(nb, 1)
    size = 1
    for d in shape:
        size *= int(d)
    return vals.reshape(nb * block)[:size].reshape(tuple(shape)).to(dtype)


def wire_bytes(size: int, dtype: str = "int8",
               block: int = DEFAULT_BLOCK) -> int:
    """Bytes one pass of the quantized payload moves for ``size`` elements:
    one a value (int8 and fp8 alike) and four a block scale."""
    _wire_dtype(dtype)
    return int(size) + 4 * n_blocks(size, block)


def logical_bytes(size: int, itemsize: int = 4) -> int:
    """Bytes one pass of the full-precision payload would move."""
    return int(size) * int(itemsize)
