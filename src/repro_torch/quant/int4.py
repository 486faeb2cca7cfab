"""INT4 KV quantization, bit-exact with ``repro.quant.int4``: two nibbles
packed per int8 byte along head_dim.

The tiered cache's coldest storage format: symmetric 4-bit values with one
f32 scale per (batch, head, position) row, the scale shape of the int8 path
``(..., S, 1)``. A ``(..., S, hd)`` tier is stored as a ``(..., S, hd // 2)``
int8 container plus the scales.

Packing layout: byte ``i`` holds element ``2i`` in the low nibble and
``2i + 1`` in the high nibble, each as a two's-complement 4-bit value in
[-8, 7]; the quantizer clips to ±7 so the grid is symmetric. The bit work
runs on ``uint8`` views of the bytes (no shift ever sees a sign bit).
Bit-exactness with the reference rests on the choices ``quant/int8.py``
keeps: exact divisions (a device tensor divisor, also for ``amax / 7``),
round-half-to-even and the all-zero-row scale of 1.0.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.quant.int8 import divisor

_QMAX = 7


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``(..., 2n)`` int8 values in [-8, 7] -> ``(..., n)`` int8 container,
    byte i = (q[2i] & 0xF) | (q[2i+1] << 4)."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got "
                         f"{tuple(q.shape)}")
    u = q.to(torch.int8).view(torch.uint8)
    return ((u[..., 0::2] & 0x0F) | ((u[..., 1::2] & 0x0F) << 4)) \
        .view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: ``(..., n)`` int8 -> ``(..., 2n)`` int8,
    each nibble sign-extended to [-8, 7] as ``(x ^ 8) - 8``."""
    u = packed.to(torch.int8).view(torch.uint8)
    pair = torch.stack([u & 0x0F, u >> 4], dim=-1).view(torch.int8)
    return ((pair ^ 8) - 8).reshape(*packed.shape[:-1],
                                    packed.shape[-1] * 2)


def quantize_kv_int4(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv: (..., head_dim) -> (packed int8 (..., head_dim // 2), f32 scales
    (..., 1)). All-zero rows take scale 1.0."""
    kf = kv.to(torch.float32)
    amax = torch.amax(kf.abs(), dim=-1, keepdim=True)
    qmax = divisor(float(_QMAX), amax)
    scale = torch.where(amax > 0.0, torch.clamp_min(amax, 1e-8),
                        qmax) / qmax
    q = torch.clamp(torch.round(kf / scale), -_QMAX, _QMAX).to(torch.int8)
    return pack_int4(q), scale


def dequantize_kv_int4(packed: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(..., head_dim // 2) int8 + (..., 1) f32 -> (..., head_dim) values."""
    return (unpack_int4(packed).to(torch.float32) * scale).to(dtype)
