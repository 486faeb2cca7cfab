"""INT8 quantization, bit-exact with ``repro.quant.int8``.

Symmetric per-channel scales. Bit-exactness rests on three choices kept
from the reference: the divisions ``amax / 127`` and ``x / scale`` (never a
multiply by the reciprocal), round-half-to-even (``torch.round`` and
``jnp.round`` agree), and the all-zero-row KV scale of 1.0. A float divisor
is given as a 0-d tensor on the operand's device (``divisor``): on CUDA,
PyTorch divides by a Python scalar as a multiply by its reciprocal, one ulp
away in some scales.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

_DIVISORS = {}


def divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device, filled once per
    (device, value) and reused. A device tensor divisor divides exactly;
    only a Python (or CPU) scalar becomes a reciprocal multiply on CUDA."""
    key = (like.device, value)
    t = _DIVISORS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.full((), value, dtype=torch.float32,
                           device=like.device)
        _DIVISORS[key] = t
    return t


@dataclass
class QuantizedTensor:
    """int8 values + f32 scale broadcastable against ``values``."""
    values: torch.Tensor        # int8
    scale: torch.Tensor         # float32, quantized axes of size 1

    def __getitem__(self, i) -> "QuantizedTensor":
        """Leading-axis view (one layer of a stacked weight)."""
        return QuantizedTensor(self.values[i], self.scale[i])


def _axes(x: torch.Tensor, axis) -> Tuple[int, ...]:
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def quantize_int8(x: torch.Tensor,
                  axis: Union[None, int, Sequence[int]] = None
                  ) -> QuantizedTensor:
    """``axis`` = reduction axes for the scale (one scale per remaining
    channel); ``None`` is per-tensor."""
    xf = x.to(torch.float32)
    return quantize_with_amax(
        xf, torch.amax(xf.abs(), dim=_axes(x, axis), keepdim=True))


def quantize_with_amax(xf: torch.Tensor, amax: torch.Tensor
                       ) -> QuantizedTensor:
    """``quantize_int8`` of the f32 ``xf`` given its (keepdim) absolute
    maximum, which may come from more than ``xf``: a row-parallel layer
    quantizes its slice of a row with the whole row's maximum, so the scale
    and every value equal the unsharded quantization's."""
    scale = torch.clamp_min(amax, 1e-8) / divisor(127.0, amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def dequantize(q: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.values.to(torch.float32) * q.scale).to(dtype)


def int8_matmul(x: torch.Tensor, w: QuantizedTensor,
                out_dtype: Optional[torch.dtype] = torch.bfloat16
                ) -> torch.Tensor:
    """x @ w for int8 weights, W8A8: x quantized per row on the fly,
    int32-exact accumulation (computed in float64, exact for
    |acc| < 2^53), then ``(acc * x_scale) * w_scale`` in f32 as the
    reference orders it. The model path reaches this through the K4
    kernel wrapper (``kernels.gemv.ops.gemv_int8_shared``)."""
    xq = quantize_int8(x, axis=-1)
    acc = torch.matmul(xq.values.to(torch.float64),
                       w.values.to(torch.float64)).to(torch.float32)
    return (acc * xq.scale * w.scale.reshape(1, -1)).to(out_dtype)


def quantize_kv(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv: (..., head_dim) -> (int8 values, f32 scales (..., 1)). All-zero
    rows take scale 1.0 (reset slots, padded chunk tails)."""
    kf = kv.to(torch.float32)
    amax = torch.amax(kf.abs(), dim=-1, keepdim=True)
    q127 = divisor(127.0, amax)
    scale = torch.where(amax > 0.0, torch.clamp_min(amax, 1e-8),
                        q127) / q127
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (values.to(torch.float32) * scale).to(dtype)
