"""K4 wrapper: W8A8 int8 GEMV on CUDA (hand-written kernel) or on the CPU
(plain version). ``gemv_int8`` quantizes the activation rows with torch
ops, as ``repro.kernels.gemv.ops`` does with jnp outside the Pallas call;
``gemv_int8_q`` is the kernel's own wrapper and counts its launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemv.ref import gemv_int8_ref
from repro_torch.quant.int8 import QuantizedTensor, quantize_int8


def _lib():
    lib = build.load_library("gemv_int8")
    fn = lib.gemv_int8_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 4 + [P]
        fn.restype = I
    return fn


def gemv_int8_q(xq, x_scale, wq, w_scale):
    """xq: (R,K) int8; x_scale: (R,1) f32; wq: (K,N) int8; w_scale: (1,N)
    f32 -> (R,N) f32, bit-exact with the plain version."""
    if xq.device.type == "cpu":
        return gemv_int8_ref(xq, x_scale, wq, w_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"gemv_int8: unsupported device {xq.device}")
    R, K = xq.shape
    N = wq.shape[1]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 \
            or x_scale.dtype != torch.float32 \
            or w_scale.dtype != torch.float32:
        raise TypeError("gemv_int8: int8 xq/wq and f32 scales required")
    if wq.shape[0] != K or x_scale.numel() != R or w_scale.numel() != N:
        raise ValueError(f"gemv_int8: shapes xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, scales {x_scale.numel()}/"
                         f"{w_scale.numel()} do not agree")
    ts = (xq, x_scale, wq, w_scale)
    if not all(t.is_contiguous() and t.device == xq.device for t in ts):
        raise ValueError("gemv_int8: tensors must be contiguous, on one "
                         "device")
    out = torch.empty((R, N), dtype=torch.float32, device=xq.device)
    if R == 0:
        return out
    aligned = int(N % 4 == 0 and wq.data_ptr() % 4 == 0)
    err = _lib()(xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), R, K, N, aligned,
                 torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "gemv_int8")
    gemv_int8_q.launches += 1
    return out


gemv_int8_q.launches = 0


def gemv_int8(x, w: QuantizedTensor):
    """x: (..., K) float; w: (K,N) int8 + (1,N) scale -> (..., N) f32."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq = quantize_int8(x.reshape(-1, K), axis=-1)
    out = gemv_int8_q(xq.values, xq.scale, w.values,
                      w.scale.reshape(1, -1))
    return out.reshape(*lead, -1)
