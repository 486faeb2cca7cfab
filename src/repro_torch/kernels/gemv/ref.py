"""Plain PyTorch version of K4 (W8A8 int8 GEMV), the port of
``repro.kernels.gemv.ref``. The int32 accumulation is computed in float64,
which is exact for every |acc| < 2^53 (int8 products over K < 2^39)."""
from __future__ import annotations

import torch


def gemv_int8_ref(xq, x_scale, wq, w_scale):
    """xq: (R,K) int8 with x_scale (R,1) f32; wq: (K,N) int8 with w_scale
    (1,N) f32 -> (R,N) f32 = (float(acc) * x_scale) * w_scale."""
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64))
    return acc.to(torch.float32) * x_scale * w_scale
