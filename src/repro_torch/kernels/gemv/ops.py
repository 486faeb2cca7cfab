"""K4 wrapper: W8A8 int8 GEMV on CUDA (hand-written kernel) or on the CPU
(plain version). ``gemv_int8_shared`` quantizes the activation rows with
torch ops, as ``repro.kernels.gemv.ops`` does with jnp outside the Pallas
call, once for several weights of the same input; ``gemv_int8_q`` is the
kernel's own wrapper and counts its launches.
``gemv_plan`` is the kernel's launch plan (grid, K split, scratch), kept
in Python so that the CPU tests can check it."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import CTAS_PER_SM, SMS, build, cdiv, tickets
from repro_torch.kernels.gemv.ref import gemv_int8_ref
from repro_torch.quant.int8 import QuantizedTensor, quantize_int8

MAX_K_CHUNK = 896           # k rows one CTA stages (shared memory cap)


@dataclass(frozen=True)
class GemvPlan:
    """How ``gemv_int8.cu`` tiles an (R,K) x (K,N) product: CTA (x, y, z)
    owns columns [x*cols, (x+1)*cols), rows [y*rows, (y+1)*rows) and k rows
    [z*k_chunk, (z+1)*k_chunk), each clipped to the extents. With more than
    one K chunk the int32 partials go to a (k_splits, R, N) scratch and
    each (x, y) output tile takes one ticket."""
    rows: int
    cols: int
    k_chunk: int
    k_splits: int
    grid: Tuple[int, int, int]
    scratch: int                # int32 elements (0: no K split)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def gemv_plan(R: int, K: int, N: int) -> GemvPlan:
    """Rows per CTA: 8 at decode widths, 32 above (one weight pass per 32
    rows). Columns per CTA: 32, or 64 for wide N. At decode widths K is cut
    only as far as MAX_K_CHUNK forces: a split costs its last CTA a ticket
    and a second round trip to L2, which at these sizes outweighs the extra
    CTAs (tools/plan_sweep.py measures both). At prefill widths, where each
    CTA does 4x the dp4a work, K is cut into chunks (multiples of 16) until
    the grid holds about CTAS_PER_SM CTAs per SM."""
    if R <= 8:
        rows, cols = 8, (64 if N >= 2048 else 32)
        strips, tiles = cdiv(N, cols), 1
        want = cdiv(K, MAX_K_CHUNK)
    else:
        rows, cols = 32, (64 if N >= 512 else 32)
        strips, tiles = cdiv(N, cols), cdiv(R, rows)
        want = cdiv(CTAS_PER_SM * SMS, strips * tiles)
    k_chunk = max(16, min(MAX_K_CHUNK, 16 * cdiv(cdiv(K, want), 16)))
    k_splits = max(1, cdiv(K, k_chunk))
    scratch = k_splits * R * N if k_splits > 1 else 0
    return GemvPlan(rows, cols, k_chunk, k_splits, (strips, tiles, k_splits),
                    scratch)


def _lib():
    lib = build.load_library("gemv_int8")
    fn = lib.gemv_int8_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 9 + [P]
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
    if R == 0 or N == 0:
        return out
    plan = gemv_plan(R, K, N)
    part = torch.empty((max(plan.scratch, 1),), dtype=torch.int32,
                       device=xq.device)
    wide_w = int(N % 16 == 0 and wq.data_ptr() % 16 == 0)
    wide_x = int(K % 16 == 0 and xq.data_ptr() % 16 == 0)
    tix = tickets(xq.device, plan.grid[0] * plan.grid[1])
    err = _lib()(xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), part.data_ptr(),
                 tix.data_ptr(), R, K, N, plan.rows, plan.cols,
                 plan.k_chunk, plan.k_splits, wide_w, wide_x,
                 torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "gemv_int8")
    gemv_int8_q.launches += 1
    return out


gemv_int8_q.launches = 0


def gemv_int8_shared(x, ws: Sequence[QuantizedTensor]) -> List:
    """x: (..., K) float, quantized once per row; each w: (K,N_i) int8 +
    (1,N_i) scale -> [(..., N_i) f32], one K4 call per weight."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq = quantize_int8(x.reshape(-1, K), axis=-1)
    return [gemv_int8_q(xq.values, xq.scale, w.values,
                        w.scale.reshape(1, -1)).reshape(*lead, -1)
            for w in ws]
