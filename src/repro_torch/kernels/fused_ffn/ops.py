"""K3 wrapper: the fused gated FFN on CUDA (hand-written kernel) or on the
CPU (plain version). A CUDA tensor launches the kernel or raises.
``ffn_plan`` is the kernel's launch plan (grids, D and F splits, scratch),
kept in Python so that the CPU tests can check it.

Under autograd (an input that requires a gradient, grad mode on) the call
goes through ``FusedFFN``: the same forward (the kernel on CUDA, the plain
version on the CPU) and ``ref.fused_ffn_backward``, plain products written
once for both devices."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import CTAS_PER_SM, SMS, build, cdiv, tickets
from repro_torch.kernels.fused_ffn.ref import (activation, fused_ffn_backward,
                                               fused_ffn_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}


COLS = 64                   # weight columns per CTA in both passes
PAD = 8                     # elements of padding per staged operand row
RING = 3 * 32               # rows of Wg and Wu a gate/up CTA holds at once
GATE_UP_BYTES = 100 * 1024  # ring + x rows one gate/up CTA stages
DOWN_BYTES = 100 * 1024     # Wd chunk + h rows one down CTA stages
SMEM_BYTES = 227 * 1024     # shared memory one CTA may use on an H100
MAX_CLUSTER = 8             # D chunks of one gate/up strip form a cluster


@dataclass(frozen=True)
class FfnPlan:
    """How ``fused_ffn.cu`` tiles one call. gate/up CTA (x, y, z) owns F
    columns [64x, 64x+64), rows [y*rows, (y+1)*rows) and D rows
    [z*d_chunk, (z+1)*d_chunk) (the d_splits CTAs of one strip form a
    cluster; trailing chunks past D may be empty). down CTA (x, y, z) owns
    D columns [64x, 64x+64), the same row tile and F rows [z*f_chunk,
    (z+1)*f_chunk), each clipped to the extents. The f32 scratch holds h
    (R*F) and, with more than one F chunk, the down partials
    (f_splits*R*D); each down (x, y) tile takes a ticket."""
    rows: int
    d_chunk: int
    d_splits: int
    f_chunk: int
    f_splits: int
    grid_gate_up: Tuple[int, int, int]
    grid_down: Tuple[int, int, int]
    scratch: int                # f32 elements
    gate_up_smem: int           # bytes of shared memory per CTA
    down_smem: int

    @property
    def ctas(self) -> Tuple[int, int]:
        return (self.grid_gate_up[0] * self.grid_gate_up[1]
                * self.grid_gate_up[2],
                self.grid_down[0] * self.grid_down[1] * self.grid_down[2])


def _gate_up_split(R: int, D: int, F: int, rows: int, itemsize: int):
    """The gate/up pass at a row tile: (tiles, d_splits, d_chunk, shared
    memory of one CTA)."""
    tiles = cdiv(max(R, 1), rows)
    strips_f = cdiv(F, COLS)
    target = CTAS_PER_SM * SMS
    d_splits = 1
    while d_splits < MAX_CLUSTER and strips_f * tiles * d_splits < target:
        d_splits *= 2

    def gate_up_bytes(d_chunk):
        return max(itemsize * (2 * RING * COLS + rows * (d_chunk + PAD)),
                   4 * 2 * COLS * (32 if rows == 16 else rows))

    d_chunk = 16 * cdiv(cdiv(D, d_splits), 16)
    while gate_up_bytes(d_chunk) > GATE_UP_BYTES and d_splits < MAX_CLUSTER:
        d_splits *= 2
        d_chunk = 16 * cdiv(cdiv(D, d_splits), 16)
    return tiles, d_splits, d_chunk, gate_up_bytes(d_chunk)


def ffn_plan(R: int, D: int, F: int, itemsize: int = 2) -> FfnPlan:
    """Rows per CTA: 16, 32 or 64 (one weight pass serves up to 64 rows;
    past 32 rows a 32-row tile where a gate/up CTA's 64 x rows would not
    fit its shared memory, as in f32 at D = 8,192). gate/up cuts D into
    1, 2, 4 or 8 chunks, down cuts F into chunks of a multiple of 16, each
    until its grid holds about CTAS_PER_SM CTAs per SM and its tiles fit
    the byte budgets above. Raises ValueError where a gate/up CTA's x rows
    exceed the shared memory even in eight D chunks."""
    rows = 16 if R <= 16 else 32 if R <= 32 else 64
    tiles, d_splits, d_chunk, gate_up_smem = _gate_up_split(R, D, F, rows,
                                                            itemsize)
    if gate_up_smem > SMEM_BYTES and rows == 64:
        rows = 32
        tiles, d_splits, d_chunk, gate_up_smem = _gate_up_split(
            R, D, F, rows, itemsize)
    if gate_up_smem > SMEM_BYTES:
        raise ValueError(f"fused_ffn: D={D} at {rows} rows needs "
                         f"{gate_up_smem} bytes of shared memory per CTA, "
                         f"more than {SMEM_BYTES}")
    strips_f, strips_d = cdiv(F, COLS), cdiv(D, COLS)
    target = CTAS_PER_SM * SMS
    want = cdiv(target, strips_d * tiles)
    per_row = COLS * itemsize + 4 * rows      # bytes of Wd and h per F row
    cap = 16 * max(1, DOWN_BYTES // (16 * per_row))
    f_chunk = max(16, min(cap, 16 * cdiv(cdiv(F, want), 16)))
    f_splits = max(1, cdiv(F, f_chunk))
    down_smem = max(f_chunk * COLS * itemsize + rows * (f_chunk + PAD) * 4,
                    8 * 16 * COLS * 4)
    scratch = R * F + (f_splits * R * D if f_splits > 1 else 0)
    return FfnPlan(rows, d_chunk, d_splits, f_chunk, f_splits,
                   (strips_f, tiles, d_splits), (strips_d, tiles, f_splits),
                   scratch, gate_up_smem, down_smem)


def _lib():
    lib = build.load_library("fused_ffn")
    if lib.fused_ffn_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_ffn_launch.argtypes = [P] * 7 + [I] * 10 + [P]
        lib.fused_ffn_launch.restype = I
    return lib


class FusedFFN(torch.autograd.Function):
    """K3 with a gradient: the forward of ``fused_ffn``, the backward of
    ``fused_ffn_backward`` from the saved x and weights."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, act):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        ctx.act = act
        return _forward(x, w_gate, w_up, w_down, act)

    @staticmethod
    def backward(ctx, dout):
        grads = fused_ffn_backward(*ctx.saved_tensors, dout, ctx.act)
        return (*grads, None)


def fused_ffn(x, w_gate, w_up, w_down, act: str = "silu"):
    """x: (R,D); w_gate/w_up: (D,F); w_down: (F,D), one float dtype, all
    contiguous -> (R,D) f32. Differentiable (``FusedFFN``) where an input
    requires a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        return FusedFFN.apply(x, w_gate, w_up, w_down, act)
    return _forward(x, w_gate, w_up, w_down, act)


def _forward(x, w_gate, w_up, w_down, act):
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w_gate, w_up, w_down, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    activation(act)                      # validates the name
    R, D = x.shape
    F_ = w_gate.shape[1]
    ws = (w_gate, w_up, w_down)
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"fused_ffn: x and weights must share one of "
                        f"{list(_DTYPES)}, got {x.dtype}/"
                        f"{[w.dtype for w in ws]}")
    if tuple(w_gate.shape) != (D, F_) or tuple(w_up.shape) != (D, F_) \
            or tuple(w_down.shape) != (F_, D):
        raise ValueError("fused_ffn: shapes x (R,D), w_gate/w_up (D,F), "
                         "w_down (F,D) required")
    if F_ == 0:
        raise ValueError("fused_ffn: F must be positive")
    if not all(t.is_contiguous() and t.device == x.device
               for t in (x,) + ws):
        raise ValueError("fused_ffn: tensors must be contiguous, on x's "
                         "device")
    out = torch.empty((R, D), dtype=torch.float32, device=x.device)
    if R == 0 or D == 0:
        return out
    plan = ffn_plan(R, D, F_, x.element_size())
    scratch = torch.empty((max(plan.scratch, 1),), dtype=torch.float32,
                          device=x.device)
    tix = tickets(x.device, plan.grid_down[0] * plan.grid_down[1])
    err = _lib().fused_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        scratch.data_ptr(), tix.data_ptr(), out.data_ptr(), R, D, F_,
        _ACTS[act], _DTYPES[x.dtype], plan.rows, plan.d_chunk,
        plan.d_splits, plan.f_chunk, plan.f_splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_ffn")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
