"""K3 wrapper: the fused gated FFN on CUDA (hand-written kernel) or on the
CPU (plain version). A CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_ffn.ref import activation, fused_ffn_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}


def _lib():
    lib = build.load_library("fused_ffn")
    if lib.fused_ffn_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_ffn_launch.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.fused_ffn_launch.restype = I
        lib.fused_ffn_slices.argtypes = [I]
        lib.fused_ffn_slices.restype = I
    return lib


def fused_ffn(x, w_gate, w_up, w_down, act: str = "silu"):
    """x: (R,D); w_gate/w_up: (D,F); w_down: (F,D), one float dtype, all
    contiguous -> (R,D) f32."""
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
    if not all(t.is_contiguous() and t.device == x.device
               for t in (x,) + ws):
        raise ValueError("fused_ffn: tensors must be contiguous, on x's "
                         "device")
    out = torch.empty((R, D), dtype=torch.float32, device=x.device)
    if R == 0:
        return out
    lib = _lib()
    part = torch.empty((lib.fused_ffn_slices(F_), R, D), dtype=torch.float32,
                       device=x.device)
    err = lib.fused_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        part.data_ptr(), out.data_ptr(), R, D, F_, _ACTS[act],
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_ffn")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
