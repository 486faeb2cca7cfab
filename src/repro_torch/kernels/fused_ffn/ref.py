"""Plain PyTorch version of K3 (fused gated FFN), the port of
``repro.kernels.fused_ffn.ref``: all of it in float32; and K3's backward,
plain products on either device (the reference has no backward kernel:
its training FFN is einsums, differentiated by XLA)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_GELU_K = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715


def activation(act: str):
    if act == "silu":
        return F.silu
    if act == "gelu":                    # jax.nn.gelu's default (tanh) form
        return lambda g: F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def fused_ffn_ref(x, w_gate, w_up, w_down, act: str = "silu"):
    """x: (R,D); w_gate/w_up: (D,F); w_down: (F,D) -> (R,D) f32."""
    xf = x.to(torch.float32)
    g = xf @ w_gate.to(torch.float32)
    u = xf @ w_up.to(torch.float32)
    return (activation(act)(g) * u) @ w_down.to(torch.float32)


def activation_grad(act: str, g: torch.Tensor) -> torch.Tensor:
    """d act(g) / dg in f32: silu, or the tanh form of gelu."""
    if act == "silu":
        s = torch.sigmoid(g)
        return s * (1.0 + g * (1.0 - s))
    if act == "gelu":
        t = torch.tanh(_GELU_K * (g + _GELU_C * g * g * g))
        return 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * _GELU_K * (
            1.0 + 3.0 * _GELU_C * g * g)
    raise ValueError(f"unknown activation {act!r}")


def fused_ffn_backward(x, w_gate, w_up, w_down, dout, act: str = "silu"):
    """Gradients of ``fused_ffn_ref`` at (x, w_gate, w_up, w_down) for the
    output gradient ``dout`` (R,D): gate and up recomputed in f32 from x
    and the weights, then plain f32 products. Returns (dx, dW_gate, dW_up,
    dW_down), each in its input's dtype."""
    f32 = torch.float32
    xf, wg, wu, wd = (t.to(f32) for t in (x, w_gate, w_up, w_down))
    dout = dout.to(f32)
    g = xf @ wg
    u = xf @ wu
    a = activation(act)(g)
    dh = dout @ wd.t()                                     # (R,F)
    dwd = (a * u).t() @ dout                               # (F,D)
    du = dh * a
    dg = dh * u * activation_grad(act, g)
    dx = dg @ wg.t() + du @ wu.t()
    dwg = xf.t() @ dg
    dwu = xf.t() @ du
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))
