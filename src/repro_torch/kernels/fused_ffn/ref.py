"""Plain PyTorch version of K3 (fused gated FFN), the port of
``repro.kernels.fused_ffn.ref``: all of it in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
