"""Plain PyTorch version of K1 (flash decode), the port of
``repro.kernels.flash_decode.ref``.

One query per sequence against a contiguous KV cache, in float32, with the
int8 dequantization, the ``kv_limit`` cut and the partial-statistics mode
of the kernel. A call whose ``kv_limit`` is <= 0 returns what the kernel
returns when it skips every tile: 0 (normalised) or ``(0, NEG_INF, 0)``.
The kernel and this version agree whenever every row has a live position
below ``kv_limit`` (always true on the decode path: a row attends at least
its own position) or ``kv_limit`` covers the whole extent.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, mask, k_scale=None, v_scale=None,
                     kv_limit=None, scale=None, partial_stats=False):
    """q: (B,Hq,hd); k/v: (B,n_kv,S,hd) float or int8 with scales
    (B,n_kv,S,1) f32; mask: (B,S) bool; kv_limit: int or 0-d int tensor.
    -> (B,Hq,hd) f32, or ``(o, m (B,Hq), l (B,Hq))`` with
    ``partial_stats``."""
    B, Hq, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    G = Hq // n_kv
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        kf, vf = kf * k_scale, vf * v_scale
    lim = None
    if kv_limit is not None:
        lim = torch.as_tensor(kv_limit, dtype=torch.int32,
                              device=q.device).reshape(())
        mask = mask & (torch.arange(S, device=q.device) < lim)[None]
    qg = q.reshape(B, n_kv, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bksh->bkgs", qg, kf) * sc
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, vf)
    if not partial_stats:
        o = o / torch.clamp_min(l, 1e-30)[..., None]
    if lim is not None:                  # every tile skipped
        empty = lim <= 0
        o = torch.where(empty, torch.zeros_like(o), o)
        m = torch.where(empty, torch.full_like(m, NEG_INF), m)
        l = torch.where(empty, torch.zeros_like(l), l)
    o = o.reshape(B, Hq, hd)
    if partial_stats:
        return o, m.reshape(B, Hq), l.reshape(B, Hq)
    return o
