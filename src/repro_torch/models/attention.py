"""Attention: GQA projections, decode attention (K1 on CUDA), chunk-prefill
attention and the full-sequence attention of monolithic prefill (causal,
or not: the enc-dec family's encoder and cross-attention).

Port of ``repro.models.attention``. ``decode_attention`` routes through the
flash-decode wrapper: the hand-written kernel on CUDA, its plain version on
the CPU, both in f32 (the reference rounds the softmax weights to the value
dtype before the PV product; the kernel keeps them in f32). Split-KV decode
(``decode_attention_split``) makes one such call per shard in the kernel's
partial-statistics mode and merges the shards with the LSE combine. A tiered
cache reaches both through the image ``kv/cache.py::layer_read_tiered``
resolves in the compute dtype. The prefill forms, ``chunk_attention_tiered``
included, are plain PyTorch, as the reference's are jnp: bf16 operands
enter the products exactly (upcast to f32) with f32 accumulation.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_decode.combine import combine_partial_stats
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_partial)
from repro_torch.kv.cache import shard_kv_limits, shard_view
from repro_torch.models import common
from repro_torch.models.sharding import NULL_LAYOUT, MeshLayout, entry_of

NEG_INF = -1e30


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of operands in their own precision with f32 accumulation and
    an f32 result (JAX's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _masked_softmax_pv(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                       eq: str) -> torch.Tensor:
    """Reference softmax: masked scores -> NEG_INF, max-shift, weights
    rounded to v's dtype before the PV product, normalised by max(l,1e-30)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    w = (p / torch.clamp_min(l, 1e-30)).to(v.dtype)
    return _f32_einsum(eq, w, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """Forward of the reference ``flash_attention`` (``_padded``: any Sq,
    Sk) for monolithic prefill, as one masked softmax; ``causal`` keeps
    keys at or before the query's position (both counted from 0),
    ``window`` > 0 the band of keys (q - window, q] (local attention); no
    mask at all for the encoder's and the cross-attention's
    ``causal=False``. q: (B,Sq,Hq,hd); k/v: (B,Sk,Hkv,hd) ->
    (B,Sq,Hq,hd).

    Training differentiates it by autograd, where the reference writes a
    custom backward (FlashAttention-2 style: the blocks recomputed from
    the saved log-sum-exp); the gradients are the same function's. The
    (B,Hkv,G,Sq,Sk) weights are kept for the backward, a block's worth
    under ``remat``. The max shift carries no gradient: the softmax does
    not depend on it."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = _f32_einsum("bqkgh,btkh->bkgqt", qg, k) / math.sqrt(hd)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    if causal or window:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(-1)
    o = _f32_einsum("bkgqt,btkh->bqkgh", p.to(v.dtype), v)
    o = o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, k_scale=None, v_scale=None,
                     kv_limit=None) -> torch.Tensor:
    """q: (B,Hq,hd); k/v: (B,n_kv,S,hd) as STORED (int8 with scales
    (B,n_kv,S,1), or float); mask: (B,S) bool; kv_limit: device int32 —
    tiles at or past it are skipped. -> (B,Hq,hd) in q's dtype."""
    o = flash_decode(q.contiguous(), k, v, mask, k_scale, v_scale,
                     kv_limit=kv_limit)
    return o.to(q.dtype)


def split_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, k_scale=None, v_scale=None,
                       kv_limit=None, scale=None) -> torch.Tensor:
    """The f32 body of ``decode_attention_split`` (its result before the
    one final cast), as ``flash_decode`` is of ``decode_attention``.

    Shard s owns absolute positions [s*Sb, (s+1)*Sb). Each shard is one K1
    call in partial-statistics mode (the plain version on the CPU) over its
    own view, mask slice and clamped limit ``shard_kv_limits(...)[s]``,
    which stays on the device; the per-shard (o, m, l) are merged by the
    LSE combine in f32. A shard wholly past the limit is skipped by the
    kernel and merges as the exact identity."""
    B, n_kv, n, Sb, _ = k.shape
    mask = mask.reshape(B, n, Sb)
    limits = shard_kv_limits(
        torch.as_tensor(Sb * n if kv_limit is None else kv_limit,
                        dtype=torch.int32, device=q.device), n, Sb)
    q = q.contiguous()
    parts = [flash_decode_partial(
        q, k[:, :, s], v[:, :, s], mask[:, s],
        None if k_scale is None else k_scale[:, :, s],
        None if v_scale is None else v_scale[:, :, s],
        kv_limit=limits[s], scale=scale) for s in range(n)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    return combine_partial_stats(o, m, l, axis=0)


def decode_attention_split(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor,
                           k_scale=None, v_scale=None, kv_limit=None,
                           scale=None) -> torch.Tensor:
    """Split-KV decode attention. q: (B,Hq,hd); k/v SHARD-MAJOR
    (B,n_kv,n,Sb,hd) as STORED (int8 with scales (B,n_kv,n,Sb,1), or
    float; ``kv/cache.py::shard_view``); mask: (B,n*Sb) or (B,n,Sb) bool;
    kv_limit: GLOBAL device int32 limit (None: every position).
    -> (B,Hq,hd) in q's dtype (``split_flash_decode``, then one cast)."""
    return split_flash_decode(q, k, v, mask, k_scale, v_scale, kv_limit,
                              scale).to(q.dtype)


def decode_attention_split_bucketed(q, k, v, mask, n_shards: int,
                                    kv_bucket: int = 0, k_scale=None,
                                    v_scale=None, kv_limit=None,
                                    scale=None) -> torch.Tensor:
    """The bucketed split read for callers holding 4-D (B,n_kv,S,hd) K/V:
    the first ``kv_bucket`` positions (0: all), cut into ``n_shards``
    shard-major views, then ``decode_attention_split``. mask: (S,) or
    (B,S) bool."""
    S = k.shape[2]
    if kv_bucket and kv_bucket < S:
        mask = mask[..., :kv_bucket]
    k, v, k_scale, v_scale = shard_view(k, v, k_scale, v_scale, kv_bucket,
                                        n_shards)
    if mask.ndim == 1:
        mask = mask[None]
    return decode_attention_split(q, k, v, mask, k_scale, v_scale,
                                  kv_limit, scale)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """q: (B,C,Hq,hd); k/v: (B,n_kv,S,hd); mask: (C,S) or (B,C,S) bool ->
    (B,C,Hq,hd): the chunked-prefill lane's masked softmax over the cache."""
    B, C, Hq, hd = q.shape
    n_kv = k.shape[1]
    G = Hq // n_kv
    qg = q.reshape(B, C, n_kv, G, hd)
    s = _f32_einsum("bqkgh,bksh->bkgqs", qg, k) / math.sqrt(hd)
    if mask.ndim == 2:
        mask = mask[None]
    o = _masked_softmax_pv(s, mask[:, None, None], v, "bkgqs,bksh->bqkgh")
    return o.reshape(B, C, Hq, hd).to(q.dtype)


def chunk_attention_tiered(q: torch.Tensor, k_hot: torch.Tensor,
                           v_hot: torch.Tensor, k_cold: torch.Tensor,
                           v_cold: torch.Tensor, hot_mask: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """``chunk_attention`` over a tiered image: key j of query i is the
    exact hot value where ``hot_mask[b, i, j]`` and the dequantized cold
    value elsewhere. The boundary is per QUERY, so both tiers are scored
    and the select happens on the score and weight planes; each softmax
    entry sees exactly one tier. q: (B,C,Hq,hd); tiers (B,n_kv,S,hd) in
    the compute dtype; hot_mask (B,C,S) bool; mask (C,S) or (B,C,S)."""
    B, C, Hq, hd = q.shape
    n_kv = k_hot.shape[1]
    qg = q.reshape(B, C, n_kv, Hq // n_kv, hd)
    eq = "bqkgh,bksh->bkgqs"
    hm = hot_mask[:, None, None]                          # (B,1,1,C,S)
    s = torch.where(hm, _f32_einsum(eq, qg, k_hot),
                    _f32_einsum(eq, qg, k_cold)) / math.sqrt(hd)
    if mask.ndim == 2:
        mask = mask[None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    w = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    pv = "bkgqs,bksh->bqkgh"
    o = _f32_einsum(pv, torch.where(hm, w, zero).to(v_hot.dtype), v_hot) \
        + _f32_einsum(pv, torch.where(hm, zero, w).to(v_cold.dtype), v_cold)
    return o.reshape(B, C, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Length buckets for the decode KV walk
# ---------------------------------------------------------------------------

def kv_buckets(s_max: int, chunk: int, shards: int = 1) -> Tuple[int, ...]:
    """Static bucket set for a cache of extent ``s_max``: chunk multiples
    with ``s_max`` always last. ``chunk <= 0`` disables bucketing.
    ``shards > 1`` (split-KV decode): every bucket must cut into ``shards``
    equal blocks, so the chunk is rounded UP to a shard multiple and
    ``s_max`` itself must divide."""
    if shards > 1 and s_max % shards:
        raise ValueError(
            f"KV extent {s_max} not divisible by shards={shards}")
    if chunk <= 0 or chunk >= s_max:
        return (s_max,)
    if shards > 1:
        chunk = -(-chunk // shards) * shards
        if chunk >= s_max:
            return (s_max,)
    return tuple(range(chunk, s_max, chunk)) + (s_max,)


def bucket_for(needed: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket covering ``needed`` KV positions."""
    for b in buckets:
        if b >= needed:
            return b
    return buckets[-1]


# ---------------------------------------------------------------------------
# GQA projection parameters
# ---------------------------------------------------------------------------

def make_attn_params(gen, cfg) -> dict:
    d = cfg.d_model
    dt = common.dtype_of(cfg)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": common.make_linear(gen, d, hq * hd, dt, bias=cfg.qkv_bias,
                                 int8=cfg.weight_int8),
        "wk": common.make_linear(gen, d, hkv * hd, dt, bias=cfg.qkv_bias,
                                 int8=cfg.weight_int8),
        "wv": common.make_linear(gen, d, hkv * hd, dt, bias=cfg.qkv_bias,
                                 int8=cfg.weight_int8),
        "wo": common.make_linear(gen, hq * hd, d, dt, int8=cfg.weight_int8),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.make_norm("rmsnorm", hd, dt, gen.device)
        p["k_norm"] = common.make_norm("rmsnorm", hd, dt, gen.device)
    return p


def _split_heads(y: torch.Tensor, n_heads: int, hd: int, cols, ctx,
                 site: str):
    """A projection's local columns (B,S,cols) as heads (B,S,h,hd) and the
    axes the heads are cut over: where the columns' cut splits a head
    (e.g. 14 heads of 64 over 4 ranks), the columns are all-gathered
    first and the heads are whole."""
    n = ctx.n(entry_of(cols)) if cols else 1
    if n > 1 and n_heads % n:
        from repro_torch.core.collectives import all_gather
        y = all_gather(y, ctx.mesh, cols, y.ndim - 1, site)
        cols = ()
    return y.reshape(*y.shape[:-1], -1, hd), cols


def qkv_project(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                lay: MeshLayout = NULL_LAYOUT
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), with RoPE applied
    where the config's ``pos`` is ``rope`` (after the per-head q/k RMSNorm
    where the config has one). On a mesh (``lay``) x is whole and q/k/v
    come from the local columns (K4 on them with int8 weights), the norms
    and RoPE run on the local heads, then the sites: q to ``act_heads``
    (an all-gather under operator_centric) and to the attention's heads,
    k/v to ``kv_heads``."""
    hd, ctx = cfg.head_dim, lay.ctx
    q, k, v = common.linears([p["wq"], p["wk"], p["wv"]], x)
    q, qa = _split_heads(q, cfg.n_heads, hd, lay.q_cols, ctx, "q_cols")
    k, ka = _split_heads(k, cfg.n_kv_heads, hd, lay.kv_cols, ctx, "kv_cols")
    v, _ = _split_heads(v, cfg.n_kv_heads, hd, lay.kv_cols, ctx, "kv_cols")
    if "q_norm" in p:
        q = common.apply_norm("rmsnorm", p["q_norm"], q, cfg.norm_eps)
        k = common.apply_norm("rmsnorm", p["k_norm"], k, cfg.norm_eps)
    if cfg.pos == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    q = lay.heads(q, qa, lay.act_heads, "q_act_heads")
    q = lay.heads(q, lay.act_heads, lay.attn_heads, "q_attn")
    k = lay.heads(k, ka, lay.kv_heads, "kv_heads")
    v = lay.heads(v, ka, lay.kv_heads, "kv_heads")
    return q, k, v
