"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks interleaved with
local (sliding-window) attention, pattern (R, R, A) repeating. The port of
``repro.models.rglru`` (inference, and the training forward and loss).

The local attention layers keep a ring KV cache of min(window, max_len)
slots (``kv/cache.py``); the RG-LRU layers an O(1) state
(``kv/state.py``). The RG-LRU recurrence, per channel:

    r_t = sigmoid(W_a xi_t),  i_t = sigmoid(W_x xi_t)
    a_t = exp(-c softplus(Lambda) r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t xi_t)

The reference's ``associative_scan`` over a full sequence is a log-depth
scan here too: ceil(log2 S) doubling passes over (a, b). On CUDA the
attention layers' decode attends the ring through K1 and every FFN (GeGLU)
runs through K3 in its gelu mode; the RG-LRU itself has no TPU kernel in
the reference and is plain PyTorch. The family has no slotted API (it
serves in drain mode), as in the reference.

On a mesh (``ctx``) the RG-LRU is cut over ``lru`` on the model axis: the
rank projects its channels through ``in_a``/``in_b`` (column-parallel),
runs the conv, ``lam`` and the block-diagonal gates ``w_a``/``w_x`` of its
heads locally and ``out`` row-parallel onto the residual's placement; the
GeGLU FFN runs K3 (gelu) on the rank's slice of F. The local attention
runs the transformer's mesh attention over the ring: its one KV head
(MQA) replicates and each rank attends its query heads
(``MeshLayout.attn_heads``); under +seqkv the ring's slots are cut over
the model axis as the reference's ``cache_specs`` cuts its ``kv_seq`` dim
(``transformer.attend_ring_seq``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRU, ModelConfig
from repro_torch.kv.cache import init_kv_cache, init_kv_cache_sharded
from repro_torch.kv.state import causal_conv, conv_step, init_rglru_state
from repro_torch.models import common
from repro_torch.models.sharding import (NULL_CTX, NULL_LAYOUT, MeshLayout,
                                         ShardingCtx, channel_head_cut,
                                         entry_of, layout)
from repro_torch.models.transformer import (block_decode, block_full_seq,
                                            block_train, cache_seq,
                                            ffn_apply, final_logits,
                                            make_block_params,
                                            make_ffn_params, row_linear,
                                            write_prefill)

C_RGLRU = 8.0


# ---------------------------------------------------------------------------
# RG-LRU temporal-mixing block
# ---------------------------------------------------------------------------

def lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def mesh_cut(cfg: ModelConfig, ctx: ShardingCtx) -> Tuple[str, ...]:
    """The mesh axes this rank's RG-LRU channels (and the gates' heads
    over them) are cut over: () on one device."""
    return channel_head_cut(ctx, "RG-LRU", cfg.d_model, lru_width(cfg),
                            "heads", cfg.n_heads)


def make_rglru_params(gen: torch.Generator, cfg: ModelConfig
                      ) -> Dict[str, Any]:
    d, lw = cfg.d_model, lru_width(cfg)
    nh = cfg.n_heads
    blk = lw // nh
    dt = common.dtype_of(cfg)
    W = cfg.rglru.conv_width
    # softplus^-1, so that a_t^c lies in about [0.9, 0.999]
    a_c = torch.linspace(0.9, 0.999, lw, dtype=torch.float32,
                         device=gen.device)
    return {
        "in_a": common.make_linear(gen, d, lw, dt),       # gelu branch
        "in_b": common.make_linear(gen, d, lw, dt),       # recurrent branch
        "conv": common.dense_init(gen, (W, lw), dt, fan_in=W),
        "w_a": common.dense_init(gen, (nh, blk, blk), dt, fan_in=blk),
        "w_x": common.dense_init(gen, (nh, blk, blk), dt, fan_in=blk),
        "lam": torch.log(torch.expm1(-torch.log(a_c) / C_RGLRU)),
        "out": common.make_linear(gen, lw, d, dt),
    }


def _gates(p, xi: torch.Tensor, nh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections. xi: (B,S,lw) -> r, i (B,S,lw) f32."""
    B, S, lw = xi.shape
    xh = xi.reshape(B, S, nh, lw // nh).to(torch.float32)
    r = torch.einsum("bsnk,nkj->bsnj", xh, p["w_a"].to(torch.float32))
    i = torch.einsum("bsnk,nkj->bsnj", xh, p["w_x"].to(torch.float32))
    return (torch.sigmoid(r).reshape(B, S, lw),
            torch.sigmoid(i).reshape(B, S, lw))


def _lru_coeffs(p, xi: torch.Tensor, nh: int):
    """Per-step (a_t, b_t) of h_t = a_t h + b_t. xi: (B,S,lw)."""
    r, i = _gates(p, xi, nh)
    log_a = -C_RGLRU * F.softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    gated = i * xi.to(torch.float32)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a log-depth
    inclusive scan: pass d combines each step with the one 2^d before it,
    (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2), ceil(log2 S) passes.
    Returns every h_t (B,S,C)."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :S - d], b[:, :S - d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], b_prev * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return b


def rglru_full_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                   lay: MeshLayout = NULL_LAYOUT, cut=()) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D) (on a mesh: x whole, the rank's channels,
    ``out`` row-parallel onto the residual's placement)."""
    ya = F.gelu(common.linear(p["in_a"], x).to(torch.float32),
                approximate="tanh")
    xb = causal_conv(common.linear(p["in_b"], x), p["conv"])
    a, b = _lru_coeffs(p, xb, p["w_a"].shape[0])
    y = (ya * linear_scan(a, b)).to(x.dtype)
    return row_linear(p["out"], y, lay, cut, "rglru_out")


def rglru_final_state(p: Dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state after a prefill pass: (h (B,lw) f32, conv tail
    (B,W-1,lw) f32, the last inputs before the conv)."""
    W = cfg.rglru.conv_width
    xb = common.linear(p["in_b"], x)
    conv_tail = xb[:, -(W - 1):, :].to(torch.float32)
    a, b = _lru_coeffs(p, causal_conv(xb, p["conv"]), p["w_a"].shape[0])
    return linear_scan(a, b)[:, -1, :], conv_tail


def rglru_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 h: torch.Tensor, conv: torch.Tensor,
                 lay: MeshLayout = NULL_LAYOUT, cut=()
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step over one layer's state. x: (B,1,D); h: (B,lw) f32;
    conv: (B,W-1,lw) -> (out, h', conv') in fresh tensors."""
    ya = F.gelu(common.linear(p["in_a"], x).to(torch.float32),
                approximate="tanh")[:, 0]
    xb = common.linear(p["in_b"], x)[:, 0]                # (B,lw)
    xb_c, conv_new = conv_step(conv, xb, p["conv"])
    a, b = _lru_coeffs(p, xb_c[:, None, :], p["w_a"].shape[0])
    h_new = a[:, 0] * h + b[:, 0]
    y = (ya * h_new).to(x.dtype)[:, None, :]
    return row_linear(p["out"], y, lay, cut, "rglru_out"), h_new, \
        conv_new.to(torch.float32)


# ---------------------------------------------------------------------------
# Hybrid stack: (R, R, A) superblocks, then the recurrent tail layers
# ---------------------------------------------------------------------------

def _layer_plan(cfg: ModelConfig) -> Tuple[int, int]:
    """(superblocks, tail layers): the stack is n_super repetitions of the
    block pattern, then recurrent layers only."""
    kinds = cfg.block_kinds()
    pat = cfg.rglru.block_pattern
    n_super = i = 0
    while i + len(pat) <= len(kinds) and tuple(kinds[i:i + len(pat)]) == pat:
        n_super += 1
        i += len(pat)
    tail = kinds[i:]
    if not all(k == RGLRU for k in tail):
        raise ValueError("the hybrid stack's tail must be recurrent-only")
    return n_super, len(tail)


def make_mix_block(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """One RG-LRU residual pair: the temporal mix and a GeGLU FFN (the
    local attention layers are ``transformer.make_block_params``)."""
    dt = common.dtype_of(cfg)
    dev = gen.device
    return {"ln1": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "ln2": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "ffn": make_ffn_params(gen, cfg),
            "mix": make_rglru_params(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen.device``: ``super`` and ``tail``
    are lists of per-layer dicts (the reference stacks them)."""
    n_super, n_tail = _layer_plan(cfg)
    dt = common.dtype_of(cfg)
    params = {
        "embed": common.make_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "super": [{"r1": make_mix_block(gen, cfg),
                   "r2": make_mix_block(gen, cfg),
                   "attn": make_block_params(gen, cfg)}
                  for _ in range(n_super)],
        "ln_f": common.make_norm(cfg.norm, cfg.d_model, dt, gen.device),
    }
    if n_tail:
        params["tail"] = [make_mix_block(gen, cfg) for _ in range(n_tail)]
    return params


def _embed(params, tokens, cfg, lay: MeshLayout = NULL_LAYOUT):
    """The embedding scaled by sqrt(d_model), the scale rounded to the
    compute dtype first (Gemma's); on a mesh onto the residual's
    placement."""
    x = common.embed(params["embed"], tokens, lay.ctx, lay.vocab,
                     lay.res_spec())
    # the scale rounded on the host: no host-to-device copy a step
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()


def _mix_residual(p, h, cfg, state=None, lay: MeshLayout = NULL_LAYOUT,
                  cut=()):
    """RG-LRU residual block: ln1, the mix (full sequence, or one decode
    step over ``state`` = (h, conv) slices), the residual, ln2 and the
    GeGLU FFN. Returns (h', (h_state', conv') or None). On a mesh h is
    the residual's slice; each norm reads the whole residual."""
    y = common.apply_norm(cfg.norm, p["ln1"], lay.to_full(h, "ln1_in"),
                          cfg.norm_eps)
    if state is None:
        mix, new = rglru_full_seq(p["mix"], y, cfg, lay, cut), None
    else:
        mix, hs, cs = rglru_decode(p["mix"], y, cfg, *state, lay, cut)
        new = (hs, cs)
    h = h + mix
    y = common.apply_norm(cfg.norm, p["ln2"], lay.to_full(h, "ln2_in"),
                          cfg.norm_eps)
    return h + ffn_apply(p["ffn"], y, cfg, lay), new


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: ShardingCtx = NULL_CTX, lay=None) -> torch.Tensor:
    """Training forward (the reference's ``forward_hidden(train=True)``):
    each superblock (two RG-LRU residual blocks, then local attention over
    the window's band) and each tail block under ``remat``, as the
    reference checkpoints ``super_fwd`` and ``tail_fwd``; the hidden
    (B,S,D) after the final norm. On a mesh (``ctx``; ``lay`` its training
    layout) tokens are this rank's rows, each unit gathers its fsdp shards
    inside its ``remat`` and runs the mesh prefill's sites (the RG-LRU
    channels and the query heads over the model axis, the one KV head
    replicated, K3 on the rank's slice of F), and the hidden state is
    whole over the other axes."""
    lay = layout(cfg, ctx, train=True) if lay is None else lay
    cut = mesh_cut(cfg, ctx)
    x = _embed(lay.weights({"embed": params["embed"]}, "top"), tokens, cfg,
               lay)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)

    def superblock(sp, h):
        sp = lay.weights(sp, "super")
        h = _mix_residual(sp["r1"], h, cfg, lay=lay, cut=cut)[0]
        h = _mix_residual(sp["r2"], h, cfg, lay=lay, cut=cut)[0]
        return block_train(sp["attn"], h, cfg, positions,
                           window=cfg.rglru.window, lay=lay)[0]

    def tail(tp, h):
        return _mix_residual(lay.weights(tp, "tail"), h, cfg, lay=lay,
                             cut=cut)[0]

    for sp in params["super"]:
        x = common.remat(superblock, sp, x)
    for tp in params.get("tail", []):
        x = common.remat(tail, tp, x)
    x = lay.to_full(x, "ln_f_in")
    return common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps)


def loss_fn(params, batch, cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
            ) -> torch.Tensor:
    """Chunked cross-entropy against the embedding table. On a mesh: this
    rank's share of the loss (summed over the batch axes it is the
    reference's), vocabulary-parallel over the table's rows, which fsdp
    gathers inside each chunk's ``remat``."""
    lay = layout(cfg, ctx, train=True)
    x = forward_train(params, batch["tokens"], cfg, ctx, lay)
    return common.lm_loss(params, ("embed", "table"), x, batch["labels"],
                          lay)


def make_caches(cfg: ModelConfig, batch: int, max_len: int, device=None,
                ctx: ShardingCtx = NULL_CTX):
    """{"kv": the ring cache of the n_super attention layers, "state": the
    RG-LRU state of the 2*n_super + n_tail recurrent layers}. On a mesh
    this rank's part of ``batch`` slots: its data row's rows, its
    channels of the state; the ring whole over its one KV head, or its
    block of slots under +seqkv."""
    n_super, n_tail = _layer_plan(cfg)
    lw, W = lru_width(cfg), cfg.rglru.conv_width
    kv_args = (n_super, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    kv_kw = dict(dtype=common.dtype_of(cfg),
                 quantized=(cfg.kv_dtype == "int8"), device=device,
                 window=cfg.rglru.window)
    if ctx.active:
        kv = init_kv_cache_sharded(ctx, *kv_args, **kv_kw)
        batch //= ctx.n(entry_of(ctx.batch_axes))
        lw //= ctx.n(entry_of(mesh_cut(cfg, ctx)))
    else:
        kv = init_kv_cache(*kv_args, **kv_kw)
    st = init_rglru_state(2 * n_super + n_tail, batch, lw, W, device=device)
    return {"kv": kv, "state": st}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            ctx: ShardingCtx = NULL_CTX):
    """Full-sequence pass that also fills the decode caches (a ring of
    min(window, max_len) slots). Returns (caches, last logits (B,1,V)).
    On a mesh tokens are this data row's rows, the logits this rank's
    vocabulary rows."""
    lay, cut = layout(cfg, ctx), mesh_cut(cfg, ctx)
    B, S = tokens.shape
    rows = ctx.n(entry_of(ctx.batch_axes)) if ctx.active else 1
    caches = make_caches(cfg, B * rows, max_len, tokens.device, ctx)
    x = _embed(params, tokens, cfg, lay)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    win = cfg.rglru.window
    hs, cs, ks, vs = [], [], [], []

    def state_residual(p, h):
        y = common.apply_norm(cfg.norm, p["ln1"], lay.to_full(h, "ln1_in"),
                              cfg.norm_eps)
        hst, ctail = rglru_final_state(p["mix"], y, cfg)
        hs.append(hst)
        cs.append(ctail)
        h = h + rglru_full_seq(p["mix"], y, cfg, lay, cut)
        y = common.apply_norm(cfg.norm, p["ln2"], lay.to_full(h, "ln2_in"),
                              cfg.norm_eps)
        return h + ffn_apply(p["ffn"], y, cfg, lay)

    for sp in params["super"]:
        x = state_residual(sp["r1"], x)
        x = state_residual(sp["r2"], x)
        x, (k, v) = block_full_seq(sp["attn"], x, cfg, positions,
                                   window=win, lay=lay)
        ks.append(k)
        vs.append(v)
    for tp in params.get("tail", []):
        x = state_residual(tp, x)
    st = caches["state"]
    st.h.copy_(torch.stack(hs))
    st.conv.copy_(torch.stack(cs))
    k_all = torch.stack(ks).transpose(2, 3)
    v_all = torch.stack(vs).transpose(2, 3)
    kv = caches["kv"]
    if kv.seq_axes:
        # the whole ring (every slot of this rank's rows), then this
        # rank's block of slots
        whole = init_kv_cache(kv.k.shape[0], B, kv.k.shape[2], max_len,
                              cfg.head_dim, dtype=common.dtype_of(cfg),
                              quantized=kv.is_quantized,
                              device=tokens.device, window=win)
        write_prefill(whole, k_all, v_all, S)
        lo, nb = kv.seq_lo, kv.k.shape[3]
        for dst, src in ((kv.k, whole.k), (kv.v, whole.v),
                         (kv.k_scale, whole.k_scale),
                         (kv.v_scale, whole.v_scale)):
            if dst is not None:
                dst.copy_(src[..., lo:lo + nb, :])
        kv.length = whole.length
    else:
        write_prefill(kv, k_all, v_all, S)
    return caches, final_logits(params, x[:, -1:], cfg, lay)


def decode_step(params, caches, tokens: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx = NULL_CTX):
    """Shared-cursor decode step (drain serving): every row appends at
    ``kv.length`` (the ring slot length % size) and advances its recurrent
    state; caches in place. Returns (caches, logits (B,1,V) f32). The
    cursor stays on the device: no host sync."""
    lay, cut = layout(cfg, ctx), mesh_cut(cfg, ctx)
    kv, st = caches["kv"], caches["state"]
    pos = kv.length
    seq = cache_seq(kv)
    x = _embed(params, tokens[:, None], cfg, lay)
    layers = iter(range(st.h.shape[0]))

    def recur(p, h):
        j = next(layers)
        h, (hs, cs) = _mix_residual(p, h, cfg, (st.h[j], st.conv[j]), lay,
                                    cut)
        st.h[j].copy_(hs)
        st.conv[j].copy_(cs)
        return h

    for i, sp in enumerate(params["super"]):
        x = recur(sp["r1"], x)
        x = recur(sp["r2"], x)
        x = block_decode(sp["attn"], x, cfg, kv.layer(i), pos,
                         cfg.rglru.window, lay, seq)
    for tp in params.get("tail", []):
        x = recur(tp, x)
    kv.length = pos + 1
    return caches, final_logits(params, x, cfg, lay)
