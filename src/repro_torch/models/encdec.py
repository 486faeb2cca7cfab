"""Whisper-style encoder-decoder: parameters, encoder, prefill (tokens and
frames), the shared-cursor decode step and the training loss.

Port of ``repro.models.encdec``. The conv/mel frontend is a stub, as in
the reference: the caller passes precomputed frame embeddings (B,
n_frames, d_model). The encoder is a non-causal stack
over the frames with sinusoidal positions; the decoder a causal stack with
learned positions, each layer self-attention, then cross-attention to the
encoder output, then the ungated ``gelu_mlp`` FFN. Layers are Python loops
over per-layer parameter dicts (``enc_blocks``, ``dec_blocks``); the
logits read the embedding table (``init_params`` makes no ``unembed``).

Kernels. Every full-sequence attention (the encoder's, the decoder's
causal self-attention and its cross-attention at prefill) is the plain
masked softmax of ``attention.flash_attention``, as the reference's
``flash_attention_padded`` is jnp; the float linears and the FFN are plain
products, as the reference's ``jnp.einsum``s are. On CUDA the decode step
launches K1 twice a layer (self-attention over the self cache with the
tile limit ``pos + 1``; cross-attention over the static cross K/V with an
all-true mask and the limit at the last frame, i.e. none), and K4 for
every linear when the config has int8 weights (the encoder's and the
prefill's too).

Caches: ``{"self": KVCache, "cross": {"k", "v"}}``. The self cache is
``S + 128`` positions long for a prompt of S and is int8 with scales when
``kv_dtype == "int8"``; the cross K/V (L, B, n_kv, F, hd) are computed
once at prefill and stay in the compute dtype whatever ``kv_dtype`` is.

On a mesh (``ctx``) the encoder's and the decoder's self- and
cross-attention run over the rank's heads (q, k, v column-parallel, ``wo``
row-parallel onto the residual's placement, the transformer's sites
through ``MeshLayout``), ``gelu_mlp`` is column- then row-parallel (no
K3: it is ungated), and the caches hold the rank's rows and KV heads;
under +seqkv the rules cut the self cache's positions and the cross
K/V's frames instead (``cache_specs``' ``kv_seq``), and each decode
attention merges the blocks' partial statistics across ranks. A
vocabulary that does not divide (51,865) replicates the table.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode.ops import flash_decode_partial
from repro_torch.kv.cache import (batch_valid_mask, init_kv_cache_sharded,
                                  layer_append_slotted)
from repro_torch.models import common
from repro_torch.models.attention import (_split_heads, decode_attention,
                                          flash_attention, make_attn_params,
                                          qkv_project)
from repro_torch.models.param_specs import cache_logical
from repro_torch.models.sharding import (NULL_CTX, NULL_LAYOUT, MeshLayout,
                                         ShardingCtx, axes_of, layout)
from repro_torch.models.transformer import (POS_EMBED_ROWS, _merge_blocks,
                                            attend_decode_seq, cache_seq,
                                            check_supported, ffn_apply,
                                            make_ffn_params, wo_out,
                                            write_prefill)

DECODE_SLACK = 128      # self-cache headroom beyond the prompt


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def make_enc_block(gen, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = common.dtype_of(cfg), gen.device
    return {"ln1": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "attn": make_attn_params(gen, cfg),
            "ln2": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "ffn": make_ffn_params(gen, cfg)}


def make_dec_block(gen, cfg: ModelConfig) -> Dict[str, Any]:
    dt, dev = common.dtype_of(cfg), gen.device
    return {"ln1": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "attn": make_attn_params(gen, cfg),
            "ln_x": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "xattn": make_attn_params(gen, cfg),
            "ln2": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
            "ffn": make_ffn_params(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen.device``."""
    check_supported(cfg)
    dt, dev = common.dtype_of(cfg), gen.device
    return {
        "embed": common.make_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "pos_embed": common.dense_init(gen, (POS_EMBED_ROWS, cfg.d_model),
                                       dt, fan_in=1),
        "enc_blocks": [make_enc_block(gen, cfg)
                       for _ in range(cfg.encoder.n_layers)],
        "enc_ln_f": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
        "dec_blocks": [make_dec_block(gen, cfg)
                       for _ in range(cfg.n_layers)],
        "ln_f": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
    }


# ---------------------------------------------------------------------------
# Full-sequence attention (encoder, prefill)
# ---------------------------------------------------------------------------

def _q_heads(p, x: torch.Tensor, cfg: ModelConfig,
             lay: MeshLayout = NULL_LAYOUT) -> torch.Tensor:
    """The query projection of x (B,S,D) as heads (B,S,h,hd) in the
    attention's placement (on a mesh: the rank's columns, then the
    ``act_heads`` and ``attn_heads`` sites)."""
    q = common.linear(p["wq"], x)
    q, qa = _split_heads(q, cfg.n_heads, cfg.head_dim, lay.q_cols, lay.ctx,
                         "q_cols")
    q = lay.heads(q, qa, lay.act_heads, "q_act_heads")
    return lay.heads(q, lay.act_heads, lay.attn_heads, "q_attn")


def _kv_heads(p, src: torch.Tensor, cfg: ModelConfig,
              lay: MeshLayout = NULL_LAYOUT):
    """The key and value projections of src (B,Sk,D) as heads
    (B,Sk,n_kv,hd) in the cache's placement."""
    k, v = common.linears([p["wk"], p["wv"]], src)
    out = []
    for t in (k, v):
        t, ta = _split_heads(t, cfg.n_kv_heads, cfg.head_dim, lay.kv_cols,
                             lay.ctx, "kv_cols")
        out.append(lay.heads(t, ta, lay.kv_heads, "kv_heads"))
    return out


def _mha(p, x: torch.Tensor, cfg: ModelConfig, kv_x=None, causal=True,
         lay: MeshLayout = NULL_LAYOUT
         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over x (B,S,D), or cross-attention from x to kv_x
    (B,F,D) (never causal). No positions inside: the enc-dec family adds
    them to its inputs. Returns (out (B,S,D), (k, v) each (B,Sk,n_kv,hd));
    on a mesh x and kv_x are whole, the output lands on the residual's
    placement and k, v hold the cache's heads."""
    B, S, _ = x.shape
    q = _q_heads(p, x, cfg, lay)
    k, v = _kv_heads(p, x if kv_x is None else kv_x, cfg, lay)
    o = flash_attention(q, k, v, causal=causal and kv_x is None)
    return wo_out(p["wo"], o, B, S, cfg, lay), (k, v)


def _norm(p, x, cfg, lay: MeshLayout, site: str):
    """The norm of the whole residual (gathered on a mesh)."""
    return common.apply_norm(cfg.norm, p, lay.to_full(x, site), cfg.norm_eps)


def _enc_block(lp, x: torch.Tensor, cfg: ModelConfig,
               lay: MeshLayout = NULL_LAYOUT, train: bool = False
               ) -> torch.Tensor:
    """One encoder layer: non-causal self-attention and the FFN. ``train``:
    the layer's fsdp shards gathered first (``lay.weights``)."""
    if train:
        lp = lay.weights(lp, "enc")
    y = _norm(lp["ln1"], x, cfg, lay, "ln1_in")
    o, _ = _mha(lp["attn"], y, cfg, causal=False, lay=lay)
    x = x + o
    y = _norm(lp["ln2"], x, cfg, lay, "ln2_in")
    return x + ffn_apply(lp["ffn"], y, cfg, lay)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           train: bool = False, lay: MeshLayout = NULL_LAYOUT
           ) -> torch.Tensor:
    """frames: (B,F,D) stub embeddings -> (B,F,D) after the encoder's
    final norm (whole on every rank of a mesh). ``train``: every layer
    under ``remat``, its fsdp shards gathered inside it."""
    _, F, D = frames.shape
    x = frames.to(common.dtype_of(cfg))
    x = x + common.sinusoidal_pos(F, D, x.device)[None].to(x.dtype)
    x = lay.res_local(x)
    for lp in params["enc_blocks"]:
        x = (common.remat(_enc_block, lp, x, cfg, lay, True) if train
             else _enc_block(lp, x, cfg, lay))
    return _norm(params["enc_ln_f"], x, cfg, lay, "enc_ln_f_in")


def _dec_block(lp, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder output, the FFN. Returns (x', (k, v) self, (k, v) cross)."""
    y = _norm(lp["ln1"], x, cfg, lay, "ln1_in")
    o, self_kv = _mha(lp["attn"], y, cfg, causal=True, lay=lay)
    x = x + o
    y = _norm(lp["ln_x"], x, cfg, lay, "ln_x_in")
    o, cross_kv = _mha(lp["xattn"], y, cfg, kv_x=enc_out, lay=lay)
    x = x + o
    y = _norm(lp["ln2"], x, cfg, lay, "ln2_in")
    return x + ffn_apply(lp["ffn"], y, cfg, lay), self_kv, cross_kv


def _dec_embed(params, tokens: torch.Tensor,
               lay: MeshLayout = NULL_LAYOUT) -> torch.Tensor:
    x = common.embed(params["embed"], tokens, lay.ctx, lay.vocab,
                     lay.res_spec())
    pe = params["pos_embed"][:tokens.shape[1]][None]
    return x + lay.res_local(pe).to(x.dtype)


def _logits(params, x: torch.Tensor, cfg: ModelConfig,
            lay: MeshLayout = NULL_LAYOUT) -> torch.Tensor:
    """f32 logits against the embedding table (this rank's vocabulary
    rows on a mesh) after the final norm of the whole residual."""
    x = _norm(params["ln_f"], x, cfg, lay, "ln_f_in")
    return common.unembed_logits(params["embed"]["table"], x)


def decode_full(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT):
    """The decoder over a whole prompt. tokens: (B,S) -> (the residual
    (B,S,D) before the final norm, per-layer list of ((k, v) self, (k, v)
    cross))."""
    x = _dec_embed(params, tokens, lay)
    kvs = []
    for lp in params["dec_blocks"]:
        x, self_kv, cross_kv = _dec_block(lp, x, enc_out, cfg, lay)
        kvs.append((self_kv, cross_kv))
    return x, kvs


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT
                 ) -> torch.Tensor:
    """The reference's ``decode_full(train=True)``: every decoder layer
    under ``remat`` (its fsdp shards gathered inside it), no K/V kept; the
    hidden (B,S,D) after the final norm, whole on every rank of a mesh."""
    def block(lp, h, e):
        return _dec_block(lay.weights(lp, "dec"), h, e, cfg, lay)[0]

    top = lay.weights({k: params[k] for k in ("embed", "pos_embed")}, "top")
    x = _dec_embed(top, tokens, lay)
    for lp in params["dec_blocks"]:
        x = common.remat(block, lp, x, enc_out)
    return _norm(params["ln_f"], x, cfg, lay, "ln_f_in")


def loss_fn(params, batch, cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
            ) -> torch.Tensor:
    """Encode the batch's frames, decode its tokens, chunked cross-entropy
    against the embedding table. On a mesh: this rank's rows of tokens and
    frames, the heads (self and cross) and the FFN's columns over the
    model axis, and this rank's share of the loss (summed over the batch
    axes it is the reference's), vocabulary-parallel over the table's rows
    where they divide the model axis."""
    lay = layout(cfg, ctx, train=True)
    enc_out = encode(params, batch["frames"], cfg, train=True, lay=lay)
    x = decode_train(params, batch["tokens"], enc_out, cfg, lay)
    return common.lm_loss(params, ("embed", "table"), x, batch["labels"],
                          lay)


# ---------------------------------------------------------------------------
# Serving: prefill and the single-token decode step
# ---------------------------------------------------------------------------

def _cross_spec(cfg: ModelConfig, batch: int, ctx: ShardingCtx):
    """The cache rules' spec of the cross K/V (L, batch, n_kv, F, hd)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder.n_frames,
             cfg.head_dim)
    return shape, ctx.spec(cache_logical(("cross", "k"), shape), shape)


def make_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                ctx: ShardingCtx = NULL_CTX) -> Dict[str, Any]:
    """Zeroed caches: the self KV (int8 with scales for an int8-KV config)
    and the cross K/V of ``cfg.encoder.n_frames`` frames. On a mesh this
    rank's part of ``batch`` slots (rows, KV heads, or positions and
    frames under +seqkv)."""
    check_supported(cfg)
    dt = common.dtype_of(cfg)
    self_kv = init_kv_cache_sharded(ctx, cfg.n_layers, batch,
                                    cfg.n_kv_heads, max_len, cfg.head_dim,
                                    dtype=dt,
                                    quantized=(cfg.kv_dtype == "int8"),
                                    device=device)
    shape, spec = _cross_spec(cfg, batch, ctx)
    if ctx.active:
        shape = tuple(d // ctx.n(e) for d, e in zip(shape, spec))
    cross = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    return {"self": self_kv, "cross": cross}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Encode the frames, run the decoder over the prompt, fill the self
    cache (S + 128 positions) and the cross K/V; return (caches, logits
    (B,1,V) f32 at the prompt's last position). On a mesh tokens and
    frames are this data row's rows."""
    lay = layout(cfg, ctx)
    B, S = tokens.shape
    rows = ctx.n(ctx.batch_axes) if ctx.active else 1
    caches = make_caches(cfg, B * rows, S + DECODE_SLACK, tokens.device, ctx)
    enc_out = encode(params, frames, cfg, lay=lay)
    x, kvs = decode_full(params, tokens, enc_out, cfg, lay)

    def stacked(i, j):                      # (L,B,n_kv,Sk,hd)
        return torch.stack([kv[i][j] for kv in kvs]).transpose(2, 3)

    self_kv = write_prefill(caches["self"], stacked(0, 0), stacked(0, 1), S)
    cross = {"k": stacked(1, 0), "v": stacked(1, 1)}
    if ctx.active:
        _, spec = _cross_spec(cfg, B * rows, ctx)
        cross = {n: ctx.local(t, (None, None, None, spec[3]))
                 for n, t in cross.items()}
    cross = {n: t.contiguous() for n, t in cross.items()}
    return {"self": self_kv, "cross": cross}, _logits(params, x[:, -1:],
                                                      cfg, lay)


def _cross_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  ctx: ShardingCtx, frame_axes) -> torch.Tensor:
    """Cross-attention of q (B,H,hd) over one layer's static cross K/V
    (all-true mask, the limit at the last frame: none). Where this rank
    holds a block of the frames (+seqkv), K1 in partial-statistics mode
    over the block and the blocks merged across ranks."""
    B, F = q.shape[0], ck.shape[2]
    ones = torch.ones((B, F), dtype=torch.bool, device=q.device)
    # "no limit": every frame, as a device int (a host int would be copied
    # to the card at each launch, a synchronising copy)
    limit = torch.full((), F, dtype=torch.int32, device=q.device)
    if not frame_axes:
        return decode_attention(q, ck, cv, ones, kv_limit=limit)
    o, m, l = flash_decode_partial(q.contiguous(), ck, cv, ones,
                                   kv_limit=limit)
    return _merge_blocks(o, m, l, ctx, frame_axes, "kv_seq_merge") \
        .to(q.dtype)


def decode_step(params, caches: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One greedy step at the shared cursor ``pos = self.length``. tokens:
    (B,) -> (caches, logits (B,1,V) f32); the self cache is appended in
    place at ``pos`` and its length bumped. Each layer: self-attention
    over the whole self extent (mask ``position <= pos``, K1's tile limit
    ``pos + 1``), cross-attention over the static cross K/V (all-true
    mask, the limit at the last frame), the FFN. The cursor and both
    limits stay on the device: no host sync. On a mesh: this data row's
    rows, the rank's heads (or blocks of positions and frames)."""
    lay = layout(cfg, ctx)
    self_kv = caches["self"]
    cross = caches["cross"]
    B = tokens.shape[0]
    pos = self_kv.length
    positions = pos.expand(B)
    active = torch.ones(B, dtype=torch.bool, device=tokens.device)
    seq = cache_seq(self_kv)
    frame_axes = ()
    if ctx.active:
        frame_axes = axes_of(_cross_spec(cfg, B, ctx)[1][3])
    x = common.embed(params["embed"], tokens[:, None], ctx, lay.vocab,
                     lay.res_spec())
    pe = params["pos_embed"].index_select(0, pos.reshape(1).to(torch.long))
    x = x + lay.res_local(pe)[None].to(x.dtype)
    mask = batch_valid_mask(self_kv.k.shape[3], positions)
    kv_limit = (pos + 1).to(torch.int32)
    for i, lp in enumerate(params["dec_blocks"]):
        y = _norm(lp["ln1"], x, cfg, lay, "ln1_in")
        q, k, v = qkv_project(lp["attn"], y, cfg, positions[:, None], lay)
        if seq:
            o = attend_decode_seq(q, k, v, self_kv.layer(i), positions,
                                  active, cfg, 0, kv_limit, 1, ctx, *seq)
        else:
            k_l, v_l, ks_l, vs_l = layer_append_slotted(
                *self_kv.layer(i), k[:, 0], v[:, 0], positions, active)
            o = decode_attention(q[:, 0], k_l, v_l, mask, ks_l, vs_l,
                                 kv_limit=kv_limit)
        x = x + wo_out(lp["attn"]["wo"], o, B, 1, cfg, lay)
        y = _norm(lp["ln_x"], x, cfg, lay, "ln_x_in")
        qx = _q_heads(lp["xattn"], y, cfg, lay)[:, 0]
        ox = _cross_attend(qx, cross["k"][i], cross["v"][i], ctx,
                           frame_axes)
        x = x + wo_out(lp["xattn"]["wo"], ox, B, 1, cfg, lay)
        y = _norm(lp["ln2"], x, cfg, lay, "ln2_in")
        x = x + ffn_apply(lp["ffn"], y, cfg, lay)
    self_kv.length = (pos + 1).to(torch.int32)
    return caches, _logits(params, x, cfg, lay)
