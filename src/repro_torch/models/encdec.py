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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kv.cache import (batch_valid_mask, init_kv_cache,
                                  layer_append_slotted)
from repro_torch.models import common
from repro_torch.models.attention import (decode_attention, flash_attention,
                                          make_attn_params, qkv_project)
from repro_torch.models.transformer import (POS_EMBED_ROWS, check_supported,
                                            ffn_apply, make_ffn_params,
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

def _mha(p, x: torch.Tensor, cfg: ModelConfig, kv_x=None, causal=True
         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over x (B,S,D), or cross-attention from x to kv_x
    (B,F,D) (never causal). No positions inside: the enc-dec family adds
    them to its inputs. Returns (out (B,S,D), (k, v) each (B,Sk,n_kv,hd))."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = common.linear(p["wq"], x).reshape(B, S, hq, hd)
    k, v = common.linears([p["wk"], p["wv"]], src)
    k = k.reshape(B, src.shape[1], hkv, hd)
    v = v.reshape(B, src.shape[1], hkv, hd)
    o = flash_attention(q, k, v, causal=causal and kv_x is None)
    return common.linear(p["wo"], o.reshape(B, S, hq * hd)), (k, v)


def _enc_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = common.apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
    o, _ = _mha(lp["attn"], y, cfg, causal=False)
    x = x + o
    y = common.apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
    return x + ffn_apply(lp["ffn"], y, cfg)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           train: bool = False) -> torch.Tensor:
    """frames: (B,F,D) stub embeddings -> (B,F,D) after the encoder's
    final norm. ``train``: every layer under ``remat``."""
    _, F, D = frames.shape
    x = frames.to(common.dtype_of(cfg))
    x = x + common.sinusoidal_pos(F, D, x.device)[None].to(x.dtype)
    for lp in params["enc_blocks"]:
        x = (common.remat(_enc_block, lp, x, cfg) if train
             else _enc_block(lp, x, cfg))
    return common.apply_norm(cfg.norm, params["enc_ln_f"], x, cfg.norm_eps)


def _dec_block(lp, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder output, the FFN. Returns (x', (k, v) self, (k, v) cross)."""
    y = common.apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
    o, self_kv = _mha(lp["attn"], y, cfg, causal=True)
    x = x + o
    y = common.apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
    o, cross_kv = _mha(lp["xattn"], y, cfg, kv_x=enc_out)
    x = x + o
    y = common.apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
    return x + ffn_apply(lp["ffn"], y, cfg), self_kv, cross_kv


def _dec_embed(params, tokens: torch.Tensor) -> torch.Tensor:
    x = common.embed(params["embed"], tokens)
    return x + params["pos_embed"][:tokens.shape[1]][None].to(x.dtype)


def decode_full(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                cfg: ModelConfig):
    """The decoder over a whole prompt. tokens: (B,S) -> (hidden (B,S,D)
    after the final norm, per-layer list of ((k, v) self, (k, v) cross))."""
    x = _dec_embed(params, tokens)
    kvs = []
    for lp in params["dec_blocks"]:
        x, self_kv, cross_kv = _dec_block(lp, x, enc_out, cfg)
        kvs.append((self_kv, cross_kv))
    return common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps), kvs


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``decode_full(train=True)``: every decoder layer
    under ``remat``, no K/V kept; the hidden (B,S,D) after the final
    norm."""
    x = _dec_embed(params, tokens)
    for lp in params["dec_blocks"]:
        x = common.remat(lambda p, h, e: _dec_block(p, h, e, cfg)[0], lp, x,
                         enc_out)
    return common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps)


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Encode the batch's frames, decode its tokens, chunked cross-entropy
    against the embedding table."""
    enc_out = encode(params, batch["frames"], cfg, train=True)
    x = decode_train(params, batch["tokens"], enc_out, cfg)
    return common.chunked_ce_loss(params["embed"]["table"], x,
                                  batch["labels"],
                                  chunk=common.ce_chunk(x.shape[1]))


# ---------------------------------------------------------------------------
# Serving: prefill and the single-token decode step
# ---------------------------------------------------------------------------

def make_caches(cfg: ModelConfig, batch: int, max_len: int, device
                ) -> Dict[str, Any]:
    """Zeroed caches: the self KV (int8 with scales for an int8-KV config)
    and the cross K/V of ``cfg.encoder.n_frames`` frames."""
    check_supported(cfg)
    dt = common.dtype_of(cfg)
    self_kv = init_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads, max_len,
                            cfg.head_dim, dtype=dt,
                            quantized=(cfg.kv_dtype == "int8"),
                            device=device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder.n_frames,
             cfg.head_dim)
    cross = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    return {"self": self_kv, "cross": cross}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Encode the frames, run the decoder over the prompt, fill the self
    cache (S + 128 positions) and the cross K/V; return (caches, logits
    (B,1,V) f32 at the prompt's last position)."""
    B, S = tokens.shape
    caches = make_caches(cfg, B, S + DECODE_SLACK, tokens.device)
    enc_out = encode(params, frames, cfg)
    x, kvs = decode_full(params, tokens, enc_out, cfg)

    def stacked(i, j):                      # (L,B,n_kv,Sk,hd)
        return torch.stack([kv[i][j] for kv in kvs]).transpose(2, 3)

    self_kv = write_prefill(caches["self"], stacked(0, 0), stacked(0, 1), S)
    cross = {"k": stacked(1, 0).contiguous(), "v": stacked(1, 1).contiguous()}
    logits = common.unembed_logits(params["embed"]["table"], x[:, -1:])
    return {"self": self_kv, "cross": cross}, logits


def decode_step(params, caches: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One greedy step at the shared cursor ``pos = self.length``. tokens:
    (B,) -> (caches, logits (B,1,V) f32); the self cache is appended in
    place at ``pos`` and its length bumped. Each layer: self-attention
    over the whole self extent (mask ``position <= pos``, K1's tile limit
    ``pos + 1``), cross-attention over the static cross K/V (all-true
    mask, the limit at the last frame), the FFN. The cursor and both
    limits stay on the device: no host sync."""
    self_kv = caches["self"]
    cross = caches["cross"]
    B = tokens.shape[0]
    pos = self_kv.length
    positions = pos.expand(B)
    active = torch.ones(B, dtype=torch.bool, device=tokens.device)
    hq, hd = cfg.n_heads, cfg.head_dim
    x = common.embed(params["embed"], tokens[:, None])
    x = x + params["pos_embed"].index_select(
        0, pos.reshape(1).to(torch.long))[None].to(x.dtype)
    mask = batch_valid_mask(self_kv.k.shape[3], positions)
    kv_limit = (pos + 1).to(torch.int32)
    F = cross["k"].shape[3]
    ones = torch.ones((B, F), dtype=torch.bool, device=tokens.device)
    # "no limit": every frame, as a device int (a host int would be copied
    # to the card at each launch, a synchronising copy)
    cross_limit = torch.full((), F, dtype=torch.int32, device=tokens.device)
    for i, lp in enumerate(params["dec_blocks"]):
        y = common.apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(lp["attn"], y, cfg, positions[:, None])
        k_l, v_l, ks_l, vs_l = layer_append_slotted(
            *self_kv.layer(i), k[:, 0], v[:, 0], positions, active)
        o = decode_attention(q[:, 0], k_l, v_l, mask, ks_l, vs_l,
                             kv_limit=kv_limit)
        x = x + common.linear(lp["attn"]["wo"], o.reshape(B, 1, -1))
        y = common.apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
        qx = common.linear(lp["xattn"]["wq"], y).reshape(B, hq, hd)
        ox = decode_attention(qx, cross["k"][i], cross["v"][i], ones,
                              kv_limit=cross_limit)
        x = x + common.linear(lp["xattn"]["wo"], ox.reshape(B, 1, -1))
        y = common.apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
        x = x + ffn_apply(lp["ffn"], y, cfg)
    self_kv.length = (pos + 1).to(torch.int32)
    x = common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps)
    return caches, common.unembed_logits(params["embed"]["table"], x)
