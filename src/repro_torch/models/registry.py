"""Model API of the port: ``build_model(cfg, device)`` -> ModelAPI.

Port of ``repro.models.registry`` for every family of the reference: the
transformer (dense, MoE and the VLM backbone), SSM (Mamba-2), hybrid
(RecurrentGemma) and enc-dec (Whisper): the fields the serving engine uses
(continuous and drain, colocated and WA), the training ``loss``,
``make_decode_block`` and ``count_params``. As in the reference, the
slotted fields are None for a family that serves in drain mode only (the
hybrid) or has no slotted API (the enc-dec family, whose ``prefill`` also
takes frames: the engine refuses it); the VLM has no chunk lane (its
prompts put vision embeddings before the text) and no WA backend.

On a mesh (``build_model(cfg, device, ctx)`` with a ``ShardingCtx`` of
more than one rank) every family's serving fields run on this rank's
share: params from ``param_specs.shard_params``, the rows of this data row
(the caller cuts a batch over the rules' batch axes; a batch-1 program
runs on the data row that owns its slot), this rank's cache or state
(``init_caches`` takes the GLOBAL slot count), logits over this rank's
vocabulary rows (``greedy`` and ``full_logits`` read them). Every
family's ``loss`` trains on a mesh under the fsdp rules (its layer
stacks' shards gathered inside each rematerialised unit); the serving
fields refuse the fsdp rules.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kv.cache import reset_slot, write_slot_kv
from repro_torch.models.sharding import NULL_CTX, ShardingCtx, layout

DECODE_SLACK = 128      # cache headroom beyond the prompt


class ModelAPI(NamedTuple):
    config: ModelConfig
    device: torch.device
    # init(seed) -> params on ``device``
    init: Callable
    # prefill(params, tokens (B,S)) -> (caches sized S + DECODE_SLACK,
    #   last logits (B,1,V)); the VLM's takes ``vision_embeds`` (B,N,D)
    #   too (its caches then hold N more positions), the enc-dec family's
    #   ``frames`` (B,F,D) as its third argument
    prefill: Callable
    # decode(params, caches, tokens) -> (caches, logits (B,1,V)): one
    #   shared-cursor step at caches.length (drain serving), in place
    decode: Callable
    # init_caches(batch, max_len, device=None) -> caches on ``device`` (the
    #   API's by default; "meta" gives their shapes without memory): a
    #   KVCache (flat, or tiered when the config's hot_window > 0), a
    #   RecurrentState (ssm), {"kv": ring KVCache, "state": ...} (hybrid)
    #   or {"self": KVCache, "cross": {"k", "v"}} (enc-dec)
    init_caches: Callable
    # -- continuous-batching fields (None: the family serves in drain mode
    #    only, as the hybrid does) ----------------------------------------
    # decode_slotted(params, caches, tokens, positions, active, kv_bucket=0,
    #                kv_shards=1) -> (caches, logits (B,1,V)); per-row
    #   cursors, caches in place; kv_shards > 1 is split-KV decode; each
    #   layer's slices are the cache's own (six for a tiered cache)
    decode_slotted: Optional[Callable] = None
    # write_slot(caches, single, slot) -> caches: admit a batch-1 prefill
    write_slot: Optional[Callable] = None
    # reset_slot(caches, slot) -> caches: zero a retired slot
    reset_slot: Optional[Callable] = None
    # decode_block(params, caches, tokens, positions, active, remaining,
    #              eos_ids, *, block_size, kv_bucket=0, kv_shards=1)
    #   -> 7-tuple
    decode_block: Optional[Callable] = None
    # prefill_chunk(params, caches, tokens (1,C), slot, start, valid_len)
    #   -> (caches, logits (1,1,V))
    prefill_chunk: Optional[Callable] = None
    # the family's KV decouples from its weights, so the WA backend
    # (``core/wa.py``) can serve it
    wa_servable: bool = False
    # loss(params, batch) -> f32 scalar: the family's training loss
    #   (chunked cross-entropy; + 0.01 x the MoE aux loss), blocks under
    #   remat; ``batch`` holds tokens and labels (B,S), plus the VLM's
    #   vision_embeds (B,N,D) or the enc-dec family's frames (B,F,D); on a
    #   mesh this rank's rows and shards, and the result is this rank's
    #   share of the loss (summed over the batch axes it is the loss)
    loss: Optional[Callable] = None
    # the sharding context the fields run under (NULL_CTX: one device)
    ctx: ShardingCtx = NULL_CTX
    # greedy(logits) -> int32 ids: argmax over the last dim, across the
    #   vocabulary shards on a mesh; full_logits(logits): whole rows
    greedy: Optional[Callable] = None
    full_logits: Optional[Callable] = None


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_decode_block(decode_slotted: Callable,
                      greedy: Callable = _argmax) -> Callable:
    """Lift ``decode_slotted`` into a macro-step ``decode_block``: T greedy
    micro-steps as a Python loop over device tensors, with per-slot halting
    on device. No host sync inside the block: tokens, cursors, budgets and
    halt masks never leave the device.

    Returns ``(caches, toks (T,B) int32, emitted (T,B) bool, last_tok,
    positions, active, remaining)``."""

    def decode_block(params, caches, tokens, positions, active, remaining,
                     eos_ids, *, block_size: int, kv_bucket: int = 0,
                     kv_shards: int = 1):
        tok, pos, act, rem = tokens, positions, active, remaining
        toks, emits = [], []
        for _ in range(block_size):
            caches, logits = decode_slotted(params, caches, tok, pos, act,
                                            kv_bucket=kv_bucket,
                                            kv_shards=kv_shards)
            nxt = greedy(logits[:, 0])
            nxt = torch.where(act, nxt, torch.zeros_like(nxt))
            emits.append(act)
            step = act.to(torch.int32)
            pos = pos + step
            rem = rem - step
            act = act & (rem > 0) & ((eos_ids < 0) | (nxt != eos_ids))
            toks.append(nxt)
            tok = nxt
        return (caches, torch.stack(toks), torch.stack(emits), tok, pos,
                act, rem)

    return decode_block


def _seeded_init(module, cfg: ModelConfig, device: torch.device):
    """``init(seed)``: the family module's parameters from a seeded
    ``torch.Generator`` on ``device``."""
    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return module.init_params(gen, cfg)
    return init


def _build_transformer(cfg: ModelConfig, device: torch.device,
                       ctx: ShardingCtx = NULL_CTX) -> ModelAPI:
    """Dense, MoE and VLM. The VLM's prefill takes optional vision
    embeddings and sizes its cache for them; it has no chunk lane and no
    WA backend (its prompts put vision embeddings before the text, which
    the token-only chunk walk cannot cover), so its admission is
    monolithic."""
    from repro_torch.models import transformer as T
    T.check_supported(cfg)
    is_vlm = cfg.family == "vlm"
    rows = ctx.n(ctx.batch_axes) if ctx.active else 1
    greedy, full_logits = _mesh_fields(cfg, ctx)

    def prefill(params, tokens, vision_embeds=None):
        cache = T.make_cache(cfg, tokens.shape[0] * rows,
                             tokens.shape[1] + DECODE_SLACK
                             + (cfg.n_vision_tokens if is_vlm else 0),
                             device, ctx)
        return T.prefill(params, tokens, cfg, cache, vision_embeds, ctx)

    def decode(params, caches, tokens):
        return T.decode_step(params, caches, tokens, cfg, ctx)

    def init_caches(batch, max_len, device=device):
        return T.make_cache(cfg, batch, max_len, device, ctx)

    def decode_slotted(params, caches, tokens, positions, active,
                       kv_bucket: int = 0, kv_shards: int = 1):
        return T.decode_step_slotted(params, caches, tokens, positions,
                                     active, cfg, kv_bucket=kv_bucket,
                                     kv_shards=kv_shards, ctx=ctx)

    def prefill_chunk(params, caches, tokens, slot, start, valid_len):
        return T.prefill_chunk(params, caches, tokens, slot, start,
                               valid_len, cfg, ctx)

    return ModelAPI(cfg, device, _seeded_init(T, cfg, device), prefill,
                    decode, init_caches, decode_slotted,
                    write_slot_kv, reset_slot,
                    make_decode_block(decode_slotted, greedy),
                    None if is_vlm else prefill_chunk,
                    wa_servable=not is_vlm,
                    loss=lambda params, batch: T.loss_fn(params, batch, cfg,
                                                         ctx),
                    ctx=ctx, greedy=greedy, full_logits=full_logits)


def _mesh_fields(cfg: ModelConfig, ctx: ShardingCtx):
    """(greedy, full_logits) of a family on ``ctx``: the argmax and the
    whole rows across the vocabulary shards. (The fsdp rules, which the
    serving fields' own layouts refuse, cut the vocabulary as the serving
    rules do.)"""
    from repro_torch.models import common
    vocab = layout(cfg, ctx, train=True).vocab
    return (lambda lg: common.greedy(lg, ctx, vocab),
            lambda lg: common.gather_logits(lg, ctx, vocab))


def _build_ssm(cfg: ModelConfig, device: torch.device,
               ctx: ShardingCtx = NULL_CTX) -> ModelAPI:
    """Mamba-2: slotted decode, chunked and monolithic admission; the
    state is O(1), so no KV buckets, split-KV, tiers or swap pair, and no
    WA backend (no KV to decouple). On a mesh: the heads cut over the
    model axis, this data row's slots (``init_caches`` takes the global
    slot count)."""
    from repro_torch.kv.state import reset_slot_tree, write_slot_tree
    from repro_torch.models import ssm as S
    greedy, full_logits = _mesh_fields(cfg, ctx)

    def decode_slotted(params, state, tokens, positions, active,
                       kv_bucket: int = 0, kv_shards: int = 1):
        return S.decode_step_slotted(params, state, tokens, positions,
                                     active, cfg, kv_bucket=kv_bucket,
                                     ctx=ctx)

    def prefill_chunk(params, state, tokens, slot, start, valid_len):
        return S.prefill_chunk(params, state, tokens, slot, start,
                               valid_len, cfg, ctx)

    return ModelAPI(
        cfg, device, _seeded_init(S, cfg, device),
        lambda params, tokens: S.prefill(params, tokens, cfg, ctx),
        lambda params, state, tokens: S.decode_step(params, state, tokens,
                                                    cfg, ctx),
        lambda batch, max_len, device=device: S.make_state(cfg, batch,
                                                           device, ctx),
        decode_slotted, write_slot_tree, reset_slot_tree,
        make_decode_block(decode_slotted, greedy), prefill_chunk,
        loss=lambda params, batch: S.loss_fn(params, batch, cfg, ctx),
        ctx=ctx, greedy=greedy, full_logits=full_logits)


def _build_hybrid(cfg: ModelConfig, device: torch.device,
                  ctx: ShardingCtx = NULL_CTX) -> ModelAPI:
    """RecurrentGemma: prefill, shared-cursor decode and caches only (no
    slotted API: the engine serves it in drain mode). On a mesh the RG-LRU
    channels and the attention's query heads are cut over the model axis;
    the ring KV (one KV head) replicates, or its slots are cut under
    +seqkv."""
    from repro_torch.models import rglru as R
    from repro_torch.models import transformer as T
    T.check_supported(cfg)
    greedy, full_logits = _mesh_fields(cfg, ctx)

    return ModelAPI(
        cfg, device, _seeded_init(R, cfg, device),
        lambda params, tokens: R.prefill(params, tokens, cfg,
                                         tokens.shape[1] + DECODE_SLACK,
                                         ctx),
        lambda params, caches, tokens: R.decode_step(params, caches, tokens,
                                                     cfg, ctx),
        lambda batch, max_len, device=device: R.make_caches(
            cfg, batch, max_len, device, ctx),
        loss=lambda params, batch: R.loss_fn(params, batch, cfg, ctx),
        ctx=ctx, greedy=greedy, full_logits=full_logits)


def _build_encdec(cfg: ModelConfig, device: torch.device,
                  ctx: ShardingCtx = NULL_CTX) -> ModelAPI:
    """Whisper: prefill(params, tokens, frames), shared-cursor decode and
    caches only (no slotted API, as in the reference). On a mesh the
    attention heads (self and cross) and the FFN's columns are cut over
    the model axis."""
    from repro_torch.models import encdec as E
    E.check_supported(cfg)
    greedy, full_logits = _mesh_fields(cfg, ctx)

    return ModelAPI(
        cfg, device, _seeded_init(E, cfg, device),
        lambda params, tokens, frames: E.prefill(params, tokens, frames,
                                                 cfg, ctx),
        lambda params, caches, tokens: E.decode_step(params, caches, tokens,
                                                     cfg, ctx),
        lambda batch, max_len, device=device: E.make_caches(
            cfg, batch, max_len, device, ctx),
        loss=lambda params, batch: E.loss_fn(params, batch, cfg, ctx),
        ctx=ctx, greedy=greedy, full_logits=full_logits)


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                ctx: ShardingCtx = NULL_CTX) -> ModelAPI:
    """The family's API (dense, moe, vlm, ssm, hybrid, audio) on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"`` is passed). ``ctx``: this rank's sharding context on
    a mesh."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_transformer(cfg, dev, ctx)
    if cfg.family == "ssm":
        return _build_ssm(cfg, dev, ctx)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg, dev, ctx)
    if cfg.family == "audio":
        return _build_encdec(cfg, dev, ctx)
    raise ValueError(f"unknown family {cfg.family!r}")


def _attn_params(cfg: ModelConfig) -> int:
    """The q/k/v/o projections (with the q/k/v biases and per-head q/k
    norms where the config has them)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = d * hq + 2 * d * hkv + hq * d
    if cfg.qkv_bias:
        attn += hq + 2 * hkv
    if cfg.qk_norm:
        attn += 2 * hd
    return attn


def _ffn_params(cfg: ModelConfig) -> int:
    """The FFN: MoE (router and total experts), gated or gelu_mlp (two
    linears with biases)."""
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        return d * m.num_experts + 3 * m.num_experts * d * m.expert_d_ff
    if cfg.act == "gelu_mlp":
        return 2 * d * cfg.d_ff + cfg.d_ff + d
    return 3 * d * cfg.d_ff


def _attn_block_params(cfg: ModelConfig) -> int:
    """One transformer block: two norms, attention and the FFN."""
    return 2 * _norm_params(cfg) + _attn_params(cfg) + _ffn_params(cfg)


def _norm_params(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def _ssd_block_params(cfg: ModelConfig) -> int:
    """One Mamba-2 layer: its norm and the SSD block."""
    s, d = cfg.ssm, cfg.d_model
    d_in, nh, gn = s.d_inner(d), s.n_heads(d), 2 * s.n_groups * s.d_state
    ssd = (2 * d * d_in + d * gn + d * nh + 3 * nh
           + s.conv_width * (d_in + gn) + d_in + d_in * d)
    return _norm_params(cfg) + ssd


def _mix_block_params(cfg: ModelConfig) -> int:
    """One RG-LRU residual block: two norms, the GeGLU FFN and the mix."""
    d, nh = cfg.d_model, cfg.n_heads
    lw = cfg.rglru.lru_width or d
    mix = 2 * d * lw + cfg.rglru.conv_width * lw + 2 * nh * (lw // nh) ** 2 \
        + lw + lw * d
    return 2 * _norm_params(cfg) + 3 * d * cfg.d_ff + mix


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes, as the reference counts it:
    int8 quantization scales are not parameters; norm scales (q/k norms
    included), LayerNorm biases and the router are.
    ``active_only``: each expert tensor counts K of its E experts."""
    from repro_torch.models.transformer import POS_EMBED_ROWS
    d = cfg.d_model
    pos = POS_EMBED_ROWS * d if cfg.pos == "learned" else 0
    if cfg.family == "audio":
        # no unembed: the logits read the embedding table
        dec = _attn_block_params(cfg) + _attn_params(cfg) + _norm_params(cfg)
        return (cfg.vocab_size * d + pos
                + cfg.encoder.n_layers * _attn_block_params(cfg)
                + cfg.n_layers * dec + 2 * _norm_params(cfg))
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + pos
    if cfg.family == "ssm":
        return emb + cfg.n_layers * _ssd_block_params(cfg) + _norm_params(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import _layer_plan
        n_super, n_tail = _layer_plan(cfg)
        return (emb + n_super * (2 * _mix_block_params(cfg)
                                 + _attn_block_params(cfg))
                + n_tail * _mix_block_params(cfg) + _norm_params(cfg))
    per_layer = _attn_block_params(cfg)
    if active_only and cfg.moe is not None:
        m = cfg.moe
        experts = 3 * m.num_experts * d * m.expert_d_ff
        per_layer -= experts - experts * m.experts_per_token // m.num_experts
    return emb + cfg.n_layers * per_layer + _norm_params(cfg)
