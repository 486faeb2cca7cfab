"""Model API of the port: ``build_model(cfg, device)`` -> ModelAPI.

Port of ``repro.models.registry`` for the transformer families (dense and
MoE): the fields the serving engine uses (continuous and drain, colocated
and WA), ``make_decode_block`` and ``count_params``.
Sharding contexts are gone (one device per engine in this slice).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kv.cache import reset_slot, write_slot_kv

DECODE_SLACK = 128      # cache headroom beyond the prompt


class ModelAPI(NamedTuple):
    config: ModelConfig
    device: torch.device
    # init(seed) -> params on ``device``
    init: Callable
    # prefill(params, tokens (B,S)) -> (caches sized S + DECODE_SLACK,
    #   last logits (B,1,V))
    prefill: Callable
    # decode(params, caches, tokens) -> (caches, logits (B,1,V)): one
    #   shared-cursor step at caches.length (drain serving), in place
    decode: Callable
    # init_caches(batch, max_len, device=None) -> caches on ``device`` (the
    #   API's by default; "meta" gives their shapes without memory): flat,
    #   or tiered when the config's hot_window > 0
    init_caches: Callable
    # decode_slotted(params, caches, tokens, positions, active, kv_bucket=0,
    #                kv_shards=1) -> (caches, logits (B,1,V)); per-row
    #   cursors, caches in place; kv_shards > 1 is split-KV decode; each
    #   layer's slices are the cache's own (six for a tiered cache)
    decode_slotted: Callable
    # write_slot(caches, single, slot) -> caches: admit a batch-1 prefill
    write_slot: Callable
    # reset_slot(caches, slot) -> caches: zero a retired slot
    reset_slot: Callable
    # decode_block(params, caches, tokens, positions, active, remaining,
    #              eos_ids, *, block_size, kv_bucket=0, kv_shards=1)
    #   -> 7-tuple
    decode_block: Callable
    # prefill_chunk(params, caches, tokens (1,C), slot, start, valid_len)
    #   -> (caches, logits (1,1,V))
    prefill_chunk: Callable
    # the family's KV decouples from its weights, so the WA backend
    # (``core/wa.py``) can serve it
    wa_servable: bool = False


def make_decode_block(decode_slotted: Callable) -> Callable:
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
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
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


def _build_transformer(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    from repro_torch.models import transformer as T
    T.check_supported(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return T.init_params(gen, cfg)

    def prefill(params, tokens):
        cache = T.make_cache(cfg, tokens.shape[0],
                             tokens.shape[1] + DECODE_SLACK, device)
        return T.prefill(params, tokens, cfg, cache)

    def decode(params, caches, tokens):
        return T.decode_step(params, caches, tokens, cfg)

    def init_caches(batch, max_len, device=device):
        return T.make_cache(cfg, batch, max_len, device)

    def decode_slotted(params, caches, tokens, positions, active,
                       kv_bucket: int = 0, kv_shards: int = 1):
        return T.decode_step_slotted(params, caches, tokens, positions,
                                     active, cfg, kv_bucket=kv_bucket,
                                     kv_shards=kv_shards)

    def prefill_chunk(params, caches, tokens, slot, start, valid_len):
        return T.prefill_chunk(params, caches, tokens, slot, start,
                               valid_len, cfg)

    return ModelAPI(cfg, device, init, prefill, decode, init_caches,
                    decode_slotted,
                    write_slot_kv, reset_slot,
                    make_decode_block(decode_slotted), prefill_chunk,
                    wa_servable=True)


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> ModelAPI:
    """The transformer families' API (dense, moe) on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"`` is passed)."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return _build_transformer(cfg, dev)
    raise ValueError(f"family {cfg.family!r} is not ported to repro_torch "
                     "yet (dense and moe only)")


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of a dense or MoE transformer from its shapes,
    as the reference counts it: int8 quantization scales are not
    parameters; norm scales (q/k norms included), LayerNorm biases and the
    router are.
    ``active_only``: each expert tensor counts K of its E experts."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = d * hq + 2 * d * hkv + hq * d
    if cfg.qkv_bias:
        attn += hq + 2 * hkv
    if cfg.qk_norm:
        attn += 2 * hd
    norm = d * (2 if cfg.norm == "layernorm" else 1)
    if cfg.moe is not None:
        m = cfg.moe
        experts = 3 * m.num_experts * d * m.expert_d_ff
        if active_only:
            experts = experts * m.experts_per_token // m.num_experts
        ffn = d * m.num_experts + experts
    else:
        ffn = 3 * d * cfg.d_ff
    per_layer = 2 * norm + attn + ffn
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return emb + cfg.n_layers * per_layer + norm
