"""Decoder-only transformer (dense, MoE and the VLM backbone): parameters,
prefill, shared-cursor and slotted decode (sequential or split-KV) and
chunked prefill; and the hybrid family's local-attention block over a ring
cache (banded prefill, ``block_decode`` at the shared cursor).

Port of ``repro.models.transformer``: inference, and training
(``forward_train`` and ``loss_fn``: every block rematerialised, K3 with
its gradient in the dense FFN; on a mesh too, through the same sites,
the layers' fsdp shards gathered inside the remat). The reference's layer
``lax.scan`` over stacked parameters becomes a Python loop over the
per-layer parameter dicts of ``params["blocks"]``; caches are updated in place (see
``repro_torch.kv.cache``). On CUDA the decode path launches K1
(attention over the stored bucket view, int8 dequantized inside the
kernel; over a tiered cache, over the hot/cold image resolved in the
compute dtype), K3 (the dense gated FFN with float weights) and K4 (every
linear with int8 weights). The ungated ``gelu_mlp`` FFN (whisper's) has no
kernel in the reference (two ``jnp.einsum``s): with float weights it is
two ``torch.matmul``s here, with int8 weights two K4 linears. An MoE layer
replaces the dense FFN by ``models/moe.py::moe_ffn`` in ``_mix_ffn``, the
one branch point under every block path (full-sequence, slotted, chunk,
tiered, split, WA).

Positions: RoPE inside ``qkv_project``, or a learned table
``params["pos_embed"]`` added to the embeddings (``embed_tokens``). The
VLM puts its precomputed vision embeddings before the text in
``forward_hidden``; positions then run over the whole sequence.

On a mesh (``ctx``, a ``ShardingCtx``) every function runs on this rank's
share: the batch rows of its data row (the caller cuts them), the KV heads
or sequence block of its cache (``init_kv_cache_sharded``), its weight
columns and rows (``param_specs.shard_params``). ``MeshLayout`` resolves,
once per call, where each tensor lives, and every reference ``ctx.ann``
site becomes the collective (or nothing) that moves a tensor from where it
arrives to where the rules put it (the site table in
``models/sharding.py``). One device and a mesh run the same functions:
without a mesh (``NULL_LAYOUT``) every site returns its tensor and a
row-parallel layer is the plain linear. K1 runs over the local heads (or,
when the rules
cut the cache's sequence, over the local block of positions, the blocks'
(o, m, l) merged across ranks), K3 over the local slice of F (a partial D
output), K4 over the local columns or rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ffn.ops import fused_ffn
from repro_torch.kernels.flash_decode.combine import (NEG_INF,
                                                      combine_partial_stats)
from repro_torch.kernels.flash_decode.ops import flash_decode_partial
from repro_torch.kv.cache import (KVCache, batch_valid_mask, bucket_view,
                                  chunk_hot_image, cold_boundary,
                                  init_kv_cache, init_kv_cache_sharded,
                                  layer_append_slotted,
                                  layer_append_ring, layer_append_ring_block,
                                  layer_append_tiered,
                                  layer_read_slot, layer_read_slot_cold,
                                  layer_read_tiered,
                                  layer_read_tiered_shards, layer_write_chunk,
                                  layer_write_chunk_tiered, shard_view,
                                  slot_valid_mask, check_window)
from repro_torch.models import common
from repro_torch.models.attention import (chunk_attention,
                                          chunk_attention_tiered,
                                          decode_attention,
                                          decode_attention_split,
                                          flash_attention, make_attn_params,
                                          qkv_project)
from repro_torch.models.moe import make_moe_params, moe_ffn, moe_ffn_mesh
from repro_torch.models.sharding import (NULL_CTX, NULL_LAYOUT, MeshLayout,
                                         ShardingCtx, entry_of, layout)
from repro_torch.quant.int8 import (QuantizedTensor, dequantize_kv,
                                    quantize_kv)

_FUSED_ACTS = {"swiglu": "silu", "geglu": "gelu"}
# families whose attention blocks this module builds (the hybrid's local
# attention layers are dense blocks over a ring cache, models/rglru.py;
# the enc-dec family's blocks are models/encdec.py's, over these parts)
FAMILIES = ("dense", "moe", "vlm", "hybrid", "audio")
POSITIONS = ("rope", "learned")
# the learned position table's rows (the reference sizes it for its
# largest decode cell plus slack)
POS_EMBED_ROWS = 32768 + 256


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations whose blocks the port does not build."""
    if cfg.family not in FAMILIES or (cfg.family == "moe") != (
            cfg.moe is not None):
        raise ValueError(f"family {cfg.family!r} has no attention blocks "
                         f"in repro_torch (families: {list(FAMILIES)})")
    if cfg.act not in _FUSED_ACTS and cfg.act != "gelu_mlp":
        raise ValueError(f"activation {cfg.act!r} is unknown (gated: "
                         f"{sorted(_FUSED_ACTS)}; ungated: gelu_mlp)")
    if cfg.pos == "sinusoidal":
        # the reference adds the table in its full-sequence forward and its
        # chunk program but not in its decode steps, so its prefill and
        # decode disagree on positions; no registered config uses it
        raise ValueError(
            "pos='sinusoidal' in a decoder-only model is not ported: the "
            "reference adds sinusoidal positions at prefill but not at "
            "decode (a gap of the reference; no registered config uses "
            "it)")
    if cfg.pos not in POSITIONS or cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"positions {cfg.pos!r} with norm {cfg.norm!r} "
                         "are not ported (rope or learned; rmsnorm or "
                         "layernorm)")
    if cfg.kv_dtype not in ("bfloat16", "float32", "int8"):
        raise ValueError(f"kv_dtype {cfg.kv_dtype!r} unsupported")


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def make_ffn_params(gen, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg)
    if cfg.act == "gelu_mlp":
        return {"w_in": common.make_linear(gen, d, f, dt, bias=True,
                                           int8=cfg.weight_int8),
                "w_out": common.make_linear(gen, f, d, dt, bias=True,
                                            int8=cfg.weight_int8)}
    return {"w_gate": common.make_linear(gen, d, f, dt, int8=cfg.weight_int8),
            "w_up": common.make_linear(gen, d, f, dt, int8=cfg.weight_int8),
            "w_down": common.make_linear(gen, f, d, dt,
                                         int8=cfg.weight_int8)}


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              lay: MeshLayout = NULL_LAYOUT) -> torch.Tensor:
    """Gated FFN. Float weights: one fused call (K3 on CUDA, f32 through
    the intermediate, cast once at the end). int8 weights: the three
    linears through K4 with the reference's rounding points. The ungated
    ``gelu_mlp``: two linears with biases (K4 with int8 weights, else
    plain products) around tanh-gelu in f32, rounded to x's dtype.

    On a mesh x is whole and the FFN runs over the local slice of F (K3's
    output, or w_down's, a partial sum of D) and lands on the residual's
    placement (reduce-scatter | all-reduce) in x's dtype."""
    if cfg.act == "gelu_mlp":
        h = common.linear(p["w_in"], x)
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
        return row_linear(p["w_out"], h, lay, lay.mlp, "ffn_out")
    if isinstance(p["w_gate"]["w"], QuantizedTensor):
        up, gate = common.linears([p["w_up"], p["w_gate"]], x)
        return row_linear(p["w_down"], common.gated_act(cfg.act, up, gate),
                          lay, lay.mlp, "ffn_out")
    lead = x.shape[:-1]
    out = fused_ffn(x.reshape(-1, x.shape[-1]), p["w_gate"]["w"],
                    p["w_up"]["w"], p["w_down"]["w"],
                    act=_FUSED_ACTS[cfg.act])
    return lay.to_res(out.reshape(*lead, -1), lay.mlp, "ffn_out") \
        .to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def make_block_params(gen, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    dev = gen.device
    p = {"ln1": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
         "attn": make_attn_params(gen, cfg),
         "ln2": common.make_norm(cfg.norm, cfg.d_model, dt, dev)}
    if cfg.moe is not None:
        p["moe"] = make_moe_params(gen, cfg)
    else:
        p["ffn"] = make_ffn_params(gen, cfg)
    return p


def _mix_ffn(p, x, cfg, lay: MeshLayout = NULL_LAYOUT, train: bool = False):
    """The FFN half of a block: ln2 (of the whole residual), then the MoE
    or the dense FFN, and the residual. ``train``: returns (x', the f32
    MoE load-balance loss: 0 for a dense FFN; on a mesh this rank's share
    of it)."""
    h = lay.to_full(x, "ln2_in")
    h = common.apply_norm(cfg.norm, p["ln2"], h, cfg.norm_eps)
    aux = None
    if cfg.moe is None:
        out = x + ffn_apply(p["ffn"], h, cfg, lay)
    elif not lay.active:
        f = moe_ffn(p["moe"], h, cfg, train=train)
        f, aux = f if train else (f, None)
        out = x + f
    else:
        f = moe_ffn_mesh(p["moe"], h, cfg, lay.ctx, lay.experts,
                         lay.mlp_shard, train)
        f, aux = f if train else (f, None)
        out = x + lay.to_res(f, lay.experts, "ffn_out").to(x.dtype)
    if not train:
        return out
    return out, aux if aux is not None else torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _attention_full_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor, kv_quant_roundtrip: bool,
                        window: int, lay: MeshLayout = NULL_LAYOUT):
    """The attention half of a full-sequence block: ln1, QKV, causal
    attention (banded when ``window`` > 0), the output projection and the
    residual. Returns (x', k, v)."""
    q, k, v = pre_attention(p, x, positions, cfg, lay)
    k_att, v_att = k, v
    if kv_quant_roundtrip:
        k_att = dequantize_kv(*quantize_kv(k), dtype=k.dtype)
        v_att = dequantize_kv(*quantize_kv(v), dtype=v.dtype)
    o = flash_attention(q, k_att, v_att, window)
    return x + attention_out(p, x, o, cfg, lay), k, v


def block_full_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   kv_quant_roundtrip: bool = False, window: int = 0,
                   lay: MeshLayout = NULL_LAYOUT):
    """Full-sequence block (prefill). x: (B,S,D) -> (x', (k, v)).
    ``kv_quant_roundtrip`` (int8-KV prefill): attend the quantize ->
    dequantize image of K/V, the values the cache will hold; the original
    K/V still go to the caller. ``window`` > 0: local attention over the
    band (q - window, q]. On a mesh x is the residual's slice and the
    attention runs over the attention's heads (k, v leave in them)."""
    x, k, v = _attention_full_seq(p, x, cfg, positions, kv_quant_roundtrip,
                                  window, lay)
    return _mix_ffn(p, x, cfg, lay), (k, v)


def block_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, window: int = 0,
                lay: MeshLayout = NULL_LAYOUT):
    """Training block (the reference's ``block_full_seq(train=True)``): no
    K/V leave it and no int8-KV roundtrip. x: (B,S,D) -> (x', aux), aux
    the MoE load-balance loss (0 for a dense FFN), f32. On a mesh the
    layer's fsdp shards are gathered here first (``lay.weights``: under
    ``remat`` the recompute gathers them again) and the block runs
    serving's sites."""
    p = lay.weights(p)
    x, _, _ = _attention_full_seq(p, x, cfg, positions, False, window, lay)
    return _mix_ffn(p, x, cfg, lay, train=True)


def pre_attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT):
    """The layer before attention: ln1 and the QKV projection with per-row
    RoPE phases ``positions`` (B,S). x: (B,S,D); returns q, k, v. On a
    mesh x arrives as the residual (``lay.res``) and q, k, v leave in the
    attention's head placement (``lay.kv_heads``)."""
    h = lay.to_full(x, "ln1_in")
    h = common.apply_norm(cfg.norm, p["ln1"], h, cfg.norm_eps)
    return qkv_project(p["attn"], h, cfg, positions, lay)


def attention_out(p: dict, x: torch.Tensor, o: torch.Tensor,
                  cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT
                  ) -> torch.Tensor:
    """The output projection of o (B,S,h,hd) or (B,h,hd) over the
    attention's heads, onto the residual's placement. On a mesh o goes to
    ``act_heads`` (an all-gather under operator_centric), to wo's rows (a
    slice), through the row-parallel wo and onto the residual
    (reduce-scatter | all-reduce)."""
    return wo_out(p["attn"]["wo"], o, x.shape[0], x.shape[1], cfg, lay)


def wo_out(wo: dict, o: torch.Tensor, B: int, S: int, cfg: ModelConfig,
           lay: MeshLayout = NULL_LAYOUT) -> torch.Tensor:
    """The output projection ``wo`` of o (B,S,h,hd) or (B,h,hd) over the
    attention's heads, onto the residual's placement (``attention_out``'s
    body, for a block whose attention parameters are not at ``attn``)."""
    if lay.active:
        o = lay.heads(o.reshape(B, S, -1, cfg.head_dim), lay.attn_heads,
                      lay.act_heads, "o_act_heads")
        o = lay.ctx.reshard(o.reshape(B, S, -1),
                            (None, None, entry_of(lay.act_heads)),
                            (None, None, entry_of(lay.wo_rows)),
                            site="wo_rows")
    return row_linear(wo, o.reshape(B, S, -1), lay, lay.wo_rows, "attn_out")


def post_attention(p: dict, x: torch.Tensor, o: torch.Tensor,
                   cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT
                   ) -> torch.Tensor:
    """The layer after attention: output projection, residual, ln2 and the
    FFN half. x: (B,S,D); o: (B,S,Hq,hd) or (B,Hq,hd) for S = 1."""
    return _mix_ffn(p, x + attention_out(p, x, o, cfg, lay), cfg, lay)


def attend_decode_slotted(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, kv_slices: Tuple,
                          positions: torch.Tensor, active: torch.Tensor,
                          cfg: ModelConfig, kv_bucket: int = 0,
                          kv_limit=None, kv_shards: int = 1) -> torch.Tensor:
    """The KV side of one decode layer: row b appends its k/v (B,1,n_kv,hd)
    at ``positions[b]`` (inactive rows write nothing) and attends its own
    prefix over the first ``kv_bucket`` positions (0 = full extent); the
    cache slices in ``kv_slices`` are updated in place. ``kv_limit``
    (device int32) lets the kernel skip tiles past every live cursor.
    ``kv_shards`` > 1: split-KV decode, the bucket prefix read as that many
    equal shards (``decode_attention_split``); the caller guarantees the
    bucket divides. Returns o (B,Hq,hd).

    Six slices are a tiered layer: the append stages both tiers, then the
    bucket's hot/cold image is resolved per row from ``positions + 1``
    tokens (on the device) in the compute dtype, and K1 attends that image
    in float mode (one partial launch per shard when split)."""
    if len(kv_slices) == 6:
        slices = layer_append_tiered(*kv_slices, k[:, 0], v[:, 0], positions,
                                     cfg.kv_cold_dtype, active)
        tiers = (positions + 1, kv_bucket)
        geom = (cfg.hot_window, cfg.kv_cold_block, cfg.kv_cold_dtype)
        if kv_shards > 1:
            kc, vc = layer_read_tiered_shards(*slices, *tiers, kv_shards,
                                              *geom, dtype=q.dtype)
        else:
            kc, vc = layer_read_tiered(*slices, *tiers, *geom, dtype=q.dtype)
        ksc = vsc = None
    else:
        k_l, v_l, ks_l, vs_l = layer_append_slotted(
            *kv_slices, k[:, 0], v[:, 0], positions, active)
        if kv_shards > 1:
            kc, vc, ksc, vsc = shard_view(k_l, v_l, ks_l, vs_l, kv_bucket,
                                          kv_shards)
        else:
            kc, vc, ksc, vsc = bucket_view(k_l, v_l, ks_l, vs_l, kv_bucket)
    if kv_shards > 1:
        mask = batch_valid_mask(kc.shape[2] * kc.shape[3], positions)
        return decode_attention_split(q[:, 0], kc, vc, mask, ksc, vsc,
                                      kv_limit=kv_limit)
    mask = batch_valid_mask(kc.shape[2], positions)
    return decode_attention(q[:, 0], kc, vc, mask, ksc, vsc,
                            kv_limit=kv_limit)


def block_decode_slotted(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         kv_slices: Tuple, positions: torch.Tensor,
                         active: torch.Tensor, kv_bucket: int = 0,
                         kv_limit=None, kv_shards: int = 1,
                         lay: MeshLayout = NULL_LAYOUT, seq=None
                         ) -> torch.Tensor:
    """One decode layer with per-row cursors. x: (B,1,D):
    ``pre_attention``, the KV side (``attend_decode_slotted``, or
    ``attend_decode_seq`` where this rank holds a block of positions:
    ``seq`` = ``cache_seq(cache)``), then ``post_attention``."""
    q, k, v = pre_attention(p, x, positions[:, None], cfg, lay)
    if seq:
        o = attend_decode_seq(q, k, v, kv_slices, positions, active, cfg,
                              kv_bucket, kv_limit, kv_shards, lay.ctx, *seq)
    else:
        o = attend_decode_slotted(q, k, v, kv_slices, positions, active,
                                  cfg, kv_bucket, kv_limit, kv_shards)
    return post_attention(p, x, o, cfg, lay)


def block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 kv_slices: Tuple, pos: torch.Tensor, window: int,
                 lay: MeshLayout = NULL_LAYOUT, seq=None) -> torch.Tensor:
    """Shared-cursor decode layer over a ring layer (the hybrid's local
    attention): every row appends at slot ``pos % size`` and attends the
    slots holding positions (pos - window, pos] through K1, with the tile
    limit min(pos + 1, size). ``pos`` is a 0-d device int: no host sync.
    x: (B,1,D); the slices are updated in place. On a mesh the attention
    runs over ``lay.attn_heads``; where this rank holds a block of the
    ring's slots (``seq`` = ``cache_seq(cache)``, +seqkv) the append lands
    on the rank that holds slot ``pos % size`` and the blocks' partial
    statistics merge across ranks (``attend_ring_seq``)."""
    B = x.shape[0]
    q, k, v = pre_attention(p, x, pos.reshape(1, 1).expand(B, 1), cfg, lay)
    if seq:
        o = attend_ring_seq(q, k, v, kv_slices, pos, window, lay.ctx, *seq)
        return post_attention(p, x, o, cfg, lay)
    k_l, v_l, ks_l, vs_l = layer_append_ring(*kv_slices[:4], k[:, 0],
                                             v[:, 0], pos)
    size = k_l.shape[2]
    mask = slot_valid_mask(size, pos, window)[None].expand(B, size) \
        .contiguous()
    kv_limit = torch.clamp_max(pos + 1, size).to(torch.int32)
    o = decode_attention(q[:, 0], k_l, v_l, mask, ks_l, vs_l,
                         kv_limit=kv_limit)
    return post_attention(p, x, o, cfg, lay)


def chunk_positions(start: int, C: int, device) -> torch.Tensor:
    """(1,C) int32 absolute positions of a prompt chunk at ``start``."""
    return start + torch.arange(C, dtype=torch.int32, device=device)[None]


def attend_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_slices: Tuple, slot: int, start: int, valid_len: int,
                 positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The KV side of one chunk-prefill layer: q/k/v (1,C,H,hd) of slot
    ``slot``'s prompt chunk at ``positions`` (1,C) = [start, start+C).
    Writes the chunk's K/V (positions >= valid_len keep their bytes), reads
    the slot's prefix back from the STORED cache and runs causal chunk
    attention against it. Returns o (1,C,Hq,hd).

    A tiered layer (six slices) first builds the exact hot image from the
    PRE-write ring and the chunk (the write may overwrite ring slots early
    queries' hot tails live in), stages the chunk into both tiers, reads
    the slot's cold image and attends both under each query's own boundary
    ``cold_boundary(start + i + 1)``."""
    S = kv_slices[0].shape[2]
    idx = torch.arange(S, device=q.device)
    mask = idx[None, :] <= positions[0][:, None]                  # (C,S)
    k_ch, v_ch = k[0].transpose(0, 1), v[0].transpose(0, 1)
    if len(kv_slices) == 6:
        kh, vh = chunk_hot_image(*kv_slices[4:], k_ch, v_ch, slot, start,
                                 valid_len, S, dtype=q.dtype)
        slices = layer_write_chunk_tiered(*kv_slices, k_ch, v_ch, slot,
                                          start, valid_len, cfg.kv_cold_dtype)
        kc, vc = layer_read_slot_cold(*slices[:4], slot, cfg.kv_cold_dtype,
                                      dtype=q.dtype)
        hot_mask = (idx[None, :] >= cold_boundary(
            positions[0] + 1, cfg.hot_window, cfg.kv_cold_block)[:, None]
        )[None]                                                   # (1,C,S)
        return chunk_attention_tiered(q, kh, vh, kc, vc, hot_mask, mask)
    slices = layer_write_chunk(*kv_slices, k_ch, v_ch, slot, start,
                               valid_len)
    kc, vc = layer_read_slot(*slices, slot, dtype=q.dtype)
    return chunk_attention(q, kc, vc, mask)


def block_prefill_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        kv_slices: Tuple, slot: int, start: int,
                        valid_len: int, lay: MeshLayout = NULL_LAYOUT,
                        seq=None) -> torch.Tensor:
    """Chunk-prefill layer: x (1,C,D) is slot ``slot``'s prompt chunk at
    absolute positions [start, start+C): ``pre_attention``, the KV side
    (``attend_chunk``, or ``attend_chunk_seq`` where this rank holds a
    block of positions), then ``post_attention``."""
    positions = chunk_positions(start, x.shape[1], x.device)
    q, k, v = pre_attention(p, x, positions, cfg, lay)
    if seq:
        o = attend_chunk_seq(q, k, v, kv_slices, slot, start, valid_len,
                             positions, cfg, lay.ctx, *seq)
    else:
        o = attend_chunk(q, k, v, kv_slices, slot, start, valid_len,
                         positions, cfg)
    return post_attention(p, x, o, cfg, lay)


# ---------------------------------------------------------------------------
# On a mesh: placements and the sites' collectives
# ---------------------------------------------------------------------------

def row_linear(p: dict, x: torch.Tensor, lay: MeshLayout, rows,
               site: str) -> torch.Tensor:
    """A row-parallel linear (wo, w_down, w_out) onto the residual's
    placement, in x's dtype: this rank's partial product over its rows
    (``common.linear_partial``), reduced over ``rows`` (reduce-scatter |
    all-reduce), int8's scales applied to the reduced sum, the bias added
    once after the reduction. Without a mesh: ``common.linear``."""
    y, finish = common.linear_partial(p, x, lay.ctx, rows)
    y = lay.to_res(y, rows, site)
    if finish is not common._identity:
        y = finish(y, lay.ctx, lay.res)
    y = y.to(x.dtype)
    b = p.get("b")
    return y if b is None else y + lay.res_local(b).to(y.dtype)


def _merge_blocks(o, m, l, ctx: ShardingCtx, axes, site: str):
    """LSE merge of per-rank partial statistics (o (B,H,hd), m/l (B,H)) of
    disjoint blocks of positions: the (o, m, l) triples are all-gathered
    over ``axes`` and combined in f32 (only they cross ranks)."""
    from repro_torch.core.collectives import all_gather
    hd = o.shape[-1]
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)[None]
    got = all_gather(packed, ctx.mesh, axes, 0, site)
    return combine_partial_stats(got[..., :hd], got[..., hd],
                                 got[..., hd + 1], axis=0)


def attend_decode_seq(q, k, v, kv_slices: Tuple, positions, active,
                      cfg: ModelConfig, kv_bucket: int, kv_limit,
                      kv_shards: int, ctx: ShardingCtx, seq_axes, lo: int):
    """The KV side of a decode layer when this rank holds positions
    [lo, lo + S) of every slot (the rules cut ``kv_seq``): the rows whose
    cursor falls in the block append here; K1 in partial-statistics mode
    walks the block's part of the bucket (in ``kv_shards`` // ranks
    sub-blocks when they divide it), and the blocks merge across ranks.
    q (B,1,H,hd) over all heads. Returns o (B,H,hd) in q's dtype.

    Six slices are a tiered layer: every rank writes the new K/V into its
    whole hot ring, the rank whose block holds the cursor stages the cold
    store, and K1 walks the block's resolved image (global position lo +
    j hot from ``cold_boundary(positions + 1)`` on, read from ring slot
    (lo + j) % H), so every position, ring positions included, is
    attended once across the group."""
    k_l, v_l, ks_l, vs_l = kv_slices[:4]
    S = k_l.shape[2]
    tiered = len(kv_slices) == 6
    if tiered:
        layer_append_tiered(*kv_slices, k[:, 0], v[:, 0], positions,
                            cfg.kv_cold_dtype, active, lo=lo)
    else:
        rel = positions - lo
        mine = active & (rel >= 0) & (rel < S)
        layer_append_slotted(k_l, v_l, ks_l, vs_l, k[:, 0], v[:, 0], rel,
                             mine)
    nb = S if not kv_bucket else max(0, min(S, kv_bucket - lo))
    B, H, hd = q.shape[0], q.shape[2], q.shape[3]
    if nb == 0:
        o = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    else:
        if tiered:
            kc, vc = layer_read_tiered(
                *kv_slices, positions + 1, nb, cfg.hot_window,
                cfg.kv_cold_block, cfg.kv_cold_dtype, dtype=q.dtype, lo=lo)
            ksc = vsc = None
        else:
            kc, vc, ksc, vsc = bucket_view(k_l, v_l, ks_l, vs_l, nb)
        mask = (lo + torch.arange(nb, device=q.device))[None, :] \
            <= positions[:, None]
        lim = torch.clamp(torch.as_tensor(kv_limit, device=q.device) - lo,
                          0, nb).to(torch.int32)
        n = max(1, kv_shards // ctx.n(entry_of(seq_axes)))
        if n > 1 and nb % n == 0:
            Sb = nb // n
            parts = []
            for s in range(n):
                cut = slice(s * Sb, (s + 1) * Sb)
                parts.append(flash_decode_partial(
                    q[:, 0].contiguous(), kc[:, :, cut], vc[:, :, cut],
                    mask[:, cut], None if ksc is None else ksc[:, :, cut],
                    None if vsc is None else vsc[:, :, cut],
                    kv_limit=torch.clamp(lim - s * Sb, 0, Sb)))
            o, m, l = (torch.stack(t) for t in zip(*parts))
            from repro_torch.kernels.flash_decode.combine import \
                merge_partial_stats
            o, m, l = merge_partial_stats(o, m, l, axis=0)
        else:
            o, m, l = flash_decode_partial(q[:, 0].contiguous(), kc, vc,
                                           mask, ksc, vsc, kv_limit=lim)
    return _merge_blocks(o, m, l, ctx, seq_axes, "kv_seq_merge") \
        .to(q.dtype)


def attend_ring_seq(q, k, v, kv_slices: Tuple, pos, window: int,
                    ctx: ShardingCtx, seq_axes, lo: int):
    """The KV side of a shared-cursor ring layer when this rank holds
    slots [lo, lo + n) of a ring of ``n * ranks`` slots (the rules cut
    ``kv_seq``, which is the ring's slot dim, as the reference's
    ``cache_specs`` does): the new K/V land in slot ``pos % size`` on the
    rank that holds it (the others rewrite their own bytes), K1 in
    partial-statistics mode attends this block under the ring's mask
    sliced to it and the limit min(pos + 1, size) - lo, and the blocks'
    (o, m, l) merge across ranks. q (B,1,H,hd) over all heads. Returns o
    (B,H,hd) in q's dtype."""
    k_l, v_l, ks_l, vs_l = kv_slices[:4]
    nb = k_l.shape[2]
    size = nb * ctx.n(entry_of(seq_axes))
    layer_append_ring_block(k_l, v_l, ks_l, vs_l, k[:, 0], v[:, 0], pos,
                            size, lo)
    B = q.shape[0]
    mask = slot_valid_mask(size, pos, window)[lo:lo + nb][None] \
        .expand(B, nb).contiguous()
    lim = torch.clamp(torch.clamp_max(pos + 1, size) - lo, 0, nb) \
        .to(torch.int32)
    o, m, l = flash_decode_partial(q[:, 0].contiguous(), k_l, v_l, mask,
                                   ks_l, vs_l, kv_limit=lim)
    return _merge_blocks(o, m, l, ctx, seq_axes, "kv_seq_merge") \
        .to(q.dtype)


def attend_chunk_seq(q, k, v, kv_slices: Tuple, slot: int, start: int,
                     valid_len: int, positions, cfg: ModelConfig,
                     ctx: ShardingCtx, seq_axes, lo: int):
    """``attend_chunk`` when this rank holds positions [lo, lo + S): the
    chunk's positions that fall in the block are written here (int8
    quantized per position), the slot's block is read back and each
    query's partial softmax statistics over it merge across ranks (the
    reference's weights rounded to the value dtype before the PV
    product).

    Six slices are a tiered layer: the block's hot image is built from
    the PRE-write ring (whole on every rank) and the chunk, the chunk is
    staged into both tiers (the cold store clipped to the block), and
    each key of the block scores against the hot image from the query's
    own ``cold_boundary(start + i + 1)`` on and against the dequantized
    cold block below it, as ``chunk_attention_tiered`` does on one
    device."""
    k_l, v_l, ks_l, vs_l = kv_slices[:4]
    S = k_l.shape[2]
    idx = lo + torch.arange(S, device=q.device)
    _, C, Hq, hd = q.shape
    if len(kv_slices) == 6:
        check_window(start, C, S * ctx.n(entry_of(seq_axes)))
        k_ch, v_ch = k[0].transpose(0, 1), v[0].transpose(0, 1)
        kh, vh = chunk_hot_image(*kv_slices[4:], k_ch, v_ch, slot, start,
                                 valid_len, S, dtype=q.dtype, lo=lo)
        layer_write_chunk_tiered(*kv_slices, k_ch, v_ch, slot, start,
                                 valid_len, cfg.kv_cold_dtype, lo=lo)
        kc, vc = layer_read_slot_cold(k_l, v_l, ks_l, vs_l, slot,
                                      cfg.kv_cold_dtype, dtype=q.dtype)
        hot = (idx[None, :] >= cold_boundary(
            positions[0] + 1, cfg.hot_window, cfg.kv_cold_block)[:, None]
        )[None, None, None]                                   # (1,1,1,C,S)
    else:
        a, b = max(start, lo), min(start + valid_len, lo + S)
        if a < b:
            k_ch = k[0, a - start:b - start].transpose(0, 1)  # (n_kv,c,hd)
            v_ch = v[0, a - start:b - start].transpose(0, 1)
            layer_write_chunk(k_l, v_l, ks_l, vs_l, k_ch, v_ch, slot,
                              a - lo, b - a)
        kc, vc = layer_read_slot(k_l, v_l, ks_l, vs_l, slot, dtype=q.dtype)
        hot = None
    n_kv = kc.shape[1]
    qg = q.reshape(1, C, n_kv, Hq // n_kv, hd).to(torch.float32)
    eq = "bqkgh,bksh->bkgqs"
    sc = torch.einsum(eq, qg, kc.to(torch.float32))
    if hot is not None:
        sc = torch.where(hot, torch.einsum(eq, qg, kh.to(torch.float32)), sc)
    sc = sc / math.sqrt(hd)
    mask = idx[None, :] <= positions[0][:, None]                  # (C,S)
    sc = torch.where(mask[None, None, None], sc, torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1)                                # (1,kv,G,C)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    pv = "bkgqs,bksh->bkgqh"
    if hot is None:
        o = torch.einsum(pv, p.to(vc.dtype).to(torch.float32),
                         vc.to(torch.float32))
    else:
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        o = torch.einsum(pv, torch.where(hot, p, zero).to(vh.dtype)
                         .to(torch.float32), vh.to(torch.float32)) \
            + torch.einsum(pv, torch.where(hot, zero, p).to(vc.dtype)
                           .to(torch.float32), vc.to(torch.float32))
    out = _merge_blocks(o.reshape(-1, C, hd), m.reshape(-1, C),
                        l.reshape(-1, C), ctx, seq_axes, "kv_seq_merge")
    out = out.reshape(n_kv, Hq // n_kv, C, hd).permute(2, 0, 1, 3)
    return out.reshape(1, C, Hq, hd).to(q.dtype)


def cache_seq(cache: KVCache):
    """(the mesh axes, this rank's first position) of a cache whose
    positions the rules cut over ranks, else None."""
    return (cache.seq_axes, cache.seq_lo) if cache.seq_axes else None


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen.device``: ``blocks`` is a list of
    per-layer dicts (the reference stacks them for its scan)."""
    check_supported(cfg)
    dt = common.dtype_of(cfg)
    params: Dict[str, Any] = {
        "embed": common.make_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": [make_block_params(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_f": common.make_norm(cfg.norm, cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.make_embedding(gen, cfg.vocab_size,
                                                  cfg.d_model, dt)
    if cfg.pos == "learned":
        params["pos_embed"] = common.dense_init(
            gen, (POS_EMBED_ROWS, cfg.d_model), dt, fan_in=1)
    return params


def unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"] if cfg.tie_embeddings
            else params["unembed"])["table"]


def final_logits(params, x, cfg, lay: MeshLayout = NULL_LAYOUT):
    """f32 logits of the residual x after the final norm; on a mesh x is
    gathered whole first and the logits cover this rank's vocabulary
    rows."""
    x = lay.to_full(x, "ln_f_in")
    x = common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps)
    return common.unembed_logits(unembed_table(params, cfg), x)


def add_learned_pos(params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT
                    ) -> torch.Tensor:
    """x (B,S,D) plus the learned positions of ``positions`` ((B,S) or
    (S,) device ints) where the config has them; else x. On a mesh the
    table's rows are sliced to the residual's D."""
    if cfg.pos != "learned":
        return x
    pe = params["pos_embed"][positions.to(torch.long)]
    return x + lay.res_local(pe).to(x.dtype)


def embed_tokens(params, tokens: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, lay: MeshLayout = NULL_LAYOUT
                 ) -> torch.Tensor:
    """Token embeddings (B,S,D) of tokens (B,S) at ``positions`` (on a
    mesh: onto the residual's placement)."""
    x = common.embed(params["embed"], tokens, lay.ctx, lay.vocab,
                     lay.res_spec())
    return add_learned_pos(params, x, positions, cfg, lay)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward_hidden(params, tokens: torch.Tensor, cfg: ModelConfig,
                   vision_embeds=None, ctx: ShardingCtx = NULL_CTX):
    """Inference forward of a prompt. tokens: (B,S_text); ``vision_embeds``
    (B,N,D) go before the text (the VLM's stub frontend) -> (hidden (B,S,D)
    after the final norm, S = N + S_text; per-layer list of (k, v) each
    (B,S,n_kv,hd)). int8-KV configs attend the quantized image of K/V, as
    the reference's prefill does. On a mesh the hidden state is whole and
    each (k, v) holds the attention's heads."""
    lay = layout(cfg, ctx)
    x = common.embed(params["embed"], tokens, ctx, lay.vocab, lay.res_spec())
    if vision_embeds is not None:
        x = torch.cat([lay.res_local(vision_embeds).to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x = add_learned_pos(params, x, positions[0], cfg, lay)
    roundtrip = cfg.kv_dtype == "int8"
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for lp in params["blocks"]:
        x, kv = block_full_seq(lp, x, cfg, positions,
                               kv_quant_roundtrip=roundtrip, lay=lay)
        kvs.append(kv)
    x = lay.to_full(x, "ln_f_in")
    return common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps), kvs


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig,
                  vision_embeds=None, ctx: ShardingCtx = NULL_CTX, lay=None):
    """Training forward (the reference's ``forward_hidden(train=True)``):
    the vision embeddings, if any, before the text, learned positions where
    the config has them, every block under ``remat``. Returns (hidden
    (B,S,D) after the final norm, the f32 aux loss summed over layers).
    On a mesh (``ctx``; ``lay`` its training layout) tokens are this
    rank's rows, the hidden state is whole over the other axes and the aux
    loss is this rank's share."""
    lay = layout(cfg, ctx, train=True) if lay is None else lay
    top = lay.weights({k: params[k] for k in ("embed", "pos_embed")
                       if k in params}, "top")
    x = common.embed(top["embed"], tokens, ctx, lay.vocab, lay.res_spec())
    if vision_embeds is not None:
        x = torch.cat([lay.res_local(vision_embeds).to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x = add_learned_pos(top, x, positions[0], cfg, lay)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["blocks"]:
        x, a = common.remat(block_train, lp, x, cfg, positions, 0, lay)
        aux = aux + a
    x = lay.to_full(x, "ln_f_in")
    return common.apply_norm(cfg.norm, params["ln_f"], x, cfg.norm_eps), aux


def loss_fn(params, batch, cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
            ) -> torch.Tensor:
    """``batch``: tokens and labels (B,S) (and the VLM's vision_embeds
    (B,N,D)). Chunked cross-entropy over the text positions plus 0.01 x
    the aux loss, as the reference's ``loss_fn``. On a mesh: this rank's
    rows of the batch and its parameter shards; returns this rank's share
    of the loss (summed over the batch axes it is the reference's), the
    cross-entropy vocabulary-parallel over the unembedding's rows."""
    lay = layout(cfg, ctx, train=True)
    vis = batch.get("vision_embeds")
    x, aux = forward_train(params, batch["tokens"], cfg, vis, ctx, lay)
    if vis is not None:
        x = x[:, vis.shape[1]:]                  # loss over text positions
    key = ("embed" if cfg.tie_embeddings else "unembed", "table")
    return common.lm_loss(params, key, x, batch["labels"], lay) + 0.01 * aux


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache: KVCache,
            vision_embeds=None, ctx: ShardingCtx = NULL_CTX
            ) -> Tuple[KVCache, torch.Tensor]:
    """Encode the context (the vision embeddings, if any, then the text),
    fill the cache over the whole sequence, return last-position logits
    (B,1,V) f32 (on a mesh: this rank's vocabulary rows)."""
    x, kvs = forward_hidden(params, tokens, cfg, vision_embeds, ctx)
    k_all = torch.stack([k for k, _ in kvs]).transpose(2, 3)  # (L,B,n_kv,S,hd)
    v_all = torch.stack([v for _, v in kvs]).transpose(2, 3)
    cache = write_prefill(cache, k_all, v_all, x.shape[1])
    logits = common.unembed_logits(unembed_table(params, cfg), x[:, -1:])
    return cache, logits


def write_prefill(cache: KVCache, k_all, v_all, S: int) -> KVCache:
    """Bulk-write a prefilled context (positions [0, S)) into the cache.
    A ring cache shorter than S keeps the last ``size`` positions, rolled
    so that position p lands in slot p % size. A tiered cache raises: its
    admissions run the chunk program, which stages both tiers."""
    if cache.is_tiered:
        raise ValueError(
            "monolithic write_prefill does not support tiered caches — the "
            "serving engine routes tiered admissions through the chunk "
            "program (full-width), which stages both tiers")
    size = cache.k.shape[3]
    n = S
    if cache.seq_axes:
        # this rank's block [seq_lo, seq_lo + size) of the positions
        lo = cache.seq_lo
        n = max(0, min(size, S - lo))
        k_all = k_all[..., lo:lo + n, :]
        v_all = v_all[..., lo:lo + n, :]
    if cache.window and S > size:
        shift = (S - size) % size
        k_all = torch.roll(k_all[..., S - size:, :], shift, dims=3)
        v_all = torch.roll(v_all[..., S - size:, :], shift, dims=3)
        n = size
    if cache.is_quantized:
        kq, ks = quantize_kv(k_all)
        vq, vs = quantize_kv(v_all)
        cache.k[..., :n, :].copy_(kq)
        cache.v[..., :n, :].copy_(vq)
        cache.k_scale[..., :n, :].copy_(ks)
        cache.v_scale[..., :n, :].copy_(vs)
    else:
        cache.k[..., :n, :].copy_(k_all)
        cache.v[..., :n, :].copy_(v_all)
    cache.length = torch.full((), S, dtype=torch.int32,
                              device=cache.k.device)
    return cache


# ---------------------------------------------------------------------------
# Decode (shared cursor, slotted) and chunked prefill
# ---------------------------------------------------------------------------

def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
                ) -> Tuple[KVCache, torch.Tensor]:
    """Shared-cursor decode step (drain serving). tokens: (B,) last emitted
    ids; every row appends at ``cache.length`` and attends the whole
    extent up to it; the length is bumped. Returns (cache, logits (B,1,V)
    f32). The slotted step with every row live at the one cursor, so no
    host sync: the cursor stays on the device."""
    B = tokens.shape[0]
    return decode_step_slotted(
        params, cache, tokens, cache.length.expand(B),
        torch.ones(B, dtype=torch.bool, device=tokens.device), cfg,
        ctx=ctx)


def decode_step_slotted(params, cache: KVCache, tokens: torch.Tensor,
                        positions: torch.Tensor, active: torch.Tensor,
                        cfg: ModelConfig, kv_bucket: int = 0,
                        kv_shards: int = 1, ctx: ShardingCtx = NULL_CTX
                        ) -> Tuple[KVCache, torch.Tensor]:
    """Continuous-batching decode step. tokens/positions/active: (B,)
    device tensors. Row b appends at positions[b] and attends
    0..positions[b]. Returns (cache, logits (B,1,V) f32). Makes no host
    sync: the kernel's tile limit ``max(positions[active]) + 1`` stays on
    the device. ``kv_shards`` > 1: split-KV decode (block_decode_slotted).
    On a mesh: this data row's slots, this rank's cache; the logits cover
    this rank's vocabulary rows."""
    lay, seq = layout(cfg, ctx), cache_seq(cache)
    x = embed_tokens(params, tokens[:, None], positions[:, None], cfg, lay)
    live = torch.where(active, positions, torch.full_like(positions, -1))
    kv_limit = (live.max() + 1).to(torch.int32)
    for i, lp in enumerate(params["blocks"]):
        x = block_decode_slotted(lp, x, cfg, cache.layer(i), positions,
                                 active, kv_bucket=kv_bucket,
                                 kv_limit=kv_limit, kv_shards=kv_shards,
                                 lay=lay, seq=seq)
    cache.length = torch.maximum(
        cache.length, (torch.where(active, positions, 0).max() + 1)
        .to(torch.int32))
    return cache, final_logits(params, x, cfg, lay)


def prefill_chunk(params, cache: KVCache, tokens: torch.Tensor, slot: int,
                  start: int, valid_len: int, cfg: ModelConfig,
                  ctx: ShardingCtx = NULL_CTX
                  ) -> Tuple[KVCache, torch.Tensor]:
    """Chunked prefill: tokens (1,C) are slot ``slot``'s prompt chunk at
    positions [start, start+valid_len); positions >= valid_len are padding,
    masked out of the KV write and of the returned logits. Returns (cache,
    logits (1,1,V)) at the chunk's last valid position. A ring cache
    raises, as in the reference."""
    if cache.window:
        raise ValueError("chunked prefill requires a non-windowed cache "
                         "(ring order has no per-position write offset)")
    lay, seq = layout(cfg, ctx), cache_seq(cache)
    x = embed_tokens(params, tokens,
                     chunk_positions(start, tokens.shape[1], tokens.device),
                     cfg, lay)
    for i, lp in enumerate(params["blocks"]):
        x = block_prefill_chunk(lp, x, cfg, cache.layer(i), slot, start,
                                valid_len, lay=lay, seq=seq)
    cache.length = torch.clamp_min(cache.length, start + valid_len)
    return cache, final_logits(params, x[:, valid_len - 1:valid_len], cfg,
                               lay)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ctx: ShardingCtx = NULL_CTX) -> KVCache:
    """The config's slot cache: flat, or tiered when ``hot_window`` > 0. On
    a mesh, this rank's part of it (``init_kv_cache_sharded``)."""
    check_supported(cfg)
    tiered = cfg.hot_window > 0
    return init_kv_cache_sharded(
        ctx, cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim,
        dtype=common.dtype_of(cfg), quantized=(cfg.kv_dtype == "int8"),
        device=device, hot_window=cfg.hot_window if tiered else 0,
        cold_block=cfg.kv_cold_block if tiered else 0,
        cold_dtype=cfg.kv_cold_dtype if tiered else "bfloat16")
