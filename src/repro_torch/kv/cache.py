"""KV cache: the contiguous (L, B, n_kv, S_max, head_dim) cache, flat,
int8 with per-(b, head, position) f32 scales, or tiered.

Port of the flat, int8, tiered, split-KV and preemption swap-pair parts of
``repro.kv.cache``. Caches are updated IN PLACE: every write below
mutates the cache tensors it is given and returns them. That is the
PyTorch form of the reference's buffer donation (each step's cache output
aliases its input there), so steady-state decode never holds two copies
of the KV. Rows a write does not target keep their bytes, inactive decode
rows stay byte-identical, and chunk positions at or past ``valid_len``
keep their previous bytes.

A TIERED cache keeps every position in a cold tier (``k``/``v``) at
``cold_dtype``: the compute dtype verbatim (``"bfloat16"``), int8 or
packed int4 with per-row f32 scales, and the most recent positions exactly
in a hot ring (``hot_k``/``hot_v``) of ``hot_window + cold_block`` slots at
the compute dtype. Every write stages a position into both tiers; the
hot-to-cold boundary ``cold_boundary(count)`` is read-side arithmetic on
the device cursors, so demotion moves no bytes and needs no host round
trip.

On a mesh (``init_kv_cache_sharded``) a rank holds its part of a cache:
its slots, and its KV heads or, when the rules cut the sequence, its block
[seq_lo, seq_lo + S) of every slot's positions. A tiered cache's hot ring
is never cut over the sequence (its axis is position mod H): every rank
holds the whole ring of its slots and heads. The tiered functions take the
block's offset (``lo``), so that on a block they give that block of what
they give on the whole cache.

A RING cache (``window`` > 0, the hybrid family's local attention) holds
min(window, max_len) slots; position p lives in slot p % size, and the
valid mask of a query resolves which absolute position each slot holds.
It is written with one shared cursor (drain serving: ``layer_append_ring``
at ``length % size``, on the device) and filled by ``write_prefill``,
which keeps the last ``size`` positions of a longer prompt rolled into
ring order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.quant.int4 import dequantize_kv_int4, quantize_kv_int4
from repro_torch.quant.int8 import dequantize_kv, quantize_kv

COLD_DTYPES = ("bfloat16", "int8", "int4")


@dataclass
class KVCache:
    k: torch.Tensor                 # (L,B,n_kv,S,hd_c) dtype or int8: the
    v: torch.Tensor                 # flat cache, or the cold tier
    k_scale: Optional[torch.Tensor]  # (L,B,n_kv,S,1) f32: int8/int4 only
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor            # () int32 upper-bound cursor
    hot_k: Optional[torch.Tensor] = None   # (L,B,n_kv,H,hd) compute dtype
    hot_v: Optional[torch.Tensor] = None   # ring, tiered caches only
    hot_window: int = 0             # 0: flat (untiered)
    cold_block: int = 0             # demotion granularity (tokens)
    cold_dtype: str = "bfloat16"    # bfloat16 | int8 | int4
    window: int = 0                 # 0: full context; > 0: ring buffer
    # on a mesh whose rules cut the sequence (``kv_seq``): the mesh axes
    # the positions are cut over and the first position this rank holds
    # (its block is [seq_lo, seq_lo + S) of the global extent)
    seq_axes: Tuple[str, ...] = ()
    seq_lo: int = 0

    @property
    def is_quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def is_tiered(self) -> bool:
        return self.hot_k is not None

    def layer(self, i: int):
        """One layer's views (writes land in the cache): (k, v, k_scale,
        v_scale), and (hot_k, hot_v) after them for a tiered cache."""
        out = tuple(None if a is None else a[i]
                    for a in (self.k, self.v, self.k_scale, self.v_scale))
        if self.is_tiered:
            out += (self.hot_k[i], self.hot_v[i])
        return out


# ---------------------------------------------------------------------------
# Tier geometry
# ---------------------------------------------------------------------------

def hot_extent(hot_window: int, cold_block: int) -> int:
    """Hot-ring size: the live hot region [cold_boundary, cursor] spans at
    most hot_window + cold_block - 1 positions, so a ring of hot_window +
    cold_block slots holds each of them in its own slot."""
    return hot_window + cold_block


def cold_boundary(counts, hot_window: int, cold_block: int) -> torch.Tensor:
    """First position still HOT for a row holding ``counts`` tokens:
    floor((counts - hot_window) / cold_block) * cold_block, clamped at 0.
    Positions below it read the cold tier. Device arithmetic on the
    cursors' own device (no host sync)."""
    c = torch.as_tensor(counts).to(torch.int32)
    over = torch.clamp_min(c - hot_window, 0)
    return torch.div(over, cold_block, rounding_mode="floor") * cold_block


def cold_pack_dim(head_dim: int, cold_dtype: str) -> int:
    """Stored head_dim of the cold tier (int4 packs two nibbles a byte)."""
    if cold_dtype == "int4":
        if head_dim % 2:
            raise ValueError(f"int4 cold tier needs even head_dim, "
                             f"got {head_dim}")
        return head_dim // 2
    return head_dim


def quantize_cold(x: torch.Tensor, cold_dtype: str):
    """(values, scale) at the cold dtype; a bf16 cold tier stores x."""
    if cold_dtype == "int4":
        return quantize_kv_int4(x)
    if cold_dtype == "int8":
        return quantize_kv(x)
    return x, None


def cold_read(k_l, v_l, k_scale_l, v_scale_l, cold_dtype: str,
              dtype=torch.bfloat16):
    """A cold-tier slice in the compute dtype: int4 unpacks, int8 rescales,
    a bf16 tier casts."""
    if k_scale_l is None:
        return k_l.to(dtype), v_l.to(dtype)
    if cold_dtype == "int4":
        return (dequantize_kv_int4(k_l, k_scale_l, dtype),
                dequantize_kv_int4(v_l, v_scale_l, dtype))
    return (dequantize_kv(k_l, k_scale_l, dtype),
            dequantize_kv(v_l, v_scale_l, dtype))


def init_kv_cache(n_layers: int, batch: int, n_kv: int, max_len: int,
                  head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
                  device=None, hot_window: int = 0,
                  cold_block: int = 0, cold_dtype: str = "bfloat16",
                  window: int = 0) -> KVCache:
    """A zeroed cache: flat (float or int8 with scales), tiered when
    ``hot_window`` > 0 (cold tier at ``cold_dtype`` + a hot ring of
    ``hot_extent(hot_window, cold_block)`` slots at ``dtype``), or a ring
    of min(window, max_len) slots when ``window`` > 0."""
    def mk(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    length = torch.zeros((), dtype=torch.int32, device=device)
    if hot_window:
        if quantized:
            raise ValueError("tiered KV (hot_window > 0) subsumes the flat "
                             "int8 cache; use kv_cold_dtype instead of "
                             "kv_dtype='int8'")
        if window:
            raise ValueError("tiered KV does not compose with sliding-window "
                             "(ring) caches")
        if cold_block < 1:
            raise ValueError(f"cold_block must be >= 1, got {cold_block}")
        if cold_dtype not in COLD_DTYPES:
            raise ValueError(f"unknown kv_cold_dtype {cold_dtype!r}")
        scaled = cold_dtype in ("int8", "int4")
        cshape = (n_layers, batch, n_kv, max_len,
                  cold_pack_dim(head_dim, cold_dtype))
        sshape = cshape[:-1] + (1,)
        hshape = (n_layers, batch, n_kv, hot_extent(hot_window, cold_block),
                  head_dim)
        store = torch.int8 if scaled else dtype
        return KVCache(mk(cshape, store), mk(cshape, store),
                       mk(sshape, torch.float32) if scaled else None,
                       mk(sshape, torch.float32) if scaled else None,
                       length, hot_k=mk(hshape, dtype),
                       hot_v=mk(hshape, dtype), hot_window=hot_window,
                       cold_block=cold_block, cold_dtype=cold_dtype)
    size = min(window, max_len) if window else max_len
    shape = (n_layers, batch, n_kv, size, head_dim)
    sshape = shape[:-1] + (1,)
    store = torch.int8 if quantized else dtype
    return KVCache(mk(shape, store), mk(shape, store),
                   mk(sshape, torch.float32) if quantized else None,
                   mk(sshape, torch.float32) if quantized else None,
                   length, window=window)


def init_kv_cache_sharded(ctx, n_layers: int, batch: int, n_kv: int,
                          max_len: int, head_dim: int, dtype=torch.bfloat16,
                          quantized: bool = False, device=None,
                          window: int = 0, hot_window: int = 0,
                          cold_block: int = 0,
                          cold_dtype: str = "bfloat16") -> KVCache:
    """This rank's part of a flat (float or int8) cache of ``batch`` slots
    and ``max_len`` positions, of a ring of min(window, max_len) slots
    (``window`` > 0), or of a tiered cache (``hot_window`` > 0), under
    ``ctx``'s rules (``cache_specs``): its slots (batch over the data
    axes), its KV heads (``kv_heads``) or, when the rules cut the sequence
    (``kv_seq``, +seqkv and the WA attention domain), its block of
    positions (of a ring: of its slots). A tiered cache's cold tier and
    scales are cut as a flat cache is; its hot ring only over the slots
    and the KV heads (the ring axis holds positions mod H, never a block
    of them); the tier geometry stays whole. Without a mesh this is
    ``init_kv_cache``."""
    from repro_torch.models.param_specs import cache_logical
    from repro_torch.models.sharding import axes_of
    size = min(window, max_len) if window else max_len
    shape = (n_layers, batch, n_kv, size, head_dim)
    if not ctx.active:
        return init_kv_cache(n_layers, batch, n_kv, max_len, head_dim,
                             dtype=dtype, quantized=quantized, device=device,
                             hot_window=hot_window, cold_block=cold_block,
                             cold_dtype=cold_dtype, window=window)
    spec = ctx.spec(cache_logical(("k",), shape), shape)
    local = [d // ctx.n(e) for d, e in zip(shape, spec)]
    cache = init_kv_cache(*local, dtype=dtype, quantized=quantized,
                          device=device, hot_window=hot_window,
                          cold_block=cold_block, cold_dtype=cold_dtype)
    cache.window = window
    cache.seq_axes = axes_of(spec[3])
    cache.seq_lo = ctx.index(spec[3]) * local[3] if cache.seq_axes else 0
    return cache


# ---------------------------------------------------------------------------
# Per-layer reads
# ---------------------------------------------------------------------------

def layer_read(k_l, v_l, k_scale_l, v_scale_l, dtype=torch.bfloat16):
    if k_scale_l is not None:
        return (dequantize_kv(k_l, k_scale_l, dtype),
                dequantize_kv(v_l, v_scale_l, dtype))
    return k_l.to(dtype), v_l.to(dtype)


def bucket_view(k_l, v_l, k_scale_l, v_scale_l, bucket: int):
    """The first ``bucket`` positions of the STORED buffers as views (no
    copy, no dequantization); 0 or >= S is the full extent. The decode
    path hands these views to the flash-decode kernel, which dequantizes
    int8 inside the kernel."""
    S = k_l.shape[2]
    if not bucket or bucket >= S:
        return k_l, v_l, k_scale_l, v_scale_l

    def cut(a):
        return None if a is None else a[:, :, :bucket]

    return cut(k_l), cut(v_l), cut(k_scale_l), cut(v_scale_l)


def layer_read_bucket(k_l, v_l, k_scale_l, v_scale_l, bucket: int,
                      dtype=torch.bfloat16):
    """``layer_read`` over only the first ``bucket`` positions."""
    return layer_read(*bucket_view(k_l, v_l, k_scale_l, v_scale_l, bucket),
                      dtype=dtype)


# ---------------------------------------------------------------------------
# Split-KV shard-local layout: a READ-time view of the contiguous bucket
# prefix cut into n equal sequence blocks; writes and cursors stay absolute.
# ---------------------------------------------------------------------------

def shard_extent(extent: int, n_shards: int) -> int:
    """Shard-local block length of a (bucketed) extent; the extent must cut
    into ``n_shards`` equal contiguous blocks."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if extent % n_shards:
        raise ValueError(
            f"KV extent {extent} not divisible by n_shards={n_shards}")
    return extent // n_shards


def shard_kv_limits(kv_limit, n_shards: int, block: int) -> torch.Tensor:
    """(n_shards,) int32 on the limit's device: shard s owns absolute
    positions [s*block, (s+1)*block), so its live extent is
    clamp(kv_limit - s*block, 0, block). No host sync; a shard clamped to
    0 is skipped whole by the kernel (the merge identity)."""
    lim = torch.as_tensor(kv_limit, dtype=torch.int32).reshape(())
    starts = torch.arange(n_shards, dtype=torch.int32,
                          device=lim.device) * block
    return torch.clamp(lim - starts, 0, block)


def shard_view(k_l, v_l, k_scale_l, v_scale_l, bucket: int, n_shards: int):
    """``bucket_view``'s prefix of the STORED buffers as shard-major views
    (B,n_kv,n_shards,Sb,hd) (scales (B,n_kv,n_shards,Sb,1)): no copy, no
    dequantization. Shard s, ``[:, :, s]``, is positions [s*Sb, (s+1)*Sb)
    with the cache's own row strides."""
    views = bucket_view(k_l, v_l, k_scale_l, v_scale_l, bucket)
    B, n_kv, Se = views[0].shape[:3]
    Sb = shard_extent(Se, n_shards)
    return tuple(None if a is None
                 else a.view(B, n_kv, n_shards, Sb, a.shape[-1])
                 for a in views)


def layer_read_shards(k_l, v_l, k_scale_l, v_scale_l, bucket: int,
                      n_shards: int, dtype=torch.bfloat16):
    """Shard-major bucketed read in the compute dtype: ``layer_read_bucket``
    with the sequence axis cut into (n_shards, Sb)."""
    return layer_read(*shard_view(k_l, v_l, k_scale_l, v_scale_l, bucket,
                                  n_shards), dtype=dtype)


def layer_read_slot(k_l, v_l, k_scale_l, v_scale_l, slot: int,
                    dtype=torch.bfloat16):
    """One batch row's (1,n_kv,S,hd) K/V in the compute dtype."""
    def take(a):
        return None if a is None else a[slot:slot + 1]

    return layer_read(take(k_l), take(v_l), take(k_scale_l),
                      take(v_scale_l), dtype)


# ---------------------------------------------------------------------------
# Per-layer writes (in place)
# ---------------------------------------------------------------------------

def _put_rows(dst, new, rows, slots, act):
    """Row b of ``dst`` (B,n_kv,S,x) takes ``new[b]`` (n_kv,x) at position
    ``slots[b]`` where ``act[b]``; other rows write back their own bytes.
    ``rows``: arange(B) on the cursors' device."""
    cur = dst[rows, :, slots]                            # (B,n_kv,x)
    dst[rows, :, slots] = torch.where(act[:, None, None], new.to(dst.dtype),
                                      cur)


def _row_operands(positions: torch.Tensor, active):
    """(rows, active) for ``_put_rows``: every row active by default."""
    if active is None:
        active = torch.ones(positions.shape, dtype=torch.bool,
                            device=positions.device)
    return torch.arange(positions.shape[0], device=positions.device), active


def layer_append_slotted(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                         positions: torch.Tensor,
                         active: Optional[torch.Tensor] = None):
    """Row b writes ``k_new[b]`` (n_kv,hd) at its own cursor
    ``positions[b]``; inactive rows write back the bytes already there, so
    their slice stays byte-identical. Cursors are clamped into the cache as
    the reference's dynamic_update_slice clamps them. No host sync."""
    rows, active = _row_operands(positions, active)
    slots = positions.to(torch.long).clamp(0, k_l.shape[2] - 1)
    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for dst, new in ((k_l, kq), (v_l, vq), (k_scale_l, ks),
                         (v_scale_l, vs)):
            _put_rows(dst, new, rows, slots, active)
    else:
        _put_rows(k_l, k_new, rows, slots, active)
        _put_rows(v_l, v_new, rows, slots, active)
    return k_l, v_l, k_scale_l, v_scale_l


def layer_append_ring(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                      pos: torch.Tensor):
    """Shared-cursor append into a ring layer: every row writes
    ``k_new[b]`` (n_kv,hd) at slot ``pos % size``; ``pos`` is a 0-d device
    int (no host sync). Quantizes per position for int8 caches."""
    slot = torch.remainder(pos.to(torch.long), k_l.shape[2]).reshape(1)
    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        pairs = ((k_l, kq), (v_l, vq), (k_scale_l, ks), (v_scale_l, vs))
    else:
        pairs = ((k_l, k_new), (v_l, v_new))
    for dst, new in pairs:
        dst.index_copy_(2, slot, new[:, :, None].to(dst.dtype))
    return k_l, v_l, k_scale_l, v_scale_l


def layer_append_ring_block(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                            pos: torch.Tensor, size: int, lo: int):
    """``layer_append_ring`` on a rank that holds slots [lo, lo + n) of a
    ring of ``size`` slots: the rank holding slot ``pos % size`` writes
    it, every other rank writes its first slot's own bytes back (no host
    sync: ``pos`` stays on the device)."""
    n = k_l.shape[2]
    g = torch.remainder(pos.to(torch.long), size)
    mine = (g >= lo) & (g < lo + n)
    slot = torch.clamp(g - lo, 0, n - 1).reshape(1)
    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        pairs = ((k_l, kq), (v_l, vq), (k_scale_l, ks), (v_scale_l, vs))
    else:
        pairs = ((k_l, k_new), (v_l, v_new))
    for dst, new in pairs:
        old = dst.index_select(2, slot)
        dst.index_copy_(2, slot, torch.where(
            mine, new[:, :, None].to(dst.dtype), old))
    return k_l, v_l, k_scale_l, v_scale_l


def check_window(start: int, C: int, S: int):
    if start < 0 or start + C > S:
        raise ValueError(f"chunk window [{start}, {start + C}) does not fit "
                         f"the KV extent {S}")


def _put_window(dst, new, slot: int, start: int, keep):
    """Slot ``slot`` of ``dst`` takes the chunk ``new`` (n_kv,C,x) at
    positions [start, start+C) where ``keep`` (1,C,1); elsewhere in the
    window it keeps its bytes."""
    C = new.shape[1]
    cur = dst[slot, :, start:start + C]
    cur.copy_(torch.where(keep, new.to(dst.dtype), cur))


def layer_write_chunk(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                      slot: int, start: int, valid_len: int):
    """Chunked-prefill write: slot ``slot``'s chunk k_new/v_new (n_kv,C,hd)
    lands at positions [start, start+C); chunk positions >= ``valid_len``
    keep their previous bytes. A window that does not fit the cache raises
    (the scheduler shifts the final window left; nothing clamps
    silently). Quantizes per position for int8 caches."""
    C = k_new.shape[1]
    check_window(start, C, k_l.shape[2])
    keep = (torch.arange(C, device=k_new.device) < valid_len)[None, :, None]
    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for dst, new in ((k_l, kq), (v_l, vq), (k_scale_l, ks),
                         (v_scale_l, vs)):
            _put_window(dst, new, slot, start, keep)
    else:
        _put_window(k_l, k_new, slot, start, keep)
        _put_window(v_l, v_new, slot, start, keep)
    return k_l, v_l, k_scale_l, v_scale_l


# ---------------------------------------------------------------------------
# Tiered per-layer reads and writes (hot ring + cold tier, in place)
#
# Every position is staged into the cold tier when it is written (quantizing
# a given vector is deterministic, so staging at write time equals
# re-quantizing at the demotion boundary) and written exactly into the hot
# ring at slot position % H. Demotion is the read-side boundary
# ``cold_boundary(count)`` advancing by cold_block.
# ---------------------------------------------------------------------------

def layer_append_tiered(k_l, v_l, k_scale_l, v_scale_l, hot_k_l, hot_v_l,
                        k_new, v_new, positions: torch.Tensor,
                        cold_dtype: str,
                        active: Optional[torch.Tensor] = None,
                        lo: int = 0):
    """Decode append for a tiered layer: row b stages ``k_new[b]`` into
    the cold tier at ``positions[b]`` (quantized at ``cold_dtype``) and
    writes it exactly into the hot ring at ``positions[b] % H``; inactive
    rows keep every byte. k_l/v_l: (B,n_kv,S,hd_c); rings (B,n_kv,H,hd);
    k_new/v_new: (B,n_kv,hd). No host sync.

    ``lo``: this rank holds cold positions [lo, lo + S) of a cache whose
    sequence is cut over ranks (``KVCache.seq_lo``; 0 on one device); a
    row's cold store lands only on the rank whose block holds its cursor,
    while every rank writes the ring (whole on each)."""
    rows, active = _row_operands(positions, active)
    pos = positions.to(torch.long)
    rel = pos - lo
    cold_act = active & (rel >= 0) & (rel < k_l.shape[2])
    slots = rel.clamp(0, k_l.shape[2] - 1)
    ring = torch.remainder(pos, hot_k_l.shape[2])
    kq, ks = quantize_cold(k_new, cold_dtype)
    vq, vs = quantize_cold(v_new, cold_dtype)
    _put_rows(k_l, kq, rows, slots, cold_act)
    _put_rows(v_l, vq, rows, slots, cold_act)
    if k_scale_l is not None:
        _put_rows(k_scale_l, ks, rows, slots, cold_act)
        _put_rows(v_scale_l, vs, rows, slots, cold_act)
    _put_rows(hot_k_l, k_new, rows, ring, active)
    _put_rows(hot_v_l, v_new, rows, ring, active)
    return k_l, v_l, k_scale_l, v_scale_l, hot_k_l, hot_v_l


def _ring_tile(h: torch.Tensor, extent: int, lo: int = 0) -> torch.Tensor:
    """The ring (...,n_kv,H,hd) tiled over ``extent`` positions from
    ``lo``: local position j (global lo + j) reads ring slot (lo + j) % H
    (a copy)."""
    idx = lo + torch.arange(extent, device=h.device)
    return h.index_select(-2, torch.remainder(idx, h.shape[-2]))


def layer_read_tiered(k_l, v_l, k_scale_l, v_scale_l, hot_k_l, hot_v_l,
                      counts: torch.Tensor, bucket: int, hot_window: int,
                      cold_block: int, cold_dtype: str,
                      dtype=torch.bfloat16, lo: int = 0):
    """The resolved (B,n_kv,Se,hd) image of the first ``bucket`` positions
    (0 or >= S: all) in the compute dtype: position j of row b is the hot
    ring's exact value when j >= cold_boundary(counts[b]) and the
    dequantized cold bytes below it. ``counts``: (B,) tokens stored per
    row (cursors + 1, after the append). Only the bucket prefix of the
    cold tier is dequantized.

    ``lo``: the cold tier is this rank's block [lo, lo + S) of a
    sequence-cut cache; local position j is global position lo + j (hot
    from the global boundary on, ring slot (lo + j) % H) and ``bucket``
    counts local positions."""
    S = k_l.shape[2]
    Se = bucket if (bucket and bucket < S) else S

    def cut(a):
        return None if a is None else a[:, :, :Se]

    kc, vc = cold_read(cut(k_l), cut(v_l), cut(k_scale_l), cut(v_scale_l),
                       cold_dtype, dtype)
    cb = cold_boundary(counts, hot_window, cold_block)            # (B,)
    hot = (lo + torch.arange(Se, device=cb.device)[None, :]
           >= cb[:, None])[:, None, :, None]                      # (B,1,Se,1)
    return (torch.where(hot, _ring_tile(hot_k_l, Se, lo).to(dtype), kc),
            torch.where(hot, _ring_tile(hot_v_l, Se, lo).to(dtype), vc))


def layer_read_tiered_shards(k_l, v_l, k_scale_l, v_scale_l, hot_k_l,
                             hot_v_l, counts, bucket: int, n_shards: int,
                             hot_window: int, cold_block: int,
                             cold_dtype: str, dtype=torch.bfloat16):
    """``layer_read_tiered``'s image cut into shard-major views
    (B,n_kv,n_shards,Sb,hd): the select is positionwise, so shard s is
    absolute positions [s*Sb, (s+1)*Sb) of the resolved image."""
    k, v = layer_read_tiered(k_l, v_l, k_scale_l, v_scale_l, hot_k_l,
                             hot_v_l, counts, bucket, hot_window, cold_block,
                             cold_dtype, dtype)
    B, n_kv, Se, hd = k.shape
    Sb = shard_extent(Se, n_shards)
    return (k.view(B, n_kv, n_shards, Sb, hd),
            v.view(B, n_kv, n_shards, Sb, hd))


def layer_write_chunk_tiered(k_l, v_l, k_scale_l, v_scale_l, hot_k_l,
                             hot_v_l, k_new, v_new, slot: int, start: int,
                             valid_len: int, cold_dtype: str,
                             lo: Optional[int] = None):
    """Chunked-prefill write into both tiers. The chunk (n_kv,C,hd) is
    staged into the cold tier at [start, start+C) (quantized, positions
    >= ``valid_len`` keep their bytes; a window that does not fit raises)
    and ring slot s takes the LAST valid chunk position congruent to s
    (mod H): chunk index r + H*floor((valid-1-r)/H) with r = (s - start)
    mod H. Ring slots the chunk does not reach (r >= valid_len) keep
    their bytes: they hold hot positions of earlier chunks.

    ``lo``: the cold tier is this rank's block [lo, lo + S) of a
    sequence-cut cache: only the chunk's valid positions inside the block
    are staged (quantized per position, so the bytes are the whole
    cache's), and the caller checks the window against the global
    extent; the ring is written whole, as on one device."""
    C = k_new.shape[1]
    dev = k_new.device
    if lo is None:
        check_window(start, C, k_l.shape[2])
        lo = 0
    a = max(start, lo)
    b = min(start + min(valid_len, C), lo + k_l.shape[2])
    if a < b:
        kq, ks = quantize_cold(k_new[:, a - start:b - start], cold_dtype)
        vq, vs = quantize_cold(v_new[:, a - start:b - start], cold_dtype)
        for dst, new in ((k_l, kq), (v_l, vq), (k_scale_l, ks),
                         (v_scale_l, vs)):
            if dst is not None:
                dst[slot, :, a - lo:b - lo] = new.to(dst.dtype)
    H = hot_k_l.shape[2]
    r = torch.remainder(torch.arange(H, device=dev) - start, H)
    i_star = torch.clamp(
        r + H * torch.div(valid_len - 1 - r, H, rounding_mode="floor"),
        0, C - 1)
    keep_h = (r < valid_len)[None, :, None]
    for dst, new in ((hot_k_l, k_new), (hot_v_l, v_new)):
        cur = dst[slot]
        cur.copy_(torch.where(keep_h, new.index_select(1, i_star)
                              .to(dst.dtype), cur))
    return k_l, v_l, k_scale_l, v_scale_l, hot_k_l, hot_v_l


def layer_read_slot_cold(k_l, v_l, k_scale_l, v_scale_l, slot: int,
                         cold_dtype: str, dtype=torch.bfloat16):
    """One slot's (1,n_kv,S,hd) cold image in the compute dtype."""
    def take(a):
        return None if a is None else a[slot:slot + 1]

    return cold_read(take(k_l), take(v_l), take(k_scale_l),
                     take(v_scale_l), cold_dtype, dtype)


def chunk_hot_image(hot_k_l, hot_v_l, k_new, v_new, slot: int, start: int,
                    valid_len: int, extent: int, dtype=torch.bfloat16,
                    lo: Optional[int] = None):
    """(1,n_kv,extent,hd) exact-value image for the chunk program's hot
    reads, built from the PRE-write ring: every position tiles from the
    ring except [start, start+valid_len), which comes from the incoming
    chunk. The pre-write ring holds every position >= cold_boundary(start),
    a superset of each query's hot tail. A chunk window that does not fit
    the extent raises (the reference clamps it).

    ``lo``: the image of this rank's block, global positions [lo, lo +
    extent) of a sequence-cut cache, the chunk's window clipped to it (the
    caller checks the window against the global extent)."""
    if lo is None:
        check_window(start, k_new.shape[1], extent)
    base = lo or 0
    a = max(start, base)
    b = min(start + valid_len, base + extent)

    def one(h_l, new):
        img = _ring_tile(h_l[slot:slot + 1], extent, base).to(dtype)
        if a < b:
            img[0, :, a - base:b - base] = new[:, a - start:b - start] \
                .to(dtype)
        return img

    return one(hot_k_l, k_new), one(hot_v_l, v_new)


# ---------------------------------------------------------------------------
# Whole-cache slot operations (in place)
# ---------------------------------------------------------------------------

def _slot_buffers(cache: KVCache):
    return (cache.k, cache.v, cache.k_scale, cache.v_scale, cache.hot_k,
            cache.hot_v)


def write_slot_kv(dst: KVCache, src: KVCache, slot: int) -> KVCache:
    """Admission: copy the batch-1 cache ``src`` (a fresh prefill) into
    batch slot ``slot`` of ``dst`` — the first min(S_src, S_dst)
    positions, and the first min(H_src, H_dst) ring slots of a tiered
    cache. ``length`` stays an upper bound (max)."""
    for d, s in zip(_slot_buffers(dst), _slot_buffers(src)):
        if d is not None:
            n = min(s.shape[3], d.shape[3])
            d[:, slot, :, :n].copy_(s[:, 0, :, :n])
    dst.length = torch.maximum(dst.length, src.length)
    return dst


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Zero one batch slot's K/V, both tiers of a tiered cache (retire);
    not needed for correctness."""
    for d in _slot_buffers(cache):
        if d is not None:
            d[:, slot].zero_()
    return cache


def export_slot_kv(cache: KVCache, slot: int):
    """Preemption swap-out: one batch slot's full-extent STORED K/V as the
    reference's ``(k, v, k_scale, v_scale, hot_k, hot_v)`` tuple of
    (L,1,n_kv,S,hd_c) tensors (scales (L,1,n_kv,S,1), hot rings
    (L,1,n_kv,H,hd)); ``None`` for what the cache lacks. Quantized tiers
    export their values and scales verbatim (packed int4 nibbles
    included), never a dequantized image. Read-only, and the tensors are
    COPIES: the slot is reused while the image is held. On a mesh: this
    rank's part of the slot (its heads or its block of positions, and its
    ring)."""
    return tuple(None if a is None else a[:, slot:slot + 1].clone()
                 for a in _slot_buffers(cache))


def empty_slot_image(cache: KVCache):
    """Host buffers of ``export_slot_kv``'s shapes and dtypes for one slot
    of ``cache`` (None where the cache lacks a buffer): where a rank
    receives another rank's part of a swapped-out slot."""
    return tuple(None if a is None else torch.empty(
        (a.shape[0], 1) + tuple(a.shape[2:]), dtype=a.dtype)
        for a in _slot_buffers(cache))


def import_slot_kv(cache: KVCache, saved, slot: int,
                   valid_len: int) -> KVCache:
    """Preemption restore, in place: write an ``export_slot_kv`` tuple back
    into ``slot`` at positions < ``valid_len`` (the sequence's TRUE length);
    positions at or past it keep the bytes already in the cache, as
    ``layer_write_chunk`` keeps them past its valid length. A hot ring
    restores verbatim at full ring width: ring slots are read only for
    positions of the restored row's hot region, and the export holds the
    victim's ring as it was. The image may lie on another device (the
    engine hosts it); the stored bytes land verbatim. ``length`` rises to
    max(length, valid_len). On a rank holding positions [seq_lo, seq_lo +
    S) the cold part below the GLOBAL ``valid_len`` lands, the ring
    verbatim."""
    hk_s, hv_s = saved[4:]
    if (hk_s is not None or hv_s is not None) and not cache.is_tiered:
        raise ValueError("a swap image with a hot ring needs a tiered "
                         "cache")
    # a rank holding positions [seq_lo, seq_lo + S) of a sequence-cut
    # cache restores the part of its block below the global valid_len
    n = max(0, min(int(valid_len) - cache.seq_lo, cache.k.shape[3]))
    for i, (dst, src) in enumerate(zip(_slot_buffers(cache), saved)):
        if dst is None or src is None:
            continue
        if i < 4:
            dst[:, slot:slot + 1, :, :n].copy_(src[:, :, :, :n])
        else:
            dst[:, slot:slot + 1].copy_(src)
    cache.length = torch.clamp(cache.length, min=int(valid_len))
    return cache


# ---------------------------------------------------------------------------
# Masks (decode order: append, then attend)
# ---------------------------------------------------------------------------

def slot_valid_mask(size: int, query_pos, window: int = 0) -> torch.Tensor:
    """(S,) bool: slots a query at ``query_pos`` attends. A ring
    (``window`` > 0): slot s holds the largest position p <= query_pos with
    p = s (mod size), valid when p >= 0 and p > query_pos - window."""
    qp = torch.as_tensor(query_pos)
    idx = torch.arange(size, device=qp.device)
    count = qp + 1
    if not window:
        return idx < count
    head = torch.remainder(count + size - 1 - idx, size)
    p = count - 1 - head
    return (p >= 0) & (p <= qp) & (p > qp - window)


def batch_valid_mask(size: int, positions: torch.Tensor) -> torch.Tensor:
    """(B,S) bool: row b attends exactly the positions its cursor wrote."""
    return torch.arange(size, device=positions.device)[None, :] \
        < (positions[:, None] + 1)
