"""KV cache: the contiguous (L, B, n_kv, S_max, head_dim) cache, flat or
int8 with per-(b, head, position) f32 scales.

Port of the flat, int8, split-KV and preemption swap-pair parts of
``repro.kv.cache``. Caches are updated IN PLACE: every write below
mutates the cache tensors it is given and returns them. That is the
PyTorch form of the reference's buffer donation (each step's cache output
aliases its input there), so steady-state decode never holds two copies
of the KV. Rows a write does not target keep their bytes, inactive decode
rows stay byte-identical, and chunk positions at or past ``valid_len``
keep their previous bytes. Sliding-window (ring) and tiered caches belong
to families not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.quant.int8 import dequantize_kv, quantize_kv


@dataclass
class KVCache:
    k: torch.Tensor                          # (L,B,n_kv,S,hd) dtype or int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]          # (L,B,n_kv,S,1) f32, int8 only
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor                     # () int32 upper-bound cursor

    @property
    def is_quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int):
        """One layer's (k, v, k_scale, v_scale) views (writes land in the
        cache)."""
        return (self.k[i], self.v[i],
                None if self.k_scale is None else self.k_scale[i],
                None if self.v_scale is None else self.v_scale[i])


def init_kv_cache(n_layers: int, batch: int, n_kv: int, max_len: int,
                  head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
                  device=None) -> KVCache:
    shape = (n_layers, batch, n_kv, max_len, head_dim)
    sshape = shape[:-1] + (1,)
    store = torch.int8 if quantized else dtype

    def mk(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    return KVCache(mk(shape, store), mk(shape, store),
                   mk(sshape, torch.float32) if quantized else None,
                   mk(sshape, torch.float32) if quantized else None,
                   torch.zeros((), dtype=torch.int32, device=device))


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

def layer_append_slotted(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                         positions: torch.Tensor,
                         active: Optional[torch.Tensor] = None):
    """Row b writes ``k_new[b]`` (n_kv,hd) at its own cursor
    ``positions[b]``; inactive rows write back the bytes already there, so
    their slice stays byte-identical. Cursors are clamped into the cache as
    the reference's dynamic_update_slice clamps them. No host sync."""
    B, _, S, _ = k_l.shape
    if active is None:
        active = torch.ones(positions.shape, dtype=torch.bool,
                            device=positions.device)
    rows = torch.arange(B, device=positions.device)
    slots = positions.to(torch.long).clamp(0, S - 1)
    act = active[:, None, None]

    def put(dst, new):
        cur = dst[rows, :, slots]                        # (B,n_kv,x)
        dst[rows, :, slots] = torch.where(act, new.to(dst.dtype), cur)

    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        put(k_l, kq), put(v_l, vq), put(k_scale_l, ks), put(v_scale_l, vs)
    else:
        put(k_l, k_new), put(v_l, v_new)
    return k_l, v_l, k_scale_l, v_scale_l


def layer_write_chunk(k_l, v_l, k_scale_l, v_scale_l, k_new, v_new,
                      slot: int, start: int, valid_len: int):
    """Chunked-prefill write: slot ``slot``'s chunk k_new/v_new (n_kv,C,hd)
    lands at positions [start, start+C); chunk positions >= ``valid_len``
    keep their previous bytes. A window that does not fit the cache raises
    (the scheduler shifts the final window left; nothing clamps
    silently). Quantizes per position for int8 caches."""
    C = k_new.shape[1]
    S = k_l.shape[2]
    if start < 0 or start + C > S:
        raise ValueError(f"chunk window [{start}, {start + C}) does not fit "
                         f"the KV extent {S}")
    keep = (torch.arange(C, device=k_new.device) < valid_len)[None, :, None]

    def put(dst, new):
        cur = dst[slot, :, start:start + C]
        cur.copy_(torch.where(keep, new.to(dst.dtype), cur))

    if k_scale_l is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        put(k_l, kq), put(v_l, vq), put(k_scale_l, ks), put(v_scale_l, vs)
    else:
        put(k_l, k_new), put(v_l, v_new)
    return k_l, v_l, k_scale_l, v_scale_l


# ---------------------------------------------------------------------------
# Whole-cache slot operations (in place)
# ---------------------------------------------------------------------------

def write_slot_kv(dst: KVCache, src: KVCache, slot: int) -> KVCache:
    """Admission: copy the batch-1 cache ``src`` (a fresh prefill) into
    batch slot ``slot`` of ``dst`` — the first min(S_src, S_dst)
    positions. ``length`` stays an upper bound (max)."""
    n = min(src.k.shape[3], dst.k.shape[3])
    for d, s in ((dst.k, src.k), (dst.v, src.v),
                 (dst.k_scale, src.k_scale), (dst.v_scale, src.v_scale)):
        if d is not None:
            d[:, slot, :, :n].copy_(s[:, 0, :, :n])
    dst.length = torch.maximum(dst.length, src.length)
    return dst


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Zero one batch slot's K/V (retire); not needed for correctness."""
    for d in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if d is not None:
            d[:, slot].zero_()
    return cache


def export_slot_kv(cache: KVCache, slot: int):
    """Preemption swap-out: one batch slot's full-extent STORED K/V as the
    reference's ``(k, v, k_scale, v_scale, hot_k, hot_v)`` tuple of
    (L,1,n_kv,S,hd) tensors (scales (L,1,n_kv,S,1)); ``None`` for what the
    cache lacks (scales of a float cache; the hot ring of the tiered
    cache, not ported yet). int8 caches export the quantized values and
    their scales verbatim, never a dequantized image. Read-only, and the
    tensors are COPIES: the slot is reused while the image is held."""
    def take(a):
        return None if a is None else a[:, slot:slot + 1].clone()

    return (take(cache.k), take(cache.v), take(cache.k_scale),
            take(cache.v_scale), None, None)


def import_slot_kv(cache: KVCache, saved, slot: int,
                   valid_len: int) -> KVCache:
    """Preemption restore, in place: write an ``export_slot_kv`` tuple back
    into ``slot`` at positions < ``valid_len`` (the sequence's TRUE length);
    positions at or past it keep the bytes already in the cache, as
    ``layer_write_chunk`` keeps them past its valid length. The image may
    lie on another device (the engine hosts it); the stored bytes land
    verbatim. ``length`` rises to max(length, valid_len)."""
    k_s, v_s, ks_s, vs_s, hk_s, hv_s = saved
    if hk_s is not None or hv_s is not None:
        raise ValueError("a swap image with a hot ring needs the tiered "
                         "cache, which is not ported yet")
    n = max(0, min(int(valid_len), cache.k.shape[3]))
    for dst, src in ((cache.k, k_s), (cache.v, v_s),
                     (cache.k_scale, ks_s), (cache.v_scale, vs_s)):
        if dst is not None:
            dst[:, slot:slot + 1, :, :n].copy_(src[:, :, :, :n])
    cache.length = torch.clamp(cache.length, min=int(valid_len))
    return cache


# ---------------------------------------------------------------------------
# Masks (decode order: append, then attend)
# ---------------------------------------------------------------------------

def slot_valid_mask(size: int, query_pos) -> torch.Tensor:
    """(S,) bool: positions a query at ``query_pos`` attends."""
    qp = torch.as_tensor(query_pos)
    return torch.arange(size, device=qp.device) < qp + 1


def batch_valid_mask(size: int, positions: torch.Tensor) -> torch.Tensor:
    """(B,S) bool: row b attends exactly the positions its cursor wrote."""
    return torch.arange(size, device=positions.device)[None, :] \
        < (positions[:, None] + 1)
