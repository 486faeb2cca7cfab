"""Parameter and cache placement by leaf-path pattern matching: the port of
``repro.models.param_specs``.

The placement of every weight shard is decided statically, once, before
the first step (the paper's deterministic shard -> core map). The port's
trees keep one dict per layer in a list (``blocks``; the hybrid's ``super``
and ``tail``) where the reference stacks layers on a leading axis, so a
port leaf's spec is the reference's with the stacked entries dropped. A
quantized weight is two leaves, ``values`` and ``scale``, as the reference's
``QuantizedTensor`` is.

``shard_params`` cuts each full leaf to this rank's part; it works on the
port's parameters from ``interop``, so the reference's own parameters reach
every rank. ``gather_params`` is its inverse (whole leaves on every rank,
for a checkpoint). Under the fsdp rules (training) the same tables cut the
weights' embed dim over the data axis, and AdamW's moments take their
parameters' specs. An int8 weight is cut from the ALREADY quantized tensor: its
per-column scales stay whole on a row-parallel cut (the reference
quantizes over the full ``d_in`` before it shards); requantizing a shard
would give other values.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.kv.cache import KVCache
from repro_torch.kv.state import RecurrentState
from repro_torch.models.sharding import ShardingCtx, Spec
from repro_torch.quant.int8 import QuantizedTensor

# (match keys..., logical axes for the trailing dims of the leaf)
_RULES = [
    (("embed", "table"), ("vocab", "embed_w")),
    (("unembed", "table"), ("vocab", "embed_w")),
    (("pos_embed",), (None, "embed_w")),
    (("router", "w"), ("embed_w", None)),
    (("moe", "w_gate"), ("experts", "embed_w", "mlp_shard")),
    (("moe", "w_up"), ("experts", "embed_w", "mlp_shard")),
    (("moe", "w_down"), ("experts", "mlp_shard", "embed_w")),
    (("wq", "w"), ("embed_w", "heads")),
    (("wk", "w"), ("embed_w", "kv_heads")),
    (("wv", "w"), ("embed_w", "kv_heads")),
    (("wo", "w"), ("heads", "embed_w")),
    (("wq", "b"), ("heads",)),
    (("wk", "b"), ("kv_heads",)),
    (("wv", "b"), ("kv_heads",)),
    (("wo", "b"), ("embed",)),
    (("w_gate", "w"), ("embed_w", "mlp")),
    (("w_up", "w"), ("embed_w", "mlp")),
    (("w_down", "w"), ("mlp", "embed_w")),
    (("w_in", "w"), ("embed_w", "mlp")),
    (("w_out", "w"), ("mlp", "embed_w")),
    (("w_in", "b"), ("mlp",)),
    (("w_out", "b"), ("embed",)),
    # --- ssd ---
    (("z_proj", "w"), ("embed_w", "lru")),
    (("x_proj", "w"), ("embed_w", "lru")),
    (("bc_proj", "w"), ("embed_w", None)),
    (("dt_proj", "w"), ("embed_w", "ssm_heads")),
    (("dt_bias",), ("ssm_heads",)),
    (("A_log",), ("ssm_heads",)),
    (("D_skip",), ("ssm_heads",)),
    (("conv_x",), ("conv", "lru")),
    (("conv_bc",), ("conv", None)),
    (("out_proj", "w"), ("lru", "embed_w")),
    # --- rglru ---
    (("in_a", "w"), ("embed_w", "lru")),
    (("in_b", "w"), ("embed_w", "lru")),
    (("mix", "conv"), ("conv", "lru")),
    (("w_a",), ("heads", None, None)),
    (("w_x",), ("heads", None, None)),
    (("lam",), ("lru",)),
    (("out", "w"), ("lru", "embed_w")),
]

_STACK_KEYS = ("blocks", "super", "tail", "enc_blocks", "dec_blocks")


def walk(tree, keys: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                             Any]]:
    """(path keys, tensor) for every tensor of a parameter or cache tree:
    dict keys in sorted order, list items by index, a QuantizedTensor's
    ``values`` and ``scale``, a KVCache's and a RecurrentState's tensor
    fields by name (None fields skipped)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], keys + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from walk(t, keys + (str(i),))
    elif isinstance(tree, QuantizedTensor):
        yield keys + ("values",), tree.values
        yield keys + ("scale",), tree.scale
    elif isinstance(tree, KVCache):
        for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v",
                  "length"):
            yield from walk(getattr(tree, f), keys + (f,))
    elif isinstance(tree, RecurrentState):
        yield keys + ("h",), tree.h
        yield keys + ("conv",), tree.conv
    else:
        yield keys, tree


def leaf_logical(keys: Tuple[str, ...], ndim: int) -> Tuple:
    """The logical axes of a leaf at ``keys`` of ``ndim`` dims (matched as
    in the reference: every key of a rule, in order, as a subsequence;
    leading dims padded with None; unmatched leaves replicate)."""
    logical = None
    for match, log in _RULES:
        ki = 0
        for k in keys:
            if ki < len(match) and k == match[ki]:
                ki += 1
        if ki == len(match):
            logical = log
            break
    if logical is None:
        logical = (None,) * ndim
    return (None,) * (ndim - len(logical)) + tuple(logical)


def param_specs(params, ctx: ShardingCtx) -> Dict[str, Spec]:
    """{"path/of/leaf": spec} for every parameter leaf."""
    return {"/".join(k): ctx.spec(leaf_logical(k, t.ndim), t.shape)
            for k, t in walk(params)}


def _cut(node, keys, ctx: ShardingCtx):
    if isinstance(node, dict):
        return {k: _cut(v, keys + (str(k),), ctx) for k, v in node.items()}
    if isinstance(node, list):
        return [_cut(v, keys + (str(i),), ctx) for i, v in enumerate(node)]
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(_cut(node.values, keys + ("values",), ctx),
                               _cut(node.scale, keys + ("scale",), ctx))
    return ctx.local(node, ctx.spec(leaf_logical(keys, node.ndim),
                                    node.shape))


def shard_params(params, ctx: ShardingCtx):
    """This rank's part of every leaf of the full ``params`` (the same
    tree; without a mesh, ``params`` itself)."""
    if ctx.mesh is None:
        return params
    return _cut(params, (), ctx)


def gather_params(params, ctx: ShardingCtx, cfg):
    """The whole leaves of this rank's ``params`` (a tree of ``cfg``'s
    parameters as ``shard_params`` cut it, or AdamW moments of that
    structure), on every rank: each leaf all-gathered over the axes its
    spec cuts it by, the inverse of ``shard_params``. Collective: every
    rank of the mesh calls it. Without a mesh, ``params`` itself."""
    if not ctx.active:
        return params
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.sharding import axes_of
    shapes = {k: t.shape for k, t in walk(abstract_params(cfg))}

    def go(node, keys):
        if isinstance(node, dict):
            return {k: go(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, list):
            return [go(v, keys + (str(i),)) for i, v in enumerate(node)]
        spec = ctx.spec(leaf_logical(keys, node.ndim), shapes[keys])
        for d, e in enumerate(spec):
            if axes_of(e):
                node = all_gather(node, ctx.mesh, axes_of(e), d,
                                  "gather_params")
        return node
    with torch.no_grad():
        return go(params, ())


def cache_logical(keys: Tuple[str, ...], shape) -> Tuple:
    """The reference's ``cache_specs`` rules as logical names: KV leaves
    (L,B,n_kv,S,hd) (+ int8 scales), the tiered hot ring (its dim 3 is the
    ring, never sequence-sharded), the SSD state (L,B,nh,hd,N), the RG-LRU
    state (L,B,lru) and the conv windows (L,B,W-1,C); the rest
    replicates."""
    nd = len(shape)
    if nd == 0:
        return ()
    if "conv" in keys and nd == 4:
        return (None, "batch", None, "lru")
    if nd == 5 and "h" in keys:
        return (None, "batch", "ssm_heads", None, None)
    if nd == 3 and "h" in keys:
        return (None, "batch", "lru")
    if "hot_k" in keys or "hot_v" in keys:
        return (None, "batch", "kv_heads", None, None)
    if nd == 5:
        return (None, "batch", "kv_heads", "kv_seq", None)
    return (None,) * nd


def cache_specs(caches, ctx: ShardingCtx) -> Dict[str, Spec]:
    """{"path/of/leaf": spec} for every cache leaf (the cursor
    replicates)."""
    out = {}
    for k, t in walk(caches):
        logical = cache_logical(k, t.shape)
        out["/".join(k)] = ctx.spec(logical, t.shape) if logical else ()
    return out


class _MetaGen:
    """A stand-in generator on the meta device: parameters with their
    shapes and dtypes and no memory."""
    device = torch.device("meta")


def abstract_params(cfg):
    """The port's parameter tree for ``cfg`` on the meta device (shapes
    only: nothing is drawn or allocated)."""
    from repro_torch.models import encdec, rglru, ssm, transformer
    module = {"ssm": ssm, "hybrid": rglru, "audio": encdec}.get(
        cfg.family, transformer)
    return module.init_params(_MetaGen(), cfg)


def shard_cache(cache: KVCache, ctx: ShardingCtx) -> KVCache:
    """This rank's part of a full flat, ring or tiered ``cache`` under
    ``ctx``'s rules (the layout ``init_kv_cache_sharded`` builds): its
    slots, its KV heads or its block of positions (of a ring: of its
    slots; of a tiered cache: of its cold tier, the hot ring cut over the
    slots and heads only); the cursor stays whole."""
    import dataclasses
    from repro_torch.models.sharding import axes_of
    if not ctx.active:
        return cache
    spec = ctx.spec(cache_logical(("k",), cache.k.shape), cache.k.shape)
    hot = None if cache.hot_k is None else ctx.spec(
        cache_logical(("hot_k",), cache.hot_k.shape), cache.hot_k.shape)

    def cut(t, s=spec):
        return None if t is None else ctx.local(t, s)
    seq = axes_of(spec[3])
    return dataclasses.replace(
        cache, k=cut(cache.k), v=cut(cache.v), k_scale=cut(cache.k_scale),
        v_scale=cut(cache.v_scale), hot_k=cut(cache.hot_k, hot),
        hot_v=cut(cache.hot_v, hot), seq_axes=seq,
        seq_lo=ctx.index(spec[3]) * (cache.k.shape[3] // ctx.n(spec[3]))
        if seq else 0)
