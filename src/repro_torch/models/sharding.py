"""Logical-axis sharding rules and their explicit collectives: the port of
``repro.models.sharding``.

Every parameter and activation is named by *logical* axes; an
``ExecutionRules`` table maps logical names to mesh axes. The paper's two
execution models differ ONLY by their table (the math is the same, the
collective schedule is not):

- ``operator_centric``: per-head activations (``act_heads``) and the
  residual stream (``embed_shard``) replicate on the model axis, so every
  operator boundary synchronises: q and the attention output are
  all-gathered, the residual is all-reduced after ``wo`` and ``w_down``.
- ``sub_operator``: per-head activations stay on the owning rank through
  q/k/v, RoPE, attention and the partial ``wo``; the residual stream lives
  reduce-scattered over ``model`` (``embed_shard``) and is all-gathered
  before each norm that feeds a projection.

An axis that does not divide its dimension is dropped (that dimension is
replicated), e.g. qwen2's 2 KV heads on a 4-wide model axis.

In the reference ``ctx.ann(x, *logical)`` is a sharding constraint and the
compiler picks the collective from the placement it infers for ``x``. A
tensor here carries no placement, so at each site the model code resolves
where ``x`` arrives and where the rules put it (specs from ``spec``, on
global shapes; ``MeshLayout`` holds the transformer's), and
``ShardingCtx.reshard`` does the one move the two placements imply:
nothing; a local slice; an all-gather; an all-reduce; or a reduce-scatter
when a partial sum (``partial``: the mesh axes it is partial over) lands
sharded. Without a mesh (``NULL_CTX``) it returns ``x``.

Sites (reference ``ctx.ann`` -> port; RES is ("batch", "seq",
"embed_shard"), FULL ("batch", "seq", "embed")):

=====================================  =====================================
reference site                         port (sub_operator | operator_centric)
=====================================  =====================================
common.py:136-137 ``embed``            masked local gather of the vocab
                                       shard, partial over ``vocab``'s axes
                                       -> RES: reduce-scatter | all-reduce
common.py:143 ``unembed_logits``       logits of the local vocab rows, left
                                       vocab-sharded; ``greedy`` takes the
                                       argmax across shards (ties -> lowest
                                       index)
transformer.py:110,128 (and :140,      RES -> FULL before ln1 and ln2:
:149, :222, :240) ``h`` "embed"        all-gather | nothing
attention.py:462 q "act_heads"         q's column shard -> act_heads: nothing
                                       | all-gather (then the cache's head
                                       shard is sliced back for attention)
attention.py:463-464 k/v "kv_heads"    k/v column shard -> kv_heads:
                                       nothing on both (all-gather where the
                                       heads do not divide, or under +seqkv)
transformer.py:118 o "act_heads"       attention output -> act_heads:
                                       nothing | all-gather; then the wo
                                       rows' slice
transformer.py:120,125 (:144, :151,    wo / w_down / expert outputs, partial
:236, :243) x + o, x + f               over their contraction's axes -> RES:
                                       reduce-scatter | all-reduce; a
                                       row-parallel bias is added once,
                                       after the reduction
transformer.py:135-136, :231-234       the cache: kv_heads -> the local KV
kc/vc "kv_heads", "kv_seq",            heads; under +seqkv kv_seq -> each
"kv_shard"                             rank holds a block of positions and
                                       attends it; (o, m, l) triples are
                                       all-gathered and LSE-merged
attention.py:450-454 split-KV          per-rank K1 partials + LSE merge over
                                       the kv_seq axes
moe.py:95-139 dispatch, expert GEMMs   experts on ``model`` (each rank
                                       dispatches to its own), expert F
                                       columns on ``data`` (``mlp_shard``):
                                       the buckets are all-gathered over
                                       data and the partial outputs
                                       reduce-scattered back; the combine is
                                       partial over model
=====================================  =====================================

Where each site lives in the port: ``common.embed`` and
``common.greedy``; ``MeshLayout.to_full`` in ``transformer.pre_attention``,
``_mix_ffn`` and ``final_logits``; ``MeshLayout.heads`` in
``attention.qkv_project`` and ``transformer.attention_out``;
``MeshLayout.to_res`` in ``transformer.row_linear`` (wo, w_down), the K3
branch of ``ffn_apply`` and the MoE branch of ``_mix_ffn``;
``transformer.attend_decode_seq`` / ``attend_chunk_seq`` for the cache's
positions; ``moe._moe_core_mesh`` for the dispatch. Without a mesh the
layout's sites return their tensor unchanged and ``embed``/``greedy``
are the plain gather and argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Entry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ExecutionRules:
    """logical axis name -> mesh axes (or None: replicate)."""
    name: str
    rules: Dict[str, Optional[Tuple[str, ...]]]

    def mesh_axes(self, logical: Tuple[Optional[str], ...], mesh,
                  shape: Tuple[int, ...]) -> Spec:
        """Translate logical names into a spec (one entry per dim: None, an
        axis name, or a tuple of names), dropping axes that do not divide
        the dimension (-> replicated). Reads only ``mesh.shape`` (a dict
        axis -> size)."""
        spec = []
        used = set()
        for dim, name in zip(shape, logical):
            entry = self.rules.get(name) if name else None
            if entry is None:
                spec.append(None)
                continue
            axes = tuple(a for a in entry
                         if a not in used and a in mesh.shape)
            total = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
            if axes and total > 0 and dim % total == 0:
                spec.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                spec.append(None)
        return tuple(spec)


def _common(pod_data: Tuple[str, ...]) -> Dict[str, Optional[Tuple[str, ...]]]:
    return {
        "batch": pod_data,
        "seq": None,
        "kv_seq": None,
        "kv_shard": None,         # split-KV shard axis; -> ("model",) only
                                  # under seq_sharded_kv
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "mlp": ("model",),
        "mlp_shard": ("data",),   # expert FFN columns: EP(model) x data
        "embed_w": None,          # weight-matrix embed dim; -> ("data",)
                                  # under fsdp
        "vocab": ("model",),
        "experts": ("model",),
        "layers": None,
        "stages": ("pod",),
        "lru": ("model",),
        "ssm_heads": ("model",),
        "state": None,
        "conv": None,
        "frames": None,
    }


def operator_centric(pod_is_dp: bool = True) -> ExecutionRules:
    """Operator-boundary materialization: the residual stream and per-head
    activations replicate on the model axis between operators."""
    rules = _common(("pod", "data") if pod_is_dp else ("data",))
    rules["embed_shard"] = None
    rules["act_heads"] = None
    return ExecutionRules("operator_centric", rules)


def sub_operator(pod_is_dp: bool = True) -> ExecutionRules:
    """Dependency-driven: per-head activations stay on the owning rank, the
    residual stream lives reduce-scattered over the model axis."""
    rules = _common(("pod", "data") if pod_is_dp else ("data",))
    rules["embed_shard"] = ("model",)
    rules["act_heads"] = ("model",)
    return ExecutionRules("sub_operator", rules)


def fsdp(base: ExecutionRules) -> ExecutionRules:
    """Training variant (ZeRO-3): the non-TP weight dim (``embed_w``) and
    the embedding rows spread over the data axis, AdamW's moments with
    them; a layer's weights are all-gathered just before it uses them
    (``MeshLayout.weights``) and their gradients reduce-scattered back."""
    rules = dict(base.rules)
    rules["embed_w"] = ("data",)
    return ExecutionRules(base.name + "+fsdp", rules)


def seq_sharded_kv(base: ExecutionRules) -> ExecutionRules:
    """The KV *sequence* sharded over the model axis (distributed flash
    decode; the softmax reductions become the LSE merge). KV heads and
    per-head activations replicate (q gathers: tiny at decode); split-KV
    shards ride the same axis."""
    rules = dict(base.rules)
    rules["kv_seq"] = ("model",)
    rules["kv_shard"] = ("model",)
    rules["kv_heads"] = None
    rules["act_heads"] = None
    return ExecutionRules(base.name + "+seqkv", rules)


# ---------------------------------------------------------------------------
# Specs on this rank
# ---------------------------------------------------------------------------

def axes_of(entry: Entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (empty: replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_of(axes: Tuple[str, ...]) -> Entry:
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def channel_head_cut(ctx: "ShardingCtx", what: str, d_model: int,
                     channels: int, heads_name: str, heads: int
                     ) -> Tuple[str, ...]:
    """The mesh axes a recurrent block's inner channels (``lru``) and the
    heads over them (``heads_name``) are cut over: () on one device or
    where the rules leave them whole. A rank must own whole heads with
    their channels, so the two cuts must agree."""
    if not ctx.active:
        return ()
    lru = axes_of(ctx.spec(("embed_w", "lru"), (d_model, channels))[1])
    cut = axes_of(ctx.spec((heads_name,), (heads,))[0])
    if lru != cut:
        raise NotImplementedError(
            f"the {what}'s {channels} inner channels and {heads} heads cut "
            f"over different axes ({lru} / {cut}) on this mesh")
    return lru


class ShardingCtx:
    """(mesh, rules) carried through the model code. ``spec`` builds a
    placement from logical names and a GLOBAL shape; ``reshard`` moves a
    local tensor between two placements with the collective they imply;
    ``local`` cuts a full tensor to this rank's part."""

    def __init__(self, mesh, rules: ExecutionRules):
        self.mesh = mesh
        self.rules = rules

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes a batch's rows are cut over (no drop rule: a
        program's rows are always this rank's share of a batch that
        divides)."""
        if self.mesh is None:
            return ()
        return tuple(a for a in self.rules.rules.get("batch") or ()
                     if a in self.mesh.shape)

    def batch_rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's rows of a global batch of ``n`` rows (the
        rows ``batch_local`` keeps)."""
        k = self.n(entry_of(self.batch_axes))
        if n % k:
            raise ValueError(f"a batch of {n} rows does not cut over the "
                             f"{k} ranks of {self.batch_axes}")
        i = self.index(entry_of(self.batch_axes))
        return i * (n // k), (i + 1) * (n // k)

    def batch_local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a global batch."""
        n = self.n(entry_of(self.batch_axes))
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not cut "
                             f"over the {n} ranks of {self.batch_axes}")
        return self.local(x, (entry_of(self.batch_axes),))

    def spec(self, logical: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        if self.mesh is None:
            return ()
        return self.rules.mesh_axes(tuple(logical), self.mesh, tuple(shape))

    def n(self, entry: Entry) -> int:
        """Shards along a spec entry."""
        return int(np.prod([self.mesh.shape[a] for a in axes_of(entry)])) \
            if self.mesh is not None else 1

    def index(self, entry: Entry) -> int:
        """This rank's shard index along a spec entry."""
        axes = axes_of(entry)
        return self.mesh.index(axes) if axes else 0

    def local(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's part of a full tensor ``x`` under ``spec``
        (contiguous)."""
        for d, e in enumerate(spec):
            n = self.n(e)
            if n > 1:
                c = x.shape[d] // n
                x = x.narrow(d, self.index(e) * c, c)
        return x.contiguous() if self.active else x

    def reshard(self, x: torch.Tensor, src: Spec, dst: Spec,
                partial: Tuple[str, ...] = (), site: str = ""
                ) -> torch.Tensor:
        """The collective from (``src``, ``partial``) to ``dst``: a partial
        sum is reduce-scattered onto the dim ``dst`` shards by exactly
        those axes (when ``src`` leaves it whole), else all-reduced; then
        each dim whose entry differs is all-gathered from ``src`` and
        sliced to ``dst``."""
        from repro_torch.core import collectives as C
        if not self.active:
            return x
        nd = x.ndim
        src = [axes_of(e) for e in tuple(src) + (None,) * (nd - len(src))]
        dst = [axes_of(e) for e in tuple(dst) + (None,) * (nd - len(dst))]
        partial = tuple(a for a in self.mesh.axis_names if a in partial
                        and self.mesh.shape[a] > 1)
        if partial:
            d = next((i for i in range(nd) if dst[i] == partial
                      and not src[i]), None)
            if d is not None:
                x = C.reduce_scatter(x, self.mesh, partial, d, site)
                src[d] = partial
            else:
                x = C.all_reduce(x, self.mesh, partial, site)
        for i in range(nd):
            if src[i] == dst[i]:
                continue
            if src[i]:
                x = C.all_gather(x, self.mesh, src[i], i, site)
            if dst[i]:
                n = self.n(entry_of(dst[i]))
                c = x.shape[i] // n
                x = x.narrow(i, self.index(entry_of(dst[i])) * c, c)
                x = x.contiguous()
        return x


NULL_CTX = ShardingCtx(None, operator_centric())


# ---------------------------------------------------------------------------
# The transformer's placements
# ---------------------------------------------------------------------------

class MeshLayout:
    """Where the transformer's tensors live on ``ctx``'s mesh, each as the
    tuple of mesh axes that cuts it (() = whole on every rank), resolved by
    the rules on the GLOBAL sizes (an axis that does not divide drops):

    res: D of the residual stream (``embed_shard``); vocab: the embedding
    and unembedding rows; q_cols / kv_cols: the columns of wq and wk/wv
    (``heads`` / ``kv_heads`` on Hq*hd and Hkv*hd); wo_rows: wo's rows;
    act_heads: q's and the attention output's heads at their sites;
    kv_heads: the cache's heads; attn_heads: the query heads attention
    runs over, the cache's heads (q is sliced to them; a cache whose
    positions the rules cut records its own axes, ``KVCache.seq_axes``),
    except with one KV head (MQA: recurrentgemma), which every rank holds
    whole, where attention runs over ``act_heads`` (each rank its query
    heads against the one K/V); mlp: the FFN's F (w_gate/w_up columns,
    w_down rows); experts / mlp_shard: the MoE experts and their F
    columns.

    Without a mesh every placement is () and every site below returns its
    tensor unchanged (``NULL_LAYOUT``): the model code runs one path on one
    device and on a mesh."""

    def __init__(self, cfg, ctx: ShardingCtx, train: bool = False):
        self.ctx = ctx
        self.active = ctx.active
        self.res = self.vocab = self.q_cols = self.kv_cols = ()
        self.wo_rows = self.act_heads = self.kv_heads = self.mlp = ()
        self.attn_heads = ()
        self.experts = self.mlp_shard = ()
        self.fsdp: Dict[str, Dict[Tuple[str, ...], Tuple]] = {}
        if not self.active:
            return
        fsdp_axes = tuple(a for a in ctx.rules.rules.get("embed_w") or ()
                          if ctx.mesh.shape.get(a, 1) > 1)
        if ctx.rules.rules.get("embed_w") and not train:
            raise ValueError(f"{ctx.rules.name}: fsdp rules shard the "
                             "weights' embed dim for training; serving "
                             "runs the operator_centric / sub_operator "
                             "tables")
        D, hd, V = cfg.d_model, cfg.head_dim, cfg.vocab_size
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads

        def ax(logical, shape, i):
            return axes_of(ctx.spec(logical, shape)[i])
        self.res = ax((None, "embed_shard"), (1, D), 1)
        self.vocab = ax(("vocab", "embed_w"), (V, D), 0)
        self.q_cols = ax(("embed_w", "heads"), (D, Hq * hd), 1)
        self.kv_cols = ax(("embed_w", "kv_heads"), (D, Hkv * hd), 1)
        self.wo_rows = ax(("heads", "embed_w"), (Hq * hd, D), 0)
        self.act_heads = ax(("act_heads",), (Hq,), 0)
        self.kv_heads = ax(("kv_heads",), (Hkv,), 0)
        self.attn_heads = self.act_heads if Hkv == 1 and not self.kv_heads \
            else self.kv_heads
        self.mlp = ax(("embed_w", "mlp"), (D, cfg.d_ff), 1)
        if cfg.moe is not None:
            m = cfg.moe
            shape = (m.num_experts, D, m.expert_d_ff)
            self.experts = ax(("experts", "embed_w", "mlp_shard"), shape, 0)
            self.mlp_shard = ax(("experts", "embed_w", "mlp_shard"), shape,
                                2)
        if fsdp_axes:
            self.fsdp = _fsdp_gathers(cfg, ctx, set(fsdp_axes))

    def weights(self, p: dict, where: str = "block") -> dict:
        """``p`` (one unit of the stack ``where``: a layer's parameters,
        a hybrid superblock's (``"super"``) or tail layer's (``"tail"``),
        an encoder's (``"enc"``) or decoder's (``"dec"``) layer; or with
        ``where="top"`` the model's) with every leaf that fsdp cuts over
        the data axes all-gathered whole: the one weight-gather site,
        called inside the rematerialised unit (the recompute gathers
        again; the gathered weights are not kept) and by the embedding and
        the loss. The gather's gradient is reduce-scattered back to the
        shards."""
        if not self.fsdp:
            return p

        def go(node, keys):
            if isinstance(node, dict):
                return {k: go(v, keys + (str(k),)) for k, v in node.items()}
            return self.weight(node, keys, where)
        return go(p, ())

    def weight(self, t: torch.Tensor, keys, where: str = "top"
               ) -> torch.Tensor:
        """One leaf (at ``keys`` of a layer's or the model's tree) gathered
        whole over the fsdp axes (``weights``)."""
        from repro_torch.core.collectives import all_gather
        for d, axes in self.fsdp.get(where, {}).get(tuple(keys), ()):
            t = all_gather(t, self.ctx.mesh, axes, d, "fsdp_gather")
        return t

    def res_spec(self):
        return (None, None, entry_of(self.res))

    def to_full(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """The residual (B,S,D) whole on every rank (before a norm that
        feeds a projection): all-gathered from its D slices."""
        if not self.active:
            return x
        return self.ctx.reshard(x, self.res_spec(), (), site=site)

    def to_res(self, y: torch.Tensor, partial, site: str) -> torch.Tensor:
        """A (B,S,D) partial sum over ``partial`` (or a whole tensor) onto
        the residual's placement: reduce-scatter, all-reduce or slice. A
        partial sum is reduced in f32."""
        if not self.active:
            return y
        if partial:
            y = y.to(torch.float32)
        return self.ctx.reshard(y, (), self.res_spec(), partial=partial,
                                site=site)

    def res_local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's D slice of a whole (..., D) tensor (a table's rows,
        vision embeddings)."""
        if not self.res:
            return x
        return self.ctx.local(x, (None,) * (x.ndim - 1)
                              + (entry_of(self.res),))

    def heads(self, t: torch.Tensor, src, dst, site: str) -> torch.Tensor:
        """(B,S,H,hd) from heads cut over ``src`` to ``dst``."""
        if not self.active:
            return t
        return self.ctx.reshard(t, (None, None, entry_of(src), None),
                                (None, None, entry_of(dst), None), site=site)


NULL_LAYOUT = MeshLayout(None, NULL_CTX)


def layout(cfg, ctx: ShardingCtx, train: bool = False) -> MeshLayout:
    """``cfg``'s placements on ``ctx`` (``NULL_LAYOUT`` without a mesh);
    ``train``: fsdp rules allowed."""
    return MeshLayout(cfg, ctx, train) if ctx.active else NULL_LAYOUT


# the port's layer stacks -> the ``where`` of their leaves' gathers
_STACK_WHERE = {"blocks": "block", "super": "super", "tail": "tail",
                "enc_blocks": "enc", "dec_blocks": "dec"}


def _unit_config(cfg):
    """``cfg`` with one unit of each of its layer stacks: one layer; the
    hybrid's one superblock and one recurrent tail layer; the enc-dec
    family's one encoder and one decoder layer."""
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=len(cfg.rglru.block_pattern) + 1)
    if cfg.family == "audio":
        return cfg.replace(n_layers=1, encoder=dataclasses.replace(
            cfg.encoder, n_layers=1))
    return cfg.replace(n_layers=1)


def _fsdp_gathers(cfg, ctx: ShardingCtx, fsdp_axes) -> Dict:
    """{where: {leaf keys: ((dim, axes), ...)}}: the dims of every leaf
    that the rules cut over the fsdp axes (``embed_w``'s, and an expert's
    F where ``mlp_shard`` takes the data axis first), from the specs of the
    global shapes of a model with one unit of each stack
    (``_unit_config``). ``where`` is the stack a leaf's unit belongs to
    (``"block"``: the transformer's and the SSM's layers, ``"super"`` /
    ``"tail"``: the hybrid's superblocks and recurrent tail, ``"enc"`` /
    ``"dec"``: the enc-dec family's layers), with keys inside one unit's
    dict, or ``"top"``, with keys in the model's tree."""
    from repro_torch.models.param_specs import (abstract_params,
                                                leaf_logical, walk)
    out: Dict[str, Dict] = {"top": {}}
    out.update({w: {} for w in _STACK_WHERE.values()})
    for keys, t in walk(abstract_params(_unit_config(cfg))):
        spec = ctx.spec(leaf_logical(keys, t.ndim), t.shape)
        dims = tuple((d, axes_of(e)) for d, e in enumerate(spec)
                     if set(axes_of(e)) & fsdp_axes)
        if not dims:
            continue
        if keys[0] in _STACK_WHERE:
            out[_STACK_WHERE[keys[0]]][keys[2:]] = dims
        else:
            out["top"][keys] = dims
    return out
