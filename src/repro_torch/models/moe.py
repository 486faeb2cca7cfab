"""Mixture-of-Experts FFN: f32 router, top-k, capacity-bounded dispatch.

Port of ``repro.models.moe`` (``make_moe_params``, ``capacity``,
``moe_ffn``, and on a mesh ``_moe_ffn_sharded``, serving and training).
Each token's
expert assignment is sorted by expert (stable), ranked within its expert's
segment and kept while its rank is below the capacity C; kept tokens are
copied into an (E, C, D) bucket tensor, every expert's products run over
all of its C slots as batched matrix products (the reference's einsums,
computed outside any kernel there too), and each token's K expert rows are
gathered back and summed.

The combine is a gather, not the reference's scatter-add: every token has
exactly K assignments, so it reads its K rows (a dropped one weighted 0)
and sums them in a fixed order. That is the same function, and unlike
``index_add_`` on CUDA (atomics) it gives the same bits on every call.
Nothing here synchronises with the host: the drop rule, slots and gathers
stay on the device.

On a mesh (``moe_ffn_mesh``) the experts are cut over ``model`` (EP) and
their F columns over ``data`` (``mlp_shard``). The router runs on every
rank (its weights are whole); each rank dispatches only to its own experts
and its combine is a partial sum over the expert axes. With several data
rows and at least 512 tokens a row (and not training), each row dispatches
its own tokens with the capacity counted on them, as the reference's
``_moe_ffn_sharded``: a row's output can then differ from the unsharded
one where tokens overflow, as in the reference. Otherwise the rows' tokens
are all-gathered and dispatched together with the global capacity.
Training takes that path, so its dispatch and its load-balance loss are
the unsharded model's; every collective on it carries its gradient
(``core/collectives.py``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def make_moe_params(gen, cfg: ModelConfig) -> Dict:
    """The router as an f32 linear (d_model -> E) and the experts stacked
    (E, D, F) / (E, F, D) in the compute dtype (never int8: the reference
    stores them in the compute dtype whatever ``weight_int8`` says)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    dt = common.dtype_of(cfg)
    return {
        "router": common.make_linear(gen, d, e, torch.float32),
        "w_gate": common.dense_init(gen, (e, d, f), dt, fan_in=d),
        "w_up": common.dense_init(gen, (e, d, f), dt, fan_in=d),
        "w_down": common.dense_init(gen, (e, f, d), dt, fan_in=f),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slot count for a call of ``tokens`` tokens (rows x
    sequence, inactive decode rows included, as in the reference).
    capacity_factor <= 0: no drop (every assignment could land on one
    expert); else GShard-style, padded to a multiple of 8, at least 8."""
    m = cfg.moe
    if m.capacity_factor <= 0:
        return tokens * m.experts_per_token
    c = int(math.ceil(tokens * m.experts_per_token * m.capacity_factor
                      / m.num_experts))
    return max(8, -(-c // 8) * 8)


def route(p: Dict, xf: torch.Tensor, k: int):
    """The router on f32 activations: softmax probabilities (T, E) and the
    top-k (values, expert ids), both (T, K), values renormalised."""
    logits = common.linear(p["router"], xf.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def dispatch(gate_idx: torch.Tensor, E: int, C: int):
    """Sort-based capacity dispatch of the (T, K) assignments, flattened
    token-major: ``order`` sorts them by expert (stable), and the
    assignment at sorted position i has rank i - (its expert's segment
    start); it is kept while its rank is below C, in slot expert*C + rank,
    and a dropped one gets slot E*C. Returns (order, slot, keep), the
    last two in sorted order."""
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = torch.searchsorted(
        se, torch.arange(E, device=se.device, dtype=se.dtype))
    rank = torch.arange(se.numel(), device=se.device) - seg_start[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))
    return order, slot, keep


def load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum over experts of the mean router
    probability times the mean number of the token's K picks it gets."""
    share = (gate_idx[..., None] == torch.arange(E, device=probs.device)
             ).to(torch.float32).sum(1)
    return E * torch.sum(probs.mean(0) * share.mean(0))


def gather_tokens(xf: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
                  K: int, E: int, C: int) -> torch.Tensor:
    """The (E, C, D) expert buckets: kept assignments copied into their
    unique slots, every dropped one onto a spare row, empty slots 0."""
    disp = torch.zeros((E * C + 1, xf.shape[1]), dtype=xf.dtype,
                       device=xf.device)
    disp.index_copy_(0, slot, xf[torch.div(order, K, rounding_mode="floor")])
    return disp[:E * C].view(E, C, -1)


def expert_products(p: Dict, disp: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Every expert's gated FFN over all C of its slots: (E, C, D) ->
    (E*C, D), three batched products in the compute dtype (experts are
    gated: a ``gelu_mlp`` config's take swiglu, as in the reference)."""
    gate = torch.bmm(disp, p["w_gate"])
    up = torch.bmm(disp, p["w_up"])
    act = "swiglu" if cfg.act == "gelu_mlp" else cfg.act
    eo = torch.bmm(common.gated_act(act, up, gate), p["w_down"])
    return eo.reshape(-1, eo.shape[-1])


def combine(eo: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
            keep: torch.Tensor, gate_vals: torch.Tensor) -> torch.Tensor:
    """(T, D): each token gathers its K expert rows (token order, through
    the inverse of the sort), weights them by its renormalised gates (a
    dropped one by 0) and sums them in top-k order."""
    T, K = gate_vals.shape
    n = eo.shape[0]
    tok_slot = torch.empty_like(slot).index_copy_(0, order, slot)
    tok_keep = torch.empty_like(keep).index_copy_(0, order, keep)
    w = (gate_vals.reshape(-1) * tok_keep).to(eo.dtype)
    contrib = eo[torch.clamp_max(tok_slot, n - 1)] * w[:, None]
    return contrib.view(T, K, -1).sum(1)


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            train: bool = False):
    """x: (B,S,D) -> (B,S,D) in x's dtype; with ``train``, (out, the f32
    load-balance loss), as the reference returns them. Serving drops the
    loss and does not compute it. Under autograd the gradients flow
    through the gates (top-k values of the softmax) and the kept tokens'
    copies; a dropped assignment contributes nothing, as in the
    reference."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    K, E = m.experts_per_token, m.num_experts
    C = capacity(T, cfg)
    xf = x.reshape(T, D)
    probs, gate_vals, gate_idx = route(p, xf, K)
    order, slot, keep = dispatch(gate_idx, E, C)
    eo = expert_products(p, gather_tokens(xf, order, slot, K, E, C), cfg)
    out = combine(eo, order, slot, keep, gate_vals).reshape(B, S, D)
    if train:
        return out, load_balance_loss(probs, gate_idx, E)
    return out


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _local_experts(slot, keep, C: int, e0: int, El: int):
    """Slots relative to this rank's experts [e0, e0 + El): the spare row
    El*C for a dropped assignment or another rank's expert."""
    mine = keep & (slot >= e0 * C) & (slot < (e0 + El) * C)
    return torch.where(mine, slot - e0 * C, torch.full_like(slot, El * C)), \
        mine


def _moe_core_mesh(p: Dict, x: torch.Tensor, cfg: ModelConfig, ctx,
                   experts, mlp_shard, rows_differ: bool):
    """Route, dispatch to the local experts, expert products on the local F
    columns, combine. x (B,S,D) whole over ``model``. ``mlp_shard``: the
    axes the F columns are cut over; when the buckets differ between those
    ranks (``rows_differ``: each data row dispatched its own tokens) they
    are all-gathered there and the partial outputs reduce-scattered back,
    else the output stays partial over them. Returns (f32 (B,S,D) partial
    over ``experts`` (and over ``mlp_shard`` unless ``rows_differ``), the
    router's probabilities (T, E) and top-k ids (T, K) of these tokens)."""
    from repro_torch.core.collectives import all_gather, reduce_scatter
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    K, E = m.experts_per_token, m.num_experts
    C = capacity(T, cfg)
    xf = x.reshape(T, D)
    probs, gate_vals, gate_idx = route(p, xf, K)
    order, slot, keep = dispatch(gate_idx, E, C)
    El = p["w_gate"].shape[0]
    e0 = ctx.index(tuple(experts)) * El if experts else 0
    slot_l, mine = _local_experts(slot, keep, C, e0, El)
    disp = torch.zeros((El * C + 1, D), dtype=x.dtype, device=x.device)
    disp.index_copy_(0, slot_l, xf[torch.div(order, K,
                                             rounding_mode="floor")])
    disp = disp[:El * C].view(El, C, D)
    if mlp_shard and rows_differ:
        n = ctx.n(tuple(mlp_shard))
        disp = all_gather(disp, ctx.mesh, mlp_shard, 0, "moe_buckets")
        eo = expert_products(p, disp.view(n, El, C, D).transpose(0, 1)
                             .reshape(El, n * C, D), cfg)
        eo = eo.view(El, n, C, D).transpose(0, 1).reshape(n * El * C, D)
        eo = reduce_scatter(eo.to(torch.float32), ctx.mesh, mlp_shard, 0,
                            "moe_expert_out")
    else:
        eo = expert_products(p, disp, cfg).to(torch.float32)
    eo = torch.cat([eo, eo.new_zeros((1, D))])
    tok_slot = torch.empty_like(slot_l).index_copy_(0, order, slot_l)
    tok_mine = torch.empty_like(mine).index_copy_(0, order, mine)
    w = (gate_vals.reshape(-1) * tok_mine).to(torch.float32)
    out = (eo[tok_slot] * w[:, None]).view(T, K, D).sum(1)
    return out.view(B, S, D), probs, gate_idx


def _aux_share(probs: torch.Tensor, gate_idx: torch.Tensor, E: int, ctx
               ) -> torch.Tensor:
    """This rank's share of the load-balance loss of tokens that every
    rank of the mesh routed alike (one data row's, or every row's
    gathered): the router probabilities' per-expert sum is cut over the
    ranks of the non-batch axes (each sums its block of tokens) and
    summed with ``reduce_from``, so each token's probabilities get their
    gradient once there; and the loss is divided by the batch axes' rank
    count, so the shares summed over the batch axes give the unsharded
    loss (as the cross-entropy's shares do)."""
    from repro_torch.core.collectives import reduce_from
    from repro_torch.models.sharding import entry_of
    T = probs.shape[0]
    rep = tuple(a for a in ctx.mesh.axis_names if a not in ctx.batch_axes
                and ctx.mesh.shape[a] > 1)
    p_sum = probs
    if rep:
        p_sum = torch.tensor_split(probs, ctx.n(entry_of(rep)))[
            ctx.index(entry_of(rep))]
    p_sum = reduce_from(p_sum.sum(0), ctx.mesh, rep, "moe_aux")
    share = (gate_idx[..., None] == torch.arange(E, device=probs.device)
             ).to(torch.float32).sum(1)
    aux = E * torch.sum((p_sum / T) * (share.sum(0) / T))
    return aux / ctx.n(entry_of(ctx.batch_axes))


def _moe_ffn_sharded(p: Dict, x: torch.Tensor, cfg: ModelConfig, ctx,
                     experts, mlp_shard, train: bool = False):
    """Each data row dispatches its own tokens (capacity on the row's
    tokens); the aux loss is averaged over the data axes. Returns the f32
    output partial over ``experts`` (and the aux loss with ``train``)."""
    from repro_torch.core.collectives import all_reduce
    out, probs, gate_idx = _moe_core_mesh(p, x, cfg, ctx, experts, mlp_shard,
                                          rows_differ=True)
    aux = load_balance_loss(probs, gate_idx, cfg.moe.num_experts)
    dp = ctx.batch_axes
    aux = all_reduce(aux, ctx.mesh, dp, "moe_aux") / ctx.n(tuple(dp)) \
        if dp else aux
    return (out, aux) if train else out


def moe_ffn_mesh(p: Dict, x: torch.Tensor, cfg: ModelConfig, ctx,
                 experts, mlp_shard, train: bool = False):
    """``moe_ffn`` on a mesh: x (B,S,D) this data row's tokens, whole over
    ``model``. Returns the f32 output partial over ``experts`` (and with
    ``train`` this rank's share of the aux loss, ``_aux_share``). Several
    data rows: per-row dispatch (``_moe_ffn_sharded``) from 512 tokens a
    row when serving, else the rows' tokens gathered and dispatched
    together."""
    from repro_torch.core.collectives import (all_gather, all_reduce,
                                              reduce_scatter)
    dp = tuple(a for a in ctx.batch_axes if ctx.mesh.shape[a] > 1)
    B, S, _ = x.shape
    if dp and not train and B * S >= 512:
        return _moe_ffn_sharded(p, x, cfg, ctx, experts, mlp_shard, train)
    xg = all_gather(x, ctx.mesh, dp, 0, "moe_tokens") if dp else x
    out, probs, gate_idx = _moe_core_mesh(p, xg, cfg, ctx, experts,
                                          mlp_shard, rows_differ=False)
    if dp and tuple(mlp_shard) == dp:
        # the F partial sums and the row cut in one reduce-scatter
        out = reduce_scatter(out, ctx.mesh, dp, 0, "moe_tokens_back")
    else:
        if mlp_shard:
            out = all_reduce(out, ctx.mesh, mlp_shard, "moe_expert_out")
        if dp:
            out = ctx.local(out, (dp if len(dp) > 1 else dp[0],))
    if train:
        return out, _aux_share(probs, gate_idx, cfg.moe.num_experts, ctx)
    return out
