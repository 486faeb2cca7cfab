"""Pipeline parallelism over the ``pod`` axis, and the static schedules of
the weight–attention (WA) layer loop: the port of ``repro.core.pipeline``.

Token-pipelined DECODE for the transformer family (``make_pp_step``): the
pod axis carries ``n_stages`` pipeline stages, each a line of ranks over
("data", "model") holding its ``L / n_stages`` layers (``stage_params``),
its own int8 KV of those layers and its cursor. Each call advances every
stage by its layers and hands its (B, 1, d_model) activation to the next
stage, one ``exchange`` per call on the pod axis (the reference's
``jnp.roll`` of ``x_carry``, a ppermute): the paper's "embeddings only" --
KV and weights never cross the pod axis. Stage 0 embeds its token row;
every stage returns its logits. As in the reference each stage's cursor
counts calls, so at call t stage s > 0 writes the KV of the activation of
call t - 1 at position t, and at call 0 the stages s > 0 run on the zero
initial activation.

``skewed_schedule`` is the software-pipeline pattern the WA backend's
overlapped decode follows (participant m runs op t - m at tick t);
``wa_schedule_occupancy`` is its per-domain occupancy, the schedule
arithmetic behind ``stats()["wa"]``. Plain Python integers, no device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Schedule = List[Tuple[int, List[Tuple[int, int]]]]


def skewed_schedule(n_ops: int, depth: int) -> Schedule:
    """Static software-pipeline schedule: ``depth`` participants each run
    the same chain of ``n_ops`` ops, participant ``m`` skewed ``m`` ticks
    behind participant 0. Returns ``[(tick, [(m, op), ...]), ...]`` over
    ``n_ops + depth - 1`` ticks; at each tick the live participants hold
    consecutive op indices (op = tick - m), so for an alternating
    two-domain op chain adjacent participants occupy opposite domains."""
    if n_ops < 1 or depth < 1:
        raise ValueError(f"need n_ops >= 1 and depth >= 1, got "
                         f"({n_ops}, {depth})")
    return [(t, [(m, t - m) for m in range(depth) if 0 <= t - m < n_ops])
            for t in range(n_ops + depth - 1)]


def wa_schedule_occupancy(n_layers: int, depth: int) -> Dict[str, Any]:
    """Per-domain occupancy of the skewed WA decode schedule: the op chain
    is 2L+1 alternating ops (even = W: embed/QKV/FFN/unembed, odd = A:
    attention), so a tick is W-busy (A-busy) when a live micro-batch holds
    an even (odd) op. Depth 1 is the sequential loop (``overlap_efficiency``
    ~0.5); depth >= 2 keeps both domains busy on every interior tick."""
    sched = skewed_schedule(2 * n_layers + 1, depth)
    w_busy = sum(1 for _t, live in sched
                 if any(op % 2 == 0 for _m, op in live))
    a_busy = sum(1 for _t, live in sched
                 if any(op % 2 == 1 for _m, op in live))
    total = len(sched)
    return {
        "total_ticks": total,
        "w_busy_ticks": w_busy,
        "a_busy_ticks": a_busy,
        "w_idle_frac": (total - w_busy) / total,
        "a_idle_frac": (total - a_busy) / total,
        "overlap_efficiency": (w_busy + a_busy) / (2 * total),
    }


# ---------------------------------------------------------------------------
# Pipeline-parallel decode over the pod axis
# ---------------------------------------------------------------------------

def stage_params(params: Dict[str, Any], n_stages: int,
                 stage: int = None) -> Dict[str, Any]:
    """The reference's (L, ...) -> (n_stages, L / n_stages, ...) cut of the
    block leaves, on the port's list of layers: ``blocks`` becomes a list
    of ``n_stages`` lists of L / n_stages layers; with ``stage``, that
    stage's list only (what one pod rank holds). The head leaves stay."""
    blocks = params["blocks"]
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers do not cut into {n_stages} "
                         "pipeline stages")
    Lp = len(blocks) // n_stages
    staged = [blocks[s * Lp:(s + 1) * Lp] for s in range(n_stages)]
    out = dict(params)
    out["blocks"] = staged if stage is None else staged[stage]
    return out


def init_pp_caches(cfg, shape, ctx, device) -> Dict[str, Any]:
    """One pod rank's pipeline state: {"kv": the int8 KV of its stage's
    layers (Lp, B, n_kv, S, hd) with scales, cut over batch and KV heads
    (or positions) by the cache rules, its ``length`` the stage's cursor;
    "x_carry": the activation in flight (B, 1, d_model) in the compute
    dtype, cut over ``model`` on its last dim (the residual's placement),
    zeros}."""
    from repro_torch.kv.cache import init_kv_cache_sharded
    from repro_torch.models import common
    from repro_torch.models.registry import DECODE_SLACK
    from repro_torch.models.sharding import entry_of, layout
    n_stages = ctx.mesh.shape["pod"]
    dt = common.dtype_of(cfg)
    kv = init_kv_cache_sharded(
        ctx, cfg.n_layers // n_stages, shape.global_batch, cfg.n_kv_heads,
        shape.seq_len + DECODE_SLACK, cfg.head_dim, dtype=dt, quantized=True,
        device=device)
    lay = layout(cfg, ctx)
    B = shape.global_batch // ctx.n(ctx.batch_axes)
    D = cfg.d_model // ctx.n(entry_of(lay.res))
    return {"kv": kv, "x_carry": torch.zeros((B, 1, D), dtype=dt,
                                             device=device)}


def make_pp_step(cfg, shape, mesh, executor: str = "sub_operator"):
    """The reference's ``make_pp_step``: a decode step whose ``fn(params,
    caches, tokens)`` runs this rank's stage. ``params``: the stage's
    parameters (``stage_params(..., stage=pod index)``, then
    ``shard_params`` under the bundle's ``ctx``); ``caches``: this rank's
    ``init_pp_caches`` (the bundle's ``init_caches()``); ``tokens``:
    (n_stages, B) global, stage s reading row s. Returns (caches, logits
    (B_local, 1, V_local) f32 of this stage). One call: stage 0 embeds its
    row (every other stage takes ``x_carry``), the stage's layers run the
    shared-cursor decode at ``kv.length`` (``block_decode_slotted``, every
    row live: K1 over the int8 KV, K3 or K4 for the FFN), ``ln_f`` and the
    unembedding give the stage's logits, the cursor advances, and the
    activation moves one stage on: one ``exchange`` on the pod axis (site
    ``pp_hop``), this rank's (B_local, 1, d_model / M) slice. The rules
    are the reference's whatever the executor: sub_operator with the pod
    axis out of the batch axes, the KV sequence cut over the model axis
    for an executor ending in ``+seqkv``."""
    from repro_torch.core.execution import StepBundle
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import (ShardingCtx, layout,
                                             seq_sharded_kv, sub_operator)
    if shape.mode != "decode":
        raise NotImplementedError(
            "PP is implemented for decode (the paper's scenario); train/"
            "prefill scale across pods with pod-DP + hierarchical reduction")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError("PP decode targets transformer-family "
                                  "archs")
    n_stages = mesh.shape["pod"]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not cut into "
                         f"{n_stages} pipeline stages")
    cfg = cfg.replace(kv_dtype="int8")      # the paper's fully int8 serving
    rules = sub_operator(pod_is_dp=False)
    if executor.endswith("+seqkv"):
        rules = seq_sharded_kv(rules)
    ctx = ShardingCtx(mesh, rules)
    api = build_model(cfg.replace(n_layers=cfg.n_layers // n_stages),
                      mesh.device, ctx)
    lay = layout(cfg, ctx)

    def step(params, caches, tokens):
        from repro_torch.core.collectives import exchange
        s = mesh.coords["pod"]
        kv, x = caches["kv"], caches["x_carry"]
        if s == 0:
            tok = ctx.batch_local(tokens[s])[:, None]
            x = common.embed(params["embed"], tok, ctx, lay.vocab,
                             lay.res_spec()).to(x.dtype)
        B = x.shape[0]
        pos = kv.length
        positions = pos.expand(B)
        active = torch.ones(B, dtype=torch.bool, device=x.device)
        kv_limit = (pos + 1).to(torch.int32)
        seq = T.cache_seq(kv)
        for i, lp in enumerate(params["blocks"]):
            x = T.block_decode_slotted(lp, x, cfg, kv.layer(i), positions,
                                       active, kv_limit=kv_limit, lay=lay,
                                       seq=seq)
        logits = T.final_logits(params, x, cfg, lay)
        kv.length = (pos + 1).to(torch.int32)
        # the hop: stage s sends to s + 1 and takes s - 1's (mod n)
        nxt = mesh.rank_at(pod=(s + 1) % n_stages)
        prv = mesh.rank_at(pod=(s - 1) % n_stages)
        got = x
        if n_stages > 1:
            got = torch.empty_like(x)
            exchange([(x.contiguous(), nxt)], [(got, prv)], mesh, "pod",
                     "pp_hop")
        return {"kv": kv, "x_carry": got}, logits.to(torch.float32)

    return StepBundle(
        f"{cfg.name}|{shape.name}|{executor}|pp{n_stages}|decode", step,
        ctx, api, init_caches=lambda device=mesh.device: init_pp_caches(
            cfg, shape, ctx, device))
