"""AdamW with global-norm clipping and a cosine schedule: the port of
``repro.optim.adamw``.

The moments are float32 whatever the parameters' dtype; the update is
computed in float32 and cast back to each parameter's dtype. Every value
stays on the parameters' device (the step counter is a 0-d int32 tensor,
the learning rate a 0-d float32 tensor), so an update makes no host sync.
The functions are pure: they return new trees and leave their inputs as
they were.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # f32 tree, like params
    nu: Any                  # f32 tree, like params


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 and step 0, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(step: torch.Tensor, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac`` x base_lr at ``total``. A 0-d f32 tensor."""
    s = step.to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)


def global_norm(tree, mesh=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares. On a
    mesh, ``sharded`` is a tree of ``tree``'s structure naming, per leaf,
    the mesh axes its shards are cut over (joined with "+", "" for none):
    the sums of the leaves cut over the same axes are added, each group
    all-reduced over its axes once, and a leaf replicated on an axis is
    counted once (its replicas hold one gradient)."""
    leaves = tree_leaves(tree)
    if mesh is None:
        sums = [torch.sum(torch.square(x.to(torch.float32)))
                for x in leaves]
        return torch.sqrt(torch.sum(torch.stack(sums)))
    from repro_torch.core.collectives import all_reduce
    groups: dict = {}
    for x, key in zip(leaves, tree_leaves(sharded)):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        groups[key] = groups[key] + sq if key in groups else sq
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for key in sorted(groups):
        total = total + (all_reduce(groups[key], mesh, key.split("+"),
                                    "grad_norm") if key else groups[key])
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 mesh=None, sharded=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step at the reference's defaults: the gradients scaled by
    min(1, clip_norm / global_norm), bias-corrected moments, decoupled
    weight decay. Returns (new params, new state, {"grad_norm": the
    unclipped norm}). On a mesh the trees are this rank's shards (the
    moments cut as their parameters) and ``global_norm`` takes ``mesh``
    and ``sharded``."""
    gnorm = global_norm(grads, mesh, sharded)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        pf = p.to(torch.float32)
        return (pf - lr * (u + weight_decay * pf)).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_params, mu, nu = (_select(out, i) for i in range(3))
    return new_params, AdamWState(step, mu, nu), {"grad_norm": gnorm}


def _select(tree, i: int):
    """Item ``i`` of every (p, m, v) triple at the leaves of ``tree`` (a
    parameter tree: dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_select(v, i) for v in tree]
    return tree[i]
