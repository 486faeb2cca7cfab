"""Execution-model assembly: (arch x shape x mesh x executor) -> a step
bundle whose ``fn`` runs on every rank. The port of
``repro.core.execution`` for serving (``prefill`` and ``decode``).

Executors (the paper's operator-boundary vs dependency-driven dichotomy,
expressed as rules tables: the math is identical, the collective schedule
is not):

  operator_centric   per-head activations and the residual stream are
                     materialized on every rank at every operator boundary
                     (all-gathers of q and the attention output, an
                     all-reduce after wo and w_down).
  sub_operator       per-head activations stay on the owning rank through
                     QKV -> RoPE -> attention -> partial wo; the residual
                     stream lives reduce-scattered between blocks.
  sub_operator+seqkv the KV sequence cut over the model axis (distributed
                     flash decode with the LSE merge).

SPMD: every rank builds the same bundle and calls ``fn`` with the same
global inputs; ``fn`` cuts them to the rank's share (``ctx.batch_local``,
``shard_params`` beforehand) and returns the rank's outputs.

Training (``mode="train"``) runs the executor's table under ``fsdp``
(ZeRO-3: the weights' embed dim and the embedding rows over the data axis,
AdamW's f32 moments cut as their parameters). Each rank differentiates its
share of the loss (``ModelAPI.loss`` on a mesh: the shares summed over
the batch axes are the loss) through collectives whose backward is their
transpose (``core/collectives.py``), so a leaf's gradient on a rank is its
part of the whole: ``GradPlan`` sums the parts of a leaf replicated on a
non-batch axis with Megatron's f (``copy_to``) as it enters the model and
those of a leaf replicated on a batch axis with ``grad_sync`` (a
hierarchical sum with a pod axis), and ``global_norm`` counts each leaf's
shards once. Every family trains this way: the transformer's, the SSM's
and the enc-dec family's layers and the hybrid's superblocks and tail
layers each gather their fsdp shards inside their rematerialised unit
(``MeshLayout.weights``), and whisper's frames are cut over the batch
axes beside its tokens.

Pod strategies for a mesh with a "pod" axis: ``dp``, the pod axis joins
the batch axes; ``pp``, the pod axis is a pipeline of decode stages
(``core/pipeline.py::make_pp_step``, the transformer family), under the
sub-operator table whatever the executor, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.models.param_specs import abstract_params, param_specs
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.models.sharding import (ExecutionRules, ShardingCtx,
                                         axes_of, fsdp, operator_centric,
                                         seq_sharded_kv, sub_operator)
from repro_torch.optim.adamw import adamw_update, cosine_lr
from repro_torch.tree import tree_paths, tree_unflatten

EXECUTORS = ("operator_centric", "sub_operator", "sub_operator+seqkv")


def make_rules(executor: str, mesh) -> ExecutionRules:
    """The executor's table; a "pod" axis joins the batch axes (pod_is_dp)."""
    pod_is_dp = "pod" in mesh.axis_names
    if executor == "operator_centric":
        return operator_centric(pod_is_dp)
    if executor == "sub_operator":
        return sub_operator(pod_is_dp)
    if executor == "sub_operator+seqkv":
        return seq_sharded_kv(sub_operator(pod_is_dp))
    raise ValueError(f"unknown executor {executor!r}; choose from "
                     f"{EXECUTORS}")


@dataclass
class StepBundle:
    """One cell's step on this rank: ``fn`` and what it runs under
    (``plan``: the train step's ``GradPlan``; ``init_caches``: a pipeline
    step's state on this rank)."""
    name: str
    fn: Callable
    ctx: ShardingCtx
    api: ModelAPI
    plan: Optional["GradPlan"] = None
    init_caches: Optional[Callable] = None


class GradPlan:
    """Where each parameter leaf of ``cfg`` lives on ``ctx``'s mesh, for
    the train step, from the specs of the global shapes: ``sharded[path]``
    the mesh axes its shards are cut over, ``enter[path]`` the non-batch
    axes it is replicated on (f there: the backward sums the ranks'
    parts), ``sync[path]`` the batch axes it is replicated on (summed by
    ``grad_sync`` after the backward; with a pod axis the data axis stays
    in, whatever its size, as the hierarchical sum's fast axis). Other
    axes of size 1 are left out."""

    def __init__(self, cfg: ModelConfig, ctx: ShardingCtx):
        mesh = ctx.mesh
        self.ctx = ctx
        self.sharded, self.enter, self.sync = {}, {}, {}
        for path, spec in param_specs(abstract_params(cfg), ctx).items():
            cut = {a for e in spec for a in axes_of(e)}
            rep = [a for a in mesh.axis_names if a not in cut]
            self.sharded[path] = "+".join(a for a in mesh.axis_names
                                          if a in cut and mesh.shape[a] > 1)
            self.enter[path] = tuple(a for a in rep if mesh.shape[a] > 1
                                     and a not in ctx.batch_axes)
            sync = tuple(a for a in rep if a in ctx.batch_axes)
            self.sync[path] = sync if any(mesh.shape[a] > 1
                                          for a in sync) else ()

    def grad_sync(self, paths, grads):
        """The gradients summed over the batch axes each leaf is replicated
        on: the leaves of one set of axes flattened into one f32 bucket,
        ``grad_sync`` (hierarchical over a pod axis), split back."""
        out = list(grads)
        groups = {}
        for i, p in enumerate(paths):
            if self.sync[p]:
                groups.setdefault(self.sync[p], []).append(i)
        for axes in sorted(groups):
            idx = groups[axes]
            flat = torch.cat([out[i].reshape(-1).to(torch.float32)
                              for i in idx])
            pod = "pod" if "pod" in axes else None
            flat = C.grad_sync([flat], self.ctx.mesh,
                               tuple(a for a in axes if a != "pod"), pod,
                               mean=False)[0]
            for i, part in zip(idx, torch.split(
                    flat, [out[i].numel() for i in idx])):
                out[i] = part.view(out[i].shape).to(out[i].dtype)
        return out


def loss_and_grads(params, batch, *, loss: Callable,
                   plan: Optional[GradPlan] = None):
    """The loss and its gradient with respect to every parameter leaf
    (in ``tree_paths`` order; zeros for a leaf the loss does not use). On
    a mesh (``plan``) the trees are this rank's shards, ``batch`` its
    rows and ``loss`` returns its share: the gradients come back summed
    over the axes each leaf is replicated on, and the loss is the shares'
    sum over the batch axes."""
    paths = [p for p, _ in tree_paths(params)]
    leaves = [t.detach().requires_grad_(True) for _, t in tree_paths(params)]
    with torch.enable_grad():
        used = leaves if plan is None else [
            C.copy_to(t, plan.ctx.mesh, plan.enter[p], "grad_enter")
            for p, t in zip(paths, leaves)]
        value = loss(tree_unflatten(params, used), batch)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    value = value.detach()
    if plan is not None:
        grads = plan.grad_sync(paths, grads)
        value = C.all_reduce(value, plan.ctx.mesh, plan.ctx.batch_axes,
                             "loss")
    return value, grads


def train_update(params, opt, batch, *, loss: Callable, lr_t,
                 plan: Optional[GradPlan] = None):
    """One training step: ``loss_and_grads``, then ``adamw_update`` at
    the learning rate ``lr_t`` (on a mesh its norm counts each leaf's
    shards once). Returns (params, opt, {"loss", "grad_norm"}) as new
    trees (0-d device tensors in the dict: no host sync)."""
    value, grads = loss_and_grads(params, batch, loss=loss, plan=plan)
    mesh = sharded = None
    if plan is not None:
        mesh = plan.ctx.mesh
        sharded = tree_unflatten(params, [plan.sharded[p]
                                          for p, _ in tree_paths(params)])
    new_p, new_o, info = adamw_update(params, tree_unflatten(params, grads),
                                      opt, lr=lr_t, mesh=mesh,
                                      sharded=sharded)
    return new_p, new_o, {"loss": value, **info}


def make_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              executor: str = "sub_operator", pod_strategy: str = "dp",
              kv_int8=None, lr: float = 3e-4) -> StepBundle:
    """``prefill``: fn(params, tokens (B,S)) -> (cache, logits) (the enc-dec
    family's fn(params, tokens, frames (B,F,D))); ``decode``:
    fn(params, cache, tokens (B,)) -> (cache, logits); ``train``:
    fn(params, opt, batch) -> (params, opt, {"loss", "grad_norm"}), the
    reference's ``cosine_lr(step, lr, warmup=100, total=10_000)``, the
    loss the global mean on every rank. ``params`` (and the moments) are
    this rank's shards (``shard_params`` under the bundle's ``ctx``),
    tokens and batches the GLOBAL batch (cut here over the batch axes),
    the cache this rank's; logits cover this rank's rows and vocabulary
    block. Serving runs int8 KV by default, as the reference's
    (``kv_int8=None``; training has no KV). ``pod_strategy="pp"`` on a
    mesh with a "pod" axis: ``core/pipeline.py::make_pp_step``."""
    if kv_int8 is None:
        kv_int8 = shape.mode != "train"
    if kv_int8 and shape.mode != "train" and cfg.kv_dtype != "int8":
        cfg = cfg.replace(kv_dtype="int8")
    if pod_strategy == "pp" and "pod" in mesh.axis_names:
        from repro_torch.core.pipeline import make_pp_step
        return make_pp_step(cfg, shape, mesh, executor=executor)
    rules = make_rules(executor, mesh)
    if shape.mode == "train":
        rules = fsdp(rules)     # ZeRO-3: params + f32 moments fully shard
    ctx = ShardingCtx(mesh, rules)
    api = build_model(cfg, mesh.device, ctx)
    name = (f"{cfg.name}|{shape.name}|{executor}|"
            f"{'x'.join(map(str, mesh.devices_shape))}|{shape.mode}")

    if shape.mode == "train":
        plan = GradPlan(cfg, ctx)

        def train_step(params, opt, batch):
            batch = {k: ctx.batch_local(v) for k, v in batch.items()}
            return train_update(params, opt, batch, loss=api.loss,
                                lr_t=cosine_lr(opt.step, lr, warmup=100,
                                               total=10_000), plan=plan)
        return StepBundle(name, train_step, ctx, api, plan)

    if shape.mode == "prefill":
        def prefill_step(params, tokens, *extra):
            # the enc-dec family's frames ride beside the tokens, cut over
            # the batch axes as the reference's batch dict is
            return api.prefill(params, ctx.batch_local(tokens),
                               *(ctx.batch_local(e) for e in extra))
        return StepBundle(name, prefill_step, ctx, api)

    def decode_step(params, cache, tokens):
        return api.decode(params, cache, ctx.batch_local(tokens))
    return StepBundle(name, decode_step, ctx, api)
