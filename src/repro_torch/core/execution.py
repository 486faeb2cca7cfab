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
``shard_params`` beforehand) and returns the rank's outputs. Training
(``mode="train"``) waits for the multi-device training slice and the pod
axis as a pipeline (``pod_strategy="pp"``) for the pipeline-parallel
slice; both raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.models.sharding import (ExecutionRules, ShardingCtx,
                                         operator_centric, seq_sharded_kv,
                                         sub_operator)

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
    """One cell's step on this rank: ``fn`` and what it runs under."""
    name: str
    fn: Callable
    ctx: ShardingCtx
    api: ModelAPI


def make_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              executor: str = "sub_operator", pod_strategy: str = "dp",
              kv_int8=None) -> StepBundle:
    """``prefill``: fn(params, tokens (B,S)) -> (cache, logits); ``decode``:
    fn(params, cache, tokens (B,)) -> (cache, logits). ``params`` are this
    rank's shards (``shard_params``), tokens the GLOBAL batch (cut here over
    the batch axes), the cache this rank's; logits cover this rank's rows
    and vocabulary block. Serving runs int8 KV by default, as the
    reference's (``kv_int8=None``)."""
    if shape.mode == "train":
        raise NotImplementedError(
            "make_step(mode='train') on a mesh waits for the multi-device "
            "training slice of the port (fsdp, grad_sync in the step)")
    if pod_strategy == "pp" and "pod" in mesh.axis_names:
        raise NotImplementedError(
            "pod_strategy='pp' waits for the pipeline-parallel slice of the "
            "port (core/pipeline.py's stage_params and make_pp_step)")
    if kv_int8 is None:
        kv_int8 = True
    if kv_int8 and cfg.kv_dtype != "int8":
        cfg = cfg.replace(kv_dtype="int8")
    ctx = ShardingCtx(mesh, make_rules(executor, mesh))
    api = build_model(cfg, mesh.device, ctx)
    name = (f"{cfg.name}|{shape.name}|{executor}|"
            f"{'x'.join(map(str, mesh.devices_shape))}|{shape.mode}")

    if shape.mode == "prefill":
        def prefill_step(params, tokens):
            return api.prefill(params, ctx.batch_local(tokens))
        return StepBundle(name, prefill_step, ctx, api)

    def decode_step(params, cache, tokens):
        return api.decode(params, cache, ctx.batch_local(tokens))
    return StepBundle(name, decode_step, ctx, api)
