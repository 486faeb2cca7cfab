"""Rank-side halves of the mesh training tests (``test_torch_mesh_train.py``
and ``test_torch_mesh_elastic.py``): each function runs on every rank of
a mesh started by ``repro_torch.launch.mesh.launch`` and returns CPU
results (numpy trees in the reference's layout, from rank 0) for the test
process to hold against the reference. This module imports no JAX (every
rank imports it); the weights arrive as the reference's numpy trees."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.core.execution import (EXECUTORS, loss_and_grads,
                                        make_rules, make_step)
from repro_torch.interop import params_from_numpy, tree_to_numpy
from repro_torch.launch.train import batch_to_torch, train
from repro_torch.models.param_specs import gather_params, shard_params
from repro_torch.models.sharding import ShardingCtx, fsdp
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.elastic import NodeFailure
from repro_torch.runtime.static_runtime import StaticRuntime
from repro_torch.tree import tree_unflatten

DENSE = "internlm2-1.8b"
TIED = "qwen2-0.5b"
MOE = "phi3.5-moe-42b-a6.6b"
VLM = "internvl2-76b"
SSM = "mamba2-1.3b"
HYBRID = "recurrentgemma-9b"
AUDIO = "whisper-medium"
FAMILIES = (SSM, HYBRID, AUDIO)
B, S = 4, 16


def family_overrides(cfg):
    """The reduced hybrid at 4 layers (one superblock and one recurrent
    tail layer) with a window of 8 (the band masks keys of a 16-token
    sequence); the other configs as they are. Works on the reference's
    configs and the port's alike."""
    if cfg.family != "hybrid":
        return cfg
    return cfg.replace(n_layers=4, rglru=dataclasses.replace(cfg.rglru,
                                                             window=8))


def train_cfg(arch):
    return family_overrides(get_config(arch).reduced()
                            .replace(dtype="float32"))


def steps_on_mesh(mesh, arch, tree, batches, executor):
    """The bundle's gradients on ``batches[0]`` (summed as the step sums
    them, gathered whole) and then ``len(batches)`` steps of
    ``make_step(mode="train")``: per step (loss, grad_norm, whole
    parameters), and the collective bytes and calls of a step by site.
    Rank 0 returns them, the other ranks None."""
    cfg = train_cfg(arch)
    b = make_step(cfg, ShapeConfig("t", S, B, "train"), mesh, executor)
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), b.ctx)
    opt = adamw_init(params)
    batches = [batch_to_torch(x, "cpu") for x in batches]
    local = {k: b.ctx.batch_local(v) for k, v in batches[0].items()}
    loss0, grads = loss_and_grads(params, local, loss=b.api.loss,
                                  plan=b.plan)
    grads = gather_params(tree_unflatten(params, grads), b.ctx, cfg)
    meter = C.meter(mesh)
    meter.reset()
    steps = []
    for batch in batches:
        params, opt, info = b.fn(params, opt, batch)
        steps.append((float(info["loss"]), float(info["grad_norm"]),
                      tree_to_numpy(gather_params(params, b.ctx, cfg))))
        if len(steps) == 1:
            stats = meter.stats()
            per_site = {}
            for (k, site), n in meter.bytes.items():
                c, b0 = per_site.get(site, (0, 0.0))
                per_site[site] = (c + meter.calls[(k, site)], b0 + n)
    if mesh.rank:
        return None
    return {"loss0": float(loss0), "grads": tree_to_numpy(grads),
            "steps": steps, "bytes": stats["bytes_total"],
            "calls": stats["calls"], "sites": per_site}


def mesh_2x2(mesh, trees, batches):
    """Reduced internlm2 under every executor, tied qwen2 and the MoE
    and the VLM (text-only loss) under sub_operator, on a (2, 2) ("data",
    "model") mesh."""
    out = {ex: steps_on_mesh(mesh, DENSE, trees[DENSE], batches[DENSE], ex)
           for ex in EXECUTORS}
    for arch in (TIED, MOE, VLM):
        out[arch] = steps_on_mesh(mesh, arch, trees[arch], batches[arch],
                                  "sub_operator")
    return out


def mesh_pod(mesh, trees, batches):
    """Reduced internlm2 under every executor on a (2, 1, 2) ("pod",
    "data", "model") mesh: the batch over pod x data, ``grad_sync``
    hierarchical over the pod axis; and one step of reduced mamba2
    through ``train(mesh=...)`` (rank 0 returns its losses)."""
    out = {ex: steps_on_mesh(mesh, DENSE, trees[DENSE], batches[DENSE], ex)
           for ex in EXECUTORS}
    losses = train(SSM, steps=1, batch=B, seq=S, mesh=mesh)[2]
    if mesh.rank == 0:
        out["mamba2_train"] = losses
    return out


def families_2x2(mesh, trees, batches):
    """Reduced mamba2, recurrentgemma (4 layers, window 8) and whisper
    under every executor on a (2, 2) ("data", "model") mesh."""
    return {(arch, ex): steps_on_mesh(mesh, arch, trees[arch],
                                      batches[arch], ex)
            for arch in FAMILIES for ex in EXECUTORS}


def families_pod(mesh, trees, batches):
    """Reduced whisper under sub_operator on a (2, 1, 2) ("pod", "data",
    "model") mesh, the pod axis a data axis (``pod_strategy="dp"``)."""
    return {(AUDIO, "sub_operator"): steps_on_mesh(
        mesh, AUDIO, trees[AUDIO], batches[AUDIO], "sub_operator")}


# ---------------------------------------------------------------------------
# train(mesh=...) on real ranks (checkpoints, a failure, the re-mesh)
# ---------------------------------------------------------------------------

def train_run(mesh, kw, fail=None, arch=DENSE, moments=False):
    """``train(mesh=...)`` of ``train_cfg(arch)`` (reduced internlm2 by
    default, f32) with ``kw``; with
    ``fail`` = (domain, step) the ranks of that data row raise
    ``NodeFailure`` as that step's dispatch starts (the step registry's
    interceptor; a fresh run's step i is its i-th dispatch). Rank 0
    returns (losses, whole parameters in the reference's layout), and
    with ``moments`` AdamW's state too ({"step", "mu", "nu"}, whole);
    the others None."""
    rt = StaticRuntime()
    if fail is not None and mesh.coords["data"] == fail[0]:
        def node_failure(name):
            if rt.stats()[name]["calls"] + 1 == fail[1]:
                raise NodeFailure(fail[0], "injected")
        rt.set_interceptor(node_failure)
    cfg = train_cfg(arch)
    params, opt, losses = train(cfg, mesh=mesh, reduced=False, runtime=rt,
                                **kw)
    ctx = ShardingCtx(mesh, fsdp(make_rules(kw.get("executor")
                                            or "sub_operator", mesh)))
    out = (losses, tree_to_numpy(gather_params(params, ctx, cfg)))
    if moments:
        out += ({"step": int(opt.step),
                 "mu": tree_to_numpy(gather_params(opt.mu, ctx, cfg)),
                 "nu": tree_to_numpy(gather_params(opt.nu, ctx, cfg))},)
    return None if mesh.rank else out


def full_init(arch=DENSE):
    """``train``'s seeded parameters of ``train_cfg(arch)`` on the CPU,
    whole (what every rank draws before cutting its shards)."""
    from repro_torch.models.registry import build_model
    return build_model(train_cfg(arch), "cpu").init(0)


def one_step_loss(mesh, arch, batch, seq):
    """One step of ``make_step(mode="train")`` of reduced ``arch`` (its
    default dtype) from seeded weights on the synthetic data: rank 0
    returns the step's loss."""
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.models.registry import build_model
    cfg = get_config(arch).reduced()
    b = make_step(cfg, ShapeConfig("t", seq, batch, "train"), mesh)
    params = shard_params(build_model(cfg, "cpu").init(0), b.ctx)
    data = SyntheticLMData(cfg, batch, seq, seed=0).batch_at(0)
    _, _, info = b.fn(params, adamw_init(params), batch_to_torch(data,
                                                                 "cpu"))
    return None if mesh.rank else float(info["loss"])
