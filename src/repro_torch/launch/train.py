"""Training driver of the port: config-driven, resumable, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --batch 8 --seq 256 [--full] --ckpt-dir CKPT \
        [--device cpu] [--mesh DxM [--executor sub_operator] \
        [--share-device]]

The port of ``repro.launch.train``. It wires the deterministic synthetic
data pipeline (a prefetch thread, resumable at any step), the family's
loss (``ModelAPI.loss``: chunked cross-entropy, blocks rematerialised, K3
with its gradient on CUDA), AdamW with the reference's cosine schedule,
the atomic keep-last-k checkpointer and the step registry
(``StaticRuntime``: ``train_step`` is registered once as ``"train"``, the
loss and the step count passed at each call, and ``stats()`` counts its
calls). A job that fails resumes from its latest checkpoint when it is
started again with the same ``ckpt_dir``; the elastic controller
(``repro_torch.runtime.elastic``) drives such a restart after a failure,
on one device or on a new mesh of ranks (``train_on_mesh``).

``train(mesh=..., executor=...)`` runs on every rank of a mesh (SPMD, as
the reference's does on its devices): the step is ``make_step``'s
(``mode="train"``: the executor's rules under fsdp), every rank takes its
rows of the global batch from the data pipeline, each rank holds its shards
of the parameters and moments, and a checkpoint is the whole tree, written
by rank 0 in the reference's format and cut again by every rank on
restore, so it restores on any mesh and on one device. ``--mesh DxM``
starts D*M ranks (``repro_torch.launch.mesh``) and prints rank 0's log.

Runs on ``cuda`` unless ``device="cpu"`` is passed (``--device cpu``).
Every family trains on a mesh (``--arch mamba2-1.3b``,
``recurrentgemma-9b`` and ``whisper-medium`` too; whisper's synthetic
frames are cut over the batch axes with its tokens). Pipeline parallelism
serves decode only, as the reference's; asked for in training, it
raises. Configs with int8 weights raise too: the reference's ``train``
cannot train them either (``jax.grad`` refuses their int8 leaves).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.execution import GradPlan, make_step, train_update
from repro_torch.data.synthetic import SyntheticLMData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.param_specs import (abstract_params, gather_params,
                                            shard_params)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWState, adamw_init, cosine_lr
from repro_torch.runtime.static_runtime import StaticRuntime
from repro_torch.tree import tree_map

BASE_LR = 3e-4
WARMUP = 20


def batch_to_torch(batch, device) -> dict:
    """The data pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_step(params, opt, batch, *, loss, steps: int,
               plan: Optional[GradPlan] = None):
    """One step (``core.execution.train_update``) at ``train``'s learning
    rate ``cosine_lr(opt.step, 3e-4, warmup=20, total=max(steps, 100))``.
    Returns (params, opt, {"loss", "grad_norm"}) as new trees (0-d device
    tensors in the dict: no host sync). On a mesh ``plan`` is the step's
    ``GradPlan`` and ``batch`` this rank's rows."""
    lr = cosine_lr(opt.step, BASE_LR, warmup=WARMUP, total=max(steps, 100))
    return train_update(params, opt, batch, loss=loss, lr_t=lr, plan=plan)


def _config(arch: Union[str, ModelConfig], reduced: bool) -> ModelConfig:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    cfg = cfg.reduced() if reduced else cfg
    if cfg.weight_int8:
        raise ValueError(
            f"{cfg.name}: a config with int8 weights cannot be trained: "
            "its linears hold int8 values with scales, and the reference's "
            "train cannot train it either (jax.grad raises TypeError on "
            "its int8 leaves); train the float config "
            "(.replace(weight_int8=False))")
    return cfg


def _whole_template(cfg: ModelConfig):
    """Empty CPU tensors of the whole parameter tree and its moments: the
    template a checkpoint restores into before every rank cuts it."""
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                      abstract_params(cfg))
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32),
                   params)
    return {"params": params,
            "opt": AdamWState(torch.zeros((), dtype=torch.int32), f32,
                              tree_map(torch.empty_like, f32))}


def save_state(ckpt: Checkpointer, step: int, params, opt, cfg=None,
               ctx=None):
    """Save (params, opt) at ``step``. On a mesh (``ctx``; every rank
    calls it) the shards are gathered whole (``gather_params``) and rank 0
    writes them, in the reference's format; the ranks wait for the
    write."""
    if ctx is None:
        ckpt.save(step, params=params, opt=opt)
        return
    whole = (gather_params(params, ctx, cfg),
             AdamWState(opt.step, gather_params(opt.mu, ctx, cfg),
                        gather_params(opt.nu, ctx, cfg)))
    if ctx.mesh.rank == 0:
        ckpt.save(step, params=whole[0], opt=whole[1])
    torch.distributed.barrier(group=ctx.mesh.control)


def restore_state(ckpt: Checkpointer, cfg: ModelConfig, ctx, device):
    """(step, params, opt) of the latest checkpoint, or (None, None,
    None): the whole tree read on every rank and cut to this rank's
    shards under ``ctx`` on ``device``, whatever mesh wrote it."""
    step, state = ckpt.restore(_whole_template(cfg))
    if step is None:
        return None, None, None

    def cut(tree):
        return tree_map(lambda t: t.to(device), shard_params(tree, ctx))
    opt = state["opt"]
    return step, cut(state["params"]), AdamWState(
        opt.step.to(device), cut(opt.mu), cut(opt.nu))


def train(arch: Union[str, ModelConfig], steps: int, batch: int, seq: int, *,
          reduced: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10, seed: int = 0,
          device: DeviceLike = None, mesh=None, executor=None,
          runtime: Optional[StaticRuntime] = None):
    """Train ``arch`` (a registered name or a ``ModelConfig``, reduced
    unless ``reduced=False``) for ``steps`` steps of ``batch`` x ``seq``
    synthetic tokens from seeded random weights. With ``ckpt_dir`` it
    resumes from the latest checkpoint there, saves every ``ckpt_every``
    steps and at the end. ``runtime``: the ``StaticRuntime`` to register
    the step in (a fresh one by default; one runtime may serve several
    calls, of any config). ``mesh`` (this rank's ``Mesh``; every rank of
    it calls ``train``) and ``executor`` (``sub_operator`` by default):
    ``make_step``'s bundle, ``batch`` the global batch. Returns (params,
    opt, losses): losses are (step, loss) at the first step and every
    ``log_every`` steps; on a mesh params and opt are this rank's shards
    and the loss the global one."""
    if executor is not None and mesh is None:
        raise ValueError("train: an executor needs a mesh (mesh=..., or "
                         "--mesh DxM on the command line)")
    cfg = _config(arch, reduced)
    if mesh is None:
        dev = resolve_device(device)
        api, ctx, plan = build_model(cfg, dev), None, None
    else:
        dev = mesh.device
        bundle = make_step(cfg, ShapeConfig("custom", seq_len=seq,
                                            global_batch=batch,
                                            mode="train"),
                           mesh, executor or "sub_operator")
        api, ctx, plan = bundle.api, bundle.ctx, bundle.plan
    params = api.init(seed)
    if ctx is not None:
        params = shard_params(params, ctx)
    opt = adamw_init(params)
    start_step = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt:
        if ctx is None:
            restored_step, state = ckpt.restore({"params": params,
                                                 "opt": opt})
            if restored_step is not None:
                params, opt = state["params"], state["opt"]
        else:
            restored_step, p, o = restore_state(ckpt, cfg, ctx, dev)
            if restored_step is not None:
                params, opt = p, o
        if restored_step is not None:
            start_step = restored_step
            _log(mesh, f"[train] resumed from step {start_step}")

    rt = runtime if runtime is not None else StaticRuntime()
    step_fn = rt.compile_step("train", train_step)
    if step_fn.fn is not train_step:
        raise ValueError("runtime: its 'train' step is another function")
    # on a mesh this rank's rows of the global batch
    data = SyntheticLMData(cfg, batch, seq, seed=seed,
                           rows=ctx.batch_rows(batch) if ctx else None
                           ).start(from_step=start_step)
    losses = []
    try:
        it = iter(data)
        t0 = time.monotonic()
        for i in range(start_step + 1, steps + 1):
            _, host_batch = next(it)
            params, opt, info = step_fn(params, opt,
                                        batch_to_torch(host_batch, dev),
                                        loss=api.loss, steps=steps,
                                        plan=plan)
            if i % log_every == 0 or i == start_step + 1:
                loss = float(info["loss"])
                losses.append((i, loss))
                ms = (time.monotonic() - t0) / (i - start_step) * 1e3
                _log(mesh, f"[train] step {i:5d} loss {loss:.4f} gnorm "
                     f"{float(info['grad_norm']):.3f} ({ms:.0f} ms/step)")
            if ckpt and i % ckpt_every == 0:
                save_state(ckpt, i, params, opt, cfg, ctx)
    finally:
        data.stop()
    if ckpt:
        save_state(ckpt, steps, params, opt, cfg, ctx)
    return params, opt, losses


def _log(mesh, line: str):
    """Print ``line`` (rank 0's only, on a mesh)."""
    if mesh is None or mesh.rank == 0:
        print(line, flush=True)


def _rank_train(mesh, arch, steps, batch, seq, kw):
    """One rank of ``train_on_mesh``: its losses."""
    return train(arch, steps, batch, seq, mesh=mesh, **kw)[2]


def train_on_mesh(shape: Tuple[int, ...], arch, steps: int, batch: int,
                  seq: int, *, device: str = "cuda",
                  share_device: bool = False, timeout_s: float = 900.0,
                  **kw):
    """Start the ranks of a ("data", "model") mesh of ``shape`` (or
    ("pod", "data", "model") for three sizes), run ``train`` on each and
    return rank 0's losses. ``share_device``: every rank on ``cuda:0``
    over gloo (one card); ``kw``: ``train``'s keywords."""
    from repro_torch.launch.mesh import launch
    axes = ("pod", "data", "model")[-len(shape):]
    return launch(_rank_train, shape, axes, (arch, steps, batch, seq, kw),
                  device=device, share_device=share_device,
                  timeout_s=timeout_s).join()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="train on a DxM (data x model) mesh of ranks, one "
                         "process each")
    ap.add_argument("--executor", default=None,
                    help="the mesh's rules table (with --mesh; default "
                         "sub_operator, under fsdp)")
    ap.add_argument("--share-device", action="store_true",
                    help="with --mesh and --device cuda: every rank on "
                         "cuda:0 over gloo")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if (args.executor or args.share_device) and not args.mesh:
        raise SystemExit("train: --executor and --share-device need --mesh")
    kw = dict(reduced=args.reduced, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, log_every=args.log_every,
              seed=args.seed)
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        losses = train_on_mesh(shape, args.arch, args.steps, args.batch,
                               args.seq, device=args.device or "cuda",
                               share_device=args.share_device,
                               executor=args.executor, **kw)
    else:
        _, _, losses = train(args.arch, args.steps, args.batch, args.seq,
                             device=args.device, **kw)
    if losses:
        first, last = losses[0][1], losses[-1][1]
        print(f"[train] loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
