"""Training driver of the port: config-driven, resumable, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 --batch 8 --seq 256 [--full] --ckpt-dir CKPT \
        [--device cpu]

The port of ``repro.launch.train``. It wires the deterministic synthetic
data pipeline (a prefetch thread, resumable at any step), the family's
loss (``ModelAPI.loss``: chunked cross-entropy, blocks rematerialised, K3
with its gradient on CUDA), AdamW with the reference's cosine schedule,
the atomic keep-last-k checkpointer and the step registry
(``StaticRuntime``: ``train_step`` is registered once as ``"train"``, the
loss and the step count passed at each call, and ``stats()`` counts its
calls). A job that fails resumes from its latest checkpoint when it is
started again with the same ``ckpt_dir``; the elastic controller
(``repro_torch.runtime.elastic``) drives such a restart after a
simulated failure.

Runs on ``cuda`` unless ``device="cpu"`` is passed (``--device cpu``).
The reference's ``mesh`` and ``--executor`` (multi-device training) wait
for the multi-device training slice of the port, and pipeline
parallelism for its own; given here, they raise.
Configs with int8 weights raise too: the reference's ``train`` cannot
train them either (``jax.grad`` refuses their int8 leaves).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import SyntheticLMData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_lr
from repro_torch.runtime.static_runtime import StaticRuntime
from repro_torch.tree import tree_leaves, tree_unflatten

BASE_LR = 3e-4
WARMUP = 20
MULTI_DEVICE = ("multi-device training (a mesh, an executor: fsdp and "
                "grad_sync in the step, the elastic re-mesh) is not ported "
                "yet: it waits for the multi-device training slice of the "
                "port, and pipeline parallelism (core/pipeline.py's "
                "stage_params / make_pp_step) for the slice after it "
                "(ROADMAP Queue 1); serving on a mesh is ported "
                "(repro_torch.launch.serve --mesh)")


def batch_to_torch(batch, device) -> dict:
    """The data pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_step(params, opt, batch, *, loss, steps: int):
    """One step: the loss and its gradient with respect to every parameter
    leaf, the learning rate ``cosine_lr(opt.step, 3e-4, warmup=20,
    total=max(steps, 100))``, and ``adamw_update``. Returns (params, opt,
    {"loss", "grad_norm"}) as new trees (0-d device tensors in the dict:
    no host sync)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        value = loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    lr = cosine_lr(opt.step, BASE_LR, warmup=WARMUP, total=max(steps, 100))
    new_p, new_o, info = adamw_update(params, tree_unflatten(params, grads),
                                      opt, lr=lr)
    return new_p, new_o, {"loss": value.detach(), **info}


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
    calls, of any config). Returns (params, opt, losses): losses are
    (step, loss) at the first step and every ``log_every`` steps."""
    if mesh is not None or executor is not None:
        raise NotImplementedError(MULTI_DEVICE)
    dev = resolve_device(device)
    cfg = _config(arch, reduced)
    api = build_model(cfg, dev)
    params = api.init(seed)
    opt = adamw_init(params)
    start_step = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt:
        restored_step, state = ckpt.restore({"params": params, "opt": opt})
        if restored_step is not None:
            params, opt = state["params"], state["opt"]
            start_step = restored_step
            print(f"[train] resumed from step {start_step}")

    rt = runtime if runtime is not None else StaticRuntime()
    step_fn = rt.compile_step("train", train_step)
    if step_fn.fn is not train_step:
        raise ValueError("runtime: its 'train' step is another function")
    data = SyntheticLMData(cfg, batch, seq, seed=seed).start(
        from_step=start_step)
    losses = []
    try:
        it = iter(data)
        t0 = time.monotonic()
        for i in range(start_step + 1, steps + 1):
            _, host_batch = next(it)
            params, opt, info = step_fn(params, opt,
                                        batch_to_torch(host_batch, dev),
                                        loss=api.loss, steps=steps)
            if i % log_every == 0 or i == start_step + 1:
                loss = float(info["loss"])
                losses.append((i, loss))
                ms = (time.monotonic() - t0) / (i - start_step) * 1e3
                print(f"[train] step {i:5d} loss {loss:.4f} gnorm "
                      f"{float(info['grad_norm']):.3f} ({ms:.0f} ms/step)")
            if ckpt and i % ckpt_every == 0:
                ckpt.save(i, params=params, opt=opt)
    finally:
        data.stop()
    if ckpt:
        ckpt.save(steps, params=params, opt=opt)
    return params, opt, losses


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
    ap.add_argument("--executor", default=None,
                    help="multi-device executor: not ported (raises)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    _, _, losses = train(args.arch, args.steps, args.batch, args.seq,
                         reduced=args.reduced, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every, seed=args.seed,
                         device=args.device, executor=args.executor)
    if losses:
        first, last = losses[0][1], losses[-1][1]
        print(f"[train] loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
