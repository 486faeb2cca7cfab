"""Rank-side halves of the mesh tests (``test_torch_mesh*.py``,
``test_torch_collectives.py``): each function runs on every rank of a mesh
started by ``repro_torch.launch.mesh.launch`` and returns CPU results for
the test process to hold against the reference. This module imports no JAX
(every rank imports it); the weights arrive as the reference's numpy
trees."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import collectives as C
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.execution import make_step
from repro_torch.core.wa import WADisaggregated, WAPlan
from repro_torch.interop import params_from_numpy
from repro_torch.kv.cache import write_slot_kv
from repro_torch.models import common
from repro_torch.models.moe import _moe_ffn_sharded
from repro_torch.models.param_specs import shard_cache, shard_params
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import ShardingCtx, sub_operator
from repro_torch.quant.int8 import quantize_int8
from repro_torch.runtime.serving import Request, ServingEngine

DENSE = "internlm2-1.8b"
MOE = "phi3.5-moe-42b-a6.6b"
ENGINE_KW = dict(mode="continuous", max_new_cap=24, block_size=4,
                 kv_bucket_chunk=16, prefill_chunk=4)
# the reference's engine cases (tests/test_distributed.py): (new tokens,
# arrival step, prompt length); the ragged one ends a prompt inside the
# first shard block and crosses a block mid-decode
PLAN = [(6, 0, 8), (10, 0, 8), (6, 2, 8)]
RAGGED = [(6, 0, 5), (10, 0, 8), (6, 2, 7)]
INT8 = dict(kv_dtype="int8", weight_int8=True)


def dense_cfg(**over):
    return get_config(DENSE).reduced().replace(dtype="float32", **over)


def moe_cfg():
    cfg = get_config(MOE).reduced().replace(dtype="float32")
    # a capacity of 8 slots per expert for 32 tokens a row: overflow
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def requests(cfg, plan):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, p,
                                               dtype=np.int32),
                    max_new_tokens=n, arrival_step=a)
            for i, (n, a, p) in enumerate(plan)]


# ---------------------------------------------------------------------------
# The model on a mesh
# ---------------------------------------------------------------------------

class K4Rows:
    """Records the int8 rows every K4 call multiplies on this rank (the
    shared q/k/v and gate/up calls see whole rows, the row-parallel wo and
    w_down this rank's slice of each row), in call order."""

    def __init__(self):
        import repro_torch.kernels.gemv.ops as gemv_ops
        self.rows, self._mods = [], (gemv_ops, common)
        self._k4 = gemv_ops.gemv_int8_q

    def _rec(self, xq, xs, wq, ws):
        self.rows.append(xq.numpy().copy())
        return self._k4(xq, xs, wq, ws)

    def __enter__(self):
        for m in self._mods:
            m.gemv_int8_q = self._rec
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.gemv_int8_q = self._k4

    def drain(self):
        out, self.rows = self.rows, []
        return out


def model_steps(mesh, tree, executor: str, toks: np.ndarray, S: int,
                over: dict, record: bool = False):
    """Prefill toks[:, :S], then teacher-forced decode of toks[:, S:]:
    (whole-vocabulary logits of this rank's rows at each step, their
    greedy tokens, the collective bytes of the run). ``record`` (int8):
    also, per step, the int8 rows of every K4 call (``K4Rows``) and this
    rank's stored K/V bytes."""
    cfg = dense_cfg(**over)
    kv_int8 = cfg.kv_dtype == "int8"
    pre = make_step(cfg, ShapeConfig("p", S, toks.shape[0], "prefill"), mesh,
                    executor, kv_int8=kv_int8)
    dec = make_step(cfg, ShapeConfig("d", S, toks.shape[0], "decode"), mesh,
                    executor, kv_int8=kv_int8)
    api = pre.api
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), pre.ctx)
    t = torch.from_numpy(toks.astype(np.int64))
    C.meter(mesh).reset()
    rec, steps = K4Rows(), []
    with rec if record else contextlib.nullcontext():
        cache, lg = pre.fn(params, t[:, :S])
        logits = [api.full_logits(lg[:, -1])]
        greedy = [api.greedy(lg[:, -1])]
        steps.append((rec.drain(), cache.k.numpy().copy(),
                      cache.v.numpy().copy()))
        for i in range(S, toks.shape[1]):
            cache, lg = dec.fn(params, cache, t[:, i].to(torch.int32))
            logits.append(api.full_logits(lg[:, -1]))
            greedy.append(api.greedy(lg[:, -1]))
            steps.append((rec.drain(), cache.k.numpy().copy(),
                          cache.v.numpy().copy()))
    out = (torch.stack(logits), torch.stack(greedy), C.meter(mesh).total())
    return out + (steps,) if record else out


def int8_row_parallel(mesh):
    """A row-parallel int8 layer over the model axis: each rank's slice of
    x quantized with the whole row's maximum (``row_quantize``) against the
    unsharded ``quantize_int8``; and the reduced product against the
    unsharded one."""
    ctx = ShardingCtx(mesh, sub_operator(False))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 256), generator=g) * torch.linspace(0.1, 3.0, 256)
    w = quantize_int8(torch.randn((256, 128), generator=g) / 16, axis=0)
    rows = ("model",)
    lo = mesh.index("model") * 128
    hi = lo + 128
    got = common.row_quantize(x[:, lo:hi], ctx, rows)
    want = quantize_int8(x, axis=-1)
    part, finish = common.linear_partial(
        {"w": type(w)(w.values[lo:hi], w.scale)}, x[:, lo:hi], ctx, rows)
    full = finish(C.all_reduce(part, mesh, rows))
    from repro_torch.quant.int8 import int8_matmul
    return (torch.equal(got.scale, want.scale),
            torch.equal(got.values, want.values[:, lo:hi]),
            torch.equal(full, int8_matmul(x, w, torch.float32)))


def moe_rows(mesh, tree, x: np.ndarray):
    """``_moe_ffn_sharded`` of layer 0 on this rank's data row of x,
    reduced over the expert axes."""
    cfg = moe_cfg()
    ctx = ShardingCtx(mesh, sub_operator(False))
    from repro_torch.models.transformer import MeshLayout
    lay = MeshLayout(cfg, ctx)
    p = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    xl = ctx.batch_local(torch.from_numpy(x))
    out = _moe_ffn_sharded(p["blocks"][0]["moe"], xl, cfg, ctx, lay.experts,
                           lay.mlp_shard)
    return C.all_reduce(out, mesh, lay.experts), lay.experts, lay.mlp_shard


def wa_device_put(mesh, tree, toks: np.ndarray, S: int, S1: int):
    """The reference's staggered case: slot 0 prefilled with S tokens,
    slot 1 admitted with S1; one WA device_put slotted step (W on data row
    0, A on row 1). Returns (role, whole logits on W)."""
    cfg = dense_cfg()
    full = params_from_numpy(tree, cfg, "cpu")
    api = build_model(cfg, "cpu")
    t = torch.from_numpy(toks.astype(np.int64))
    caches, logits = api.prefill(full, t)
    c1, l1 = api.prefill(full, t[1:, :S1])
    caches = write_slot_kv(caches, c1, 1)
    cur = torch.stack([torch.argmax(logits[0, -1]),
                       torch.argmax(l1[0, -1])]).to(torch.int32)
    pos = torch.tensor([S, S1], dtype=torch.int32)
    act = torch.tensor([True, True])
    wa = WADisaggregated(cfg, "cpu", mesh=mesh, plan=WAPlan(True, 1, 1, "t"),
                         routing="device_put")
    if wa.role == "w":
        _, lg = wa.decode_step_slotted(shard_params(full, wa.w_ctx), None,
                                       cur, pos, act)
        lg = build_model(cfg, "cpu", wa.w_ctx).full_logits(lg)
    else:
        wa.decode_step_slotted(None, shard_cache(caches, wa.a_ctx), cur,
                               pos, act)
        lg = None
    return wa.role, lg, C.meter(mesh).stats()


def engine_streams(mesh, tree, backend: str, a_shards: int, plan):
    """Serve ``plan`` through the engine on this mesh (sub_operator rules):
    (token streams, completed, host syncs, mesh stats)."""
    cfg = dense_cfg()
    ctx = ShardingCtx(mesh, sub_operator())
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    reqs = requests(cfg, plan)
    st = ServingEngine(build_model(cfg, "cpu"), 2, 8, backend=backend,
                       a_shards=a_shards, device="cpu", ctx=ctx,
                       **ENGINE_KW).run(params, reqs, max_steps=300)
    return ([r.generated for r in reqs], st["completed"], st["host_syncs"],
            st["mesh"], sorted(st["runtime"]))


# ---------------------------------------------------------------------------
# What each test module's ranks run (one launch per module)
# ---------------------------------------------------------------------------

def mesh_2x2(mesh, trees, moe_tree, toks, S, wa_toks, S_wa, S1, moe_x):
    dense_tree = trees["f32"]
    out = {"model": {ex: model_steps(mesh, dense_tree, ex, toks, S, {})
                     for ex in ("operator_centric", "sub_operator",
                                "sub_operator+seqkv")},
           "model_int8": model_steps(mesh, trees["int8"], "sub_operator",
                                     toks, S, INT8, record=True),
           "int8": int8_row_parallel(mesh),
           "moe": moe_rows(mesh, moe_tree, moe_x),
           "wa": wa_device_put(mesh, dense_tree, wa_toks, S_wa, S1),
           "engine": {b: engine_streams(mesh, dense_tree, b, 1, PLAN)
                      for b in ("colocated", "wa")},
           "coords": mesh.coords}
    return out


def mesh_1x4(mesh, dense_tree, toks, S):
    return {"model": {ex: model_steps(mesh, dense_tree, ex, toks, S, {})
                      for ex in ("operator_centric", "sub_operator",
                                 "sub_operator+seqkv")},
            "engine": engine_streams(mesh, dense_tree, "wa", 4, RAGGED),
            "coords": mesh.coords}


def collectives(mesh):
    """On a (2,2) ("data", "model") mesh: flat vs hierarchical sums (fast
    axis "model", slow "data") with their bytes per axis; ring vs direct
    all-gather; control broadcasts and gathers."""
    g = torch.Generator().manual_seed(10 + mesh.rank)
    x = torch.randn((8, 6), generator=g)
    m = C.meter(mesh)
    m.reset()
    flat = C.all_reduce(x, mesh, ("data", "model"))
    flat_bytes = m.total("data+model")
    m.reset()
    hier = C.hierarchical_psum(x, mesh, "model", "data")
    slow_bytes = m.total("data")
    mean = C.hierarchical_pmean(x, mesh, "model", "data")
    out = {"flat": flat, "hier": hier, "mean": mean,
           "flat_bytes": flat_bytes, "slow_bytes": slow_bytes}
    for axis in ("model", "data"):
        y = torch.arange(6, dtype=torch.float32).reshape(2, 3) \
            + 100 * mesh.rank
        out[f"ring_{axis}"] = C.ring_all_gather(y, mesh, axis, 0)
        out[f"gather_{axis}"] = C.all_gather(y, mesh, (axis,), 0)
        out[f"ring1_{axis}"] = C.ring_all_gather(y, mesh, axis, 1)
        out[f"gather1_{axis}"] = C.all_gather(y, mesh, (axis,), 1)
    grads = {"a": x, "b": [x * 2]}
    out["grad_sync"] = C.grad_sync(grads, mesh, ("data",))
    m.reset()
    out["bcast"] = C.control_broadcast(torch.tensor([mesh.rank + 7]), mesh,
                                       src=3)
    out["cgather"] = C.control_all_gather(torch.tensor([mesh.rank]), mesh,
                                          ("data",))
    out["control_calls"] = m.control_calls
    out["rs"] = C.reduce_scatter(x, mesh, ("model",), 0)
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    again = make_test_mesh((2, 2), ("data", "model"))
    out["test_mesh"] = (again.coords, again.group_ranks("data"))
    try:
        make_production_mesh()
        out["production_mesh"] = "built"
    except RuntimeError as e:
        out["production_mesh"] = str(e)
    out["coords"] = mesh.coords
    out["x"] = x
    out["grads"] = collective_grads(mesh)
    return out


def collective_grads(mesh):
    """Each differentiable collective over "model" under autograd: this
    rank's x (4, 3) and upstream gradient w, both seeded by the rank, and
    the gradient of sum(w * op(x)) on this rank (the backward runs the
    op's transpose across the ranks), with the bytes and calls metered at
    the site's ".grad"."""
    g = torch.Generator().manual_seed(30 + mesh.rank)
    x = torch.randn((4, 3), generator=g)
    ops = {"all_gather": lambda t: C.all_gather(t, mesh, ("model",), 0,
                                                "g"),
           "reduce_scatter": lambda t: C.reduce_scatter(
               t, mesh, ("model",), 0, "g"),
           "all_reduce": lambda t: C.all_reduce(t, mesh, ("model",), "g"),
           "copy_to": lambda t: C.copy_to(t, mesh, ("model",), "g"),
           "reduce_from": lambda t: C.reduce_from(t, mesh, ("model",),
                                                  "g")}
    out = {"x": x}
    m = C.meter(mesh)
    for name, op in ops.items():
        xr = x.clone().requires_grad_(True)
        m.reset()
        y = op(xr)
        w = torch.randn(y.shape, generator=g)
        (dx,) = torch.autograd.grad((w * y).sum(), xr)
        out[name] = {"y": y.detach(), "w": w, "dx": dx,
                     "grad_calls": sum(c for (_, s), c in m.calls.items()
                                       if s == "g.grad")}
    return out


def collectives_on(mesh):
    """The collectives on this rank's device (a (1, 2) mesh): all-reduce,
    all-gather, reduce-scatter (straight through on gloo+CUDA),
    point-to-point and the ring all-gather (staged through pinned host
    memory there). CPU copies of every result."""
    dev = mesh.device
    g = torch.Generator().manual_seed(20 + mesh.rank)
    x = torch.randn((8, 6), generator=g).to(dev)
    other = 1 - mesh.rank
    got = torch.empty_like(x)
    C.exchange([(x, other)], [(got, other)], mesh, "model", "p2p")
    out = {"ar": C.all_reduce(x, mesh, ("model",)),
           "ag": C.all_gather(x, mesh, ("model",), 1),
           "rs": C.reduce_scatter(x, mesh, ("model",), 0),
           "p2p": got,
           "ring": C.ring_all_gather(x, mesh, "model", 0),
           "hier": C.hierarchical_psum(x, mesh, "model", "data")}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def coords_of(mesh):
    return mesh.coords
