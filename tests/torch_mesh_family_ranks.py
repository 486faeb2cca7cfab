"""Rank-side halves of ``test_torch_pipeline.py`` and
``test_torch_mesh_families.py``: each function runs on every rank of a
mesh started by ``repro_torch.launch.mesh.launch`` and returns CPU results
for the test process to hold against the reference. This module imports
no JAX (every rank imports it); the weights arrive as the reference's
numpy trees."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.core.execution import make_step
from repro_torch.interop import stage_params_from_numpy
from repro_torch.models.param_specs import cache_logical, shard_params

PP_ARCH, PP_LAYERS, PP_STAGES = "internlm2-1.8b", 4, 2
PP_B, PP_S, PP_CALLS = 4, 8, 4
PP_EXECUTORS = ("sub_operator", "sub_operator+seqkv", "operator_centric")


def pp_cfg(dtype: str):
    return get_config(PP_ARCH).reduced().replace(n_layers=PP_LAYERS,
                                                 dtype=dtype)


def _whole(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A local tensor all-gathered along every dim its spec cuts."""
    from repro_torch.models.sharding import axes_of
    for d, e in enumerate(spec):
        if axes_of(e):
            t = C.all_gather(t, mesh, axes_of(e), d, "check")
    return t


def pp_rank(mesh, trees, toks):
    """Every executor and dtype of ``trees`` ({dtype: the reference's
    staged parameters as numpy}): PP_CALLS calls of the PP decode step
    on this rank's stage. Per call: the stage's whole-vocabulary logits,
    its cursor, its x_carry and int8 K/V gathered whole over the model
    axis, and the pod axis's bytes by site so far."""
    s = mesh.coords["pod"]
    out = {"coords": mesh.coords}
    for dtype, tree in trees.items():
        cfg = pp_cfg(dtype)
        shape = ShapeConfig("pp", PP_S, PP_B, "decode")
        for ex in PP_EXECUTORS:
            bundle = make_step(cfg, shape, mesh, ex, pod_strategy="pp")
            ctx = bundle.ctx
            params = shard_params(stage_params_from_numpy(tree, cfg, s,
                                                          "cpu"), ctx)
            caches = bundle.init_caches()
            meter = C.meter(mesh)
            meter.reset()
            calls = []
            for t in range(PP_CALLS):
                caches, lg = bundle.fn(params, caches,
                                       torch.from_numpy(toks[t]))
                pod = {f"{k}|{site}": b for (k, site), b in
                       meter.bytes.items() if "pod" in k}
                kv = caches["kv"]
                full = (kv.k.shape[0], PP_B, cfg.n_kv_heads,
                        PP_S + 128, cfg.head_dim)
                spec = ctx.spec(cache_logical(("k",), full), full)
                sspec = spec[:4] + (None,)
                x = caches["x_carry"]
                calls.append({
                    "logits": bundle.api.full_logits(lg)[:, 0].float(),
                    "length": int(kv.length),
                    "x_carry": _whole(x, mesh, (None, None, "model")
                                      if x.shape[-1] < cfg.d_model
                                      else ()).float(),
                    "k": _whole(kv.k, mesh, spec),
                    "v": _whole(kv.v, mesh, spec),
                    "k_scale": _whole(kv.k_scale, mesh, sspec),
                    "pod_bytes": dict(pod)})
            out[(dtype, ex)] = {"name": bundle.name,
                                "rules": ctx.rules.name, "calls": calls,
                                "itemsize": torch.empty(
                                    0, dtype=getattr(torch, dtype))
                                .element_size()}
    return out


# ---------------------------------------------------------------------------
# The recurrent and enc-dec families on a mesh
# ---------------------------------------------------------------------------

FAMILIES = {"mamba2": "mamba2-1.3b", "hybrid": "recurrentgemma-9b",
            "whisper": "whisper-medium"}
FAM_B, FAM_STEPS = 2, 4
# prompt lengths: mamba2's spans two SSD chunks of 16 (padded), the
# hybrid's passes the reduced window of 32 (the ring wraps at prefill and
# again while decoding)
FAM_S = {"mamba2": 20, "hybrid": 36, "whisper": 8}
CHUNK, CHUNK_PROMPT = 4, 10
EXECUTORS = ("operator_centric", "sub_operator", "sub_operator+seqkv")
# mamba2 through the engine on (1, 2): (new tokens, arrival step, prompt
# length) per request, as tests/test_torch_ssm.py serves them
ENGINE_CASES = {
    "t4_chunk4": ([(9, 0, 6), (13, 0, 11), (5, 2, 8), (9, 6, 3)],
                  dict(block_size=4, prefill_chunk=4)),
    "t1_mono": ([(9, 0, 8), (13, 0, 8), (5, 2, 8), (9, 6, 8)],
                dict(block_size=1)),
}


def fam_cfg(name: str):
    return get_config(FAMILIES[name]).reduced().replace(dtype="float32")


def _rows(t: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """A tensor of this data row's batch rows (at ``dim``) gathered over
    the batch axes."""
    if ctx.n(ctx.batch_axes) == 1:
        return t
    return C.all_gather(t, ctx.mesh, ctx.batch_axes, dim, "check")


def _state(name, cfg, caches, ctx):
    """The whole recurrent state (h, conv) from every rank's part."""
    from repro_torch.kv import state as S
    from repro_torch.models import rglru, ssm
    if name == "mamba2":
        st = S.ssd_state_gather(caches, ctx, cfg.ssm.d_inner(cfg.d_model),
                                ssm.mesh_cut(cfg, ctx))
    elif name == "hybrid":
        st = S.rglru_state_gather(caches["state"], ctx,
                                  rglru.mesh_cut(cfg, ctx))
    else:
        return None
    return st.h.clone(), st.conv.clone()


def family_run(mesh, name, tree, toks, frames, executor):
    """Prefill of FAM_S[name] tokens (whisper with its frames), then
    teacher-forced decode of the rest under ``executor``: per step the
    whole logits of every row, and the whole state after prefill and at
    the end; mamba2 also its chunk lane and a slotted step."""
    from repro_torch.core.execution import make_rules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    cfg = fam_cfg(name)
    ctx = ShardingCtx(mesh, make_rules(executor, mesh))
    api = build_model(cfg, "cpu", ctx)
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    S = FAM_S[name]
    t = ctx.batch_local(torch.from_numpy(toks))
    extra = (ctx.batch_local(torch.from_numpy(frames)),) \
        if name == "whisper" else ()
    C.meter(mesh).reset()
    caches, lg = api.prefill(params, t[:, :S], *extra)
    logits = [api.full_logits(lg[:, -1])]
    states = [_state(name, cfg, caches, ctx)]
    for i in range(S, toks.shape[1]):
        caches, lg = api.decode(params, caches, t[:, i].to(torch.int32))
        logits.append(api.full_logits(lg[:, -1]))
    states.append(_state(name, cfg, caches, ctx))
    out = {"logits": _rows(torch.stack(logits), ctx, 1),
           "states": states, "bytes": C.meter(mesh).total()}
    if name == "mamba2":
        out["chunk"] = mamba2_chunk(api, params, ctx, cfg, toks[1])
    return out


def mamba2_chunk(api, params, ctx, cfg, prompt):
    """Slot 1 of a zero state of FAM_B slots admitted through the chunk
    lane (CHUNK_PROMPT tokens of ``prompt`` in chunks of CHUNK, the last
    one partial) on its data row, then one slotted step of every row with
    only slot 1 live: the chunks' logits (the owner row's ranks), the
    step's logits and the whole state."""
    state = api.init_caches(FAM_B, 64)
    rows = ctx.n(ctx.batch_axes) if ctx.active else 1
    per = FAM_B // rows
    row, local = divmod(1, per)
    mine = row == (ctx.index(ctx.batch_axes) if ctx.active else 0)
    chunks = []
    if mine:
        for start in range(0, CHUNK_PROMPT, CHUNK):
            valid = min(CHUNK, CHUNK_PROMPT - start)
            ch = torch.zeros((1, CHUNK), dtype=torch.long)
            ch[0, :valid] = torch.from_numpy(
                prompt[start:start + valid].astype(np.int64))
            state, lg = api.prefill_chunk(params, state, ch, local, start,
                                          valid)
            chunks.append(api.full_logits(lg[:, -1]))
    tok = ctx.batch_local(torch.tensor([0, int(prompt[CHUNK_PROMPT])],
                                       dtype=torch.int32))
    pos = ctx.batch_local(torch.tensor([0, CHUNK_PROMPT],
                                       dtype=torch.int32))
    act = ctx.batch_local(torch.tensor([False, True]))
    state, lg = api.decode_slotted(params, state, tok, pos, act)
    return {"chunks": chunks, "mine": mine,
            "step": _rows(api.full_logits(lg[:, 0]), ctx, 0),
            "state": _state("mamba2", cfg, state, ctx)}


def engine_mamba2(mesh, tree, case):
    """mamba2 through the engine on this mesh (sub_operator rules):
    (token streams, host syncs, stats of the run)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    from repro_torch.runtime.serving import Request, ServingEngine
    plan, kw = ENGINE_CASES[case]
    cfg = fam_cfg("mamba2")
    ctx = ShardingCtx(mesh, sub_operator())
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, p,
                                               dtype=np.int32),
                    max_new_tokens=n, arrival_step=a)
            for i, (n, a, p) in enumerate(plan)]
    eng = ServingEngine(build_model(cfg, "cpu"), 2, 8, device="cpu",
                        ctx=ctx, max_new_cap=32, **kw)
    st = eng.run(params, reqs, max_steps=400)
    keys = ("mode", "completed", "decode_steps", "macro_steps",
            "decode_tokens", "admissions", "prefill_chunks")
    return ([r.generated for r in reqs], eng.host_syncs,
            {k: st[k] for k in keys},
            {k: v["calls"] for k, v in st["runtime"].items()}, st["mesh"])


def make_step_run(mesh, name, tree, toks, frames, executor):
    """The family through ``make_step``'s prefill (whisper's frames beside
    the tokens) and decode bundles with their default int8 KV (the
    reference's serving default), against the port's one-device model of
    the same int8-KV config: (per step max |dlogit| / max|logit| of this
    rank's rows, greedy tokens equal)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    cfg = fam_cfg(name)
    S = FAM_S[name]
    pre = make_step(cfg, ShapeConfig("p", S, FAM_B, "prefill"), mesh,
                    executor)
    dec = make_step(cfg, ShapeConfig("d", S, FAM_B, "decode"), mesh,
                    executor)
    full = params_from_numpy(tree, cfg.replace(kv_dtype="int8"), "cpu")
    params = shard_params(full, pre.ctx)
    t = torch.from_numpy(toks)
    extra = (torch.from_numpy(frames),) if name == "whisper" else ()
    one = build_model(cfg.replace(kv_dtype="int8"), "cpu")
    lo, hi = pre.ctx.batch_rows(FAM_B)
    cache, lg = pre.fn(params, t[:, :S], *extra)
    c1, l1 = one.prefill(full, t[:, :S], *extra)
    got, want = [pre.api.full_logits(lg[:, -1])], [l1[lo:hi, -1]]
    for i in range(S, toks.shape[1]):
        cache, lg = dec.fn(params, cache, t[:, i].to(torch.int32))
        c1, l1 = one.decode(full, c1, t[:, i].to(torch.int32))
        got.append(pre.api.full_logits(lg[:, -1]))
        want.append(l1[lo:hi, -1])
    got, want = torch.stack(got), torch.stack(want)
    rel = ((got - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2))).tolist()
    return rel, bool(torch.equal(got.argmax(-1), want.argmax(-1)))


def families_rank(mesh, trees, toks, frames, engine: bool):
    """Every family under every executor on this mesh, and through
    ``make_step`` under the sub-operator tables; with ``engine``, mamba2
    through the engine on each ENGINE_CASES plan."""
    out = {"coords": mesh.coords}
    for name in FAMILIES:
        for ex in EXECUTORS:
            out[(name, ex)] = family_run(mesh, name, trees[name],
                                         toks[name], frames, ex)
        for ex in EXECUTORS[1:]:
            out[("make_step", name, ex)] = make_step_run(
                mesh, name, trees[name], toks[name], frames, ex)
    if engine:
        out["engine"] = {case: engine_mamba2(mesh, trees["mamba2"], case)
                         for case in ENGINE_CASES}
    return out


def spin_forever(mesh):
    """A rank that keeps computing and never returns (the launcher's
    wall-clock ceiling must stop it)."""
    x = 0
    while True:
        x = (x + mesh.rank + 1) % 1_000_003


# ---------------------------------------------------------------------------
# Drain mode on a mesh
# ---------------------------------------------------------------------------

DRAIN_ARCHS = {"qwen2": ("qwen2-0.5b", "drain"),
               "hybrid": ("recurrentgemma-9b", "auto"),
               "mamba2": ("mamba2-1.3b", "drain")}
DRAIN_SLOTS = 2
# (new tokens, arrival step, prompt length) per request: the second wave
# is admitted only once the first has drained; the hybrid's prompts pass
# the reduced window of 32 (the ring rolls at prefill)
DRAIN_PLAN = [(6, 0, 7), (9, 0, 5), (4, 2, 6), (7, 3, 8)]
DRAIN_PROMPT = {"qwen2": 8, "hybrid": 36, "mamba2": 8}
DRAIN_KEYS = ("mode", "completed", "decode_steps", "macro_steps",
              "decode_tokens", "admissions")


def drain_requests(cfg, name, request_cls):
    """The plan's requests (prompts from a seeded generator; the hybrid's
    28 tokens longer), built with the engine's ``Request`` class."""
    rng = np.random.default_rng(5)
    extra = DRAIN_PROMPT[name] - 8
    return [request_cls(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, p + extra, dtype=np.int32),
                max_new_tokens=n, arrival_step=a)
            for i, (n, a, p) in enumerate(DRAIN_PLAN)]


def engine_drain(mesh, name, tree, executor):
    """``name`` through the engine in drain mode (``auto`` for the
    hybrid) on this mesh under ``executor``: (token streams, host syncs,
    stats, program calls, the mesh's stats)."""
    from repro_torch.core.execution import make_rules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.runtime.serving import Request, ServingEngine
    arch, mode = DRAIN_ARCHS[name]
    cfg = get_config(arch).reduced().replace(dtype="float32")
    ctx = ShardingCtx(mesh, make_rules(executor, mesh))
    params = shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)
    reqs = drain_requests(cfg, name, Request)
    eng = ServingEngine(build_model(cfg, "cpu"), DRAIN_SLOTS,
                        DRAIN_PROMPT[name], device="cpu", ctx=ctx,
                        max_new_cap=32, mode=mode)
    st = eng.run(params, reqs, max_steps=400)
    return ([r.generated for r in reqs], eng.host_syncs,
            {k: st[k] for k in DRAIN_KEYS},
            {k: v["calls"] for k, v in st["runtime"].items()}, st["mesh"])


def drain_rank(mesh, trees, executors):
    """Every DRAIN_ARCHS entry through the drain engine under each of
    ``executors`` on this mesh."""
    return {(name, ex): engine_drain(mesh, name, trees[name], ex)
            for name in DRAIN_ARCHS for ex in executors}
