"""Rank-side halves of ``test_torch_mesh_tiered.py`` and
``test_torch_mesh_preempt.py``: each function runs on every rank of a mesh
started by ``repro_torch.launch.mesh.launch`` and returns CPU results (numpy
arrays, lists, dicts) for the test process to hold against the reference.
This module imports no JAX; the weights arrive as the reference's numpy
trees.

Reduced qwen2-0.5b in float32 (3 layers, 4 query heads on 2 KV heads of
32): a tiered cache of hot window 4 and cold block 4 (a hot ring of 8, the
boundary every 4 tokens)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.execution import make_rules
from repro_torch.interop import params_from_numpy
from repro_torch.kv.cache import KVCache, export_slot_kv, import_slot_kv
from repro_torch.models.param_specs import shard_cache, shard_params
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import ShardingCtx
from repro_torch.runtime.faults import FaultPlan, run_chaos
from repro_torch.runtime.serving import KVArbiter, Request, ServingEngine

ARCH = "qwen2-0.5b"
HOT, BLOCK = 4, 4
PROMPT_LEN, CAP = 8, 24                 # the engines' KV extent: 32
EXECUTORS = {(1, 2): ("sub_operator", "operator_centric",
                      "sub_operator+seqkv"),
             (2, 1): ("sub_operator",)}
# the model-level cache run: two slots chunk-admitted (11 and 6 tokens, 4
# a chunk), then DECODE_STEPS teacher-forced decode steps over a cache of
# CACHE_S positions
CACHE_PROMPTS, CHUNK, DECODE_STEPS, CACHE_S = (11, 6), 4, 40, 64
ENGINE_KW = dict(mode="continuous", max_new_cap=CAP, block_size=8,
                 kv_bucket_chunk=16, prefill_chunk=4)
COLD_ENGINE_KEYS = ("completed", "decode_steps", "macro_steps",
                    "decode_tokens", "prefill_chunks", "prefill_mode",
                    "preemptions", "restores", "rejections")


def cfg_of(cold=None, **over):
    """The reduced config in f32; ``cold``: tiered at that cold dtype."""
    over = dict(dtype="float32", **over)
    if cold is not None:
        over.update(hot_window=HOT, kv_cold_dtype=cold, kv_cold_block=BLOCK)
    return get_config(ARCH).reduced().replace(**over)


def budget_of(cold: str, slots: int = 2) -> int:
    """Five hot tokens' worth of bytes: below two busy slots' occupancy
    for an int8 and an int4 cold tier, so the arbiter preempts (three
    times on the staggered plan)."""
    caches = build_model(cfg_of(cold), "cpu").init_caches(
        slots, PROMPT_LEN + CAP, device="meta")
    return KVArbiter(caches).hot_bytes_per_token * 5


# ---------------------------------------------------------------------------
# request plans (the same on both sides: ``cls`` is the engine's Request)
# ---------------------------------------------------------------------------

def plan_staggered(cls, vocab):
    """Staggered arrivals over 2 slots; the longest request crosses the
    cold boundary several times (``test_torch_tiered``'s plan)."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                            dtype=np.int32),
                max_new_tokens=n, arrival_step=4 * i)
            for i, n in enumerate((20, 12, 8))]


def plan_priority(cls, vocab):
    """Two low-priority decoders, then a priority-5 arrival at step 4: the
    most recently admitted decoder (slot 0) is swapped out, and restored
    into slot 1 when rid 0 finishes first (on (2, 1): another data
    row)."""
    rng = np.random.default_rng(3)
    rs = [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                         dtype=np.int32),
              max_new_tokens=n, arrival_step=0, priority=0)
          for i, n in enumerate((10, 20))]
    rs.append(cls(rid=2, prompt=rng.integers(0, vocab, 6, dtype=np.int32),
                  max_new_tokens=12, arrival_step=4, priority=5))
    return rs


PLANS = {"staggered": plan_staggered, "priority": plan_priority}

# engine cases: name -> (backend, cold dtype or None, plan, extra kwargs;
# "budget" in the kwargs is filled from ``budget_of``)
TIERED_CASES = {
    "int8": ("colocated", "int8", "staggered", {}),
    # monolithic tiered admission: the full-width chunk (``serve_admit``);
    # refused under +seqkv, where it is not run
    "int8_monolithic": ("colocated", "int8", "staggered",
                        dict(prefill_chunk=0)),
    "int4_budget": ("colocated", "int4", "staggered",
                    dict(preemptible=True, budget=True)),
}
PREEMPT_CASES = {
    "colocated_priority": ("colocated", "int8", "priority",
                           dict(preemptible=True, strict_invariants=True)),
    "colocated_budget": ("colocated", "int4", "staggered",
                         dict(preemptible=True, budget=True)),
    "wa_priority": ("wa", "int8", "priority",
                    dict(preemptible=True, strict_invariants=True)),
    "wa_budget": ("wa", "int4", "staggered",
                  dict(preemptible=True, budget=True)),
}
# the chaos engine (the reference's, tests/test_chaos.py) with no clock
# read: no watchdog, no backoff; the plan below injects failures only
CHAOS_ENGINE = dict(mode="continuous", block_size=8, prefill_chunk=4,
                    preemptible=True, max_queue=16, max_retries=2,
                    strict_invariants=True)
CHAOS_SLOTS, CHAOS_SEED = 4, 3


def chaos_plan(cls=FaultPlan, seed: int = CHAOS_SEED):
    """A seeded plan with dispatch failures and KV pressure but no
    slowdown and no deadline: nothing in it reads a clock."""
    return dataclasses.replace(cls.generate(seed), fail_rate=0.1,
                               slow_rate=0.0, slow_s=0.0, deadline_frac=0.0,
                               pressure_slots=2)


def runs_on(executor: str, name: str) -> bool:
    """Whether tiered case ``name`` serves under ``executor`` (monolithic
    admission under a sequence-cut cache stays refused on a mesh)."""
    return not (executor.endswith("+seqkv")
                and TIERED_CASES[name][3].get("prefill_chunk") == 0)


def engine_kwargs(case: dict, name: str):
    backend, cold, plan, extra = case[name]
    kw = dict(ENGINE_KW, backend=backend)
    extra = dict(extra)
    if extra.pop("budget", False):
        kw["kv_budget_bytes"] = budget_of(cold)
    kw.update(extra)
    return cold, plan, kw


# ---------------------------------------------------------------------------
# on the ranks
# ---------------------------------------------------------------------------

def _ctx(mesh, executor):
    return ShardingCtx(mesh, make_rules(executor, mesh))


def _params(tree, cfg, ctx):
    return shard_params(params_from_numpy(tree, cfg, "cpu"), ctx)


def _cache_np(c: KVCache):
    return {f: None if getattr(c, f) is None else getattr(c, f).numpy().copy()
            for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")}


def cache_run(mesh, tree, executor, cold, prompts, dec_toks):
    """Chunked admission of ``prompts`` (one per slot, CHUNK a chunk, on
    the slot's data row) and teacher-forced slotted decode of
    ``dec_toks`` (steps, 2) over a tiered cache of CACHE_S positions:
    (whole-vocabulary logits of each chunk's last valid position and of
    this rank's rows at each decode step, this rank's cache part, its
    seq_lo)."""
    cfg = cfg_of(cold)
    ctx = _ctx(mesh, executor)
    api = build_model(cfg, "cpu", ctx)
    params = _params(tree, cfg, ctx)
    cache = api.init_caches(2, CACHE_S)
    rows = ctx.n(ctx.batch_axes)
    local_slots = 2 // rows
    my_row = ctx.index(ctx.batch_axes)
    chunk_logits = {}
    for slot, p in enumerate(prompts):
        row, local = divmod(slot, local_slots)
        if row != my_row:
            continue
        for start in range(0, len(p), CHUNK):
            valid = min(CHUNK, len(p) - start)
            toks = np.zeros((1, CHUNK), np.int64)
            toks[0, :valid] = p[start:start + valid]
            cache, lg = api.prefill_chunk(params, cache,
                                          torch.from_numpy(toks), local,
                                          start, valid)
            chunk_logits[(slot, start)] = api.full_logits(lg[:, -1]).numpy()
    lo = my_row * local_slots
    pos = np.array([len(p) for p in prompts], np.int32)
    act = torch.ones(local_slots, dtype=torch.bool)
    dec_logits = []
    for step in range(dec_toks.shape[0]):
        sl = slice(lo, lo + local_slots)
        cache, lg = api.decode_slotted(
            params, cache, torch.from_numpy(dec_toks[step, sl].astype(
                np.int32)), torch.from_numpy(pos[sl] + step), act)
        dec_logits.append(api.full_logits(lg[:, 0]).numpy())
    return {"chunk_logits": chunk_logits, "dec_logits": np.stack(dec_logits),
            "cache": _cache_np(cache), "seq_lo": cache.seq_lo,
            "seq_axes": cache.seq_axes, "coords": dict(mesh.coords)}


def swap_pair(mesh, whole: dict, cold, executor, slot: int, valid_lens):
    """The swap pair on this rank's part of ``whole`` (a filled cache as
    numpy buffers; ``cold``: its cold dtype when tiered, else None): the
    part
    of slot ``slot`` that ``export_slot_kv`` exports on its data row, and
    for each valid_len, whether importing it into a zeroed part of the
    same layout gives the exported bytes below valid_len (global
    positions) and zeros elsewhere, and the full image's bytes for the
    ring."""
    ctx = _ctx(mesh, executor)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in whole.items()}
    B = t["k"].shape[1]
    full = KVCache(t["k"], t["v"], t["k_scale"], t["v_scale"],
                   torch.zeros((), dtype=torch.int32), hot_k=t["hot_k"],
                   hot_v=t["hot_v"], hot_window=HOT if cold else 0,
                   cold_block=BLOCK if cold else 0,
                   cold_dtype=cold or "bfloat16")
    part = shard_cache(full, ctx)
    rows = ctx.n(ctx.batch_axes)
    row, local = divmod(slot, B // rows)
    out = {"coords": dict(mesh.coords), "seq_lo": part.seq_lo,
           "owner": row == ctx.index(ctx.batch_axes)}
    if not out["owner"]:
        return out
    saved = export_slot_kv(part, local)
    out["export"] = [None if a is None else a.numpy().copy() for a in saved]
    imports = {}
    S_local = part.k.shape[3]
    for n in valid_lens:
        fresh = dataclasses.replace(part, **{
            f: None if getattr(part, f) is None
            else torch.zeros_like(getattr(part, f))
            for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")})
        fresh = import_slot_kv(fresh, saved, local, n)
        keep = int(np.clip(n - part.seq_lo, 0, S_local))
        ok = True
        for i, (a, b) in enumerate(zip(
                (fresh.k, fresh.v, fresh.k_scale, fresh.v_scale,
                 fresh.hot_k, fresh.hot_v), saved)):
            if a is None:
                continue
            got = a[:, local:local + 1]
            if i >= 4:
                ok &= torch.equal(got, b)
                continue
            ok &= torch.equal(got[:, :, :, :keep], b[:, :, :, :keep])
            ok &= not got[:, :, :, keep:].any()
            others = torch.cat([a[:, :local], a[:, local + 1:]], dim=1)
            ok &= not others.any()
        imports[n] = (bool(ok), int(fresh.length))
    out["imports"] = imports
    return out


def engine_run(mesh, tree, executor, cases: dict, name: str):
    """Serve case ``name`` of ``cases`` through the engine on this mesh:
    (streams, statuses, reject reasons, per-request preemptions, host
    syncs, stats subset, program calls, the arbiter's stats, mesh
    stats)."""
    cold, plan, kw = engine_kwargs(cases, name)
    cfg = cfg_of(cold)
    ctx = _ctx(mesh, executor)
    params = _params(tree, cfg, ctx)
    reqs = PLANS[plan](Request, cfg.vocab_size)
    eng = ServingEngine(build_model(cfg, "cpu"), 2, PROMPT_LEN,
                        device="cpu", ctx=ctx, **kw)
    st = eng.run(params, reqs, max_steps=1500)
    return engine_outcome(eng, st, reqs)


def engine_outcome(eng, st, reqs):
    return {"streams": [list(r.generated) for r in reqs],
            "statuses": [r.status for r in reqs],
            "reasons": [r.reject_reason for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "admit_steps": [r.admit_step for r in reqs],
            "host_syncs": eng.host_syncs,
            "stats": {k: st[k] for k in COLD_ENGINE_KEYS},
            "calls": {k: v["calls"] for k, v in st["runtime"].items()},
            "tiered": st.get("tiered"), "mesh": st.get("mesh")}


def chaos_run(mesh, tree, executor):
    """One seeded chaos schedule (``chaos_plan``) through ``run_chaos`` on
    a tiered int8 engine of CHAOS_SLOTS slots on this mesh: the report,
    the chaos run's outcomes and the injector's draws on this rank."""
    cfg = cfg_of("int8")
    ctx = _ctx(mesh, executor)
    params = _params(tree, cfg, ctx)
    plan = chaos_plan()
    reqs = plan.requests(cfg.vocab_size, prompt_lo=4,
                         prompt_hi=PROMPT_LEN + 8)
    eng = ServingEngine(build_model(cfg, "cpu"), CHAOS_SLOTS, PROMPT_LEN,
                        device="cpu", ctx=ctx, **CHAOS_ENGINE)
    runs = []
    inner = eng.run

    def run(p, rs, **kw):
        st = inner(p, rs, **kw)
        runs.append(engine_outcome(eng, st, rs))
        return st
    eng.run = run
    rep = run_chaos(eng, params, plan, reqs)
    return {"report": rep, "clean": runs[0], "chaos": runs[1]}


def refusals(mesh, executor):
    """The engine's refusals on this mesh: (kind, message) of each
    construction that raises."""
    ctx = _ctx(mesh, executor)
    out = {}
    dense = cfg_of("int8")

    def attempt(key, cfg, slots=2, **kw):
        try:
            ServingEngine(build_model(cfg, "cpu"), slots, PROMPT_LEN,
                          device="cpu", ctx=ctx, max_new_cap=CAP, **kw)
            out[key] = None
        except (NotImplementedError, ValueError) as e:
            out[key] = (type(e).__name__, str(e))
    attempt("overlap", dense, mode="continuous", block_size=4,
            prefill_chunk=4, backend="wa", overlap=2, preemptible=True)
    attempt("slots", dense, slots=3, mode="continuous", block_size=4,
            prefill_chunk=4, preemptible=True)
    moe = get_config("qwen3-moe-235b-a22b").reduced().replace(
        dtype="float32")
    attempt("moe", moe, mode="continuous", block_size=4, prefill_chunk=4)
    attempt("monolithic_seqkv", dense, mode="continuous", block_size=4,
            prefill_chunk=0, preemptible=True)
    # the families' own refusal, under rules that leave their admission
    # alone (under +seqkv mamba2's monolithic admission is refused first)
    ctx = _ctx(mesh, "sub_operator")
    for arch in ("recurrentgemma-9b", "mamba2-1.3b"):
        cfg = get_config(arch).reduced().replace(dtype="float32")
        attempt(arch, cfg, preemptible=True)
    return out


# ---------------------------------------------------------------------------
# What each test module's ranks run (one launch per mesh and module)
# ---------------------------------------------------------------------------

def tiered_rank(mesh, tree, prompts, dec_toks):
    shape = mesh.devices_shape
    out = {"coords": dict(mesh.coords), "cache": {}, "engine": {}}
    for ex in EXECUTORS[shape]:
        for cold in ("int8", "int4"):
            out["cache"][(ex, cold)] = cache_run(mesh, tree, ex, cold,
                                                 prompts, dec_toks)
        for name in TIERED_CASES:
            if not runs_on(ex, name):
                continue
            out["engine"][(ex, name)] = engine_run(mesh, tree, ex,
                                                   TIERED_CASES, name)
    return out


def preempt_rank(mesh, tree, wholes, slot, valid_lens):
    shape = mesh.devices_shape
    out = {"coords": dict(mesh.coords), "swap": {}, "engine": {}}
    for ex in EXECUTORS[shape]:
        for key, (whole, cold) in wholes.items():
            out["swap"][(ex, key)] = swap_pair(mesh, whole, cold, ex, slot,
                                               valid_lens)
    for name in PREEMPT_CASES:
        out["engine"][name] = engine_run(mesh, tree, "sub_operator",
                                         PREEMPT_CASES, name)
    out["chaos"] = chaos_run(mesh, tree, "sub_operator")
    if shape == (1, 2):
        out["refusals"] = refusals(mesh, "sub_operator+seqkv")
    else:
        out["refusals"] = refusals(mesh, "sub_operator")
    return out
