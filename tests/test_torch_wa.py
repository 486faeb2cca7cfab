"""The weight–attention (WA) backend of the port against the JAX reference,
in float32 (reduced qwen2, the JAX parameters through
``repro_torch.interop``).

- schedule: ``skewed_schedule``, ``wa_schedule_occupancy``,
  ``micro_batch_slices``, ``routing_bytes`` and the scheduler's
  ``micro_batch_view`` give the reference's output, errors included;
- model: ``WADisaggregated.prefill_chunk``, ``decode_step_slotted`` and
  ``decode_block`` at overlap 1, 2 and 4 over flat f32 and int8 KV,
  a_shards 1 and 2 and a tiered int4-cold cache, against the reference's
  (jitted): tokens equal at every step, logits within 1e-4 of
  max|logit| until a stored int8/int4 step differs (counted exactly), then
  2e-2 (the rule of ``test_torch_model.py``);
- engine: with the staggered plan of ``tests/test_wa_overlap.py`` on 4
  slots, dense and int8 KV x T in {1, 8} x overlap in {1, 2, 4}, plus
  a_shards 2 (int8 KV, T = 8), monolithic admission (f32 and int8 KV)
  and a tiered int4 cache at overlap 2,
  the port's WA engine gives the JAX WA engine's token streams, host syncs,
  per-program calls, program names, ``overlap`` meta and
  ``stats()["wa"]`` byte and schedule fields, and its streams equal the
  port's colocated engine's; preempt-then-restore at overlap 2 and two
  seeded chaos schedules (on the fake clock of ``test_torch_failure.py``)
  match the JAX WA engine;
- validation: the reference's errors for overlap without WA, slots that
  do not divide, WA with drain, and ``routing="device_put"`` (which names
  the multi-device slice).

Every distinct serve runs once per module (``_serve``).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.core.pipeline as jpipe                          # noqa: E402
import repro.core.wa as jwa                                  # noqa: E402
import repro.runtime.faults as jfaults                       # noqa: E402
import repro_torch.core.pipeline as tpipe                    # noqa: E402
import repro_torch.core.wa as twa                            # noqa: E402
import repro_torch.runtime.faults as tfaults                 # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.serving import SlotScheduler as JaxScheduler  # noqa: E402
from repro_torch.quant import int4 as tint4                  # noqa: E402
from repro_torch.runtime.serving import (Request,            # noqa: E402
                                         ServingEngine, SlotScheduler)
from test_torch_failure import (TICK_S, assert_same_stats,  # noqa: E402
                                make_models, outcomes, program_calls)
from test_torch_failure import clock                         # noqa: E402,F401

torch.set_num_threads(2)

PROMPT_LEN = 8
SLOTS = 4                     # divides by every overlap depth tested
CAP = 24                      # KV extent 32: buckets 16 and 32 at T=8
# the staggered plan of tests/test_wa_overlap.py: mid-serve admissions and
# retirements, so micro-batches see mixed active masks
PLAN = [(9, 0), (13, 0), (5, 2), (9, 6), (7, 9), (6, 12)]
HOT, BLOCK = 4, 4             # tiered cache: ring of 8, boundary every 4
KINDS = {"f32": {}, "int8": dict(kv_dtype="int8"),
         "int4": dict(hot_window=HOT, kv_cold_dtype="int4",
                      kv_cold_block=BLOCK)}
LOGIT_RTOL = 1e-4
FLIP_RTOL = 2e-2              # once a stored int8/int4 step differs


@pytest.fixture(scope="module")
def models():
    """``models(kind)`` -> (jcfg, japi, jparams, tapi, tparams) on the same
    seeded weights, built once per kind."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = make_models(**KINDS[kind])
        return built[kind]

    return get


# ---------------------------------------------------------------------------
# schedule arithmetic
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("n_ops,depth", [(1, 1), (7, 1), (7, 2), (7, 4),
                                         (9, 3), (49, 4), (0, 2), (3, 0)])
def test_skewed_schedule_matches_reference(n_ops, depth):
    assert _outcome(tpipe.skewed_schedule, n_ops, depth) == \
        _outcome(jpipe.skewed_schedule, n_ops, depth)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
def test_wa_schedule_occupancy_matches_reference(depth):
    for L in (1, 2, 3, 24):
        assert tpipe.wa_schedule_occupancy(L, depth) == \
            jpipe.wa_schedule_occupancy(L, depth)


@pytest.mark.parametrize("batch,depth", [(4, 1), (4, 2), (4, 4), (8, 2),
                                         (2, 2), (4, 3), (4, 0)])
def test_micro_batch_slices_match_reference(batch, depth):
    assert _outcome(twa.micro_batch_slices, batch, depth) == \
        _outcome(jwa.micro_batch_slices, batch, depth)


def test_routing_bytes_and_hop_names_match_reference(models):
    jcfg, _, _, tapi, _ = models("f32")
    for batch, el in ((1, 2), (4, 4), (8, 2)):
        assert twa.routing_bytes(tapi.config, batch, el) == \
            jwa.routing_bytes(jcfg, batch, el)
    assert (twa.WA_HOP_TO_A, twa.WA_HOP_TO_W) == (jwa.WA_HOP_TO_A,
                                                  jwa.WA_HOP_TO_W)


def test_scheduler_micro_batch_view_matches_reference():
    views = []
    for cls in (JaxScheduler, SlotScheduler):
        sched = cls(4, [], [])
        sched.phase = [sched.DECODE, sched.FREE, sched.DECODE, sched.DECODE]
        views.append([(slots, act.tolist()) for depth in (1, 2, 4)
                      for slots, act in sched.micro_batch_view(depth)]
                     + [(slots, act.tolist()) for slots, act in
                        sched.micro_batch_view(
                            2, np.array([False, False, True, False]))])
    assert views[0] == views[1]
    assert views[1][1:3] == [([0, 1], [True, False]), ([2, 3], [True, True])]


# ---------------------------------------------------------------------------
# model level: WADisaggregated against the reference's
# ---------------------------------------------------------------------------

def _flips(jc, tc) -> int:
    """Stored int8 bytes / int4 nibbles that differ between the caches
    (0 for float storage); each must be one step and rare."""
    if tc.k_scale is None:
        return 0
    n = 0
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        j = torch.from_numpy(np.array(j))
        if tc.cold_dtype == "int4" and tc.is_tiered:
            j, t = tint4.unpack_int4(j), tint4.unpack_int4(t)
        d = (t.to(torch.int32) - j.to(torch.int32)).abs()
        assert int(d.max()) <= 1
        n += int((d > 0).sum())
    assert n <= 1e-3 * 2 * tc.k.numel(), n
    return n


def _assert_close(got, want, jc, tc, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    rtol = LOGIT_RTOL if _flips(jc, tc) == 0 else FLIP_RTOL
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err)


MODEL_CASES = {
    # id: (kind, overlap, a_shards): every depth, cache kind and shard
    # count meets the others
    "f32-d1": ("f32", 1, 1),
    "f32-d4": ("f32", 4, 1),
    "int8-d2-shards2": ("int8", 2, 2),
    "int4tiered-d2": ("int4", 2, 1),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_programs_match_reference(models, case):
    """4 slots admitted by ``prefill_chunk`` (4-wide chunks of 11-, 6-, 8-
    and 3-token prompts), 3 ``decode_step_slotted`` steps at bucket 16
    with slot 3 inactive in the first, then one ``decode_block`` (T=4,
    bucket 24, slot 1 halting after 2 tokens), all in place on one cache
    per side: chunk and step logits, tokens, the block's outputs and the
    stored caches. The reference's programs run jitted, as its engine
    runs them."""
    kind, D, n = MODEL_CASES[case]
    jcfg, japi, jparams, tapi, tparams = models(kind)
    jw = jwa.WADisaggregated(jcfg, None, routing="sharding", a_shards=n,
                             overlap=D)
    j_chunk = jax.jit(jw.prefill_chunk)
    j_step = jax.jit(functools.partial(jw.decode_step_slotted, kv_bucket=16))
    j_block = jax.jit(lambda *xs: jw.decode_block(*xs, None, block_size=4,
                                                  kv_bucket=24))
    tw = twa.WADisaggregated(tapi.config, "cpu", a_shards=n, overlap=D)
    jc = japi.init_caches(SLOTS, 32)
    tc = tapi.init_caches(SLOTS, 32)
    rng = np.random.default_rng(5)
    lens = (11, 6, 8, 3)
    first = []
    for slot, plen in enumerate(lens):
        prompt = rng.integers(0, jcfg.vocab_size, plen, dtype=np.int32)
        for start in range(0, plen, 4):
            valid = min(4, plen - start)
            row = np.zeros((1, 4), np.int32)
            row[0, :valid] = prompt[start:start + valid]
            jc, jl = j_chunk(jparams, jc, jnp.asarray(row), jnp.asarray(slot),
                             jnp.asarray(start), jnp.asarray(valid))
            tc, tl = tw.prefill_chunk(tparams, tc, torch.from_numpy(row),
                                      slot, start, valid)
            _assert_close(tl, jl, jc, tc, ("chunk", slot, start))
        first.append(int(np.asarray(jl)[0, -1].argmax()))
    tok = np.array(first, np.int32)
    pos = np.array(lens, np.int32)
    for step in range(3):
        act = np.array([True, True, True, step > 0])
        jc, jl = j_step(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                        jnp.asarray(act))
        tc, tl = tw.decode_step_slotted(
            tparams, tc, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(act), kv_bucket=16)
        jl, tl = np.asarray(jl)[:, 0], tl[:, 0].numpy()
        _assert_close(tl[act], jl[act], jc, tc, ("step", step))
        nxt = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1)[act], nxt[act])
        tok = np.where(act, nxt, 0).astype(np.int32)
        pos = pos + act.astype(np.int32)
    args = (tok, pos, np.ones(SLOTS, bool), np.array([4, 2, 4, 4], np.int32),
            np.full((SLOTS,), -1, np.int32))
    jout = j_block(jparams, jc, *[jnp.asarray(a) for a in args])
    tout = tw.decode_block(tparams, tc, *[torch.from_numpy(a) for a in args],
                           block_size=4, kv_bucket=24)
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jc, tc = jout[0], tout[0]
    _flips(jc, tc)
    if tc.k_scale is None:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-4, atol=1e-5)
    if tc.is_tiered:
        for name in ("hot_k", "hot_v"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_depth_one_equals_colocated_bit_for_bit(models):
    """The WA step at depth 1 runs the colocated step's ops in its order:
    on the CPU its logits and cache bytes are the colocated ones exactly."""
    _, _, _, tapi, tparams = models("int8")
    tw = twa.WADisaggregated(tapi.config, "cpu")
    caches = []
    for step_fn in (tapi.decode_slotted, tw.decode_step_slotted):
        c = tapi.init_caches(SLOTS, 32)
        tok = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
        pos = torch.tensor([0, 2, 4, 6], dtype=torch.int32)
        act = torch.tensor([True, True, False, True])
        logits = []
        for _ in range(3):
            c, lg = step_fn(tparams, c, tok, pos, act, kv_bucket=16)
            logits.append(lg)
            tok, pos = lg[:, 0].argmax(-1).to(torch.int32), pos + 1
        caches.append((c, torch.stack(logits)))
    (c0, l0), (c1, l1) = caches
    assert torch.equal(l0, l1)
    for f in ("k", "v", "k_scale", "v_scale", "length"):
        assert torch.equal(getattr(c0, f), getattr(c1, f)), f


def test_shared_cursor_step_equals_colocated_drain_step(models):
    """``decode_step`` (every row at ``cache.length``) is the slotted step
    at one device cursor, as the colocated ``decode`` is: equal logits and
    bytes at depths 1 and 2."""
    _, _, _, tapi, tparams = models("f32")
    tok = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    out = {}
    for name, step in (("colocated", tapi.decode),
                       ("wa d1", twa.WADisaggregated(tapi.config,
                                                     "cpu").decode_step),
                       ("wa d2", twa.WADisaggregated(tapi.config, "cpu",
                                                     overlap=2).decode_step)):
        c = tapi.init_caches(SLOTS, 32)
        c.length = torch.tensor(5, dtype=torch.int32)
        t, logits = tok, []
        for _ in range(3):
            c, lg = step(tparams, c, t)
            logits.append(lg)
            t = lg[:, 0].argmax(-1).to(torch.int32)
        out[name] = (torch.stack(logits), c)
    ref_logits, ref_c = out["colocated"]
    assert int(ref_c.length) == 8
    for name in ("wa d1", "wa d2"):
        logits, c = out[name]
        torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
        assert torch.equal(c.k, ref_c.k) and torch.equal(c.length,
                                                         ref_c.length)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def _requests(cls, vocab, plan=PLAN, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                           dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr) in enumerate(plan)]


_SERVES = {}


def _serve(models, side, kind, T, chunk, overlap=1, a_shards=1,
           backend="wa"):
    """One serve of PLAN per distinct (side, cell), cached for the module:
    (requests, stats, engine)."""
    key = (side, kind, T, chunk, overlap, a_shards, backend)
    if key not in _SERVES:
        jcfg, japi, jparams, tapi, tparams = models(kind)
        kw = dict(mode="continuous", max_new_cap=CAP, block_size=T,
                  kv_bucket_chunk=16 if T > 1 else 0, prefill_chunk=chunk,
                  backend=backend, a_shards=a_shards, overlap=overlap)
        if side == "jax":
            reqs = _requests(JaxRequest, jcfg.vocab_size)
            eng = JaxEngine(japi, NULL_CTX, SLOTS, PROMPT_LEN, **kw)
            stats = eng.run(jparams, reqs, max_steps=400)
        else:
            reqs = _requests(Request, jcfg.vocab_size)
            eng = ServingEngine(tapi, SLOTS, PROMPT_LEN, device="cpu", **kw)
            stats = eng.run(tparams, reqs, max_steps=400)
        assert stats["completed"] == len(PLAN)
        _SERVES[key] = (reqs, stats, eng)
    return _SERVES[key]


def _streams(reqs):
    return {r.rid: list(r.generated) for r in reqs}


WA_EXACT = ("routing_bytes_per_token", "routing_total_bytes",
            "routing_bytes_per_decode_token", "overlap",
            "overlap_efficiency", "schedule_ticks", "w_busy_ticks",
            "a_busy_ticks", "micro_batch_occupancy")


def assert_wa_engines_agree(jout, tout):
    (jreqs, jstats, jeng), (treqs, tstats, teng) = jout, tout
    assert _streams(treqs) == _streams(jreqs)
    assert [r.admit_step for r in treqs] == [r.admit_step for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert teng.host_syncs == jeng.host_syncs
    for key in ("completed", "decode_steps", "macro_steps", "decode_tokens",
                "prefill_chunks", "prefill_mode", "admissions",
                "overlapped_admissions", "preemptions", "restores",
                "backend"):
        assert tstats[key] == jstats[key], key
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt)
    for prog in trt:
        assert trt[prog]["calls"] == jrt[prog]["calls"], prog
        assert trt[prog]["compiles"] == 1, prog
        assert trt[prog].get("overlap") == jrt[prog].get("overlap"), prog
    jwa_s, twa_s = jstats["wa"], tstats["wa"]
    assert set(twa_s) == set(jwa_s)
    for key in WA_EXACT:
        assert twa_s[key] == jwa_s[key], key
    for key in ("w_idle_ms_per_macro_step", "a_idle_ms_per_macro_step"):
        assert twa_s[key] >= 0.0, key


ENGINE_CELLS = {
    # id: (kind, T, prefill_chunk, overlap, a_shards)
    **{f"{kind}-t{T}-d{D}": (kind, T, 3, D, 1)
       for kind in ("f32", "int8") for T in (1, 8) for D in (1, 2, 4)},
    "int8-t8-d2-shards2": ("int8", 8, 3, 2, 2),
    "f32-t8-d2-mono": ("f32", 8, 0, 2, 1),
    "int8-t8-d2-mono": ("int8", 8, 0, 2, 1),
    "int4tiered-t8-d2": ("int4", 8, 4, 2, 1),
}


@pytest.mark.parametrize("cell", sorted(ENGINE_CELLS))
def test_engine_matches_reference(models, cell):
    kind, T, chunk, D, n = ENGINE_CELLS[cell]
    jout = _serve(models, "jax", kind, T, chunk, D, n)
    tout = _serve(models, "port", kind, T, chunk, D, n)
    assert_wa_engines_agree(jout, tout)
    stats = tout[1]
    want = {"serve_wa_prefill_chunk" if chunk else "serve_wa_admit"}
    assert want <= set(stats["runtime"])
    assert all(name.startswith("serve_wa_") for name in stats["runtime"])
    if kind == "int4":
        assert stats["tiered"] == jout[1]["tiered"]
        assert stats["tiered"]["demotions"] > 0


@pytest.mark.parametrize("cell", sorted(ENGINE_CELLS))
def test_wa_streams_equal_colocated(models, cell):
    kind, T, chunk, D, n = ENGINE_CELLS[cell]
    got = _serve(models, "port", kind, T, chunk, D, n)[0]
    ref = _serve(models, "port", kind, T, chunk, 1, n, backend="colocated")[0]
    assert _streams(got) == _streams(ref)


def test_engine_reuse_keeps_programs_and_meta(models):
    """A second run of the overlap-2 engine registers nothing new, serves
    the same streams and keeps the programs' ``overlap`` meta."""
    reqs, stats, eng = _serve(models, "port", "f32", 8, 3, 2, 1)
    again = _requests(Request, eng.api.config.vocab_size)
    stats2 = eng.run(models("f32")[4], again, max_steps=400)
    assert _streams(again) == _streams(reqs)
    assert set(stats2["runtime"]) == set(stats["runtime"])
    for name, rec in stats2["runtime"].items():
        assert rec["compiles"] == 1
        assert rec.get("overlap") == (2 if "decode" in name else None), name
    assert stats2["wa"]["routing_total_bytes"] == \
        stats["wa"]["routing_total_bytes"]


def _preempt_plan(cls, vocab, seed=3):
    rng = np.random.default_rng(seed)
    rs = [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                         dtype=np.int32),
              max_new_tokens=20, arrival_step=0, priority=0)
          for i in range(2)]
    rs.append(cls(rid=2, prompt=rng.integers(0, vocab, 6, dtype=np.int32),
                  max_new_tokens=6, arrival_step=8, priority=5))
    return rs


def test_overlap_preempt_restore_token_identical(models):
    """The reference's ``test_overlap_preempt_restore_token_identical``:
    preempt + restore at overlap 2 gives the uninterrupted streams and the
    JAX WA engine's serve of the same plan; the swap pair is
    ``serve_wa_swap_out`` / ``serve_wa_swap_in``, registered once."""
    jcfg, japi, jparams, tapi, tparams = models("f32")
    kw = dict(mode="continuous", max_new_cap=CAP, block_size=8,
              kv_bucket_chunk=16, prefill_chunk=4, backend="wa", overlap=2)
    base = _preempt_plan(Request, jcfg.vocab_size)
    ServingEngine(tapi, 4, PROMPT_LEN, device="cpu", **kw).run(
        tparams, base, max_steps=600)
    ref = _streams(base)
    assert all(ref.values())
    tout, jout = [], []
    for out, cls, eng_cls, api, params, extra in (
            (tout, Request, ServingEngine, tapi, tparams,
             dict(device="cpu")),
            (jout, JaxRequest, JaxEngine, japi, jparams, {})):
        reqs = _preempt_plan(cls, jcfg.vocab_size)
        args = (api, 2, PROMPT_LEN) if eng_cls is ServingEngine else \
            (api, NULL_CTX, 2, PROMPT_LEN)
        eng = eng_cls(*args, preemptible=True, strict_invariants=True, **kw,
                      **extra)
        out.extend((reqs, eng.run(params, reqs, max_steps=600), eng))
    stats = tout[1]
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1
    assert _streams(tout[0]) == ref
    assert {"serve_wa_swap_out", "serve_wa_swap_in"} <= set(stats["runtime"])
    assert_wa_engines_agree(jout, tout)


# the chaos engine of tests/test_torch_chaos.py, through the WA backend at
# overlap 2 on 4 slots
CHAOS_ENGINE = dict(mode="continuous", block_size=8, prefill_chunk=4,
                    preemptible=True, max_queue=16, max_retries=2,
                    strict_invariants=True, backend="wa", overlap=2)


@pytest.fixture(scope="module")
def chaos_engines(models):
    kw = dict(CHAOS_ENGINE, watchdog_s=TICK_S + 5e-4, retry_backoff_s=TICK_S)
    jcfg, japi, jparams, tapi, tparams = models("f32")
    return (jcfg, JaxEngine(japi, NULL_CTX, SLOTS, PROMPT_LEN, **kw),
            jparams, ServingEngine(tapi, SLOTS, PROMPT_LEN, device="cpu",
                                   **kw), tparams)


@pytest.mark.parametrize("seed", [3, 4])
def test_wa_chaos_schedule_matches_reference(chaos_engines, clock,
                                             monkeypatch, seed):
    """``run_chaos`` (a clean run, then the plan's injected failures, KV
    pressure and stalls) through both WA engines on one fake clock: equal
    reports, statuses, reasons, streams, counters and per-program calls,
    and no invariant violation."""
    cfg, jeng, jparams, teng, tparams = chaos_engines
    reports, runs = [], []
    for mod, eng, params in ((jfaults, jeng, jparams),
                             (tfaults, teng, tparams)):
        plan = mod.FaultPlan.generate(seed)
        reqs = plan.requests(cfg.vocab_size, prompt_lo=4,
                             prompt_hi=PROMPT_LEN + 8)
        recorded = []
        inner = eng.run

        def run(p, rs, _inner=inner, _rec=recorded, _eng=eng, **kw):
            calls0 = program_calls(_eng.rt)
            stats = _inner(p, rs, **kw)
            _rec.append((rs, stats, calls0))
            return stats

        monkeypatch.setattr(eng, "run", run)
        runs.append(recorded)
        clock.restart()
        reports.append(mod.run_chaos(eng, params, plan, reqs))
    jrep, trep = reports
    assert trep == jrep
    assert trep["violations"] == []
    for (jreqs, jstats, j0), (treqs, tstats, t0) in zip(*runs):
        assert outcomes(treqs) == outcomes(jreqs)
        assert_same_stats(jstats, tstats, j0, t0)
        assert tstats["wa"]["overlap"] == 2


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

VALIDATION = {
    # id: (engine kwargs, slots, the error's words)
    "overlap_without_wa": (dict(backend="colocated", overlap=2), 4,
                           "no W↔A hops"),
    "slots_not_divisible": (dict(backend="wa", overlap=2), 3,
                            "does not divide"),
    "overlap_zero": (dict(backend="wa", overlap=0), 4, ">= 1"),
    "wa_with_drain": (dict(backend="wa", mode="drain"), 4,
                      "drain mode is colocated-only"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors_match_reference(models, case):
    _, japi, _, tapi, _ = models("f32")
    kw, slots, words = VALIDATION[case]
    with pytest.raises(ValueError, match=words) as jerr:
        JaxEngine(japi, NULL_CTX, slots, PROMPT_LEN, **kw)
    with pytest.raises(ValueError, match=words) as terr:
        ServingEngine(tapi, slots, PROMPT_LEN, device="cpu", **kw)
    assert str(terr.value).split("(")[0] == str(jerr.value).split("(")[0]


def test_wa_refuses_a_family_without_wa_support(models):
    _, _, _, tapi, _ = models("f32")
    with pytest.raises(ValueError, match="no WA-disaggregated serving"):
        ServingEngine(tapi._replace(wa_servable=False), SLOTS, PROMPT_LEN,
                      device="cpu", backend="wa")


def test_device_put_routing_names_the_multi_device_slice(models):
    jcfg, _, _, tapi, _ = models("f32")
    with pytest.raises(ValueError, match="multi-device slice"):
        twa.WADisaggregated(tapi.config, "cpu", routing="device_put")
    # overlap and split-KV with eager routing name 'sharding', as the
    # reference's errors do
    for kw in (dict(overlap=2), dict(a_shards=2)):
        with pytest.raises(ValueError, match="sharding"):
            jwa.WADisaggregated(jcfg, None, routing="device_put", **kw)
        with pytest.raises(ValueError, match="sharding"):
            twa.WADisaggregated(tapi.config, "cpu", routing="device_put",
                                **kw)
    for kw in (dict(overlap=0), dict(a_shards=0), dict(routing="mesh")):
        with pytest.raises(ValueError):
            twa.WADisaggregated(tapi.config, "cpu", **kw)
