"""Seeded chaos schedules through the port's fault harness
(``repro_torch.runtime.faults``), against the JAX engine, on one fake
clock.

- the plan, its requests and the injector's draws equal the reference's
  for a seed (the same numpy streams);
- for seeds 1, 3, 4, 7 and 16 (between them retries, watchdog stalls, a
  preemption and restore, a shed deadline), ``run_chaos`` on the port and
  on the JAX engine give equal reports, and both the clean and the chaos
  run give equal statuses, reject reasons, token streams, counters (preemptions,
  restores, retries, watchdog timeouts, quarantined slots, rejections,
  deadline misses, host syncs) and per-program calls;
- 20 seeds on the port alone pass ``check_invariants``, and every request
  is terminally accounted.

The clock (``test_torch_failure.clock``) moves ``TICK_S`` per dispatch, so
deadlines (50-500 ms in a plan), the watchdog and the retry backoff
decide the same way on both sides and in every run.
"""
import pytest

torch = pytest.importorskip("torch")

import repro.runtime.faults as jfaults                       # noqa: E402
import repro_torch.runtime.faults as tfaults                 # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.runtime.serving import ServingEngine        # noqa: E402
from test_torch_failure import (TICK_S, assert_same_stats,   # noqa: E402
                                make_models, outcomes, program_calls)
from test_torch_failure import clock, one_thread             # noqa: E402,F401,F811

PROMPT_LEN = 8
PARITY_SEEDS = [1, 3, 4, 7, 16]
PORT_SEEDS = list(range(20))
# the reference's chaos engine (tests/test_chaos.py), with the watchdog
# set between one dispatch and one dispatch plus the longest injected
# stall, and a backoff, so both read the clock
ENGINE = dict(mode="continuous", block_size=8, prefill_chunk=4,
              preemptible=True, max_queue=16, max_retries=2,
              strict_invariants=True, watchdog_s=TICK_S + 5e-4,
              retry_backoff_s=TICK_S)

@pytest.fixture(scope="module")
def models():
    cfg, japi, jparams, tapi, tparams = make_models()
    jeng = JaxEngine(japi, NULL_CTX, 3, PROMPT_LEN, **ENGINE)
    teng = ServingEngine(tapi, 3, PROMPT_LEN, device="cpu", **ENGINE)
    return cfg, jeng, jparams, teng, tparams


def recorded(monkeypatch, engine):
    """Keep (requests, stats, program calls before the run) of every
    ``run()`` of ``engine``."""
    runs = []
    inner = engine.run

    def run(params, reqs, **kw):
        calls0 = program_calls(engine.rt)
        stats = inner(params, reqs, **kw)
        runs.append((reqs, stats, calls0))
        return stats

    monkeypatch.setattr(engine, "run", run)
    return runs


def _plan_requests(mod, cfg, seed):
    plan = mod.FaultPlan.generate(seed)
    return plan, plan.requests(cfg.vocab_size, prompt_lo=4,
                               prompt_hi=PROMPT_LEN + 8)


@pytest.mark.parametrize("seed", [3, 16])
def test_plan_and_injector_streams_match_reference(models, seed):
    cfg = models[0]
    (jplan, jreqs), (tplan, treqs) = (_plan_requests(m, cfg, seed)
                                      for m in (jfaults, tfaults))
    assert jplan.__dict__ == tplan.__dict__

    def fields(rs):
        return [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_step,
                 r.priority, r.ttft_deadline_ms) for r in rs]
    assert fields(treqs) == fields(jreqs)
    draws = []
    for mod, plan in ((jfaults, jplan), (tfaults, tplan)):
        inj = mod.FaultInjector(plan)
        seq = []
        for i in range(200):
            try:
                inj.on_dispatch(f"serve_x_{i}")
                seq.append(0)
            except RuntimeError:
                seq.append(1)
        draws.append((seq, [inj.slots_held(s) for s in range(80)],
                      inj.injected_failures))
    assert draws[0] == draws[1]


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_chaos_schedule_matches_reference(models, clock, monkeypatch, seed):
    cfg, jeng, jparams, teng, tparams = models
    reports, runs = [], []
    for mod, eng, params in ((jfaults, jeng, jparams),
                             (tfaults, teng, tparams)):
        plan, reqs = _plan_requests(mod, cfg, seed)
        runs.append(recorded(monkeypatch, eng))
        clock.restart()
        reports.append(mod.run_chaos(eng, params, plan, reqs))
    jrep, trep = reports
    assert trep == jrep
    assert trep["violations"] == []
    for (jreqs, jstats, j0), (treqs, tstats, t0) in zip(*runs):  # clean,
        assert outcomes(treqs) == outcomes(jreqs)               # chaos
        assert_same_stats(jstats, tstats, j0, t0)


@pytest.mark.parametrize("seed", PORT_SEEDS)
def test_chaos_schedule_port_invariants(models, clock, seed):
    cfg, _, _, teng, tparams = models
    plan, reqs = _plan_requests(tfaults, cfg, seed)
    clock.restart()
    rep = tfaults.run_chaos(teng, tparams, plan, reqs)
    assert rep["violations"] == [], f"seed {seed}: {rep['violations']}"
    assert rep["completed"] + rep["rejections"] + rep["deadline_misses"] \
        == plan.n_requests
    assert all(r["compiles"] == 1 for r in teng.rt.stats().values())
