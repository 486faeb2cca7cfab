"""Deterministic fault-injection harness for the serving engine: the port
of ``repro.runtime.faults``.

A stalled dispatch or an overload burst must end in explicit, accounted
outcomes, never a hung engine or a corrupted token stream. This module
makes that testable:

- ``FaultPlan``: a frozen, seeded chaos schedule: dispatch failure and
  slowdown rates, a KV-pressure square wave, and a bursty heavy-tailed
  arrival workload. It draws from the same numpy streams as the
  reference, so one seed gives the same plan and requests on both sides.
- ``FaultInjector``: the live hook. ``on_dispatch(name)`` is installed as
  the ``StaticRuntime`` dispatch interceptor (raising ``DispatchError``
  before the step touches its operands, so a retry is safe);
  ``slots_held(step)`` models KV pressure, answered by preemption.
- ``check_invariants``: the post-run audit: terminal accounting,
  occupancy, emission-log contiguity (no duplicated, lost or reordered
  token), preemption/restore conservation, and token equality of every
  COMPLETED request with a clean run.
- ``run_chaos``: clean run, chaos run, audit, on one engine.

CLI (the card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels)::

    PYTHONPATH=src python -m repro_torch.runtime.faults --seeds 5 \
        [--device cpu]
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.runtime.serving import Request, ServingEngine
from repro_torch.runtime.static_runtime import DispatchError

TERMINAL = ("completed", "rejected", "deadline_missed")


# ---------------------------------------------------------------------------
# FaultPlan — the seeded schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultPlan:
    """One deterministic chaos schedule. Frozen: a plan is a VALUE — the
    injector and the workload generator derive everything from it and the
    seed, nothing mutates mid-run."""
    seed: int
    # dispatch faults (drawn per dispatch from the seeded stream)
    fail_rate: float = 0.0          # P(raise DispatchError)
    slow_rate: float = 0.0          # P(sleep slow_s before dispatching)
    slow_s: float = 0.0
    # artificial KV pressure: a square wave over boundary steps —
    # ``pressure_slots`` slots withheld for the duty fraction of each
    # period. Duty < 1 guarantees pressure always lifts (no livelock).
    pressure_slots: int = 0
    pressure_period: int = 0        # 0 → no pressure
    pressure_duty: float = 0.5
    # bursty arrival workload (heavy-tailed lengths)
    n_requests: int = 8
    burst_size: int = 3             # arrivals per burst
    burst_gap: int = 12             # boundary steps between bursts
    max_new_lo: int = 2
    max_new_hi: int = 16            # heavy tail: few long, many short
    deadline_frac: float = 0.0      # fraction of requests carrying a TTFT
    ttft_deadline_ms: float = 0.0   # deadline (tight → shed under slowness)

    @staticmethod
    def generate(seed: int, *, max_fail_rate: float = 0.12,
                 max_slow_rate: float = 0.1, max_pressure: int = 2,
                 n_requests: int = 8) -> "FaultPlan":
        """Randomize a plan FROM the seed (two seeds, two schedules) while
        keeping every knob inside the always-terminates envelope: bounded
        fail rate (retries + quarantine absorb it), pressure duty < 1."""
        rng = np.random.default_rng(seed)
        return FaultPlan(
            seed=seed,
            fail_rate=float(rng.uniform(0, max_fail_rate)),
            slow_rate=float(rng.uniform(0, max_slow_rate)),
            slow_s=float(rng.uniform(0, 0.002)),
            pressure_slots=int(rng.integers(0, max_pressure + 1)),
            pressure_period=int(rng.integers(8, 40)),
            pressure_duty=float(rng.uniform(0.25, 0.75)),
            n_requests=n_requests,
            burst_size=int(rng.integers(2, 5)),
            burst_gap=int(rng.integers(6, 24)),
            max_new_lo=2,
            max_new_hi=int(rng.integers(8, 20)),
            deadline_frac=float(rng.uniform(0, 0.5)),
            ttft_deadline_ms=float(rng.uniform(50, 500)),
        )

    def requests(self, vocab_size: int, prompt_lo: int, prompt_hi: int
                 ) -> List[Request]:
        """Seeded bursty open-loop workload: arrivals land in bursts of
        ``burst_size`` every ``burst_gap`` boundary steps; prompt and
        output lengths are heavy-tailed (mostly short, a fat tail of
        long) — the overload shape a production engine must degrade
        under, not the uniform trickle it is tuned on."""
        rng = np.random.default_rng(self.seed + 1)       # independent stream
        out: List[Request] = []
        for i in range(self.n_requests):
            burst, lane = divmod(i, self.burst_size)
            # Pareto-ish tail for lengths, clamped to the engine bounds
            plen = int(np.clip(prompt_lo + rng.pareto(2.0) * prompt_lo,
                               prompt_lo, prompt_hi))
            mnew = int(np.clip(self.max_new_lo + rng.pareto(1.5) * 2,
                               self.max_new_lo, self.max_new_hi))
            has_dl = rng.uniform() < self.deadline_frac
            out.append(Request(
                rid=i,
                prompt=rng.integers(0, vocab_size, plen, dtype=np.int32),
                max_new_tokens=mnew,
                arrival_step=burst * self.burst_gap,
                priority=int(rng.integers(0, 3)),
                ttft_deadline_ms=self.ttft_deadline_ms if has_dl else 0.0))
        return out


# ---------------------------------------------------------------------------
# FaultInjector — the live hook
# ---------------------------------------------------------------------------

class FaultInjector:
    """Consumes the plan's seeded random stream one draw per dispatch, so
    the injected fault sequence is a pure function of (plan, dispatch
    order) — and dispatch order is deterministic for a fixed engine
    config. Passed to ``ServingEngine(fault_injector=...)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed + 2)
        self.injected_failures = 0
        self.injected_slowdowns = 0
        self.dispatches = 0

    # -- StaticRuntime dispatch interceptor -----------------------------
    def on_dispatch(self, name: str):
        self.dispatches += 1
        u = float(self._rng.uniform())
        if u < self.plan.fail_rate:
            self.injected_failures += 1
            raise DispatchError(
                f"injected dispatch failure #{self.injected_failures} "
                f"for {name!r} (seed {self.plan.seed})")
        if u < self.plan.fail_rate + self.plan.slow_rate and self.plan.slow_s:
            self.injected_slowdowns += 1
            time.sleep(self.plan.slow_s)

    # -- artificial KV pressure -----------------------------------------
    def slots_held(self, step: int) -> int:
        p = self.plan
        if not p.pressure_period or not p.pressure_slots:
            return 0
        phase = (step % p.pressure_period) / p.pressure_period
        return p.pressure_slots if phase < p.pressure_duty else 0

    def counters(self) -> Dict[str, int]:
        return {"dispatches": self.dispatches,
                "injected_failures": self.injected_failures,
                "injected_slowdowns": self.injected_slowdowns}


# ---------------------------------------------------------------------------
# Invariant checker
# ---------------------------------------------------------------------------

def check_invariants(engine: ServingEngine, stats: Dict[str, Any],
                     requests: List[Request],
                     reference: Optional[Dict[int, List[int]]] = None
                     ) -> List[str]:
    """Audit one finished ``run()``. Returns violation strings (empty =
    green). ``reference`` maps rid → token list from a CLEAN run of the
    same workload on the same engine config; every request the chaos run
    COMPLETED must match it byte for byte (preemption/restore and victim
    shedding may change WHO finishes, never WHAT a finisher says)."""
    bad: List[str] = []

    # 1. terminal accounting: exactly one outcome per request
    terminal_rids = set()
    for r in requests:
        if r.status not in TERMINAL:
            bad.append(f"rid {r.rid}: non-terminal status {r.status!r}")
        if r.rid in terminal_rids:
            bad.append(f"rid {r.rid}: duplicated in request list")
        terminal_rids.add(r.rid)
        if r.swap is not None:
            bad.append(f"rid {r.rid}: terminal but still holds a swap "
                       "image")
    completed = {r.rid for r in requests if r.status == "completed"}
    stats_rids = {m["rid"] for m in stats["per_request"]}
    if completed != stats_rids:
        bad.append(f"completed set mismatch: requests say "
                   f"{sorted(completed)}, stats say {sorted(stats_rids)}")
    shed = {e["rid"] for e in stats.get("rejected", [])}
    want_shed = {r.rid for r in requests
                 if r.status in ("rejected", "deadline_missed")}
    if shed != want_shed:
        bad.append(f"shed set mismatch: requests say {sorted(want_shed)}, "
                   f"stats say {sorted(shed)}")

    # 2. emission log: per rid the token indices must be exactly
    #    0,1,2,...,n-1 IN ORDER — one line proves no token was
    #    duplicated, lost or reordered on its way to the host
    per_rid: Dict[int, List[int]] = {}
    for rid, idx in engine._emit_log:
        per_rid.setdefault(rid, []).append(idx)
    for r in requests:
        got = per_rid.get(r.rid, [])
        want = list(range(len(r.generated)))
        if got != want:
            bad.append(f"rid {r.rid}: emission log {got[:8]}... != "
                       f"contiguous 0..{len(r.generated) - 1}")

    # 3. occupancy at end of run: the scheduler must have drained (or the
    #    run hit max_steps — surfaced as non-terminal statuses above)
    sched = getattr(engine, "_sched", None)
    if sched is not None:
        bad.extend(sched.invariant_violations())
        for i in range(sched.n):
            if sched.phase[i] != sched.FREE and sched.req[i] is not None\
                    and sched.req[i].status in TERMINAL:
                bad.append(f"slot {i}: occupied by terminal rid "
                           f"{sched.req[i].rid}")

    # 4. conservation: restores never exceed preemptions; the difference
    #    is exactly the preempted-then-shed population
    if stats["restores"] > stats["preemptions"]:
        bad.append(f"restores {stats['restores']} > preemptions "
                   f"{stats['preemptions']}")

    # 5. token-byte equality of completed requests vs the clean run
    if reference is not None:
        for r in requests:
            if r.status != "completed":
                continue
            if reference.get(r.rid) != r.generated:
                bad.append(
                    f"rid {r.rid}: completed tokens diverge from the "
                    f"clean run ({r.generated[:6]}... vs "
                    f"{reference.get(r.rid, [])[:6]}...)")
    return bad


# ---------------------------------------------------------------------------
# run_chaos — clean run, chaos run, audit
# ---------------------------------------------------------------------------

def clone_requests(requests: List[Request]) -> List[Request]:
    """Fresh Request objects for a run (``run()`` mutates its requests):
    only the WORKLOAD fields carry over — status, stamps, generated
    tokens and swap images all restart from their defaults."""
    return [Request(rid=r.rid, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens,
                    arrival_step=r.arrival_step, eos_id=r.eos_id,
                    priority=r.priority,
                    ttft_deadline_ms=r.ttft_deadline_ms,
                    tpot_deadline_ms=r.tpot_deadline_ms)
            for r in requests]


def run_chaos(engine: ServingEngine, params, plan: FaultPlan,
              requests: List[Request], max_steps: int = 20_000
              ) -> Dict[str, Any]:
    """One seeded chaos schedule end to end on ``engine``:

    1. CLEAN reference run (injector cleared) → rid → tokens map,
    2. chaos run with ``FaultInjector(plan)`` installed,
    3. ``check_invariants`` over the chaos run against the reference.

    The same engine serves both (programs compile once); the injector is
    cleared afterwards so the engine is reusable. Returns a report dict —
    ``report["violations"] == []`` is the green condition. On a mesh every
    rank calls this with its own engine and an injector of the same plan:
    every rank dispatches every program in the same order, so the
    injector draws one stream on all of them, and each rank's report is
    the same."""
    clean = clone_requests(requests)
    engine.fault_injector = None
    clean_stats = engine.run(params, clean, max_steps=max_steps)
    reference = {r.rid: list(r.generated) for r in clean}
    if clean_stats["completed"] != len(clean):
        raise ValueError(
            f"clean run incomplete ({clean_stats['completed']}/"
            f"{len(clean)}): the workload must fit the engine before "
            "chaos means anything")

    inj = FaultInjector(plan)
    chaos = clone_requests(requests)
    engine.fault_injector = inj
    try:
        stats = engine.run(params, chaos, max_steps=max_steps)
    finally:
        engine.fault_injector = None
        engine.rt.set_interceptor(None)
    violations = check_invariants(engine, stats, chaos, reference)
    return {
        "seed": plan.seed,
        "violations": violations,
        "injected": inj.counters(),
        "completed": stats["completed"],
        "rejections": stats["rejections"],
        "deadline_misses": stats["deadline_misses"],
        "preemptions": stats["preemptions"],
        "restores": stats["restores"],
        "retries": stats["retries"],
        "quarantined_slots": stats["quarantined_slots"],
    }


# ---------------------------------------------------------------------------
# CLI smoke
# ---------------------------------------------------------------------------

def _main(argv=None):
    import argparse

    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("qwen2-0.5b").reduced()
    api = build_model(cfg, args.device)
    params = api.init(0)
    prompt_len = 8
    eng = ServingEngine(api, args.slots, prompt_len, mode="continuous",
                        block_size=args.block_size, prefill_chunk=4,
                        preemptible=True, max_queue=16, max_retries=2,
                        strict_invariants=True, device=api.device)
    red = 0
    for seed in range(args.seed0, args.seed0 + args.seeds):
        plan = FaultPlan.generate(seed)
        reqs = plan.requests(cfg.vocab_size, prompt_lo=4,
                             prompt_hi=prompt_len + 8)
        rep = run_chaos(eng, params, plan, reqs)
        status = "green" if not rep["violations"] else "RED"
        red += bool(rep["violations"])
        print(f"seed {seed:3d} {status:5s} completed={rep['completed']} "
              f"rej={rep['rejections']} miss={rep['deadline_misses']} "
              f"preempt={rep['preemptions']} restore={rep['restores']} "
              f"inj={rep['injected']['injected_failures']}")
        for v in rep["violations"]:
            print(f"         - {v}")
    print(f"{args.seeds - red}/{args.seeds} schedules green")
    return 1 if red else 0


if __name__ == "__main__":
    raise SystemExit(_main())
