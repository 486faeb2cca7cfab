"""How close the reference's chaos schedules run to their TTFT deadlines on
the wall clock, on this host's CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chaos_deadline_margin.py \
        --backend colocated --seeds 16 [--repeats 3]

Builds the engine of ``tests/test_chaos.py`` (reduced f32 qwen2-0.5b, 3
slots, T=8, chunk 4, preemptible, bounded queue, retries) and serves the
CLEAN run that ``run_chaos`` makes first for each seed, ``--repeats`` times
in one process. For every request that carries a TTFT deadline it prints
the wall time it waited in the queue before admission, beside the plan's
deadline and their ratio. ``_shed_deadlines`` sheds a queued request whose
wait passes its deadline, and ``run_chaos`` then raises "clean run
incomplete": the ratio is how much slower the host may get before that
happens. The first repeat includes the programs' compilation, which
happens inside the first run of an engine.
"""
from __future__ import annotations

import argparse
import time

import jax

from repro.configs.registry import ASSIGNED
from repro.models import NULL_CTX, build_model
from repro.runtime.faults import FaultPlan, clone_requests
from repro.runtime.serving import ServingEngine

PROMPT_LEN = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="colocated",
                    choices=["colocated", "wa"])
    ap.add_argument("--seeds", default="16",
                    help="comma-separated FaultPlan seeds")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = ASSIGNED["qwen2-0.5b"].reduced().replace(dtype="float32")
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    eng = ServingEngine(api, NULL_CTX, 3, PROMPT_LEN, mode="continuous",
                        block_size=8, prefill_chunk=4, preemptible=True,
                        max_queue=16, max_retries=2, strict_invariants=True,
                        backend=args.backend)
    for rep in range(args.repeats):
        for seed in (int(s) for s in args.seeds.split(",")):
            plan = FaultPlan.generate(seed)
            reqs = clone_requests(plan.requests(
                cfg.vocab_size, prompt_lo=4, prompt_hi=PROMPT_LEN + 8))
            t0 = time.perf_counter()
            eng.run(params, reqs, max_steps=20_000)
            wall = (time.perf_counter() - t0) * 1e3
            # a shed request was never admitted: its wait passed the deadline
            waits = [(r.rid, (r.t_admitted - r.t_enqueue) * 1e3
                      if r.t_admitted else float("nan"), r.status)
                     for r in reqs if r.ttft_deadline_ms > 0]
            admitted = [w for _, w, s in waits if s == "completed"]
            if len(admitted) < len(waits):
                verdict = "shed: the clean run is incomplete"
            elif admitted and max(admitted) > 0:
                verdict = ("deadline / worst wait "
                           f"{plan.ttft_deadline_ms / max(admitted):.2f}")
            else:
                verdict = "no wait"
            print(f"{args.backend} seed {seed} repeat {rep}: run "
                  f"{wall:.1f} ms, deadline {plan.ttft_deadline_ms:.1f} ms, "
                  "queue waits "
                  + ", ".join(f"rid {i} {w:.1f} ms {s}" for i, w, s in waits)
                  + f"; {verdict}", flush=True)


if __name__ == "__main__":
    main()
