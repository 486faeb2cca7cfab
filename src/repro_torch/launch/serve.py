"""Serving CLI of the port: continuous-batching (or drain-mode) decode on
one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --full-width --requests 12 --batch 8 --prompt-len 128 --max-new 32 \
        --arrival-every 4 --block-size 8 --kv-bucket-chunk 64 \
        --prefill-chunk 32 [--a-shards 4] [--preemptible] [--max-queue 6] \
        [--hot-window 64 --kv-cold-dtype int4 --kv-cold-block 16 \
         --kv-budget-bytes 7372800] [--backend wa --overlap 2]

``--arch`` takes every registered config (``configs/registry.py``: the
dense and MoE models, mamba2-1.3b (SSM), recurrentgemma-9b (hybrid),
internvl2-76b (VLM, served text-only with monolithic admission, as the
reference engine serves it) and the paper's Llama/Qwen deployments); the
default is the reference CLI's, internlm2-1.8b. ``--arch whisper-medium``
(enc-dec) prints the engine's refusal and exits with status 1: the
engine's prefill has no frames input.
``--mode`` is ``auto`` by default, as in the reference CLI: continuous
where the family has slotted decode (every family but the hybrid, which
``auto`` serves in drain mode). ``--mode drain`` serves the
drain-then-refill baseline (no chunk lane: ``--prefill-chunk`` is then
ignored, as in the reference CLI).
Runs on ``--device cuda`` by default (raises without a GPU); pass
``--device cpu`` for the plain PyTorch versions on the CPU. The config is
reduced unless ``--full-width`` is given, as in the reference CLI. Weights
are random, made from a fixed seed. ``--hot-window`` > 0 serves a tiered KV
cache (hot ring + cold tier at ``--kv-cold-dtype``). ``--backend wa``
serves through the weight-attention split (the KV side on its own CUDA
stream), ``--overlap D`` pipelines D micro-batches across it. Prints the
engine's stats, the tiered cache's ``tiered kv:`` and ``arbiter:`` lines,
the WA backend's ``wa routing:`` and ``wa overlap:`` lines, a per-request
table and the per-program call counts.

``--mesh DxM`` serves on a ("data", "model") mesh of D*M ranks, one
process each (``repro_torch.launch.mesh.launch``), under ``--executor``
(``sub_operator`` by default, ``operator_centric`` or
``sub_operator+seqkv``): every rank runs the same engine loop on its share
(its slots, heads, F columns and vocabulary rows), and rank 0 prints, with
a ``mesh:`` line of collective bytes per axis and site and the control
group's calls. With ``--device cuda`` each rank takes its own card
(nccl), and a machine with fewer cards than ranks raises unless
``--share-device`` asks for every rank on ``cuda:0`` over gloo (one H100:
``--mesh 1x2 --share-device``); ``--device cpu`` runs gloo ranks on the
CPU. Drain mode runs on a mesh too (``--mode drain``, and
``--arch recurrentgemma-9b``, whose ``auto`` is drain): each data row
prefills and decodes its block of the slots, and the host reads every
row's tokens in the one sync a step. A tiered, preemptible engine with a
KV budget serves on a mesh too (``--hot-window``, ``--kv-cold-dtype``,
``--kv-cold-block``, ``--preemptible``, ``--kv-budget-bytes``, under
every executor, ``--backend wa`` included): each rank holds its part of
the hot ring (its slots and KV heads) and of the cold tier (its slots and
KV heads, or under ``sub_operator+seqkv`` its block of positions), swaps
its part of a preempted slot, and the arbiter prices the whole cache, as
on one device. One H100:

    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 1x2 \
        --share-device --executor sub_operator+seqkv --arch qwen2-0.5b \
        --full-width --requests 12 --batch 8 --prompt-len 128 --max-new 32 \
        --arrival-every 4 --block-size 8 --kv-bucket-chunk 64 \
        --prefill-chunk 32 --hot-window 64 --kv-cold-dtype int4 \
        --kv-cold-block 16 --preemptible --kv-budget-bytes 1118208

(1,118,208 B is the arbiter's price of one slot at cursor 160 in bf16 at
24 layers. Unbudgeted, two decoding slots peak at 1,161,216 B, so this
budget binds: the plan preempts 12 times in a CPU run, the arbiter
pricing bytes, not values. Phase 4f's (z9) sets 1.06 such prices, which
binds at 2 layers in f32 but not here: the f32 hot ring weighs more
against the int4 cold tier.)
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.core.execution import EXECUTORS, make_rules
from repro_torch.models.param_specs import shard_params
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import ShardingCtx
from repro_torch.runtime.serving import Request, ServingEngine


def make_requests(cfg, n_requests: int, prompt_len: int, max_new: int,
                  seed: int = 0, arrival_every: int = 0):
    """Synthetic workload; request i arrives at step i*arrival_every."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=max_new,
                    arrival_step=i * arrival_every)
            for i in range(n_requests)]


def serve(arch: str, n_requests: int, batch_slots: int, prompt_len: int,
          max_new: int, *, reduced: bool = True, seed: int = 0,
          mode: str = "auto", arrival_every: int = 0,
          block_size: int = 1, kv_bucket_chunk: int = 0,
          prefill_chunk: int = 0, a_shards: int = 1,
          backend: str = "colocated", overlap: int = 1,
          preemptible: bool = False, max_queue: int = 0,
          hot_window: int = 0, kv_cold_dtype: str = "int8",
          kv_cold_block: int = 16, kv_budget_bytes: int = 0, device=None,
          mesh=None, executor: str = "sub_operator"):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if hot_window:
        # tiered KV cache: hot ring at the compute dtype, cold prefix
        # quantized, demoted in fixed blocks
        cfg = cfg.replace(hot_window=hot_window, kv_cold_dtype=kv_cold_dtype,
                          kv_cold_block=kv_cold_block)
    if mode == "drain" and prefill_chunk:
        print("note: --prefill-chunk ignored (drain mode has no chunk lane)")
        prefill_chunk = 0
    ctx = None
    api = build_model(cfg, device if mesh is None else mesh.device)
    params = api.init(seed)
    if mesh is not None:
        # this rank's share: the full seeded weights cut to its part
        ctx = ShardingCtx(mesh, make_rules(executor, mesh))
        params = shard_params(params, ctx)
    eng = ServingEngine(api, batch_slots, prompt_len, mode=mode,
                        block_size=block_size,
                        kv_bucket_chunk=kv_bucket_chunk,
                        prefill_chunk=prefill_chunk, a_shards=a_shards,
                        backend=backend, overlap=overlap,
                        preemptible=preemptible, max_queue=max_queue,
                        kv_budget_bytes=kv_budget_bytes, device=api.device,
                        ctx=ctx)
    reqs = make_requests(cfg, n_requests, prompt_len, max_new, seed,
                         arrival_every)
    return eng.run(params, reqs)


def _rank_serve(mesh, kwargs, executor):
    """One rank of ``--mesh``: the stats of its engine."""
    return serve(**kwargs, mesh=mesh, executor=executor)


def serve_on_mesh(shape, executor: str, kwargs: dict, device: str = "cuda",
                  share_device: bool = False):
    """Start the ranks of a ("data", "model") mesh of ``shape``, serve on
    each, and return rank 0's stats. ``share_device``: every rank on
    ``cuda:0`` over gloo; without it each rank needs a card of its own
    (``launch`` raises otherwise)."""
    from repro_torch.launch.mesh import launch
    res = launch(_rank_serve, shape, ("data", "model"), (kwargs, executor),
                 device=device, share_device=share_device,
                 timeout_s=3600).join()
    return res[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published widths (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "continuous", "drain"))
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="stagger: request i arrives at step i*N")
    ap.add_argument("--block-size", type=int, default=1,
                    help="decode micro-steps per host sync")
    ap.add_argument("--kv-bucket-chunk", type=int, default=0,
                    help="KV bucket granularity (block mode; 0 = full)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill lane width (0 = monolithic)")
    ap.add_argument("--a-shards", type=int, default=1,
                    help="split-KV decode: read each KV bucket as N equal "
                         "sequence shards merged by the LSE combine")
    ap.add_argument("--backend", default="colocated",
                    choices=("colocated", "wa"),
                    help="executor backend: colocated, or the weight-"
                         "attention split (QKV/FFN on the caller's CUDA "
                         "stream, KV and attention on a stream of its own)")
    ap.add_argument("--overlap", type=int, default=1,
                    help="micro-batch pipelining depth of the W/A boundary "
                         "(backend wa only; --batch must divide by it): W "
                         "runs QKV/FFN for one micro-batch while A attends "
                         "another, token-exact at every depth")
    ap.add_argument("--preemptible", action="store_true",
                    help="register the token-exact KV swap pair and allow "
                         "priority/pressure preemption at block boundaries")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded queue: shed the lowest-priority queued "
                         "work beyond N as structured rejections "
                         "(0 = unbounded)")
    ap.add_argument("--hot-window", type=int, default=0,
                    help="tiered KV cache: keep the most recent N tokens "
                         "per slot exact in a hot ring and demote older "
                         "ones to the quantized cold tier in fixed blocks, "
                         "inside the step programs (0 = flat cache)")
    ap.add_argument("--kv-cold-dtype", default="int8",
                    choices=("bfloat16", "int8", "int4"),
                    help="cold-tier storage dtype (int4 packs two values "
                         "a byte, one f32 scale a row)")
    ap.add_argument("--kv-cold-block", type=int, default=16,
                    help="demotion granularity: the cold boundary advances "
                         "in blocks of N tokens")
    ap.add_argument("--kv-budget-bytes", type=int, default=0,
                    help="tiered-KV arbiter byte budget: preempt victims "
                         "(with --preemptible) or hold admissions while the "
                         "occupancy-priced live KV bytes exceed N "
                         "(0 = unbounded)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a DxM (data x model) mesh of ranks, one "
                         "process each (e.g. 1x2)")
    ap.add_argument("--executor", default=None, choices=EXECUTORS,
                    help="the mesh's rules table (with --mesh; default "
                         "sub_operator)")
    ap.add_argument("--share-device", action="store_true",
                    help="with --mesh and --device cuda: put every rank on "
                         "cuda:0 over gloo (one card for all ranks); "
                         "without it each rank needs a card of its own")
    args = ap.parse_args(argv)
    if (args.executor or args.share_device) and not args.mesh:
        raise SystemExit("serve: --executor and --share-device need --mesh")
    kwargs = dict(arch=args.arch, n_requests=args.requests,
                  batch_slots=args.batch, prompt_len=args.prompt_len,
                  max_new=args.max_new, reduced=not args.full_width,
                  mode=args.mode, arrival_every=args.arrival_every,
                  block_size=args.block_size,
                  kv_bucket_chunk=args.kv_bucket_chunk,
                  prefill_chunk=args.prefill_chunk, a_shards=args.a_shards,
                  backend=args.backend, overlap=args.overlap,
                  preemptible=args.preemptible, max_queue=args.max_queue,
                  hot_window=args.hot_window,
                  kv_cold_dtype=args.kv_cold_dtype,
                  kv_cold_block=args.kv_cold_block,
                  kv_budget_bytes=args.kv_budget_bytes)
    try:
        if args.mesh:
            shape = tuple(int(n) for n in args.mesh.lower().split("x"))
            stats = serve_on_mesh(shape, args.executor or "sub_operator",
                                  kwargs, args.device, args.share_device)
        else:
            stats = serve(**kwargs, device=args.device)
    except ValueError as e:
        # a configuration the engine refuses (whisper-medium's family, an
        # option the family lacks): its message, and exit status 1
        raise SystemExit(f"serve: {e}")
    per_req = stats.pop("per_request")
    rt = stats.pop("runtime")
    rejected = stats.pop("rejected")
    tiered = stats.pop("tiered", None)
    wa = stats.pop("wa", None)
    mesh = stats.pop("mesh", None)
    print("serve stats:", stats)
    if mesh:
        # rank 0's collective bytes (ring algorithms: what it sends) and
        # the control group's CPU broadcasts and gathers (no device syncs)
        print(f"mesh: {mesh['shape']} rules={mesh['rules']} bytes/axis "
              f"{mesh['bytes_per_axis']} total {mesh['bytes_total']:.0f} B "
              f"in {mesh['calls']} collectives; control calls "
              f"{mesh['control_calls']} ({mesh['control_bytes']} B); "
              f"bytes/site {mesh['bytes_per_site']}")
    if tiered:
        # the KVArbiter's view: tier occupancy, in-program demotions
        # counted off cursor watermarks, bytes
        print(f"tiered kv:  hot_window={tiered['hot_window']} "
              f"cold={tiered['cold_dtype']}/block{tiered['cold_block']} "
              f"demotions={tiered['demotions']} "
              f"kv_bytes_per_slot={tiered['kv_bytes_per_slot']} "
              f"peak_kv_bytes={tiered['peak_kv_bytes']} "
              f"cold_bytes_saved={tiered['cold_bytes_saved']}")
        for sl in tiered["per_slot"]:
            print(f"  slot {sl['slot']}: {sl['tokens']} tokens "
                  f"({sl['hot_tokens']} hot / {sl['cold_tokens']} cold, "
                  f"{sl['kv_bytes']} B)")
        print(f"  arbiter: {tiered['recommendation']}")
    if wa:
        # the metered W<->A traffic and the overlap schedule's per-domain
        # stall accounting (efficiency = busy ticks / total, both domains)
        print(f"wa routing: {wa['routing_bytes_per_token']} B/token "
              f"(2 hops x layers x d_model), total "
              f"{wa['routing_total_bytes']} B, "
              f"{wa['routing_bytes_per_decode_token']:.1f} B per decode "
              f"token")
        print(f"wa overlap: depth={wa['overlap']} "
              f"efficiency={wa['overlap_efficiency']:.3f} "
              f"(W busy {wa['w_busy_ticks']}/{wa['schedule_ticks']}, "
              f"A busy {wa['a_busy_ticks']}/{wa['schedule_ticks']} ticks); "
              f"per macro-step W-idle {wa['w_idle_ms_per_macro_step']:.2f} "
              f"ms / A-idle {wa['a_idle_ms_per_macro_step']:.2f} ms; "
              f"micro-batch occupancy {wa['micro_batch_occupancy']:.2f}")
    # every submitted request ends completed, rejected or deadline-missed
    print(f"pressure: preemptions={stats['preemptions']} "
          f"restores={stats['restores']} rejections={stats['rejections']} "
          f"deadline_misses={stats['deadline_misses']} "
          f"retries={stats['retries']} "
          f"watchdog_timeouts={stats['watchdog_timeouts']} "
          f"quarantined={stats['quarantined_slots']} "
          f"swap_time_ms={stats['swap_time_ms']:.2f}")
    for e in rejected:
        print(f"  shed rid={e['rid']:3d} [{e['status']}] "
              f"priority={e['priority']} reason={e['reason']}")
    print("per-request:")
    for m in per_req:
        print(f"  rid={m['rid']:3d} admit@{m['admit_step']:4d} "
              f"queue={m['queue_delay_ms']:8.1f}ms "
              f"ttft={m['ttft_ms']:8.1f}ms tpot={m['tpot_ms']:6.2f}ms "
              f"preempts={m['preemptions']}")
    print("runtime:", rt)


if __name__ == "__main__":
    main()
