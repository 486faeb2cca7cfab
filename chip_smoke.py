"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``), never the JAX package, through five
phases; any failure exits non-zero before the result line:

1. build the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and across the kernels' tiling boundaries (K1 flash
   decode at S from 1 to 4096, B 1 and 8, the four q/KV dtype pairs,
   kv_limit at 0, inside a split, on a split edge and at S, normalised and
   partial, and at G*hd = 1024; K3 fused FFN; K4 int8 GEMV — K4 must be
   bit-exact; K1, K3 and K4 must give the same bits on a second call);
3. model parity at full qwen2-0.5b width, depth cut to 2 layers, float32:
   the same seeded weights on the CPU (plain versions) and on CUDA
   (kernels) give equal tokens and logits within 1e-3 of max|logit|;
4. the continuous-batching engine at full qwen2-0.5b (24 layers, seeded
   random bf16 weights): (a) chunked admission + macro-step decode + KV
   buckets, (b) int8 weights and int8 KV with monolithic admission,
   (c) per-token decode; every request must complete and every kernel of
   each run must have been launched (counts reset just before the run);
   one decode block of (a) and of (b) is traced with torch.profiler;
5. time each kernel at the main path's shapes (K1 at B=8 over S=200 and
   at a long context of S=4096, bf16 and int8 KV; K3 at 8, 32 and 128
   rows; K4 at 8 and 128 rows for the four projection shapes) against its
   bound, its plain version and PyTorch calls for the same function (K1:
   SDPA with ``enable_gqa``; K4: a bf16 matmul on dequantized weights and
   ``torch._int_mm``).

It then prints the card (nvidia-smi name, power limit), a ``kernels`` JSON
line, and last the JSON result line. Without a GPU, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core rates, 700 W
            torch.float32: 67e12,         # CUDA-core f32
            torch.int8: 1979e12}
L2_BYTES = 50 * 2 ** 20
REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:84",
    "fused_ffn": "src/repro/kernels/fused_ffn/fused_ffn.py:43",
    "gemv_int8": "src/repro/kernels/gemv/gemv.py:42",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "not measured"


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2 / 5 inputs at the main path's shapes
# ---------------------------------------------------------------------------

K1_PAIRS = (("float32", "float32"), ("float32", "int8"),
            ("bfloat16", "bfloat16"), ("bfloat16", "int8"))


def k1_inputs(dev, B, S, pair=("bfloat16", "bfloat16"), lim=None, Hq=14,
              n_kv=2, hd=64, seed=0):
    """Decode attention inputs (q, k, v, mask, k_scale, v_scale, kv_limit)
    with q and K/V in the dtype ``pair``; K/V a bucket view of S positions
    of an S + 8 cache layer (strided rows, as the engine passes them).
    ``lim`` None: every row live to the end (kv_limit = S); else every row
    attends a position below ``lim`` (when lim > 0) and none at or past
    it."""
    from repro_torch.quant.int8 import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt, kvdt = (getattr(torch, n) for n in pair)
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(qdt)
    kf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    vf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        ks, vs = ks[:, :, :S], vs[:, :, :S]
    else:
        k, v, ks, vs = kf.to(kvdt), vf.to(kvdt), None, None
    ar = torch.arange(S, device=dev)[None]
    if lim is None:
        lim = S
        pos = torch.full((B,), S - 1, device=dev)
    else:
        pos = torch.randint(0, max(1, min(lim, S)), (B,), device=dev,
                            generator=g)
    mask = (ar < pos[:, None] + 1) & (ar < lim)
    return (q, k[:, :, :S], v[:, :, :S], mask, ks, vs,
            torch.tensor(lim, dtype=torch.int32, device=dev))


def check_k1(args, lim):
    """Kernel against plain for one input set, normalised and partial:
    returns (max |d|, max |d| / tol, repeat identical). Tolerance 1e-5 *
    max(1, max|plain|) per output tensor (f32 online softmax in both, in
    another order); kv_limit <= 0 must give exactly 0 / (0, NEG_INF, 0)."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import (NEG_INF,
                                                      flash_decode_ref)
    err = ratio = 0.0
    same = True
    for partial in (False, True):
        got = flash_decode(*args, partial_stats=partial)
        again = flash_decode(*args, partial_stats=partial)
        want = flash_decode_ref(*args, partial_stats=partial)
        if not partial:
            got, again, want = (got,), (again,), (want,)
        for a, b, w in zip(got, again, want):
            e = max_err(a, w)
            err = max(err, e)
            ratio = max(ratio, e / (1e-5 * max(1.0, max_abs(w))))
            same = same and torch.equal(a, b)
        if lim <= 0:
            require(not got[0].any(), "K1 at kv_limit 0 is not 0")
            if partial:
                require(bool((got[1] == NEG_INF).all())
                        and not got[2].any(),
                        "K1 at kv_limit 0 is not (0, NEG_INF, 0)")
    return err, ratio, same


def k3_inputs(dev, R, seed=0, D=896, F=4864, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(R, D, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(s, device=dev, generator=g) / math.sqrt(s[0]))
          .to(dtype) for s in ((D, F), (D, F), (F, D))]
    return (x, *ws), dict(act="silu")


def k4_inputs(dev, R, K, N, seed=0):
    from repro_torch.quant.int8 import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = quantize_int8(torch.randn(R, K, device=dev, generator=g), axis=-1)
    wq = quantize_int8(torch.randn(K, N, device=dev, generator=g), axis=0)
    return (xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1)), {}


def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(a, b) for a, b in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def max_abs(t) -> float:
    if isinstance(t, tuple):
        return max(max_abs(a) for a in t)
    return float(t.float().abs().max())


def phase_compare(dev):
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    errs = {"flash_decode": 0.0, "fused_ffn": 0.0, "gemv_int8": 0.0}
    # K1: f32 online softmax in both, in a different summation order.
    # Every split count of the plan from one to many, kv_limit at 0, inside
    # a split, on a split edge and at S, and every row live to the end (as
    # timed in phase 5); then G*hd = 1024 (G=8, hd=128).
    from repro_torch.kernels.flash_decode.ops import decode_plan
    cases = [(S, B, pair, 14, 64)
             for S in (1, 17, 64, 128, 200, 1000, 4096)
             for B in (1, 8) for pair in K1_PAIRS]
    cases += [(S, B, pair, 16, 128) for S in (200, 4096) for B in (1, 8)
              for pair in K1_PAIRS]
    for S, B, pair, Hq, hd in cases:
        isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
        plan = decode_plan(B, 2, Hq // 2, S, hd, isz)
        edge = plan.split if plan.splits > 1 else S
        lims = sorted({0, max(1, plan.split // 2 + 3), edge, S})
        err = ratio = 0.0
        same = True
        for lim in lims + [None]:             # None: every row live to S
            args = k1_inputs(dev, B, S, pair, lim, Hq=Hq, hd=hd,
                             seed=S + B + (lim or 0))
            e, r, sm = check_k1(args, S if lim is None else lim)
            err, ratio, same = max(err, e), max(ratio, r), same and sm
        errs["flash_decode"] = max(errs["flash_decode"], err)
        log(f"  K1 B={B} S={S} G={Hq // 2} hd={hd} q={pair[0]} kv={pair[1]}"
            f" ({plan.splits} splits of {plan.split}), kv_limit {lims}: "
            f"max|d|={err:.3g}, max|d|/tol={ratio:.3g}, repeat "
            f"identical={same}")
        require(ratio <= 1.0, f"K1 disagrees at B={B} S={S} {pair} hd={hd}")
        require(same, f"K1 not deterministic at B={B} S={S} {pair}")
    # K3: f32 through the intermediate in both; different summation order.
    # Rows across the 16/32/64-row tiles; D=200 F=700 divides no tile.
    for D, F in ((896, 4864), (200, 700)):
        for dtype in (torch.bfloat16, torch.float32):
            for R in (1, 8, 16, 17, 32, 128):
                args, _ = k3_inputs(dev, R, seed=R + D, D=D, F=F,
                                    dtype=dtype)
                for act in ("silu", "gelu"):
                    got = fused_ffn(*args, act=act)
                    want = fused_ffn_ref(*args, act=act)
                    e, tol = max_err(got, want), 1e-4 * max(1, max_abs(want))
                    same = torch.equal(fused_ffn(*args, act=act), got)
                    errs["fused_ffn"] = max(errs["fused_ffn"], e)
                    log(f"  K3 D={D} F={F} {str(dtype)[6:]} rows={R} "
                        f"act={act}: max|d|={e:.3g} (tol {tol:.3g}), "
                        f"repeat identical={same}")
                    require(e <= tol, f"K3 disagrees at D={D} rows={R} "
                            f"{dtype} {act}")
                    require(same, f"K3 not deterministic at D={D} rows={R}")
    # K4: int32-exact accumulation, same f32 epilogue order: bit-exact.
    # K=100 is no multiple of the 16-row K chunk, N=130 none of 16 bytes.
    for K in (100, 896, 4864):
        for N in (128, 130, 896, 4864):
            for R in (1, 8, 9, 17, 128):
                args, _ = k4_inputs(dev, R, K, N, seed=K + N + R)
                got, want = gemv_int8_q(*args), gemv_int8_ref(*args)
                e = max_err(got, want)
                exact = torch.equal(got, want)
                same = torch.equal(gemv_int8_q(*args), got)
                errs["gemv_int8"] = max(errs["gemv_int8"], e)
                log(f"  K4 K={K} N={N} rows={R}: max|d|={e:.3g} (tol 0, "
                    f"exact={exact}, repeat identical={same})")
                require(exact, f"K4 not exact at {K}x{N} rows={R}")
                require(same, f"K4 not deterministic at {K}x{N} rows={R}")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phase 3: full-width model, 2 layers, f32, CPU vs CUDA
# ---------------------------------------------------------------------------

def phase_model_parity():
    from repro_torch.configs.registry import get_config
    from repro_torch.interop import to_device
    from repro_torch.kv.cache import KVCache
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16),
                                            dtype=np.int64))
    cpu_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(cpu_params, api.device)
        caches = api.init_caches(8, 48)
        first = []
        for slot in range(8):
            single, lg = api.prefill(params, prompts[slot:slot + 1]
                                     .to(api.device))
            caches = api.write_slot(caches, single, slot)
            first.append(lg[0, -1])
        tok = torch.stack(first).argmax(-1).to(torch.int32)
        pos = torch.full((8,), 16, dtype=torch.int32, device=api.device)
        act = torch.ones(8, dtype=torch.bool, device=api.device)
        saved = KVCache(caches.k.clone(), caches.v.clone(), None, None,
                        caches.length.clone())
        logits, toks = [], []
        t, p = tok, pos
        for _ in range(8):
            caches, lg = api.decode_slotted(params, caches, t, p, act)
            logits.append(lg[:, 0].float().cpu())
            t = lg[:, 0].argmax(-1).to(torch.int32)
            toks.append(t.cpu())
            p = p + 1
        blk = api.decode_block(
            params, saved, tok, pos, act,
            torch.full((8,), 8, dtype=torch.int32, device=api.device),
            torch.full((8,), -1, dtype=torch.int32, device=api.device),
            block_size=8, kv_bucket=32)
        res[d] = (torch.stack(logits), torch.stack(toks), blk[1].cpu())
    lc, lg = res["cpu"][0], res["cuda"][0]
    rel = float((lc - lg).abs().max() / lc.abs().max())
    same_steps = torch.equal(res["cpu"][1], res["cuda"][1])
    same_block = torch.equal(res["cpu"][2], res["cuda"][2])
    block_is_steps = torch.equal(res["cuda"][2], res["cuda"][1])
    log(f"  2-layer full-width f32: max|dlogit|/max|logit| = {rel:.3g} "
        f"(tol 1e-3); tokens equal: slotted={same_steps} "
        f"block={same_block}; block == slotted steps: {block_is_steps}")
    require(np.isfinite(rel) and rel <= 1e-3, "model logits disagree")
    require(same_steps and same_block and block_is_steps,
            "model tokens disagree")


# ---------------------------------------------------------------------------
# phase 4: the engine at full qwen2-0.5b
# ---------------------------------------------------------------------------

RUNS = {
    # name: (config overrides, engine kwargs, n_requests, max_new, kernels)
    "a_bf16_chunked_T8": (
        {}, dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
                 max_new_cap=72), 12, 64, ("flash_decode", "fused_ffn")),
    "b_int8w_int8kv_monolithic_T8": (
        dict(weight_int8=True, kv_dtype="int8"),
        dict(block_size=8, kv_bucket_chunk=64, max_new_cap=72), 12, 32,
        ("flash_decode", "gemv_int8")),
    "c_bf16_T1": ({}, dict(block_size=1, max_new_cap=72), 2, 16,
                  ("flash_decode", "fused_ffn")),
}


def trace_decode_block(api, params, kw):
    """Profile one steady decode block (T=8, 8 live rows at position 160,
    bucket 192): device busy time from the profiler's per-kernel sums
    against the block's wall time; prints the idle share and the ops that
    take most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    T, B = kw["block_size"], 8
    dev = api.device

    def block():
        caches = api.init_caches(B, 200)
        return api.decode_block(
            params, caches, torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), 160, dtype=torch.int32, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev),
            block_size=T, kv_bucket=192)

    block()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    block()
    torch.cuda.synchronize()
    wall_plain = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        block()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # device rows only: op rows repeat their kernels' time as "self" time
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us <= 0:
        log("    trace: profiler reported no device time (idle share not "
            "measured)")
        return
    log(f"    trace of one decode block (T={T}, 8 rows at 160, bucket 192): "
        f"wall {wall * 1e3:.2f} ms traced / {wall_plain * 1e3:.2f} ms "
        f"untraced, device busy {busy_us / 1e3:.2f} ms in "
        f"{sum(e.count for e in kern)} kernels, idle share "
        f"{1 - busy_us / 1e3 / (wall_plain * 1e3):.3f} of the untraced "
        f"wall")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.key[:64]:64s} {e.self_device_time_total / 1e3:8.3f} "
            f"ms, {e.count} launches")
    port = {}
    for e in kern:
        for tag in ("flash_decode", "gate_up_kernel", "down_kernel",
                    "gemv_int8"):
            if tag in e.key:
                us, n = port.get(tag, (0.0, 0))
                port[tag] = (us + e.self_device_time_total, n + e.count)
    log("      port kernels: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms in {n} launches"
        for k, (us, n) in port.items()))


def phase_engine(totals):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    per_step = {}
    for name, (over, kw, n_req, max_new, needed) in RUNS.items():
        cfg = get_config("qwen2-0.5b").replace(**over)
        api = build_model(cfg)
        t0 = time.monotonic()
        params = api.init(0)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        reqs = make_requests(cfg, n_req, 128, max_new, seed=0,
                             arrival_every=4)
        eng = ServingEngine(api, 8, 128, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stats = eng.run(params, reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, n in counts.items():
            totals[k] += n
        per_req = stats.pop("per_request")
        runtime = stats.pop("runtime")
        log(f"  run {name}: init {init_s:.1f}s, launches {counts}")
        log(f"    stats: {json.dumps(stats)}")
        log(f"    programs: " + ", ".join(
            f"{k}={v['calls']}" for k, v in runtime.items() if v["calls"]))
        log(f"    decode TPOT mean {stats['tpot_mean_ms']:.3f} ms, p50 "
            f"{stats['tpot_p50_ms']:.3f} ms, p99 {stats['tpot_p99_ms']:.3f} "
            f"ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require(stats["completed"] == n_req, f"{name}: not all completed")
        for r in reqs:
            require(len(r.generated) == max_new and all(
                0 <= t < cfg.vocab_size for t in r.generated),
                f"{name}: request {r.rid} stream malformed")
        require(len(per_req) == n_req, f"{name}: per-request stats missing")
        for k in needed:
            require(counts[k] > 0, f"{name}: kernel {k} never launched")
        if name.startswith("a_") or name.startswith("b_"):
            trace_decode_block(api, params, kw)
        # launches of one decode step (T = 1)
        if name.startswith("a_") or name.startswith("b_"):
            caches = api.init_caches(8, 200)
            z = torch.zeros(8, dtype=torch.int32, device=api.device)
            reset_launch_counts()
            api.decode_slotted(params, caches, z, z + 100,
                               torch.ones(8, dtype=torch.bool,
                                          device=api.device), kv_bucket=128)
            torch.cuda.synchronize()
            for k, n in launch_counts().items():
                if n:
                    per_step[k] = n
        del params, eng, api
        torch.cuda.empty_cache()
    return per_step


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_ms(fn, variants, iters) -> float:
    """Mean DEVICE time of ``fn(*args, **kw)`` over ``iters`` launches that
    rotate through ``variants`` (input copies whose total exceeds the L2,
    so every launch reads cold inputs as a layer-by-layer caller does).

    The host enqueues a launch more slowly than a small kernel runs, so the
    stream is first held by a spin kernel (``torch.cuda._sleep``) long
    enough for every launch to be queued behind it; the events then bracket
    back-to-back device work. A window whose start event had already
    completed when the host finished queueing (the CUDA launch queue
    filled, or the spin was short) is retried with fewer launches and a
    longer spin."""
    for args, kw in variants[:2]:
        fn(*args, **kw)
    torch.cuda.synchronize()
    for _ in range(8):
        t0 = time.perf_counter()
        for i in range(iters):
            args, kw = variants[i % len(variants)]
            fn(*args, **kw)
        spin = 2.0 * (time.perf_counter() - t0) + 2e-3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2.0e9))        # cycles at <= 2 GHz
        start.record()
        for i in range(iters):
            args, kw = variants[i % len(variants)]
            fn(*args, **kw)
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        iters = max(4, iters // 2)
    raise AssertionError(f"could not queue {fn} ahead of the device")


def variants_of(make, per_call_bytes):
    n = max(2, min(64, math.ceil(2 * L2_BYTES / max(per_call_bytes, 1))))
    return [make(i) for i in range(n)]


def phase_timing(dev, launches, per_step, errs):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    rows = []

    def bound(nb, ops, dtype):
        t_b = nb / HBM_BYTES_PER_S * 1e3
        t_o = ops / PEAK_OPS[dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # K1 at the engine's largest bucket (200, no multiple of 16) and at a
    # long context (4096), every position live
    for S, kv in ((200, "bfloat16"), (200, "int8"), (4096, "bfloat16"),
                  (4096, "int8")):
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, 8, S, ("bfloat16", kv))
        nb = nbytes(q, k, v, mask, ks, vs) + q.numel() * 4
        ops = 2 * 2 * q.shape[0] * q.shape[1] * S * q.shape[2]
        b_ms, b_by = bound(nb, ops, torch.bfloat16)
        var = variants_of(lambda i: (k1_inputs(dev, 8, S, ("bfloat16", kv),
                                               seed=i), {}), nb)
        ms = time_ms(flash_decode, var, 400)
        plain = time_ms(flash_decode_ref, var, 50)
        # yardstick: SDPA (GQA) on dequantized bf16 K/V of the same bucket
        sd = []
        for (q_, k_, v_, m_, ks_, vs_, _), _ in var:
            kd = k_ if ks_ is None else (k_.float() * ks_).to(torch.bfloat16)
            vd = v_ if vs_ is None else (v_.float() * vs_).to(torch.bfloat16)
            sd.append(((q_[:, :, None], kd, vd),
                       dict(attn_mask=m_[:, None, None, :], enable_gqa=True)))
        lib = {"sdpa(enable_gqa) on dequantized bf16 K/V":
               time_ms(F.scaled_dot_product_attention, sd, 400)}
        rows.append(("flash_decode", f"B=8 Hq=14 n_kv=2 hd=64 S={S} kv={kv}",
                     ms, plain, b_ms, b_by, lib))
        log(f"  K1 S={S} kv={kv}: {nb / 1e6:.3f} MB moved")
    # K3 at decode (8 rows), chunk (32 rows) and monolithic-prefill (128
    # rows) widths
    for R in (8, 32, 128):
        (x, wg, wu, wd), kw = k3_inputs(dev, R)
        D, F_ = wg.shape
        nb = nbytes(x, wg, wu, wd) + R * D * 4
        ops = 2 * R * D * F_ * 3
        b_ms, b_by = bound(nb, ops, torch.bfloat16)
        var = variants_of(lambda i: k3_inputs(dev, R, seed=i), nb)
        ms = time_ms(fused_ffn, var, 200)
        plain = time_ms(fused_ffn_ref, var, 50)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 200)}
        rows.append(("fused_ffn", f"rows={R} D=896 F=4864 bf16", ms, plain,
                     b_ms, b_by, lib))
    # K4 at decode (8) and prefill (128) rows for each projection shape
    for R in (8, 128):
        for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
            (xq, xs, wq, ws), _ = k4_inputs(dev, R, K, N)
            nb = nbytes(xq, xs, wq, ws) + R * N * 4
            ops = 2 * R * K * N
            b_ms, b_by = bound(nb, ops, torch.int8)
            var = variants_of(lambda i: k4_inputs(dev, R, K, N, seed=i), nb)
            ms = time_ms(gemv_int8_q, var, 400)
            plain = time_ms(gemv_int8_ref, var, 50)
            # yardsticks: a bf16 matmul on the dequantized weights, and the
            # same integer product by torch._int_mm, which needs more than
            # 16 rows (padded to 32 at decode rows) and K, N multiples of 8
            dq = [((a[0].to(torch.bfloat16),
                    (a[2].float() * a[3]).to(torch.bfloat16)), {})
                  for a, _ in var]
            pad = max(R, 32)
            im = [((torch.cat([a[0], a[0].new_zeros(pad - R, K)]), a[2]), {})
                  for a, _ in var]
            lib = {"bf16 torch.matmul on dequantized weights":
                   time_ms(torch.matmul, dq, 400)}
            try:
                lib[f"torch._int_mm, rows padded to {pad}"] = \
                    time_ms(torch._int_mm, im, 400)
            except RuntimeError as e:        # a yardstick only: say why
                log(f"  torch._int_mm refused {K}x{N}: {e}")
                lib[f"torch._int_mm, rows padded to {pad}"] = None
            rows.append(("gemv_int8", f"rows={R} K={K} N={N}", ms, plain,
                         b_ms, b_by, lib))
    for name, shape, ms, plain, b_ms, b_by, lib in rows:
        libs = ", ".join(("not measured" if v is None else
                          f"{v * 1e3:.2f} us") + f" ({k})"
                         for k, v in lib.items())
        log(f"  {name} [{shape}]: {ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} "
            f"us ({b_by}), plain {plain * 1e3:.2f} us, library {libs}; "
            f"launches per decode step {per_step.get(name, 0)}")
    out = []
    for name in REPLACES:
        mine = [r for r in rows if r[0] == name]
        first = mine[0]
        src = {"flash_decode": "flash_decode/csrc/flash_decode.cu",
               "fused_ffn": "fused_ffn/csrc/fused_ffn.cu",
               "gemv_int8": "gemv/csrc/gemv_int8.cu"}[name]
        out.append({"name": name, "status": "ported", "route": "cuda",
                    "source": "src/repro_torch/kernels/" + src,
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": errs[name],
                    "ms": first[2], "plain_ms": first[3],
                    "bound_ms": first[4], "bound_by": first[5],
                    "library_ms": next(iter(first[6].values())),
                    "shapes": [{"shape": r[1], "ms": r[2], "plain_ms": r[3],
                                "bound_ms": r[4], "bound_by": r[5],
                                "library_ms": r[6]} for r in mine]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    t_start = time.monotonic()

    log("phase 1: build")
    t0 = time.monotonic()
    reports = build.build_all()
    log(f"  built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.monotonic() - t0:.1f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")

    log("phase 2: kernels against their plain versions")
    errs = phase_compare(dev)

    log("phase 3: model parity, full width, 2 layers, f32, cpu vs cuda")
    phase_model_parity()

    log("phase 4: engine at full qwen2-0.5b")
    launches = {"flash_decode": 0, "fused_ffn": 0, "gemv_int8": 0}
    per_step = phase_engine(launches)
    log(f"  main-path launches {launches}; per decode step {per_step}")

    log("phase 5: kernel timing")
    kernels = phase_timing(dev, launches, per_step, errs)
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
