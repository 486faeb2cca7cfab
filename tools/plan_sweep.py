"""Launch-plan variants of the K1, K3 and K4 kernels, timed on one NVIDIA
GPU.

    python3 tools/plan_sweep.py [k1] [k3] [k4]      (default: all three)

Runs each kernel at the decode path's shapes under other tilings than its
plan picks (K1: positions per split of S, with programmatic dependent
launch on and off, at B=8 and S=200 and 4096, bf16 and int8 KV; K3: D
chunks per gate/up strip and F rows per down CTA, 8 rows; K4: columns and
K rows per CTA, 8 rows), checks each result against the plain version (K4
bit-exact, K1 within 1e-5 and K3 within 1e-4 * max(1, max|plain|)), and
times it as ``chip_smoke.py`` does (device time by CUDA events, inputs
rotated past the L2). The plan's own choice is marked. Prints the card
(nvidia-smi name, power limit) first.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, cdiv, tickets  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd  # noqa: E402
from repro_torch.kernels.fused_ffn import ops as ffn  # noqa: E402
from repro_torch.kernels.gemv import ops as gemv  # noqa: E402

R, D, F = 8, 896, 4864
K4_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))


def k3_run(plan, x, wg, wu, wd, act="silu"):
    out = torch.empty((R, D), dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.float32,
                          device=x.device)
    tix = tickets(x.device, plan.grid_down[0] * plan.grid_down[1])
    err = ffn._lib().fused_ffn_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        scratch.data_ptr(), tix.data_ptr(), out.data_ptr(), R, D, F, 0, 1,
        plan.rows, plan.d_chunk, plan.d_splits, plan.f_chunk, plan.f_splits,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "fused_ffn")
    return out


def k4_run(plan, xq, xs, wq, ws):
    K, N = wq.shape
    out = torch.empty((R, N), dtype=torch.float32, device=xq.device)
    part = torch.empty(max(plan.scratch, 1), dtype=torch.int32,
                       device=xq.device)
    tix = tickets(xq.device, plan.grid[0] * plan.grid[1])
    err = gemv._lib()(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
                      ws.data_ptr(), out.data_ptr(), part.data_ptr(),
                      tix.data_ptr(), R, K, N, plan.rows, plan.cols,
                      plan.k_chunk, plan.k_splits, 1, 1,
                      torch.cuda.current_stream().cuda_stream)
    build.check(err, "gemv_int8")
    return out


def k1_sweep(dev):
    for S in (200, 4096):
        for kv in ("bfloat16", "int8"):
            pair = ("bfloat16", kv)
            args = cs.k1_inputs(dev, 8, S, pair)
            q, k = args[0], args[1]
            B, Hq, hd = q.shape
            n_kv = k.shape[1]
            nb = cs.nbytes(*args)
            var = cs.variants_of(
                lambda i: (cs.k1_inputs(dev, 8, S, pair, seed=i), {}), nb)
            want = fd.flash_decode_ref(*var[0][0])
            base = fd.decode_plan(B, n_kv, Hq // n_kv, S, hd,
                                  k.element_size())
            splits = sorted({16, 32, 64, 128, 256, 16 * cdiv(S, 16),
                             base.split})
            print(f"K1 B={B} Hq={Hq} n_kv={n_kv} hd={hd} S={S} kv={kv}: "
                  f"{nb / 1e6:.3f} MB, bound "
                  f"{nb / cs.HBM_BYTES_PER_S * 1e6:.2f} us", flush=True)
            variants = [(split, None) for split in splits]
            if S > 1024:          # ring tiles of the longer splits
                variants += [(sp, t) for sp in (256, 512) for t in (64, 128)]
            for split, tile in variants:
                plan = fd.decode_plan(B, n_kv, Hq // n_kv, S, hd,
                                      k.element_size(), split=split,
                                      tile=tile)
                for pdl in (True, False):
                    def run(*a, plan=plan, pdl=pdl):
                        return fd.launch_plan(plan, pdl, *a)[0]
                    got = run(*var[0][0])
                    err = float((got - want).abs().max())
                    tol = 1e-5 * max(1.0, float(want.abs().max()))
                    cs.require(err <= tol,
                               f"K1 variant split={split} disagrees")
                    ms = cs.time_ms(run, var, 400)
                    mine = plan == base and pdl == fd.PDL
                    print(f"  split {split} ({plan.splits} splits, {plan.ctas}"
                          f" CTAs, tile {plan.tile} x {plan.stages} stages, "
                          f"{plan.smem} B smem), pdl={pdl}: {ms * 1e3:.2f} us"
                          + ("  <- plan" if mine else ""), flush=True)


def k3_sweep(dev):
    var = cs.variants_of(lambda i: cs.k3_inputs(dev, R, seed=i),
                         3 * D * F * 2)
    want = ffn.fused_ffn_ref(*var[0][0])
    base = ffn.ffn_plan(R, D, F)
    for d_splits in (2, 4, 8):
        for f_chunk in (128, 256, 512, 1024):
            f_splits = cdiv(F, f_chunk)
            plan = dataclasses.replace(
                base, d_splits=d_splits,
                d_chunk=16 * cdiv(cdiv(D, d_splits), 16),
                grid_gate_up=base.grid_gate_up[:2] + (d_splits,),
                f_chunk=f_chunk, f_splits=f_splits,
                grid_down=base.grid_down[:2] + (f_splits,),
                scratch=R * F + (f_splits * R * D if f_splits > 1 else 0))
            err = float((k3_run(plan, *var[0][0]) - want).abs().max())
            cs.require(err <= 1e-4 * max(1.0, float(want.abs().max())),
                       f"K3 variant {d_splits}/{f_chunk} disagrees")
            ms = cs.time_ms(lambda *a, **k: k3_run(plan, *a), var, 200)
            mine = (d_splits, f_chunk) == (base.d_splits, base.f_chunk)
            print(f"K3 rows={R}: {d_splits} D chunks, {f_chunk} F rows per "
                  f"down CTA, CTAs {plan.ctas}: {ms * 1e3:.2f} us"
                  + ("  <- plan" if mine else ""), flush=True)


def k4_sweep(dev):
    for K, N in K4_SHAPES:
        var = cs.variants_of(lambda i: cs.k4_inputs(dev, R, K, N, seed=i),
                             K * N)
        want = gemv.gemv_int8_ref(*var[0][0])
        base = gemv.gemv_plan(R, K, N)
        for cols in (32, 64):
            for k_chunk in (16, 64, 256, 448, 896):
                k_splits = cdiv(K, k_chunk)
                plan = dataclasses.replace(
                    base, cols=cols, k_chunk=k_chunk, k_splits=k_splits,
                    grid=(cdiv(N, cols), 1, k_splits),
                    scratch=k_splits * R * N if k_splits > 1 else 0)
                cs.require(torch.equal(k4_run(plan, *var[0][0]), want),
                           f"K4 variant {cols}/{k_chunk} not exact")
                ms = cs.time_ms(lambda *a: k4_run(plan, *a), var, 400)
                print(f"K4 rows={R} K={K} N={N}: {cols} columns, {k_chunk} "
                      f"K rows per CTA, {plan.ctas} CTAs: {ms * 1e3:.2f} us",
                      flush=True)
        print(f"  plan: {base.cols} columns, {base.k_chunk} K rows per CTA, "
              f"{base.ctas} CTAs (its own time is chip_smoke.py's)")


def main(argv=None) -> int:
    which = set(sys.argv[1:] if argv is None else argv) or {"k1", "k3",
                                                            "k4"}
    if not torch.cuda.is_available():
        print("plan_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {cs.nvidia_smi()}")
    if "k1" in which:
        k1_sweep(dev)
    if "k3" in which:
        k3_sweep(dev)
    if "k4" in which:
        k4_sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
