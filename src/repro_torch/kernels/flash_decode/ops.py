"""K1 wrapper: flash decode attention on CUDA (hand-written kernel) or on
the CPU (plain version). A CUDA tensor launches the kernel or raises.
``decode_plan`` is the kernel's launch plan (split of S across CTAs, ring
tiles, scratch, shared memory, runs of query heads), kept in Python so
that the CPU tests can check it.

The kernel takes at most MAX_GROUP query heads per KV head (the mma's n8)
and MAX_GROUP_WIDTH = G * hd. A wider group (qwen3-moe: G = 16, hd = 128,
two runs of 8 heads; recurrentgemma-9b: G = 16, hd = 256, four runs of 4)
runs as ``head_runs`` equal runs of heads, one launch each over the same
K/V (``by_head_runs``), up to MAX_HEAD_RUNS; anything wider raises."""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import CTAS_PER_SM, SMS, build, cdiv, tickets
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SUPPORTED = {(0, 0), (0, 2), (1, 1), (1, 2)}
HEAD_DIMS = (32, 64, 128, 256)   # multiples of the mma's k16, instantiated
MAX_GROUP = 8                    # query heads per KV head: the mma's n8
MAX_GROUP_WIDTH = 1024           # G*hd: merge buffers, 4 outputs a thread
MAX_HEAD_RUNS = 4                # launches a wider group may take
WARPS = 8                        # port::kThreads / 32
MAX_TILE = 1024                  # positions per tile (4 mask bytes/thread)
SPLIT_CHUNK = 16                 # splits the last CTA stages per round trip
MIN_SPLIT = 256                  # positions a split takes at least
STAGE_BYTES = 96 * 1024          # K, V, scales and flags of one ring stage
SMEM_BYTES = 227 * 1024          # dynamic shared memory a CTA may use
PDL = True                       # launch as a programmatic dependent


@dataclass(frozen=True)
class DecodePlan:
    """How ``flash_decode.cu`` tiles a call: CTA (h, b, z) owns positions
    [z*split, min((z+1)*split, S)) of KV head h in row b and streams them
    in tiles of ``tile`` positions through ``stages`` ring stages (one
    stage holds the whole split). With more than one split the raw
    (o, m, l) of each split go to an f32 scratch of ``scratch`` elements
    and the last CTA of each (b, h) merges them. A group of more than
    MAX_GROUP heads (or MAX_GROUP_WIDTH columns) runs as ``runs`` launches
    of ``heads`` heads each; the other fields describe one launch."""
    split: int
    splits: int
    tile: int
    stages: int
    grid: Tuple[int, int, int]
    scratch: int                # f32 elements (0: one split)
    smem: int                   # dynamic shared memory bytes a CTA takes
    heads: int = 1              # query heads per KV head in one launch
    runs: int = 1               # launches: heads * runs = G

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(tile: int, stages: int, splits: int, G: int, hd: int,
               kv_itemsize: int) -> int:
    """Shared memory of one CTA, as ``flash_decode.cu`` lays it out: the
    ring stages (K and V rows padded by 16 bytes, int8 scales, live flags)
    or, once they are consumed, the merge buffers (o of 8 warps or of up
    to SPLIT_CHUNK splits, m and l of max(8, splits) rows), then the 8
    warps' P tiles (8 heads x 20 floats)."""
    kv = _a16(tile * (hd * kv_itemsize + 16))
    sc = _a16(tile * 4) if kv_itemsize == 1 else 0
    stage = 2 * kv + 2 * sc + _a16(tile)
    o_rows = max(min(splits, SPLIT_CHUNK), WARPS)
    merge = _a16(o_rows * G * hd * 4) + \
        _a16((2 * max(splits, WARPS) * G + 2 * MAX_GROUP) * 4)
    return max(stages * stage, merge) + WARPS * MAX_GROUP * 20 * 4


def head_runs(G: int, hd: int) -> int:
    """The fewest equal runs of G query heads in which each run has at most
    MAX_GROUP heads and MAX_GROUP_WIDTH columns; raises past
    MAX_HEAD_RUNS."""
    for runs in range(1, MAX_HEAD_RUNS + 1):
        if G % runs == 0 and G // runs <= MAX_GROUP \
                and G // runs * hd <= MAX_GROUP_WIDTH:
            return runs
    raise ValueError(f"flash_decode: G={G} hd={hd} does not split into "
                     f"<= {MAX_HEAD_RUNS} equal runs of <= {MAX_GROUP} "
                     f"heads and <= {MAX_GROUP_WIDTH} columns")


def by_head_runs(fn, q: torch.Tensor, n_kv: int, runs: int):
    """``fn`` once per run of query heads: q (B,Hq,hd) is viewed
    (B, n_kv, runs, r, hd) with r = Hq / n_kv / runs, and run j passes the
    contiguous (B, n_kv*r, hd) copy of heads [j*r, (j+1)*r) of every KV
    group. ``fn`` returns (o (B,n_kv*r,hd), m (B,n_kv*r), l); the runs'
    outputs interleave back into (B,Hq,hd) and (B,Hq), head h of group g
    at g*G + h as in a one-launch call."""
    B, Hq, hd = q.shape
    r = Hq // n_kv // runs
    qv = q.view(B, n_kv, runs, r, hd)
    outs = [fn(qv[:, :, j].contiguous().view(B, n_kv * r, hd))
            for j in range(runs)]
    o, m, l = (torch.stack([t.view(B, n_kv, r, -1) for t in ts], dim=2)
               for ts in zip(*outs))
    return o.view(B, Hq, hd), m.view(B, Hq), l.view(B, Hq)


def decode_plan(B: int, n_kv: int, G: int, S: int, hd: int,
                kv_itemsize: int, split: Optional[int] = None,
                tile: Optional[int] = None) -> DecodePlan:
    """Split S until the grid holds about CTAS_PER_SM CTAs per SM: where
    B*n_kv CTAs already fill the card there is one split, else each (b, h)
    takes ceil(CTAS_PER_SM * SMS / (B*n_kv)) splits of a multiple of 16
    positions, but no split shorter than MIN_SPLIT: a split costs its last
    CTA a ticket and a second round trip to L2, about 2 us on the H100,
    more than one CTA takes to stream 256 positions (tools/plan_sweep.py:
    at B=8, S=200 one split beats 2 to 13; at S=4096, 16 splits of 256
    beat 8 of 512 and 32 of 128). ``split`` and ``tile`` override the
    choice (the sweep's variants). A split whose K/V bytes pass STAGE_BYTES
    streams through two ring stages of half that size. A group wider than
    the kernel's takes ``head_runs(G, hd)`` launches of G / runs heads."""
    runs = head_runs(G, hd)
    G //= runs
    pairs = B * n_kv
    if split is None:
        want = 1 if pairs >= SMS else cdiv(CTAS_PER_SM * SMS, pairs)
        whole = 16 * cdiv(max(S, 1), 16)
        split = min(whole, max(MIN_SPLIT, 16 * cdiv(cdiv(max(S, 1), want),
                                                    16)))
    if split <= 0 or split % 16:
        raise ValueError(f"decode_plan: split {split} is no positive "
                         f"multiple of 16")
    splits = max(1, cdiv(S, split))
    row = 2 * (hd * kv_itemsize + 16) + (8 if kv_itemsize == 1 else 0)
    if tile is None:
        tile = split if split <= MAX_TILE and split * row <= STAGE_BYTES \
            else max(16, min(MAX_TILE, STAGE_BYTES // 2 // row // 16 * 16))
    if tile <= 0 or tile % 16 or tile > MAX_TILE:
        raise ValueError(f"decode_plan: tile {tile} is no multiple of 16 "
                         f"in (0, {MAX_TILE}]")
    tile = min(tile, split)
    stages = 1 if tile == split else 2
    smem = smem_bytes(tile, stages, splits, G, hd, kv_itemsize)
    if smem > SMEM_BYTES:
        raise ValueError(f"decode_plan: {smem} bytes of shared memory for "
                         f"split {split} ({splits} splits), G={G} hd={hd}")
    scratch = pairs * splits * G * (hd + 2) if splits > 1 else 0
    return DecodePlan(split, splits, tile, stages, (n_kv, B, splits),
                      scratch, smem, G, runs)


def _lib():
    lib = build.load_library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 12 + [I] * 5 + [L] * 5 + [ctypes.c_float] + \
            [I] * 10 + [P]
        fn.restype = ctypes.c_int
    return fn


def _aligned16(t: torch.Tensor) -> bool:
    """Base and the batch/head strides of t are 16-byte aligned (rows are:
    hd * itemsize is a multiple of 16 for every hd the kernel takes)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.shape[d] <= 1 or t.stride(d) * es % 16 == 0 for d in (0, 1))


def launch_plan(plan: DecodePlan, pdl: bool, q, k, v, mask, k_scale=None,
                v_scale=None, kv_limit=None, scale=None,
                partial_stats=False):
    """Check the CUDA inputs and launch the kernel under ``plan`` (counts
    nothing: ``flash_decode`` is the counted entry)."""
    B, Hq, hd = q.shape
    _, n_kv, S, _ = k.shape
    G = Hq // n_kv
    quantized = k_scale is not None
    codes = (_Q_CODES.get(q.dtype), _KV_CODES.get(k.dtype))
    if codes not in _SUPPORTED or v.dtype != k.dtype:
        raise TypeError(f"flash_decode: unsupported dtypes q={q.dtype} "
                        f"k={k.dtype} v={v.dtype}")
    if quantized != (k.dtype == torch.int8):
        raise TypeError("flash_decode: int8 K/V need scales, float K/V none")
    if Hq % n_kv or hd not in HEAD_DIMS or G > MAX_GROUP \
            or G * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"flash_decode: Hq={Hq} n_kv={n_kv} hd={hd} "
                         f"unsupported (hd in {HEAD_DIMS}, G <= "
                         f"{MAX_GROUP}, G*hd <= {MAX_GROUP_WIDTH})")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd or t.device != q.device:
            raise ValueError("flash_decode: K/V rows must be contiguous "
                             "(stride(3)=1, stride(2)=hd) on q's device")
    if k.stride() != v.stride():
        raise ValueError("flash_decode: K and V strides differ")
    if quantized:
        if k_scale.dtype != torch.float32 or k_scale.stride(2) != 1 \
                or k_scale.stride() != v_scale.stride() \
                or tuple(k_scale.shape) != (B, n_kv, S, 1):
            raise ValueError("flash_decode: scales must be (B,n_kv,S,1) f32 "
                             "with unit stride on S, equal for K and V")
        s_sb, s_sh = k_scale.stride(0), k_scale.stride(1)
    else:
        s_sb = s_sh = 0
    if mask.dtype != torch.bool or tuple(mask.shape) != (B, S) \
            or mask.stride(1) != 1:
        raise ValueError("flash_decode: mask must be (B,S) bool, unit "
                         "stride on S")
    if kv_limit is None:
        kv_limit = S
    lim = torch.as_tensor(kv_limit, dtype=torch.int32, device=q.device)
    if lim.numel() != 1:
        raise ValueError("flash_decode: kv_limit must be a scalar")
    lim = lim.reshape(1).contiguous()
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    o = torch.empty((B, Hq, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    if B == 0 or Hq == 0:
        return o, m, l
    part = torch.empty((max(plan.scratch, 1),), dtype=torch.float32,
                       device=dev)
    tix = tickets(dev, B * n_kv)
    wide = int(_aligned16(k) and _aligned16(v))
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        mask.data_ptr(), lim.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), part.data_ptr(), tix.data_ptr(), B, n_kv, G, S, hd,
        k.stride(0), k.stride(1), s_sb, s_sh, mask.stride(0), float(sc),
        codes[0], codes[1], int(partial_stats), plan.split, plan.splits,
        plan.tile, plan.stages, plan.smem, wide, int(pdl),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "flash_decode")
    return o, m, l


def flash_decode(q, k, v, mask, k_scale=None, v_scale=None, kv_limit=None,
                 scale=None, partial_stats=False):
    """q: (B,Hq,hd) f32/bf16 contiguous; k/v: (B,n_kv,S,hd) with unit
    stride on hd and row stride hd (a bucket prefix view of a cache layer
    is fine); int8 K/V take scales (B,n_kv,S,1) f32; mask: (B,S) bool;
    kv_limit: 0-d int32 device tensor (or int) — tiles at or past it are
    skipped. Returns (B,Hq,hd) f32, or ``(o, m, l)`` with
    ``partial_stats``. A group wider than the kernel's runs as the plan's
    ``runs`` launches (``by_head_runs``), each counted."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, mask, k_scale, v_scale, kv_limit,
                                scale, partial_stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, Hq, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    plan = decode_plan(B, n_kv, max(1, Hq // max(n_kv, 1)), S, hd,
                       k.element_size())

    def launch(qr):
        out = launch_plan(plan, PDL, qr, k, v, mask, k_scale, v_scale,
                          kv_limit, scale, partial_stats)
        if B and Hq:                    # launch_plan launched the kernel
            flash_decode.launches += 1
            if partial_stats:
                flash_decode_partial.launches += 1
        return out

    if plan.runs == 1:
        o, m, l = launch(q)
    else:
        if not q.is_contiguous():
            raise ValueError("flash_decode: q must be contiguous")
        o, m, l = by_head_runs(launch, q, n_kv, plan.runs)
    return (o, m, l) if partial_stats else o


flash_decode.launches = 0


def flash_decode_partial(q, k, v, mask, k_scale=None, v_scale=None,
                         kv_limit=None, scale=None):
    """K1 in partial-statistics mode: the raw ``(o (B,Hq,hd), m (B,Hq),
    l (B,Hq))`` f32 of one KV block for an LSE merge
    (``combine.combine_partial_stats``); a block skipped whole
    (``kv_limit`` <= 0) gives exactly ``(0, NEG_INF, 0)``. ``flash_decode``
    counts every partial-mode launch under this name too."""
    return flash_decode(q, k, v, mask, k_scale, v_scale, kv_limit, scale,
                        partial_stats=True)


flash_decode_partial.launches = 0
