"""K1 wrapper: flash decode attention on CUDA (hand-written kernel) or on
the CPU (plain version). A CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SUPPORTED = {(0, 0), (0, 2), (1, 1), (1, 2)}
MAX_GROUP_WIDTH = 128 * 8        # G*hd a CTA accumulates (kThreads*kMaxAcc)


def _lib():
    lib = build.load_library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 5 + [L] * 5 + [ctypes.c_float] + \
            [I] * 3 + [P]
        fn.restype = ctypes.c_int
    return fn


def flash_decode(q, k, v, mask, k_scale=None, v_scale=None, kv_limit=None,
                 scale=None, partial_stats=False):
    """q: (B,Hq,hd) f32/bf16 contiguous; k/v: (B,n_kv,S,hd) with unit
    stride on hd and row stride hd (a bucket prefix view of a cache layer
    is fine); int8 K/V take scales (B,n_kv,S,1) f32; mask: (B,S) bool;
    kv_limit: 0-d int32 device tensor (or int) — tiles at or past it are
    skipped. Returns (B,Hq,hd) f32, or ``(o, m, l)`` with
    ``partial_stats``."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, mask, k_scale, v_scale, kv_limit,
                                scale, partial_stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
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
    if Hq % n_kv or G * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"flash_decode: Hq={Hq} n_kv={n_kv} hd={hd} "
                         f"unsupported (G*hd <= {MAX_GROUP_WIDTH})")
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
    o = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        mask.data_ptr(), lim.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, n_kv, G, S, hd, k.stride(0), k.stride(1), s_sb,
        s_sh, mask.stride(0), float(sc), codes[0], codes[1],
        int(partial_stats), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return (o, m, l) if partial_stats else o


flash_decode.launches = 0
