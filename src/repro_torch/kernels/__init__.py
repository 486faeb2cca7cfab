"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers.

Each kernel lives in ``<name>/``: ``csrc/*.cu`` (plain C interface, built
with ``nvcc`` into ``build/kernels/`` on first use and loaded with
``ctypes``), ``ops.py`` (the wrapper, with a launch counter) and ``ref.py``
(the plain PyTorch version). A wrapper launches its kernel for CUDA tensors
and runs the plain version only for CPU tensors. Launch plans size their
grids for an H100 (``SMS``); ``tickets`` serves the kernels that split a
reduction across CTAs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

SMS = 132                   # streaming multiprocessors of an H100 SXM
CTAS_PER_SM = 2             # launch plans aim at this many CTAs per SM


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
MIN_TICKETS = 4096


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` ticket counters for launches
    on the current stream of ``device``. A kernel that splits a reduction
    across CTAs lets the last CTA of each output tile add the partials:
    every CTA takes a ticket with an integer ``atomicInc`` that wraps to
    zero, so the buffer is zeroed again when the kernel ends and one buffer
    per (device, stream) serves every such launch on that stream."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, MIN_TICKETS), dtype=torch.int32,
                          device=device)
        _TICKETS[key] = buf
    return buf


def _wrappers():
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_partial)
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    return {"flash_decode": flash_decode,
            "flash_decode_partial": flash_decode_partial,
            "fused_ffn": fused_ffn, "gemv_int8": gemv_int8_q}


def launch_counts() -> Dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset.
    ``flash_decode_partial`` counts the K1 launches made in its partial-
    statistics mode; ``flash_decode`` counts every K1 launch."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
