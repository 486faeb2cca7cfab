"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers.

Each kernel lives in ``<name>/``: ``csrc/*.cu`` (plain C interface, built
with ``nvcc`` into ``build/kernels/`` on first use and loaded with
``ctypes``), ``ops.py`` (the wrapper, with a launch counter) and ``ref.py``
(the plain PyTorch version). A wrapper launches its kernel for CUDA tensors
and runs the plain version only for CPU tensors.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    return {"flash_decode": flash_decode, "fused_ffn": fused_ffn,
            "gemv_int8": gemv_int8_q}


def launch_counts() -> Dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
