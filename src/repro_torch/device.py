"""Device resolution for the port's entry points.

Entry points default to ``cuda`` and raise when no GPU is present: a run
that silently fell back to the CPU would report CPU numbers under GPU
names. The CPU is used only when the caller asks for it explicitly."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly to run the plain PyTorch versions on the CPU")
        # full-precision float32 products everywhere (the reference keeps
        # f32 accumulation; TF32 would keep ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
