"""The assigned input-shape set: the port of ``repro.configs.shapes``.

Each cell is (arch x shape); ``mode`` selects the step: train, prefill
(context encode) or decode (one new token against a seq_len-deep KV).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                       mode="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          mode="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         mode="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        mode="decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(config, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, and why not if skipped:
    long_500k decode needs sub-quadratic attention (SSM / hybrid)."""
    if shape.name == "long_500k" and not config.subquadratic:
        return False, ("skip: pure full-attention arch — 512k dense-KV "
                       "decode is the quadratic regime this shape excludes "
                       "(DESIGN.md §6)")
    return True, ""
