"""Working-set / residency planner: the port of ``repro.core.residency``.

Per (arch x shape x chips): per-chip weight and KV bytes, whether the
weight hot set fits the fast level, whether the whole working set fits the
device memory, the KV-pressure paradox invariant, and whether WA
separation is profitable (working set over half the fast level, decode
only) -- which drives ``core/wa.py::wa_plan``. The logic is the
reference's; the budgets are arguments whose defaults are the H100's own:
the fast level is its 50 MB L2 and its memory 80 GB of HBM (the reference
defaults to a TPU v5e's VMEM and HBM).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.analytical import (H100_HBM_BYTES, H100_L2_BYTES,
                                         kv_bytes_per_token, weight_bytes)

FAST_BYTES = H100_L2_BYTES
HBM_BYTES = H100_HBM_BYTES


@dataclass(frozen=True)
class ResidencyReport:
    weight_bytes_per_chip: float
    kv_bytes_per_chip: float
    vmem_weight_resident: bool     # the weight hot set fits the fast level
    hbm_fits: bool
    wa_profitable: bool
    paradox_invariant: float       # per-domain KV bytes, PP-depth invariant
    notes: str


def dtype_bytes(cfg: ModelConfig, kv: bool = False) -> float:
    if kv:
        return 1.0 if cfg.kv_dtype == "int8" else 2.0
    return 1.0 if cfg.weight_int8 else 2.0


def plan(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
         pp_depth: int = 1, train: bool = None,
         fast_bytes: float = FAST_BYTES,
         hbm_bytes: float = HBM_BYTES) -> ResidencyReport:
    train = shape.mode == "train" if train is None else train
    bpp = dtype_bytes(cfg)
    emb = cfg.vocab_size * cfg.d_model * bpp * (1 if cfg.tie_embeddings
                                                else 2)
    w_per_chip = (weight_bytes(cfg, bpp) + emb) / n_chips
    per_tok = kv_bytes_per_token(cfg, shape.seq_len, dtype_bytes(cfg, True))
    kv_per_chip = per_tok * shape.global_batch / n_chips
    # paradox: in-flight requests >= pp_depth -> per-domain KV invariant
    in_flight = shape.global_batch * max(pp_depth, 1)
    paradox = per_tok * in_flight / max(pp_depth, 1)
    opt = 3 * (weight_bytes(cfg, bpp) + emb) * 2 if train else 0.0
    vmem_ok = w_per_chip <= fast_bytes
    hbm_ok = (w_per_chip + kv_per_chip + opt / n_chips) <= hbm_bytes * 0.9
    wa_prof = (w_per_chip + kv_per_chip) > 0.5 * fast_bytes \
        and shape.is_decode
    notes = []
    if not vmem_ok:
        notes.append(f"weights/chip {w_per_chip/1e6:.0f}MB > fast level — "
                     "HBM-streamed (gemv kernel regime)")
    if wa_prof:
        notes.append("WA separation profitable: co-located hot set exceeds "
                     "fast-memory budget (paper Fig 9 high-pressure regime)")
    return ResidencyReport(w_per_chip, kv_per_chip, vmem_ok, hbm_ok, wa_prof,
                           paradox, "; ".join(notes))


def paradox_table(cfg: ModelConfig, ctx_len: int, batch: int,
                  depths=(1, 2, 4, 8, 16)) -> Dict[int, float]:
    """The §2.3 algebra: per-domain KV vs pipeline depth."""
    out = {}
    for p in depths:
        out[p] = (cfg.n_layers / p / cfg.n_layers) * (p * batch) * \
            kv_bytes_per_token(cfg, ctx_len, dtype_bytes(cfg, kv=True))
    return out
