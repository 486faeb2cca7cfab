"""The paper's analytical performance model (§6.2): the port of
``repro.core.analytical``, with the H100 as its default machine.

    TPOT       = #stages x (per-stage latency + network latency) + embed
    Throughput = batch / per-stage latency

Per-stage latency is the roofline service time of one pipeline stage,
max(compute, memory), with memory time = bytes / the bandwidth of the
level that HOLDS the working set: a cache-resident working set runs at
cache bandwidth, a spilled one at DRAM/HBM bandwidth. The logic is the
reference's; the machines are arguments.

- ``H100_SXM``: one NVIDIA H100 SXM. Its fast level is the 50 MB L2, read
  at 3.74 TB/s (a warm read of one 32 MB buffer by the load-only kernel of
  ``tools/stream_floor.py --l2`` on an H100 80GB HBM3 at 700 W); HBM is
  80 GB at 3.35 TB/s (data sheet); peak int8 1,979 TOP/s (data sheet,
  dense). ``net_latency`` and ``sync_overhead`` are assumptions of the
  model, not measurements.
- ``EPYC_9684X``: the paper's platform, as the reference gives it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HW:
    name: str
    fast_bw: float           # B/s: cache-class bandwidth per domain
    slow_bw: float           # B/s: DRAM/HBM-class bandwidth per domain
    fast_capacity: float     # bytes of the fast level per domain
    flops: float             # peak FLOP/s per domain (int8 path where used)
    net_latency: float       # s per inter-stage hop
    sync_overhead: float     # s fixed per-operator sync cost
    n_ops_per_block: int = 4  # QKV, attn-out, FFN-up, FFN-down boundaries


# the paper's platform: EPYC 9684X, 1152 MB LLC/socket, ~400 GB/s DRAM
EPYC_9684X = HW("epyc-9684x", fast_bw=1.6e12, slow_bw=4.0e11,
                fast_capacity=1152e6, flops=9.8e12,
                net_latency=5e-6, sync_overhead=25e-6)

H100_L2_BYTES = 50e6
H100_HBM_BYTES = 80e9
H100_SXM = HW("h100-sxm", fast_bw=3.74e12, slow_bw=3.35e12,
              fast_capacity=H100_L2_BYTES, flops=1.979e15,
              net_latency=1e-6, sync_overhead=5e-6)


def weight_bytes(cfg: ModelConfig, bytes_per_param: float = 1.0) -> float:
    """Transformer-stack weights only (the embedding is the +1 stage)."""
    from repro_torch.models.registry import count_params
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return (count_params(cfg, active_only=True) - emb) * bytes_per_param


def kv_bytes_per_token(cfg: ModelConfig, ctx_len: int,
                       bytes_per_el: float = 1.0) -> float:
    """KV working set touched to decode ONE token (whole context)."""
    if cfg.family == "ssm":
        nh = cfg.ssm.n_heads(cfg.d_model)
        return cfg.n_layers * nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4.0
    total = 0.0
    for k in cfg.block_kinds():
        if k == "attn":
            span = ctx_len
        elif k == "local":
            span = min(ctx_len, cfg.rglru.window)
        else:       # rglru state
            total += (cfg.rglru.lru_width or cfg.d_model) * 4.0
            continue
        total += 2 * cfg.n_kv_heads * cfg.head_dim * span * bytes_per_el
    return total


def flops_per_token(cfg: ModelConfig, ctx_len: int) -> float:
    from repro_torch.models.registry import count_params
    n = count_params(cfg, active_only=True)
    return 2.0 * n + kv_bytes_per_token(cfg, ctx_len) * 2.0


def _eff_bw(footprint: float, traffic: float, cap: float, fast: float,
            slow: float) -> float:
    """Bandwidth for ``traffic`` given the RESIDENT fraction of the
    ``footprint`` (partial residency: the cache holds the hot fraction)."""
    if footprint <= 0:
        return fast
    f = min(1.0, cap / footprint)
    return f * fast + (1.0 - f) * slow


def stage_latency(cfg: ModelConfig, hw: HW = H100_SXM, *, batch: int,
                  ctx_len: int, n_stages: int, domains_per_stage: int = 1,
                  cache_resident: bool = True, wa_separated: bool = False,
                  operator_centric: bool = False,
                  bytes_per_param: float = 1.0,
                  bw_efficiency: float = 1.0) -> float:
    """Service time of one pipeline stage decoding ``batch`` tokens. The
    paradox (§2.3): per-stage traffic scales with (L/p)B, the KV footprint
    with L B (pipeline depth cancels); residency is judged on the
    footprint, service time on the traffic."""
    wb = weight_bytes(cfg, bytes_per_param) / n_stages
    kvb = kv_bytes_per_token(cfg, ctx_len) * batch / n_stages
    fl = flops_per_token(cfg, ctx_len) * batch / n_stages
    w_foot = wb
    kv_foot = kv_bytes_per_token(cfg, ctx_len) * batch
    cap = hw.fast_capacity * domains_per_stage
    fast = hw.fast_bw * domains_per_stage * bw_efficiency
    slow = hw.slow_bw * domains_per_stage * bw_efficiency
    if not cache_resident:
        w_bw = kv_bw = slow
    elif wa_separated:
        w_bw = _eff_bw(w_foot, wb, cap, fast, slow)
        kv_bw = _eff_bw(kv_foot, kvb, cap, fast, slow)
    else:
        w_bw = kv_bw = _eff_bw(w_foot + kv_foot, wb + kvb, cap, fast, slow)
    t = max(wb / w_bw + kvb / kv_bw, fl / (hw.flops * domains_per_stage))
    if operator_centric:
        t += cfg.n_layers / n_stages * hw.n_ops_per_block * hw.sync_overhead
    elif wa_separated:
        t += (cfg.n_layers / n_stages) * 2 * hw.net_latency
    return t


def tpot_and_throughput(cfg: ModelConfig, hw: HW = H100_SXM, *, batch: int,
                        ctx_len: int, n_stages: int,
                        embed_latency: float = 10e-6,
                        **kw) -> Dict[str, float]:
    lat = stage_latency(cfg, hw, batch=batch, ctx_len=ctx_len,
                        n_stages=n_stages, **kw)
    tpot = n_stages * (lat + hw.net_latency) + embed_latency
    return {"stage_latency_s": lat, "tpot_s": tpot,
            "throughput_tok_s": batch / lat}


def paper_system(cfg: ModelConfig, *, batch: int, ctx_len: int,
                 n_stages: int, hw: HW = EPYC_9684X,
                 wa_separated: bool = False) -> Dict[str, float]:
    return tpot_and_throughput(cfg, hw, batch=batch, ctx_len=ctx_len,
                               n_stages=n_stages, cache_resident=True,
                               wa_separated=wa_separated)


LLAMA_CPP_BW_EFF = 0.30   # the reference's calibration against Table 2


def baseline_llama_cpp(cfg: ModelConfig, *, batch: int, ctx_len: int,
                       hw: HW = EPYC_9684X,
                       n_stages: int = 1) -> Dict[str, float]:
    """Operator-centric, DRAM-streamed weights, per-op sync tax."""
    return tpot_and_throughput(cfg, hw, batch=batch, ctx_len=ctx_len,
                               n_stages=n_stages, cache_resident=False,
                               operator_centric=True,
                               bw_efficiency=LLAMA_CPP_BW_EFF)


def stages_for(cfg: ModelConfig, hw: HW = H100_SXM,
               bytes_per_param: float = 1.0) -> int:
    """Enough stages that per-stage weights are cache-resident (3/4 of the
    fast level, leaving room for KV and activations); layers split
    evenly."""
    wb = weight_bytes(cfg, bytes_per_param)
    n = max(1, math.ceil(wb / (hw.fast_capacity * 0.75)))
    while cfg.n_layers % n != 0 and n < cfg.n_layers:
        n += 1
    return n
