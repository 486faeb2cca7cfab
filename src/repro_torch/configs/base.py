"""Model configuration: the port's own copy of ``repro.configs.base``.

The field set and defaults equal the reference ``ModelConfig`` so a config
compares field by field against its JAX counterpart. ``MoEConfig`` is a
copy of the reference's; the sub-configs of the families not yet ported
(SSM, RG-LRU, encoder) stay ``None`` here, and the registry admits only
ported architectures. ``param_count`` lives in
``repro_torch.models.registry.count_params``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int          # top-k
    expert_d_ff: int                # per-expert hidden size
    # capacity factor of the dispatch (tokens per expert slot); <= 0: no drop
    capacity_factor: float = 1.25
    # dense (shared) ffn units run for every token, 0 for pure MoE
    num_shared_experts: int = 0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- normalization / activation / position ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | gelu_mlp
    rope_theta: float = 10000.0
    pos: str = "rope"               # rope | learned | sinusoidal
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    # --- sub-configs of families not yet ported (always None here) ---
    ssm: Optional[Any] = None
    rglru: Optional[Any] = None
    encoder: Optional[Any] = None
    n_vision_tokens: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"         # activation/weight compute dtype
    kv_dtype: str = "bfloat16"      # "int8" enables quantized KV
    weight_int8: bool = False       # int8 weight storage
    # --- tiered KV cache (hot_window > 0: hot ring + quantized cold tier) ---
    hot_window: int = 0
    kv_cold_dtype: str = "int8"
    kv_cold_block: int = 16
    subquadratic: bool = False
    source: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def qk_norm(self) -> bool:
        """Per-head RMSNorm of q and k before RoPE (Qwen3's). The reference
        gives it to every qwen3-moe config by name; a property, so the
        field set stays the reference's."""
        return self.name.startswith("qwen3-moe")

    def reduced(self) -> "ModelConfig":
        """Same structure at tiny widths, for CPU tests (the reference's
        ``reduced()`` for the dense and MoE families: 4 experts, top
        ``min(k, 2)``, expert width 64)."""
        kw = {}
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                experts_per_token=min(self.moe.experts_per_token, 2),
                expert_d_ff=64)
        return self.replace(name=self.name + "-reduced",
                            n_layers=min(self.n_layers, 3), d_model=128,
                            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
                            head_dim=32, d_ff=256, vocab_size=512, **kw)
