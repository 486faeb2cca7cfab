"""Model configuration: the port's own copy of ``repro.configs.base``.

The field set and defaults equal the reference ``ModelConfig`` so a config
compares field by field against its JAX counterpart. ``MoEConfig``,
``SSMConfig``, ``RGLRUConfig`` and ``EncoderConfig`` (the enc-dec family's
encoder stack) are copies of the reference's. ``param_count`` lives in
``repro_torch.models.registry.count_params``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds of a decoder stack: recurrentgemma interleaves RG-LRU and
# local attention, mamba2 is all SSD, every other family uniform attention
ATTN = "attn"            # full (global) GQA attention
LOCAL_ATTN = "local"     # sliding-window GQA attention
RGLRU = "rglru"          # RG-LRU recurrent block (Griffin)
SSD = "ssd"              # Mamba-2 state-space-duality block


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
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length of prefill

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = (RGLRU, RGLRU, LOCAL_ATTN)
    window: int = 2048              # local attention sliding window


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of the enc-dec family (whisper)."""
    n_layers: int = 0
    n_frames: int = 1500            # precomputed frame embeddings (stub frontend)
    is_causal: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | audio | vlm | hybrid | ssm
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
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    # --- vlm stub: precomputed patch embeddings put before the text ---
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

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind of the decoder stack."""
        if self.family == "ssm":
            return (SSD,) * self.n_layers
        if self.family == "hybrid":
            pat = self.rglru.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return (ATTN,) * self.n_layers

    @property
    def qk_norm(self) -> bool:
        """Per-head RMSNorm of q and k before RoPE (Qwen3's). The reference
        gives it to every qwen3-moe config by name; a property, so the
        field set stays the reference's."""
        return self.name.startswith("qwen3-moe")

    def reduced(self) -> "ModelConfig":
        """Same structure at tiny widths, for CPU tests (the reference's
        ``reduced()``: 4 experts, top ``min(k, 2)``, expert width 64; SSD
        state 16, head 32, chunk 16; RG-LRU width d_model, window 32; an
        encoder of 2 layers over 16 frames; 4 vision tokens)."""
        kw = {}
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                experts_per_token=min(self.moe.experts_per_token, 2),
                expert_d_ff=64)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16,
                                            head_dim=32, chunk=16)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=0,
                                              window=32)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=2,
                                                n_frames=16)
        if self.n_vision_tokens:
            kw["n_vision_tokens"] = 4
        return self.replace(name=self.name + "-reduced",
                            n_layers=min(self.n_layers, 3), d_model=128,
                            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
                            head_dim=32, d_ff=256, vocab_size=512, **kw)
