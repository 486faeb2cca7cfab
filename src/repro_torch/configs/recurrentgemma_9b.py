"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern 2 recurrent : 1 local
attention. [arXiv:2402.19427; unverified]

Sub-quadratic: the local attention window (2048) bounds the KV held per
slot (a ring) and the RG-LRU state is O(1) in the context.
"""
from repro_torch.configs.base import (LOCAL_ATTN, RGLRU, ModelConfig,
                                      RGLRUConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    norm="rmsnorm",
    act="geglu",
    rope_theta=10000.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=(RGLRU, RGLRU, LOCAL_ATTN), window=2048),
    subquadratic=True,
    tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
)
