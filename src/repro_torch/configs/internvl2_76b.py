"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama3-70B-style) LM backbone. [arXiv:2404.16821; unverified]

The modality frontend is a stub: the caller supplies precomputed patch
embeddings (batch, n_vision_tokens, d_model); only the transformer
backbone is implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=500000.0,
    n_vision_tokens=256,
    source="[arXiv:2404.16821; unverified]",
)
