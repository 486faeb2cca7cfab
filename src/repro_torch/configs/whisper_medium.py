"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16, full MHA) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

Frontend stub: the caller supplies precomputed log-mel frame embeddings
(batch, n_frames=1500, d_model) in place of the conv1d/mel pipeline.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,               # decoder layers; encoder is a separate 24L stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    act="gelu_mlp",
    pos="learned",
    qkv_bias=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500, is_causal=False),
    source="[arXiv:2212.04356; unverified]",
)
