"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) d_ff=0
vocab=50280, ssm_state=128 — SSD (state-space duality).
[arXiv:2405.21060; unverified]

Attention-free: the decode state is O(1) in the context, and the
weight–attention split has no KV to decouple.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,                    # no separate MLP; mixing lives in the SSD block
    vocab_size=50280,
    head_dim=64,
    norm="rmsnorm",
    act="swiglu",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, n_groups=1),
    subquadratic=True,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
