"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536(expert)
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                 # per-expert intermediate size (moe_intermediate_size)
    vocab_size=151936,
    head_dim=128,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, expert_d_ff=1536),
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
