"""The paper's own evaluated models (Table 1): the port's copy of
``repro.configs.paper_models``. All are standard Llama/Qwen dense decoders;
the paper deploys them fully INT8 (weights AND KV), mirrored here by
``weight_int8=True, kv_dtype="int8"``.
"""
from repro_torch.configs.base import ModelConfig

LLAMA32_3B = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, head_dim=128, rope_theta=500000.0, tie_embeddings=True,
    weight_int8=True, kv_dtype="int8",
    source="[paper Table 1]",
)

LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=32000, head_dim=128, rope_theta=10000.0,
    weight_int8=True, kv_dtype="int8",
    source="[paper Table 1]",
)

QWEN3_8B = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, head_dim=128, rope_theta=1000000.0,
    weight_int8=True, kv_dtype="int8",
    source="[paper Table 1]",
)

LLAMA2_70B = ModelConfig(
    name="llama2-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=32000, head_dim=128, rope_theta=10000.0,
    weight_int8=True, kv_dtype="int8",
    source="[paper Table 1]",
)

PAPER_MODELS = {m.name: m for m in (LLAMA32_3B, LLAMA2_7B, QWEN3_8B, LLAMA2_70B)}
