"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Every configuration of the reference's registry is listed: the dense and
MoE models, the SSM (mamba2), the hybrid (recurrentgemma), the VLM
backbone (internvl2) and the enc-dec model (whisper), and the paper's own
four deployments. An unknown id raises with the list."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite3_2b, internlm2_1p8b,
                                 internvl2_76b, mamba2_1p3b, phi3_medium_14b,
                                 phi35_moe_42b, qwen2_0p5b, qwen3_moe_235b,
                                 recurrentgemma_9b, whisper_medium)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import PAPER_MODELS

REGISTRY: Dict[str, ModelConfig] = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "internlm2-1.8b": internlm2_1p8b.CONFIG,
    "granite-3-2b": granite3_2b.CONFIG,
    "phi3-medium-14b": phi3_medium_14b.CONFIG,
    "qwen2-0.5b": qwen2_0p5b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "mamba2-1.3b": mamba2_1p3b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
}
REGISTRY.update(PAPER_MODELS)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise ValueError(
            f"unknown arch {arch!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[arch]
