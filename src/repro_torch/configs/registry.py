"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The reference's dense, MoE, SSM (mamba2) and hybrid (recurrentgemma)
configurations and the paper's own four deployments are listed; the other
families' ids (enc-dec, VLM) raise with the list of what is ported so
far."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite3_2b, internlm2_1p8b,
                                 mamba2_1p3b, phi3_medium_14b, phi35_moe_42b,
                                 qwen2_0p5b, qwen3_moe_235b,
                                 recurrentgemma_9b)
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
}
REGISTRY.update(PAPER_MODELS)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise ValueError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(REGISTRY)}")
    return REGISTRY[arch]
