"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Only architectures whose family the port serves are listed; the others
raise with the list of what is ported so far."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import qwen2_0p5b
from repro_torch.configs.base import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    "qwen2-0.5b": qwen2_0p5b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise ValueError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(REGISTRY)}")
    return REGISTRY[arch]
