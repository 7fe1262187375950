"""Config registry: resolves ``--arch <id>`` ids to ArchConfig instances,
the reference's ten ids in its order."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, ShapeConfig, scaled_down

# CLI id -> module name (ids may contain characters invalid in module names)
_ARCH_MODULES: Dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
    "granite-8b": "granite_8b",
    "whisper-medium": "whisper_medium",
    "yi-6b": "yi_6b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "paligemma-3b": "paligemma_3b",
    "gemma-2b": "gemma_2b",
    "minicpm-2b": "minicpm_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "ShapeConfig", "ARCH_IDS", "get_arch",
           "scaled_down"]
