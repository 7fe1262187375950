"""Config registry: resolves ``--arch <id>`` ids to ArchConfig instances.

It lists only the architectures the port serves; the reference's other
families and configs come with ROADMAP A13b.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, ShapeConfig, scaled_down

# CLI id -> module name (ids may contain characters invalid in module names)
_ARCH_MODULES: Dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
    "gemma-2b": "gemma_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{ARCH_IDS} (the others come with ROADMAP A13b)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "ShapeConfig", "ARCH_IDS", "get_arch",
           "scaled_down"]
