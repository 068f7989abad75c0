"""Ported architecture configs (public literature; see each module's
source tag)."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES

__all__ = ["ARCH_IDS", "ALIASES", "get_config", "all_configs", "ArchConfig", "ShapeConfig", "SHAPES"]

# the configs the port serves: two dense, one MoE; the JAX package has
# more families
ARCH_IDS = [
    "qwen3_4b",
    "yi_6b",
    "olmoe_1b_7b",
]

# hyphenated aliases (CLI --arch accepts both)
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    mod_name = name.replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"no ported config {name!r}; pick from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
