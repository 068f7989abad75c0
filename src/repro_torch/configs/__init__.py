"""Ported architecture configs (public literature; see each module's
source tag)."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES

__all__ = ["ARCH_IDS", "ALIASES", "get_config", "all_configs", "ArchConfig", "ShapeConfig", "SHAPES"]

# every architecture of the JAX package (its `ARCH_IDS`, in its order):
# dense, MoE, hybrid, xLSTM, encoder-decoder and VLM families
ARCH_IDS = [
    "xlstm_1_3b",
    "stablelm_1_6b",
    "qwen3_4b",
    "qwen2_72b",
    "yi_6b",
    "seamless_m4t_medium",
    "zamba2_1_2b",
    "olmoe_1b_7b",
    "qwen3_moe_30b_a3b",
    "qwen2_vl_72b",
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
