"""Model registry: ArchConfig -> model instance (dense and MoE families)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model"]


def build_model(
    cfg: ArchConfig,
    *,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> DecoderLM:
    """The config's model with uninitialised parameters on ``device`` (the
    card unless another device is named; raises where CUDA is absent).
    Fill it with ``.init(generator)`` or ``.load_state_dict(...)``."""
    dev = resolve_device(device)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 item 12"
        )
    return DecoderLM(cfg, device=dev, dtype=dtype)
