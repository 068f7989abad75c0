"""Model registry: ArchConfig -> model instance (the dense, MoE, VLM,
hybrid, xLSTM and encoder-decoder families), and the most patch
embeddings the VLM's stub vision frontend places on a sequence."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.xlstm_model import XLSTMLM

__all__ = ["build_model", "VISION_TOKENS"]

VISION_TOKENS = 1024  # stub frontend: patch embeddings on leading positions (the JAX package's value)


def build_model(
    cfg: ArchConfig,
    *,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Union[DecoderLM, HybridLM, XLSTMLM, EncDecLM]:
    """The config's model with uninitialised parameters on ``device`` (the
    card unless another device is named; raises where CUDA is absent):
    `DecoderLM` for the dense, MoE and VLM families, `HybridLM` for the
    hybrid one, `XLSTMLM` for "ssm" and `EncDecLM` for "audio".  Fill it with
    ``.init(generator)`` or ``.load_state_dict(...)``."""
    dev = resolve_device(device)
    models = {"hybrid": HybridLM, "ssm": XLSTMLM, "audio": EncDecLM, "dense": DecoderLM, "moe": DecoderLM,
              "vlm": DecoderLM}
    if cfg.family not in models:
        raise ValueError(f"unknown model family {cfg.family!r}; pick from {sorted(models)}")
    return models[cfg.family](cfg, device=dev, dtype=dtype)
