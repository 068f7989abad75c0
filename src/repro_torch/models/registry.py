"""Model registry: ArchConfig -> model instance (the dense, MoE, hybrid,
xLSTM and encoder-decoder families)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.xlstm_model import XLSTMLM

__all__ = ["build_model"]


def build_model(
    cfg: ArchConfig,
    *,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Union[DecoderLM, HybridLM, XLSTMLM, EncDecLM]:
    """The config's model with uninitialised parameters on ``device`` (the
    card unless another device is named; raises where CUDA is absent):
    `DecoderLM` for the dense and MoE families, `HybridLM` for the hybrid
    one, `XLSTMLM` for "ssm" and `EncDecLM` for "audio".  Fill it with
    ``.init(generator)`` or ``.load_state_dict(...)``."""
    dev = resolve_device(device)
    models = {"hybrid": HybridLM, "ssm": XLSTMLM, "audio": EncDecLM, "dense": DecoderLM, "moe": DecoderLM}
    if cfg.family not in models:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 item 12"
        )
    return models[cfg.family](cfg, device=dev, dtype=dtype)
