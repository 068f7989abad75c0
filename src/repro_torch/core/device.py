"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "torch_dtype"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another one.  Raises when CUDA is wanted and absent, rather than
    running somewhere the caller did not ask for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's ``param_dtype``) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
