"""Parameters and optimizer state of the JAX package, as numpy arrays, to
the port's, and the port's parameters back to the JAX tree layout."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype

__all__ = ["params_from_jax", "params_to_jax", "opt_state_from_jax", "jax_leaf_path"]


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widening to f32 is exact
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device=device, dtype=dtype)


def jax_leaf_path(name: str):
    """(path, layer) of the JAX package's leaf that holds the port's
    parameter ``name``, the path as the JAX package's ``optim.fused`` spells
    it: ``layers.{i}.attn.wq`` is row ``i`` of ``layers/attn/wq``, any
    other name its keys joined by "/" with layer None (the inverse of
    `params_from_jax`'s name map)."""
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        return "layers/" + rest.replace(".", "/"), int(i)
    return name.replace(".", "/"), None


def params_from_jax(
    tree: Mapping[str, Any],
    cfg: ArchConfig,
    *,
    device: Union[str, torch.device],
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """A ``DecoderLM`` state dict from the JAX parameter tree.

    ``tree`` is ``repro.models.transformer.DecoderLM.init``'s output with
    every leaf turned into a numpy array.  Its ``layers`` subtree is stacked
    on a leading layer axis; each slice ``i`` becomes ``layers.{i}.*``.  The
    other names carry over with ``.`` joining the keys, as ``nn.Module``
    names them.  ``dtype`` defaults to the config's ``param_dtype``.
    """
    dtype = torch_dtype(dtype or cfg.param_dtype)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree):
        if name.startswith("layers."):
            arr = np.asarray(arr)
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{name} stacks {arr.shape[0]} layers, config has {cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = _to_tensor(arr[i], device, dtype)
        else:
            out[name] = _to_tensor(arr, device, dtype)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor], cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse name map of `params_from_jax`: the port's parameters as
    f32 numpy arrays in the JAX tree layout (``layers.{i}.*`` stacked on a
    leading layer axis, dotted names nested)."""
    tree: Dict[str, Any] = {}

    def put(name: str, arr: np.ndarray) -> None:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr

    layer_leaves: Dict[str, list] = {}
    for name, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layer_leaves.setdefault(rest, [None] * cfg.n_layers)[int(i)] = arr
        else:
            put(name, arr)
    for rest, arrs in layer_leaves.items():
        put(f"layers.{rest}", np.stack(arrs))
    return tree


def opt_state_from_jax(
    state: Mapping[str, Any],
    cfg: ArchConfig,
    *,
    device: Union[str, torch.device],
) -> Dict[str, Any]:
    """The port's AdamW state from the JAX package's ``adamw_init`` tree
    (numpy leaves): the step as an int32 scalar, and ``mu``, ``nu`` and
    ``master`` as f32 tensors named as the model's parameters; the optional
    ``gnorm`` leaf (``adamw_init(..., with_gnorm=True)``, informational)
    as an f32 scalar."""
    out: Dict[str, Any] = {"step": torch.tensor(np.asarray(state["step"]), dtype=torch.int32).to(device)}
    if "gnorm" in state:
        out["gnorm"] = torch.tensor(np.asarray(state["gnorm"]), dtype=torch.float32).to(device)
    for slot in ("mu", "nu", "master"):
        out[slot] = params_from_jax(state[slot], cfg, device=device, dtype=torch.float32)
    return out
