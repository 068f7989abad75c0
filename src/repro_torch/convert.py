"""Parameters and optimizer state of the JAX package, as numpy arrays, to
the port's, and the port's parameters back to the JAX tree layout.

The JAX trees stack repeated layers on leading axes; the port writes each
slice out under its index: ``layers`` (the decoder's, on one axis) becomes
``layers.{i}.*``; the hybrid family's ``groups`` (on (G, E)) becomes
``groups.{g}.{e}.*`` and its ``tail`` (on one axis) ``tail.{i}.*``; the
xLSTM family's ``mlstm`` (on (G, slstm_every - 1)) ``mlstm.{g}.{m}.*`` and
its ``slstm`` (on G) ``slstm.{g}.*``; the encoder-decoder's ``encoder``
and ``decoder`` (each on its layers) ``encoder.{i}.*`` and
``decoder.{i}.*``.  Every other leaf carries over with ``.`` joining the
keys."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype

# the JAX trees' stacked subtrees and their stacked axes
_STACKED = {"layers": 1, "groups": 2, "tail": 1, "mlstm": 2, "slstm": 1, "encoder": 1, "decoder": 1}

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


def _stacked(name: str):
    """(subtree, stacked axes) of a dotted name inside a stacked subtree,
    else None."""
    head = name.split(".", 1)[0]
    return (head, _STACKED[head]) if head in _STACKED and "." in name else None


def _stack_shape(head: str, cfg: ArchConfig) -> tuple:
    """The leading (stacked) axes of subtree ``head`` under ``cfg``."""
    if head in ("layers", "decoder"):
        return (cfg.n_layers,)
    if head == "encoder":
        return (cfg.encoder_layers,)
    if head in ("mlstm", "slstm"):
        groups = cfg.n_layers // cfg.slstm_every
        return (groups, cfg.slstm_every - 1) if head == "mlstm" else (groups,)
    groups = cfg.n_layers // cfg.attn_every
    return (groups, cfg.attn_every) if head == "groups" else (cfg.n_layers - groups * cfg.attn_every,)


def jax_leaf_path(name: str):
    """(path, layer) of the JAX package's leaf that holds the port's
    parameter ``name``, the path as the JAX package's ``optim.fused`` spells
    it: ``layers.{i}.attn.wq`` is row ``i`` of ``layers/attn/wq`` (layer
    ``i``), ``groups.{g}.{e}.mixer.in_proj`` the (g, e) slice of
    ``groups/mixer/in_proj`` (layer ``(g, e)``), ``tail.{i}.*`` row ``i``
    of ``tail/*``, and so ``mlstm.{g}.{m}.*``, ``slstm.{g}.*``,
    ``encoder.{i}.*`` and ``decoder.{i}.*``; any other name its keys
    joined by "/" with layer None (the inverse of `params_from_jax`'s name
    map)."""
    st = _stacked(name)
    if st is None:
        return name.replace(".", "/"), None
    head, axes = st
    parts = name.split(".")
    idx = tuple(int(i) for i in parts[1:1 + axes])
    return head + "/" + "/".join(parts[1 + axes:]), idx[0] if axes == 1 else idx


def params_from_jax(
    tree: Mapping[str, Any],
    cfg: ArchConfig,
    *,
    device: Union[str, torch.device],
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """A ``DecoderLM``, ``HybridLM``, ``XLSTMLM`` or ``EncDecLM`` state
    dict from the JAX parameter tree.

    ``tree`` is the JAX model's ``init`` output with every leaf turned into
    a numpy array.  Its stacked subtrees (``layers``; the hybrid's
    ``groups`` and ``tail``; the xLSTM's ``mlstm`` and ``slstm``; the
    encoder-decoder's ``encoder`` and ``decoder``) are written out slice
    by slice (the module
    docstring), the other names carry over with ``.`` joining the keys, as
    ``nn.Module`` names them.  ``dtype`` defaults to the config's
    ``param_dtype``; the Mamba2 mixers' ``A_log``, ``D`` and ``dt_bias``
    stay f32, as the JAX package keeps them.
    """
    from repro_torch.models.ssm import F32_PARAMS  # the models import this module's importers

    dtype = torch_dtype(dtype or cfg.param_dtype)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree):
        leaf_dtype = torch.float32 if cfg.family == "hybrid" and name.rsplit(".", 1)[-1] in F32_PARAMS else dtype
        st = _stacked(name)
        if st is None:
            out[name] = _to_tensor(arr, device, leaf_dtype)
            continue
        head, axes = st
        arr = np.asarray(arr)
        want = _stack_shape(head, cfg)
        if tuple(arr.shape[:axes]) != want:
            raise ValueError(f"{name} stacks {tuple(arr.shape[:axes])} layers, config has {want}")
        rest = name[len(head) + 1:]
        for idx in np.ndindex(*want):
            out[".".join((head, *map(str, idx), rest))] = _to_tensor(arr[idx], device, leaf_dtype)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor], cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse name map of `params_from_jax`: the port's parameters as
    f32 numpy arrays in the JAX tree layout (every stacked subtree of the
    module docstring stacked on its leading axes, dotted names nested)."""
    tree: Dict[str, Any] = {}

    def put(name: str, arr: np.ndarray) -> None:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr

    stacked: Dict[tuple, Dict[tuple, np.ndarray]] = {}
    for name, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        st = _stacked(name)
        if st is None:
            put(name, arr)
            continue
        head, axes = st
        parts = name.split(".")
        idx = tuple(int(i) for i in parts[1:1 + axes])
        stacked.setdefault((head, ".".join(parts[1 + axes:])), {})[idx] = arr
    for (head, rest), slices in stacked.items():
        shape = _stack_shape(head, cfg)
        put(f"{head}.{rest}", np.stack([slices[idx] for idx in np.ndindex(*shape)]).reshape(
            *shape, *next(iter(slices.values())).shape))
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
