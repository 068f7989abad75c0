"""Atomic checkpointing with per-leaf integrity digests (the port's
``repro.train.checkpoint``).

Layout, the JAX package's:  <dir>/step_00000123/
             manifest.json     tree structure, shapes, dtypes, step, digests
             <leaf-path>.npy   one file per leaf (the full tensor)
             COMMITTED         written last: its presence marks validity

Guarantees used by the fault-tolerance layer:
  * atomicity: data is written into a tmp dir and `os.rename`d into place;
    a crash mid-save never corrupts the latest valid checkpoint;
  * integrity: each leaf's manifest entry carries the sha256 of its stored
    bytes, and `restore` refuses a leaf whose bytes do not match;
  * async: `save_async` copies every leaf to the host before it returns,
    so the next step may overwrite the tensors in place (the port's
    training updates the model and the optimizer state in place, where
    JAX's arrays never change), and its thread only hashes and writes.

A tree is a nested dict (or tuple / list) of tensors, arrays and scalars.
Leaf files are named by their path joined with ``__``, dict keys in sorted
order, as ``jax.tree_util`` orders them; bf16 (and the fp8 types) are
stored as the unsigned view of the same width, as the JAX package stores
them (``_VIEW_DTYPES``), so the same bytes give the same digests and each
package reads the other's checkpoint of a nested dict.  Leaves are hashed
and written by a pool of threads (hashing and file writes release the
GIL).

`restore` with a ``target`` tree copies every tensor leaf into the
target's tensor **in place** (the fused optimizer and the model hold
references to them) and returns the target.  The elastic ``shardings=``
restore onto another mesh is ROADMAP item 16's.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# numpy cannot hold these torch types: store the unsigned view of the same
# width and record the logical dtype in the manifest (the JAX package's table)
_VIEW_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}
_TORCH_VIEW = {"bfloat16": torch.int16, "float8_e4m3fn": torch.uint8, "float8_e5m2": torch.uint8}
_WORKERS = min(8, os.cpu_count() or 1)

__all__ = [
    "CheckpointIntegrityError",
    "save",
    "save_async",
    "restore",
    "latest_step",
    "cleanup",
    "CheckpointManager",
]


class CheckpointIntegrityError(RuntimeError):
    """A restored leaf's bytes do not match its manifest digest.

    Raised instead of silently loading a torn or bit-rotted checkpoint: the
    rollback path in `train.fault_tolerance` depends on restored state
    actually being the state that was saved."""


def _digest(arr: np.ndarray) -> str:
    """Content digest of a leaf's stored byte representation."""
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf; dict keys sorted, as jax.tree_util does."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _leaf_files(tree) -> List[Tuple[str, Any]]:
    return [("__".join(_SAFE.sub("-", x) for x in path), leaf) for path, leaf in _flatten(tree)]


def _set_nested(d: Dict, keys: List[str], value):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the array of the stored bytes, the logical dtype name) of a leaf,
    copied off the device: a tensor's host copy never aliases it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        logical = str(t.dtype).split(".", 1)[1]
        if logical in _TORCH_VIEW:
            t = t.view(_TORCH_VIEW[logical])
        arr = t.to("cpu", copy=True).numpy()
        if logical in _VIEW_DTYPES:
            arr = arr.view(_VIEW_DTYPES[logical])
        return arr, logical
    arr = np.array(leaf)
    logical = str(arr.dtype)
    if logical in _VIEW_DTYPES:
        arr = arr.view(_VIEW_DTYPES[logical])
    return arr, logical


def _write_leaf(tmp: str, name: str, arr: np.ndarray, logical: str) -> Dict:
    np.save(os.path.join(tmp, name + ".npy"), arr)
    return {"name": name, "shape": list(arr.shape), "dtype": logical, "digest": _digest(arr)}


def _save_host(ckpt_dir: str, step: int, leaves: List[Tuple[str, np.ndarray, str]], extra: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with concurrent.futures.ThreadPoolExecutor(_WORKERS) as pool:
        entries = list(pool.map(lambda leaf: _write_leaf(tmp, *leaf), leaves))
    manifest = {"step": step, "extra": extra or {}, "leaves": entries}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_leaves(tree) -> List[Tuple[str, np.ndarray, str]]:
    """(name, stored array, logical dtype) of every leaf, copied to the host
    by the thread pool (the copies into fresh host memory are bound by
    its page faults, which threads spread)."""
    named = _leaf_files(tree)
    with concurrent.futures.ThreadPoolExecutor(_WORKERS) as pool:
        hosts = list(pool.map(lambda item: _to_host(item[1]), named))
    return [(name, arr, logical) for (name, _), (arr, logical) in zip(named, hosts)]


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[Dict] = None) -> str:
    """Blocking atomic save; returns the committed directory."""
    return _save_host(ckpt_dir, step, _host_leaves(tree), extra)


def save_async(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[Dict] = None) -> threading.Thread:
    """Fire-and-join-later save: every leaf is copied to the host on the
    caller's thread before this returns (the state may change in place as
    soon as it does), the hashing and the writes on a worker thread."""
    leaves = _host_leaves(tree)
    t = threading.Thread(target=_save_host, args=(ckpt_dir, step, leaves, extra))
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
            best = max(best or 0, int(m.group(1)))
    return best


def _load_leaf(d: str, leaf: Dict, mapped: bool = False) -> np.ndarray:
    """A leaf's stored array, verified against its digest; ``mapped``: a
    copy-on-write map of the file (no host copy, for a leaf about to be
    copied into its target)."""
    arr = np.load(os.path.join(d, leaf["name"] + ".npy"), mmap_mode="c" if mapped else None)
    want = leaf.get("digest")
    if want is not None and _digest(arr) != want:
        raise CheckpointIntegrityError(
            f"checkpoint leaf {leaf['name']!r} in {d} is corrupt: stored bytes do not match the manifest digest"
        )
    return arr


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _TORCH_VIEW:
        return torch.from_numpy(arr.view(np.int16 if logical == "bfloat16" else np.uint8)).view(
            getattr(torch, logical))
    return torch.from_numpy(arr)


def _copy_into(target, name: str, value: torch.Tensor):
    """``value`` written into the target leaf in place (a tensor), or the
    value itself in the target's kind (a Python scalar, an array)."""
    if isinstance(target, torch.Tensor):
        if tuple(target.shape) != tuple(value.shape) or target.dtype != value.dtype:
            raise ValueError(f"checkpoint leaf {name!r}: {tuple(value.shape)} {value.dtype} does not fit the "
                             f"target's {tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(value)
        return target
    if isinstance(target, (bool, int, float)):
        return type(target)(value.item())
    return value.numpy()


def _rebuild(target, values: Dict[str, Any], path=()):
    """``target``'s structure with each leaf replaced by ``values[name]``."""
    if isinstance(target, dict):
        return {k: _rebuild(target[k], values, path + (str(k),)) for k in target}
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(v, values, path + (str(i),)) for i, v in enumerate(target))
    return values["__".join(_SAFE.sub("-", x) for x in path)]


def restore(ckpt_dir: str, step: Optional[int] = None, *, target: Any = None) -> Tuple[Any, Dict]:
    """Restore a checkpoint: (tree, manifest).

    Without ``target`` the tree is a nested dict rebuilt from the leaf
    paths, of CPU tensors.  With ``target`` (a tree of the same structure)
    every tensor leaf of the target is overwritten in place with the saved
    bytes (shape and dtype must match) and the target is returned; a
    Python scalar leaf is replaced by the saved value.

    Every leaf whose manifest entry carries a ``digest`` is verified
    against its stored bytes; a mismatch raises
    :class:`CheckpointIntegrityError` (legacy manifests without digests
    load unverified)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    entries = manifest["leaves"]
    targets = dict(_leaf_files(target)) if target is not None else None
    if targets is not None and sorted(targets) != sorted(leaf["name"] for leaf in entries):
        raise ValueError("target/checkpoint structure mismatch")

    def load(leaf):  # read, verify and (with a target) copy in, leaf by leaf in the pool
        value = _to_tensor(_load_leaf(d, leaf, mapped=targets is not None), leaf["dtype"])
        return value if targets is None else _copy_into(targets[leaf["name"]], leaf["name"], value)

    with concurrent.futures.ThreadPoolExecutor(_WORKERS) as pool:
        values = {leaf["name"]: v for leaf, v in zip(entries, pool.map(load, entries))}
    if target is not None:
        return _rebuild(target, values), manifest
    tree: Dict = {}
    for name, value in values.items():
        _set_nested(tree, name.split("__"), value)
    return tree, manifest


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir) if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


class CheckpointManager:
    """Periodic async checkpointing + resume + retention, as used by the
    train loop and the fault-tolerance tests."""

    def __init__(self, ckpt_dir: str, *, interval: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self.last_extra: Dict = {}

    def maybe_save(self, step: int, tree: Any, *, extra=None, force=False):
        if not force and (step % self.interval) != 0:
            return
        self.wait()
        self._pending = save_async(self.dir, step, tree, extra=extra)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            cleanup(self.dir, self.keep)

    def resume(self, *, target=None):
        """(step, tree) of the latest committed checkpoint, restored into
        ``target`` in place when given, else (None, None).  The manifest's
        ``extra`` is kept in ``last_extra``."""
        step = latest_step(self.dir)
        if step is None:
            return None, None
        tree, manifest = restore(self.dir, step, target=target)
        self.last_extra = manifest.get("extra", {})
        return step, tree
