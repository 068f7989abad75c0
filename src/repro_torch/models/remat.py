"""Activation recomputation (remat): the port's ``REMAT_POLICIES`` and
``_maybe_remat`` of ``repro.models.transformer``.

A model wraps each of JAX's remat units (a decoder layer; an encoder or
decoder layer of the encoder-decoder; a hybrid group and each tail block;
an xLSTM group) in `remat_call`.  Under a policy other than "none", and
with grad mode on, the unit runs through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its forward
keeps only the unit's inputs and what the policy saves, and the backward
runs the unit's forward again to rebuild the rest.

  "none"           no recomputation
  "full"           nothing saved (JAX: ``nothing_saveable``)
  "dots"           the outputs of ``aten.mm`` / ``addmm`` / ``bmm`` /
                   ``baddbmm`` saved (JAX: ``checkpoint_dots``)
  "dots_no_batch"  those of ``aten.mm`` / ``addmm`` only (JAX:
                   ``checkpoint_dots_with_no_batch_dims``)

"dots" saves only the products of plain torch ops, the counterparts of
XLA's dots: a kernel entry (`kernels.entry`) is one opaque operation, as a
``pallas_call`` is to JAX's policies, so every SFC kernel call is
recomputed and never saved, on the card (a ctypes launch) and in its plain
version on the CPU alike.  Under "sfc_cuda" + "sfc" attention a decoder
layer therefore keeps only its input, as JAX's does.  JAX saves only the
dots its backward reads; a selective checkpoint keeps every product the
policy names, so where a unit ends in a product whose output only feeds
the unit's result (the MLP's ``w_out`` before the residual add under
"torch"), the port keeps that one output more than JAX does.

The recompute runs in the context the unit's forward saw.  On the card
autograd runs the backward, and so the recompute, on a device thread where
the port's context variables (the GEMM and attention backends, the ABFT
mode and step scope, the fused step's session and update config, the knob
defaults) are unset, and on every device the train step calls
``backward()`` after leaving them: the unit's forward takes a
`contextvars.copy_context` snapshot and the recompute runs in a copy of
it, marked by `kernels.entry.recomputing()` (the fused step's tape then
hands the recomputed projection the slot its forward took, `optim.fused`).
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from repro_torch.kernels.entry import inside_kernel_entry, mark_recompute

__all__ = ["REMAT_POLICIES", "check_policy", "remat_call", "RematStats", "remat_stats"]

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default})
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})

# policy -> the ops whose outputs a unit's forward saves (None: no remat)
REMAT_POLICIES: Dict[str, Optional[frozenset]] = {
    "none": None,
    "full": frozenset(),
    "dots": _DOTS,
    "dots_no_batch": _DOTS_NO_BATCH,
}

def check_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; pick from {tuple(REMAT_POLICIES)}")
    return policy


class RematStats:
    """What the remat units of a block of calls did (`remat_stats`):
    ``units`` run, their ``input_elements`` (the unit's tensor arguments)
    and ``saved_elements`` (the outputs the policy saved), and the
    ``recomputes``."""

    def __init__(self):
        self.units = 0
        self.recomputes = 0
        self.input_elements = 0
        self.saved_elements = 0


_STATS: contextvars.ContextVar[Optional[RematStats]] = contextvars.ContextVar("remat_stats", default=None)


class remat_stats:
    """``with remat_stats() as st:`` records the units of the forwards run
    inside the block (and, through the forward's context, their
    recomputes, wherever the backward runs) into ``st``."""

    def __enter__(self) -> RematStats:
        self.stats = RematStats()
        self._tok = _STATS.set(self.stats)
        return self.stats

    def __exit__(self, *exc) -> None:
        _STATS.reset(self._tok)


def _policy_fn(save_ops, stats, ctx, op, *args, **kwargs):
    if op in save_ops and not inside_kernel_entry():
        if stats is not None:
            out = getattr(ctx, "op_output", None)  # torch >= 2.8 hands the policy the output
            stats.saved_elements += out.numel() if isinstance(out, torch.Tensor) else 0
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _recompute(fn: Callable, *args):
    mark_recompute()
    stats = _STATS.get()
    if stats is not None:
        stats.recomputes += 1
    return fn(*args)


def remat_call(fn: Callable, policy: str, *args):
    """``fn(*args)`` as one remat unit under ``policy``.  ``args`` are the
    unit's activations (tensors); parameters and other inputs come through
    ``fn``'s closure.  With "none", or with grad mode off, this is
    ``fn(*args)``."""
    save_ops = REMAT_POLICIES[check_policy(policy)]
    if save_ops is None or not torch.is_grad_enabled():
        return fn(*args)
    snapshot = contextvars.copy_context()
    stats = _STATS.get()
    calls = [0]

    def unit(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        # the recompute, maybe on autograd's device thread: the forward's context
        return snapshot.copy().run(_recompute, fn, *a)

    kw = {}
    if save_ops:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             functools.partial(_policy_fn, save_ops, stats))
    # the whole unit recomputes: no early stop, whose exception would cross
    # the context's run on autograd's thread
    with set_checkpoint_early_stop(False):
        out = checkpoint(unit, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    if stats is not None:
        stats.units += 1
        stats.input_elements += sum(a.numel() for a in args if isinstance(a, torch.Tensor))
    return out
