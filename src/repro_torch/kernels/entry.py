"""Kernel entries as opaque units (the counterpart of a ``pallas_call`` to
JAX's checkpoint policies), and the flag of a recomputed forward.

Every public wrapper that launches a CUDA kernel on a CUDA tensor, or runs
its plain version on a CPU tensor, is decorated with `kernel_entry`.  While
one runs, `inside_kernel_entry()` is true on its thread, so the selective
recomputation of `models.remat` treats the whole call as one operation:
JAX's "dots" policy saves the outputs of ``dot_general`` and never of a
``pallas_call``, and the plain version's tile products (``torch.matmul``
on the CPU) must not be saved where the card's ctypes launch, invisible to
the dispatcher, saves nothing.

`recomputing()` is true while a remat unit's forward runs a second time,
in the backward (`models.remat` sets it in the context the recompute runs
in); the fused optimizer's tape reads it (`optim.fused`).
"""

from __future__ import annotations

import contextvars
import functools
import threading

__all__ = ["kernel_entry", "inside_kernel_entry", "recomputing", "mark_recompute"]

_STATE = threading.local()
_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar("remat_recomputing", default=False)


def kernel_entry(fn):
    """Mark ``fn`` as a kernel entry (see the module docstring)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        depth = getattr(_STATE, "depth", 0)
        _STATE.depth = depth + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.depth = depth

    return run


def inside_kernel_entry() -> bool:
    """Whether a kernel entry is running on this thread."""
    return getattr(_STATE, "depth", 0) > 0


def recomputing() -> bool:
    """Whether the calls being made are a remat unit's recomputed forward."""
    return _RECOMPUTING.get()


def mark_recompute() -> None:
    """Mark the current context as a recomputed forward's (call it in a
    context of the recompute's own: a `contextvars.Context.run`)."""
    _RECOMPUTING.set(True)
