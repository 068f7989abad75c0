"""Deterministic fault injection for the fallback ladder (the port's
``repro.robust.inject``).

A contextvar harness that makes routed ops raise synthetic compile errors
or OOM, or poison their outputs with NaN or a flipped bit, at chosen call
indices, so the ladder, quarantine and recovery paths in `robust.ladder`
are all differentially testable without real hardware failures.

    with fault_injection(FaultSpec("gemm", kind="compile")):
        y = matmul(x, w)          # the sfc_cuda rung raises, the ladder heals

Call counting is per *namespace* and advances once per
`run_with_fallback` invocation.  The JAX package counts at trace time, so
a cached trace is not faulted again; the port runs eagerly and counts
every call.

A "bitflip" with ABFT on models a checksum mismatch.  Outside a step
scope it raises `abft.InjectedSdc`, as JAX's does at trace time; inside
one (`abft.step_scope`: the train step, the engine's verified decode) it
records an injected detection in the scope, which the scope's exit counts
as a real one would be, so the engine's redo and the train loop's
rollback run on the path real SDC takes.  The JAX package raises at trace
time there too; the port's counterpart of its traced program is the
scope.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import fnmatch
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.namespaces import KERNEL_RUNGS as _KERNEL_RUNGS

__all__ = [
    "InjectedFault",
    "InjectedCompileError",
    "InjectedResourceExhausted",
    "FaultSpec",
    "InjectionState",
    "fault_injection",
    "injection_active",
    "begin_call",
    "check",
]


class InjectedFault(Exception):
    """Base class for synthetic failures raised by the harness.

    The ladder grants injected failures strict-mode amnesty: a fallback
    caused by an `InjectedFault` never trips ``REPRO_STRICT``.
    """


class InjectedCompileError(InjectedFault):
    """Synthetic lowering failure (classified as ``compile``); the message
    is the JAX package's, so both packages classify it alike."""

    def __init__(self, namespace: str, rung: str, call: int):
        super().__init__(
            f"INJECTED Mosaic lowering failed for {namespace}/{rung} "
            f"(call {call}): Unsupported operation in kernel body"
        )


class InjectedResourceExhausted(InjectedFault):
    """Synthetic device OOM (classified as ``oom``)."""

    def __init__(self, namespace: str, rung: str, call: int):
        super().__init__(
            f"INJECTED RESOURCE_EXHAUSTED for {namespace}/{rung} "
            f"(call {call}): ran out of memory allocating scratch"
        )


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    namespace: fnmatch pattern over ladder namespaces ("gemm", "attn_*",
        "*", ...).
    kind: "compile" (raise InjectedCompileError), "oom" (raise
        InjectedResourceExhausted), "nan" (poison the rung's floating
        outputs with NaN: exercises the nonfinite-update guardrails, not
        the ladder), or "bitflip" (silent data corruption: with ABFT
        active an injected detection, see the module docstring; with ABFT
        off it flips bit ``bit`` of one output element, the negative
        control that goes undetected).
    calls: call indices (per namespace, 0-based) to fault; None = every
        call.
    rungs: fnmatch patterns over rung names to fault (default: the
        kernel rungs, "sfc_cuda" and "replicated"); None = every rung.
    fires: max number of times this spec fires in total; None =
        unlimited.  ``fires=1`` models a transient flip: the ladder's
        retry-once on the same rung succeeds.
    bit: which bit of the f32 bit pattern to flip for "bitflip".
    """

    namespace: str
    kind: str = "compile"
    calls: Optional[Tuple[int, ...]] = None
    rungs: Optional[Tuple[str, ...]] = _KERNEL_RUNGS
    fires: Optional[int] = None
    bit: int = 30

    def __post_init__(self):
        if self.kind not in ("compile", "oom", "nan", "bitflip"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.calls is not None:
            object.__setattr__(self, "calls", tuple(self.calls))
        if self.rungs is not None:
            object.__setattr__(self, "rungs", tuple(self.rungs))

    def matches(self, namespace: str, rung: str, call: int) -> bool:
        if not fnmatch.fnmatchcase(namespace, self.namespace):
            return False
        if self.calls is not None and call not in self.calls:
            return False
        if self.rungs is not None and not any(
            fnmatch.fnmatchcase(rung, pat) for pat in self.rungs
        ):
            return False
        return True


class InjectionState:
    """Active specs plus deterministic per-namespace call counters."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = tuple(specs)
        self.calls: dict = {}  # namespace -> number of ladder invocations
        self.fired: list = []  # (namespace, rung, call, kind) log
        self.fire_counts: dict = {}  # spec index -> times fired

    def begin_call(self, namespace: str) -> int:
        idx = self.calls.get(namespace, 0)
        self.calls[namespace] = idx + 1
        return idx

    def check(self, namespace: str, rung: str, call: int):
        """Raise / return a poison fn if a spec targets this attempt."""
        for i, spec in enumerate(self.specs):
            if not spec.matches(namespace, rung, call):
                continue
            if spec.fires is not None and self.fire_counts.get(i, 0) >= spec.fires:
                continue
            self.fire_counts[i] = self.fire_counts.get(i, 0) + 1
            self.fired.append((namespace, rung, call, spec.kind))
            if spec.kind == "compile":
                raise InjectedCompileError(namespace, rung, call)
            if spec.kind == "oom":
                raise InjectedResourceExhausted(namespace, rung, call)
            if spec.kind == "bitflip":
                from repro_torch.robust import abft

                if abft.current_mode(namespace) != "off":
                    if abft.record_injected(namespace):
                        return None  # counted in the step scope: the output stays clean
                    raise abft.InjectedSdc(namespace, rung, call)
                return functools.partial(_bitflip_poison, bit=spec.bit)
            return _nan_poison
        return None


_STATE: contextvars.ContextVar[Optional[InjectionState]] = contextvars.ContextVar(
    "repro_torch_fault_injection", default=None
)


@contextlib.contextmanager
def fault_injection(*specs: FaultSpec):
    """Activate fault specs; yields the InjectionState for inspection."""
    state = InjectionState(specs)
    token = _STATE.set(state)
    try:
        yield state
    finally:
        _STATE.reset(token)


def injection_active() -> bool:
    return _STATE.get() is not None


def begin_call(namespace: str) -> int:
    """Advance the per-namespace ladder-invocation counter."""
    state = _STATE.get()
    if state is None:
        return -1
    return state.begin_call(namespace)


def check(namespace: str, rung: str, call: int) -> Optional[Callable]:
    """Fault this rung attempt if a spec targets it.

    Raises an `InjectedFault` for "compile"/"oom" kinds (and an
    `abft.InjectedSdc` for "bitflip" with ABFT on, outside a step scope);
    returns an output-poisoning transform for "nan" (and "bitflip" with
    ABFT off); returns None when clean.
    """
    state = _STATE.get()
    if state is None:
        return None
    return state.check(namespace, rung, call)


def _floating_leaves(out):
    """Every floating tensor of ``out`` (a tensor or a nested tuple /
    list), in order."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [leaf for x in out for leaf in _floating_leaves(x)]
    return []


def _map_floating(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out) if out.is_floating_point() else out
    if isinstance(out, (tuple, list)):
        return type(out)(_map_floating(x, fn) for x in out)
    return out


def _nan_poison(out):
    """Poison every floating tensor of a rung output with NaN."""
    return _map_floating(out, lambda x: x * torch.full((), float("nan"), dtype=x.dtype, device=x.device))


def _bitflip_poison(out, *, bit: int = 30):
    """Flip one bit of the first non-empty floating tensor's first element
    (its f32 bit pattern, cast back to the tensor's type).

    Models undetected SDC for the ABFT-off negative control: a single
    corrupted value that no guardrail notices (bit 30 of the f32 pattern
    perturbs the exponent, so the damage is large but finite)."""
    target = next((x for x in _floating_leaves(out) if x.numel()), None)
    if target is None:
        return out

    def flip(x):
        if x is not target:
            return x
        flat = x.reshape(-1).to(torch.float32).clone()
        bits = flat[:1].view(torch.int32) ^ torch.tensor(1 << bit, dtype=torch.int64).to(torch.int32)
        flat[:1] = bits.view(torch.float32)
        return flat.reshape(x.shape).to(x.dtype)

    return _map_floating(out, flip)
