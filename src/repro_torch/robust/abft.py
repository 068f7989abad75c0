"""ABFT checksum verification: detect silent data corruption in the SFC
GEMMs (the port's ``repro.robust.abft``).

The linear checksum ``sum(C) == (eᵀA)·(Be)`` holds for every contraction
the SFC kernels launch.  The kernels' checksum lane sums the raw f32
accumulators (before the epilogue, before the optimizer) tile by tile into
a per-task partials buffer that the wrapper sums on the device; the
operand-side reference is two rank-1 contractions (``O(MK + KN)`` reads
against the kernel's ``O(MNK)``).  A flipped bit perturbs one side and not
the other; roundoff perturbs both by ``O(eps)``, so a threshold relative to
the absolute-magnitude checksum and growing with the contraction depth
separates corruption from noise.

Modes, resolved per ladder namespace when a call is made (a contextvar
default, then per-namespace overrides, then the ``REPRO_ABFT`` environment
variable), as in the JAX package:

``"off"``     no lane and no check.
``"detect"``  a mismatch is reported (below).
``"strict"``  inside a step scope, the output of a mismatching call is also
              NaN-poisoned, so the non-finite guards stop it.

The JAX package reports through two channels, an eager raise for concrete
values and a ``jax.debug.callback`` into process counters under ``jit``.
Eager torch has no trace, so the second channel is a **step scope**
(`step_scope`), which the train step and the serving engine's verified
decode enter where JAX would be tracing:

* outside a scope, `verify` reads the residual and the tolerance to the
  host (one read a call) and raises `SdcDetected` on a mismatch;
* inside a scope, `verify` keeps the comparison on the device: it adds the
  mismatch flag into a per-namespace device counter (no host read a call)
  and under ``"strict"`` poisons the output with ``torch.where``; the
  scope's exit reads every counter at once into the runtime counters
  (`runtime_sdc_total`, `runtime_sdc_counts`).

Both channels also keep the largest residual-to-tolerance ratio of the
checks run (`runtime_max_ratio`, the margin against false positives; a NaN
residual, which is no detection, does not enter it) and their number
(`runtime_check_total`).

A detection outside a scope raises `SdcDetected`, which the fallback
ladder (`robust.ladder`) classifies as "sdc": it retries the op once on
the same rung, then quarantines it.  Detections counted in a scope are
mirrored into the ladder's health registry, as the JAX package's runtime
detections are, so ``degradation_report()`` covers them.  `InjectedSdc` is
the fault harness's detection (`robust.inject`, ``kind="bitflip"``); inside
a scope the harness records it with `record_injected` instead of raising.
The ``obs`` metrics ``abft.*`` and the ``abft/verify`` span are ROADMAP
item 15's.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.robust.inject import InjectedFault

__all__ = [
    "ABFT_MODES",
    "SdcDetected",
    "InjectedSdc",
    "abft_mode",
    "current_mode",
    "gemm_checksum_ref",
    "grouped_checksum_ref",
    "nt_checksum_ref",
    "tn_checksum_ref",
    "tolerance",
    "verify",
    "step_scope",
    "StepScope",
    "capture",
    "restored",
    "record_injected",
    "runtime_sdc_total",
    "runtime_sdc_counts",
    "runtime_max_ratio",
    "runtime_check_total",
    "reset_runtime_sdc",
]

ABFT_MODES = ("off", "detect", "strict")

# roundoff slack: both sides of the checksum accumulate in f32 but in
# different orders, so the residual of a clean run is O(eps32 * sqrt(ops))
# relative to the absolute-magnitude checksum.  Deliberately generous, as
# in the JAX package: a false positive stops a healthy step, a missed
# low-mantissa flip is numerically harmless.
_SLACK = 64.0


class SdcDetected(RuntimeError):
    """Checksum residual exceeded tolerance: silent data corruption."""

    def __init__(self, namespace: str, residual: float, tol: float):
        self.namespace = namespace
        self.residual = residual
        self.tol = tol
        super().__init__(
            f"ABFT checksum failure in {namespace!r}: residual {residual:.3e} exceeds tolerance "
            f"{tol:.3e} — silent data corruption detected"
        )


class InjectedSdc(SdcDetected, InjectedFault):
    """Synthetic SDC detection from the fault harness (``kind="bitflip"``
    with an ABFT mode active, outside a step scope).  Carries strict-mode
    amnesty like every injected fault."""

    def __init__(self, namespace: str, rung: str, call: int):
        SdcDetected.__init__(self, namespace, float("inf"), 0.0)
        # overwrite the SdcDetected message with the injection provenance
        self.args = (
            f"INJECTED ABFT checksum failure for {namespace}/{rung} "
            f"(call {call}): simulated accumulator bit flip",
        )


# ---------------------------------------------------------------------------
# mode resolution: contextvar default + per-namespace overrides
# ---------------------------------------------------------------------------

# (default mode or None = the environment, ((namespace, mode), ...))
_MODE: contextvars.ContextVar[Tuple[Optional[str], Tuple[Tuple[str, str], ...]]] = contextvars.ContextVar(
    "repro_torch_abft_mode", default=(None, ())
)


def _check(mode: str) -> str:
    if mode not in ABFT_MODES:
        raise ValueError(f"unknown abft mode {mode!r}; pick from {ABFT_MODES}")
    return mode


@contextlib.contextmanager
def abft_mode(mode: str, namespace: Optional[str] = None):
    """Set the ABFT mode: the default, or for one ladder namespace.  Nested
    contexts stack; an inner per-namespace override wins over an outer
    default."""
    _check(mode)
    default, overrides = _MODE.get()
    if namespace is None:
        tok = _MODE.set((mode, overrides))
    else:
        tok = _MODE.set((default, overrides + ((namespace, mode),)))
    try:
        yield
    finally:
        _MODE.reset(tok)


def current_mode(namespace: str) -> str:
    """Effective ABFT mode for a ladder namespace."""
    default, overrides = _MODE.get()
    for ns, mode in reversed(overrides):
        if ns == namespace:
            return mode
    if default is not None:
        return default
    env = os.environ.get("REPRO_ABFT", "off")
    return env if env in ABFT_MODES else "off"


# ---------------------------------------------------------------------------
# checksum math
# ---------------------------------------------------------------------------


def _abs_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 ``sum(|x|)`` over ``dim``, without a copy of ``|x|``."""
    return torch.linalg.vector_norm(x, 1, dim=dim, dtype=torch.float32)


def gemm_checksum_ref(
    a: torch.Tensor, b: torch.Tensor, b_gate: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ref, mag): the operand-side checksum of ``sum(A @ B)``, ``(eᵀA)·(Be)``,
    and its absolute-magnitude companion ``sum(|A| @ |B|)``, f32 scalars.
    Leading batch dims on either operand sum into the checksum (the kernel
    lane sums over the whole launch); with ``b_gate`` the dual-B (GLU)
    second accumulator is folded in."""
    ca = a.sum(dim=-2, dtype=torch.float32)
    rb = b.sum(dim=-1, dtype=torch.float32)
    ca_mag = _abs_sum(a, -2)
    rb_mag = _abs_sum(b, -1)
    if a.ndim > 2 and b.ndim == 2:
        # shared weights: fold the batch into the column sums first
        ca = ca.reshape(-1, ca.shape[-1]).sum(dim=0)
        ca_mag = ca_mag.reshape(-1, ca_mag.shape[-1]).sum(dim=0)
    ref = (ca * rb).sum()
    mag = (ca_mag * rb_mag).sum()
    if b_gate is not None:
        cg = b_gate.sum(dim=-1, dtype=torch.float32)
        cg_mag = _abs_sum(b_gate, -1)
        ref = ref + (ca * cg).sum()
        mag = mag + (ca_mag * cg_mag).sum()
    return ref, mag


@functools.lru_cache(maxsize=64)
def _row_experts(group_sizes: tuple, device: torch.device) -> torch.Tensor:
    """Each row's expert id, uploaded once per (group sizes, device), so a
    repeated dispatch (and a CUDA graph's capture of one) copies nothing."""
    ids = torch.repeat_interleave(torch.arange(len(group_sizes)), torch.tensor(group_sizes, dtype=torch.int64))
    return ids.to(device)


def grouped_checksum_ref(
    a: torch.Tensor, b: torch.Tensor, b_gate: Optional[torch.Tensor], group_sizes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ref, mag) of a grouped product: the (T, K) rows of ``a`` sorted by
    expert, expert e's ``group_sizes[e]`` rows against ``b[e]`` (and
    ``b_gate[e]``).  The sum of every expert's `gemm_checksum_ref`, as the
    JAX package sums them (an empty expert adds 0), with each expert's
    column sums taken by one segment sum over the rows' expert ids."""
    e_cnt, k = b.shape[0], b.shape[1]
    expert = _row_experts(tuple(int(g) for g in group_sizes), a.device)
    rows = a.to(torch.float32, copy=True)
    ca = torch.zeros((e_cnt, k), dtype=torch.float32, device=a.device).index_add_(0, expert, rows)
    ca_mag = torch.zeros_like(ca).index_add_(0, expert, rows.abs_())
    ref = (ca * b.sum(dim=-1, dtype=torch.float32)).sum()
    mag = (ca_mag * _abs_sum(b, -1)).sum()
    if b_gate is not None:
        ref = ref + (ca * b_gate.sum(dim=-1, dtype=torch.float32)).sum()
        mag = mag + (ca_mag * _abs_sum(b_gate, -1)).sum()
    return ref, mag


def nt_checksum_ref(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ref, mag) for the NT form ``sum(A @ Bᵀ)``: both operands store the
    contraction dim last, so the checksum is the dot of their column sums."""
    ca, cb = a.sum(dim=0, dtype=torch.float32), b.sum(dim=0, dtype=torch.float32)
    return (ca * cb).sum(), (_abs_sum(a, 0) * _abs_sum(b, 0)).sum()


def tn_checksum_ref(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ref, mag) for the TN form ``sum(Aᵀ @ B)``: the contraction runs over
    the shared row dim, so the checksum is the dot of the row sums."""
    ra, rb = a.sum(dim=1, dtype=torch.float32), b.sum(dim=1, dtype=torch.float32)
    return (ra * rb).sum(), (_abs_sum(a, 1) * _abs_sum(b, 1)).sum()


def tolerance(mag: torch.Tensor, contract_dim: int, cast_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Roundoff threshold of a checksum over a depth-``contract_dim``
    contraction: ``eps32 · 64 · √K · mag``, plus ``2 · eps(cast_dtype) ·
    mag`` for op-level checks that sum an output already cast to
    ``cast_dtype`` (the replicated and NT paths), plus 1e-30 so an all-zero
    problem cannot alarm.  The JAX package's expression, term for term."""
    eps = torch.finfo(torch.float32).eps
    k = max(int(contract_dim), 1)
    tol = eps * _SLACK * (k**0.5) * mag
    if cast_dtype is not None and cast_dtype.is_floating_point:
        tol = tol + 2.0 * torch.finfo(cast_dtype).eps * mag
    return tol + 1e-30


# ---------------------------------------------------------------------------
# runtime counters and the step scope
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_RUNTIME_SDC: Dict[str, int] = {}
_RUNTIME = {"checks": 0, "max_ratio": 0.0}


def _note(checks: int, ratio: float, bad: Dict[str, int]) -> None:
    with _LOCK:
        _RUNTIME["checks"] += checks
        if ratio == ratio:  # a NaN residual is no detection and no margin
            _RUNTIME["max_ratio"] = max(_RUNTIME["max_ratio"], ratio)
        for ns, n in bad.items():
            if n:
                _RUNTIME_SDC[ns] = _RUNTIME_SDC.get(ns, 0) + n
    if any(bad.values()):
        # mirror into the health registry so degradation_report() covers it
        from repro_torch.robust.ladder import get_registry

        reg = get_registry()
        for ns, n in bad.items():
            for _ in range(n):
                reg.record_sdc(ns, healed=False)


def runtime_sdc_total() -> int:
    """Detections in step scopes of this process."""
    with _LOCK:
        return sum(_RUNTIME_SDC.values())


def runtime_sdc_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_RUNTIME_SDC)


def runtime_max_ratio() -> float:
    """The largest residual / tolerance of any check since the last reset
    (eager or in a step scope): how far the cleanest run came to a false
    positive; below 1 means no check alarmed."""
    with _LOCK:
        return _RUNTIME["max_ratio"]


def runtime_check_total() -> int:
    """Checks run since the last reset (eager and in step scopes)."""
    with _LOCK:
        return _RUNTIME["checks"]


def reset_runtime_sdc() -> None:
    with _LOCK:
        _RUNTIME_SDC.clear()
        _RUNTIME.update(checks=0, max_ratio=0.0)


class StepScope:
    """A step's device-side ledger: each check's mismatch flag and ratio,
    counted by namespace and maxed on the device and read to the host once,
    at the scope's exit; then
    ``detections`` ({namespace: count}, the namespaces that mismatched) and
    ``max_ratio`` hold this step's share of the runtime counters.  The exit
    closes the scope: a check made in it later (a backward run after the
    step's scope exited) takes the eager channel, so no detection is lost."""

    def __init__(self):
        self.closed = False
        self.bad: Dict[str, List[torch.Tensor]] = {}
        self.ratios: List[torch.Tensor] = []
        self.checks = 0
        self.injected: Dict[str, int] = {}  # the fault harness's detections, on the host
        self.detections: Dict[str, int] = {}
        self.max_ratio = 0.0

    def record(self, namespace: str, bad: torch.Tensor, ratio: torch.Tensor) -> None:
        # kept, and summed at the flush: a check runs the same device ops
        # whatever was recorded before it, so a remat unit's recomputed
        # forward replays its forward's ops (`models.remat`)
        self.bad.setdefault(namespace, []).append(bad.to(torch.float32))
        self.ratios.append(ratio)
        self.checks += 1

    def record_injected(self, namespace: str) -> None:
        """An injected detection (`robust.inject`, "bitflip"): counted at
        the flush as a device check's would be, entering no ratio."""
        self.injected[namespace] = self.injected.get(namespace, 0) + 1

    def flush(self) -> None:
        if not self.checks:
            if self.injected:
                self.detections = dict(self.injected)
                _note(0, float("nan"), self.detections)
            return
        names = list(self.bad)
        ratios = torch.stack(self.ratios)
        dev = ratios.device
        # fmax over the checks: NaN only where every ratio is NaN
        top = torch.where(ratios.isnan().all(), ratios.new_full((), float("nan")),
                          ratios.nan_to_num(nan=float("-inf")).max())
        counts = [torch.stack(self.bad[n]).to(dev).sum() for n in names]
        vals = torch.stack(counts + [top]).tolist()  # the one host read
        self.detections = {n: int(v) for n, v in zip(names, vals[:-1]) if v}
        for n, v in self.injected.items():
            self.detections[n] = self.detections.get(n, 0) + v
        self.max_ratio = vals[-1] if vals[-1] == vals[-1] else 0.0
        _note(self.checks, vals[-1], self.detections)


_SCOPE: contextvars.ContextVar[Optional[StepScope]] = contextvars.ContextVar("repro_torch_abft_scope", default=None)


@contextlib.contextmanager
def step_scope():
    """The step-level detection channel (JAX: the traced program).  Checks
    made inside count on the device, and the exit adds them to the runtime
    counters with one host read; nothing raises for a mismatch.  Yields the
    `StepScope`, whose ``detections`` and ``max_ratio`` are this step's
    after the exit.  A scope entered inside another is the outer one."""
    outer = _SCOPE.get()
    if outer is not None and not outer.closed:
        yield outer
        return
    scope = StepScope()
    tok = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(tok)
        scope.closed = True
    scope.flush()  # not after an exception: the step's results are gone


def record_injected(namespace: str) -> bool:
    """Record an injected detection in the open step scope, if there is
    one; returns whether it was recorded (else the harness raises)."""
    scope = _SCOPE.get()
    if scope is None or scope.closed:
        return False
    scope.record_injected(namespace)
    return True


def capture():
    """The ambient ABFT state: the mode context and the step scope."""
    return _MODE.get(), _SCOPE.get()


@contextlib.contextmanager
def restored(state):
    """Re-enter a `capture`d ABFT state.  On the card autograd runs a
    backward on a device thread of its own, where the caller's context
    variables are unset: a custom Function's backward re-enters its
    forward's state, so that its launches check as JAX's, traced in the
    same step, do.  A scope that has exited since is closed, and the
    backward's checks then raise eagerly (`verify`)."""
    mode, scope = state
    tok_mode, tok_scope = _MODE.set(mode), _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(tok_scope)
        _MODE.reset(tok_mode)


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------


def _nan_where(out, bad: torch.Tensor):
    """NaN-poison every floating tensor of ``out`` (a tensor or a nested
    tuple / list of them) where ``bad``."""
    if isinstance(out, (tuple, list)):
        return type(out)(_nan_where(x, bad) for x in out)
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return torch.where(bad, torch.full((), float("nan"), dtype=out.dtype, device=out.device), out)
    return out


def verify(
    namespace: str,
    out,
    chk: torch.Tensor,
    ref: torch.Tensor,
    mag: torch.Tensor,
    *,
    contract_dim: int,
    mode: str,
    cast_dtype: Optional[torch.dtype] = None,
):
    """Compare the kernel-side checksum ``chk`` with the operand-side
    ``ref``; return ``out`` (NaN-poisoned under ``"strict"`` in a step
    scope).  Outside a step scope (or in one that has exited) a mismatch
    raises `SdcDetected`; inside one it is counted on the device.  A NaN residual compares false: no
    detection, as in the JAX package."""
    if mode == "off":
        return out
    _check(mode)
    tol = tolerance(mag, contract_dim, cast_dtype)
    resid = (chk.to(torch.float32) - ref).abs()
    scope = _SCOPE.get()
    if scope is not None and not scope.closed:
        bad = resid > tol
        scope.record(namespace, bad, resid / tol)
        return _nan_where(out, bad) if mode == "strict" else out
    r, t = torch.stack([resid, tol.to(resid.device)]).tolist()  # the one host read
    _note(1, r / t, {})
    if r > t:
        raise SdcDetected(namespace, r, t)
    return out
