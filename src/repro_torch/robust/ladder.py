"""Fallback ladder + health registry: the one degradation mechanism (the
port's ``repro.robust.ladder``).

`run_with_fallback` tries each rung of a ladder in order (``sfc_cuda →
replicated (fuse=False) → sfc_reference → torch``) and advances only on
*classified* failures: a launch the runtime refused at this shape, device
OOM, the JAX package's lowering / resource / interpret markers, and the
synthetic faults from `robust.inject`.  Anything else re-raises; the
ladder heals platform breakage, it does not hide bugs.

A failing ``(namespace, rung, shape-class)`` is quarantined in the
process-wide :class:`HealthRegistry` so later calls skip it instead of
retrying forever; a re-tune that confirms a winner lifts its namespace's
quarantines (`tune.tuner.tune_gemm`).  The registry round-trips through the
knob cache (``__health__|…`` entries) so a replica restarting after a crash
remembers what was broken.

Where it differs from the JAX module:

* **The walk runs on every call.**  JAX walks at trace time and pays
  nothing once the trace is cached; the port is eager.  With no quarantine
  and no injection active the walk is one call of the first rung and one
  count on the ledger and its mirror in the process registry (a label key
  built once per namespace and rung): no lock, no shape key, no closure
  when the call site keeps its rungs in a table (``args``).  The counts
  have one writer at a time (`obs.metrics.Counter.inc_key`): the thread
  that runs the model, or autograd's device thread while it waits.
* **Strict on the card by default.**  A degradation whose served output
  lies on a CUDA device raises `StrictFallbackError` unless
  ``REPRO_ALLOW_FALLBACK=1`` asks for it, so that no caller times plain
  PyTorch believing it ran the kernels; injected faults keep their
  amnesty.  On CPU tensors the JAX package's silent descent holds, and
  ``REPRO_STRICT=1`` makes it strict there too.
* **The card's failures are classified by type** (`classify_failure`): a
  `kernels.build.KernelLaunchError` by its CUDA code, ``torch.
  OutOfMemoryError``.  A sticky CUDA error (an illegal address, a
  device-side assert, a launch failure or timeout) leaves the context
  dead, so no rung on the same device could serve: it is never
  classified and re-raises.  Neither is a failed build
  (`kernels.build.KernelBuildError`): a port whose kernels did not build
  must not quietly serve on a lower rung.
* **No retry or descent after an in-place write.**  JAX retries a rung
  after "sdc" because its state is never mutated.  A ladder whose rungs
  write state in place (the fused optimizer's update flush) passes
  ``in_place=True``: only a failure that comes before any write (an
  injected fault, raised before the rung runs, or a `KernelLaunchError`,
  whose kernel never ran) moves it on; any other, a detection included,
  re-raises to the step, whose rollback
  (`train.fault_tolerance.CorruptionPolicy`) restores the state.
* ``VmemBudgetError`` has no counterpart: the port plans no VMEM (its
  kernels loop over K inside one CTA).  The "planned" flag of a record is
  kept for records the knob cache holds.
* **The ``ladder/run`` span times every call** (JAX: once a trace), the
  healthy path included, with no allocation or label there: two clock
  reads and one unlocked histogram store (`obs.trace.observe_since`);
  a `obs.span` only while a torch profiler records.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.namespaces import DEFAULT_LADDER, KERNEL_RUNGS
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject
from repro_torch.robust.abft import SdcDetected
from repro_torch.robust.inject import InjectedFault

__all__ = [  # DEFAULT_LADDER / KERNEL_RUNGS re-exported from the registry
    "DEFAULT_LADDER",
    "KERNEL_RUNGS",
    "FallbackError",
    "StrictFallbackError",
    "SdcDetected",
    "strict_mode",
    "classify_failure",
    "QuarantineRecord",
    "HealthRegistry",
    "get_registry",
    "degradation_report",
    "run_with_fallback",
]


class FallbackError(RuntimeError):
    """Every rung of a ladder failed or was quarantined."""


class StrictFallbackError(RuntimeError):
    """A non-injected fallback occurred where none is allowed: on the card
    without ``REPRO_ALLOW_FALLBACK=1``, or anywhere under ``REPRO_STRICT=1``."""


def _set(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def strict_mode(on_card: bool = False) -> bool:
    """Whether a non-injected degradation raises: always under
    ``REPRO_STRICT=1``; for work on a CUDA device (``on_card``) unless
    ``REPRO_ALLOW_FALLBACK=1``."""
    return _set("REPRO_STRICT") or (on_card and not _set("REPRO_ALLOW_FALLBACK"))


def refuses_degradation(injected: bool, on_card: bool) -> bool:
    """Whether a degradation caused by a fault (``injected``: the harness's)
    must raise instead of serving a lower rung: strict mode, and no
    injection to grant amnesty."""
    return not injected and strict_mode(on_card) and not inject.injection_active()


def _on_card(out) -> bool:
    """Whether a rung's output lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    return False


# ---------------------------------------------------------------------------
# failure classification
# ---------------------------------------------------------------------------

# the JAX package's markers, so that the same exceptions classify alike
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "VMEM",
    "vmem budget",
    "ran out of memory",
    "Ran out of memory",
    "out of memory",
)
_COMPILE_MARKERS = (
    "Mosaic",
    "mosaic",
    "lowering",
    "Lowering",
    "Unsupported",
    "unsupported",
    "INTERNAL: Generating",
)
_INTERPRET_MARKERS = (
    "Bounds check",
    "out-of-bounds",
    "Out-of-bounds",
    "must be divisible",
    "not divisible",
    "block shape",
)

# cudaError_t codes (driver_types.h) a launch may return.  Every other code
# is left unclassified, the sticky ones first of all (214 ECC, 700 illegal
# address, 702 launch timeout, 710 device-side assert, 714-718 stack,
# instruction, alignment, address space, PC, 719 launch failure): the
# context is unusable after them, so no rung on the device could serve.
CUDA_OOM = frozenset({2})  # cudaErrorMemoryAllocation
# a launch rejected at this shape: the card's counterpart of a lowering failure
CUDA_COMPILE = frozenset({
    1,    # cudaErrorInvalidValue
    9,    # cudaErrorInvalidConfiguration
    98,   # cudaErrorInvalidDeviceFunction
    209,  # cudaErrorNoKernelImageForDevice
    701,  # cudaErrorLaunchOutOfResources
    720,  # cudaErrorCooperativeLaunchTooLarge
    912,  # cudaErrorInvalidClusterSize
})
# torch's own messages for the sticky errors (it raises them untyped)
_STICKY_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "the launch timed out",
    "misaligned address",
    "illegal instruction",
)


def classify_failure(exc: BaseException) -> Optional[str]:
    """Map an exception to a ladder-classified kind, or None (re-raise).

    "sdc" for ABFT checksum mismatches (`SdcDetected`, the injected
    variant included); "oom" and "compile" for the injected faults, device
    OOM (``torch.OutOfMemoryError``, a launch failing with
    ``cudaErrorMemoryAllocation``) and a launch refused at its shape (too
    many resources, an invalid configuration or value, no kernel image, a
    cluster that cannot be scheduled; `CUDA_COMPILE`); then the JAX
    package's: NotImplementedError is "compile", its markers "oom",
    "compile" and "interpret", and an AssertionError "interpret".  Never
    classified: a launch error of any other code (the sticky ones among
    them), torch's message for a sticky error, and a failed build
    (`kernels.build.KernelBuildError`).
    """
    if isinstance(exc, SdcDetected):
        return "sdc"
    if isinstance(exc, inject.InjectedResourceExhausted):
        return "oom"
    if isinstance(exc, inject.InjectedCompileError):
        return "compile"
    if isinstance(exc, KernelBuildError):
        return None
    if isinstance(exc, KernelLaunchError):
        if exc.code in CUDA_OOM:
            return "oom"
        if exc.code in CUDA_COMPILE:
            return "compile"
        return None
    if isinstance(exc, torch.OutOfMemoryError):
        return "oom"
    if isinstance(exc, NotImplementedError):
        return "compile"
    msg = str(exc)
    if any(m in msg for m in _STICKY_MARKERS):
        return None
    if any(m in msg for m in _OOM_MARKERS):
        return "oom"
    if any(m in msg for m in _COMPILE_MARKERS):
        return "compile"
    if isinstance(exc, AssertionError) or any(m in msg for m in _INTERPRET_MARKERS):
        return "interpret"
    return None


# ---------------------------------------------------------------------------
# health registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuarantineRecord:
    namespace: str
    rung: str
    shape: Optional[str]
    reason: str
    injected: bool = False
    planned: bool = False
    count: int = 1
    error: str = ""

    def as_dict(self) -> Dict:
        return {
            "namespace": self.namespace,
            "rung": self.rung,
            "shape": self.shape,
            "reason": self.reason,
            "injected": self.injected,
            "planned": self.planned,
            "count": self.count,
            "error": self.error,
        }


def _qkey(namespace: str, rung: str, shape: Optional[str]) -> str:
    return f"{namespace}|{rung}|{shape if shape is not None else '*'}"


class HealthRegistry:
    """Per-process quarantine + serving ledger for the fallback ladder.

    Quarantine is keyed ``(namespace, rung, shape-class)``; a record with
    shape ``None`` quarantines the rung for every shape in the namespace
    (the serving engine uses this after a classified runtime failure or a
    detection).  `clear(namespace=...)` lifts quarantines: the re-tune
    path calls it after fresh knobs land, so a broken (backend, knobs,
    shape) combination is retried only once it has been re-tuned.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._quarantine: Dict[str, QuarantineRecord] = {}
        # the serving/SDC ledger lives in a private always-on metrics store:
        # degradation_report() is a view over it, and it cannot go dark
        # under REPRO_OBS=0.  Every write is mirrored into the gated process
        # registry so an exporter sees the same series.
        self._store = obs_metrics.Registry()
        self._served = self._store.counter("ladder.served")
        self._fallback = self._store.counter("ladder.fallback")
        self._served_keys: Dict[Tuple[str, str], Tuple] = {}

    # -- quarantine ---------------------------------------------------------

    def quarantine(
        self,
        namespace: str,
        rung: str,
        shape: Optional[str],
        reason: str,
        *,
        injected: bool = False,
        planned: bool = False,
        error: Optional[BaseException] = None,
    ) -> QuarantineRecord:
        key = _qkey(namespace, rung, shape)
        with self._lock:
            rec = self._quarantine.get(key)
            if rec is None:
                rec = QuarantineRecord(
                    namespace,
                    rung,
                    shape,
                    reason,
                    injected=injected,
                    planned=planned,
                    error="" if error is None else str(error)[:200],
                )
                self._quarantine[key] = rec
            else:
                rec.count += 1
                rec.reason = reason
                rec.injected = rec.injected and injected
                rec.planned = rec.planned and planned
        obs_metrics.inc("ladder.quarantine", namespace=namespace, rung=rung, reason=reason)
        return rec

    def get_quarantine(self, namespace: str, rung: str, shape: Optional[str]) -> Optional[QuarantineRecord]:
        with self._lock:
            rec = self._quarantine.get(_qkey(namespace, rung, shape))
            if rec is None and shape is not None:
                rec = self._quarantine.get(_qkey(namespace, rung, None))
            return rec

    def is_quarantined(self, namespace: str, rung: str, shape: Optional[str]) -> bool:
        return self.get_quarantine(namespace, rung, shape) is not None

    def clear(self, namespace: Optional[str] = None, rung: Optional[str] = None) -> int:
        """Lift quarantines (all, per namespace, or per namespace+rung)."""
        with self._lock:
            keys = [
                k
                for k, r in self._quarantine.items()
                if (namespace is None or r.namespace == namespace) and (rung is None or r.rung == rung)
            ]
            for k in keys:
                del self._quarantine[k]
            return len(keys)

    # -- serving ledger -----------------------------------------------------

    def record_served(self, namespace: str, rung: str, *, degraded: bool = False) -> None:
        """Count a call served by ``rung`` (and a fallback when
        ``degraded``) on the ledger and, when the gate is open, in the
        process registry: the same label key, built once per (namespace,
        rung), and no lock (one writer at a time)."""
        key = self._served_keys.get((namespace, rung))
        if key is None:
            key = self._served_keys[(namespace, rung)] = obs_metrics._label_key(
                {"namespace": namespace, "rung": rung})
        self._served.inc_key(key)
        if obs_metrics.enabled():
            # the registry's lookup inlined, as `obs.trace.observe_since`'s
            mirror = obs_metrics._REGISTRY._metrics.get("ladder.served")
            if type(mirror) is not obs_metrics.Counter:
                mirror = obs_metrics.registry().counter("ladder.served")
            mirror.inc_key(key)
        if degraded:
            self._fallback.inc(namespace=namespace)
            obs_metrics.inc("ladder.fallback", namespace=namespace)

    def record_sdc(self, namespace: str, *, healed: bool) -> None:
        """Count an ABFT detection (``healed=False``) or a successful
        same-rung retry after one (``healed=True``)."""
        state = "healed" if healed else "detected"
        self._store.counter("ladder.sdc").inc(namespace=namespace, state=state)
        obs_metrics.inc("ladder.sdc", namespace=namespace, state=state)

    def _served_view(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for key, v in self._served.series().items():
            labels = dict(key)
            out.setdefault(labels["namespace"], {})[labels["rung"]] = int(v)
        return out

    def _sdc_view(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for key, v in self._store.counter("ladder.sdc").series().items():
            labels = dict(key)
            per_ns = out.setdefault(labels["namespace"], {"detected": 0, "healed": 0})
            per_ns[labels["state"]] = int(v)
        return out

    def sdc_counts(self) -> Dict[str, Dict[str, int]]:
        return self._sdc_view()

    def quarantined_namespaces(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted({r.namespace for r in self._quarantine.values()}))

    def degradation_report(self, namespaces: Optional[Sequence[str]] = None) -> Dict:
        """Summarise what served and what is quarantined.

        ``namespaces`` optionally filters to a prefix-or-exact match set
        (e.g. the GEMM backend reports only its own namespaces); the
        totals are the whole process's, as in the JAX package.
        """

        def keep(ns: str) -> bool:
            if namespaces is None:
                return True
            return any(ns == n or ns.startswith(n) for n in namespaces)

        served = self._served_view()
        sdc = self._sdc_view()
        with self._lock:
            quarantined = [rec.as_dict() for key, rec in sorted(self._quarantine.items()) if keep(rec.namespace)]
        return {
            "strict": strict_mode(),
            "total_calls": int(self._served.total()),
            "fallback_calls": int(self._fallback.total()),
            "served": {ns: dict(rungs) for ns, rungs in sorted(served.items()) if keep(ns)},
            "quarantined": quarantined,
            "sdc": {ns: dict(counts) for ns, counts in sorted(sdc.items()) if keep(ns)},
        }

    def reset(self) -> None:
        with self._lock:
            self._quarantine.clear()
            self._store.reset()
            self._served = self._store.counter("ladder.served")
            self._fallback = self._store.counter("ladder.fallback")

    # -- persistence (knob-cache round trip) --------------------------------

    def export_state(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: r.as_dict() for k, r in self._quarantine.items()}

    def load_state(self, state: Dict[str, Dict]) -> None:
        with self._lock:
            for key, d in state.items():
                try:
                    rec = QuarantineRecord(
                        namespace=d["namespace"],
                        rung=d["rung"],
                        shape=d.get("shape"),
                        reason=d.get("reason", "unknown"),
                        injected=bool(d.get("injected", False)),
                        planned=bool(d.get("planned", False)),
                        count=int(d.get("count", 1)),
                        error=str(d.get("error", "")),
                    )
                except (KeyError, TypeError, ValueError):
                    continue  # malformed persisted entry: drop, don't crash
                self._quarantine[key] = rec

    def save_to_cache(self, cache) -> None:
        """Persist quarantines as ``__health__|…`` knob-cache entries."""
        cache.put_health(self.export_state())

    def load_from_cache(self, cache) -> None:
        self.load_state(cache.get_health())


_REGISTRY = HealthRegistry()


def get_registry() -> HealthRegistry:
    return _REGISTRY


def degradation_report(namespaces: Optional[Sequence[str]] = None) -> Dict:
    return _REGISTRY.degradation_report(namespaces)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

ShapeKey = Union[None, str, Callable[..., Optional[str]]]
_LADDER_SPAN = "span.ladder/run_us"


def run_with_fallback(
    namespace: str,
    rungs: Sequence[Tuple[str, Callable[..., object]]],
    *,
    args: Tuple = (),
    shape_key: ShapeKey = None,
    registry: Optional[HealthRegistry] = None,
    in_place: bool = False,
):
    """Run the first healthy rung; degrade on classified failures.

    ``rungs`` is an ordered sequence of ``(rung_name, thunk)`` pairs,
    conventionally a suffix of :data:`DEFAULT_LADDER`.  Quarantined rungs
    are skipped without retrying; a rung that fails with a classified error
    is quarantined for this ``(namespace, rung, shape_key)`` and the next
    rung runs.  The one exception is "sdc" (an ABFT checksum mismatch): SDC
    is usually a transient flip, so the same rung is retried once before
    quarantining.  Unclassified exceptions propagate immediately.
    ``in_place``: the rungs write state in place, so once a rung has run
    only an injected fault (raised before it runs) or a
    `KernelLaunchError` (its kernel never ran) may retry or descend; any
    other failure, a detection included, re-raises.  ``shape_key`` is a
    string or a callable giving one, called only when the walk needs it
    (a quarantine exists, or a rung failed).  Each thunk, and a callable
    ``shape_key``, is called with ``*args`` (none in the JAX package): a
    call site can then keep its rungs in a constant table instead of
    building closures on every call.

    A degradation whose causes were not all injected raises
    :class:`StrictFallbackError` instead of serving a lower rung when the
    served output lies on a CUDA device (unless ``REPRO_ALLOW_FALLBACK=1``)
    and, for any device, under ``REPRO_STRICT=1`` (`strict_mode`).
    Raises :class:`FallbackError` when every rung is exhausted.

    Timed as the ``ladder/run`` span.
    """
    if not obs_metrics.enabled():
        return _run(namespace, rungs, args, registry, shape_key, in_place)
    if obs_trace.profiling():
        with obs_trace.span("ladder/run"):
            return _run(namespace, rungs, args, registry, shape_key, in_place)
    t0 = time.perf_counter()
    try:
        return _run(namespace, rungs, args, registry, shape_key, in_place)
    finally:
        obs_trace.observe_since(_LADDER_SPAN, t0)


def _run(namespace, rungs, args, registry: Optional[HealthRegistry], shape_key: ShapeKey, in_place: bool):
    reg = registry if registry is not None else _REGISTRY
    if not reg._quarantine and inject._STATE.get() is None:
        # the healthy path: no quarantine to consult, nothing injected
        rung, thunk = rungs[0]
        try:
            out = thunk(*args)
        except Exception as exc:  # noqa: BLE001 — classified in the walk
            if classify_failure(exc) is None:
                raise
            return _walk_ladder(namespace, rungs, args, reg, shape_key, in_place, first_error=exc)
        reg.record_served(namespace, rung)
        return out
    return _walk_ladder(namespace, rungs, args, reg, shape_key, in_place)


def _walk_ladder(namespace, rungs, args, reg: HealthRegistry, shape_key: ShapeKey, in_place: bool, *,
                 first_error: Optional[BaseException] = None):
    if callable(shape_key):
        shape_key = shape_key(*args)
    call = inject.begin_call(namespace)
    failures = []
    degraded = False
    benign_only = True
    for i, (rung, thunk) in enumerate(rungs):
        rec = reg.get_quarantine(namespace, rung, shape_key)
        if rec is not None:
            degraded = True
            benign_only = benign_only and (rec.injected or rec.planned)
            continue
        failed = None  # (kind, exc) once both attempts are spent
        for attempt in (0, 1):
            ran = first_error is not None and i == 0 and attempt == 0
            try:
                if ran:
                    raise first_error  # the healthy path's attempt, already made
                poison = inject.check(namespace, rung, call)
                ran = True
                out = thunk(*args)
                if poison is not None:
                    out = poison(out)
            except Exception as exc:  # noqa: BLE001 — classified below
                kind = classify_failure(exc)
                if kind is None:
                    raise
                if kind == "sdc":
                    reg.record_sdc(namespace, healed=False)
                if in_place and ran and not isinstance(exc, KernelLaunchError):
                    raise  # the state may be written: the step's rollback restores it
                if kind == "sdc" and attempt == 0:
                    continue  # transient flip? retry the same rung
                failed = (kind, exc)
            else:
                if attempt == 1:
                    reg.record_sdc(namespace, healed=True)
            break
        if failed is not None:
            kind, exc = failed
            injected = isinstance(exc, InjectedFault)
            reg.quarantine(namespace, rung, shape_key, kind, injected=injected, error=exc)
            degraded = True
            benign_only = benign_only and injected
            failures.append((rung, kind, exc))
            continue
        reg.record_served(namespace, rung, degraded=degraded)
        if degraded and refuses_degradation(benign_only, _on_card(out)):
            raise StrictFallbackError(
                f"namespace {namespace!r} (shape {shape_key!r}) degraded to rung {rung!r} "
                f"({'REPRO_STRICT' if strict_mode() else 'on the card; REPRO_ALLOW_FALLBACK=1 allows it'}); "
                f"failures: "
                + "; ".join(f"{r}:{k}: {e}" for r, k, e in failures[:3])
            )
        return out
    last = failures[-1][2] if failures else None
    raise FallbackError(
        f"every rung failed for namespace {namespace!r} "
        f"(shape {shape_key!r}): "
        + "; ".join(f"{r}:{k}" for r, k, _ in failures)
    ) from last
