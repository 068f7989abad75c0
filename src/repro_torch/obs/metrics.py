"""Typed metrics registry: the one store every telemetry surface writes
(the port's ``repro.obs.metrics``, whole; the JAX module imports no JAX).

Three series types, all labeled:

``Counter``
    monotonically increasing per-label-set floats (ladder serves,
    fallbacks, SDC detections).  ``inc(**labels)`` is a dict update under
    a lock, and the module-level facade (:func:`inc` / :func:`observe` /
    :func:`set_gauge`) short-circuits before touching the registry when
    observability is disabled, so ``REPRO_OBS=0`` costs one branch per
    call site.  ``inc_key`` is the unlocked form for a series with one
    writer at a time whose label key the caller built once (the fallback
    ladder's healthy path).
``Gauge``
    last-write-wins floats (rolling drift error, a calibration's fit
    error).
``Histogram``
    exact ``count``/``sum`` plus a bounded reservoir of recent samples
    for quantiles (serving TTFT / per-token latency, span durations, train
    step time).  `ServingEngine.latency_report` computes its p50/p95/p99
    through the same class.  ``observe_key`` is ``inc_key``'s counterpart.

The process-wide registry (:func:`registry`) is what `obs.export`
snapshots; independent `Registry` instances back stores that must work
even when the global gate is off (`repro_torch.robust.HealthRegistry` keeps its
degradation ledger in one: ``degradation_report()`` cannot go dark because
telemetry export is disabled).

Enablement: the ``REPRO_OBS`` env var (unset or ``1`` means on, ``0`` /
``false`` / ``off`` / ``no`` means off), read at import and at
``set_enabled(None)``, overridable in-process via :func:`set_enabled`
without touching the environment.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "enabled",
    "set_enabled",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry",
    "reset",
    "inc",
    "set_gauge",
    "observe",
    "snapshot",
    "require_series",
]

_DISABLED_VALUES = ("0", "false", "off", "no")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "1").strip().lower() not in _DISABLED_VALUES


# in-process override: None defers to the environment, which is read when
# the module is imported and again at ``set_enabled(None)`` (the JAX module
# reads it at every call; the fallback ladder's healthy path consults the
# gate on every eager call, and an environment read costs a microsecond)
_FORCED: Optional[bool] = None
_ENV: bool = _env_enabled()


def enabled() -> bool:
    """Is the process-wide observability gate open?"""
    if _FORCED is not None:
        return _FORCED
    return _ENV


def set_enabled(value: Optional[bool]) -> None:
    """Force the gate on/off in-process; ``None`` re-reads REPRO_OBS and
    defers to it."""
    global _FORCED, _ENV
    _FORCED = value
    if value is None:
        _ENV = _env_enabled()


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict) -> LabelKey:
    """Canonical hashable form of a label set (sorted, stringified)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic per-label-set counter."""

    kind = "counter"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(value)

    def inc_key(self, key: LabelKey, value: float = 1.0) -> None:
        """`inc` under a label key the caller built once, with the
        canonical order (`_label_key`), without the lock: for a series with
        one writer at a time, as the fallback ladder's are (the thread that
        runs the model, or autograd's device thread while that one waits in
        ``backward``).  A reader stays safe: the store is one dict
        assignment, and `series` copies the dict in one call under the GIL."""
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._series)

    def export_rows(self) -> List[Dict]:
        return [
            {"labels": dict(k), "value": v} for k, v in self.series().items()
        ]


class Gauge:
    """Last-write-wins per-label-set value."""

    kind = "gauge"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._series)

    def export_rows(self) -> List[Dict]:
        return [
            {"labels": dict(k), "value": v} for k, v in self.series().items()
        ]


# reservoir bound: quantiles come from the most recent samples only — the
# exact count/sum stay unbounded, so totals never lie, only tail estimates
# age out.  4096 covers every per-request/per-step series this repo records.
_RESERVOIR = 4096


class _HistSeries:
    __slots__ = ("count", "sum", "max", "values")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.max = float("-inf")
        self.values: deque = deque(maxlen=_RESERVOIR)


class Histogram:
    """Exact count/sum + recent-sample reservoir for quantiles."""

    kind = "histogram"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries()
            s.count += 1
            s.sum += v
            s.max = max(s.max, v)
            s.values.append(v)

    def observe_key(self, key: LabelKey, value: float) -> None:
        """`observe` under a label key the caller built, without the lock:
        for a series with one writer at a time (the fallback ladder's
        ``span.ladder/run_us``; `Counter.inc_key`)."""
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries()
        s.count += 1
        s.sum += value
        if value > s.max:
            s.max = value
        s.values.append(value)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.count if s is not None else 0

    def percentile(self, q: float, **labels) -> float:
        """q-th percentile (0..100) over the reservoir; 0.0 when empty."""
        import numpy as np

        with self._lock:
            s = self._series.get(_label_key(labels))
            vals = list(s.values) if s is not None else []
        if not vals:
            return 0.0
        return float(np.percentile(vals, q))

    def summary(self, **labels) -> Dict[str, float]:
        """count/sum/mean/max plus the p50/p95/p99 tail — the exported
        shape of one histogram series (all-zeros when empty)."""
        import numpy as np

        with self._lock:
            s = self._series.get(_label_key(labels))
            vals = list(s.values) if s is not None else []
            count = s.count if s is not None else 0
            total = s.sum if s is not None else 0.0
            mx = s.max if s is not None and s.count else 0.0
        if not vals:
            return {
                "count": count, "sum": total, "mean": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0,
            }
        p50, p95, p99 = np.percentile(vals, (50, 95, 99))
        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "max": mx,
            "p50": float(p50),
            "p95": float(p95),
            "p99": float(p99),
        }

    def label_keys(self) -> List[LabelKey]:
        with self._lock:
            return list(self._series)

    def export_rows(self) -> List[Dict]:
        return [
            dict({"labels": dict(k)}, **self.summary(**dict(k)))
            for k in self.label_keys()
        ]


class Registry:
    """Name -> typed-series map; the store snapshots/exports walk.

    Instances are always live — the REPRO_OBS gate lives in the
    module-level facade, not here — so subsystems that must keep their
    ledger regardless of telemetry export (the health registry) own a
    private instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)  # a hit takes no lock
        if m is not None and type(m) is cls:
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def metrics(self) -> List[object]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view: {"counters": {...}, "gauges": {...},
        "histograms": {...}} with one row per label set."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            out[m.kind + "s"][m.name] = m.export_rows()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide registry the exporters snapshot."""
    return _REGISTRY


def reset() -> None:
    """Drop every series in the process-wide registry (test isolation)."""
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# facade: the gated entry points instrumentation calls
# ---------------------------------------------------------------------------


def inc(name: str, value: float = 1.0, **labels) -> None:
    if not enabled():
        return
    _REGISTRY.counter(name).inc(value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    if not enabled():
        return
    _REGISTRY.gauge(name).set(value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if not enabled():
        return
    _REGISTRY.histogram(name).observe(value, **labels)


def snapshot() -> Dict[str, Dict]:
    return _REGISTRY.snapshot()


def require_series(names: Iterable[str]) -> List[str]:
    """Names from ``names`` with no recorded series — [] when all present."""
    have = set(_REGISTRY.names())
    return [n for n in names if n not in have]
