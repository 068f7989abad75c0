"""Perf-drift monitor: detect when the calibrated model stops predicting
(the port's ``repro.obs.drift``).

The tuner's predict-then-confirm loop (and anything else that measures a
kernel it also predicted) feeds ``observe(namespace, predicted_s,
measured_s)``.  Per tune namespace the monitor keeps a rolling window of
relative errors; when the rolling *median* error exceeds ``threshold``
(with at least ``min_samples`` observations) the namespace is flagged —
the persisted calibration constants no longer describe this machine,
whether because the clock throttled, a driver changed, or the constants
were fitted on different hardware entirely.

Flagging is the detection half of the ROADMAP staleness policy; the
response half is :meth:`DriftMonitor.invalidate_calibration`, which purges
the persisted platform constants from the knob cache so the next
`repro_torch.tune.calibrate` re-fits from a fresh micro-sweep
(`ServingEngine.warmup(tune=True)` calls `calibrate()` first, so a warmed
fleet heals on its next warmup).  Median — not mean — because a single straggler
measurement (GC pause, noisy neighbour) must not poison the verdict.

Everything routes through the metrics registry: per-namespace rolling
error as the ``drift.median_rel_err`` gauge, sample and flag counts as
counters, so the JSONL/Prometheus exports carry the drift state a fleet
would alert on.

Where it differs from the JAX module: `DriftMonitor.invalidate_calibration`
purges the card's constants (backend ``"gpu"``) unless told another
backend.  The JAX module asks the process for its backend; the port's
entry points run on the card unless the caller names the CPU, and the
tuner's own default backend name is the CPU's.
"""

from __future__ import annotations

import threading
import warnings
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics

__all__ = ["DriftMonitor", "get_monitor", "reset_monitor"]


class DriftMonitor:
    """Rolling predicted-vs-measured error per tune namespace."""

    def __init__(
        self,
        threshold: float = 0.5,
        window: int = 64,
        min_samples: int = 5,
    ):
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._errors: Dict[str, deque] = {}
        self._flagged: Dict[str, float] = {}  # namespace -> median at flag

    def observe(
        self, namespace: str, predicted_s: float, measured_s: float
    ) -> Optional[float]:
        """Record one predicted-vs-measured pair; returns the namespace's
        rolling median relative error once ``min_samples`` are in."""
        if not (
            predicted_s is not None
            and measured_s
            and measured_s > 0
            and np.isfinite(predicted_s)
            and np.isfinite(measured_s)
        ):
            return None
        rel = abs(measured_s - float(predicted_s)) / float(measured_s)
        with self._lock:
            errs = self._errors.get(namespace)
            if errs is None:
                errs = self._errors[namespace] = deque(maxlen=self.window)
            errs.append(rel)
            n = len(errs)
            med = float(np.median(errs)) if n >= self.min_samples else None
            newly_flagged = (
                med is not None
                and med > self.threshold
                and namespace not in self._flagged
            )
            if newly_flagged:
                self._flagged[namespace] = med
            elif med is not None and med <= self.threshold:
                # drifted back under threshold (e.g. after re-calibration
                # samples land): lift the flag
                self._flagged.pop(namespace, None)
        metrics.inc("drift.samples", namespace=namespace)
        if med is not None:
            metrics.set_gauge(
                "drift.median_rel_err", med, namespace=namespace
            )
        if newly_flagged:
            metrics.inc("drift.flagged", namespace=namespace)
            warnings.warn(
                f"perf drift: namespace {namespace!r} rolling median "
                f"predicted-vs-measured error {med:.1%} exceeds "
                f"{self.threshold:.0%} — persisted calibration constants "
                "are stale for this device (invalidate_calibration() "
                "purges them; the next calibrate() re-fits)",
                RuntimeWarning,
                stacklevel=3,
            )
        return med

    def median_error(self, namespace: str) -> Optional[float]:
        with self._lock:
            errs = self._errors.get(namespace)
            if not errs or len(errs) < self.min_samples:
                return None
            return float(np.median(errs))

    def flagged(self) -> Tuple[str, ...]:
        """Namespaces whose calibration is currently considered stale."""
        with self._lock:
            return tuple(sorted(self._flagged))

    def report(self) -> Dict[str, Dict]:
        """Per-namespace {n, median_rel_err, flagged} summary."""
        with self._lock:
            return {
                ns: {
                    "n": len(errs),
                    "median_rel_err": (
                        float(np.median(errs))
                        if len(errs) >= self.min_samples
                        else None
                    ),
                    "flagged": ns in self._flagged,
                }
                for ns, errs in sorted(self._errors.items())
            }

    def invalidate_calibration(
        self, cache=None, *, backend: Optional[str] = None
    ) -> bool:
        """Mark the persisted calibration constants stale: purge them from
        the knob cache so the next `repro_torch.tune.calibrate` re-fits.
        ``backend`` defaults to the card's ("gpu").

        No-op (returns False) when nothing is flagged.  The per-namespace
        error windows are dropped on purge — post-re-calibration samples
        must earn a fresh verdict, not inherit the stale one."""
        if not self.flagged():
            return False
        from repro_torch.tune.cache import KnobCache

        if cache is None:
            from repro_torch.tune.tuner import default_cache

            cache = default_cache()
        assert isinstance(cache, KnobCache)
        if backend is None:
            from repro_torch.tune.tuner import _backend_name

            backend = _backend_name("cuda")
        purged = cache.purge_platform(backend)
        metrics.inc("drift.calibration_purged", backend=backend)
        with self._lock:
            self._errors.clear()
            self._flagged.clear()
        return purged

    def reset(self) -> None:
        with self._lock:
            self._errors.clear()
            self._flagged.clear()


_MONITOR = DriftMonitor()


def get_monitor() -> DriftMonitor:
    """Process-wide drift monitor (fed by `tune.tuner.tune_gemm`)."""
    return _MONITOR


def reset_monitor() -> None:
    _MONITOR.reset()
