"""repro_torch.obs — process-wide observability: metrics, spans, drift
(the port's ``repro.obs``, whole).

One registry (`obs.metrics`), one span tracer (`obs.trace`), one
perf-drift monitor (`obs.drift`), and exporters (`obs.export`).  Every
telemetry surface of the port — fallback ladder, ABFT, knob cache, tuner,
serving engine, train loop — emits through the facade re-exported here,
under the JAX package's series and span names:

    from repro_torch import obs
    obs.inc("tune.cache.hit", op="matmul")
    with obs.span("serving/prefill"):
        ...
    obs.to_jsonl("telemetry.jsonl")

Gate: ``REPRO_OBS=0`` (or ``set_enabled(False)``) turns every facade call
into a single branch — instrumented hot paths cost nothing measurable.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.obs.drift import DriftMonitor, get_monitor, reset_monitor
from repro_torch.obs.export import (
    missing_series,
    read_jsonl,
    to_jsonl,
    to_prometheus,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    enabled,
    inc,
    observe,
    registry,
    require_series,
    reset,
    set_enabled,
    set_gauge,
    snapshot,
)
from repro_torch.obs.trace import SPAN_NAMES, span

__all__ = [
    "enabled",
    "set_enabled",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry",
    "reset",
    "reset_all",
    "inc",
    "set_gauge",
    "observe",
    "snapshot",
    "require_series",
    "span",
    "SPAN_NAMES",
    "DriftMonitor",
    "get_monitor",
    "reset_monitor",
    "to_jsonl",
    "to_prometheus",
    "read_jsonl",
    "missing_series",
    "StructuredLog",
    "as_structured",
]


def reset_all() -> None:
    """Drop the process registry and the drift monitor (test isolation)."""
    reset()
    reset_monitor()


class StructuredLog:
    """Event-counting logger: human line to a sink, typed event to obs.

    ``event(kind, msg, **fields)`` forwards the formatted ``msg`` to the
    sink (default ``print``) exactly as a bare f-string print would have,
    and increments the ``log.events`` counter labeled by ``kind`` — so a
    fleet alerts on ``log.events{kind=ft.rollback}`` rates instead of
    grepping stdout.  Extra ``fields`` are appended as ``k=v`` pairs when
    ``verbose_fields`` is set (off by default: the historical log lines
    already carry their own formatting, and tests match substrings)."""

    def __init__(
        self,
        sink: Optional[Callable[[str], None]] = None,
        verbose_fields: bool = False,
    ):
        self.sink = sink if sink is not None else print
        self.verbose_fields = verbose_fields

    def __call__(self, msg: str) -> None:
        self.event("info", msg)

    def event(self, kind: str, msg: str, **fields) -> None:
        inc("log.events", kind=kind)
        line = msg
        if self.verbose_fields and fields:
            line = msg + " " + " ".join(
                f"{k}={v}" for k, v in sorted(fields.items())
            )
        self.sink(line)


def as_structured(logger) -> StructuredLog:
    """Coerce a plain line-sink callable into a :class:`StructuredLog`
    (pass-through when it already is one)."""
    if isinstance(logger, StructuredLog):
        return logger
    return StructuredLog(sink=logger)
