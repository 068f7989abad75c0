"""Observability of the port (the JAX package's ``repro.obs``): so far the
metrics registry, `obs.metrics`, which the fallback ladder's ledger lives
in.  Spans, exporters, the drift monitor and the structured log are
ROADMAP item 15's."""

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

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "enabled",
    "inc",
    "observe",
    "registry",
    "require_series",
    "reset",
    "set_enabled",
    "set_gauge",
    "snapshot",
]
