"""Span tracing over the hot control-plane paths (the port's
``repro.obs.trace``).

``with span("serving/prefill", request_id=...)`` times a region, records
its duration into the ``span.<name>_us`` histogram of the process metrics
registry, and, while a torch profiler is active, forwards the name to
``torch.autograd.profiler.record_function`` so that the same region lands
in the trace (a user annotation, and under ``emit_nvtx`` an NVTX range)
beside the kernels it launched.

Span taxonomy (the JAX package's; see README "Observability"):

    tune/tune_gemm       knob resolution sweep for one (op, shape bucket)
    tune/calibrate       platform-constants micro-sweep + fit
    ladder/run           one `run_with_fallback` rung walk (label-free;
                         the namespace rides in `ladder.served` counters)
    abft/verify          one checksum comparison
    serving/admission    request batching + overdue shedding
    serving/prefill      one batched prefill launch
    serving/decode       one batched decode step
    serving/retire       end-of-batch request bookkeeping
    train/batch          host-side batch materialization
    train/step           one train_step call
    train/checkpoint     checkpoint save at a step boundary

Spans are metrics, not a causal trace: attributes are forwarded to the
profiler annotation only (they would explode label cardinality in the
registry).  When observability is disabled the context manager yields at
once: no clock read, no annotation.

Where it differs from the JAX module:

* **The annotation is entered only inside an active profiler**
  (``torch.autograd._profiler_enabled()``).  JAX's ``TraceAnnotation``
  costs about nothing outside a profile; an empty ``record_function``
  costs over ten microseconds there, and the port walks the ladder on
  every eager call.
* **A span times the host.**  A launch returns before its kernel ends, so
  a span measures device time only where it ends in a host read
  (``serving/prefill``, ``serving/decode``, ``train/step``).
* `observe_since` is the allocation-free form for a hot path (the fallback
  ladder's healthy path): the caller reads the clock, calls it at the end,
  and opens a `span` instead while a profiler is active.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

from repro_torch.obs import metrics

__all__ = ["span", "SPAN_NAMES", "profiling", "observe_since"]

# the documented taxonomy: tests gate that instrumented paths stay on it
SPAN_NAMES = (
    "tune/tune_gemm",
    "tune/calibrate",
    "ladder/run",
    "abft/verify",
    "serving/admission",
    "serving/prefill",
    "serving/decode",
    "serving/retire",
    "train/batch",
    "train/step",
    "train/checkpoint",
)

# whether a torch profiler (kineto or the legacy one) is recording
profiling = torch.autograd._profiler_enabled


def observe_since(series: str, t0: float) -> None:
    """Record the microseconds since ``t0`` (a ``time.perf_counter()``
    reading) into the unlabeled histogram ``series`` of the process
    registry, without the lock: for a series with one writer at a time
    (`metrics.Histogram.observe_key`).  The registry's own lookup, inlined:
    the ladder calls this on every eager call."""
    dt_us = (time.perf_counter() - t0) * 1e6
    h = metrics._REGISTRY._metrics.get(series)
    if type(h) is not metrics.Histogram:
        h = metrics._REGISTRY.histogram(series)
    h.observe_key((), dt_us)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Time a region into ``span.<name>_us`` and mirror it into an active
    torch profile.  Exceptions propagate; the duration is still recorded
    (a failing prefill is exactly the sample you want in the tail)."""
    if not metrics.enabled():
        yield
        return
    ann = None
    if profiling():
        args = ",".join(f"{k}={v}" for k, v in attrs.items()) or None
        ann = torch.autograd.profiler.record_function(name, args)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt_us = (time.perf_counter() - t0) * 1e6
        if ann is not None:
            ann.__exit__(None, None, None)
        metrics.observe(f"span.{name}_us", dt_us)
