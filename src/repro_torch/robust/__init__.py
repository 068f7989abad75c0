"""Execution guardrails of the port (the JAX package's ``repro.robust``):
the fallback ladder, the health registry, fault injection and ABFT.

Every routed op (the GEMM backends, the attention backends, the backward
kernels and the fused optimizer's update) degrades through one mechanism:
:func:`run_with_fallback` walks a ladder of rungs (``sfc_cuda → replicated
→ sfc_reference → torch``) on *classified* failures (a launch refused at
its shape, device OOM, the fault harness's faults).  Unclassified
exceptions propagate, and so do sticky CUDA errors and failed builds: the
ladder heals platform breakage, it does not hide bugs.

The :class:`HealthRegistry` quarantines a failing ``(namespace, rung,
shape-class)`` so the broken path is skipped on later calls, and
`degradation_report()` summarises what actually served.  `robust.inject`
is a deterministic contextvar fault harness, so every rung transition is
differentially testable without real hardware failures.

A fallback that was not injected raises `StrictFallbackError` when its
tensors lie on the card, unless ``REPRO_ALLOW_FALLBACK=1`` allows it, so
no caller times plain PyTorch believing it ran the kernels; on the CPU the
JAX package's silent descent holds, and ``REPRO_STRICT=1`` makes every
device strict.

`robust.abft` is the silent-corruption layer: checksum lanes in the GEMM
flushes compare ``sum(C)`` against the operand contraction; a mismatch
outside a step scope raises :class:`SdcDetected`, which the ladder
classifies as ``"sdc"``: retry once on the same rung, then quarantine.
"""

from repro_torch.robust.abft import (
    ABFT_MODES,
    InjectedSdc,
    SdcDetected,
    StepScope,
    abft_mode,
    current_mode,
    reset_runtime_sdc,
    runtime_check_total,
    runtime_max_ratio,
    runtime_sdc_counts,
    runtime_sdc_total,
    step_scope,
)
from repro_torch.robust.inject import (
    FaultSpec,
    InjectedCompileError,
    InjectedFault,
    InjectedResourceExhausted,
    fault_injection,
    injection_active,
)
from repro_torch.robust.ladder import (
    DEFAULT_LADDER,
    KERNEL_RUNGS,
    FallbackError,
    HealthRegistry,
    QuarantineRecord,
    StrictFallbackError,
    classify_failure,
    degradation_report,
    get_registry,
    run_with_fallback,
    strict_mode,
)

__all__ = [
    "ABFT_MODES",
    "DEFAULT_LADDER",
    "KERNEL_RUNGS",
    "FallbackError",
    "FaultSpec",
    "HealthRegistry",
    "InjectedCompileError",
    "InjectedFault",
    "InjectedResourceExhausted",
    "InjectedSdc",
    "QuarantineRecord",
    "SdcDetected",
    "StepScope",
    "StrictFallbackError",
    "abft_mode",
    "classify_failure",
    "current_mode",
    "degradation_report",
    "fault_injection",
    "get_registry",
    "injection_active",
    "reset_runtime_sdc",
    "run_with_fallback",
    "runtime_check_total",
    "runtime_max_ratio",
    "runtime_sdc_counts",
    "runtime_sdc_total",
    "step_scope",
    "strict_mode",
]
