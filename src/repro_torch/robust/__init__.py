"""Robustness layer of the port (the JAX package's ``repro.robust``): so
far only the ABFT checksum verification, `robust.abft`."""

from repro_torch.robust.abft import (
    ABFT_MODES,
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

__all__ = [
    "ABFT_MODES",
    "SdcDetected",
    "abft_mode",
    "current_mode",
    "step_scope",
    "StepScope",
    "runtime_sdc_total",
    "runtime_sdc_counts",
    "runtime_max_ratio",
    "runtime_check_total",
    "reset_runtime_sdc",
]
