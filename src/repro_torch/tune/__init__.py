"""Empirical knob tuning for the SFC kernels (calibrated, cached,
persistent): the port's ``repro.tune``.

`calibrate` fits per-device platform constants from a short measured
micro-sweep (once per device kind, persisted in the knob cache);
`tune_gemm` then ranks candidates with the calibrated model and times only
the top few to confirm (``strategy="predict"``, the default;
``"exhaustive"`` measures every one).  On the card a candidate is a launch
configuration of the kernels (``Knobs.launch``), the kernel's rule first.
`lookup_knobs` is the measurement-free cache consult of
`repro_torch.kernels.ops.resolve_knobs` and
`repro_torch.core.attention_backend.resolve_attn_knobs`.
"""

from repro_torch.tune.cache import (
    KnobCache,
    Knobs,
    default_cache_path,
    detect_device_kind,
    shape_bucket,
)
from repro_torch.tune.calibrate import (
    PlatformConstants,
    calibrate,
    calibrated_hardware,
    fit_constants,
    load_platform_constants,
    resolve_hardware_model,
)
from repro_torch.tune.tuner import (
    TUNE_OPS,
    candidate_knobs,
    default_cache,
    lookup_knobs,
    measure_candidate,
    predict_candidate,
    tune_gemm,
    using_cache,
)

__all__ = [
    "KnobCache",
    "Knobs",
    "PlatformConstants",
    "TUNE_OPS",
    "calibrate",
    "calibrated_hardware",
    "candidate_knobs",
    "default_cache",
    "default_cache_path",
    "detect_device_kind",
    "fit_constants",
    "load_platform_constants",
    "lookup_knobs",
    "measure_candidate",
    "predict_candidate",
    "resolve_hardware_model",
    "shape_bucket",
    "tune_gemm",
    "using_cache",
]
