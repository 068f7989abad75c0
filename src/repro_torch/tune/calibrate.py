"""Calibrate the perf model against measurement (the port's
``repro.tune.calibrate``).

The simulator of `core.perf_model` is parameterized by data-sheet
constants.  This module fits per-device platform constants to a short
measured micro-sweep (the csl-experiments method of SNIPPETS.md 1-3: a
handful of empirical constants fitted to measured timelines):

  1. ``calibration_sweep`` measures the micro-sweep `CAL_SWEEP_SHAPES` and
     pairs each point with the uncalibrated simulator's features;
  2. ``fit_constants`` fits, by relative-weighted least squares with an
     active set that drops any column whose coefficient goes negative::

         t_meas ~= launch_overhead
                   + n_flushes * flush_overhead
                   + flush_bytes * drain_byte_s
                   + time_scale * t_simulated
                   + reuse_miss_beta * reuse_deficit_bytes
                   + vmem_penalty * vmem_excess_bytes

     on the same records it gives the JAX module's constants;
  3. ``calibrate`` persists the fit in the knob-cache file per (backend,
     device kind), and ``calibrated_hardware`` rebuilds a `HardwareModel`
     whose simulators consume the fitted constants.

On the card (a deliberate difference from the JAX module):

* The sweep measures the type warmup tunes, bf16, not the JAX module's
  default f32: an f32 product on the card takes the 64 x 64 FMA tile
  kernel, so an f32 fit would price a kernel the tuned calls never take.
* Its variants per shape are the card's launch candidates of the "gemm"
  namespace (`tune.tuner.candidate_knobs`: the wgmma tile and worker
  group, the cluster kernel's K layers) rather than the TPU's k_layers /
  k_block_factor perturbations, which the card's fused kernels ignore;
  their features come from the launch-aware simulation
  (``tuner._simulate_card``) the tuner later predicts with, on the
  `H100_SXM` data sheet.
* Each point is a CUDA-event time (`tune.tuner.measure_candidate`), and a
  measurement that fails raises: calibration is not skipped.

On the CPU the sweep is the JAX module's (f32, k-knob variants, the
simulator as the measurement, `TPU_V5E` as the base).  A fit is a
``tune/calibrate`` span and counts ``tune.calibrations`` and the
``tune.calibration_fit_err`` gauge by backend, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perf_model import H100_SXM, TPU_V5E, HardwareModel, vmem_excess_bytes
from repro_torch.tune.cache import KnobCache, Knobs

__all__ = [
    "PlatformConstants",
    "CalibrationRecord",
    "calibration_sweep",
    "fit_constants",
    "calibrate",
    "calibrated_hardware",
    "load_platform_constants",
    "resolve_hardware_model",
    "base_hardware",
    "CAL_SWEEP_SHAPES",
]


@dataclasses.dataclass(frozen=True)
class PlatformConstants:
    """Fitted per-device platform constants (see module docstring); the
    cache file's schema is ``as_dict()``'s keys."""

    device_kind: str
    backend: str
    time_scale: float  # effective/data-sheet throughput ratio (γ, β derate)
    launch_overhead_s: float  # per kernel launch
    flush_overhead_s: float  # per accumulator drain (tile x K chunk)
    vmem_penalty: float  # sec/byte of working-set excess over the budget
    drain_byte_s: float = 0.0  # sec/byte of per-step working set, steps > 1
    reuse_miss_beta: float = 0.0  # sec/byte of census-credited panel reuse
    n_samples: int = 0
    median_abs_rel_err: float = 0.0  # fit quality on the sweep itself

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PlatformConstants":
        return cls(
            device_kind=str(d.get("device_kind", "")),
            backend=str(d.get("backend", "")),
            time_scale=float(d["time_scale"]),
            launch_overhead_s=float(d["launch_overhead_s"]),
            flush_overhead_s=float(d["flush_overhead_s"]),
            vmem_penalty=float(d["vmem_penalty"]),
            drain_byte_s=float(d.get("drain_byte_s", 0.0)),
            reuse_miss_beta=float(d.get("reuse_miss_beta", 0.0)),
            n_samples=int(d.get("n_samples", 0)),
            median_abs_rel_err=float(d.get("median_abs_rel_err", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    """One measured micro-sweep point and its model-side features."""

    m: int
    n: int
    k: int
    knobs: Knobs
    t_measured: float
    t_simulated: float  # uncalibrated simulator time (the base feature)
    vmem_excess: float
    n_flushes: float = 1.0  # accumulator drains: output tiles x K chunks x layers
    flush_bytes: float = 0.0  # per-step working set x (n_flushes - 1)
    reuse_deficit: float = 0.0  # panel reuse the census credits, in bytes


# small, fast, and deliberately varied so the fit's columns are identifiable
CAL_SWEEP_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (128, 128, 128),
    (256, 256, 256),
    (256, 256, 1024),
    (512, 256, 512),
    (512, 512, 512),
)


def _on_card(device) -> bool:
    import torch

    return device is not None and torch.device(device).type == "cuda"


def base_hardware(device=None) -> HardwareModel:
    """The data-sheet model of a device: `H100_SXM` for the card,
    `TPU_V5E` (the JAX package's) for the CPU."""
    return H100_SXM if _on_card(device) else TPU_V5E


def _sweep_knob_variants(m: int, n: int, k: int) -> List[Knobs]:
    """The CPU's variants (the JAX module's): the seed knobs plus
    k_layers / k_block_factor perturbations."""
    from repro_torch.kernels.ops import pick_blocks

    bm, bn, _ = pick_blocks(m, n, k)
    out = [Knobs(bm=bm, bn=bn, k_layers=1, k_block_factor=1)]
    if k >= 2:
        out.append(Knobs(bm=bm, bn=bn, k_layers=2, k_block_factor=1))
        out.append(Knobs(bm=bm, bn=bn, k_layers=1, k_block_factor=2))
    if k >= 4:
        out.append(Knobs(bm=bm, bn=bn, k_layers=2, k_block_factor=2))
    return out


def calibration_sweep(
    shapes: Sequence[Tuple[int, int, int]] = CAL_SWEEP_SHAPES,
    dtype=None,
    *,
    base: Optional[HardwareModel] = None,
    measure_fn: Optional[Callable] = None,
    device="cpu",
) -> List[CalibrationRecord]:
    """Measure the micro-sweep on ``device`` and pair each point with its
    simulator features.  ``dtype``: bf16 on the card, f32 (the JAX
    module's) on the CPU, unless given.  ``measure_fn(m, n, k, dtype,
    knobs)`` defaults to `tune.tuner.measure_candidate` on the device.  A
    failing or non-finite measurement raises."""
    import torch

    from repro_torch.tune.cache import dtype_name
    from repro_torch.tune.tuner import _simulate_candidate, candidate_knobs, measure_candidate

    card = _on_card(device)
    dtype = (torch.bfloat16 if card else np.float32) if dtype is None else dtype
    base = base or base_hardware(device)
    dtype_bytes = 2 if dtype_name(dtype) == "bfloat16" else np.dtype(dtype_name(dtype)).itemsize
    sms = 132
    if card:
        from repro_torch.core.device import sm_count

        sms = sm_count(torch.device(device))
    measure = measure_fn or (lambda m, n, k, dt, kn: measure_candidate(m, n, k, dt, kn, device=device))
    records: List[CalibrationRecord] = []
    for (m, n, k) in shapes:
        variants = (candidate_knobs(m, n, k, op="gemm", dtype=dtype, device=device) if card
                    else _sweep_knob_variants(m, n, k))
        for knobs in variants:
            t_meas = float(measure(m, n, k, dtype, knobs))
            if not (t_meas > 0 and np.isfinite(t_meas)):
                raise RuntimeError(f"calibration point {(m, n, k)} {knobs} measured {t_meas}")
            feats = _simulate_candidate(m, n, k, dtype, knobs, op="gemm", hw=base, sms=sms)
            k_chunk = max(1, (k // knobs.k_layers) // knobs.k_block_factor)
            records.append(
                CalibrationRecord(
                    m=m, n=n, k=k, knobs=knobs,
                    t_measured=t_meas, t_simulated=feats["time_s"],
                    vmem_excess=vmem_excess_bytes(knobs.bm, knobs.bn, k_chunk, dtype_bytes=dtype_bytes, hw=base),
                    n_flushes=feats["n_flushes"],
                    flush_bytes=feats["flush_bytes"],
                    reuse_deficit=feats["reuse_deficit_bytes"],
                )
            )
    return records


def fit_constants(
    records: Sequence[CalibrationRecord],
    *,
    base: HardwareModel = TPU_V5E,
    backend: str = "",
    device_kind: str = "",
) -> PlatformConstants:
    """Relative-weighted least-squares fit of the platform constants, the
    JAX module's: samples weighted 1/t_measured, an active-set pass that
    drops any column whose coefficient fits negative and refits the
    survivors jointly."""
    if not records:
        return PlatformConstants(
            device_kind=device_kind, backend=backend,
            time_scale=1.0, launch_overhead_s=0.0, flush_overhead_s=0.0,
            vmem_penalty=0.0, drain_byte_s=0.0, reuse_miss_beta=0.0,
            n_samples=0, median_abs_rel_err=0.0,
        )
    t = np.array([r.t_measured for r in records], dtype=np.float64)
    feats = np.stack(
        [
            np.ones(len(records)),
            np.array([r.n_flushes for r in records], dtype=np.float64),
            np.array([r.flush_bytes for r in records], dtype=np.float64),
            np.array([r.t_simulated for r in records], dtype=np.float64),
            np.array([r.reuse_deficit for r in records], dtype=np.float64),
            np.array([r.vmem_excess for r in records], dtype=np.float64),
        ],
        axis=1,
    )
    SIM = 3  # column index of t_simulated (the time_scale term)
    w = 1.0 / np.maximum(t, 1e-12)
    theta = np.zeros(feats.shape[1])
    active = list(range(feats.shape[1]))
    for _ in range(feats.shape[1]):
        fa = feats[:, active] * w[:, None]
        # scale-normalize columns so lstsq is well conditioned
        norms = np.maximum(np.abs(fa).max(axis=0), 1e-30)
        sol, *_ = np.linalg.lstsq(fa / norms, t * w, rcond=None)
        sol = sol / norms
        negative = [active[i] for i, v in enumerate(sol) if v < 0]
        if not negative:
            theta[:] = 0.0
            for i, col in enumerate(active):
                theta[col] = sol[i]
            break
        active = [col for col in active if col not in negative]
        if not active:
            break
    theta[SIM] = max(float(theta[SIM]), 1e-6)

    pred = feats @ theta
    rel_err = np.abs(pred - t) / np.maximum(np.abs(t), 1e-30)
    return PlatformConstants(
        device_kind=device_kind,
        backend=backend,
        time_scale=float(theta[SIM]),
        launch_overhead_s=float(theta[0]),
        flush_overhead_s=float(theta[1]),
        drain_byte_s=float(theta[2]),
        vmem_penalty=float(theta[5]),
        reuse_miss_beta=float(theta[4]),
        n_samples=len(records),
        median_abs_rel_err=float(np.median(rel_err)),
    )


def calibrated_hardware(constants: PlatformConstants, base: HardwareModel = TPU_V5E) -> HardwareModel:
    """A `HardwareModel` carrying the fitted constants: γ/β scaled by the
    throughput derate, overheads and the working-set penalty installed."""
    label = constants.device_kind or "calibrated"
    return dataclasses.replace(
        base,
        name=f"{base.name}+{label}",
        gamma=base.gamma * constants.time_scale,
        beta=base.beta * constants.time_scale,
        launch_overhead_s=constants.launch_overhead_s,
        flush_overhead_s=constants.flush_overhead_s,
        drain_byte_s=constants.drain_byte_s,
        vmem_penalty=constants.vmem_penalty,
        reuse_miss_beta=constants.reuse_miss_beta,
        calibrated=constants.device_kind,
    )


def load_platform_constants(
    cache: Optional[KnobCache] = None, *, backend: Optional[str] = None, device="cpu"
) -> Optional[PlatformConstants]:
    """Persisted constants for this (backend, device kind), or None."""
    from repro_torch.tune.tuner import _backend_name, default_cache

    cache = cache if cache is not None else default_cache()
    d = cache.get_platform(backend or _backend_name(device))
    if d is None:
        return None
    try:
        return PlatformConstants.from_dict(d)
    except (KeyError, TypeError, ValueError):
        return None


def calibrate(
    cache: Optional[KnobCache] = None,
    *,
    base: Optional[HardwareModel] = None,
    dtype=None,
    shapes: Sequence[Tuple[int, int, int]] = CAL_SWEEP_SHAPES,
    measure_fn: Optional[Callable] = None,
    force: bool = False,
    device=None,
) -> PlatformConstants:
    """Fit-once entry point on ``device`` (the card unless the caller names
    the CPU): the persisted constants when present (no measurement), else
    the micro-sweep, the fit, persisted in the knob-cache file."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import span
    from repro_torch.tune.tuner import _backend_name, _device, default_cache

    device = _device(device)
    cache = cache if cache is not None else default_cache()
    backend = _backend_name(device)
    if not force:
        hit = load_platform_constants(cache, backend=backend)
        if hit is not None:
            return hit
    base = base or base_hardware(device)
    with span("tune/calibrate", backend=backend):
        records = calibration_sweep(shapes, dtype, base=base, measure_fn=measure_fn, device=device)
        constants = fit_constants(records, base=base, backend=backend, device_kind=cache.device_of(backend))
        cache.put_platform(backend, constants.as_dict())
        obs_metrics.inc("tune.calibrations", backend=backend)
        obs_metrics.set_gauge("tune.calibration_fit_err", constants.median_abs_rel_err, backend=backend)
    return constants


def resolve_hardware_model(
    cache: Optional[KnobCache] = None, *, base: Optional[HardwareModel] = None, device="cpu"
) -> HardwareModel:
    """The model the tuner ranks with: the device's calibrated model when
    constants are persisted for it, else its data-sheet base."""
    base = base or base_hardware(device)
    constants = load_platform_constants(cache, device=device)
    if constants is None:
        return base
    return calibrated_hardware(constants, base)
