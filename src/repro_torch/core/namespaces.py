"""The tune/ladder namespace registry: every string that keys a tune-cache
bucket, a fallback-ladder health record or a serving warmup row, as typed
constants in one place.

This is the port's copy of ``repro.core.namespaces``.  The namespace
strings are the JAX package's, so a knob cache or health record can later be
keyed the same way on both sides.  Two axes live here:

* **namespaces** — *what* is being tuned/healed: the kernel-variant
  buckets of the tune cache (``NS_*``) plus the ladder-only namespaces of
  the fused-optimizer flush paths.
* **backends / rungs** — *which implementation* runs a projection: the
  names the ``repro_torch.core.gemm_backend`` switch takes (``BACKEND_*``)
  and, the same four strings, the fallback ladder's rungs (``RUNG_*``,
  `robust.ladder`), walked in :data:`DEFAULT_LADDER` order under
  "sfc_cuda".

**Schedule-derived namespaces.**  The unified schedule compiler
(`repro_torch.core.schedule`) lets new op families reuse existing kernels under
a schedule-specific tune bucket: :func:`schedule_namespace` appends the
``ScheduleSpec`` key to a base namespace (``"gemm@1a2b3c4d5e6f"``), so a
chunked-recurrence einsum and a plain projection with the same padded
shape tune independently.  `tune.tuner.tune_gemm` accepts any namespace
whose :func:`base_namespace` is in :data:`TUNE_OPS`.
"""

from __future__ import annotations

__all__ = [
    "NS_GEMM",
    "NS_GLU",
    "NS_NT",
    "NS_NT_DUAL",
    "NS_TN",
    "NS_TN_DUAL",
    "NS_TN_UPDATE",
    "NS_TN_UPDATE_DUAL",
    "NS_ATTN_FWD",
    "NS_ATTN_BWD",
    "NS_ATTN_DECODE",
    "NS_GROUPED",
    "NS_GROUPED_GLU",
    "NS_GROUPED_NT",
    "NS_GROUPED_TN",
    "NS_GEMM_UPDATE",
    "NS_GLU_UPDATE",
    "NS_GROUPED_UPDATE",
    "NS_GROUPED_GLU_UPDATE",
    "NS_GROUPED_TN_UPDATE",
    "TUNE_OPS",
    "ATTN_OPS",
    "LADDER_ONLY_NAMESPACES",
    "ALL_NAMESPACES",
    "BACKEND_TORCH",
    "BACKEND_SFC_CUDA",
    "BACKEND_REPLICATED",
    "BACKEND_SFC_REFERENCE",
    "BACKENDS",
    "RUNG_SFC_CUDA",
    "RUNG_REPLICATED",
    "RUNG_SFC_REFERENCE",
    "RUNG_TORCH",
    "DEFAULT_LADDER",
    "KERNEL_RUNGS",
    "schedule_namespace",
    "is_schedule_namespace",
    "base_namespace",
]

# --- tune-cache namespaces (measured by `repro_torch.tune.tune_gemm`) -----
NS_GEMM = "gemm"                        # forward A·B (paper Listing 1)
NS_GLU = "glu"                          # dual-B gated forward
NS_NT = "nt"                            # dX = dY·Wᵀ backward
NS_NT_DUAL = "nt_dual"                  # NT, dual-B (GLU backward)
NS_TN = "tn"                            # dW = Xᵀ·dY backward
NS_TN_DUAL = "tn_dual"                  # TN, dual-B
NS_TN_UPDATE = "tn_update"              # TN + fused optimizer flush
NS_TN_UPDATE_DUAL = "tn_update_dual"    # fused flush, dual-B
NS_ATTN_FWD = "attn_fwd"                # flash forward (q_chunk/k_chunk)
NS_ATTN_BWD = "attn_bwd"                # flash dQ/dK/dV
NS_ATTN_DECODE = "attn_decode"          # single-launch cache decode

# --- ladder-only namespaces (healed, not independently tuned) -------------
NS_GROUPED = "grouped"                  # grouped/ragged MoE forward
NS_GROUPED_GLU = "grouped_glu"
NS_GROUPED_NT = "grouped_nt"            # grouped backward traversals
NS_GROUPED_TN = "grouped_tn"
NS_GEMM_UPDATE = "gemm_update"          # fused-update wrapper ladders
NS_GLU_UPDATE = "glu_update"
NS_GROUPED_UPDATE = "grouped_update"
NS_GROUPED_GLU_UPDATE = "grouped_glu_update"
NS_GROUPED_TN_UPDATE = "grouped_tn_update"

TUNE_OPS = (
    NS_GEMM,
    NS_GLU,
    NS_NT,
    NS_NT_DUAL,
    NS_TN,
    NS_TN_DUAL,
    NS_TN_UPDATE,
    NS_TN_UPDATE_DUAL,
    NS_ATTN_FWD,
    NS_ATTN_BWD,
    NS_ATTN_DECODE,
)

ATTN_OPS = (NS_ATTN_FWD, NS_ATTN_BWD, NS_ATTN_DECODE)

LADDER_ONLY_NAMESPACES = (
    NS_GROUPED,
    NS_GROUPED_GLU,
    NS_GROUPED_NT,
    NS_GROUPED_TN,
    NS_GEMM_UPDATE,
    NS_GLU_UPDATE,
    NS_GROUPED_UPDATE,
    NS_GROUPED_GLU_UPDATE,
    NS_GROUPED_TN_UPDATE,
)

ALL_NAMESPACES = TUNE_OPS + LADDER_ONLY_NAMESPACES

# --- GEMM backends (`core.gemm_backend.gemm_backend`) --------------------
BACKEND_TORCH = "torch"                  # torch.matmul + epilogue ("xla" in JAX)
BACKEND_SFC_CUDA = "sfc_cuda"            # the hand-written SFC CUDA kernel
BACKEND_REPLICATED = "replicated"        # split-K partial copies + add_reduce, epilogue after
BACKEND_SFC_REFERENCE = "sfc_reference"  # Listing-1 loop in plain torch

BACKENDS = (BACKEND_TORCH, BACKEND_SFC_CUDA, BACKEND_REPLICATED, BACKEND_SFC_REFERENCE)

# --- fallback-ladder rungs (implementation names, `robust.ladder`) --------
# The JAX package's rungs one to one: "sfc_pallas", "replicated",
# "sfc_reference", "xla".  An explicit backend of the same name bypasses
# the ladder: it *is* that rung.
RUNG_SFC_CUDA = BACKEND_SFC_CUDA
RUNG_REPLICATED = BACKEND_REPLICATED
RUNG_SFC_REFERENCE = BACKEND_SFC_REFERENCE
RUNG_TORCH = BACKEND_TORCH

DEFAULT_LADDER = (
    RUNG_SFC_CUDA,
    RUNG_REPLICATED,
    RUNG_SFC_REFERENCE,
    RUNG_TORCH,
)
# the rungs that launch the hand-written kernels (JAX: ``PALLAS_RUNGS``):
# the fault harness's default target, and what the serving engine
# quarantines wholesale on a classified failure or a detection
KERNEL_RUNGS = (RUNG_SFC_CUDA, RUNG_REPLICATED)


def schedule_namespace(base: str, key: str) -> str:
    """Namespace for a schedule-compiled op family: ``base`` (one of
    :data:`ALL_NAMESPACES`) qualified by a ``ScheduleSpec.key`` hash, so
    distinct tile spaces tune into distinct buckets."""
    if base not in ALL_NAMESPACES:
        raise ValueError(
            f"unknown base namespace {base!r}; pick from {ALL_NAMESPACES}"
        )
    if not key or "@" in key:
        raise ValueError(f"bad schedule key {key!r}")
    return f"{base}@{key}"


def is_schedule_namespace(ns: str) -> bool:
    return "@" in ns


def base_namespace(ns: str) -> str:
    """The registry namespace a (possibly schedule-qualified) name keys:
    ``"gemm@1a2b3c" -> "gemm"``; plain names pass through."""
    return ns.split("@", 1)[0]
