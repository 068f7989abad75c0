"""Re-export of the GEMM-backend switch for serving call sites."""

from repro_torch.core.gemm_backend import (
    current_backend,
    gemm_backend,
    glu_matmul,
    matmul,
)

__all__ = ["gemm_backend", "current_backend", "matmul", "glu_matmul"]
