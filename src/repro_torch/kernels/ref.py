"""Plain-torch oracles for the port's kernels."""

from __future__ import annotations

import torch

__all__ = ["matmul_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast back to A's type — the oracle
    for the fused GEMM without its epilogue."""
    return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).to(a.dtype)
