"""Plain-torch oracles for the port's kernels."""

from __future__ import annotations

import math

import torch

__all__ = ["matmul_ref", "flash_attention_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast back to A's type — the oracle
    for the fused GEMM without its epilogue."""
    return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).to(a.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    causal: bool = True,
) -> torch.Tensor:
    """Dense attention oracle for the flash kernels (f32 softmax).

    GQA repeats each kv head over its group of q heads.  The causal mask is
    start-aligned: q position i attends k[0..i] (callers with a cache pass
    absolute positions), masked scores are -1e30."""
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    groups = h // hkv
    kk = k.repeat_interleave(groups, dim=2)
    vv = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return o.to(q.dtype)
