"""Plain-torch oracles for the port's kernels."""

from __future__ import annotations

import math

import torch

__all__ = ["matmul_ref", "partial_k_matmul_ref", "add_reduce_ref", "flash_attention_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast back to A's type — the oracle
    for the fused GEMM without its epilogue."""
    return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).to(a.dtype)


def partial_k_matmul_ref(a: torch.Tensor, b: torch.Tensor, k_layers: int,
                         acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(K_layers, M, N) partial products over K / K_layers slabs, f32
    accumulated and cast to A's type — the oracle for the replicated form's
    partial copies (K4) before the layer sum.  K must divide evenly, as in
    the JAX package's oracle."""
    m, k = a.shape
    if k % k_layers:
        raise ValueError(f"K={k} is not a multiple of k_layers={k_layers}")
    kl = k // k_layers
    parts = [torch.matmul(a[:, i * kl:(i + 1) * kl].to(acc_dtype), b[i * kl:(i + 1) * kl].to(acc_dtype))
             for i in range(k_layers)]
    return torch.stack(parts).to(a.dtype)


def add_reduce_ref(c_copies: torch.Tensor, acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(K_layers, M, N) -> (M, N): the layer sum in ``acc_dtype``, cast to
    the copies' type — the oracle for ``add_reduce`` (K6)."""
    return c_copies.to(acc_dtype).sum(dim=0).to(c_copies.dtype)


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
