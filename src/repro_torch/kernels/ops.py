"""Public wrappers around the SFC fused-GEMM kernel (the port's
``repro.kernels.ops`` forward half).

`sfc_matmul` accepts ``(M, K) @ (K, N)``, ``(..., M, K) @ (K, N)`` (shared
weights) and ``(..., M, K) @ (..., K, N)``, validates the operands and the
epilogue, folds the leading dims into one batch axis and launches **one**
fused-epilogue kernel: ``C = act(A@B + bias) * out_scale + residual`` on the
f32 accumulator, one write of C.  `sfc_glu_matmul` is the dual-B gated form
(``act(A@Wg + gate_bias) * (A@Wv + bias)``, one traversal of A).

Ragged M/N/K need no padding here: the CUDA kernel masks its edge tiles and
the plain version clips them.  Knobs: on the CPU, ``bm``/``bn`` come from
`pick_blocks` (as in the JAX package, minus its tune cache and perf model);
on the card they are the kernel's compiled tile, and the K loop runs inside
one CTA, so the fused plan always fits (no VMEM budget, no replicated
fallback).

Not ported in this slice, each raising ``NotImplementedError``: the
replicated 2.5D form (``fuse=False``, ROADMAP queue 2 K4-K6), the training
forward's ``preact`` output (queue 1 item 9) and the ABFT checksum lane
(queue 1 item 14).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.sfc_gemm import kernel_tile, sfc_gemm_fused

__all__ = [
    "sfc_matmul",
    "sfc_glu_matmul",
    "pick_blocks",
    "resolve_knobs",
    "reference_knobs",
]


def pick_blocks(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """(bm, bn, bk): the largest of 256, 128, ..., 8 that divides each
    extent, else the extent itself."""

    def pick(dim: int) -> int:
        for cand in (256, 128, 64, 32, 16, 8):
            if dim % cand == 0:
                return cand
        return dim

    return pick(m), pick(n), pick(k)


def resolve_knobs(
    m: int,
    n: int,
    k: int,
    device: torch.device,
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """(bm, bn, k_layers, k_block_factor) for one launch.

    On a CUDA device the tile is the kernel's compiled one and an explicit
    other ``bm``/``bn`` is an error; on the CPU unset blocks come from
    `pick_blocks`.  Unset K knobs are 1: there is no tune cache or perf
    model yet (ROADMAP queue 1 item 13)."""
    if torch.device(device).type == "cuda":
        tile = kernel_tile()
        if (bm or tile[0], bn or tile[1]) != tile:
            raise ValueError(f"the CUDA kernel is compiled for (bm, bn)={tile}, got {(bm, bn)}")
        bm, bn = tile
    elif bm is None or bn is None:
        pbm, pbn, _ = pick_blocks(m, n, k)
        bm = bm or pbm
        bn = bn or pbn
    return bm, bn, k_layers or 1, k_block_factor or 1


def reference_knobs(m: int, n: int, k: int) -> Tuple[int, int, int, int, int]:
    """(bm, bn, bk, k_layers, k_block_factor) for `sfc_ca_gemm_reference`:
    divisor blocks from `pick_blocks`, one K layer and one chunk (the JAX
    package draws the K knobs from its perf model; they order the sum and
    do not change its value beyond rounding)."""
    bm, bn, bk = pick_blocks(m, n, k)
    return bm, bn, bk, 1, 1


def _matmul_impl(
    a: torch.Tensor,
    b: torch.Tensor,
    b_gate: Optional[torch.Tensor],
    *,
    bias: Optional[torch.Tensor],
    gate_bias: Optional[torch.Tensor],
    residual: Optional[torch.Tensor],
    activation: Optional[str],
    out_scale: Optional[float],
    bm: Optional[int],
    bn: Optional[int],
    k_layers: Optional[int],
    k_block_factor: Optional[int],
    out_dtype: Optional[torch.dtype],
    fuse: Optional[bool] = None,
    preact: bool = False,
    abft: Optional[str] = None,
) -> torch.Tensor:
    if fuse is False:
        raise NotImplementedError(
            "the replicated 2.5D form (fuse=False) is not ported: ROADMAP queue 2, K4-K6"
        )
    if preact:
        raise NotImplementedError(
            "preact (the training forward's GLU pre-activations) is not ported: ROADMAP queue 1 item 9"
        )
    if abft not in (None, "off"):
        raise NotImplementedError(
            "the ABFT checksum lane is not ported: ROADMAP queue 1 item 14"
        )
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"sfc_matmul needs matrices, got {tuple(a.shape)} @ {tuple(b.shape)}")

    glu = b_gate is not None
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    b_batched = b.ndim > 2
    if b_batched and tuple(b.shape[:-2]) != lead:
        raise ValueError(f"batch dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if glu:
        if b_gate.ndim != 2 or tuple(b_gate.shape) != tuple(b.shape[-2:]):
            raise ValueError(
                f"GLU gate weights must be (K, N)={tuple(b.shape[-2:])}, got {tuple(b_gate.shape)}"
            )
        if b_batched:
            raise ValueError("GLU form requires shared 2-D value weights")
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) not in ((n,), (1, n)):
            raise ValueError(f"{name} must be (N,) or (1, N) with N={n}, got {tuple(vec.shape)}")
    if residual is not None and tuple(residual.shape) != (*lead, m, n):
        raise ValueError(f"residual shape {tuple(residual.shape)} != output {(*lead, m, n)}")

    bm, bn, k_layers, k_block_factor = resolve_knobs(
        m, n, k, a.device, bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor
    )
    kw = dict(
        activation=activation, out_scale=out_scale, bm=bm, bn=bn,
        k_layers=k_layers, k_block_factor=k_block_factor, out_dtype=out_dtype,
    )
    gate = None if b_gate is None else b_gate.contiguous()
    vecs = [None if v is None else v.contiguous() for v in (bias, gate_bias)]
    if not lead:
        res = None if residual is None else residual.contiguous()
        return sfc_gemm_fused(a.contiguous(), b.contiguous(), gate, *vecs, res, **kw)

    # fold leading dims into one batch axis for the kernel grid
    bsz = 1
    for d in lead:
        bsz *= d
    a3 = a.reshape(bsz, m, k).contiguous()
    b3 = b.reshape(bsz, k, n).contiguous() if b_batched else b.contiguous()
    res3 = None if residual is None else residual.reshape(bsz, m, n).contiguous()
    out = sfc_gemm_fused(a3, b3, gate, *vecs, res3, **kw)
    return out.reshape(*lead, m, n)


def sfc_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    fuse: Optional[bool] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """C = epilogue(A @ B) through the SFC fused kernel, any leading batch
    dims on A.

    ``a``: (..., M, K); ``b``: (K, N) shared across the batch, or
    (..., K, N) with leading dims matching ``a``'s.  The epilogue — ``bias``
    (N,), ``activation`` in {"silu", "gelu", "relu"}, ``out_scale`` (a
    Python float) and ``residual`` (..., M, N) — runs in the kernel's flush:
    ``C = act(A@B + bias) * out_scale + residual`` on the f32 accumulator.
    """
    return _matmul_impl(
        a, b, None,
        bias=bias, gate_bias=None, residual=residual,
        activation=activation, out_scale=out_scale,
        bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
        out_dtype=out_dtype, fuse=fuse, abft=abft,
    )


def sfc_glu_matmul(
    a: torch.Tensor,
    b_gate: torch.Tensor,
    b_val: torch.Tensor,
    *,
    activation: str = "silu",
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    fuse: Optional[bool] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """Gated-MLP projection ``act(A@Wg + gate_bias) * (A@Wv + bias)`` in one
    SFC traversal of A (dual-B kernel: two weight panels, two f32
    accumulators, one C write).  Weights are shared 2-D (K, N)."""
    return _matmul_impl(
        a, b_val, b_gate,
        bias=bias, gate_bias=gate_bias, residual=residual,
        activation=activation, out_scale=out_scale,
        bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
        out_dtype=out_dtype, fuse=fuse, abft=abft,
    )
