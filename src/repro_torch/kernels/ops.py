"""Public wrappers around the SFC GEMM kernels (the port's
``repro.kernels.ops``: the forward, the NT/TN backward entry points and the
custom VJP that joins them).

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

Training.  When grad mode is on and an input needs a gradient,
`sfc_matmul` and `sfc_glu_matmul` run through `_MatmulCore`, a
``torch.autograd.Function`` (JAX: ``_matmul_core``'s custom VJP).  Its
forward is JAX's training forward: a linear epilogue is the one fused
launch; an activation is a linear launch, then the activation in f32; a GLU
is one ``preact`` launch (both biased pre-activations), then ``act(g)·h``
in f32.  Its backward computes the f32 epilogue cotangents
(`_epilogue_cotangents`), casts them to the compute type, and launches the
NT kernel for dA (`sfc_matmul_nt`, dual for the GLU) and the TN kernel for
dW (`sfc_matmul_tn`, dual for the GLU); bias gradients are sums, the
residual's passes straight through.  Under ``torch.no_grad`` (serving) the
calls keep the single fused launch with the activation in the flush.  On
CPU tensors every launch is its kernel's plain version, so the CPU runs the
same NT/TN structure as the card.

The fused optimizer.  `sfc_matmul_tn_update` is the TN kernel in its update
mode (dW and AdamW in one flush, the weight and its f32 state written in
place) and `sfc_matmul_tn_norm` in its norm mode.  `_UpdateCore` is the
autograd Function of a projection whose weight the fused optimizer routes
(JAX: ``_update_core``): its forward is `_MatmulCore`'s; its backward runs
the NT kernel for dA, hands ``(a, dh, dg)`` to the step's tape (which runs
the norm mode in the first phase of the exact clip and the update mode
after the backward) and returns no weight gradient.  Under the "torch" and
"sfc_reference" backends a routed weight takes the JAX package's oracle
instead (`fused_update_matmul(..., fused=False)`): plain autograd dW, handed
to the tape through `_RoutedWeight`, then the same AdamW program
(`plain_update`).

The grouped (MoE expert) forms.  `sfc_grouped_matmul` and
`sfc_grouped_glu_matmul` run every expert's ``epilogue(a[rows of e] @
b[e])`` in one launch of the grouped kernel (K3), the rows of each expert
packed and unpadded; `sfc_grouped_matmul_nt` (K9) and
`sfc_grouped_matmul_tn` (K10) are their dA and dW.  `_GroupedCore` is the
grouped autograd Function (JAX: ``_grouped_core``), built as `_MatmulCore`
is: the GLU forward in ``preact`` mode, the backward on K9 and K10, bias
gradients as per-expert sums.

Not ported in this slice, each raising ``NotImplementedError``: the
replicated 2.5D form (``fuse=False``, ROADMAP queue 2 K4-K6) and the ABFT
checksum lane (queue 1 item 14).  The backward has no fallback ladder
(item 14): a kernel that fails raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.sfc_gemm import (
    activation_fn,
    grouped_tn_row_block,
    kernel_tile,
    sfc_gemm_fused,
    sfc_gemm_grouped,
    sfc_gemm_grouped_nt,
    sfc_gemm_grouped_tn,
    sfc_gemm_nt,
    sfc_gemm_tn,
    stochastic_round_to,
    tile_random_bits,
)

__all__ = [
    "sfc_matmul",
    "sfc_glu_matmul",
    "sfc_matmul_nt",
    "sfc_matmul_tn",
    "sfc_matmul_tn_norm",
    "sfc_matmul_tn_update",
    "plain_update",
    "fused_update_matmul",
    "fused_update_glu_matmul",
    "sfc_grouped_matmul",
    "sfc_grouped_glu_matmul",
    "sfc_grouped_matmul_nt",
    "sfc_grouped_matmul_tn",
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


def _no_abft(abft: Optional[str]) -> None:
    if abft not in (None, "off"):
        raise NotImplementedError("the ABFT checksum lane is not ported: ROADMAP queue 1 item 14")


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
    _no_abft(abft)
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
        k_layers=k_layers, k_block_factor=k_block_factor, out_dtype=out_dtype, preact=preact,
    )
    gate = None if b_gate is None else b_gate.contiguous()
    vecs = [None if v is None else v.contiguous() for v in (bias, gate_bias)]
    if not lead:
        res = None if residual is None else residual.contiguous()
        return sfc_gemm_fused(a.contiguous(), b.contiguous(), gate, *vecs, res, **kw)

    # fold leading dims into one batch axis for the kernel grid
    bsz = math.prod(lead)
    a3 = a.reshape(bsz, m, k).contiguous()
    b3 = b.reshape(bsz, k, n).contiguous() if b_batched else b.contiguous()
    res3 = None if residual is None else residual.reshape(bsz, m, n).contiguous()
    out = sfc_gemm_fused(a3, b3, gate, *vecs, res3, **kw)
    if preact:
        return tuple(o.reshape(*lead, m, n) for o in out)
    return out.reshape(*lead, m, n)


# ---------------------------------------------------------------------------
# backward (NT / TN) entry points
# ---------------------------------------------------------------------------


def sfc_matmul_nt(
    a: torch.Tensor,  # (..., M, K)
    b: torch.Tensor,  # (N, K): consumed as bᵀ, no transposed copy
    a2: Optional[torch.Tensor] = None,  # (..., M, K) second addend
    b2: Optional[torch.Tensor] = None,  # (N, K)
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """C = A @ Bᵀ (+ A2 @ B2ᵀ) through the SFC NT kernel: the dA backward
    GEMM (``dA = dC @ Wᵀ``; the dual form is the GLU's ``dg·Wgᵀ + dh·Wvᵀ``
    in one traversal).  Leading batch dims of ``a`` fold into M (the (N, K)
    operand is shared); ragged shapes are masked by the kernel and clipped
    by its plain version, not padded.  Knobs resolve as `resolve_knobs`
    does for the forward."""
    _no_abft(abft)
    if a.ndim < 2 or b.ndim != 2 or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"sfc_matmul_nt needs a (..., M, K) and b (N, K); got {tuple(a.shape)}, {tuple(b.shape)}")
    if (a2 is None) != (b2 is None) or (a2 is not None and tuple(a2.shape) != tuple(a.shape)):
        raise ValueError("the dual form needs a2 shaped like a and b2 shaped like b")
    lead = tuple(a.shape[:-2])
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    a22d = None if a2 is None else a2.reshape(-1, a2.shape[-1]).contiguous()
    m, k = a2d.shape
    n = b.shape[0]
    bm, bn, kl, kbf = resolve_knobs(m, n, k, a.device, bm=bm, bn=bn, k_layers=k_layers,
                                    k_block_factor=k_block_factor)
    out = sfc_gemm_nt(a2d, b.contiguous(), a22d, None if b2 is None else b2.contiguous(),
                      bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf, out_dtype=out_dtype)
    return out.reshape(*lead, a.shape[-2], n)


def sfc_matmul_tn(
    a: torch.Tensor,  # (..., M, K): consumed as aᵀ, no transposed copy
    b: torch.Tensor,  # (..., M, N)
    b2: Optional[torch.Tensor] = None,  # (..., M, N) second operand
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    abft: Optional[str] = None,
):
    """C = Aᵀ @ B (and Aᵀ @ B2) through the SFC TN kernel: the dW backward
    GEMM (``dW = Aᵀ @ dC``); with ``b2`` one traversal of the activations
    flushes both weight grads (the GLU's dWv, dWg pair).  Leading batch
    dims fold into the contraction (the weight grad sums over them).
    Returns (K, N), or a pair with ``b2``."""
    _no_abft(abft)
    a2d, b2d, b22d = _tn_operands(a, b, b2)
    m, k = a2d.shape
    # the output is (K, N); the contraction runs over M
    bm, bn, kl, kbf = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                                    k_block_factor=k_block_factor)
    return sfc_gemm_tn(a2d, b2d, b22d, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf, out_dtype=out_dtype)


def _tn_operands(a, dy, dy2):
    """The TN operands as 2-D contiguous matrices, leading dims folded into
    the contraction's M rows."""
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    b2d = dy.reshape(-1, dy.shape[-1]).contiguous()
    b22d = None if dy2 is None else dy2.reshape(-1, dy2.shape[-1]).contiguous()
    if b2d.shape[0] != a2d.shape[0] or (b22d is not None and b22d.shape != b2d.shape):
        raise ValueError(f"TN row mismatch: {tuple(a.shape)}, {tuple(dy.shape)}")
    return a2d, b2d, b22d


def sfc_matmul_tn_norm(
    a: torch.Tensor,  # (..., M, K) forward activations (leading dims fold)
    dy: torch.Tensor,  # (..., M, N) output cotangent
    dy2: Optional[torch.Tensor] = None,  # (..., M, N) second cotangent (GLU)
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
):
    """``sum(dW²)`` of ``dW = Aᵀ @ dY`` (and of ``Aᵀ @ dY2``) from the TN
    kernel's norm mode: dW stays in the f32 accumulator.  The first phase
    of the fused step's exact clip (the JAX package runs the update flush at
    scale 1 and keeps only its norm tokens).  Returns an f32 scalar, or a
    pair with ``dy2``."""
    a2d, b2d, b22d = _tn_operands(a, dy, dy2)
    m, k = a2d.shape
    bm, bn, kl, kbf = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                                    k_block_factor=k_block_factor)
    norms = sfc_gemm_tn(a2d, b2d, b22d, norm=True, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf)
    return norms[0] if dy2 is None else (norms[0], norms[1])


def sfc_matmul_tn_update(
    a: torch.Tensor,  # (..., M, K) forward activations (leading dims fold)
    dy: torch.Tensor,  # (..., M, N) output cotangent
    master: torch.Tensor,  # (K, N) f32 master weights, updated in place
    mu: torch.Tensor,  # (K, N) f32, in place
    nu: torch.Tensor,  # (K, N) f32, in place
    hyper: torch.Tensor,  # (12,) f32 `optim.adamw.pack_adamw_hyper` vector
    dy2: Optional[torch.Tensor] = None,  # (..., M, N) second cotangent (GLU)
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    *,
    w: torch.Tensor,  # (K, N) the weight, in a's type, written in place
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    abft: Optional[str] = None,
):
    """Fused dW-and-AdamW: one TN launch computes ``dW = Aᵀ @ dY`` in the
    f32 accumulator and applies the update in its flush, writing W (and
    its f32 master, mu and nu) in place; dW never reaches device memory.
    Returns ``sum(dW²)`` before the scale (an f32 scalar, or a pair with
    ``dy2``, whose set is (w2, master2, mu2, nu2)).  The JAX package's
    ``sfc_matmul_tn_update`` returns the new arrays instead; its hyper
    vector carries the salt, here ``salt`` does."""
    _no_abft(abft)
    a2d, b2d, b22d = _tn_operands(a, dy, dy2)
    m, k = a2d.shape
    bm, bn, kl, kbf = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                                    k_block_factor=k_block_factor)
    norms = sfc_gemm_tn(a2d, b2d, b22d, master, mu, nu, master2, mu2, nu2, hyper, w=w, w2=w2, salt=salt,
                        stochastic_round=stochastic_round, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf)
    return norms[0] if dy2 is None else (norms[0], norms[1])


@torch.no_grad()
def plain_update(dw, master, mu, nu, w, hyper, *, salt: int, stochastic_round: bool) -> torch.Tensor:
    """The oracle backends' AdamW step from the hyper vector (the JAX
    package's ``_jnp_update``): `optim.adamw.adamw_leaf_update` on the raw
    dW, written in place, W stochastically rounded (bf16) with ONE hash over
    the whole leaf seeded ``seed ^ salt * 0x85EB`` (not per tile, so its
    bits differ from the kernel's by design).  Returns ``sum(dW²)``."""
    from repro_torch.optim import adamw as opt

    g0 = dw.float()
    sq = torch.sum(g0 * g0)
    h = hyper
    mu_n, nu_n, mst_n = opt.adamw_leaf_update(
        g0, mu, nu, master, lr=h[opt.HYP_LR], b1=h[opt.HYP_B1], b2=h[opt.HYP_B2], eps=h[opt.HYP_EPS],
        weight_decay=h[opt.HYP_WD], b1c=h[opt.HYP_B1C], b2c=h[opt.HYP_B2C], scale=h[opt.HYP_SCALE],
    )
    if stochastic_round and w.dtype == torch.bfloat16:
        flat = mst_n.reshape(-1, mst_n.shape[-1])
        seed = (opt.seed_from_lane(h[opt.HYP_SEED]).to(torch.int64) ^ (salt * 0x85EB)) & 0xFFFFFFFF
        w_sr = stochastic_round_to(flat, tile_random_bits(flat.shape, seed), w.dtype).reshape(mst_n.shape)
        w_n = torch.where(h[opt.HYP_SCALE] == 0.0, mst_n.to(w.dtype), w_sr)
    else:
        w_n = mst_n.to(w.dtype)
    mu.copy_(mu_n)
    nu.copy_(nu_n)
    master.copy_(mst_n)
    w.copy_(w_n)
    return sq


# ---------------------------------------------------------------------------
# the custom VJP: the backward pass is itself SFC GEMMs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _VjpCfg:
    glu: bool
    activation: Optional[str]
    out_scale: Optional[float]
    bm: Optional[int]
    bn: Optional[int]
    k_layers: Optional[int]
    k_block_factor: Optional[int]
    out_dtype: Optional[torch.dtype]
    fuse: Optional[bool]
    abft: Optional[str] = None


def _activation_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """d act / dx in f32, for the activations of `activation_fn`."""
    if name == "silu":
        s = torch.sigmoid(x)
        return s + x * s * (1.0 - s)
    if name == "gelu":  # the tanh form
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (x + 0.044715 * x**3))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3.0 * 0.044715 * x * x)
    if name == "relu":
        return (x > 0).to(x.dtype)
    raise ValueError(f"unknown activation {name!r}")


def _epilogue_cotangents(glu, activation, out_scale, h_pre, g_pre, dy):
    """(dh, dg) f32 cotangents of the biased pre-activations given dy: the
    epilogue-derivative prelude of the backward."""
    dyf = dy.float()
    if out_scale is not None:
        dyf = dyf * out_scale
    if glu:
        g = g_pre.float()
        dh = dyf * activation_fn(activation)(g)
        dg = dyf * h_pre.float() * _activation_grad(activation, g)
    elif activation is not None:
        dh, dg = dyf * _activation_grad(activation, h_pre.float()), None
    else:
        dh, dg = dyf, None
    return dh, dg


def _training_forward(cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, residual):
    """JAX's training forward of ``_matmul_core``: (out, h_pre, g_pre), the
    pre-activations kept for the backward (None for a linear epilogue)."""
    out_dtype = cfg.out_dtype or a.dtype
    kw = dict(bm=cfg.bm, bn=cfg.bn, k_layers=cfg.k_layers, k_block_factor=cfg.k_block_factor,
              fuse=cfg.fuse, abft=cfg.abft)
    h_pre = g_pre = None
    if cfg.glu:
        h_pre, g_pre = _matmul_impl(a, b, b_gate, bias=bias, gate_bias=gate_bias, residual=None,
                                    activation=None, out_scale=None, out_dtype=None, preact=True, **kw)
        y = activation_fn(cfg.activation)(g_pre.float()) * h_pre.float()
    elif cfg.activation is not None:
        h_pre = _matmul_impl(a, b, None, bias=bias, gate_bias=None, residual=None,
                             activation=None, out_scale=None, out_dtype=None, **kw)
        y = activation_fn(cfg.activation)(h_pre.float())
    else:
        # linear epilogue: the fully fused path is the training forward too
        out = _matmul_impl(a, b, None, bias=bias, gate_bias=None, residual=residual,
                           activation=None, out_scale=cfg.out_scale, out_dtype=cfg.out_dtype, **kw)
        return out, None, None
    if cfg.out_scale is not None:
        y = y * cfg.out_scale
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype), h_pre, g_pre


def _compute_cotangents(cfg: _VjpCfg, a, h_pre, g_pre, dy):
    """(dh, dg) in f32 and (dh_c, dg_c) in the compute type: the backward
    kernels run in the forward's compute type."""
    dh, dg = _epilogue_cotangents(cfg.glu, cfg.activation, cfg.out_scale, h_pre, g_pre, dy)
    return dh, dg, dh.to(a.dtype), None if dg is None else dg.to(a.dtype)


def _bias_grads(dh, dg, bias, gate_bias):
    lead_axes = tuple(range(dh.ndim - 1))
    dbias = None if bias is None else dh.sum(dim=lead_axes).reshape(bias.shape).to(bias.dtype)
    dgbias = None if gate_bias is None else dg.sum(dim=lead_axes).reshape(gate_bias.shape).to(gate_bias.dtype)
    return dbias, dgbias


class _MatmulCore(torch.autograd.Function):
    """``_matmul_core`` of the JAX package: the training forward on the
    forward kernel, the backward on the NT/TN kernels."""

    @staticmethod
    def forward(ctx, cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, residual):
        out, h_pre, g_pre = _training_forward(cfg, a, b, b_gate, bias, gate_bias, residual)
        ctx.cfg = cfg
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        cfg = ctx.cfg
        need_a, need_b, need_bg = ctx.needs_input_grad[1:4]
        dh, dg, dh_c, dg_c = _compute_cotangents(cfg, a, h_pre, g_pre, dy)
        da = db = dbg = None
        if b.ndim > 2:
            # per-batch weights (no model call site; the forward refuses a
            # GLU): the forward kernel on transposed copies, as in JAX
            if need_a:
                da = sfc_matmul(dh_c, b.transpose(-1, -2))
            if need_b:
                db = sfc_matmul(a.transpose(-1, -2), dh_c)
        else:
            if need_a:
                da = sfc_matmul_nt(dh_c, b, dg_c, b_gate if dg_c is not None else None)
            if need_b or need_bg:
                n = b.shape[-1]
                a2d = a.reshape(-1, a.shape[-1])
                if dg_c is not None:
                    db, dbg = sfc_matmul_tn(a2d, dh_c.reshape(-1, n), dg_c.reshape(-1, n))
                else:
                    db = sfc_matmul_tn(a2d, dh_c.reshape(-1, n))
        dbias, dgbias = _bias_grads(dh, dg, bias, gate_bias)
        dres = None if ctx.res_dtype is None else dy.to(ctx.res_dtype)
        return (
            None,
            None if da is None else da.to(a.dtype),
            None if db is None else db.to(b.dtype),
            None if dbg is None else dbg.to(b_gate.dtype),
            dbias,
            dgbias,
            dres,
        )


class _UpdateCore(torch.autograd.Function):
    """``_update_core`` of the JAX package (its fused branch) for a
    projection whose weight the fused optimizer routes: the forward is
    `_MatmulCore`'s; the backward computes the epilogue cotangents, runs the
    NT kernel for dA, hands ``(a (M, K), dh (M, N), dg)`` in the compute
    type to ``sink`` (the step's tape, which launches the TN kernel's norm
    and update modes) and returns no gradient for the weights, so dW never
    exists."""

    @staticmethod
    def forward(ctx, cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, sink):
        out, h_pre, g_pre = _training_forward(cfg, a, b, b_gate, bias, gate_bias, None)
        ctx.cfg, ctx.sink = cfg, sink
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        dh, dg, dh_c, dg_c = _compute_cotangents(ctx.cfg, a, h_pre, g_pre, dy)
        da = None
        if ctx.needs_input_grad[1]:
            da = sfc_matmul_nt(dh_c, b, dg_c, b_gate if dg_c is not None else None).to(a.dtype)
        n = b.shape[-1]
        ctx.sink(a.reshape(-1, a.shape[-1]), dh_c.reshape(-1, n), None if dg_c is None else dg_c.reshape(-1, n))
        dbias, dgbias = _bias_grads(dh, dg, bias, gate_bias)
        return None, da, None, None, dbias, dgbias, None


class _RoutedWeight(torch.autograd.Function):
    """Identity on a routed weight whose gradient goes to ``sink`` and not
    to the weight: the oracle backends' way to take plain-autograd dW
    without a ``.grad`` (the JAX package's oracle returns its update through
    the cotangent slot, which torch has no counterpart of)."""

    @staticmethod
    def forward(ctx, w, sink):
        ctx.sink = sink
        return w.view_as(w)

    @staticmethod
    def backward(ctx, dw):
        ctx.sink(dw)
        return None, None


def fused_update_matmul(x, w, sink, *, bias=None, activation=None, fused: bool = True) -> torch.Tensor:
    """Projection of a routed weight (JAX: ``fused_update_matmul``):
    ``epilogue(x @ w)`` whose backward hands the weight's share to ``sink``
    instead of a gradient.  ``fused``: `_UpdateCore` (the SFC kernels;
    ``sink(a, dh, None)``); else the oracle, ``x @ w`` in plain torch with
    ``sink(dw)``."""
    if fused:
        cfg = _VjpCfg(glu=False, activation=activation, out_scale=None, bm=None, bn=None, k_layers=None,
                      k_block_factor=None, out_dtype=None, fuse=None)
        return _UpdateCore.apply(cfg, x, w, None, bias, None, sink)
    y = x @ _RoutedWeight.apply(w, sink)
    if bias is not None:
        y = y + bias
    return activation_fn(activation)(y) if activation is not None else y


def fused_update_glu_matmul(x, w_gate, w_val, sink, *, activation="silu", bias=None, gate_bias=None,
                            fused: bool = True) -> torch.Tensor:
    """Gated projection of a routed (gate, value) pair (JAX:
    ``fused_update_glu_matmul``): one dual TN update flush serves both.
    ``fused``: `_UpdateCore`, ``sink(a, dh, dg)``; else the oracle, with
    ``sink`` a pair of callables taking dW of the value and of the gate."""
    if fused:
        cfg = _VjpCfg(glu=True, activation=activation, out_scale=None, bm=None, bn=None, k_layers=None,
                      k_block_factor=None, out_dtype=None, fuse=None)
        return _UpdateCore.apply(cfg, x, w_val, w_gate, bias, gate_bias, sink)
    sink_val, sink_gate = sink
    g = x @ _RoutedWeight.apply(w_gate, sink_gate)
    if gate_bias is not None:
        g = g + gate_bias
    h = x @ _RoutedWeight.apply(w_val, sink_val)
    if bias is not None:
        h = h + bias
    return activation_fn(activation)(g) * h


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


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
    Differentiable: with an input that needs a gradient it runs through
    `_MatmulCore` (the NT/TN kernels in the backward).
    """
    if _needs_grad(a, b, bias, residual):
        cfg = _VjpCfg(glu=False, activation=activation, out_scale=out_scale, bm=bm, bn=bn, k_layers=k_layers,
                      k_block_factor=k_block_factor, out_dtype=out_dtype, fuse=fuse, abft=abft)
        return _MatmulCore.apply(cfg, a, b, None, bias, None, residual)
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
    accumulators, one C write).  Weights are shared 2-D (K, N).
    Differentiable as `sfc_matmul` is; the forward then flushes both
    pre-activations (``preact``) and the backward runs the dual NT/TN
    forms."""
    if _needs_grad(a, b_gate, b_val, bias, gate_bias, residual):
        cfg = _VjpCfg(glu=True, activation=activation, out_scale=out_scale, bm=bm, bn=bn, k_layers=k_layers,
                      k_block_factor=k_block_factor, out_dtype=out_dtype, fuse=fuse, abft=abft)
        return _MatmulCore.apply(cfg, a, b_val, b_gate, bias, gate_bias, residual)
    return _matmul_impl(
        a, b_val, b_gate,
        bias=bias, gate_bias=gate_bias, residual=residual,
        activation=activation, out_scale=out_scale,
        bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
        out_dtype=out_dtype, fuse=fuse, abft=abft,
    )


# ---------------------------------------------------------------------------
# grouped (MoE expert) GEMMs: K3 forward, K9 dA, K10 dW, and their VJP
# ---------------------------------------------------------------------------


def _grouped_knobs(max_rows: int, n: int, k: int, device, bm, bn) -> Tuple[int, int]:
    """(bm, bn) of a grouped launch: the kernel's tile on the card; on the
    CPU the JAX package's choice, `pick_blocks` over the largest expert's
    rows with bm at most 128."""
    if torch.device(device).type == "cuda":
        bm, bn, _, _ = resolve_knobs(max_rows, n, k, device, bm=bm, bn=bn)
        return bm, bn
    pbm, pbn, _ = pick_blocks(max(max_rows, 1), n, k)
    return bm or min(pbm, 128), bn or pbn


def _grouped_impl(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b: torch.Tensor,  # (E, K, N) per-expert weights
    b_gate: Optional[torch.Tensor],  # (E, K, N) per-expert gate weights
    group_sizes,
    *,
    bias: Optional[torch.Tensor],
    gate_bias: Optional[torch.Tensor],
    activation: Optional[str],
    out_scale: Optional[float],
    bm: Optional[int],
    bn: Optional[int],
    k_block_factor: Optional[int],
    out_dtype: Optional[torch.dtype],
    preact: bool = False,
):
    """One launch of the grouped kernel (the JAX package's ``_grouped_impl``
    less its row padding and its ABFT lane: the kernel masks each expert's
    last row block)."""
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"grouped matmul needs a (T, K) and b (E, K, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    e_cnt, k, n = b.shape
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) != (e_cnt, n):
            raise ValueError(f"{name} must be (E, N)=({e_cnt},{n}), got {tuple(vec.shape)}")
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_knobs(max(gs, default=1), n, k, a.device, bm, bn)
    vecs = [None if v is None else v.contiguous() for v in (bias, gate_bias)]
    return sfc_gemm_grouped(
        a.contiguous(), b.contiguous(), None if b_gate is None else b_gate.contiguous(), *vecs,
        group_sizes=gs, activation=activation, out_scale=out_scale, bm=bm, bn=bn,
        k_block_factor=k_block_factor or 1, out_dtype=out_dtype, preact=preact,
    )


def sfc_grouped_matmul_nt(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the dC rows)
    b: torch.Tensor,  # (E, N, K) per-expert operand, consumed as b[e]ᵀ
    group_sizes,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped NT: ``out[rows of e] = a[rows of e] @ b[e]ᵀ`` (+ ``a2 @
    b2[e]ᵀ``), the grouped dA (per-expert weights read as stored) through
    K9.  Knobs as in the JAX package's ``sfc_grouped_matmul_nt``."""
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_knobs(max(gs, default=1), b.shape[-2], a.shape[-1], a.device, bm, bn)
    return sfc_gemm_grouped_nt(
        a.contiguous(), b.contiguous(), None if a2 is None else a2.contiguous(),
        None if b2 is None else b2.contiguous(),
        group_sizes=gs, bm=bm, bn=bn, k_block_factor=k_block_factor or 1, out_dtype=out_dtype,
    )


def sfc_grouped_matmul_tn(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the forward activations)
    b: torch.Tensor,  # (T, N) rows sorted by expert (the dC rows)
    group_sizes,
    b2: Optional[torch.Tensor] = None,  # (T, N) second dC (the GLU's gate grad)
    *,
    row_block: Optional[int] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Grouped TN: ``dW[e] = a[rows of e]ᵀ @ b[rows of e]`` for every
    expert in one K10 launch; with ``b2`` the activations stream once for
    both weight-grad stacks (a pair).  Knobs as in the JAX package's
    ``sfc_grouped_matmul_tn`` (the output tile from `pick_blocks`, at most
    128, the contraction chunk from the largest expert's rows)."""
    gs = tuple(int(g) for g in group_sizes)
    k, n = a.shape[-1], b.shape[-1]
    if torch.device(a.device).type == "cuda":
        bm, bn, _, _ = resolve_knobs(k, n, a.shape[0], a.device, bm=bm, bn=bn)
    elif bm is None or bn is None:
        pbm, pbn, _ = pick_blocks(k, n, max(a.shape[0], 1))
        bm, bn = bm or min(pbm, 128), bn or min(pbn, 128)
    return sfc_gemm_grouped_tn(
        a.contiguous(), b.contiguous(), None if b2 is None else b2.contiguous(),
        group_sizes=gs, bm=bm, bn=bn, row_block=row_block or grouped_tn_row_block(gs), out_dtype=out_dtype,
    )


@dataclasses.dataclass(frozen=True)
class _GroupedVjpCfg:
    group_sizes: Tuple[int, ...]
    glu: bool
    activation: Optional[str]
    out_scale: Optional[float]
    bm: Optional[int]
    bn: Optional[int]
    k_block_factor: Optional[int]
    out_dtype: Optional[torch.dtype]


def _grouped_training_forward(cfg: _GroupedVjpCfg, a, b, b_gate, bias, gate_bias):
    """JAX's ``_grouped_core_fwd``: (out, h_pre, g_pre)."""
    out_dtype = cfg.out_dtype or a.dtype
    kw = dict(bm=cfg.bm, bn=cfg.bn, k_block_factor=cfg.k_block_factor)
    h_pre = g_pre = None
    if cfg.glu:
        h_pre, g_pre = _grouped_impl(a, b, b_gate, cfg.group_sizes, bias=bias, gate_bias=gate_bias,
                                     activation=None, out_scale=None, out_dtype=None, preact=True, **kw)
        y = activation_fn(cfg.activation)(g_pre.float()) * h_pre.float()
    elif cfg.activation is not None:
        h_pre = _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None,
                              activation=None, out_scale=None, out_dtype=None, **kw)
        y = activation_fn(cfg.activation)(h_pre.float())
    else:
        out = _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None,
                            activation=None, out_scale=cfg.out_scale, out_dtype=cfg.out_dtype, **kw)
        return out, None, None
    if cfg.out_scale is not None:
        y = y * cfg.out_scale
    return y.to(out_dtype), h_pre, g_pre


def _segment_sums(x: torch.Tensor, group_sizes) -> torch.Tensor:
    """(E, N) f32 per-expert sums of the rows of ``x`` (T, N), each in its
    own reduction: no atomics."""
    parts = torch.split(x.float(), list(group_sizes))
    return torch.stack([p.sum(dim=0) for p in parts])


class _GroupedCore(torch.autograd.Function):
    """``_grouped_core`` of the JAX package: the training forward on K3
    (the GLU in ``preact`` mode), the backward on K9 (dA) and K10 (dW)."""

    @staticmethod
    def forward(ctx, cfg: _GroupedVjpCfg, a, b, b_gate, bias, gate_bias):
        out, h_pre, g_pre = _grouped_training_forward(cfg, a, b, b_gate, bias, gate_bias)
        ctx.cfg = cfg
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        cfg = ctx.cfg
        gs = cfg.group_sizes
        need_a, need_b, need_bg = ctx.needs_input_grad[1:4]
        dh, dg = _epilogue_cotangents(cfg.glu, cfg.activation, cfg.out_scale, h_pre, g_pre, dy)
        dh_c = dh.to(a.dtype)
        dg_c = None if dg is None else dg.to(a.dtype)
        da = db = dbg = None
        if need_a:
            # (E, K, N) weights as stored are the NT kernel's (E, N', K') operand
            da = sfc_grouped_matmul_nt(dh_c, b, gs, dg_c, b_gate if dg_c is not None else None)
        if need_b or need_bg:
            if dg_c is not None:
                db, dbg = sfc_grouped_matmul_tn(a, dh_c, gs, dg_c)
            else:
                db = sfc_grouped_matmul_tn(a, dh_c, gs)
        dbias = None if bias is None else _segment_sums(dh, gs).to(bias.dtype)
        dgbias = None if gate_bias is None else _segment_sums(dg, gs).to(gate_bias.dtype)
        return (
            None,
            None if da is None else da.to(a.dtype),
            None if db is None else db.to(b.dtype),
            None if dbg is None else dbg.to(b_gate.dtype),
            dbias,
            dgbias,
        )


def sfc_grouped_matmul(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b: torch.Tensor,  # (E, K, N) per-expert weights
    group_sizes,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Ragged grouped GEMM: ``out[rows of e] = epilogue(a[rows of e] @
    b[e])`` for every expert in one launch of K3, the epilogue (per-expert
    ``bias`` (E, N), ``activation``, ``out_scale``) in its flush.
    ``group_sizes`` are the experts' row counts (zero is legal), summing to
    ``a``'s rows.  Differentiable: with an input that needs a gradient it
    runs through `_GroupedCore` (K9 and K10 in the backward)."""
    cfg = _GroupedVjpCfg(group_sizes=tuple(int(g) for g in group_sizes), glu=False, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
    if _needs_grad(a, b, bias):
        return _GroupedCore.apply(cfg, a, b, None, bias, None)
    return _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)


def sfc_grouped_glu_matmul(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b_gate: torch.Tensor,  # (E, K, N) per-expert gate weights
    b_val: torch.Tensor,  # (E, K, N) per-expert value weights
    group_sizes,
    *,
    activation: str = "silu",
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    out_scale: Optional[float] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Ragged grouped gated MLP ``act(a@b_gate[e] + gate_bias[e]) *
    (a@b_val[e] + bias[e])`` per expert in one dual-B launch of K3: each
    dispatched row slab is read once for both weight stacks.
    Differentiable through `_GroupedCore` (the dual K9 and K10 forms)."""
    cfg = _GroupedVjpCfg(group_sizes=tuple(int(g) for g in group_sizes), glu=True, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
    if _needs_grad(a, b_gate, b_val, bias, gate_bias):
        return _GroupedCore.apply(cfg, a, b_val, b_gate, bias, gate_bias)
    return _grouped_impl(a, b_val, b_gate, cfg.group_sizes, bias=bias, gate_bias=gate_bias, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
