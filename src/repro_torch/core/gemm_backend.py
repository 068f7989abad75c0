"""Pluggable GEMM backend for model projections (paper §IV-D integration).

`matmul()` and `glu_matmul()` are the call sites every dense projection in
`repro_torch.models` goes through; the active backend is a contextvar:

  "torch"          ``x @ w`` + the epilogue in the compute type — the
                   counterpart of the JAX package's "xla" (the default)
  "sfc_cuda"       the hand-written SFC fused-GEMM kernel, epilogue and
                   GLU gate inside its flush (its plain version on CPU
                   tensors)
  "sfc_reference"  the Listing-1 loop in plain torch

Every backend is differentiable.  "torch" and "sfc_reference" are plain
torch ops under autograd; under "sfc_cuda", with an input that needs a
gradient, `matmul` and `glu_matmul` run through `kernels.ops`'s autograd
Function, whose backward launches the NT (dA) and TN (dW) kernels.  There
is no fallback ladder: "sfc_cuda" launches the kernel on a CUDA tensor or
raises.

The fused optimizer (`optim.fused`): while a fused step's session is
active, a weight it routes goes through `ops.fused_update_matmul` /
`fused_update_glu_matmul` instead (the TN kernel's update flush under
"sfc_cuda", the JAX package's oracle under the other backends), and a
routing probe counts the parameters that reach these call sites.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.core.namespaces import (
    BACKEND_SFC_CUDA,
    BACKEND_TORCH,
    BACKENDS,
)
from repro_torch.optim import fused as _fused

__all__ = ["gemm_backend", "current_backend", "matmul", "glu_matmul"]

_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "gemm_backend", default=BACKEND_TORCH
)


@contextlib.contextmanager
def gemm_backend(name: str):
    """Select the GEMM backend for the calls made inside the block."""
    if name not in BACKENDS:
        raise ValueError(f"unknown gemm backend {name!r}; pick from {BACKENDS}")
    tok = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(tok)


def current_backend() -> str:
    return _BACKEND.get()


def _act(name: Optional[str]):
    from repro_torch.kernels.sfc_gemm import activation_fn

    return activation_fn(name)


def _epilogue(y, *, bias=None, activation=None, out_scale=None, residual=None):
    """Epilogue of the torch/reference paths, in the compute type."""
    if bias is not None:
        y = y + bias
    if activation is not None:
        y = _act(activation)(y)
    if out_scale is not None:
        y = y * out_scale
    if residual is not None:
        y = y + residual
    return y


def _reference_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Listing-1 reference with divisor blocks from `ops.reference_knobs`."""
    from repro_torch.core.sfc_gemm import sfc_ca_gemm_reference
    from repro_torch.kernels.ops import reference_knobs

    m, k = x2.shape
    bm, bn, bk, kl, kbf = reference_knobs(m, w.shape[1], k)
    return sfc_ca_gemm_reference(
        x2, w, bm=bm, bn=bn, bk=bk, k_layers=kl, k_block_factor=kbf
    )


def _kernel_operands(x, residual, n):
    """The kernel's view of ``x``: a 1-D ``x`` becomes one row, and a
    decode-shaped (B, 1, K) ``x`` is flattened into M (a batched grid would
    run one single-row task per element).  Returns (x_run, res_run, post)."""
    if x.ndim == 1:
        res = residual[None] if residual is not None else None
        return x[None], res, lambda out: out[0]
    if x.ndim > 2 and x.shape[-2] == 1:
        res = residual.reshape(-1, n) if residual is not None else None
        return x.reshape(-1, x.shape[-1]), res, lambda out: out.reshape(*x.shape[:-1], n)
    return x, residual, None


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """epilogue((..., K) @ (K, N)) through the active backend.

    Under "sfc_cuda", rank-2 ``x`` launches the kernel's plain mode and
    rank >= 3 its batched mode (one SFC traversal per batch element, the
    weight panels shared), except decode-shaped (B, 1, K), which is
    flattened to (B, K).  A weight routed by the active fused step goes
    through the update path (no ``out_scale`` or ``residual`` there, as in
    the JAX package)."""
    name = _BACKEND.get()
    fusable = out_scale is None and residual is None
    probe = _fused.current_probe()
    if probe is not None and fusable:
        probe.observe(w, "matmul")
    session = _fused.current_session()
    leaf = session.lookup(w) if session is not None else None
    if leaf is not None:
        if not fusable:
            raise NotImplementedError("fused-optimizer routing does not support out_scale/residual epilogues; "
                                      "exclude this weight with fused_filter")
        from repro_torch.kernels.ops import fused_update_matmul

        slot = session.slot(leaf)
        if name == BACKEND_SFC_CUDA:
            x_run, _, post = _kernel_operands(x, None, w.shape[1])
            out = fused_update_matmul(x_run, w, slot, bias=bias, activation=activation)
            return post(out) if post is not None else out
        return fused_update_matmul(x, w, slot.dw_sink(0), bias=bias, activation=activation, fused=False)
    if name == BACKEND_TORCH or w.ndim != 2:
        return _epilogue(
            x @ w, bias=bias, activation=activation,
            out_scale=out_scale, residual=residual,
        )
    if name == BACKEND_SFC_CUDA:
        from repro_torch.kernels.ops import sfc_matmul

        x_run, res_run, post = _kernel_operands(x, residual, w.shape[1])
        out = sfc_matmul(
            x_run, w, bias=bias, activation=activation,
            out_scale=out_scale, residual=res_run,
        )
        return post(out) if post is not None else out
    lead = x.shape[:-1]
    k = x.shape[-1]
    out = _reference_matmul(x.reshape(-1, k), w).reshape(*lead, w.shape[1])
    return _epilogue(
        out, bias=bias, activation=activation,
        out_scale=out_scale, residual=residual,
    )


def glu_matmul(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_val: torch.Tensor,
    *,
    activation: str = "silu",
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gated projection ``act(x@w_gate + gate_bias) * (x@w_val + bias)``
    through the active backend.  Under "sfc_cuda" the dual-B kernel
    traverses ``x`` once: two weight panels, two f32 accumulators, one
    fused flush.  Routed by the active fused step, the pair goes through
    the dual update path; both weights must be routed or neither."""
    name = _BACKEND.get()
    fusable = out_scale is None and residual is None
    probe = _fused.current_probe()
    if probe is not None and fusable:
        probe.observe(w_gate, "glu")
        probe.observe(w_val, "glu")
    session = _fused.current_session()
    if session is not None and (session.lookup(w_gate) is not None or session.lookup(w_val) is not None):
        leaf_g, leaf_v = session.lookup(w_gate), session.lookup(w_val)
        if leaf_g is None or leaf_v is None:
            raise ValueError("GLU gate/value weights must be fused-routed together; adjust fused_filter so both "
                             "(or neither) match")
        if not fusable:
            raise NotImplementedError("fused-optimizer routing does not support out_scale/residual epilogues; "
                                      "exclude these weights with fused_filter")
        from repro_torch.kernels.ops import fused_update_glu_matmul

        slot = session.slot(leaf_v, leaf_g)
        kw = dict(activation=activation, bias=bias, gate_bias=gate_bias)
        if name == BACKEND_SFC_CUDA:
            x_run, _, post = _kernel_operands(x, None, w_val.shape[1])
            out = fused_update_glu_matmul(x_run, w_gate, w_val, slot, **kw)
            return post(out) if post is not None else out
        return fused_update_glu_matmul(x, w_gate, w_val, (slot.dw_sink(0), slot.dw_sink(1)), fused=False, **kw)
    if name == BACKEND_TORCH or w_val.ndim != 2:
        g = x @ w_gate
        if gate_bias is not None:
            g = g + gate_bias
        h = x @ w_val
        if bias is not None:
            h = h + bias
        return _epilogue(
            _act(activation)(g) * h, out_scale=out_scale, residual=residual
        )
    if name == BACKEND_SFC_CUDA:
        from repro_torch.kernels.ops import sfc_glu_matmul

        x_run, res_run, post = _kernel_operands(x, residual, w_val.shape[1])
        out = sfc_glu_matmul(
            x_run, w_gate, w_val, activation=activation, bias=bias,
            gate_bias=gate_bias, out_scale=out_scale, residual=res_run,
        )
        return post(out) if post is not None else out
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    g = _reference_matmul(x2, w_gate).reshape(*lead, w_gate.shape[1])
    h = _reference_matmul(x2, w_val).reshape(*lead, w_val.shape[1])
    if gate_bias is not None:
        g = g + gate_bias
    if bias is not None:
        h = h + bias
    return _epilogue(
        _act(activation)(g) * h, out_scale=out_scale, residual=residual
    )
