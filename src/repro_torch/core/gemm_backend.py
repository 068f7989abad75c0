"""Pluggable GEMM backend for model projections (paper §IV-D integration).

`matmul()` and `glu_matmul()` are the call sites every dense projection in
`repro_torch.models` goes through; the active backend is a contextvar:

  "torch"          ``x @ w`` + the epilogue in the compute type — the
                   counterpart of the JAX package's "xla" (the default)
  "sfc_cuda"       the hand-written SFC fused-GEMM kernel, epilogue and
                   GLU gate inside its flush (its plain version on CPU
                   tensors) — the JAX package's "sfc_pallas"
  "replicated"     the replicated 2.5D form, ``fuse=False``: the split-K
                   partial copies (K4, K5 batched) and their sum (K6,
                   when k_layers > 1), the epilogue after in f32; the GLU
                   as two products with f32 copies — JAX's "replicated"
                   rung
  "sfc_reference"  the Listing-1 loop in plain torch

The four are the JAX fallback ladder's rungs, one to one; the port has no
ladder (ROADMAP item 14), so a backend is chosen, never fallen back to.
Every backend is differentiable.  "torch" and "sfc_reference" are plain
torch ops under autograd; under "sfc_cuda" and "replicated", with an input
that needs a gradient, `matmul` and `glu_matmul` run through
`kernels.ops`'s autograd Function, whose backward launches the NT (dA) and
TN (dW) kernels.  A kernel backend launches its kernels on a CUDA tensor or
raises.

"replicated" changes only `matmul` and `glu_matmul`: in the JAX package,
failing the gemm / glu fused rungs leaves every other namespace on its
first rung, so the grouped entry points, the fused optimizer's routes and
everything else run as under "sfc_cuda" (attention is `attn_impl`'s).

`grouped_matmul()` and `grouped_glu_matmul()` are the MoE expert GEMMs,
``(..., E, C, K) @ (E, K, N)`` over dispatch buffers of C capacity rows
per (token group, expert): an einsum under "torch", one launch of the
grouped SFC kernel (K3) under "sfc_cuda" with each expert's rows gathered
by `_rows_by_expert`, and Listing 1 per expert under "sfc_reference".

The fused optimizer (`optim.fused`): while a fused step's session is
active, a weight it routes goes through `ops.fused_update_matmul` /
`fused_update_glu_matmul` instead, and an expert stack through
`ops.fused_update_grouped_matmul` / `fused_update_grouped_glu_matmul` (the
TN kernel's or K10's update flush under "sfc_cuda", the JAX package's
oracle under the other backends); a routing probe counts the parameters
that reach these call sites.

`chunk_einsum()` is the chunked-recurrence intra-chunk block (the SSD's
scores and output product, the mLSTM's qk scores and numerator): under
"sfc_cuda" one batched launch of the fused kernel (K2) with per-batch B,
its f32-output mode where the caller asks for f32; under every other
backend ``torch.einsum``, as the JAX package's is ``jnp.einsum`` there.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.core.namespaces import (
    BACKEND_REPLICATED,
    BACKEND_SFC_CUDA,
    BACKEND_TORCH,
    BACKENDS,
    NS_GEMM,
    NS_GLU,
)
from repro_torch.optim import fused as _fused

__all__ = ["gemm_backend", "current_backend", "matmul", "glu_matmul", "grouped_matmul", "grouped_glu_matmul",
           "chunk_einsum"]

_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "gemm_backend", default=BACKEND_TORCH
)
# the backends that launch the SFC kernels
_KERNEL_BACKENDS = (BACKEND_SFC_CUDA, BACKEND_REPLICATED)


@contextlib.contextmanager
def gemm_backend(name: str, *, abft: Optional[str] = None):
    """Select the GEMM backend for the calls made inside the block; ``abft``
    ("off" | "detect" | "strict"; None leaves the ambient
    `robust.abft.abft_mode` as it is) sets the ABFT mode of every kernel
    launch made inside it.  Under "sfc_cuda" and "replicated" the kernels
    check their checksums; "torch" and "sfc_reference" check nothing, as the
    JAX package's "xla" and "sfc_reference" do not."""
    if name not in BACKENDS:
        raise ValueError(f"unknown gemm backend {name!r}; pick from {BACKENDS}")
    tok = _BACKEND.set(name)
    try:
        if abft is None:
            yield
        else:
            from repro_torch.robust.abft import abft_mode

            with abft_mode(abft):
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


def _reference_matmul(x2: torch.Tensor, w: torch.Tensor, op: str = NS_GEMM) -> torch.Tensor:
    """Listing-1 reference with the knobs of `ops.reference_knobs` (``op``:
    the tune-cache namespace, "glu" for the gate and value products)."""
    from repro_torch.core.sfc_gemm import sfc_ca_gemm_reference
    from repro_torch.kernels.ops import reference_knobs

    m, k = x2.shape
    bm, bn, bk, kl, kbf = reference_knobs(m, w.shape[1], k, x2.dtype, op)
    return sfc_ca_gemm_reference(
        x2, w, bm=bm, bn=bn, bk=bk, k_layers=kl, k_block_factor=kbf
    )


def _fuse(name: str) -> Optional[bool]:
    """``fuse`` of a kernel backend's `sfc_matmul` call: False (the
    replicated form) under "replicated", the fused form otherwise."""
    return False if name == BACKEND_REPLICATED else None


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
    flattened to (B, K).  "replicated" takes the same operands to the
    partial-copy kernel (K4 plain, K5 batched), then K6 and the epilogue.
    A weight routed by the active fused step goes
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
        if name in _KERNEL_BACKENDS:
            x_run, _, post = _kernel_operands(x, None, w.shape[1])
            out = fused_update_matmul(x_run, w, slot, bias=bias, activation=activation)
            return post(out) if post is not None else out
        return fused_update_matmul(x, w, slot.dw_sink(0), bias=bias, activation=activation, fused=False)
    if name == BACKEND_TORCH or w.ndim != 2:
        return _epilogue(
            x @ w, bias=bias, activation=activation,
            out_scale=out_scale, residual=residual,
        )
    if name in _KERNEL_BACKENDS:
        from repro_torch.kernels.ops import sfc_matmul

        x_run, res_run, post = _kernel_operands(x, residual, w.shape[1])
        out = sfc_matmul(
            x_run, w, bias=bias, activation=activation,
            out_scale=out_scale, residual=res_run, fuse=_fuse(name),
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
    fused flush; under "replicated" the two products are replicated-form
    launches with f32 copies, the gate's activation applied after them.
    Routed by the active fused step, the pair goes through
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
        if name in _KERNEL_BACKENDS:
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
    if name in _KERNEL_BACKENDS:
        from repro_torch.kernels.ops import sfc_glu_matmul

        x_run, res_run, post = _kernel_operands(x, residual, w_val.shape[1])
        out = sfc_glu_matmul(
            x_run, w_gate, w_val, activation=activation, bias=bias,
            gate_bias=gate_bias, out_scale=out_scale, residual=res_run,
            fuse=_fuse(name),
        )
        return post(out) if post is not None else out
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    g = _reference_matmul(x2, w_gate, NS_GLU).reshape(*lead, w_gate.shape[1])
    h = _reference_matmul(x2, w_val, NS_GLU).reshape(*lead, w_val.shape[1])
    if gate_bias is not None:
        g = g + gate_bias
    if bias is not None:
        h = h + bias
    return _epilogue(
        _act(activation)(g) * h, out_scale=out_scale, residual=residual
    )


# ---------------------------------------------------------------------------
# grouped (MoE expert) GEMMs
# ---------------------------------------------------------------------------


def _rows_by_expert(x: torch.Tensor):
    """(..., E, C, K) -> ((E*g*C, K) rows grouped by expert, (g, E, C),
    restore), g the product of the leading dims; ``restore(out, n)`` puts
    the (E*g*C, n) result back as (..., E, C, n)."""
    e, c, k = x.shape[-3:]
    lead = tuple(x.shape[:-3])
    g = 1
    for d in lead:
        g *= d
    rows = x.reshape(g, e, c, k).transpose(0, 1).reshape(e * g * c, k)

    def restore(out: torch.Tensor, n: int) -> torch.Tensor:
        return out.reshape(e, g, c, n).transpose(0, 1).reshape(*lead, e, c, n)

    return rows, (g, e, c), restore


def grouped_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-expert contraction ``(..., E, C, K) @ (E, K, N) -> (..., E, C,
    N)`` through the active backend, with an optional per-expert epilogue
    (``bias`` (E, N), ``activation``, ``out_scale``).  Under "sfc_cuda" the
    experts' rows go through one grouped kernel launch (K3) with the
    epilogue in its flush; differentiable (K9 / K10 in the backward).  A
    stack routed by the active fused step goes through the grouped update
    path (no ``out_scale`` there, as in the JAX package)."""
    name = _BACKEND.get()
    probe = _fused.current_probe()
    if probe is not None and out_scale is None:
        probe.observe(w, "grouped")
    session = _fused.current_session()
    leaf = session.lookup(w) if session is not None else None
    if leaf is not None:
        if out_scale is not None:
            raise NotImplementedError("fused-optimizer routing does not support the out_scale epilogue; exclude "
                                      "this weight with fused_filter")
        from repro_torch.kernels.ops import fused_update_grouped_matmul

        slot = session.slot(leaf)
        rows, (g, e, c), restore = _rows_by_expert(x)
        fused = name in _KERNEL_BACKENDS
        out = fused_update_grouped_matmul(rows, w, (g * c,) * e, slot if fused else slot.dw_sink(0), bias=bias,
                                          activation=activation, fused=fused)
        return restore(out, w.shape[-1])
    if name == BACKEND_TORCH:
        y = torch.einsum("...eck,ekn->...ecn", x, w)
        if bias is not None:
            y = y + bias[..., :, None, :]
        return _epilogue(y, activation=activation, out_scale=out_scale)
    rows, (g, e, c), restore = _rows_by_expert(x)
    n = w.shape[-1]
    if name in _KERNEL_BACKENDS:
        from repro_torch.kernels.ops import sfc_grouped_matmul

        out = sfc_grouped_matmul(rows, w, (g * c,) * e, bias=bias, activation=activation, out_scale=out_scale)
        return restore(out, n)
    parts = []
    for ei in range(e):
        ye = _reference_matmul(rows[ei * g * c:(ei + 1) * g * c], w[ei])
        parts.append(ye if bias is None else ye + bias[ei])
    return restore(_epilogue(torch.cat(parts), activation=activation, out_scale=out_scale), n)


def grouped_glu_matmul(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_val: torch.Tensor,
    *,
    activation: str = "silu",
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-expert gated MLP ``act(x@w_gate[e]) * (x@w_val[e])`` over ``(...,
    E, C, K)`` dispatch buffers.  Under "sfc_cuda" the dual-B grouped kernel
    (K3) reads the dispatched rows once for both expert weight stacks, the
    gate's activation in its flush.  Routed by the active fused step, the
    pair goes through the dual grouped update path; both stacks must be
    routed or neither."""
    name = _BACKEND.get()
    probe = _fused.current_probe()
    if probe is not None and out_scale is None:
        probe.observe(w_gate, "grouped_glu")
        probe.observe(w_val, "grouped_glu")
    session = _fused.current_session()
    if session is not None and (session.lookup(w_gate) is not None or session.lookup(w_val) is not None):
        leaf_g, leaf_v = session.lookup(w_gate), session.lookup(w_val)
        if leaf_g is None or leaf_v is None:
            raise ValueError("GLU gate/value expert stacks must be fused-routed together; adjust fused_filter so "
                             "both (or neither) match")
        if out_scale is not None:
            raise NotImplementedError("fused-optimizer routing does not support the out_scale epilogue; exclude "
                                      "these stacks with fused_filter")
        from repro_torch.kernels.ops import fused_update_grouped_glu_matmul

        slot = session.slot(leaf_v, leaf_g)
        rows, (g, e, c), restore = _rows_by_expert(x)
        fused = name in _KERNEL_BACKENDS
        out = fused_update_grouped_glu_matmul(rows, w_gate, w_val, (g * c,) * e,
                                              slot if fused else (slot.dw_sink(0), slot.dw_sink(1)),
                                              activation=activation, fused=fused)
        return restore(out, w_val.shape[-1])
    if name == BACKEND_TORCH:
        g_ = torch.einsum("...eck,ekn->...ecn", x, w_gate)
        h = torch.einsum("...eck,ekn->...ecn", x, w_val)
        return _epilogue(_act(activation)(g_) * h, out_scale=out_scale)
    rows, (g, e, c), restore = _rows_by_expert(x)
    n = w_val.shape[-1]
    if name in _KERNEL_BACKENDS:
        from repro_torch.kernels.ops import sfc_grouped_glu_matmul

        out = sfc_grouped_glu_matmul(rows, w_gate, w_val, (g * c,) * e, activation=activation,
                                     out_scale=out_scale)
        return restore(out, n)
    parts = []
    for ei in range(e):
        xe = rows[ei * g * c:(ei + 1) * g * c]
        parts.append(_act(activation)(_reference_matmul(xe, w_gate[ei], NS_GLU))
                     * _reference_matmul(xe, w_val[ei], NS_GLU))
    return restore(_epilogue(torch.cat(parts), out_scale=out_scale), n)


# ---------------------------------------------------------------------------
# chunked-recurrence einsums (xLSTM / SSM intra-chunk blocks)
# ---------------------------------------------------------------------------

# Each supported signature is a pure transpose framing of a batched
# (..., M, K) @ (..., K, N) product: (a_perm, b_perm, swap_b, out_perm), the
# JAX package's table (core/gemm_backend.py:_CHUNK_EINSUMS).  ``swap_b``
# transposes B's trailing pair (the qk / scores forms contract against Kᵀ /
# Bᵀ); perms of None mean identity.
_CHUNK_EINSUMS = {
    # xLSTM intra-chunk attention scores: q·kᵀ per (batch, head)
    "blhp,bjhp->bljh": ((0, 2, 1, 3), (0, 2, 1, 3), True, (0, 2, 3, 1)),
    # xLSTM intra-chunk numerator: att·v per (batch, head)
    "bljh,bjhp->blhp": ((0, 3, 1, 2), (0, 2, 1, 3), False, (0, 2, 1, 3)),
    # SSD intra-chunk scores: C·Bᵀ per (batch, chunk)
    "bcin,bcjn->bcij": (None, None, True, None),
    # SSD intra-chunk output: w·x per (batch, chunk, head)
    "bcijh,bcjhp->bcihp": ((0, 1, 4, 2, 3), (0, 1, 3, 2, 4), False, (0, 1, 3, 2, 4)),
}


def chunk_einsum(subs: str, a: torch.Tensor, b: torch.Tensor, *,
                 preferred_element_type: Optional[torch.dtype] = None) -> torch.Tensor:
    """Backend-routed two-operand einsum of a chunked recurrence's
    intra-chunk block, for the signatures of ``_CHUNK_EINSUMS`` (the JAX
    package's ``chunk_einsum``).

    Under "sfc_cuda" the operands are transposed into a batched (..., M, K)
    @ (..., K, N) product and run as one launch of the fused kernel with
    per-batch B (`kernels.ops.sfc_matmul`, ``fuse=True``), in the output
    type ``preferred_element_type`` (else the inputs' common type): bf16
    inputs asking for f32 take the kernel's f32-output mode, the
    accumulator written with no bf16 rounding.  Knobs and namespace come
    from `kernels.ops.chunk_gemm_plan`.  There is no fallback ladder
    (ROADMAP item 14): a kernel that fails raises.  Under every other
    backend it is ``torch.einsum`` of the same signature, on operands cast
    to ``preferred_element_type`` when one is given (products of the
    inputs' values are exact in f32, so that is the f32 accumulation JAX's
    ``jnp.einsum(..., preferred_element_type=f32)`` gives).  Differentiable:
    the kernel path runs through `sfc_matmul`'s autograd Function."""
    if subs not in _CHUNK_EINSUMS:
        raise ValueError(
            f"chunk_einsum does not know {subs!r}; registered signatures: {sorted(_CHUNK_EINSUMS)}"
        )
    if _BACKEND.get() != BACKEND_SFC_CUDA:
        if preferred_element_type is not None:
            a, b = a.to(preferred_element_type), b.to(preferred_element_type)
        return torch.einsum(subs, a, b)

    from repro_torch.kernels.ops import chunk_gemm_plan, sfc_matmul

    pa, pb, swap_b, po = _CHUNK_EINSUMS[subs]
    at = a.permute(pa) if pa is not None else a
    bt = b.permute(pb) if pb is not None else b
    if swap_b:
        bt = bt.transpose(-1, -2)
    out_dtype = preferred_element_type or torch.promote_types(a.dtype, b.dtype)
    m, k = at.shape[-2:]
    n = bt.shape[-1]
    _, knobs = chunk_gemm_plan(m, n, k, at.dtype, device=at.device)
    out = sfc_matmul(at, bt, out_dtype=out_dtype, fuse=True, **knobs)
    return out.permute(po) if po is not None else out
