"""SFC-ordered GEMMs: the CUDA ports of the TPU kernels
``repro.kernels.sfc_gemm._fused_kernel`` (K1/K2), ``sfc_gemm_nt`` (K7) and
``sfc_gemm_tn`` (K8, dW mode), each beside its plain PyTorch version.

``sfc_gemm_fused`` is the one wrapper for both modes the TPU package ran as
separate Pallas entry points: ``a`` (M, K) is the plain mode
(``sfc_gemm_fused``), ``a`` (B, M, K) the batched mode
(``sfc_gemm_batched_fused``) against shared (K, N) or per-batch (B, K, N)
weights.  It computes

    C = act(A@B + bias) [GLU: act(A@B_gate + gate_bias) * (A@B + bias)]
        * out_scale + residual

on an f32 accumulator, with one cast to ``out_dtype``; its ``preact`` mode
(the training forward of a GLU) returns both biased pre-activations
instead.  ``sfc_gemm_nt`` (C = A@Bᵀ, the dA of a projection) and
``sfc_gemm_tn`` (C = Aᵀ@B, its dW) read the stored operands with swapped
roles, so no transposed copy is made.  A tensor on the
CPU goes to the plain version, ``sfc_gemm_fused_plain``; a CUDA tensor goes
to the hand-written kernel in ``csrc/sfc_gemm_fused.cu`` or the call
raises.  There is no fallback from one to the other.

Each kernel and its plain version walk the C tiles in the order of the
gilbert task table that ``core.schedule.compile_schedule(gemm_spec(mb,
nb))`` builds, and accept ragged shapes: the plain versions clip their edge
tiles, the kernels mask them.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.schedule import compile_schedule, gemm_spec
from repro_torch.kernels import build

__all__ = [
    "ACTIVATIONS",
    "activation_fn",
    "sfc_gemm_fused",
    "sfc_gemm_fused_plain",
    "sfc_gemm_nt",
    "sfc_gemm_nt_plain",
    "sfc_gemm_tn",
    "sfc_gemm_tn_plain",
    "kernel_tile",
]

ACTIVATIONS = ("silu", "gelu", "relu")

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, the batch axis


def activation_fn(name: Optional[str]):
    """f32 -> f32 elementwise activation of the epilogue.  ``gelu`` is the
    tanh form, which is what ``jax.nn.gelu`` computes by default."""
    if name is None:
        return lambda x: x
    if name == "silu":
        return F.silu
    if name == "gelu":
        return functools.partial(F.gelu, approximate="tanh")
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation {name!r}; pick from {ACTIVATIONS}")


def kernel_tile() -> tuple:
    """(bm, bn) of the C tile the CUDA kernel is compiled for."""
    return build.TILE


def _check(a, b, b_gate, bias, gate_bias, residual, activation, out_scale, preact):
    """Shape contract shared by the kernel and its plain version.  Returns
    (batch, M, K, N, b_batched); batch is 0 for the plain (2-D) mode."""
    if preact and (b_gate is None or activation is not None or out_scale is not None or residual is not None):
        raise ValueError("preact returns the two biased GLU pre-activations: it needs b_gate and takes "
                         "no activation, out_scale or residual")
    if a.ndim not in (2, 3) or b.ndim not in (2, 3):
        raise ValueError(f"a must be (M, K) or (B, M, K) and b (K, N) or (B, K, N); got {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    b_batched = b.ndim == 3
    batch = a.shape[0] if a.ndim == 3 else 0
    if b_batched and (a.ndim != 3 or b.shape[0] != batch):
        raise ValueError(f"per-batch weights need a matching batched a: {tuple(a.shape)} @ {tuple(b.shape)}")
    if b_gate is not None:
        if b_batched:
            raise ValueError("GLU form requires shared 2-D weights")
        if tuple(b_gate.shape) != (k, n):
            raise ValueError(f"GLU gate weights must be (K, N)={(k, n)}, got {tuple(b_gate.shape)}")
    if gate_bias is not None and b_gate is None:
        raise ValueError("gate_bias needs the GLU form (b_gate)")
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) not in ((n,), (1, n)):
            raise ValueError(f"{name} must be (N,) or (1, N) with N={n}, got {tuple(vec.shape)}")
    out_shape = (batch, m, n) if a.ndim == 3 else (m, n)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != output {out_shape}")
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; pick from {ACTIVATIONS}")
    return batch, m, k, n, b_batched


def _epilogue(acc, gate, bias, gate_bias, residual, activation, out_scale, preact=False):
    """The flush step on f32 tiles: same order as the TPU kernel's.  Under
    ``preact`` the pair (acc + bias, gate + gate_bias)."""
    if bias is not None:
        acc = acc + bias.float()
    if gate is not None:
        if gate_bias is not None:
            gate = gate + gate_bias.float()
        if preact:
            return acc, gate
        y = activation_fn(activation)(gate) * acc
    else:
        y = activation_fn(activation)(acc)
    if out_scale is not None:
        y = y * out_scale
    if residual is not None:
        y = y + residual.float()
    return y


def sfc_gemm_fused_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: int,
    bn: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    preact: bool = False,
):
    """The plain version of the fused kernel, on any device.

    A Python loop over the compiled schedule's tasks: for each (im, in) C
    tile (all batch elements at once) it accumulates over the
    ``k_layers x k_block_factor`` K chunks in f32, layer-major as in
    Listing 1, and applies the epilogue in f32.  Edge tiles and the last K
    chunk are clipped to the matrix.  ``preact`` returns the pair
    (A@B + bias, A@B_gate + gate_bias).
    """
    batch, m, k, n, b_batched = _check(a, b, b_gate, bias, gate_bias, residual, activation, out_scale, preact)
    if bm < 1 or bn < 1 or k_layers < 1 or k_block_factor < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn} k_layers={k_layers} k_block_factor={k_block_factor}")
    out_dtype = out_dtype or a.dtype
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b_batched else b[None]
    res3 = None if residual is None else (residual if residual.ndim == 3 else residual[None])
    bias_row = None if bias is None else bias.reshape(n)
    gbias_row = None if gate_bias is None else gate_bias.reshape(n)
    out = torch.empty((a3.shape[0], m, n), dtype=out_dtype, device=a.device)
    out_gate = torch.empty_like(out) if preact else None
    if m and n:
        n_chunks = k_layers * k_block_factor
        k_chunk = max(1, math.ceil(k / n_chunks))
        tab = compile_schedule(gemm_spec(math.ceil(m / bm), math.ceil(n / bn), 1)).table
        for im, in_ in zip(tab[0].tolist(), tab[1].tolist()):
            rs = slice(im * bm, min((im + 1) * bm, m))
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((a3.shape[0], rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
            gate = torch.zeros_like(acc) if b_gate is not None else None
            for c in range(n_chunks):
                ks = slice(min(c * k_chunk, k), min((c + 1) * k_chunk, k))
                a_panel = a3[:, rs, ks].float()
                acc += a_panel @ b3[:, ks, cs].float()
                if gate is not None:
                    gate += a_panel @ b_gate[ks, cs].float()
            y = _epilogue(
                acc, gate,
                None if bias_row is None else bias_row[cs],
                None if gbias_row is None else gbias_row[cs],
                None if res3 is None else res3[:, rs, cs],
                activation, out_scale, preact,
            )
            if preact:
                y, g = y
                out_gate[:, rs, cs] = g.to(out_dtype)
            out[:, rs, cs] = y.to(out_dtype)
    if preact:
        return (out, out_gate) if a.ndim == 3 else (out[0], out_gate[0])
    return out if a.ndim == 3 else out[0]


@functools.lru_cache(maxsize=256)
def _device_table(mb: int, nb: int, device: torch.device) -> torch.Tensor:
    """(2, T) int32 major/minor rows of the gilbert schedule, uploaded once
    per (mb, nb, device) and kept there."""
    tab = compile_schedule(gemm_spec(mb, nb, 1)).table[:2]
    return torch.from_numpy(tab.copy()).to(device).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_operands(bm, bn, out_dtype, a, **others):
    """Device, type, layout and tile checks shared by the GEMM kernels'
    launches; ``others`` maps names to tensors (or None)."""
    if (bm, bn) != build.TILE:
        raise ValueError(f"the CUDA kernel is compiled for (bm, bn)={build.TILE}, got {(bm, bn)}")
    if a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 inputs, got {a.dtype}")
    if out_dtype != a.dtype:
        raise TypeError(f"the CUDA kernel writes its input type {a.dtype}, asked for {out_dtype}")
    for name, t in others.items():
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype}, a is {a.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")


def _dtype_name(t: torch.Tensor) -> str:
    return build.DTYPE_NAMES[str(t.dtype).split(".")[1]]


def _rows_vec(cols: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Rows of ``cols`` elements of every given tensor start 16-byte aligned."""
    return all(cols % (16 // t.element_size()) == 0 and t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _launch(a, b, b_gate, bias, gate_bias, residual, *, activation, out_scale, bm, bn, out_dtype, shape,
            preact=False):
    batch, m, k, n, b_batched = shape
    _check_operands(bm, bn, out_dtype, a, b=b, b_gate=b_gate, bias=bias, gate_bias=gate_bias, residual=residual)
    if max(batch, 1) > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the grid limit {_MAX_GRID_Y}")
    out = torch.empty((batch, m, n) if a.ndim == 3 else (m, n), dtype=out_dtype, device=a.device)
    out_gate = torch.empty_like(out) if preact else None
    if out.numel() == 0:
        return (out, out_gate) if preact else out
    lib = build.load_library()
    fn = getattr(lib, build.entry_name(_dtype_name(a), b_gate is not None, activation))
    mb, nb = math.ceil(m / bm), math.ceil(n / bn)
    tab = _device_table(mb, nb, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            a.data_ptr(), b.data_ptr(), _ptr(b_gate), _ptr(bias), _ptr(gate_bias), _ptr(residual),
            out.data_ptr(), _ptr(out_gate),
            tab.data_ptr(), mb * nb, max(batch, 1),
            m, n, k,
            m * k, k * n if b_batched else 0,
            int(out_scale is not None), float(out_scale if out_scale is not None else 1.0),
            int(_rows_vec(k, a)), int(_rows_vec(n, b, b_gate)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused kernel launch failed with CUDA error {rc}")
    sfc_gemm_fused.launches += 1
    sfc_gemm_fused.launches_by_shape[(batch, m, k, n, b_gate is not None)] += 1
    return (out, out_gate) if preact else out


def sfc_gemm_fused(
    a: torch.Tensor,
    b: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    preact: bool = False,
):
    """Single-launch SFC GEMM with the fused epilogue, plain or batched.

    ``a`` (M, K) or (B, M, K); ``b`` (K, N), or (B, K, N) per batch
    element; ``b_gate`` (K, N) selects the dual-B GLU form; ``bias`` and
    ``gate_bias`` are (N,) or (1, N); ``residual`` has the output's shape.
    ``preact`` (GLU only, no activation, scale or residual) returns the
    pair (A@B + bias, A@B_gate + gate_bias) from the one traversal of A:
    the training forward's ``_FusedSpec.preact_out``.

    On a CUDA tensor this launches the kernel, whose C tile is fixed at
    compile time: ``bm``/``bn`` must be `kernel_tile()`, and the kernel runs
    the whole K range in one loop, so ``k_layers``/``k_block_factor`` only
    order the plain version's sum.  Every launch adds one to
    ``sfc_gemm_fused.launches`` (and to ``launches_by_shape`` under
    ``(batch, M, K, N, glu)``, batch 0 for the plain mode).  On a CPU
    tensor it runs `sfc_gemm_fused_plain` and counts nothing.
    """
    shape = _check(a, b, b_gate, bias, gate_bias, residual, activation, out_scale, preact)
    out_dtype = out_dtype or a.dtype
    kw = dict(activation=activation, out_scale=out_scale, bm=bm, bn=bn, out_dtype=out_dtype, preact=preact)
    if a.device.type == "cpu":
        return sfc_gemm_fused_plain(
            a, b, b_gate, bias, gate_bias, residual,
            k_layers=k_layers, k_block_factor=k_block_factor, **kw,
        )
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_fused runs on cuda or cpu tensors, got {a.device}")
    return _launch(a, b, b_gate, bias, gate_bias, residual, shape=shape, **kw)


sfc_gemm_fused.launches = 0
sfc_gemm_fused.launches_by_shape = collections.Counter()


# ---------------------------------------------------------------------------
# NT / TN backward kernels (K7: dA = dC·Wᵀ, K8: dW = Aᵀ·dC)
# ---------------------------------------------------------------------------


def _check_nt(a, b, a2, b2):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"sfc_gemm_nt needs a (M, K) and b (N, K); got {tuple(a.shape)}, {tuple(b.shape)}")
    if (a2 is None) != (b2 is None):
        raise ValueError("the dual NT form needs both a2 and b2")
    if a2 is not None and (tuple(a2.shape) != tuple(a.shape) or tuple(b2.shape) != tuple(b.shape)):
        raise ValueError(f"a2 {tuple(a2.shape)} / b2 {tuple(b2.shape)} must match a {tuple(a.shape)} / "
                         f"b {tuple(b.shape)}")
    return a.shape[0], b.shape[0], a.shape[1]


def _check_tn(a, b, b2):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"sfc_gemm_tn needs a (M, K) and b (M, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    if b2 is not None and tuple(b2.shape) != tuple(b.shape):
        raise ValueError(f"b2 {tuple(b2.shape)} must match b {tuple(b.shape)}")
    return a.shape[1], b.shape[1], a.shape[0]


def _plain_tiles(rows: int, cols: int, depth: int, bm: int, bn: int, k_layers: int, k_block_factor: int):
    """(row slice, col slice, [contraction slices]) per task of the gilbert
    table over the (rows, cols) output, edge tiles and chunks clipped."""
    if bm < 1 or bn < 1 or k_layers < 1 or k_block_factor < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn} k_layers={k_layers} k_block_factor={k_block_factor}")
    if not (rows and cols):
        return
    n_chunks = k_layers * k_block_factor
    chunk = max(1, math.ceil(depth / n_chunks))
    ks = [slice(min(c * chunk, depth), min((c + 1) * chunk, depth)) for c in range(n_chunks)]
    tab = compile_schedule(gemm_spec(math.ceil(rows / bm), math.ceil(cols / bn), 1)).table
    for im, in_ in zip(tab[0].tolist(), tab[1].tolist()):
        yield slice(im * bm, min((im + 1) * bm, rows)), slice(in_ * bn, min((in_ + 1) * bn, cols)), ks


def sfc_gemm_nt_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    bm: int,
    bn: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of the NT kernel, on any device: per task of the
    gilbert table over C's (M, N) tiles, ``a[im] @ b[in]ᵀ (+ a2[im] @
    b2[in]ᵀ)`` accumulated in f32 over the ``k_layers x k_block_factor``
    contraction chunks (`_nt_kernel`'s order), one cast at the flush."""
    m, n, k = _check_nt(a, b, a2, b2)
    out = torch.empty((m, n), dtype=out_dtype or a.dtype, device=a.device)
    for rs, cs, chunks in _plain_tiles(m, n, k, bm, bn, k_layers, k_block_factor):
        acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
        for ks in chunks:
            acc += a[rs, ks].float() @ b[cs, ks].float().T
            if a2 is not None:
                acc += a2[rs, ks].float() @ b2[cs, ks].float().T
        out[rs, cs] = acc.to(out.dtype)
    return out


def sfc_gemm_tn_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    b2: Optional[torch.Tensor] = None,
    *,
    bm: int,
    bn: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
):
    """The plain version of the TN kernel in its dW mode, on any device:
    per task of the gilbert table over C's (K, N) tiles, ``a[:, im]ᵀ @
    b[:, in]`` (and ``b2``) accumulated in f32 over the contraction chunks
    of the M rows, one cast at the flush.  Returns C, or (C, C2) with
    ``b2``."""
    k, n, m = _check_tn(a, b, b2)
    out = torch.empty((k, n), dtype=out_dtype or a.dtype, device=a.device)
    out2 = torch.empty_like(out) if b2 is not None else None
    for rs, cs, chunks in _plain_tiles(k, n, m, bm, bn, k_layers, k_block_factor):
        acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
        acc2 = torch.zeros_like(acc) if b2 is not None else None
        for ms in chunks:
            a_pan = a[ms, rs].float().T
            acc += a_pan @ b[ms, cs].float()
            if b2 is not None:
                acc2 += a_pan @ b2[ms, cs].float()
        out[rs, cs] = acc.to(out.dtype)
        if b2 is not None:
            out2[rs, cs] = acc2.to(out.dtype)
    return out if b2 is None else (out, out2)


def _launch_bwd(kind: str, a, b, x2, out, out2, *, rows: int, cols: int, depth: int, vec_a: bool, vec_b: bool):
    mb, nb = math.ceil(rows / build.TILE[0]), math.ceil(cols / build.TILE[1])
    tab = _device_table(mb, nb, a.device)
    fn = getattr(build.load_library(), build.bwd_entry_name(kind, _dtype_name(a)))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if kind == "nt":
            a2, b2 = x2
            ptrs = (a.data_ptr(), b.data_ptr(), _ptr(a2), _ptr(b2), out.data_ptr())
        else:
            ptrs = (a.data_ptr(), b.data_ptr(), _ptr(x2), out.data_ptr(), _ptr(out2))
        rc = fn(*ptrs, tab.data_ptr(), mb * nb, rows, cols, depth, int(vec_a), int(vec_b), stream)
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_{kind} kernel launch failed with CUDA error {rc}")


def sfc_gemm_nt(
    a: torch.Tensor,  # (M, K)
    b: torch.Tensor,  # (N, K): consumed as bᵀ, never transposed in memory
    a2: Optional[torch.Tensor] = None,  # (M, K) second addend (the GLU's dA)
    b2: Optional[torch.Tensor] = None,  # (N, K)
    *,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C = A @ Bᵀ (+ A2 @ B2ᵀ) over the gilbert traversal of C's tiles: the
    dA backward GEMM (A = dC, B = the forward weight as stored).

    On a CUDA tensor this launches the NT kernel (tile `kernel_tile()`, the
    whole contraction in one CTA loop, ragged edges masked) and adds one to
    ``sfc_gemm_nt.launches`` and to ``launches_by_shape[(M, N, K, dual)]``.
    On a CPU tensor it runs `sfc_gemm_nt_plain` and counts nothing."""
    m, n, k = _check_nt(a, b, a2, b2)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sfc_gemm_nt_plain(a, b, a2, b2, bm=bm, bn=bn, k_layers=k_layers,
                                 k_block_factor=k_block_factor, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_nt runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, a2=a2, b2=b2)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    # an empty contraction (k == 0) still launches: the CTAs flush zeros
    _launch_bwd("nt", a, b, (a2, b2), out, None, rows=m, cols=n, depth=k,
                vec_a=_rows_vec(k, a, a2), vec_b=_rows_vec(k, b, b2))
    sfc_gemm_nt.launches += 1
    sfc_gemm_nt.launches_by_shape[(m, n, k, a2 is not None)] += 1
    return out


def sfc_gemm_tn(
    a: torch.Tensor,  # (M, K): consumed as aᵀ, never transposed in memory
    b: torch.Tensor,  # (M, N)
    b2: Optional[torch.Tensor] = None,  # (M, N) second operand (the GLU's dWg)
    master: Optional[torch.Tensor] = None,
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    hyper: Optional[torch.Tensor] = None,
    *,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    abft: bool = False,
):
    """C = Aᵀ @ B (and Aᵀ @ B2) over the gilbert traversal of C's (K, N)
    tiles: the dW backward GEMM (A = the forward activations, B = dC).
    Returns C, or (C, C2) with ``b2``.

    Only the dW mode is ported: the grad-and-update flush (``master``,
    ``mu``, ``nu``, ``hyper``: the fused AdamW step) and the ABFT checksum
    lane raise `NotImplementedError`.  On a CUDA tensor this launches the
    TN kernel, whose CTAs each loop over all M rows (no atomics), and adds
    one to ``sfc_gemm_tn.launches`` and to ``launches_by_shape[(K, N, M,
    dual)]``.  On a CPU tensor it runs `sfc_gemm_tn_plain` and counts
    nothing."""
    if any(x is not None for x in (master, mu, nu, master2, mu2, nu2, hyper)):
        raise NotImplementedError(
            "the TN kernel's update mode (the fused AdamW flush: master, mu, nu, hyper) is not ported: "
            "ROADMAP queue 1 item 10"
        )
    if abft:
        raise NotImplementedError("the ABFT checksum lane is not ported: ROADMAP queue 1 item 14")
    k, n, m = _check_tn(a, b, b2)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sfc_gemm_tn_plain(a, b, b2, bm=bm, bn=bn, k_layers=k_layers,
                                 k_block_factor=k_block_factor, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_tn runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, b2=b2)
    out = torch.empty((k, n), dtype=out_dtype, device=a.device)
    out2 = torch.empty_like(out) if b2 is not None else None
    if out.numel():
        _launch_bwd("tn", a, b, b2, out, out2, rows=k, cols=n, depth=m,
                    vec_a=_rows_vec(k, a), vec_b=_rows_vec(n, b, b2))
        sfc_gemm_tn.launches += 1
        sfc_gemm_tn.launches_by_shape[(k, n, m, b2 is not None)] += 1
    return out if b2 is None else (out, out2)


sfc_gemm_nt.launches = 0
sfc_gemm_nt.launches_by_shape = collections.Counter()
sfc_gemm_tn.launches = 0
sfc_gemm_tn.launches_by_shape = collections.Counter()
