"""SFC-ordered fused GEMM: the CUDA port of the TPU kernel body
``repro.kernels.sfc_gemm._fused_kernel`` and its plain PyTorch version.

``sfc_gemm_fused`` is the one wrapper for both modes the TPU package ran as
separate Pallas entry points: ``a`` (M, K) is the plain mode
(``sfc_gemm_fused``), ``a`` (B, M, K) the batched mode
(``sfc_gemm_batched_fused``) against shared (K, N) or per-batch (B, K, N)
weights.  It computes

    C = act(A@B + bias) [GLU: act(A@B_gate + gate_bias) * (A@B + bias)]
        * out_scale + residual

on an f32 accumulator, with one cast to ``out_dtype``.  A tensor on the
CPU goes to the plain version, ``sfc_gemm_fused_plain``; a CUDA tensor goes
to the hand-written kernel in ``csrc/sfc_gemm_fused.cu`` or the call
raises.  There is no fallback from one to the other.

Both walk the C tiles in the order of the gilbert task table that
``core.schedule.compile_schedule(gemm_spec(mb, nb))`` builds.  Both accept
ragged M/N/K: the plain version clips its edge tiles, the kernel masks them.
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


def _check(a, b, b_gate, bias, gate_bias, residual, activation):
    """Shape contract shared by the kernel and its plain version.  Returns
    (batch, M, K, N, b_batched); batch is 0 for the plain (2-D) mode."""
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


def _epilogue(acc, gate, bias, gate_bias, residual, activation, out_scale):
    """The flush step on f32 tiles: same order as the TPU kernel's."""
    if bias is not None:
        acc = acc + bias.float()
    if gate is not None:
        if gate_bias is not None:
            gate = gate + gate_bias.float()
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
) -> torch.Tensor:
    """The plain version of the fused kernel, on any device.

    A Python loop over the compiled schedule's tasks: for each (im, in) C
    tile (all batch elements at once) it accumulates over the
    ``k_layers x k_block_factor`` K chunks in f32, layer-major as in
    Listing 1, and applies the epilogue in f32.  Edge tiles and the last K
    chunk are clipped to the matrix.
    """
    batch, m, k, n, b_batched = _check(a, b, b_gate, bias, gate_bias, residual, activation)
    if bm < 1 or bn < 1 or k_layers < 1 or k_block_factor < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn} k_layers={k_layers} k_block_factor={k_block_factor}")
    out_dtype = out_dtype or a.dtype
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b_batched else b[None]
    res3 = None if residual is None else (residual if residual.ndim == 3 else residual[None])
    bias_row = None if bias is None else bias.reshape(n)
    gbias_row = None if gate_bias is None else gate_bias.reshape(n)
    out = torch.empty((a3.shape[0], m, n), dtype=out_dtype, device=a.device)
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
                activation, out_scale,
            )
            out[:, rs, cs] = y.to(out_dtype)
    return out if a.ndim == 3 else out[0]


@functools.lru_cache(maxsize=256)
def _device_table(mb: int, nb: int, device: torch.device) -> torch.Tensor:
    """(2, T) int32 major/minor rows of the gilbert schedule, uploaded once
    per (mb, nb, device) and kept there."""
    tab = compile_schedule(gemm_spec(mb, nb, 1)).table[:2]
    return torch.from_numpy(tab.copy()).to(device).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(a, b, b_gate, bias, gate_bias, residual, *, activation, out_scale, bm, bn, out_dtype, shape):
    batch, m, k, n, b_batched = shape
    if (bm, bn) != build.TILE:
        raise ValueError(f"the CUDA kernel is compiled for (bm, bn)={build.TILE}, got {(bm, bn)}")
    if a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 inputs, got {a.dtype}")
    if out_dtype != a.dtype:
        raise TypeError(f"the CUDA kernel writes its input type {a.dtype}, asked for {out_dtype}")
    for name, t in (("b", b), ("b_gate", b_gate), ("bias", bias), ("gate_bias", gate_bias), ("residual", residual)):
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
    if max(batch, 1) > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the grid limit {_MAX_GRID_Y}")
    out = torch.empty((batch, m, n) if a.ndim == 3 else (m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    fn = getattr(lib, build.entry_name(build.DTYPE_NAMES[str(a.dtype).split(".")[1]], b_gate is not None, activation))
    mb, nb = math.ceil(m / bm), math.ceil(n / bn)
    tab = _device_table(mb, nb, a.device)
    vec = 16 // a.element_size()
    vec_a = k % vec == 0 and a.data_ptr() % 16 == 0
    vec_b = n % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (b, b_gate) if t is not None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            a.data_ptr(), b.data_ptr(), _ptr(b_gate), _ptr(bias), _ptr(gate_bias), _ptr(residual), out.data_ptr(),
            tab.data_ptr(), mb * nb, max(batch, 1),
            m, n, k,
            m * k, k * n if b_batched else 0,
            int(out_scale is not None), float(out_scale if out_scale is not None else 1.0),
            int(vec_a), int(vec_b),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused kernel launch failed with CUDA error {rc}")
    sfc_gemm_fused.launches += 1
    sfc_gemm_fused.launches_by_shape[(batch, m, k, n, b_gate is not None)] += 1
    return out


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
) -> torch.Tensor:
    """Single-launch SFC GEMM with the fused epilogue, plain or batched.

    ``a`` (M, K) or (B, M, K); ``b`` (K, N), or (B, K, N) per batch
    element; ``b_gate`` (K, N) selects the dual-B GLU form; ``bias`` and
    ``gate_bias`` are (N,) or (1, N); ``residual`` has the output's shape.

    On a CUDA tensor this launches the kernel, whose C tile is fixed at
    compile time: ``bm``/``bn`` must be `kernel_tile()`, and the kernel runs
    the whole K range in one loop, so ``k_layers``/``k_block_factor`` only
    order the plain version's sum.  Every launch adds one to
    ``sfc_gemm_fused.launches`` (and to ``launches_by_shape`` under
    ``(batch, M, K, N, glu)``, batch 0 for the plain mode).  On a CPU
    tensor it runs `sfc_gemm_fused_plain` and counts nothing.
    """
    shape = _check(a, b, b_gate, bias, gate_bias, residual, activation)
    out_dtype = out_dtype or a.dtype
    kw = dict(activation=activation, out_scale=out_scale, bm=bm, bn=bn, out_dtype=out_dtype)
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
