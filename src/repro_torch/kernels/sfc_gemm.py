"""SFC-ordered GEMMs: the CUDA ports of the TPU kernels
``repro.kernels.sfc_gemm._fused_kernel`` (K1/K2, and K3 in its grouped
mode), ``sfc_gemm_pallas`` / ``sfc_gemm_batched`` (K4/K5, the replicated
form's partial products) and ``add_reduce_pallas`` (K6), ``sfc_gemm_nt``
(K7), ``sfc_gemm_tn`` (K8, with its update and norm modes),
``sfc_gemm_grouped_nt`` (K9) and ``sfc_gemm_grouped_tn`` (K10, with the
same three modes), each beside its plain PyTorch version.

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
to a hand-written kernel in ``csrc/sfc_gemm_fused.cu`` (bf16 past 16 rows,
and bf16 NT and TN products, K8 and K10 in all their modes: the persistent
wgmma + TMA main loop of ``csrc/sfc_gemm_wgmma.cuh``) or the call raises.
There is no fallback from one to the other.

Each kernel and its plain version walk the C tiles in the order of the
gilbert task table that ``core.schedule.compile_schedule(gemm_spec(mb,
nb))`` builds, and accept ragged shapes: the plain versions clip their edge
tiles, the kernels mask them.

``sfc_gemm_tn`` has two more modes, the TPU kernel's grad-and-update flush
(``_apply_update_flush``): the **update** mode runs AdamW on each f32 dW
tile against the f32 master / mu / nu and writes W (stochastically rounded
when bf16 and asked for) and the three states **in place**, so dW never
reaches device memory; the **norm** mode runs the same traversal and writes
only each tile's ``sum(dW²)``, the first phase of the exact global-norm
clip.  Both return the per-set norm, taken before the gradient scale.  The
stochastic rounding draws its bits from the counter hash of the JAX
package's interpret path (`tile_random_bits`), seeded per (step, weight,
tile), so the card's bits are the plain version's and the JAX package's.

The replicated 2.5D form (the paper's Listing 1, lines 26-35) is two
wrappers: ``sfc_gemm_replicated`` writes the (K_layers, M, N) partial
copies of A (M, K) @ B, or (B, K_layers, M, N) for a batched A, copy ``l``
the product over layer ``l``'s K slab (the JAX package's: K padded to a
multiple of ``k_layers * k_block_factor`` and split evenly, clipped here
instead of padded), over the tasks of ``gemm_spec(mb, nb, k_layers)``'s
table, so the layers run as split-K across the SMs (bf16 at decode: each
task a cluster of CTAs over sub-slabs of its slab, K1's cluster design;
bf16 past 16 rows: the wgmma kernel's persistent CTAs over curve
segments); ``add_reduce`` sums the copies in f32 and casts them back to
their type.  Neither has an epilogue.

The grouped wrappers run the MoE expert GEMMs in one launch each:
``sfc_gemm_grouped`` (K3, the forward with the same epilogue and preact
mode), ``sfc_gemm_grouped_nt`` (K9, dA) and ``sfc_gemm_grouped_tn`` (K10,
dW, and the update and norm modes over (E, K, N) state stacks, whose bf16
rounding also hashes the expert into each tile's seed).  Each expert's
rows lie packed, unpadded, in one matrix and its weights in an (E, K, N)
stack; the kernels mask each expert's last row block where the TPU
kernels took rows padded to whole blocks.

The ABFT checksum lane (``abft=True`` on ``sfc_gemm_fused``,
``sfc_gemm_grouped`` and ``sfc_gemm_tn`` in all three modes; the TPU
kernels' launch-resident ``chk`` output) appends the f32 sum of the raw
accumulators, before the epilogue, the cast or AdamW, to the result: each
task sums its tile (the GLU's two accumulators together, the TN kernel's
operand sets apart) over the rows and columns inside the output, into a
per-task partials buffer that the wrapper sums on the device, so the
checksum needs no atomics and is as deterministic as the output.  On the
card it is a kernel of its own per mode (the ``-DSFC_ABFT=1`` parts); the
plain versions sum the same tiles.  `robust.abft` compares it with the
operand-side checksum.

Each public wrapper (``sfc_gemm_fused``, ``sfc_gemm_replicated``,
``add_reduce``, ``sfc_gemm_nt``, ``sfc_gemm_tn`` and the grouped three) is a
`kernels.entry.kernel_entry`: one opaque operation to remat's policy, its
launch or its plain version alike.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.device import sm_count
from repro_torch.core.schedule import compile_schedule, gemm_spec, grouped_gemm_spec, grouped_tn_spec
from repro_torch.kernels import build
from repro_torch.kernels.entry import kernel_entry

__all__ = [
    "KERNEL_VERSION",
    "ACTIVATIONS",
    "activation_fn",
    "sfc_gemm_fused",
    "sfc_gemm_fused_plain",
    "sfc_gemm_replicated",
    "sfc_gemm_replicated_plain",
    "add_reduce",
    "add_reduce_plain",
    "add_reduce_launch",
    "layer_slab",
    "cluster_layers",
    "uses_cluster_kernel",
    "replicated_cluster_split",
    "uses_replicated_wgmma_kernel",
    "replicated_wgmma_launch",
    "WgmmaLaunch",
    "AddReduceLaunch",
    "wgmma_grid",
    "wgmma_launch",
    "uses_wgmma_kernel",
    "uses_nt_wgmma_kernel",
    "tn_wgmma_launch",
    "uses_tn_wgmma_kernel",
    "sfc_gemm_nt",
    "sfc_gemm_nt_plain",
    "sfc_gemm_tn",
    "sfc_gemm_tn_plain",
    "sfc_gemm_grouped",
    "sfc_gemm_grouped_plain",
    "sfc_gemm_grouped_nt",
    "sfc_gemm_grouped_nt_plain",
    "sfc_gemm_grouped_tn",
    "sfc_gemm_grouped_tn_plain",
    "build_grouped_task_table",
    "build_grouped_tn_task_table",
    "grouped_tn_row_block",
    "tile_random_bits",
    "stochastic_round_to",
    "kernel_tile",
    "check_launch",
]

# The kernel generation a tune-cache entry was measured against
# (`repro_torch.tune.cache`): bump it when a kernel change makes measured
# launch winners or calibrated constants stale.
KERNEL_VERSION = 1

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


def check_preact(preact, b_gate, activation, out_scale, residual) -> None:
    """``preact`` (the training forward of a GLU) needs the gate weights and
    takes no activation, scale or residual."""
    if preact and (b_gate is None or activation is not None or out_scale is not None or residual is not None):
        raise ValueError("preact returns the two biased GLU pre-activations: it needs b_gate and takes "
                         "no activation, out_scale or residual")


def _check(a, b, b_gate, bias, gate_bias, residual, activation, out_scale, preact):
    """Shape contract shared by the kernel and its plain version.  Returns
    (batch, M, K, N, b_batched); batch is 0 for the plain (2-D) mode."""
    check_preact(preact, b_gate, activation, out_scale, residual)
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


def _k_chunks(depth: int, n_chunks: int):
    """The contraction's ``n_chunks`` slices of ceil(depth / n_chunks), the
    last ones clipped (possibly empty)."""
    chunk = max(1, math.ceil(depth / n_chunks))
    return [slice(min(c * chunk, depth), min((c + 1) * chunk, depth)) for c in range(n_chunks)]


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
    abft: bool = False,
):
    """The plain version of the fused kernel, on any device.

    A Python loop over the compiled schedule's tasks: for each (im, in) C
    tile (all batch elements at once) it accumulates over the
    ``k_layers x k_block_factor`` K chunks in f32, layer-major as in
    Listing 1, and applies the epilogue in f32.  Edge tiles and the last K
    chunk are clipped to the matrix.  ``preact`` returns the pair
    (A@B + bias, A@B_gate + gate_bias).  ``abft`` appends the checksum lane,
    an f32 scalar: the sum of every tile's raw accumulator (the GLU's two
    together), taken before the epilogue, per (batch element, task) in the
    TPU grid's order and then summed, as the kernel's partials are.
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
    parts = None
    if m and n:
        chunks = _k_chunks(k, k_layers * k_block_factor)
        tab = compile_schedule(gemm_spec(math.ceil(m / bm), math.ceil(n / bn), 1)).table
        if abft:
            parts = torch.zeros((a3.shape[0], tab.shape[1]), dtype=torch.float32, device=a.device)
        for t, (im, in_) in enumerate(zip(tab[0].tolist(), tab[1].tolist())):
            rs = slice(im * bm, min((im + 1) * bm, m))
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((a3.shape[0], rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
            gate = torch.zeros_like(acc) if b_gate is not None else None
            for ks in chunks:
                a_panel = a3[:, rs, ks].float()
                acc += a_panel @ b3[:, ks, cs].float()
                if gate is not None:
                    gate += a_panel @ b_gate[ks, cs].float()
            if abft:
                parts[:, t] = _tile_sums(acc, gate)
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
    if a.ndim == 2:
        out, out_gate = out[0], None if out_gate is None else out_gate[0]
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


def _tile_sums(acc: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The checksum lane of one tile of every batch element: the f32 sum of
    the (B, rows, cols) raw accumulator, plus the gate's for the GLU."""
    s = acc.sum(dim=(-2, -1))
    return s if gate is None else s + gate.sum(dim=(-2, -1))


def _lane_total(parts: Optional[torch.Tensor], device, sets: Optional[int] = None) -> torch.Tensor:
    """The lane's checksum: the per-task partials summed, 0 with no task; with
    ``sets``, per operand set, (sets, 1)."""
    if sets is None:
        return parts.sum() if parts is not None else torch.zeros((), dtype=torch.float32, device=device)
    if parts is None:
        return torch.zeros((sets, 1), dtype=torch.float32, device=device)
    return parts.sum(dim=1, keepdim=True)


@functools.lru_cache(maxsize=256)
def _device_table(mb: int, nb: int, device: torch.device) -> torch.Tensor:
    """(2, T) int32 major/minor rows of the gilbert schedule, uploaded once
    per (mb, nb, device) and kept there."""
    tab = compile_schedule(gemm_spec(mb, nb, 1)).table[:2]
    return torch.from_numpy(tab.copy()).to(device).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_operands(bm, bn, out_dtype, a, *, f32_out: bool = False, **others):
    """Device, type, layout and tile checks shared by the GEMM kernels'
    launches; ``others`` maps names to tensors (or None).  ``f32_out``: the
    launch is K1/K2's f32-output mode (`_f32_out`), which writes f32 from
    bf16 inputs."""
    if (bm, bn) != build.TILE:
        raise ValueError(f"the CUDA kernel is compiled for (bm, bn)={build.TILE}, got {(bm, bn)}")
    if a.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 inputs, got {a.dtype}")
    if out_dtype != a.dtype and not f32_out:
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


def _f32_out(a: torch.Tensor, out_dtype: torch.dtype) -> bool:
    """Whether a forward call asks for K1/K2's f32-output mode: bf16 inputs,
    an f32 output."""
    return a.dtype == torch.bfloat16 and out_dtype == torch.float32


def _check_f32_out(b_gate, bias, residual, activation, out_scale, preact) -> None:
    """The f32-output mode is the plain product's (`chunk_einsum` passes no
    epilogue): the GLU form, ``preact`` and every epilogue flag raise,
    naming which."""
    asked = [name for name, on in (("the GLU form (b_gate)", b_gate is not None), ("preact", preact),
                                   ("bias", bias is not None), ("activation", activation is not None),
                                   ("out_scale", out_scale is not None), ("residual", residual is not None)) if on]
    if asked:
        raise TypeError("the CUDA kernel writes f32 from bf16 inputs only for the plain product with no epilogue; "
                        f"this call also asks for {', '.join(asked)}")


def _dtype_name(t: torch.Tensor) -> str:
    return build.DTYPE_NAMES[str(t.dtype).split(".")[1]]


def _rows_vec(cols: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Rows of ``cols`` elements of every given tensor start 16-byte aligned."""
    return all(cols % (16 // t.element_size()) == 0 and t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _results(outs, lane: Optional[torch.Tensor] = None):
    """A wrapper's return: its outputs that exist, with the lane's checksum
    appended when it ran."""
    res = tuple(o for o in outs if o is not None)
    if lane is not None:
        res = (*res, lane)
    return res if len(res) > 1 else res[0]


# the cluster kernel's slabs are at least this many K rows deep (4 BK steps)
_MIN_SLAB = 256


def cluster_layers(k: int, n: int, sm_count: int) -> int:
    """K layers (CTAs a cluster) of the cluster kernel for an (M <= 16, k)
    @ (k, n) product: the smallest power of two L with nb * L >= 1.5 x
    ``sm_count`` CTAs (nb = ceil(n / 64) C tiles), at most
    ``build.MAX_CLUSTER_LAYERS``, and no more once a slab (`layer_slab`)
    would be under 256 K rows.  Past one and a half CTAs an SM a deeper
    split adds cluster and reduction cost and takes no more bytes at once
    (`scripts/split_sweep.py`).  The kernel's launch configuration: the
    plain version's sum order is still ``k_layers``'s.  The rule of
    `replicated_cluster_split` for one layer."""
    return replicated_cluster_split(k, n, 1, sm_count)


def replicated_cluster_split(k: int, n: int, k_layers: int, sm_count: int, k_block_factor: int = 1) -> int:
    """L', the CTAs a cluster of the replicated cluster kernel (K4 at M <=
    16) for the ``k_layers`` copies of an (M, k) @ (k, n) product: each
    (C tile, layer) task is a cluster of L' CTAs, one a sub-slab of
    ``layer_slab(slab, L')`` rows of the layer's slab (``layer_slab(k,
    k_layers, k_block_factor)``).  `cluster_layers`' rule over the task
    count: the smallest power of two with nb * k_layers * L' >= 1.5 x
    ``sm_count`` CTAs, at most ``build.MAX_CLUSTER_LAYERS``, and no more
    once a sub-slab would be under 256 K rows.  At k_layers 1 it is
    `cluster_layers`; at qwen3-4b's decode shapes and k_layers 8 it is 1.
    A pure function of the shape, the split and the SM count, not a knob."""
    nb = math.ceil(n / build.TILE[1])
    slab = layer_slab(k, k_layers, k_block_factor)
    split = 1
    while (split < build.MAX_CLUSTER_LAYERS and 2 * nb * k_layers * split < 3 * sm_count
           and layer_slab(slab, 2 * split) >= _MIN_SLAB):
        split *= 2
    return split


def forced_cluster_layers(k: int, layers: int) -> int:
    """A tuned K-layer count of the cluster kernel for a K of ``k``: the
    largest power of two up to ``layers`` whose slabs stay at least 256
    rows deep (`cluster_layers`' floor), so that one cache entry serves
    every K of its bucket."""
    while layers > 1 and layer_slab(k, layers) < _MIN_SLAB:
        layers //= 2
    return layers


_LAUNCH_KEYS = ("wide", "group", "layers")


def check_launch(launch) -> Optional[dict]:
    """A launch override (`repro_torch.tune`'s ``Knobs.launch``) as a dict
    of ints, or None.  ``wide``: the wgmma kernels' 128 x 256 C tile (1) or
    128 x 128 (0); ``group``: CTAs of a worker of a persistent wgmma or TN
    launch (at least 1); ``layers``: the cluster kernel's K layers, a power
    of two up to ``build.MAX_CLUSTER_LAYERS``.  A kernel reads only the
    keys that concern it and keeps its rule for the others."""
    if launch is None:
        return None
    out = {str(k): int(v) for k, v in dict(launch).items()}
    bad = [k for k in out if k not in _LAUNCH_KEYS]
    if bad:
        raise ValueError(f"unknown launch keys {bad}; pick from {_LAUNCH_KEYS}")
    if out.get("wide", 0) not in (0, 1) or out.get("group", 1) < 1:
        raise ValueError(f"bad launch {out}: wide is 0 or 1, group at least 1")
    layers = out.get("layers", 1)
    if layers < 1 or layers > build.MAX_CLUSTER_LAYERS or layers & (layers - 1):
        raise ValueError(f"bad launch {out}: layers is a power of two up to {build.MAX_CLUSTER_LAYERS}")
    return out


def uses_cluster_kernel(a: torch.Tensor) -> bool:
    """Whether `sfc_gemm_fused` launches the cluster kernel for this A on
    the card: the plain mode (2-D), 1 to ``build.SPLIT_MAX_ROWS`` rows,
    bf16; every other A takes the wgmma kernel (`uses_wgmma_kernel`) or the
    64 x 64 tile kernel."""
    return a.ndim == 2 and 1 <= a.shape[0] <= build.SPLIT_MAX_ROWS and a.dtype == torch.bfloat16


class WgmmaLaunch(NamedTuple):
    """The wgmma kernels' launch configuration (`wgmma_launch`)."""

    wide: bool  # the 128 x 256 C tile (the GLU's 128 x 128) in place of 128 x 128 (64)
    mb: int  # C tile rows and columns of one batch element: the table is gemm_spec(mb, nb)'s
    nb: int
    ctas: int  # persistent CTAs, one an SM
    group: int  # CTAs of a worker: a worker walks one contiguous segment, its CTAs taking its tasks in turn


# a wide tile's time in narrow tiles' (twice the work, read at 85 flops a
# byte of L2 in place of 64): 1.41-1.42 where both tiles fill an H100
# (qwen3-4b's GLU and its w_out dA at 512 rows, scripts/wgmma_sweep.py)
_WIDE_TILE_COST = 1.45


def wgmma_grid(rows: int, n: int, glu: bool = False, wide: bool = False) -> tuple:
    """(mb, nb): the wgmma kernel's C tiles over ``rows`` x ``n`` outputs,
    128 x 128, or ``wide`` 128 x 256; the GLU's are half as wide (B's
    columns beside the same ones of B_gate a stage)."""
    bm, bn = build.WGMMA_TILE
    cols = bn * (2 if wide else 1) // (2 if glu else 1)
    return math.ceil(rows / bm), math.ceil(n / cols)


def wgmma_launch(rows: int, n: int, sm_count: int, glu: bool = False, batch: int = 1,
                 launch: Optional[dict] = None) -> WgmmaLaunch:
    """The launch configuration of the wgmma kernels for ``batch`` x
    ``rows`` x ``n`` outputs on ``sm_count`` SMs: the tile, the CTAs and
    the CTAs of a worker.  The CTAs are min(tasks, SMs), one an SM.  A
    worker walks one contiguous segment of the tasks
    (`core.decomposition.partition_curve` over the workers); where a CTA
    has more than one task, a worker is a group of min(4, mb, CTAs) CTAs
    that take its segment's tasks in turn, so the neighbouring tiles of the
    curve run at once and read their shared A and B panels from L2 once
    (qwen3-4b's LM head: 1.165 → 0.792 ms, scripts/wgmma_sweep.py).  The
    wide tile is taken where its modelled time, ceil(tasks / CTAs) x 1.45,
    is under the narrow tile's, ceil(tasks / CTAs): where the wide tiles
    still fill the card (qwen3-4b's GLU, LM head and w_out dA at 512 rows),
    not where halving the tiles would leave SMs idle.  A function of the
    shape and the SM count; ``launch`` (a tuned ``Knobs.launch``, which
    reaches a wrapper only through `kernels.ops.resolve_knobs`) overrides
    the tile (``wide``) and the worker group (``group``, at most the
    CTAs)."""
    mb = wgmma_grid(rows, n, glu)[0]
    return _wgmma_cost_rule(mb, n, sm_count, glu, batch, mb, launch)


def _wgmma_config(mb: int, n: int, sm_count: int, glu: bool, batch: int, group_rows: int, wide: bool,
                  group: Optional[int] = None) -> WgmmaLaunch:
    """The launch of one tile width: min(tasks, SMs) CTAs, workers of
    ``group`` CTAs (else min(4, ``group_rows``, CTAs) where a CTA has more
    than one task, else 1), the CTAs cut to a multiple of the group."""
    nb = wgmma_grid(1, n, glu, wide)[1]
    tasks = batch * mb * nb
    ctas = min(tasks, sm_count)
    if group is None:
        group = min(4, group_rows, ctas) if tasks > ctas else 1
    group = max(1, min(group, ctas))
    ctas -= ctas % group
    return WgmmaLaunch(wide, mb, nb, ctas, group)


def _wgmma_cost_rule(mb: int, n: int, sm_count: int, glu: bool, batch: int, group_rows: int,
                     launch: Optional[dict] = None) -> WgmmaLaunch:
    """`wgmma_launch`'s rule over ``batch`` x ``mb`` row blocks of ``n``
    outputs: per tile width, `_wgmma_config`, and the width of the least
    ceil(tasks / CTAs) x (1.45 if wide); ``launch`` overrides the width
    and the group."""
    best, best_cost = None, None
    for wide in (False, True):
        cfg = _wgmma_config(mb, n, sm_count, glu, batch, group_rows, wide)
        cost = math.ceil(batch * mb * cfg.nb / cfg.ctas) * (_WIDE_TILE_COST if wide else 1.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = cfg, cost
    if launch and ("wide" in launch or "group" in launch):
        wide = bool(launch.get("wide", best.wide))
        best = _wgmma_config(mb, n, sm_count, glu, batch, group_rows, wide, launch.get("group"))
    return best


def grouped_wgmma_launch(group_sizes, n: int, sm_count: int, glu: bool = False) -> WgmmaLaunch:
    """The launch configuration of the grouped wgmma kernels (K3, K9) for
    experts of ``group_sizes`` rows and ``n`` output columns on
    ``sm_count`` SMs: each expert's ceil(rows / 128) row blocks (``mb`` is
    their sum, the grouped table's row blocks; an expert with no rows has
    none) by ``nb`` column tiles, and `wgmma_launch`'s rule for the tile,
    the CTAs and the workers, a worker at most as many CTAs as the largest
    expert has row blocks (neighbouring tasks of one expert share its A
    rows).  A pure function of the group sizes, the width, the SM count and
    the GLU form, not a knob."""
    blocks = [math.ceil(int(g) / build.WGMMA_TILE[0]) for g in group_sizes]
    if not sum(blocks):
        raise ValueError(f"group sizes {tuple(group_sizes)} have no row: a grouped launch needs one")
    return _wgmma_cost_rule(sum(blocks), n, sm_count, glu, 1, max(blocks))


def _tile_name(cfg: WgmmaLaunch, glu: bool) -> str:
    """The launch counters' name of a wgmma launch's C tile, "128x128"."""
    bm, bn = build.WGMMA_TILE
    return f"{bm}x{bn * (2 if cfg.wide else 1) // (2 if glu else 1)}"


def _tma_rows(cols: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Rows of ``cols`` bf16 elements, and the bases of the given tensors,
    lie on 16-byte boundaries: what a TMA tensor map can describe."""
    return cols > 0 and cols % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def uses_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, b_gate: Optional[torch.Tensor] = None) -> bool:
    """Whether `sfc_gemm_fused` launches the wgmma kernel for these
    operands on the card: bf16, every A that the cluster kernel does not
    take (batched, or more than ``build.SPLIT_MAX_ROWS`` rows), and rows TMA
    can describe (K and N multiples of 8, A, B and B_gate 16-byte aligned).
    Every other call takes the 64 x 64 tile kernel."""
    if a.dtype != torch.bfloat16 or uses_cluster_kernel(a):
        return False
    return _tma_rows(a.shape[-1], a) and _tma_rows(b.shape[-1], b, b_gate)


def uses_replicated_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, k_layers: int = 1,
                                 k_block_factor: int = 1) -> bool:
    """Whether `sfc_gemm_replicated` launches the replicated wgmma kernel
    (K5, and K4 past 16 rows) on the card: bf16, every A that the cluster
    kernel does not take (`uses_cluster_kernel`: batched, or more than
    ``build.SPLIT_MAX_ROWS`` rows), rows TMA can describe (K and N multiples
    of 8, A and B 16-byte aligned), and a slab (`layer_slab`) that is a
    whole number of ``build.WGMMA_BK``-row steps or all of K, so that no
    stage reads the next layer's rows (past K, TMA fills zeros).  The other
    calls with a cluster-kernel A take the cluster kernel; the rest (f32,
    ragged rows or slabs) the 64 x 64 tile kernel."""
    k = a.shape[-1]
    slab = layer_slab(k, k_layers, k_block_factor)
    return uses_wgmma_kernel(a, b) and (slab % build.WGMMA_BK == 0 or slab >= k)


def replicated_wgmma_launch(batch: int, m: int, n: int, k_layers: int, sm_count: int) -> WgmmaLaunch:
    """The launch configuration of the replicated wgmma kernel for the
    ``k_layers`` copies of ``batch`` (0: the plain mode) x ``m`` x ``n``
    outputs: `_wgmma_cost_rule` over max(batch, 1) x k_layers x mb x nb
    tasks (mb = ceil(m / 128) row blocks of one batch element), workers of
    at most mb CTAs.  The table is gemm_spec(mb, nb, k_layers)'s for one
    batch element.  A pure function of the shape and the SM count."""
    mb = wgmma_grid(m, n)[0]
    return _wgmma_cost_rule(mb, n, sm_count, False, max(batch, 1) * k_layers, mb)


class AddReduceLaunch(NamedTuple):
    """K6's launch configuration (`add_reduce_launch`)."""

    threads: int  # a CTA
    vectors: int  # V: 16-byte vectors a thread takes a pass
    ctas: int  # CTAs a batch element (the grid is ctas x batch), striding past ctas x threads x V vectors


# K6's CTAs across the batch are capped at one full wave, 2048 threads an
# SM; past it they stride
_REDUCE_THREADS_PER_SM = 2048


def add_reduce_launch(batch: int, mn: int, layers: int, elem_size: int, sm_count: int) -> AddReduceLaunch:
    """The launch configuration of K6 (`add_reduce`) for ``batch`` (0: the
    3-D form) x ``layers`` copies of ``mn`` elements of ``elem_size`` bytes
    on ``sm_count`` SMs: 128 threads a CTA, one 16-byte vector a thread a
    pass (V 1), and a CTA for every 128 of the ceil(mn x elem_size / 16)
    vectors of a batch element, at most one full wave across the batch
    (2048 threads an SM), striding past it.  So decode's few vectors spread
    over as many SMs as they fill and prefill's fill every SM.  The
    constants are `scripts/split_sweep.py k6`'s (qwen3-4b's sums at 2, 4
    and 8 copies on an H100): with every load of a chunk of 8 copies in
    flight, V 2 and 4 were 3-28% slower at the bf16 rows (fewer CTAs for
    the same bytes) and at most 5% faster at the f32 GLU rows; 64 threads
    within 8% of 128, 256 up to 6% slower at decode (half the CTAs).  The
    copy count does not enter: a thread holds a chunk of 8 loads in flight
    whatever it is.  A pure function of the shape and the SM count, not a
    knob."""
    b = max(batch, 1)
    threads = 128
    cap = max(1, _REDUCE_THREADS_PER_SM // threads * sm_count // b)
    return AddReduceLaunch(threads, 1, min(math.ceil(math.ceil(mn * elem_size / 16) / threads), cap))


def uses_nt_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, a2: Optional[torch.Tensor] = None,
                         b2: Optional[torch.Tensor] = None) -> bool:
    """Whether `sfc_gemm_nt` launches the wgmma kernel on the card: bf16 and
    a contraction whose rows TMA can describe (a multiple of 8, every
    operand 16-byte aligned); else the 64 x 64 NT tile kernel."""
    return a.dtype == torch.bfloat16 and _tma_rows(a.shape[1], a, b, a2, b2)


def uses_grouped_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, b_gate: Optional[torch.Tensor] = None) -> bool:
    """Whether `sfc_gemm_grouped` launches the grouped wgmma kernel (K3) on
    the card: bf16 and rows TMA can describe (K and N multiples of 8; the
    packed A, the (E, K, N) B and B_gate 16-byte aligned); every other call
    takes the 64 x 64 tile kernel."""
    return a.dtype == torch.bfloat16 and _tma_rows(a.shape[1], a) and _tma_rows(b.shape[2], b, b_gate)


def uses_grouped_nt_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, a2: Optional[torch.Tensor] = None,
                                 b2: Optional[torch.Tensor] = None) -> bool:
    """Whether `sfc_gemm_grouped_nt` launches the grouped wgmma NT kernel
    (K9) on the card: bf16 and a contraction whose rows TMA can describe (a
    multiple of 8; the packed dC and dC2 and the (E, N, K) weights 16-byte
    aligned); else the 64 x 64 grouped NT tile kernel."""
    return a.dtype == torch.bfloat16 and _tma_rows(a.shape[1], a, b, a2, b2)


def tn_wgmma_launch(rows: int, cols: int, sm_count: int, dual: bool = False, experts: int = 1,
                    update: bool = False, group: Optional[int] = None) -> WgmmaLaunch:
    """The launch configuration of the TN wgmma kernels (K8, and K10 over
    ``experts``) for (rows, cols) dW outputs a set on ``sm_count`` SMs, in
    dW mode or (``update``) the norm and update modes: the C tile is 128 x
    128 a set, over one gilbert grid (mb, nb) per expert; the dual form's
    dW stage holds 128 columns of dC beside the same 128 of dC2 (the wide
    stage, ``wide``), its norm and update 64 beside 64 (128 x 64 a set:
    their flush would otherwise hold the second set's accumulators over
    the first set's AdamW; the two modes share the tile, so their norms
    are bitwise equal).  The CTAs and worker groups follow `wgmma_launch`'s
    rule: min(tasks, SMs) CTAs, and where a CTA has more than one task,
    workers of min(4, mb, CTAs) CTAs that take their segment's tasks in
    turn.  A function of the shape, the SM count and the form and mode;
    ``group`` (a tuned ``Knobs.launch["group"]``, at most the CTAs)
    overrides the worker group."""
    bm, bn = build.WGMMA_TILE
    wide = dual and not update
    mb, nb = math.ceil(rows / bm), math.ceil(cols / (bn // 2 if dual and update else bn))
    tasks = experts * mb * nb
    ctas = min(tasks, sm_count)
    if group is None:
        group = min(4, mb, ctas) if tasks > ctas else 1
    group = max(1, min(group, ctas))
    ctas -= ctas % group
    return WgmmaLaunch(wide, mb, nb, ctas, group)


def uses_tn_wgmma_kernel(a: torch.Tensor, b: torch.Tensor, b2: Optional[torch.Tensor] = None,
                         *state: Optional[torch.Tensor]) -> bool:
    """Whether `sfc_gemm_tn` and `sfc_gemm_grouped_tn` launch the TN wgmma
    kernels on the card, in any mode and grouped or not: bf16, at least one
    token row, rows TMA can describe (K and N multiples of 8, A, dC and dC2
    16-byte aligned) and, in the update mode, W and its f32 state (``state``)
    16-byte aligned; every other call takes the 64 x 64 TN tile kernels."""
    return (a.dtype == torch.bfloat16 and a.shape[0] >= 1 and _tma_rows(a.shape[1], a)
            and _tma_rows(b.shape[1], b, b2) and all(t.data_ptr() % 16 == 0 for t in state if t is not None))


def _launch(a, b, b_gate, bias, gate_bias, residual, *, activation, out_scale, bm, bn, out_dtype, shape,
            preact=False, abft=False, launch=None):
    batch, m, k, n, b_batched = shape
    f32_out = _f32_out(a, out_dtype)
    if f32_out:
        _check_f32_out(b_gate, bias, residual, activation, out_scale, preact)
    _check_operands(bm, bn, out_dtype, a, f32_out=f32_out, b=b, b_gate=b_gate, bias=bias, gate_bias=gate_bias,
                    residual=residual)
    if max(batch, 1) > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the grid limit {_MAX_GRID_Y}")
    out = torch.empty((batch, m, n) if a.ndim == 3 else (m, n), dtype=out_dtype, device=a.device)
    out_gate = torch.empty_like(out) if preact else None
    if out.numel() == 0:
        return _results((out, out_gate), _lane_total(None, a.device) if abft else None)
    if f32_out:
        return _launch_f32_out(a, b, out, bm=bm, bn=bn, shape=shape, abft=abft, launch=launch)
    if uses_cluster_kernel(a):
        return _launch_cluster(a, b, b_gate, bias, gate_bias, residual, out, out_gate, activation=activation,
                               out_scale=out_scale, abft=abft, launch=launch)
    if uses_wgmma_kernel(a, b, b_gate):
        return _launch_wgmma(a, b, b_gate, bias, gate_bias, residual, out, out_gate, activation=activation,
                             out_scale=out_scale, shape=shape, abft=abft, launch=launch)
    lib = build.load_library()
    fn = getattr(lib, build.entry_name(_dtype_name(a), b_gate is not None, activation, abft))
    mb, nb = math.ceil(m / bm), math.ceil(n / bn)
    tab = _device_table(mb, nb, a.device)
    parts = torch.empty((max(batch, 1), mb * nb), dtype=torch.float32, device=a.device) if abft else None
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
            None, 0, *((parts.data_ptr(),) if abft else ()), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused kernel launch failed with CUDA error {rc}")
    _count(batch, m, k, n, b_gate is not None, abft, ("sfc_gemm_fused_kernel", 1))
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


def _count(batch, m, k, n, glu, abft, kernel):
    sfc_gemm_fused.launches += 1
    sfc_gemm_fused.launches_by_shape[(batch, m, k, n, glu)] += 1
    sfc_gemm_fused.launches_by_kernel[kernel] += 1
    if abft:
        sfc_gemm_fused.abft_launches += 1


def _launch_cluster(a, b, b_gate, bias, gate_bias, residual, out, out_gate, *, activation, out_scale, abft,
                    launch=None):
    """The cluster kernel (K1 at M <= 16): one cluster of L CTAs per C tile
    of ``gemm_spec(1, nb)``'s table, CTA l the K slab of layer l; L is
    `cluster_layers`', or a tuned ``launch["layers"]`` (`forced_cluster_layers`)."""
    m, k = a.shape
    n = b.shape[1]
    if launch and "layers" in launch:
        layers = forced_cluster_layers(k, launch["layers"])
    else:
        layers = cluster_layers(k, n, sm_count(a.device))
    slab = layer_slab(k, layers)
    nb = math.ceil(n / build.TILE[1])
    tab = _device_table(1, nb, a.device)
    parts = torch.empty(nb, dtype=torch.float32, device=a.device) if abft else None
    fn = getattr(build.load_library(), build.cluster_entry_name(b_gate is not None, activation, abft))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            a.data_ptr(), b.data_ptr(), _ptr(b_gate), _ptr(bias), _ptr(gate_bias), _ptr(residual),
            out.data_ptr(), _ptr(out_gate),
            tab.data_ptr(), nb,
            m, n, k,
            layers, slab,
            int(out_scale is not None), float(out_scale if out_scale is not None else 1.0),
            int(_rows_vec(k, a) and slab % 8 == 0), int(_rows_vec(n, b, b_gate)),
            *((parts.data_ptr(),) if abft else ()), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused cluster kernel launch failed with CUDA error {rc}")
    _count(0, m, k, n, b_gate is not None, abft, ("sfc_gemm_cluster_kernel", layers))
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


def _launch_wgmma(a, b, b_gate, bias, gate_bias, residual, out, out_gate, *, activation, out_scale, shape, abft,
                  launch=None):
    """The wgmma kernel (K2, and K1 past the cluster kernel's rows):
    persistent clusters over contiguous segments of the tasks.  Shared
    weights fold the batch into the rows; per-batch weights walk each batch
    element's tiles in turn."""
    batch, m, k, n, b_batched = shape
    glu = b_gate is not None
    tb, rows = (batch, m) if b_batched else (1, max(batch, 1) * m)
    cfg = wgmma_launch(rows, n, sm_count(a.device), glu, tb, launch)
    mb, nb = cfg.mb, cfg.nb
    tab = _device_table(mb, nb, a.device)
    parts = torch.empty(tb * mb * nb * build.WGMMA_LANE_SLOTS, dtype=torch.float32, device=a.device) if abft else None
    fn = getattr(build.load_library(), build.wgmma_entry_name(glu, activation, abft))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(
            a.data_ptr(), b.data_ptr(), _ptr(b_gate), _ptr(bias), _ptr(gate_bias), _ptr(residual),
            out.data_ptr(), _ptr(out_gate),
            tab.data_ptr(), mb * nb, tb, int(b_batched),
            rows, n, k,
            int(cfg.wide), cfg.ctas, cfg.group,
            int(out_scale is not None), float(out_scale if out_scale is not None else 1.0),
            None, 0, *((parts.data_ptr(),) if abft else ()), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused wgmma kernel launch failed with CUDA error {rc}")
    _count(batch, m, k, n, glu, abft, ("sfc_gemm_wgmma_kernel", _tile_name(cfg, glu)))
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


def _launch_f32_out(a, b, out, *, bm, bn, shape, abft, launch=None):
    """K1/K2's f32-output mode (bf16 inputs, the plain product): the wgmma
    kernel's f32 flush where TMA can describe the rows (`uses_wgmma_kernel`),
    else the tile kernel's, a plain-mode A of at most 16 rows included (the
    cluster kernel writes bf16 only).  Per-batch B walks each batch
    element's tiles in turn, as `_launch_wgmma` does."""
    batch, m, k, n, b_batched = shape
    lib = build.load_library()
    if uses_wgmma_kernel(a, b):
        tb, rows = (batch, m) if b_batched else (1, max(batch, 1) * m)
        cfg = wgmma_launch(rows, n, sm_count(a.device), False, tb, launch)
        tab = _device_table(cfg.mb, cfg.nb, a.device)
        parts = (torch.empty(tb * cfg.mb * cfg.nb * build.WGMMA_LANE_SLOTS, dtype=torch.float32, device=a.device)
                 if abft else None)
        fn = getattr(lib, build.f32out_entry_name("wgmma", abft))
        args = (tab.data_ptr(), cfg.mb * cfg.nb, tb, int(b_batched), rows, n, k, int(cfg.wide), cfg.ctas, cfg.group)
        kernel = ("sfc_gemm_wgmma_f32out_kernel", _tile_name(cfg, False))
    else:
        mb, nb = math.ceil(m / bm), math.ceil(n / bn)
        tab = _device_table(mb, nb, a.device)
        parts = torch.empty((max(batch, 1), mb * nb), dtype=torch.float32, device=a.device) if abft else None
        fn = getattr(lib, build.f32out_entry_name("tile", abft))
        args = (tab.data_ptr(), mb * nb, max(batch, 1), m, n, k, m * k, k * n if b_batched else 0,
                int(_rows_vec(k, a)), int(_rows_vec(n, b)))
        kernel = ("sfc_gemm_fused_f32out_kernel", 1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *args, *((parts.data_ptr(),) if abft else ()), stream)
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_fused f32-output kernel launch failed with CUDA error {rc}")
    _count(batch, m, k, n, False, abft, kernel)
    sfc_gemm_fused.f32_out_launches += 1
    return _results((out,), _lane_total(parts, a.device) if abft else None)


@kernel_entry
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
    abft: bool = False,
    launch: Optional[dict] = None,
):
    """Single-launch SFC GEMM with the fused epilogue, plain or batched.

    ``a`` (M, K) or (B, M, K); ``b`` (K, N), or (B, K, N) per batch
    element; ``b_gate`` (K, N) selects the dual-B GLU form; ``bias`` and
    ``gate_bias`` are (N,) or (1, N); ``residual`` has the output's shape.
    ``preact`` (GLU only, no activation, scale or residual) returns the
    pair (A@B + bias, A@B_gate + gate_bias) from the one traversal of A:
    the training forward's ``_FusedSpec.preact_out``.

    On a CUDA tensor this launches a kernel; ``bm``/``bn`` must be
    `kernel_tile()`, the tile kernel's compiled tile.  A plain-mode bf16 A
    of at most 16 rows (`uses_cluster_kernel`: every decode projection)
    takes the cluster kernel, each 64-column C tile split over
    `cluster_layers` K slabs (`layer_slab`) summed in layer order inside
    the launch; every other bf16 call whose rows TMA can describe
    (`uses_wgmma_kernel`: the prefill and training forward) the wgmma
    kernel, persistent CTAs over contiguous segments of the curve, whose
    tile (128 x 128 or 128 x 256) and CTAs (`wgmma_launch`) the wrapper
    chooses from the shape and the SM count; the rest (f32, ragged rows)
    the 64 x 64 tile kernel with the whole K range in one loop.
    ``k_layers``/``k_block_factor`` only order the plain version's sum.
    ``launch`` (`check_launch`; `kernels.ops.resolve_knobs` hands a tuned
    one down) replaces the rule's L (``layers``) or the wgmma tile and
    worker group (``wide``, ``group``) of the kernel the call takes.
    Every launch adds one to ``sfc_gemm_fused.launches``, to
    ``launches_by_shape`` under ``(batch, M, K, N, glu)`` (batch 0 for the
    plain mode) and to ``launches_by_kernel`` under
    ("sfc_gemm_cluster_kernel", L), ("sfc_gemm_wgmma_kernel", its C
    tile, e.g. "128x128") or ("sfc_gemm_fused_kernel", 1).  On a CPU tensor it runs
    `sfc_gemm_fused_plain` and counts nothing.

    ``out_dtype`` float32 on bf16 inputs is the f32-output mode (the TPU
    kernel's ``acc.astype(out_dtype)``, `chunk_einsum`'s SSD scores): the
    f32 accumulator written with no bf16 rounding, on the plain product
    only (the GLU form, ``preact`` and the epilogue flags raise with it).
    On the card it launches ``sfc_gemm_wgmma_f32out_kernel`` where
    `uses_wgmma_kernel` holds and ``sfc_gemm_fused_f32out_kernel`` (the
    tile kernel) for every other call, a plain-mode A of at most 16 rows
    included; counted in ``launches_by_kernel`` under those names and in
    ``sfc_gemm_fused.f32_out_launches``.  Any other output type but the
    input's raises on the card.

    ``abft`` runs the kernel with its checksum lane (the TPU kernel's
    ``_FusedSpec.abft``) and appends an f32 scalar to the result: the sum
    of the raw f32 accumulators (the GLU's two) over every tile, before the
    epilogue, from per-task partials summed on the device.  The outputs are
    bitwise those without it.  Such a launch also adds one to
    ``sfc_gemm_fused.abft_launches``.
    """
    shape = _check(a, b, b_gate, bias, gate_bias, residual, activation, out_scale, preact)
    out_dtype = out_dtype or a.dtype
    launch = check_launch(launch)
    kw = dict(activation=activation, out_scale=out_scale, bm=bm, bn=bn, out_dtype=out_dtype, preact=preact,
              abft=abft)
    if a.device.type == "cpu":
        return sfc_gemm_fused_plain(
            a, b, b_gate, bias, gate_bias, residual,
            k_layers=k_layers, k_block_factor=k_block_factor, **kw,
        )
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_fused runs on cuda or cpu tensors, got {a.device}")
    return _launch(a, b, b_gate, bias, gate_bias, residual, shape=shape, launch=launch, **kw)


sfc_gemm_fused.launches = 0
sfc_gemm_fused.abft_launches = 0
sfc_gemm_fused.f32_out_launches = 0
sfc_gemm_fused.launches_by_shape = collections.Counter()
sfc_gemm_fused.launches_by_kernel = collections.Counter()


# ---------------------------------------------------------------------------
# the replicated 2.5D form: K4/K5 partial products, K6 their sum
# ---------------------------------------------------------------------------


def layer_slab(depth: int, k_layers: int, k_block_factor: int = 1) -> int:
    """Rows of K a layer of the replicated form owns: ``k_block_factor``
    chunks of ceil(depth / (k_layers * k_block_factor)), the JAX package's
    split of K padded to a multiple of ``k_layers * k_block_factor``; the
    last layers are clipped to ``depth`` (possibly empty).  `_k_chunks` cuts
    at the same boundaries."""
    return k_block_factor * max(1, math.ceil(depth / (k_layers * k_block_factor)))


def _rep_shape(a, b, k_layers, k_block_factor):
    batch, m, k, n, b_batched = _check(a, b, None, None, None, None, None, None, False)
    if k_layers < 1 or k_block_factor < 1:
        raise ValueError(f"bad knobs k_layers={k_layers} k_block_factor={k_block_factor}")
    return batch, m, k, n, b_batched


def sfc_gemm_replicated_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int,
    bn: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    split: int = 1,
) -> torch.Tensor:
    """The plain version of the replicated kernel, on any device.

    A Python loop over the tasks of ``gemm_spec(mb, nb, k_layers)``'s table
    (layer-major, gilbert within a layer): for each (im, in, layer) it sums
    the layer's ``k_block_factor`` K chunks in f32, in order (the TPU grid's
    innermost axis), and writes that tile of copy ``layer`` in
    ``out_dtype``.  With ``split`` > 1 it sums instead the layer's
    ``split`` sub-slabs of ``layer_slab(slab, split)`` rows in order, each
    one f32 product: the cluster kernel's order at its L'
    (`replicated_cluster_split`).  Edge tiles and chunks are clipped to the
    matrix.  Returns (k_layers, M, N), or (B, k_layers, M, N) for a batched
    ``a``."""
    batch, m, k, n, b_batched = _rep_shape(a, b, k_layers, k_block_factor)
    if bm < 1 or bn < 1 or split < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn} split={split}")
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b_batched else b[None]
    out = torch.zeros((a3.shape[0], k_layers, m, n), dtype=out_dtype or a.dtype, device=a.device)
    if m and n:
        chunks = _k_chunks(k, k_layers * k_block_factor)
        slab = layer_slab(k, k_layers, k_block_factor)
        sub = layer_slab(slab, split)
        tab = compile_schedule(gemm_spec(math.ceil(m / bm), math.ceil(n / bn), k_layers)).table
        for im, in_, layer in zip(*(row.tolist() for row in tab[:3])):
            rs = slice(im * bm, min((im + 1) * bm, m))
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((a3.shape[0], rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32,
                              device=a.device)
            s_lo, s_hi = min(layer * slab, k), min((layer + 1) * slab, k)
            parts = (chunks[layer * k_block_factor:(layer + 1) * k_block_factor] if split == 1 else
                     [slice(min(s_lo + r * sub, s_hi), min(s_lo + (r + 1) * sub, s_hi)) for r in range(split)])
            for ks in parts:
                acc += a3[:, rs, ks].float() @ b3[:, ks, cs].float()
            out[:, layer, rs, cs] = acc.to(out.dtype)
    return out if a.ndim == 3 else out[0]


@functools.lru_cache(maxsize=256)
def _device_layer_table(mb: int, nb: int, k_layers: int, device: torch.device) -> torch.Tensor:
    """(3, T) int32 major / minor / layer rows of ``gemm_spec(mb, nb,
    k_layers)``'s table, uploaded once per key and kept there."""
    tab = compile_schedule(gemm_spec(mb, nb, k_layers)).table[:3]
    return torch.from_numpy(tab.copy()).to(device).contiguous()


@kernel_entry
def sfc_gemm_replicated(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The replicated form's partial products (K4, and K5 for a batched
    ``a``): copy ``l`` is A[:, slab l] @ B[slab l, :] with the f32
    accumulator cast to ``out_dtype``, the slabs those of `layer_slab`.

    ``a`` (M, K) gives (k_layers, M, N); ``a`` (B, M, K) against ``b`` (K,
    N) shared or (B, K, N) per element gives (B, k_layers, M, N).
    ``out_dtype`` is the input type or float32 (the unfused GLU's copies).
    On a CUDA tensor this launches a kernel, ``bm``/``bn`` the tile
    kernel's compiled tile: a bf16 plain-mode A of at most 16 rows
    (`uses_cluster_kernel`: the decode projections and the LM head) the
    cluster kernel, each (tile, layer) task a cluster of
    `replicated_cluster_split` CTAs over sub-slabs of its slab, summed in
    order inside the launch; every other bf16 call whose rows TMA can
    describe and whose slab is whole (`uses_replicated_wgmma_kernel`: the
    prefill) the wgmma kernel, persistent CTAs over contiguous segments of
    the (batch element, layer, tile) tasks, its tile from
    `replicated_wgmma_launch`; the rest (f32, ragged rows or slabs) the 64
    x 64 tile kernel, one CTA per (tile, layer) task.  ``k_block_factor``
    only sets the slab (each kernel runs one K loop over it).  Every launch
    adds one to ``sfc_gemm_replicated.launches``, to ``launches_by_shape``
    under ``(batch, M, K, N, k_layers)``, batch 0 for the plain mode, and
    to ``launches_by_kernel`` under ("sfc_gemm_replicated_cluster_kernel",
    L'), ("sfc_gemm_replicated_wgmma_kernel", its C tile, e.g. "128x128")
    or ("sfc_gemm_replicated_kernel", 1).  On a CPU tensor it runs
    `sfc_gemm_replicated_plain` and counts nothing."""
    batch, m, k, n, b_batched = _rep_shape(a, b, k_layers, k_block_factor)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sfc_gemm_replicated_plain(a, b, bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
                                         out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_replicated runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, a.dtype, a, b=b)  # the copies' type is checked here, not there
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"the replicated kernel writes {a.dtype} or float32 copies, asked for {out_dtype}")
    if max(batch, 1) > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the grid limit {_MAX_GRID_Y}")
    out = torch.empty((batch, k_layers, m, n) if a.ndim == 3 else (k_layers, m, n), dtype=out_dtype,
                      device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    slab = layer_slab(k, k_layers, k_block_factor)
    out_f32 = int(out_dtype == torch.float32 and a.dtype != torch.float32)
    lib = build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if uses_cluster_kernel(a):
            split = replicated_cluster_split(k, n, k_layers, sm_count(a.device), k_block_factor)
            sub = layer_slab(slab, split)
            nb = math.ceil(n / build.TILE[1])
            tab = _device_layer_table(1, nb, k_layers, a.device)
            kernel = ("sfc_gemm_replicated_cluster_kernel", split)
            rc = getattr(lib, build.rep_entry_name("cluster", "bf16"))(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), out_f32,
                tab.data_ptr(), nb * k_layers,
                m, n, k,
                slab, split, sub,
                int(_rows_vec(k, a) and slab % 8 == 0 and sub % 8 == 0), int(_rows_vec(n, b)),
                stream,
            )
        elif uses_replicated_wgmma_kernel(a, b, k_layers, k_block_factor):
            cfg = replicated_wgmma_launch(batch, m, n, k_layers, sm_count(a.device))
            tab = _device_layer_table(cfg.mb, cfg.nb, k_layers, a.device)
            kernel = ("sfc_gemm_replicated_wgmma_kernel", _tile_name(cfg, False))
            rc = getattr(lib, build.rep_entry_name("wgmma", "bf16"))(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), out_f32,
                tab.data_ptr(), cfg.mb * cfg.nb * k_layers, max(batch, 1), int(b_batched),
                m, n, k,
                k_layers, slab,
                int(cfg.wide), cfg.ctas, cfg.group,
                stream,
            )
        else:
            mb, nb = math.ceil(m / bm), math.ceil(n / bn)
            tab = _device_layer_table(mb, nb, k_layers, a.device)
            vec = 16 // a.element_size()
            kernel = ("sfc_gemm_replicated_kernel", 1)
            rc = getattr(lib, build.rep_entry_name("gemm", _dtype_name(a)))(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), out_f32,
                tab.data_ptr(), mb * nb * k_layers, max(batch, 1),
                m, n, k,
                m * k, k * n if b_batched else 0,
                k_layers, slab,
                int(_rows_vec(k, a) and slab % vec == 0), int(_rows_vec(n, b)),
                stream,
            )
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_replicated {kernel[0]} launch failed with CUDA error {rc}")
    sfc_gemm_replicated.launches += 1
    sfc_gemm_replicated.launches_by_shape[(batch, m, k, n, k_layers)] += 1
    sfc_gemm_replicated.launches_by_kernel[kernel] += 1
    return out


sfc_gemm_replicated.launches = 0
sfc_gemm_replicated.launches_by_shape = collections.Counter()
sfc_gemm_replicated.launches_by_kernel = collections.Counter()


def _check_copies(copies: torch.Tensor) -> None:
    if copies.ndim not in (3, 4):
        raise ValueError(f"add_reduce takes (L, M, N) or (B, L, M, N) copies, got {tuple(copies.shape)}")


def add_reduce_plain(copies: torch.Tensor) -> torch.Tensor:
    """The plain version of K6 (the JAX package's ``add_reduce_ref``):
    (L, M, N) -> (M, N) or (B, L, M, N) -> (B, M, N), the f32 sum over the
    layer axis cast to the copies' type."""
    _check_copies(copies)
    return copies.float().sum(dim=copies.ndim - 3).to(copies.dtype)


@kernel_entry
def add_reduce(copies: torch.Tensor) -> torch.Tensor:
    """The layer sum of the replicated form (K6): each output element is
    the f32 sum of its L copies, written once in the copies' type.

    On a CUDA tensor this launches the kernel (bound by the (L + 1)·M·N
    elements it moves) at `add_reduce_launch`'s configuration for the
    card's SM count, a batch of at most 65535; every launch adds one to
    ``add_reduce.launches``, to ``launches_by_shape`` under ``(batch, L, M,
    N)``, batch 0 for the 3-D form, and to ``launches_by_kernel`` under
    ``("add_reduce_kernel", AddReduceLaunch)``.  On a CPU tensor it runs
    `add_reduce_plain` and counts nothing."""
    _check_copies(copies)
    if copies.device.type == "cpu":
        return add_reduce_plain(copies)
    if copies.device.type != "cuda":
        raise ValueError(f"add_reduce runs on cuda or cpu tensors, got {copies.device}")
    if copies.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"add_reduce takes float32 or bfloat16 copies, got {copies.dtype}")
    if not copies.is_contiguous():
        raise ValueError("copies must be contiguous")
    *lead, layers, m, n = copies.shape
    batch = lead[0] if lead else 0
    out = torch.empty((*lead, m, n), dtype=copies.dtype, device=copies.device)
    if out.numel() == 0:
        return out
    if layers == 0:
        return out.zero_()
    cfg = add_reduce_launch(batch, m * n, layers, copies.element_size(), sm_count(copies.device))
    launch_add_reduce(copies, out, cfg)
    add_reduce.launches += 1
    add_reduce.launches_by_shape[(batch, layers, m, n)] += 1
    add_reduce.launches_by_kernel[("add_reduce_kernel", cfg)] += 1
    return out


add_reduce.launches = 0
add_reduce.launches_by_shape = collections.Counter()
add_reduce.launches_by_kernel = collections.Counter()


def launch_add_reduce(copies: torch.Tensor, out: torch.Tensor, cfg: AddReduceLaunch) -> None:
    """One launch of K6 at the configuration ``cfg`` (`add_reduce` takes
    `add_reduce_launch`'s; `scripts/split_sweep.py` forces others): the
    contiguous (L, M, N) or (B, L, M, N) CUDA ``copies`` summed into
    ``out``.  16-byte vectors where M·N is a whole number of them and both
    bases are 16-byte aligned, else one element at a time.  Raises on a
    launch the entry refuses; counts nothing."""
    *lead, layers, m, n = copies.shape
    lib = build.load_library()
    fn = getattr(lib, build.rep_entry_name("add_reduce", _dtype_name(copies)))
    vec = int((m * n) % (16 // copies.element_size()) == 0 and copies.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(copies.device):
        stream = torch.cuda.current_stream(copies.device).cuda_stream
        rc = fn(copies.data_ptr(), out.data_ptr(), layers, lead[0] if lead else 1, m * n, vec, cfg.threads,
                cfg.vectors, cfg.ctas, stream)
    if rc != 0:
        raise RuntimeError(f"add_reduce kernel launch failed with CUDA error {rc}")


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
    ks = _k_chunks(depth, k_layers * k_block_factor)
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


# ---------------------------------------------------------------------------
# stochastic rounding and the TN update flush (the TPU kernel's
# `_apply_update_flush`, its interpret-mode hash bits)
#
# torch's uint32 has few CPU operations, so the 32-bit arithmetic runs on
# int64 tensors holding values in [0, 2^32), masked after every step.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# lanes of the (12,) hyper vector (`optim.adamw.HYP_*`)
_LR, _B1, _1MB1, _B2, _1MB2, _EPS, _WD, _B1C, _B2C, _SCALE, _SEED = range(11)


def _u32(x) -> torch.Tensor:
    """An int32 (or int) tensor's bit pattern as a uint32 value in int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in two 16-bit halves of c so
    no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (murmur3-style avalanche), the JAX package's
    ``_hash_u32``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def tile_random_bits(shape, seed) -> torch.Tensor:
    """(rows, cols) uint32 random bits (int64 holding [0, 2^32)) from a
    scalar int32 / uint32 seed: the counter hash over the tile's local
    (row, col) of the JAX package's ``tile_random_bits(hw_rng=False)``."""
    seed = _u32(seed)
    i = torch.arange(shape[0], dtype=torch.int64, device=seed.device)[:, None]
    j = torch.arange(shape[1], dtype=torch.int64, device=seed.device)[None, :]
    return _hash_u32(seed ^ _mul32(i, 0x9E3779B1) ^ _mul32(j, 0x85EBCA77))


def stochastic_round_to(x: torch.Tensor, bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round f32 ``x`` to bf16 up with probability equal to the truncated
    fraction: add the low 16 bits of ``bits`` to the f32 significand and
    truncate.  Other targets are a plain cast; non-finite values pass
    through (the JAX package's ``stochastic_round_to``)."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    xf = x.float()
    xu = (_u32(xf.view(torch.int32)) + (bits & 0xFFFF)) & 0xFFFF0000
    rounded = torch.where(xu >= 1 << 31, xu - (1 << 32), xu).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(xf), rounded, xf).to(torch.bfloat16)


def _tile_seed(hyper: torch.Tensor, salt, *salts) -> torch.Tensor:
    """Per-(step, weight, tile) uint32 seed: the int32 step (bitcast out of
    the seed lane) mixed with the weight's ``salt`` and the tile
    coordinates (each an int or an int tensor; they broadcast).  The JAX
    package's ``_tile_seed`` reads the salt from the hyper lane."""
    h = _hash_u32(_u32(hyper[_SEED].view(torch.int32)) ^ 0x2545F491)
    h = _hash_u32(h ^ _mul32(_u32(salt), 0x85EBCA77))
    for extra in salts:
        h = _hash_u32(h ^ _mul32(_u32(extra), 0x9E3779B1))
    return h


def _tile_bits(rows: int, cols: int, bm: int, bn: int, hyper, salt, *extra) -> torch.Tensor:
    """(rows, cols) stochastic-rounding bits of a whole (K, N) output: each
    element gets the hash of its tile's seed (`_tile_seed` at the tile's
    (im, in)) and its local (row, col) in that tile, as the kernel draws
    them."""
    dev = hyper.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    seed = _tile_seed(hyper, salt, r // bm, c // bn, *extra)
    return _hash_u32(seed ^ _mul32(r % bm, 0x9E3779B1) ^ _mul32(c % bn, 0x85EBCA77))


@torch.no_grad()
def _update_flush_plain(dw, master, mu, nu, w, hyper, *, bits):
    """The update flush on a whole f32 dW at once (each tile's flush is
    elementwise, so the order of tiles does not matter): AdamW from the
    hyper lanes in the TPU kernel's expression order, ``scale == 0`` a
    select that keeps the state and writes the deterministic cast, then
    master, mu, nu and W written in place.  ``bits`` None: no stochastic
    rounding."""
    h = hyper.float()
    skip = h[_SCALE] == 0.0
    g = dw * h[_SCALE]
    mu_n = h[_B1] * mu + h[_1MB1] * g
    nu_n = h[_B2] * nu + h[_1MB2] * (g * g)
    step_v = (mu_n / h[_B1C]) / (torch.sqrt(nu_n / h[_B2C]) + h[_EPS]) + h[_WD] * master
    mst_n = torch.where(skip, master, master - h[_LR] * step_v)
    mu.copy_(torch.where(skip, mu, mu_n))
    nu.copy_(torch.where(skip, nu, nu_n))
    master.copy_(mst_n)
    if bits is None:
        w.copy_(mst_n.to(w.dtype))
    else:
        w.copy_(torch.where(skip, mst_n.to(w.dtype), stochastic_round_to(mst_n, bits, w.dtype)))


def _check_update(a, shape, b2, master, mu, nu, master2, mu2, nu2, hyper, w, w2, norm, salt):
    """The update / norm modes' operands, the weight and its state of
    ``shape``: (K, N) for the TN kernel, (E, K, N) stacks for the grouped
    one.  Returns (mode, sets): the mode ("dw", "norm" or "update") and,
    for the update, one (master, mu, nu, w) per operand set."""
    state = (master, mu, nu, master2, mu2, nu2, hyper, w, w2)
    if norm:
        if any(x is not None for x in state):
            raise ValueError("the TN kernel's norm mode takes no optimizer state")
        return "norm", None
    if all(x is None for x in state):
        return "dw", None
    dual = b2 is not None
    sets = [("master", master), ("mu", mu), ("nu", nu), ("w", w)]
    sets2 = [("master2", master2), ("mu2", mu2), ("nu2", nu2), ("w2", w2)]
    need = sets + (sets2 if dual else [])
    missing = [name for name, x in need if x is None] + ([] if hyper is not None else ["hyper"])
    if missing or (not dual and any(x is not None for _, x in sets2)):
        raise ValueError(f"the TN kernel's update mode needs master, mu, nu, w and hyper (and their second set "
                         f"with b2, only then); missing {missing}")
    shape = tuple(shape)
    for name, x in need:
        want = a.dtype if name.startswith("w") else torch.float32
        if tuple(x.shape) != shape or x.dtype != want or x.device != a.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {want} tensor on {a.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if tuple(hyper.shape) != (12,) or hyper.dtype != torch.float32 or hyper.device != a.device:
        raise ValueError(f"hyper must be the (12,) float32 vector of optim.adamw.pack_adamw_hyper on {a.device}")
    if not -(1 << 31) <= salt < (1 << 31):
        raise ValueError(f"salt {salt} is not an int32")
    return "update", [(master, mu, nu, w)] + ([(master2, mu2, nu2, w2)] if dual else [])


def sfc_gemm_tn_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    b2: Optional[torch.Tensor] = None,
    master: Optional[torch.Tensor] = None,
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    hyper: Optional[torch.Tensor] = None,
    *,
    w: Optional[torch.Tensor] = None,
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    norm: bool = False,
    bm: int,
    bn: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    abft: bool = False,
):
    """The plain version of the TN kernel, on any device.

    dW mode (no state): per task of the gilbert table over C's (K, N)
    tiles, ``a[:, im]ᵀ @ b[:, in]`` (and ``b2``) accumulated in f32 over
    the contraction chunks of the M rows, one cast at the flush.  Returns
    C, or (C, C2) with ``b2``.

    Norm mode (``norm=True``) and update mode (``master``, ``mu``, ``nu``,
    ``w``, ``hyper``; with ``b2`` also the second set): the same f32 tiles,
    then per set the sum of every tile's ``sum(dW²)`` in table order,
    returned as an (n_sets,) f32 tensor.  The update mode also runs the
    flush (`_update_flush_plain`) and writes W, master, mu and nu in
    place; with ``stochastic_round`` and a bf16 W its bits are the tile
    hash at this (bm, bn), so they equal the kernel's at its 64 x 64 tile.
    The salt lane of ``hyper`` is not read: ``salt`` is the weight's.

    ``abft`` appends the checksum lane, an (n_sets, 1) f32 tensor: per set
    the sum of every tile's raw dW (before the cast, the scale and AdamW),
    per task in table order, then summed.
    """
    k, n, m = _check_tn(a, b, b2)
    mode, sets = _check_update(a, (k, n), b2, master, mu, nu, master2, mu2, nu2, hyper, w, w2, norm, salt)
    acc_dtype = torch.float32 if mode != "dw" else (out_dtype or a.dtype)
    out = torch.empty((k, n), dtype=acc_dtype, device=a.device)
    out2 = torch.empty_like(out) if b2 is not None else None
    tiles = list(_plain_tiles(k, n, m, bm, bn, k_layers, k_block_factor))
    n_sets = 1 if b2 is None else 2
    parts = torch.zeros((n_sets, len(tiles)), dtype=torch.float32, device=a.device) if abft else None
    for t, (rs, cs, chunks) in enumerate(tiles):
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
        if abft:
            parts[:, t] = torch.stack([acc.sum()] + ([acc2.sum()] if b2 is not None else []))
    chk = _lane_total(parts, a.device, n_sets) if abft else None
    if mode == "dw":
        return _results((out, out2), chk)
    outs = [out] if b2 is None else [out, out2]
    norms = torch.zeros(len(outs), dtype=torch.float32, device=a.device)
    if tiles:
        # per-tile sums of squares, summed in table order
        mb, nb = math.ceil(k / bm), math.ceil(n / bn)
        tab = torch.from_numpy(compile_schedule(gemm_spec(mb, nb, 1)).table[:2].astype("int64")).to(a.device)
        for s, dw in enumerate(outs):
            sq = F.pad(dw * dw, (0, nb * bn - n, 0, mb * bm - k)).reshape(mb, bm, nb, bn).sum(dim=(1, 3))
            norms[s] = sq[tab[0], tab[1]].sum()
    if mode == "update":
        for s, (dw, (mst, m1, m2, w_)) in enumerate(zip(outs, sets)):
            bits = None
            if stochastic_round and w_.dtype == torch.bfloat16:
                bits = _tile_bits(k, n, bm, bn, hyper, salt, *((1,) if s else ()))
            _update_flush_plain(dw, mst, m1, m2, w_, hyper, bits=bits)
    return (norms, chk) if abft else norms


def _launch_bwd(kind: str, a, b, x2, out, out2, *, rows: int, cols: int, depth: int, vec_a: bool, vec_b: bool,
                chk: Optional[torch.Tensor] = None):
    """One launch of the NT or TN kernel; ``chk`` (TN only): the (n_sets,
    n_tasks) partials of the checksum lane, which selects the lane's entry."""
    mb, nb = math.ceil(rows / build.TILE[0]), math.ceil(cols / build.TILE[1])
    tab = _device_table(mb, nb, a.device)
    fn = getattr(build.load_library(), build.bwd_entry_name(kind, _dtype_name(a), abft=chk is not None))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if kind == "nt":
            a2, b2 = x2
            ptrs = (a.data_ptr(), b.data_ptr(), _ptr(a2), _ptr(b2), out.data_ptr())
        else:
            ptrs = (a.data_ptr(), b.data_ptr(), _ptr(x2), out.data_ptr(), _ptr(out2))
        tail = (None, 0) if chk is None else (chk.data_ptr(),)  # no grouped mode; the lane's partials
        rc = fn(*ptrs, tab.data_ptr(), mb * nb, rows, cols, depth, int(vec_a), int(vec_b), *tail, stream)
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_{kind} kernel launch failed with CUDA error {rc}")


@kernel_entry
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
    launch: Optional[dict] = None,
) -> torch.Tensor:
    """C = A @ Bᵀ (+ A2 @ B2ᵀ) over the gilbert traversal of C's tiles: the
    dA backward GEMM (A = dC, B = the forward weight as stored).

    On a CUDA tensor this launches a kernel; ``bm``/``bn`` must be
    `kernel_tile()`.  A bf16 call whose contraction rows TMA can describe
    (`uses_nt_wgmma_kernel`) takes the wgmma NT kernel, whose tile and CTAs
    (`wgmma_launch`, or ``launch``'s ``wide`` and ``group``) the wrapper
    chooses; the rest the 64 x 64 NT tile kernel (the whole contraction in
    one CTA loop, ragged edges masked).
    Every launch adds one to ``sfc_gemm_nt.launches``, to
    ``launches_by_shape[(M, N, K, dual)]`` and to ``launches_by_kernel``
    under ("nt_wgmma_kernel", its C tile, e.g. "128x128") or ("nt_kernel",
    1).  On a CPU tensor it runs `sfc_gemm_nt_plain` and
    counts nothing."""
    m, n, k = _check_nt(a, b, a2, b2)
    out_dtype = out_dtype or a.dtype
    launch = check_launch(launch)
    if a.device.type == "cpu":
        return sfc_gemm_nt_plain(a, b, a2, b2, bm=bm, bn=bn, k_layers=k_layers,
                                 k_block_factor=k_block_factor, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_nt runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, a2=a2, b2=b2)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if uses_nt_wgmma_kernel(a, b, a2, b2):
        kernel = ("nt_wgmma_kernel", _launch_nt_wgmma(a, b, a2, b2, out, launch=launch))
    else:
        # an empty contraction (k == 0) still launches: the CTAs flush zeros
        _launch_bwd("nt", a, b, (a2, b2), out, None, rows=m, cols=n, depth=k,
                    vec_a=_rows_vec(k, a, a2), vec_b=_rows_vec(k, b, b2))
        kernel = ("nt_kernel", 1)
    sfc_gemm_nt.launches += 1
    sfc_gemm_nt.launches_by_shape[(m, n, k, a2 is not None)] += 1
    sfc_gemm_nt.launches_by_kernel[kernel] += 1
    return out


def _launch_nt_wgmma(a, b, a2, b2, out, *, gs: Optional[tuple] = None, launch: Optional[dict] = None) -> str:
    """One launch of the wgmma NT kernel (K7, or K9 over the group sizes
    ``gs``, b (E, N, K)); returns its tile's name."""
    m, n = a.shape[0], b.shape[-2]
    if gs is None:
        cfg = wgmma_launch(m, n, sm_count(a.device), launch=launch)
        tab, grp = _device_table(cfg.mb, cfg.nb, a.device), None
    else:
        cfg = grouped_wgmma_launch(gs, n, sm_count(a.device))
        tab = _device_grouped_table(gs, build.WGMMA_TILE[0], cfg.nb, a.device)
        grp = _device_groups(gs, build.WGMMA_TILE[0], a.device)
    fn = getattr(build.load_library(), build.bwd_entry_name("nt_wgmma", "bf16"))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), _ptr(a2), _ptr(b2), out.data_ptr(), tab.data_ptr(), tab.shape[1], m, n,
                a.shape[1], int(cfg.wide), cfg.ctas, cfg.group, _ptr(grp), 0 if gs is None else len(gs), stream)
    if rc != 0:
        kind = "sfc_gemm_nt" if gs is None else "sfc_gemm_grouped_nt"
        raise RuntimeError(f"{kind} wgmma kernel launch failed with CUDA error {rc}")
    return _tile_name(cfg, False)


def _launch_tn_wgmma(a, b, b2, out, out2, *, gs: Optional[tuple] = None, abft: bool = False,
                     group: Optional[int] = None):
    """One launch of the TN wgmma kernel in dW mode (K8, or K10 over the
    group sizes ``gs``, its (E, K, N) outputs); returns (its tile's name,
    the lane's (n_sets, tasks) partials under ``abft``, else None)."""
    t, k = a.shape
    n = b.shape[1]
    experts = 1 if gs is None else len(gs)
    cfg = tn_wgmma_launch(k, n, sm_count(a.device), b2 is not None, experts, group=group)
    tiles = cfg.mb * cfg.nb
    tab = _device_table(cfg.mb, cfg.nb, a.device)
    grp = None if gs is None else _device_groups(gs, build.WGMMA_TILE[0], a.device)
    chk = (torch.empty((1 if b2 is None else 2, experts * tiles), dtype=torch.float32, device=a.device)
           if abft else None)
    fn = getattr(build.load_library(), build.bwd_entry_name("tn_wgmma", "bf16", abft=abft))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), _ptr(b2), out.data_ptr(), _ptr(out2), tab.data_ptr(), tiles, experts,
                k, n, t, cfg.ctas, cfg.group, _ptr(grp), _ptr(chk), stream)
    if rc != 0:
        kind = "sfc_gemm_tn" if gs is None else "sfc_gemm_grouped_tn"
        raise RuntimeError(f"{kind} wgmma kernel launch failed with CUDA error {rc}")
    return _tile_name(cfg, b2 is not None), chk


def _launch_tn_update_wgmma(a, b, b2, sets, hyper, *, salt: int, stochastic_round: bool,
                            gs: Optional[tuple] = None, abft: bool = False, group: Optional[int] = None):
    """One launch of the TN wgmma kernel in norm mode (``sets`` None) or
    update mode, as `_launch_tn_update`'s; returns (its result, the tile's
    name)."""
    t, k = a.shape
    n = b.shape[1]
    n_sets = 1 if b2 is None else 2
    experts = 1 if gs is None else len(gs)
    cfg = tn_wgmma_launch(k, n, sm_count(a.device), b2 is not None, experts, update=True, group=group)
    tiles = cfg.mb * cfg.nb
    tab = _device_table(cfg.mb, cfg.nb, a.device)
    grp = None if gs is None else _device_groups(gs, build.WGMMA_TILE[0], a.device)
    partials = torch.empty((n_sets, experts * tiles), dtype=torch.float32, device=a.device)
    chk = torch.empty_like(partials) if abft else None
    fn = getattr(build.load_library(), build.bwd_entry_name("tn_update_wgmma", "bf16", abft=abft))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), _ptr(b2), n_sets, *(_ptr(x) for x in _entry_state(sets)), _ptr(hyper),
                salt, int(stochastic_round), partials.data_ptr(), tab.data_ptr(), tiles, experts, k, n, t, cfg.ctas,
                cfg.group, _ptr(grp), _ptr(chk), stream)
    if rc != 0:
        kind = "sfc_gemm_tn" if gs is None else "sfc_gemm_grouped_tn"
        raise RuntimeError(f"{kind} {'update' if sets else 'norm'} wgmma kernel launch failed with CUDA error {rc}")
    # the per-task partials in curve order, summed on the device: no atomics
    norms = partials.sum(dim=1)
    result = (norms, _lane_total(chk, a.device, n_sets)) if abft else norms
    return result, _tile_name(cfg, b2 is not None)


def _entry_state(sets) -> list:
    """The update entries' state pointers' order (w, w2, master, mu, nu,
    master2, mu2, nu2) from one (master, mu, nu, w) per set; all None in
    norm mode."""
    if sets is None:
        return [None] * 8
    (m1, u1, v1, w1), *rest = sets
    m2, u2, v2, w2 = rest[0] if rest else (None,) * 4
    return [w1, w2, m1, u1, v1, m2, u2, v2]


def _state_tensors(sets) -> tuple:
    """Every tensor of the update's sets, for `uses_tn_wgmma_kernel`."""
    return () if sets is None else tuple(x for st in sets for x in st)


def _launch_tn_update(a, b, b2, sets, hyper, *, salt: int, stochastic_round: bool, rows: int, cols: int,
                      depth: int, vec_a: bool, vec_b: bool, gs: Optional[tuple] = None, abft: bool = False):
    """One launch of the TN kernel in norm mode (``sets`` None) or update
    mode (``sets``: one (master, mu, nu, w) per operand set); returns the
    (n_sets,) per-set sums of the per-task partials.  ``gs`` (the group
    sizes) selects the grouped kernel (K10) over (E, rows, cols) stacks;
    ``abft`` K8's entry with the checksum lane (K10 has none), and then the
    pair (norms, the (n_sets, 1) lane sums)."""
    mb, nb = math.ceil(rows / build.TILE[0]), math.ceil(cols / build.TILE[1])
    n_sets = 1 if b2 is None else 2
    if gs is None:
        tab, grp, n_groups = _device_table(mb, nb, a.device), None, 0
    else:
        tab = _device_grouped_tn_table(len(gs), mb, nb, a.device)
        grp, n_groups = _device_groups(gs, build.TILE[0], a.device), len(gs)
    n_tasks = tab.shape[1]
    partials = torch.empty((n_sets, n_tasks), dtype=torch.float32, device=a.device)
    chk = torch.empty_like(partials) if abft else None
    fn = getattr(build.load_library(), build.bwd_entry_name("tn_update", _dtype_name(a), abft=abft))
    state = _entry_state(sets)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        lane = (_ptr(grp), n_groups) if chk is None else (chk.data_ptr(),)
        rc = fn(a.data_ptr(), b.data_ptr(), _ptr(b2), n_sets, *(_ptr(x) for x in state), _ptr(hyper), salt,
                int(stochastic_round), partials.data_ptr(), tab.data_ptr(), n_tasks, rows, cols, depth,
                int(vec_a), int(vec_b), *lane, stream)
    if rc != 0:
        kind = "sfc_gemm_tn" if gs is None else "sfc_gemm_grouped_tn"
        raise RuntimeError(f"{kind} {'update' if sets else 'norm'} kernel launch failed with CUDA error {rc}")
    # the per-task partials in table order, summed on the device: no atomics
    norms = partials.sum(dim=1)
    return (norms, _lane_total(chk, a.device, n_sets)) if abft else norms


@kernel_entry
def sfc_gemm_tn(
    a: torch.Tensor,  # (M, K): consumed as aᵀ, never transposed in memory
    b: torch.Tensor,  # (M, N)
    b2: Optional[torch.Tensor] = None,  # (M, N) second operand (the GLU's dWg)
    master: Optional[torch.Tensor] = None,  # (K, N) f32: selects the update mode
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
    master2: Optional[torch.Tensor] = None,  # the second set (with b2)
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    hyper: Optional[torch.Tensor] = None,  # (12,) f32, optim.adamw.pack_adamw_hyper
    *,
    w: Optional[torch.Tensor] = None,  # (K, N) in a's type, written in place
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    norm: bool = False,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_layers: int = 1,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    abft: bool = False,
    launch: Optional[dict] = None,
):
    """C = Aᵀ @ B (and Aᵀ @ B2) over the gilbert traversal of C's (K, N)
    tiles: the dW backward GEMM (A = the forward activations, B = dC), in
    one of three modes.

    * dW (no state): returns C, or (C, C2) with ``b2``.
    * norm (``norm=True``): returns the (n_sets,) f32 ``sum(dW²)`` per set;
      nothing else is written.
    * update (``master``, ``mu``, ``nu``, ``w`` and ``hyper``; with ``b2``
      also ``master2``, ``mu2``, ``nu2``, ``w2``): AdamW on each f32 dW
      tile from the hyper lanes, writing W (in ``a``'s type; stochastically
      rounded when bf16 and ``stochastic_round``) and the f32 master, mu and
      nu in place; ``hyper``'s scale lane 0 keeps the state and writes the
      deterministic cast of master.  Returns the per-set norm as the norm
      mode does, taken before the scale.  ``salt`` (an int32) is the
      weight's own: the kernel does not read ``hyper``'s salt lane.  The
      second set draws its bits with one more salt of 1.

    On a CUDA tensor this launches a TN kernel, whose CTAs each loop over
    all M rows of their tiles (no atomics: the norms are per-task partials
    summed on the device): a bf16 call that `uses_tn_wgmma_kernel` takes
    the persistent wgmma kernel (128 x 128 tiles a set, the dual form's
    norm and update 128 x 64, `tn_wgmma_launch`, its worker group
    ``launch["group"]`` where given; the writes staged in shared memory),
    every other the 64 x 64 TN tile kernel.  Each launch adds one to
    ``sfc_gemm_tn.launches``, to ``launches_by_mode[mode]``, to
    ``launches_by_shape[(K, N, M, dual)]`` (dW mode) or ``[(K, N, M, dual,
    mode)]`` and to ``launches_by_kernel`` under ("tn_wgmma_kernel" or, in
    the norm and update modes, "tn_update_wgmma_kernel", its tile, e.g.
    "128x128") or ("tn_kernel" / "tn_update_kernel", 1).  On a CPU tensor
    it runs `sfc_gemm_tn_plain` and counts nothing.

    ``abft`` (any mode) runs the kernel with its checksum lane (the TPU
    kernel's ``abft``) and appends an (n_sets, 1) f32 tensor to the result:
    per set the sum of the raw dW accumulators over every tile, before the
    cast, the scale and AdamW, from per-task partials summed on the device.
    dW mode then returns (C, chk) or (C, C2, chk), the norm and update modes
    (norms, chk).  The outputs are bitwise those without it.  Such a launch
    also adds one to ``sfc_gemm_tn.abft_launches``."""
    k, n, m = _check_tn(a, b, b2)
    mode, sets = _check_update(a, (k, n), b2, master, mu, nu, master2, mu2, nu2, hyper, w, w2, norm, salt)
    out_dtype = out_dtype or a.dtype
    group = (check_launch(launch) or {}).get("group")
    if a.device.type == "cpu":
        return sfc_gemm_tn_plain(a, b, b2, master, mu, nu, master2, mu2, nu2, hyper, w=w, w2=w2, salt=salt,
                                 stochastic_round=stochastic_round, norm=norm, bm=bm, bn=bn, k_layers=k_layers,
                                 k_block_factor=k_block_factor, out_dtype=out_dtype, abft=abft)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_tn runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, b2=b2)
    vecs = dict(vec_a=_rows_vec(k, a), vec_b=_rows_vec(n, b, b2))
    n_sets = 1 if b2 is None else 2
    if mode == "dw":
        out = torch.empty((k, n), dtype=out_dtype, device=a.device)
        out2 = torch.empty_like(out) if b2 is not None else None
        parts = None
        if out.numel() and uses_tn_wgmma_kernel(a, b, b2):
            tile, parts = _launch_tn_wgmma(a, b, b2, out, out2, abft=abft, group=group)
            kernel = ("tn_wgmma_kernel", tile)
        elif out.numel():
            mb, nb = math.ceil(k / bm), math.ceil(n / bn)
            parts = torch.empty((n_sets, mb * nb), dtype=torch.float32, device=a.device) if abft else None
            _launch_bwd("tn", a, b, b2, out, out2, rows=k, cols=n, depth=m, chk=parts, **vecs)
            kernel = ("tn_kernel", 1)
        result = _results((out, out2), _lane_total(parts, a.device, n_sets) if abft else None)
    elif k * n == 0:
        norms = torch.zeros(n_sets, dtype=torch.float32, device=a.device)
        return (norms, _lane_total(None, a.device, n_sets)) if abft else norms
    elif uses_tn_wgmma_kernel(a, b, b2, *_state_tensors(sets)):
        result, tile = _launch_tn_update_wgmma(a, b, b2, sets, hyper, salt=salt, stochastic_round=stochastic_round,
                                               abft=abft, group=group)
        kernel = ("tn_update_wgmma_kernel", tile)
    else:
        result = _launch_tn_update(a, b, b2, sets, hyper, salt=salt, stochastic_round=stochastic_round,
                                   rows=k, cols=n, depth=m, abft=abft, **vecs)
        kernel = ("tn_update_kernel", 1)
    if k * n:
        sfc_gemm_tn.launches += 1
        sfc_gemm_tn.launches_by_mode[mode] += 1
        key = (k, n, m, b2 is not None)
        sfc_gemm_tn.launches_by_shape[key if mode == "dw" else (*key, mode)] += 1
        sfc_gemm_tn.launches_by_kernel[kernel] += 1
        if abft:
            sfc_gemm_tn.abft_launches += 1
    return result


sfc_gemm_nt.launches = 0
sfc_gemm_nt.launches_by_shape = collections.Counter()
sfc_gemm_nt.launches_by_kernel = collections.Counter()
sfc_gemm_tn.launches = 0
sfc_gemm_tn.abft_launches = 0
sfc_gemm_tn.launches_by_mode = collections.Counter()
sfc_gemm_tn.launches_by_shape = collections.Counter()
sfc_gemm_tn.launches_by_kernel = collections.Counter()


# ---------------------------------------------------------------------------
# grouped (MoE expert) kernels: K3 forward, K9 dA, K10 dW / norm / update
#
# The experts' rows lie packed in one (T, K) matrix, expert 0's first, with
# ``group_sizes[e]`` rows each (zero is legal).  The TPU kernels take them
# padded to whole row blocks (`repro.kernels.ops._grouped_row_pad`); the
# CUDA kernels mask each expert's last row block at its row count instead,
# and the plain versions clip it, so no padded copy exists.  Both walk the
# TPU kernels' tables: one gilbert map per expert over its padded row blocks
# (K3, K9), one shared gilbert map over the (K, N) weight tiles replayed per
# expert (K10).
# ---------------------------------------------------------------------------


def build_grouped_task_table(row_blocks, nb: int):
    """(3, sum_e row_blocks[e] * nb) int32 table of the grouped forward / NT
    kernels: rows (im_global, in, expert), each expert's ``row_blocks[e] x
    nb`` tile grid in its own gilbert order, ``im_global`` offset by the
    row blocks of the experts before it; an expert with no rows has no
    task (the JAX package's ``build_grouped_task_table``)."""
    return compile_schedule(grouped_gemm_spec(tuple(int(r) for r in row_blocks), int(nb))).table


def build_grouped_tn_task_table(row_blocks, kb: int, nb: int):
    """(5, E * kb * nb) int32 table of the grouped TN kernel: rows (ik, in,
    expert, row_off, rb), one gilbert map of the ``kb x nb`` weight tiles
    replayed per expert, with the block offset and extent of the expert's
    rows (the JAX package's ``build_grouped_tn_task_table``)."""
    return compile_schedule(grouped_tn_spec(tuple(int(r) for r in row_blocks), int(kb), int(nb))).table


def _group_sizes(group_sizes, rows: int, experts: int):
    gs = tuple(int(g) for g in group_sizes)
    if len(gs) != experts:
        raise ValueError(f"{len(gs)} group sizes for {experts} experts")
    if any(g < 0 for g in gs) or sum(gs) != rows:
        raise ValueError(f"group sizes {gs} must be >= 0 and sum to the {rows} rows")
    return gs


def _starts(sizes):
    """Exclusive prefix sums: where each group begins."""
    out, acc = [], 0
    for s_ in sizes:
        out.append(acc)
        acc += s_
    return out


def _check_grouped(a, b, b_gate, bias, gate_bias, group_sizes, activation, out_scale, preact):
    """Shape contract of K3 and its plain version.  Returns (gs, T, K, N)."""
    if preact and (b_gate is None or activation is not None or out_scale is not None):
        raise ValueError("preact returns the two biased GLU pre-activations: it needs b_gate and takes "
                         "no activation or out_scale")
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"the grouped GEMM needs a (T, K) and b (E, K, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    e, k, n = b.shape
    gs = _group_sizes(group_sizes, a.shape[0], e)
    if b_gate is not None and tuple(b_gate.shape) != tuple(b.shape):
        raise ValueError(f"gate weights {tuple(b_gate.shape)} != {tuple(b.shape)}")
    if gate_bias is not None and b_gate is None:
        raise ValueError("gate_bias needs the GLU form (b_gate)")
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) not in ((e, n), (e, 1, n)):
            raise ValueError(f"{name} must be (E, N) or (E, 1, N) with (E, N)={(e, n)}, got {tuple(vec.shape)}")
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; pick from {ACTIVATIONS}")
    return gs, a.shape[0], k, n


def _grouped_row_tiles(gs, bm: int, nb: int):
    """(expert, row slice, local col block) per task of the grouped table at
    row block ``bm``, the expert's last row block clipped at its rows."""
    row_blocks = [math.ceil(g / bm) for g in gs]
    starts, blk_starts = _starts(gs), _starts(row_blocks)
    tab = build_grouped_task_table(row_blocks, nb)
    for im, in_, e in zip(*(row.tolist() for row in tab)):
        r0 = starts[e] + (im - blk_starts[e]) * bm
        yield e, slice(r0, min(r0 + bm, starts[e] + gs[e])), in_


def sfc_gemm_grouped_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    *,
    group_sizes,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: int,
    bn: int,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    preact: bool = False,
    abft: bool = False,
):
    """The plain version of the grouped kernel, on any device: per task of
    the grouped table (`build_grouped_task_table` over each expert's
    ``ceil(rows / bm)`` row blocks) the tile ``epilogue(a[rows of e] @
    b[e])``, accumulated in f32 over ``k_block_factor`` K chunks with the
    epilogue of `sfc_gemm_fused_plain` and expert e's bias row.  Returns
    (T, N), or the (value, gate) pair of pre-activations under ``preact``;
    ``abft`` appends the checksum lane as `sfc_gemm_fused_plain` does (an
    expert with no rows has no task and adds nothing)."""
    gs, t, k, n = _check_grouped(a, b, b_gate, bias, gate_bias, group_sizes, activation, out_scale, preact)
    if bm < 1 or bn < 1 or k_block_factor < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn} k_block_factor={k_block_factor}")
    out_dtype = out_dtype or a.dtype
    e_cnt = b.shape[0]
    bias2 = None if bias is None else bias.reshape(e_cnt, n)
    gbias2 = None if gate_bias is None else gate_bias.reshape(e_cnt, n)
    out = torch.empty((t, n), dtype=out_dtype, device=a.device)
    out_gate = torch.empty_like(out) if preact else None
    parts = None
    if t and n:
        chunks = _k_chunks(k, k_block_factor)
        tiles = list(_grouped_row_tiles(gs, bm, math.ceil(n / bn)))
        parts = torch.zeros(len(tiles), dtype=torch.float32, device=a.device) if abft else None
        for task, (e, rs, in_) in enumerate(tiles):
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
            gate = torch.zeros_like(acc) if b_gate is not None else None
            for ks in chunks:
                a_panel = a[rs, ks].float()
                acc += a_panel @ b[e, ks, cs].float()
                if gate is not None:
                    gate += a_panel @ b_gate[e, ks, cs].float()
            if abft:
                parts[task] = _tile_sums(acc, gate)
            y = _epilogue(acc, gate, None if bias2 is None else bias2[e, cs],
                          None if gbias2 is None else gbias2[e, cs], None, activation, out_scale, preact)
            if preact:
                y, g = y
                out_gate[rs, cs] = g.to(out_dtype)
            out[rs, cs] = y.to(out_dtype)
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


@functools.lru_cache(maxsize=64)
def _device_groups(gs: tuple, bm: int, device: torch.device) -> torch.Tensor:
    """(3, E) int32 per-expert row start, row count and first row block of
    ``bm`` rows (the tile kernels' 64, the wgmma kernels' 128), uploaded
    once per (group sizes, bm, device)."""
    row_blocks = [math.ceil(g / bm) for g in gs]
    arr = torch.tensor([_starts(gs), list(gs), _starts(row_blocks)], dtype=torch.int32)
    return arr.to(device).contiguous()


@functools.lru_cache(maxsize=64)
def _device_grouped_table(gs: tuple, bm: int, nb: int, device: torch.device) -> torch.Tensor:
    """(3, tasks) int32 grouped table at ``bm``-row blocks and ``nb``
    column tiles, kept on the device."""
    tab = build_grouped_task_table([math.ceil(g / bm) for g in gs], nb)
    return torch.from_numpy(tab.copy()).to(device).contiguous()


@functools.lru_cache(maxsize=64)
def _device_grouped_tn_table(experts: int, kb: int, nb: int, device: torch.device) -> torch.Tensor:
    """(3, E * kb * nb) int32 (ik, in, expert) rows of the grouped TN table;
    the kernel bounds each expert's contraction by its row count, so the
    table's offset / extent rows stay on the host."""
    tab = build_grouped_tn_task_table((1,) * experts, kb, nb)[:3]
    return torch.from_numpy(tab.copy()).to(device).contiguous()


def _launch_grouped(a, b, b_gate, bias, gate_bias, *, gs, activation, out_scale, bm, bn, out_dtype, preact, abft):
    t, k = a.shape
    e_cnt, _, n = b.shape
    glu = b_gate is not None
    vecs = [None if v is None else v.reshape(e_cnt, n) for v in (bias, gate_bias)]
    _check_operands(bm, bn, out_dtype, a, b=b, b_gate=b_gate, bias=vecs[0], gate_bias=vecs[1])
    out = torch.empty((t, n), dtype=out_dtype, device=a.device)
    out_gate = torch.empty_like(out) if preact else None
    if out.numel() == 0:
        return _results((out, out_gate), _lane_total(None, a.device) if abft else None)
    wgmma = uses_grouped_wgmma_kernel(a, b, b_gate)
    if wgmma:  # 128-row tiles, persistent CTAs over curve segments
        cfg = grouped_wgmma_launch(gs, n, sm_count(a.device), glu)
        bm, nb = build.WGMMA_TILE[0], cfg.nb
        fn = getattr(build.load_library(), build.wgmma_entry_name(glu, activation, abft))
    else:
        nb = math.ceil(n / bn)
        fn = getattr(build.load_library(), build.entry_name(_dtype_name(a), glu, activation, abft))
    tab = _device_grouped_table(gs, bm, nb, a.device)
    grp = _device_groups(gs, bm, a.device)
    slots = build.WGMMA_LANE_SLOTS if wgmma else 1  # the wgmma lane's partials: one a consumer warp
    parts = torch.empty(tab.shape[1] * slots, dtype=torch.float32, device=a.device) if abft else None
    epilogue = (int(out_scale is not None), float(out_scale if out_scale is not None else 1.0))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        ptrs = (a.data_ptr(), b.data_ptr(), _ptr(b_gate), _ptr(vecs[0]), _ptr(vecs[1]), None, out.data_ptr(),
                _ptr(out_gate), tab.data_ptr(), tab.shape[1], 1)
        lane = (parts.data_ptr(),) if abft else ()
        if wgmma:
            rc = fn(*ptrs, 0, t, n, k, int(cfg.wide), cfg.ctas, cfg.group, *epilogue, grp.data_ptr(), e_cnt,
                    *lane, stream)
        else:
            rc = fn(*ptrs, t, n, k, 0, 0, *epilogue, int(_rows_vec(k, a)), int(_rows_vec(n, b, b_gate)),
                    grp.data_ptr(), e_cnt, *lane, stream)
    if rc != 0:
        raise RuntimeError(f"sfc_gemm_grouped {'wgmma ' if wgmma else ''}kernel launch failed with CUDA error {rc}")
    sfc_gemm_grouped.launches += 1
    sfc_gemm_grouped.launches_by_shape[(e_cnt, t, k, n, glu)] += 1
    sfc_gemm_grouped.launches_by_kernel[("sfc_gemm_grouped_wgmma_kernel", _tile_name(cfg, glu)) if wgmma
                                        else ("sfc_gemm_grouped_kernel", 1)] += 1
    if abft:
        sfc_gemm_grouped.abft_launches += 1
    return _results((out, out_gate), _lane_total(parts, a.device) if abft else None)


@kernel_entry
def sfc_gemm_grouped(
    a: torch.Tensor,  # (T, K) the experts' rows, packed, unpadded
    b: torch.Tensor,  # (E, K, N) per-expert weights
    b_gate: Optional[torch.Tensor] = None,  # (E, K, N) per-expert gate weights (GLU)
    bias: Optional[torch.Tensor] = None,  # (E, N) or (E, 1, N)
    gate_bias: Optional[torch.Tensor] = None,
    *,
    group_sizes,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
    preact: bool = False,
    abft: bool = False,
):
    """Grouped (ragged) SFC GEMM with the fused epilogue: ``out[rows of e] =
    epilogue(a[rows of e] @ b[e])``, expert e owning ``group_sizes[e]``
    packed rows of ``a``; the dual-B GLU form, ``preact`` and the ``abft``
    checksum lane (counted in ``sfc_gemm_grouped.abft_launches`` too) as in
    `sfc_gemm_fused`.  Returns (T, N) (a pair under ``preact``; the lane's
    scalar appended under ``abft``).

    On a CUDA tensor this launches K3: where `uses_grouped_wgmma_kernel`
    takes the call (bf16, rows TMA can describe), the persistent wgmma
    kernel ``sfc_gemm_grouped_wgmma_kernel`` over the grouped table at
    128-row blocks, whose tile and CTAs (`grouped_wgmma_launch`) the wrapper
    chooses from the group sizes, the width and the SM count; else
    ``sfc_gemm_grouped_kernel`` (the fused kernel's 64 x 64 tile body, tile
    `kernel_tile()`).  Each masks every expert's last row block at its row
    count.  A launch adds one to ``sfc_gemm_grouped.launches``, to
    ``launches_by_shape[(E, T, K, N, glu)]`` and to ``launches_by_kernel``
    under ("sfc_gemm_grouped_wgmma_kernel", its C tile, e.g. "128x64") or
    ("sfc_gemm_grouped_kernel", 1).  On a CPU tensor it runs
    `sfc_gemm_grouped_plain` and counts nothing."""
    gs, _, _, _ = _check_grouped(a, b, b_gate, bias, gate_bias, group_sizes, activation, out_scale, preact)
    out_dtype = out_dtype or a.dtype
    kw = dict(activation=activation, out_scale=out_scale, bm=bm, bn=bn, out_dtype=out_dtype, preact=preact,
              abft=abft)
    if a.device.type == "cpu":
        return sfc_gemm_grouped_plain(a, b, b_gate, bias, gate_bias, group_sizes=gs,
                                      k_block_factor=k_block_factor, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_grouped runs on cuda or cpu tensors, got {a.device}")
    return _launch_grouped(a, b, b_gate, bias, gate_bias, gs=gs, **kw)


def _check_grouped_nt(a, b, a2, b2, group_sizes):
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[2]:
        raise ValueError(f"the grouped NT GEMM needs a (T, K) and b (E, N, K); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if (a2 is None) != (b2 is None):
        raise ValueError("the dual grouped NT form needs both a2 and b2")
    if a2 is not None and (tuple(a2.shape) != tuple(a.shape) or tuple(b2.shape) != tuple(b.shape)):
        raise ValueError(f"a2 {tuple(a2.shape)} / b2 {tuple(b2.shape)} must match a {tuple(a.shape)} / "
                         f"b {tuple(b.shape)}")
    gs = _group_sizes(group_sizes, a.shape[0], b.shape[0])
    return gs, a.shape[0], b.shape[1], a.shape[1]


def sfc_gemm_grouped_nt_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    group_sizes,
    bm: int,
    bn: int,
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of the grouped NT kernel, on any device: per task
    of the grouped table, ``a[rows of e] @ b[e]ᵀ (+ a2 @ b2[e]ᵀ)``
    accumulated in f32 over the K chunks, one cast at the flush."""
    gs, t, n, k = _check_grouped_nt(a, b, a2, b2, group_sizes)
    out = torch.empty((t, n), dtype=out_dtype or a.dtype, device=a.device)
    if t and n:
        chunks = _k_chunks(k, k_block_factor)
        for e, rs, in_ in _grouped_row_tiles(gs, bm, math.ceil(n / bn)):
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
            for ks in chunks:
                acc += a[rs, ks].float() @ b[e, cs, ks].float().T
                if a2 is not None:
                    acc += a2[rs, ks].float() @ b2[e, cs, ks].float().T
            out[rs, cs] = acc.to(out.dtype)
    return out


@kernel_entry
def sfc_gemm_grouped_nt(
    a: torch.Tensor,  # (T, K) the experts' packed rows (the dC of each expert)
    b: torch.Tensor,  # (E, N, K) per-expert weights as stored, consumed as b[e]ᵀ
    a2: Optional[torch.Tensor] = None,  # (T, K) second addend (the GLU's dA)
    b2: Optional[torch.Tensor] = None,  # (E, N, K)
    *,
    group_sizes,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    k_block_factor: int = 1,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped NT: ``out[rows of e] = a[rows of e] @ b[e]ᵀ (+ a2 @
    b2[e]ᵀ)``, the dA of the grouped (MoE expert) backward, over the
    forward's grouped table.

    On a CUDA tensor this launches K9: where `uses_grouped_nt_wgmma_kernel`
    takes the call, the persistent wgmma kernel ``grouped_nt_wgmma_kernel``
    over the grouped table at 128-row blocks (`grouped_wgmma_launch`), else
    ``grouped_nt_kernel`` (the NT kernel's 64 x 64 tile body).  A launch
    adds one to ``sfc_gemm_grouped_nt.launches``, to
    ``launches_by_shape[(E, T, N, K, dual)]`` and to ``launches_by_kernel``
    under ("grouped_nt_wgmma_kernel", its C tile) or ("grouped_nt_kernel",
    1).  On a CPU tensor it runs `sfc_gemm_grouped_nt_plain` and counts
    nothing."""
    gs, t, n, k = _check_grouped_nt(a, b, a2, b2, group_sizes)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sfc_gemm_grouped_nt_plain(a, b, a2, b2, group_sizes=gs, bm=bm, bn=bn,
                                         k_block_factor=k_block_factor, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_grouped_nt runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, a2=a2, b2=b2)
    out = torch.empty((t, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    e_cnt = b.shape[0]
    if uses_grouped_nt_wgmma_kernel(a, b, a2, b2):
        kernel = ("grouped_nt_wgmma_kernel", _launch_nt_wgmma(a, b, a2, b2, out, gs=gs))
    else:
        tab = _device_grouped_table(gs, bm, math.ceil(n / bn), a.device)
        grp = _device_groups(gs, bm, a.device)
        fn = getattr(build.load_library(), build.bwd_entry_name("nt", _dtype_name(a)))
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), _ptr(a2), _ptr(b2), out.data_ptr(), tab.data_ptr(), tab.shape[1],
                    t, n, k, int(_rows_vec(k, a, a2)), int(_rows_vec(k, b, b2)), grp.data_ptr(), e_cnt, stream)
        if rc != 0:
            raise RuntimeError(f"sfc_gemm_grouped_nt kernel launch failed with CUDA error {rc}")
        kernel = ("grouped_nt_kernel", 1)
    sfc_gemm_grouped_nt.launches += 1
    sfc_gemm_grouped_nt.launches_by_shape[(e_cnt, t, n, k, a2 is not None)] += 1
    sfc_gemm_grouped_nt.launches_by_kernel[kernel] += 1
    return out


def _check_grouped_tn(a, b, b2, group_sizes, experts):
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"the grouped TN GEMM needs a (T, K) and b (T, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    if b2 is not None and tuple(b2.shape) != tuple(b.shape):
        raise ValueError(f"b2 {tuple(b2.shape)} must match b {tuple(b.shape)}")
    if experts is None:
        experts = len(tuple(group_sizes))
    gs = _group_sizes(group_sizes, a.shape[0], experts)
    return gs, a.shape[1], b.shape[1], a.shape[0]


def grouped_tn_row_block(group_sizes) -> int:
    """The grouped TN kernel's rows per contraction chunk on the TPU: the
    largest expert's rows rounded up to 8, at most 128 (the JAX package's
    ``sfc_grouped_matmul_tn`` before its VMEM check)."""
    max_g = max(group_sizes) if len(group_sizes) else 1
    return min(128, -(-max(max_g, 8) // 8) * 8)


def _grouped_tile_bits(experts: int, rows: int, cols: int, bm: int, bn: int, hyper, salt, s: int) -> torch.Tensor:
    """(E, rows, cols) stochastic-rounding bits of set ``s`` of a grouped
    update: `_tile_bits` with the expert lane ``2e + s`` that the grouped
    flush hashes for every expert and set (the JAX package's
    ``_grouped_tn_kernel`` seeds ``_tile_seed(hyp, im, in, 2e + set)``)."""
    lane = 2 * torch.arange(experts, dtype=torch.int64, device=hyper.device)[:, None, None] + s
    return _tile_bits(rows, cols, bm, bn, hyper, salt, lane)


def sfc_gemm_grouped_tn_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    b2: Optional[torch.Tensor] = None,
    master: Optional[torch.Tensor] = None,
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    hyper: Optional[torch.Tensor] = None,
    *,
    group_sizes,
    w: Optional[torch.Tensor] = None,
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    norm: bool = False,
    bm: int,
    bn: int,
    row_block: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """The plain version of the grouped TN kernel, on any device.

    dW mode (no state): per task (ik, in, e, row_off, rb) of
    `build_grouped_tn_task_table` over ``ceil(rows / row_block)``
    contraction chunks per expert, ``a[rows of e, ik]ᵀ @ b[rows of e, in]``
    (and ``b2``) accumulated in f32 chunk by chunk, the expert's last chunk
    clipped at its rows; an expert with no rows flushes zeros.  Returns (E,
    K, N), or a pair with ``b2``.

    Norm and update modes, as `sfc_gemm_tn_plain`'s over (E, K, N) stacks:
    the same f32 tiles, per set the sum of every task's ``sum(dW²)`` in
    table order (an (n_sets,) f32 tensor); the update also runs the flush
    (`_update_flush_plain`) on every expert, an empty one's the g = 0
    update, and writes W, master, mu and nu in place, bf16 W with the
    grouped tile bits (`_grouped_tile_bits`) at this (bm, bn)."""
    gs, k, n, _ = _check_grouped_tn(a, b, b2, group_sizes, None)
    e_cnt = len(gs)
    mode, sets = _check_update(a, (e_cnt, k, n), b2, master, mu, nu, master2, mu2, nu2, hyper, w, w2, norm, salt)
    if bm < 1 or bn < 1:
        raise ValueError(f"bad knobs bm={bm} bn={bn}")
    row_block = row_block or grouped_tn_row_block(gs)
    out_dtype = torch.float32 if mode != "dw" else (out_dtype or a.dtype)
    out = torch.zeros((e_cnt, k, n), dtype=out_dtype, device=a.device)
    out2 = torch.zeros_like(out) if b2 is not None else None
    kb, nb = math.ceil(k / bm), math.ceil(n / bn)
    tab = build_grouped_tn_task_table([math.ceil(g / row_block) for g in gs], kb, nb)
    if k and n and e_cnt:
        starts = _starts(gs)
        for ik, in_, e, _, rb in zip(*(row.tolist() for row in tab)):
            rs = slice(ik * bm, min((ik + 1) * bm, k))
            cs = slice(in_ * bn, min((in_ + 1) * bn, n))
            acc = torch.zeros((rs.stop - rs.start, cs.stop - cs.start), dtype=torch.float32, device=a.device)
            acc2 = torch.zeros_like(acc) if b2 is not None else None
            end = starts[e] + gs[e]
            for c in range(rb):  # chunks past the expert's rows contribute nothing
                ms = slice(starts[e] + c * row_block, min(starts[e] + (c + 1) * row_block, end))
                a_pan = a[ms, rs].float().T
                acc += a_pan @ b[ms, cs].float()
                if b2 is not None:
                    acc2 += a_pan @ b2[ms, cs].float()
            out[e, rs, cs] = acc.to(out_dtype)
            if b2 is not None:
                out2[e, rs, cs] = acc2.to(out_dtype)
    if mode == "dw":
        return out if b2 is None else (out, out2)
    outs = [out] if b2 is None else [out, out2]
    norms = torch.zeros(len(outs), dtype=torch.float32, device=a.device)
    if k and n and e_cnt:
        # per-task sums of squares, summed in table order
        idx = [torch.from_numpy(tab[i].astype("int64")).to(a.device) for i in (2, 0, 1)]
        for s, dw in enumerate(outs):
            sq = F.pad(dw * dw, (0, nb * bn - n, 0, kb * bm - k)).reshape(e_cnt, kb, bm, nb, bn).sum(dim=(2, 4))
            norms[s] = sq[idx[0], idx[1], idx[2]].sum()
    if mode == "update":
        for s, (dw, (mst, m1, m2, w_)) in enumerate(zip(outs, sets)):
            bits = None
            if stochastic_round and w_.dtype == torch.bfloat16:
                bits = _grouped_tile_bits(e_cnt, k, n, bm, bn, hyper, salt, s)
            _update_flush_plain(dw, mst, m1, m2, w_, hyper, bits=bits)
    return norms


@kernel_entry
def sfc_gemm_grouped_tn(
    a: torch.Tensor,  # (T, K) the experts' packed forward rows
    b: torch.Tensor,  # (T, N) their dC rows, packed alike
    b2: Optional[torch.Tensor] = None,  # (T, N) second dC (the GLU's dg)
    master: Optional[torch.Tensor] = None,  # (E, K, N) f32: selects the update mode
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
    master2: Optional[torch.Tensor] = None,  # the second set (with b2)
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    hyper: Optional[torch.Tensor] = None,  # (12,) f32, optim.adamw.pack_adamw_hyper
    *,
    group_sizes,
    w: Optional[torch.Tensor] = None,  # (E, K, N) in a's type, written in place
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    norm: bool = False,
    bm: int = build.TILE[0],
    bn: int = build.TILE[1],
    row_block: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Grouped TN, ``dW[e] = a[rows of e]ᵀ @ b[rows of e]`` for every
    expert in one launch (and ``a[rows of e]ᵀ @ b2[rows of e]`` with
    ``b2``, the activations read once for both), in the three modes of
    `sfc_gemm_tn`:

    * dW (no state): returns (E, K, N), or a pair with ``b2``;
    * norm (``norm=True``): returns the (n_sets,) f32 ``sum(dW²)`` over
      every expert; nothing else is written;
    * update (``master``, ``mu``, ``nu``, ``w``, ``hyper`` as (E, K, N)
      stacks and the (12,) vector; with ``b2`` the second set): per-expert
      AdamW on each f32 dW tile, W, master, mu and nu written in place, an
      expert with no rows taking the g = 0 update (moment decay and weight
      decay) in the same launch; scale 0 keeps the state bitwise.  Returns
      the norm as the norm mode does.  The bf16 stochastic rounding hashes
      the expert lane ``2e + set`` into each tile's seed.

    On a CUDA tensor this launches K10, the TN kernels' grouped mode (each
    tile's contraction over its expert's rows, no atomics): where
    `uses_tn_wgmma_kernel` takes the call, the persistent wgmma kernel
    ``grouped_tn_wgmma_kernel`` (dW) or ``grouped_tn_update_wgmma_kernel``
    (norm, update) over the experts' tiles (`tn_wgmma_launch`),
    else ``grouped_tn_kernel`` or ``grouped_tn_update_kernel`` (the 64 x 64
    tile body).  Each launch adds one to ``sfc_gemm_grouped_tn.launches``,
    to ``launches_by_mode[mode]``, to ``launches_by_shape[(E, K, N, T,
    dual)]`` (dW mode) or ``[(E, K, N, T, dual, mode)]`` and to
    ``launches_by_kernel[(kernel, tile or 1)]``; ``row_block`` only chunks
    the plain version's sum.  On a CPU tensor it runs
    `sfc_gemm_grouped_tn_plain` and counts nothing."""
    gs, k, n, t = _check_grouped_tn(a, b, b2, group_sizes, None)
    e_cnt = len(gs)
    mode, sets = _check_update(a, (e_cnt, k, n), b2, master, mu, nu, master2, mu2, nu2, hyper, w, w2, norm, salt)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sfc_gemm_grouped_tn_plain(a, b, b2, master, mu, nu, master2, mu2, nu2, hyper, group_sizes=gs, w=w,
                                         w2=w2, salt=salt, stochastic_round=stochastic_round, norm=norm, bm=bm,
                                         bn=bn, row_block=row_block, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_gemm_grouped_tn runs on cuda or cpu tensors, got {a.device}")
    _check_operands(bm, bn, out_dtype, a, b=b, b2=b2)
    vecs = dict(vec_a=_rows_vec(k, a), vec_b=_rows_vec(n, b, b2))
    if e_cnt * k * n == 0:
        if mode == "dw":
            out = torch.empty((e_cnt, k, n), dtype=out_dtype, device=a.device)
            return out if b2 is None else (out, torch.empty_like(out))
        return torch.zeros(1 if b2 is None else 2, dtype=torch.float32, device=a.device)
    if mode == "dw" and uses_tn_wgmma_kernel(a, b, b2):
        out = torch.empty((e_cnt, k, n), dtype=out_dtype, device=a.device)
        out2 = torch.empty_like(out) if b2 is not None else None
        result = out if b2 is None else (out, out2)
        kernel = ("grouped_tn_wgmma_kernel", _launch_tn_wgmma(a, b, b2, out, out2, gs=gs)[0])
    elif mode == "dw":
        out = torch.empty((e_cnt, k, n), dtype=out_dtype, device=a.device)
        out2 = torch.empty_like(out) if b2 is not None else None
        result = out if b2 is None else (out, out2)
        kernel = ("grouped_tn_kernel", 1)
        tab = _device_grouped_tn_table(e_cnt, math.ceil(k / bm), math.ceil(n / bn), a.device)
        grp = _device_groups(gs, build.TILE[0], a.device)
        fn = getattr(build.load_library(), build.bwd_entry_name("tn", _dtype_name(a)))
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), _ptr(b2), out.data_ptr(), _ptr(out2), tab.data_ptr(),
                    tab.shape[1], k, n, t, int(vecs["vec_a"]), int(vecs["vec_b"]), grp.data_ptr(), e_cnt, stream)
        if rc != 0:
            raise RuntimeError(f"sfc_gemm_grouped_tn kernel launch failed with CUDA error {rc}")
    elif uses_tn_wgmma_kernel(a, b, b2, *_state_tensors(sets)):
        result, tile = _launch_tn_update_wgmma(a, b, b2, sets, hyper, salt=salt, stochastic_round=stochastic_round,
                                               gs=gs)
        kernel = ("grouped_tn_update_wgmma_kernel", tile)
    else:
        result = _launch_tn_update(a, b, b2, sets, hyper, salt=salt, stochastic_round=stochastic_round,
                                   rows=k, cols=n, depth=t, gs=gs, **vecs)
        kernel = ("grouped_tn_update_kernel", 1)
    sfc_gemm_grouped_tn.launches += 1
    sfc_gemm_grouped_tn.launches_by_mode[mode] += 1
    key = (e_cnt, k, n, t, b2 is not None)
    sfc_gemm_grouped_tn.launches_by_shape[key if mode == "dw" else (*key, mode)] += 1
    sfc_gemm_grouped_tn.launches_by_kernel[kernel] += 1
    return result


sfc_gemm_grouped.launches = 0
sfc_gemm_grouped.abft_launches = 0
sfc_gemm_grouped.launches_by_shape = collections.Counter()
sfc_gemm_grouped.launches_by_kernel = collections.Counter()
sfc_gemm_grouped_nt.launches = 0
sfc_gemm_grouped_nt.launches_by_shape = collections.Counter()
sfc_gemm_grouped_nt.launches_by_kernel = collections.Counter()
sfc_gemm_grouped_tn.launches = 0
sfc_gemm_grouped_tn.launches_by_mode = collections.Counter()
sfc_gemm_grouped_tn.launches_by_shape = collections.Counter()
sfc_gemm_grouped_tn.launches_by_kernel = collections.Counter()
