"""SFC-scheduled attention: the CUDA ports of the TPU kernels
``repro.kernels.sfc_attention.sfc_flash_fwd`` (K11),
``sfc_flash_bwd_dq`` (K12), ``sfc_flash_bwd_dkv`` (K13) and
``sfc_decode_attention_pallas`` (K14), each beside its plain PyTorch
version.

``sfc_flash_fwd`` is the band-table online-softmax flash forward: it walks
the (q, k) tile pairs of the causal band in the serpentine order that
``core.schedule.attention_spec`` compiles and returns the output and the
per-row logsumexp.  ``sfc_flash_bwd_dq`` and ``sfc_flash_bwd_dkv`` are its
backward: from the forward's lse and ``delta = rowsum(dO ⊙ O)`` they
recompute the probabilities per tile and return dQ over the q-major band
and (dK, dV) over the k-major band, the GQA group innermost.
``sfc_decode_attention`` is one launch for a whole
decode step: the kv head's GQA group as its rows, a chunk loop bounded by
each sequence's live cache length, and the cache capacity cut into
`decode_splits` segments of whole chunks, reduced apart and merged in
segment order (one cluster of CTAs per (batch, kv head) on the card).

All take the model's layout (q (B, S, H, D), k/v (B, T, Hkv, D)), resolve
GQA by mapping q head h to kv head ``h // groups`` and pad nothing.  A CPU
tensor goes to the plain version (``*_plain``), which repeats the TPU
kernel's arithmetic in f32: online softmax, masked scores ``NEG``, the
final division guarded by ``max(l, 1e-30)``; the backward's
``_bwd_p_ds`` prelude.  A CUDA tensor goes to the hand-written kernel in
``csrc/sfc_attention.cu`` or the call raises; there is no fallback from
one to the other.  On the card the chunks are the kernel's compiled tile
(`kernel_chunks`; the f32 dK/dV kernel's is ``build.ATTN_DKV_TILE``).
The forward and the backward have two kernels each: a bf16 call whose
operands TMA can describe (`uses_fwd_wgmma_kernel`,
`uses_bwd_wgmma_kernel`) takes the wgmma kernels (the forward's CTA runs
W q heads of one kv head on one stream of k / v tiles, `fwd_wgmma_grid`;
K13 sums its group's q heads in parts, one a CTA of its cluster, the
order `sfc_flash_bwd_dkv_plain` takes with ``group_parts``), every other
call the 64 x 64 tile kernels.  Each public wrapper is a
`kernels.entry.kernel_entry` (one opaque operation to remat's policy).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import operator
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import sm_count
from repro_torch.core.schedule import attention_spec, compile_schedule
from repro_torch.kernels import build
from repro_torch.kernels.entry import kernel_entry

__all__ = [
    "NEG",
    "build_attention_task_table",
    "kernel_chunks",
    "require_no_grad",
    "sfc_flash_fwd",
    "sfc_flash_fwd_plain",
    "uses_fwd_wgmma_kernel",
    "fwd_wgmma_grid",
    "fwd_warpgroup_sizes",
    "sfc_flash_bwd_dq",
    "sfc_flash_bwd_dq_plain",
    "sfc_flash_bwd_dkv",
    "sfc_flash_bwd_dkv_plain",
    "uses_bwd_wgmma_kernel",
    "bwd_wgmma_grid",
    "dkv_cluster_sizes",
    "sfc_decode_attention",
    "sfc_decode_attention_plain",
    "decode_splits",
    "decode_split_sizes",
    "decode_segment_rows",
    "H100_SMS",
]

NEG = -1e30
_TINY = 1e-30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, the (batch, head) axis
# an H100 SXM's streaming multiprocessors: the SM count `decode_splits`
# takes for a CPU tensor, so the plain version runs the card's segments
H100_SMS = 132


def build_attention_task_table(
    nq: int,
    nk: int,
    *,
    causal: bool,
    q_chunk: int,
    k_chunk: int,
    transpose: bool = False,
    q_offset: int = 0,
) -> np.ndarray:
    """(4, T) band task table (major, minor, first, last) for the (nq, nk)
    attention tile grid, from `core.schedule.attention_spec`.  Causal bands
    are start-aligned: global q position ``q_offset + i`` attends
    k[0..q_offset+i].  ``transpose`` gives the k-row-major table."""
    spec = attention_spec(
        nq, nk, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk,
        transpose=transpose, q_offset=q_offset,
    )
    return compile_schedule(spec).table


def kernel_chunks() -> Tuple[int, int]:
    """(q_chunk, k_chunk) of the tile the CUDA flash kernel is compiled for."""
    return build.ATTN_TILE


def shape_key(q: torch.Tensor, k: torch.Tensor, causal: bool) -> Tuple[int, ...]:
    """The flash wrappers' ``launches_by_shape`` key: (B, S, T, H, Hkv, D,
    causal)."""
    b, s, h, d = q.shape
    return (b, s, k.shape[1], h, k.shape[2], d, bool(causal))


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel's output carries no ``grad_fn``: refuse inputs
    that would need one rather than hand autograd a constant."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only, as in the JAX package (it has no backward); "
            "call it under torch.no_grad()"
        )


def check_fwd_shapes(q, k, v, seq_q, seq_k, q_offset):
    """Shape contract of the flash forward; returns (seq_q, seq_k)."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, T, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    b2, t, hkv, d2 = k.shape
    if b != b2 or d != d2:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if hkv == 0 or h % hkv:
        raise ValueError(f"GQA heads {h} not a multiple of kv heads {hkv}")
    if t == 0:
        raise ValueError("attention needs at least one key")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    seq_q = s if seq_q is None else seq_q
    seq_k = t if seq_k is None else seq_k
    if not (0 <= seq_q <= s and 0 <= seq_k <= t):
        raise ValueError(f"seq_q={seq_q}, seq_k={seq_k} outside the shapes S={s}, T={t}")
    return seq_q, seq_k


def pad_seq(x: torch.Tensor, length: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, length - x.shape[1]))


def sfc_flash_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    k_chunk: int,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
    p_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the band flash forward, on any device.

    A Python loop over the compiled band table, all (batch, head) pairs of
    a task at once, with `_flash_fwd_kernel`'s arithmetic: q scaled by
    1/sqrt(D) in f32, masked scores NEG, f32 online softmax, flush at the
    row's last task.  Sequences are zero-padded to chunk multiples here (as
    the JAX wrapper pads); rows at or past ``seq_q`` hold the masked
    sentinel.  ``p_dtype`` rounds P to that type for P v, the row sums
    keeping the f32 P: ``torch.bfloat16`` is the CUDA kernels' bf16 forward,
    which rounds P once (the JAX kernel and None keep P f32).  Returns o
    (B, S, H, D) in q's type and lse (B, S, H) f32.
    """
    seq_q, seq_k = check_fwd_shapes(q, k, v, seq_q, seq_k, q_offset)
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    groups = h // hkv
    nq, nk = math.ceil(s / q_chunk), math.ceil(t / k_chunk)
    heads = torch.arange(h, device=q.device) // groups
    qp = pad_seq(q, nq * q_chunk).float().transpose(1, 2) * (1.0 / math.sqrt(d))  # (B, H, Sp, D)
    kp = pad_seq(k, nk * k_chunk).float()[:, :, heads].transpose(1, 2)  # (B, H, Tp, D)
    vp = pad_seq(v, nk * k_chunk).float()[:, :, heads].transpose(1, 2)
    o = torch.zeros((b, h, nq * q_chunk, d), dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, h, nq * q_chunk), dtype=torch.float32, device=q.device)
    rows = torch.arange(q_chunk, device=q.device)[:, None]
    cols = torch.arange(k_chunk, device=q.device)[None, :]
    tab = build_attention_task_table(nq, nk, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk,
                                     q_offset=q_offset)
    for iq, ik, first, last in tab.T.tolist():
        if first:
            acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=q.device)
            m = torch.full((b, h, q_chunk, 1), NEG, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        ks = slice(ik * k_chunk, (ik + 1) * k_chunk)
        sc = qp[:, :, qs] @ kp[:, :, ks].transpose(-1, -2)
        qpos, kpos = iq * q_chunk + rows, ik * k_chunk + cols
        valid = (kpos < seq_k) & (qpos < seq_q)
        if causal:
            valid = valid & (kpos <= qpos + q_offset)
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        acc = acc * alpha + (p if p_dtype is None else p.to(p_dtype).float()) @ vp[:, :, ks]
        m = m_new
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if last:
            lc = torch.clamp_min(l, _TINY)
            o[:, :, qs] = acc / lc
            lse[:, :, qs] = (m + torch.log(lc))[..., 0]
    return o[:, :, :s].transpose(1, 2).to(q.dtype), lse[:, :, :s].transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=256)
def _device_band(nq: int, nk: int, causal: bool, q_offset: int, device: torch.device,
                 q_chunk: int = build.ATTN_TILE[0], k_chunk: int = build.ATTN_TILE[1], transpose: bool = False):
    """(minor tile per task, row starts (n_major + 1,)) of the serpentine
    band over the kernel's tile, int32, uploaded once per shape and kept
    there.  Major row r's tasks are [row_start[r], row_start[r + 1]) in
    table order; the segments are found from the table's ``first`` flags.
    The major rows are q tiles, or k tiles with ``transpose``."""
    tab = build_attention_task_table(nq, nk, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk,
                                     q_offset=q_offset, transpose=transpose)
    starts = np.flatnonzero(tab[2])
    if not np.array_equal(tab[0, starts], np.arange(nk if transpose else nq)):
        raise AssertionError("band table rows are not one segment per major tile in order")
    row_start = np.append(starts, tab.shape[1]).astype(np.int32)
    return (torch.from_numpy(tab[1].copy()).to(device), torch.from_numpy(row_start).to(device))


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte aligned rows along the last (contiguous) dim."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:-1]))


def _check_launch(name: str, q: torch.Tensor, *others: torch.Tensor) -> str:
    """Device, type and layout checks shared by the kernels' launches;
    returns the C type tag."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    d = q.shape[-1]
    if d not in build.ATTN_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is compiled for head dims {build.ATTN_HEAD_DIMS}, got {d}")
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: tensors of {t.dtype} and {q.dtype}")
        if not _vec_ok(t):
            raise ValueError(f"{name}: needs a contiguous head dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")
    return build.DTYPE_NAMES[str(q.dtype).split(".")[1]]


_TMA_MAX_STRIDE = 2**37  # elements: a tensor map's strides are below 2^40 bytes


def _wgmma_operands(dtype: torch.dtype, d: int, strides, bases) -> bool:
    """Whether the wgmma flash kernels take operands of this type and head
    dim, each operand's (batch, seq, head, dim) element strides (as
    `_tma_strides` gives them) in ``strides`` and its data pointer in
    ``bases``: bf16, a head dim of 64 or 128, and views a TMA tensor map can
    describe (a contiguous last dim, the other strides positive whole 16
    bytes, 16-byte aligned bases)."""
    if dtype != torch.bfloat16 or d not in build.ATTN_HEAD_DIMS:
        return False
    for st in strides:
        if st[-1] != 1 or not all(0 < x < _TMA_MAX_STRIDE and x % 8 == 0 for x in st[:-1]):
            return False
    return all(base % 16 == 0 for base in bases)


def uses_fwd_wgmma_kernel(dtype: torch.dtype, d: int, strides, bases) -> bool:
    """Whether the flash forward (K11, K15) launches ``flash_fwd_wgmma_kernel``
    for these operands on the card: `_wgmma_operands` of q, k and v (one
    strides tuple and one base each).  Every other call takes
    ``flash_fwd_kernel``, the 64 x 64 tile kernel."""
    return _wgmma_operands(dtype, d, strides, bases)


def _tma_strides(t: torch.Tensor) -> Tuple[int, ...]:
    """The (batch, seq, head, dim) element strides of a (B, S, H, D) view as
    its tensor map takes them: a dim of extent 1 is never stepped, so its
    stride (which PyTorch leaves arbitrary) becomes the extent of the dims
    inside it."""
    if 1 not in t.shape[:3]:
        return t.stride()
    st = list(t.stride())
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = max(st[j] * t.shape[j] for j in range(i + 1, 4))
    return tuple(st)


def _fwd_route(q, k, v):
    """(whether ``flash_fwd_wgmma_kernel`` takes q, k, v, their strides as
    `_tma_strides` gives them)."""
    strides = [_tma_strides(x) for x in (q, k, v)]
    return uses_fwd_wgmma_kernel(q.dtype, q.shape[-1], strides, [x.data_ptr() for x in (q, k, v)]), strides


def fwd_warpgroup_sizes(h: int, hkv: int) -> Tuple[int, ...]:
    """The W ``flash_fwd_wgmma_kernel`` takes for ``h`` q heads over
    ``hkv`` kv heads: the divisors of the group up to
    ``build.MAX_FWD_WARPGROUPS``."""
    groups = h // hkv
    return tuple(w for w in range(1, min(groups, build.MAX_FWD_WARPGROUPS) + 1) if groups % w == 0)


@functools.lru_cache(maxsize=256)
def fwd_wgmma_grid(b: int, s: int, t: int, h: int, hkv: int,
                   sm_count: int = H100_SMS) -> Tuple[Tuple[int, int], int]:
    """((grid x, grid y), W) of a ``flash_fwd_wgmma_kernel`` launch: one CTA
    per (64-row q tile, (batch, kv head), part of the GQA group), x the
    (batch, kv head, part), y the q tile, each CTA W consumer warpgroups
    on W q heads of its kv head that share every k / v tile it loads.  W
    is a divisor of the group, at most ``build.MAX_FWD_WARPGROUPS``: the
    smallest whose CTAs fit one wave of ``sm_count`` SMs (one CTA an SM),
    since two warpgroups on one SM lengthen a CTA that has the SM to
    itself (one prompt's prefill, 1 x 128 tokens at 32 / 8 heads: W 1's
    64 CTAs 0.0074 ms, W 2's 32 CTAs 0.0092-0.0096 on an H100 80GB HBM3 at
    700 W); where none does, the largest, which reads k / v once per W q
    heads (W 2 10-30% faster than W 1 at 4 x 128, 2 x 256 and 1 x 2000).
    The keys ``t`` takes no part.  `scripts/split_sweep.py k11` times
    every W.  A function of the shapes and the card alone."""
    nq, groups = math.ceil(s / build.ATTN_TILE[0]), h // hkv
    sizes = fwd_warpgroup_sizes(h, hkv)
    fits = [w for w in sizes if nq * b * hkv * (groups // w) <= sm_count]
    w = min(fits) if fits else max(sizes)
    return (b * hkv * (groups // w), nq), w


def launch_flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tab_k: torch.Tensor,
    row_start: torch.Tensor,
    *,
    causal: bool,
    seq_q: int,
    seq_k: int,
    q_offset: int,
    want_lse: bool,
    warpgroups: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Tuple[str, int]]]:
    """One launch of a CUDA flash forward over the given per-row task
    segments, one row a q tile: ``flash_fwd_wgmma_kernel`` where
    `uses_fwd_wgmma_kernel` says so, with `fwd_wgmma_grid`'s W on this card
    (``warpgroups`` forces another), else ``flash_fwd_kernel``.  Shared by
    K11 (serpentine band, lse) and K15 (ascending k tiles, no lse).
    Returns (o, lse or None, the launched (kernel, W) key, None where the
    output is empty and nothing was launched); counts nothing."""
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    dt = _check_launch("flash forward", q, k, v)
    nq = row_start.numel() - 1
    wgmma, strides = _fwd_route(q, k, v)
    if (nq if wgmma else b * h) > _MAX_GRID_Y:
        raise ValueError(f"{'q tiles' if wgmma else 'batch x heads'} {nq if wgmma else b * h} exceed the grid "
                         f"limit {_MAX_GRID_Y}")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device) if want_lse else None
    if o.numel() == 0:
        return o, lse, None
    if wgmma:
        w = warpgroups or fwd_wgmma_grid(b, s, t, h, hkv, sm_count(q.device))[1]
        key, extra = ("flash_fwd_wgmma_kernel", w), (w,)
    else:
        key, extra, strides = ("flash_fwd_kernel", 1), (), (q.stride(), k.stride(), v.stride())
    fn = getattr(build.load_attention_library(), build.attn_entry_name("fwd_wgmma" if wgmma else "fwd", dt, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            tab_k.data_ptr(), row_start.data_ptr(),
            nq, b, h, h // hkv,
            s, t, seq_q, seq_k,
            q_offset, int(causal),
            *(x for st in strides for x in st[:3]),
            1.0 / math.sqrt(d),
            *extra,
            stream,
        )
    if rc != 0:
        raise build.KernelLaunchError("flash forward kernel", rc)
    return o, lse, key


@kernel_entry
def sfc_flash_fwd(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
    q_chunk: Optional[int] = None,
    k_chunk: Optional[int] = None,
    warpgroups: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band-scheduled flash forward: (o (B, S, H, D) in q's type, lse
    (B, S, H) f32).

    ``seq_q``/``seq_k`` (default: the shapes) bound the masks;
    ``q_offset`` places q row i at global position ``q_offset + i`` of a
    causal stream whose first ``q_offset`` keys are cached.  On a CUDA
    tensor this launches a forward kernel (`launch_flash_fwd`:
    ``flash_fwd_wgmma_kernel`` for the operands `uses_fwd_wgmma_kernel`
    takes, else ``flash_fwd_kernel``), whose tile is fixed at compile time:
    the chunks must be `kernel_chunks()` or None.  ``warpgroups`` (a tuned
    W, which `core.attention_backend.resolve_attn_knobs` hands down)
    replaces `fwd_wgmma_grid`'s W where it is a valid one for this group
    (`fwd_warpgroup_sizes`); the tile kernel ignores it, as does the plain
    version (W does not order any sum).  Every launch adds one to
    ``sfc_flash_fwd.launches``, to ``launches_by_kernel[(kernel, W)]`` (the
    tile kernel's W: 1) and to ``launches_by_shape[shape_key(...)]``.  On a
    CPU tensor it runs
    `sfc_flash_fwd_plain` (chunks default to the kernel's) and counts
    nothing.
    """
    seq_q, seq_k = check_fwd_shapes(q, k, v, seq_q, seq_k, q_offset)
    if q.device.type == "cpu":
        qc, kc = kernel_chunks()
        return sfc_flash_fwd_plain(q, k, v, causal=causal, q_chunk=q_chunk or qc, k_chunk=k_chunk or kc,
                                   seq_q=seq_q, seq_k=seq_k, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"sfc_flash_fwd runs on cuda or cpu tensors, got {q.device}")
    if (q_chunk or build.ATTN_TILE[0], k_chunk or build.ATTN_TILE[1]) != build.ATTN_TILE:
        raise ValueError(f"the CUDA kernel is compiled for (q_chunk, k_chunk)={build.ATTN_TILE}, "
                         f"got {(q_chunk, k_chunk)}")
    qc, kc = build.ATTN_TILE
    tab_k, row_start = _device_band(math.ceil(q.shape[1] / qc), math.ceil(k.shape[1] / kc), bool(causal),
                                    int(q_offset), q.device)
    if warpgroups is not None and warpgroups not in fwd_warpgroup_sizes(q.shape[2], k.shape[2]):
        warpgroups = None
    o, lse, key = launch_flash_fwd(q, k, v, tab_k, row_start, causal=causal, seq_q=seq_q, seq_k=seq_k,
                                   q_offset=q_offset, want_lse=True, warpgroups=warpgroups)
    if key is not None:
        sfc_flash_fwd.launches += 1
        sfc_flash_fwd.launches_by_kernel[key] += 1
        sfc_flash_fwd.launches_by_shape[shape_key(q, k, causal)] += 1
    return o, lse


sfc_flash_fwd.launches = 0
sfc_flash_fwd.launches_by_kernel = collections.Counter()
sfc_flash_fwd.launches_by_shape = collections.Counter()


# ---------------------------------------------------------------------------
# backward: dQ (K12) and dK / dV (K13)
# ---------------------------------------------------------------------------


def _check_bwd(q, k, v, do, lse, delta, seq_q, seq_k, q_offset):
    """Shape contract of the flash backward; returns (seq_q, seq_k)."""
    seq_q, seq_k = check_fwd_shapes(q, k, v, seq_q, seq_k, q_offset)
    b, s, h, _ = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, s, h) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (B, S, H)=({b}, {s}, {h}), got {x.dtype} {tuple(x.shape)}")
    return seq_q, seq_k


def _bwd_p_ds(q, k, v, do, lse, delta, valid, *, scale: float):
    """The (p, ds) prelude of both backward versions, all f32 (the TPU
    kernels' ``_bwd_p_ds``): p = exp(scale·qkᵀ − lse) masked to the band,
    ds = p ⊙ (do·vᵀ − delta)."""
    sc = (q @ k.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(sc - lse[..., None]), torch.zeros_like(sc))
    dp = do @ v.transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def _tile_valid(iq, ik, q_chunk, k_chunk, seq_q, seq_k, causal, q_offset, device):
    qpos = iq * q_chunk + torch.arange(q_chunk, device=device)[:, None]
    kpos = ik * k_chunk + torch.arange(k_chunk, device=device)[None, :]
    valid = (kpos < seq_k) & (qpos < seq_q)
    return valid & (kpos <= qpos + q_offset) if causal else valid


def sfc_flash_bwd_dq_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    k_chunk: int,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The plain version of the dQ kernel, on any device: a Python loop over
    the q-major band table, all (batch, head) pairs of a task at once, with
    `_flash_bwd_dq_kernel`'s arithmetic (``acc += scale · ds @ k`` in f32,
    flushed at the row's last task).  Sequences are zero-padded to chunk
    multiples internally to walk the JAX table.  Returns dQ (B, S, H, D) in
    q's type."""
    seq_q, seq_k = _check_bwd(q, k, v, do, lse, delta, seq_q, seq_k, q_offset)
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    nq, nk = math.ceil(s / q_chunk), math.ceil(t / k_chunk)
    heads = torch.arange(h, device=q.device) // (h // hkv)
    scale = 1.0 / math.sqrt(d)
    qp = pad_seq(q, nq * q_chunk).float().transpose(1, 2)  # (B, H, Sp, D)
    dop = pad_seq(do, nq * q_chunk).float().transpose(1, 2)
    kp = pad_seq(k, nk * k_chunk).float()[:, :, heads].transpose(1, 2)  # (B, H, Tp, D)
    vp = pad_seq(v, nk * k_chunk).float()[:, :, heads].transpose(1, 2)
    lsep = torch.nn.functional.pad(lse, (0, 0, 0, nq * q_chunk - s)).transpose(1, 2)  # (B, H, Sp)
    deltap = torch.nn.functional.pad(delta, (0, 0, 0, nq * q_chunk - s)).transpose(1, 2)
    dq = torch.zeros_like(qp)
    tab = build_attention_task_table(nq, nk, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk, q_offset=q_offset)
    for iq, ik, first, last in tab.T.tolist():
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        ks = slice(ik * k_chunk, (ik + 1) * k_chunk)
        if first:
            acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=q.device)
        valid = _tile_valid(iq, ik, q_chunk, k_chunk, seq_q, seq_k, causal, q_offset, q.device)
        _, ds = _bwd_p_ds(qp[:, :, qs], kp[:, :, ks], vp[:, :, ks], dop[:, :, qs], lsep[:, :, qs],
                          deltap[:, :, qs], valid, scale=scale)
        acc = acc + scale * (ds @ kp[:, :, ks])
        if last:
            dq[:, :, qs] = acc
    return dq[:, :, :s].transpose(1, 2).to(q.dtype)


def sfc_flash_bwd_dkv_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int,
    k_chunk: int,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
    group_parts: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV kernels, on any device: a Python loop
    over the k-major (transposed) band table and, innermost, the GQA group
    of each kv head, with `_flash_bwd_dkv_kernel`'s arithmetic (``dv += pᵀ
    @ do``, ``dk += scale · dsᵀ @ q`` in f32, flushed at the row's last
    task).  ``group_parts`` sums as the wgmma kernel with that many CTAs a
    cluster does: the group's q heads in that many consecutive parts, each
    part into its own f32 accumulators along the band row (its heads
    innermost), then the parts in order; 1, the tile kernel's and the TPU
    kernel's order, adds every head into one accumulator as it goes.
    Returns (dK, dV), each (B, T, Hkv, D) in k's type."""
    seq_q, seq_k = _check_bwd(q, k, v, do, lse, delta, seq_q, seq_k, q_offset)
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    groups = h // hkv
    nq, nk = math.ceil(s / q_chunk), math.ceil(t / k_chunk)
    sp, tp = nq * q_chunk, nk * k_chunk
    scale = 1.0 / math.sqrt(d)

    def by_group(x):  # (B, Sp, H, ...) -> (B, Hkv, G, Sp, ...)
        return x.reshape(b, sp, hkv, groups, *x.shape[3:]).movedim(1, 3)

    qg = by_group(pad_seq(q, sp).float())
    dog = by_group(pad_seq(do, sp).float())
    lseg = by_group(torch.nn.functional.pad(lse, (0, 0, 0, sp - s)))
    deltag = by_group(torch.nn.functional.pad(delta, (0, 0, 0, sp - s)))
    kp = pad_seq(k, tp).float().transpose(1, 2)  # (B, Hkv, Tp, D)
    vp = pad_seq(v, tp).float().transpose(1, 2)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    if group_parts < 1 or groups % group_parts:
        raise ValueError(f"group_parts {group_parts} does not divide the group of {groups} q heads")
    n_acc = group_parts
    tab = build_attention_task_table(nq, nk, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk,
                                     q_offset=q_offset, transpose=True)
    for ik, iq, first, last in tab.T.tolist():
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        ks = slice(ik * k_chunk, (ik + 1) * k_chunk)
        if first:
            zero = torch.zeros((b, hkv, k_chunk, d), dtype=torch.float32, device=q.device)
            dk_acc, dv_acc = [zero] * n_acc, [zero] * n_acc
        valid = _tile_valid(iq, ik, q_chunk, k_chunk, seq_q, seq_k, causal, q_offset, q.device)
        for g in range(groups):
            q_, do_ = qg[:, :, g, qs], dog[:, :, g, qs]
            p, ds = _bwd_p_ds(q_, kp[:, :, ks], vp[:, :, ks], do_, lseg[:, :, g, qs], deltag[:, :, g, qs],
                              valid, scale=scale)
            j = g // (groups // n_acc)
            dv_acc[j] = dv_acc[j] + p.transpose(-1, -2) @ do_
            dk_acc[j] = dk_acc[j] + scale * (ds.transpose(-1, -2) @ q_)
        if last:
            dk[:, :, ks], dv[:, :, ks] = functools.reduce(operator.add, dk_acc), functools.reduce(operator.add, dv_acc)
    return dk[:, :, :t].transpose(1, 2).to(k.dtype), dv[:, :, :t].transpose(1, 2).to(v.dtype)


def uses_bwd_wgmma_kernel(dtype: torch.dtype, d: int, strides, bases) -> bool:
    """Whether the flash backward launches its wgmma kernels (K12
    ``flash_bwd_dq_wgmma_kernel``, K13 ``flash_bwd_dkv_wgmma_kernel``) for
    these operands on the card: `_wgmma_operands` of q, k, v and dO (one
    strides tuple and one base each).  Every other call takes the 64 x 64
    tile kernels."""
    return _wgmma_operands(dtype, d, strides, bases)


def _bwd_route(q, k, v, do):
    """(whether the wgmma kernels take these operands, their (batch, seq,
    head, dim) strides as `_tma_strides` gives them, q, k, v, dO)."""
    strides = [_tma_strides(x) for x in (q, k, v, do)]
    return uses_bwd_wgmma_kernel(q.dtype, q.shape[-1], strides, [x.data_ptr() for x in (q, k, v, do)]), strides


@functools.lru_cache(maxsize=256)
def bwd_wgmma_grid(kind: str, b: int, s: int, t: int, h: int, hkv: int,
                   sm_count: int = H100_SMS) -> Tuple[Tuple[int, int], int]:
    """((grid x, grid y), CTAs a cluster) of a wgmma backward launch over
    the kernels' 64 x 64 tiles: K12 ("dq") one CTA per (q tile, (batch, q
    head)); K13 ("dkv") one cluster of C CTAs per (k tile, (batch, kv
    head)), each CTA taking ``h // hkv // C`` q heads of the group.  C is a
    divisor of the group, at most ``build.MAX_BWD_CLUSTER``: the largest
    whose CTAs fit one wave of ``sm_count`` SMs (K13 holds one CTA an SM);
    where even C 1 takes more, the smallest that gives two waves or more,
    so that the band's rows of uneven length balance (else the largest).
    `scripts/split_sweep.py k13` times every C.  A function of the shapes
    and the card alone."""
    qc, kc = build.ATTN_TILE
    if kind == "dq":
        return (math.ceil(s / qc), b * h), 1
    if kind == "dkv":
        nk = math.ceil(t / kc)
        sizes = dkv_cluster_sizes(h, hkv)
        one_wave = [c for c in sizes if nk * c * b * hkv <= sm_count]
        two_waves = [c for c in sizes if nk * c * b * hkv >= 2 * sm_count]
        cluster = max(one_wave) if one_wave else min(two_waves or [max(sizes)])
        return (nk * cluster, b * hkv), cluster
    raise ValueError(f"unknown backward kernel {kind!r}")


def dkv_cluster_sizes(h: int, hkv: int) -> Tuple[int, ...]:
    """The C ``flash_bwd_dkv_wgmma_kernel`` takes for ``h`` q heads over
    ``hkv`` kv heads: the divisors of the group up to
    ``build.MAX_BWD_CLUSTER``."""
    groups = h // hkv
    return tuple(c for c in range(1, min(groups, build.MAX_BWD_CLUSTER) + 1) if groups % c == 0)


def _dkv_cluster(q, k, sms: int) -> int:
    """K13's CTAs a cluster on a card of ``sms`` SMs (`bwd_wgmma_grid`)."""
    return bwd_wgmma_grid("dkv", q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], sms)[1]


def _launch_bwd(kind: str, q, k, v, do, lse, delta, outs, tab_minor, row_start, *, causal, seq_q, seq_k,
                q_offset, wgmma: bool = False, cluster: int = 1, strides=None):
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    dt = _check_launch(f"flash backward {kind}", q, k, v, do)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"flash backward {kind}: {name} must be contiguous on {q.device}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch x heads {b * h} exceeds the grid limit {_MAX_GRID_Y}")
    if strides is None:
        strides = [_tma_strides(x) for x in (q, k, v, do)]
    strides = (ctypes.c_longlong * 12)(*(x for st in strides for x in st[:3]))
    fn = getattr(build.load_attention_library(), build.attn_entry_name(f"{kind}_wgmma" if wgmma else kind, dt, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(o.data_ptr() for o in outs),
            tab_minor.data_ptr(), row_start.data_ptr(), row_start.numel() - 1,
            b, h, h // hkv,
            s, t, seq_q, seq_k,
            q_offset, int(causal),
            ctypes.addressof(strides),
            1.0 / math.sqrt(d),
            *((cluster,) if wgmma and kind == "dkv" else ()),
            stream,
        )
    if rc != 0:
        raise build.KernelLaunchError(f"flash backward {kind} kernel", rc)


def _bwd_chunks(name: str, tile: Tuple[int, int], q_chunk, k_chunk) -> None:
    if (q_chunk or tile[0], k_chunk or tile[1]) != tile:
        raise ValueError(f"the CUDA {name} kernel is compiled for (q_chunk, k_chunk)={tile}, "
                         f"got {(q_chunk, k_chunk)}")


@kernel_entry
def sfc_flash_bwd_dq(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    do: torch.Tensor,  # (B, S, H, D)
    lse: torch.Tensor,  # (B, S, H) f32, from the forward
    delta: torch.Tensor,  # (B, S, H) f32, rowsum(dO ⊙ O)
    *,
    causal: bool,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
    q_chunk: Optional[int] = None,
    k_chunk: Optional[int] = None,
) -> torch.Tensor:
    """dQ (B, S, H, D, in q's type) over the q-major band table.

    On a CUDA tensor this launches a dQ kernel (tile `kernel_chunks()`;
    the chunks must be that or None): ``flash_bwd_dq_wgmma_kernel`` where
    `uses_bwd_wgmma_kernel` says so, else ``flash_bwd_dq_kernel``; it adds
    one to ``sfc_flash_bwd_dq.launches``, to ``launches_by_kernel[(kernel,
    1)]`` and to ``launches_by_shape[shape_key(...)]``.  On a CPU tensor
    it runs `sfc_flash_bwd_dq_plain` (chunks default to the kernel's) and
    counts nothing."""
    seq_q, seq_k = _check_bwd(q, k, v, do, lse, delta, seq_q, seq_k, q_offset)
    kw = dict(causal=causal, seq_q=seq_q, seq_k=seq_k, q_offset=q_offset)
    if q.device.type == "cpu":
        qc, kc = build.ATTN_TILE
        return sfc_flash_bwd_dq_plain(q, k, v, do, lse, delta, q_chunk=q_chunk or qc, k_chunk=k_chunk or kc, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sfc_flash_bwd_dq runs on cuda or cpu tensors, got {q.device}")
    _bwd_chunks("dQ", build.ATTN_TILE, q_chunk, k_chunk)
    qc, kc = build.ATTN_TILE
    nq, nk = math.ceil(q.shape[1] / qc), math.ceil(k.shape[1] / kc)
    tab_k, row_start = _device_band(nq, nk, bool(causal), int(q_offset), q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        wgmma, strides = _bwd_route(q, k, v, do)
        _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), tab_k, row_start, wgmma=wgmma, strides=strides, **kw)
        sfc_flash_bwd_dq.launches += 1
        sfc_flash_bwd_dq.launches_by_kernel[("flash_bwd_dq_wgmma_kernel" if wgmma else "flash_bwd_dq_kernel", 1)] += 1
        sfc_flash_bwd_dq.launches_by_shape[shape_key(q, k, causal)] += 1
    return dq


@kernel_entry
def sfc_flash_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool,
    seq_q: Optional[int] = None,
    seq_k: Optional[int] = None,
    q_offset: int = 0,
    q_chunk: Optional[int] = None,
    k_chunk: Optional[int] = None,
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, T, Hkv, D) in k's type, over the k-major band
    table with the GQA group innermost: one kv head's accumulators stay
    resident while its q heads stream through, so no per-q-head copies
    and no reduction pass.

    On a CUDA tensor this launches a dK/dV kernel, whose tile is
    ``build.ATTN_DKV_TILE`` for the input type (the chunks must be that or
    None): where `uses_bwd_wgmma_kernel` says so
    ``flash_bwd_dkv_wgmma_kernel``, a cluster of C CTAs per k tile
    (`bwd_wgmma_grid`) that sums its CTAs' parts of the group after the
    walk, else ``flash_bwd_dkv_kernel``; it adds one to
    ``sfc_flash_bwd_dkv.launches``, to ``launches_by_kernel[(kernel, C)]``
    (the tile kernel's C: 1) and to ``launches_by_shape[shape_key(...)]``.
    ``cluster`` (a tuned C, which `core.attention_backend.resolve_attn_knobs`
    hands down) replaces the rule's where it is a valid one for this group
    (`dkv_cluster_sizes`); it orders the group's sum.  On a CPU tensor it
    runs `sfc_flash_bwd_dkv_plain` in the order the card would take for
    these operands (with `H100_SMS` SMs, or ``cluster``) and counts
    nothing."""
    seq_q, seq_k = _check_bwd(q, k, v, do, lse, delta, seq_q, seq_k, q_offset)
    kw = dict(causal=causal, seq_q=seq_q, seq_k=seq_k, q_offset=q_offset)
    if cluster is not None and cluster not in dkv_cluster_sizes(q.shape[2], k.shape[2]):
        cluster = None
    if q.device.type == "cpu":
        qc, kc = build.ATTN_TILE
        parts = (cluster or _dkv_cluster(q, k, H100_SMS)) if _bwd_route(q, k, v, do)[0] else 1
        return sfc_flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_chunk=q_chunk or qc, k_chunk=k_chunk or kc,
                                       group_parts=parts, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sfc_flash_bwd_dkv runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash backward dkv: the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    tile = build.ATTN_DKV_TILE[build.DTYPE_NAMES[str(q.dtype).split(".")[1]]]
    _bwd_chunks("dK/dV", tile, q_chunk, k_chunk)
    qc, kc = tile
    nq, nk = math.ceil(q.shape[1] / qc), math.ceil(k.shape[1] / kc)
    tab_q, row_start = _device_band(nq, nk, bool(causal), int(q_offset), q.device, qc, kc, True)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        wgmma, strides = _bwd_route(q, k, v, do)
        cluster = (cluster or _dkv_cluster(q, k, sm_count(q.device))) if wgmma else 1
        _launch_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), tab_q, row_start, wgmma=wgmma, cluster=cluster,
                    strides=strides, **kw)
        sfc_flash_bwd_dkv.launches += 1
        sfc_flash_bwd_dkv.launches_by_kernel[("flash_bwd_dkv_wgmma_kernel" if wgmma else "flash_bwd_dkv_kernel",
                                              cluster)] += 1
        sfc_flash_bwd_dkv.launches_by_shape[shape_key(q, k, causal)] += 1
    return dk, dv


sfc_flash_bwd_dq.launches = 0
sfc_flash_bwd_dq.launches_by_kernel = collections.Counter()
sfc_flash_bwd_dq.launches_by_shape = collections.Counter()
sfc_flash_bwd_dkv.launches = 0
sfc_flash_bwd_dkv.launches_by_kernel = collections.Counter()
sfc_flash_bwd_dkv.launches_by_shape = collections.Counter()


def _check_decode(q, k, v, valid_len):
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, 1, H, D) and k, v (B, T, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    b2, _, hkv, d2 = k.shape
    if b != b2 or d != d2 or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache {tuple(k.shape)}")
    if tuple(valid_len.shape) != (b,) or valid_len.dtype.is_floating_point:
        raise ValueError(f"valid_len must be an integer (B,)=({b},) tensor, got {valid_len.dtype} "
                         f"{tuple(valid_len.shape)}")


def decode_segment_rows(t: int, splits: int, chunk: int = build.DECODE_CHUNK) -> int:
    """Cache rows a segment of the split decode owns: ceil(ceil(T / chunk) /
    splits) whole chunks, so that segment s is rows [s * seg, (s + 1) *
    seg) clipped to T."""
    if splits < 1 or chunk < 1:
        raise ValueError(f"bad decode split: splits={splits} chunk={chunk}")
    return max(1, math.ceil(math.ceil(t / chunk) / splits)) * chunk


def decode_split_sizes(t: int) -> Tuple[int, ...]:
    """The segment counts the decode kernel takes for a cache capacity
    ``t``: 1 to ``build.MAX_DECODE_SPLITS``, at most one a chunk, none
    empty of capacity."""
    chunks = max(1, math.ceil(t / build.DECODE_CHUNK))
    return tuple(s for s in range(1, min(chunks, build.MAX_DECODE_SPLITS) + 1)
                 if math.ceil(chunks / math.ceil(chunks / s)) == s)


def decode_splits(batch: int, kv_heads: int, t: int, sm_count: int) -> int:
    """Segments of the decode's cache capacity ``t``: enough that batch x
    kv_heads x S CTAs give 2 an SM of ``sm_count``, at most one a
    ``build.DECODE_CHUNK``-row chunk and at most ``build.MAX_DECODE_SPLITS``
    (a portable cluster), and none empty of capacity.  A function of the
    shapes and the card alone, never of the live lengths (which stay on the
    device)."""
    chunks = max(1, math.ceil(t / build.DECODE_CHUNK))
    want = math.ceil(2 * sm_count / max(1, batch * kv_heads))
    splits = max(1, min(chunks, want, build.MAX_DECODE_SPLITS))
    per = math.ceil(chunks / splits)
    return math.ceil(chunks / per)


def _decode_walk(qg, k, v, valid, lo_seg, hi_seg, k_chunk):
    """`_decode_kernel`'s chunk walk over cache rows [lo_seg, hi_seg):
    the running (m, l, acc) of every (batch, kv head, group row), moved only
    by chunks that start inside a sequence's live length."""
    b, hkv, groups, d = qg.shape
    acc = torch.zeros((b, hkv, groups, d), dtype=torch.float32, device=qg.device)
    m = torch.full((b, hkv, groups, 1), NEG, dtype=torch.float32, device=qg.device)
    l = torch.zeros_like(m)
    top = min(hi_seg, int(valid.max())) if b else lo_seg
    for lo in range(lo_seg, top, k_chunk):
        hi = min(lo + k_chunk, hi_seg)
        sc = torch.einsum("bhgd,bnhd->bhgn", qg, k[:, lo:hi].float())
        live = torch.arange(lo, hi, device=qg.device)[None, :] < valid[:, None]  # (B, n)
        sc = torch.where(live[:, None, None, :], sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        active = (lo < valid)[:, None, None, None]
        acc = torch.where(active, acc * alpha + torch.einsum("bhgn,bnhd->bhgd", p, v[:, lo:hi].float()), acc)
        l = torch.where(active, l * alpha + p.sum(dim=-1, keepdim=True), l)
        m = torch.where(active, m_new, m)
    return m, l, acc


def sfc_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    k_chunk: int,
    splits: int = 1,
) -> torch.Tensor:
    """The plain version of the decode kernels, on any device.

    The cache capacity is cut into ``splits`` segments of whole ``k_chunk``
    chunks (`decode_segment_rows`); each segment runs `_decode_kernel`'s
    chunk walk on its own (a sequence's state moves only on chunks that
    start inside its live length, ``valid_len`` clamped to [0, T], and keys
    at or past it score NEG), and the segments' (m_s, l_s, acc_s) merge in
    segment order: m* = max m_s, l = sum l_s e^(m_s - m*), o = sum acc_s
    e^(m_s - m*) / max(l, 1e-30).  ``splits`` 1 is the TPU kernel's one
    walk.  Returns (B, 1, H, D) in q's type.
    """
    _check_decode(q, k, v, valid_len)
    b, _, h, d = q.shape
    _, t, hkv, _ = k.shape
    groups = h // hkv
    qg = q.reshape(b, hkv, groups, d).float() * (1.0 / math.sqrt(d))
    valid = valid_len.to(device=q.device, dtype=torch.long).clamp(0, t)
    seg = decode_segment_rows(t, splits, k_chunk)
    parts = [_decode_walk(qg, k, v, valid, lo, min(lo + seg, t), k_chunk) for lo in range(0, max(t, 1), seg)]
    if len(parts) == 1:
        _, l, acc = parts[0]
    else:
        mstar = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        weights = [torch.exp(m - mstar) for m, _, _ in parts]
        l = sum(lp * w for (_, lp, _), w in zip(parts, weights))
        acc = sum(ap * w for (_, _, ap), w in zip(parts, weights))
    o = acc / torch.clamp_min(l, _TINY)
    return o.reshape(b, 1, h, d).to(q.dtype)


@kernel_entry
def sfc_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D) cache, as stored
    v: torch.Tensor,  # (B, T, Hkv, D)
    valid_len: torch.Tensor,  # (B,) live cache lengths
    *,
    k_chunk: Optional[int] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Single-launch decode attention against the KV cache: (B, 1, H, D).

    The cache capacity T is cut into ``decode_splits(B, Hkv, T, SMs)``
    segments of whole chunks (SMs: the card's count; `H100_SMS` for a CPU
    tensor).  On a CUDA tensor this launches the kernel: one cluster of S
    CTAs per (batch, kv head), each reducing one segment, the leader merging
    them; the live lengths ``valid_len`` stay on the device (int32; the host
    never reads them) and the cache is read in place.  ``k_chunk`` must be
    ``build.DECODE_CHUNK`` or None.  ``splits`` (a tuned S, which
    `core.attention_backend.resolve_attn_knobs` hands down) replaces the
    rule's where `decode_split_sizes` holds it; it orders the merge, on
    the card and in the plain version alike.  Every launch adds one to
    ``sfc_decode_attention.launches``, to ``launches_by_splits[S]`` and to
    ``launches_by_shape[(B, H, T, Hkv, D)]``.  On
    a CPU tensor it runs `sfc_decode_attention_plain` with the same
    segments and counts nothing.
    """
    _check_decode(q, k, v, valid_len)
    b, _, h, d = q.shape
    _, t, hkv, _ = k.shape
    if splits is not None and splits not in decode_split_sizes(t):
        splits = None
    if q.device.type == "cpu":
        return sfc_decode_attention_plain(q, k, v, valid_len, k_chunk=k_chunk or build.DECODE_CHUNK,
                                          splits=splits or decode_splits(b, hkv, t, H100_SMS))
    if q.device.type != "cuda":
        raise ValueError(f"sfc_decode_attention runs on cuda or cpu tensors, got {q.device}")
    if k_chunk not in (None, build.DECODE_CHUNK):
        raise ValueError(f"the CUDA kernel is compiled for k_chunk={build.DECODE_CHUNK}, got {k_chunk}")
    if h // hkv > build.MAX_DECODE_GROUPS:
        raise ValueError(f"GQA group {h // hkv} exceeds the kernel's {build.MAX_DECODE_GROUPS} rows")
    if valid_len.dtype != torch.int32 or valid_len.device != q.device or not valid_len.is_contiguous():
        raise TypeError(f"valid_len must be a contiguous int32 tensor on {q.device}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    dt = _check_launch("decode attention", q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    splits = splits or decode_splits(b, hkv, t, sm_count(q.device))
    fn = getattr(build.load_attention_library(), build.attn_entry_name("decode", dt, d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(), o.data_ptr(),
            b, h, hkv, t,
            *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(d),
            splits, decode_segment_rows(t, splits),
            stream,
        )
    if rc != 0:
        raise build.KernelLaunchError("decode attention kernel", rc)
    sfc_decode_attention.launches += 1
    sfc_decode_attention.launches_by_splits[splits] += 1
    sfc_decode_attention.launches_by_shape[(b, h, t, hkv, d)] += 1
    return o


sfc_decode_attention.launches = 0
sfc_decode_attention.launches_by_splits = collections.Counter()
sfc_decode_attention.launches_by_shape = collections.Counter()
