"""Pluggable attention backend (the port's ``repro.core.attention_backend``).

`models.attention` routes every prefill and decode attention through this
switch; the active implementation is the call site's ``attn_impl`` (from
`ArchConfig.attn_impl`) unless the `attention_backend` context overrides
it:

  "blockwise"     plain-torch online-softmax loop (`models.layers`), default
  "flash_pallas"  the dense-grid flash forward (K15, `kernels/flash_attention`)
  "sfc"           the SFC band flash forward (K11), differentiable through
                  the flash backward (K12 dQ, K13 dK/dV), and the
                  single-launch decode (K14), `kernels/sfc_attention`

Knobs: `resolve_attn_knobs` consults the tune cache (`repro_torch.tune`)
first, as the JAX package does.  On CPU tensors a cached winner's chunks,
else the caller's hint, are clipped as the JAX package clips them, so the
plain versions walk the JAX package's task tables.  On the card the chunks
are the CUDA kernel's compiled tile, the task table is built over it, and
the cache entry's launch (K11's W, K13's C, K14's S; ``Knobs.launch``)
replaces the kernel's rule; with no entry every launch is the rule's.

Left out of this slice: `run_with_fallback` and `degradation_report`
(ROADMAP queue 1 item 14): nothing falls back, a kernel that fails raises.

`flash_attention` is differentiable (`_FlashCore`, the JAX package's
``_flash_core`` custom VJP); `decode_attention` and the "flash_pallas"
kernel are forward-only, as in the JAX package, and refuse inputs that need
a gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.namespaces import NS_ATTN_BWD, NS_ATTN_DECODE, NS_ATTN_FWD
from repro_torch.kernels import build
from repro_torch.kernels.ops import ResolvedKnobs
from repro_torch.kernels.sfc_attention import (
    check_fwd_shapes,
    require_no_grad,
    sfc_decode_attention,
    sfc_flash_bwd_dkv,
    sfc_flash_bwd_dq,
    sfc_flash_fwd,
)
from repro_torch.tune.tuner import default_cache, lookup_knobs

__all__ = [
    "ATTN_IMPLS",
    "attention_backend",
    "current_attention_backend",
    "resolve_attn_impl",
    "resolve_attn_knobs",
    "flash_attention",
    "decode_attention",
]

ATTN_IMPLS = ("blockwise", "flash_pallas", "sfc")

_ATTN_BACKEND: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "attention_backend", default=None
)


@contextlib.contextmanager
def attention_backend(name: str):
    """Override the attention implementation for every call inside."""
    if name not in ATTN_IMPLS:
        raise ValueError(f"unknown attention backend {name!r}; pick from {ATTN_IMPLS}")
    tok = _ATTN_BACKEND.set(name)
    try:
        yield
    finally:
        _ATTN_BACKEND.reset(tok)


def current_attention_backend() -> Optional[str]:
    return _ATTN_BACKEND.get()


def resolve_attn_impl(impl: str) -> str:
    """Context override first, the call site's (config) value otherwise."""
    return _ATTN_BACKEND.get() or impl


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _clip_chunk(chunk: int, extent: int, floor: int = 8) -> int:
    """Largest power of two <= chunk that does not overshoot the padded
    extent, at least ``floor``."""
    return max(floor, min(_pow2_ceil(chunk), _pow2_ceil(extent)))


def resolve_attn_knobs(
    sq: int,
    sk: int,
    d: int,
    dtype,
    *,
    op: str,
    q_chunk: Optional[int] = None,
    k_chunk: Optional[int] = None,
    device: Union[str, torch.device] = "cpu",
) -> ResolvedKnobs:
    """(q_chunk, k_chunk) for one attention launch of namespace ``op``,
    equal to the JAX package's pair, with ``.launch``
    (`kernels.ops.ResolvedKnobs`).

    The tune cache's entry for the bucket (sq, sk, d) first
    (`repro_torch.tune.lookup_knobs`, backend by ``device``; a failed
    lookup raises), as the JAX package consults it even when a hint is
    given.  On the card: the CUDA kernel's compiled tile (the decode
    kernel's chunk for ``op="attn_decode"``) and as ``.launch`` the entry's
    (K11's W, K13's C, K14's S; None: the kernel's rule).  Elsewhere: the
    entry's chunks (its bm / bn), else the hint (128 when absent), clipped
    to the padded extents, the JAX package's path.  Answered once per exact
    call and cache state (`KnobCache.resolved`)."""
    cache = default_cache()
    memo = (sq, sk, d, dtype, op, q_chunk, k_chunk, device)
    hit = cache.resolved.get(memo)
    if hit is None:
        cached = lookup_knobs(sq, sk, d, dtype, cache=cache, op=op, device=device)
        if torch.device(device).type == "cuda":
            tile = (build.ATTN_TILE[0], build.DECODE_CHUNK) if op == NS_ATTN_DECODE else build.ATTN_TILE
            hit = ResolvedKnobs(tile, cached.launch if cached is not None else None)
        else:
            if cached is not None:
                q_chunk, k_chunk = cached.bm, cached.bn
            hit = ResolvedKnobs((_clip_chunk(q_chunk or 128, sq), _clip_chunk(k_chunk or 128, sk)))
        cache.resolved[memo] = hit
    return hit


def _launch_value(knobs: ResolvedKnobs, key: str) -> Optional[int]:
    return (knobs.launch or {}).get(key)


@dataclasses.dataclass(frozen=True)
class _FlashCfg:
    causal: bool
    seq_q: int
    seq_k: int
    q_chunk: int
    k_chunk: int
    q_chunk_hint: Optional[int]
    k_chunk_hint: Optional[int]
    q_offset: int = 0
    warpgroups: Optional[int] = None


class _FlashCore(torch.autograd.Function):
    """``_flash_core`` of the JAX package: K11 forward, saving (q, k, v, o,
    lse); the backward forms ``delta = rowsum(dO ⊙ O)`` in plain torch, as
    the JAX package does outside its kernels, then launches K12 and K13."""

    @staticmethod
    def forward(ctx, cfg: _FlashCfg, q, k, v):
        o, lse = sfc_flash_fwd(q, k, v, causal=cfg.causal, seq_q=cfg.seq_q, seq_k=cfg.seq_k,
                               q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, q_offset=cfg.q_offset,
                               warpgroups=cfg.warpgroups)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        cfg = ctx.cfg
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)  # (B, S, H) f32
        # the backward resolves its own knobs, as the JAX package does
        knobs = resolve_attn_knobs(cfg.seq_q, cfg.seq_k, q.shape[-1], q.dtype, op=NS_ATTN_BWD,
                                   q_chunk=cfg.q_chunk_hint, k_chunk=cfg.k_chunk_hint, device=q.device)
        qc, kc = (None, None) if q.device.type == "cuda" else knobs  # on the card each kernel's compiled tile
        kw = dict(causal=cfg.causal, seq_q=cfg.seq_q, seq_k=cfg.seq_k, q_offset=cfg.q_offset,
                  q_chunk=qc, k_chunk=kc)
        dq = sfc_flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = sfc_flash_bwd_dkv(q, k, v, do, lse, delta, cluster=_launch_value(knobs, "cluster"), **kw)
        return None, dq, dk, dv


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool = True,
    q_chunk: Optional[int] = None,
    k_chunk: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Differentiable SFC flash attention in the model's (B, S, H, D) layout.

    GQA is resolved by the kernels' head maps; ragged S and T are masked,
    not padded.  ``q_offset`` places the q block at global rows
    ``[q_offset, q_offset + S)`` of a causal stream whose first ``q_offset``
    keys are cached.  ``q_chunk``/``k_chunk`` are hints
    (`resolve_attn_knobs`); the backward resolves its own from the same
    hints.  With an input that needs a gradient the call runs through
    `_FlashCore` (K11 forward, K12/K13 backward)."""
    check_fwd_shapes(q, k, v, None, None, q_offset)  # negative q_offset, GQA ratio, ...
    s, d, t = q.shape[1], q.shape[3], k.shape[1]
    knobs = resolve_attn_knobs(s, t, d, q.dtype, op=NS_ATTN_FWD, q_chunk=q_chunk, k_chunk=k_chunk,
                               device=q.device)
    qc, kc = knobs
    cfg = _FlashCfg(causal=causal, seq_q=s, seq_k=t, q_chunk=qc, k_chunk=kc, q_chunk_hint=q_chunk,
                    k_chunk_hint=k_chunk, q_offset=q_offset, warpgroups=_launch_value(knobs, "warpgroups"))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashCore.apply(cfg, q, k, v)
    o, _ = sfc_flash_fwd(q, k, v, causal=causal, seq_q=s, seq_k=t, q_offset=q_offset, q_chunk=qc, k_chunk=kc,
                         warpgroups=cfg.warpgroups)
    return o


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D) cache
    v: torch.Tensor,  # (B, T, Hkv, D)
    valid_len: torch.Tensor,  # (B,) live cache lengths
    *,
    k_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Single-launch decode attention against the KV cache, read in place;
    drop-in for `models.layers.decode_attention`."""
    require_no_grad("attn_impl='sfc' decode_attention", q, k, v)
    h, d, t = q.shape[2], q.shape[3], k.shape[1]
    knobs = resolve_attn_knobs(h, t, d, q.dtype, op=NS_ATTN_DECODE, q_chunk=None, k_chunk=k_chunk,
                               device=q.device)
    return sfc_decode_attention(q, k, v, valid_len, k_chunk=knobs[1], splits=_launch_value(knobs, "splits"))
