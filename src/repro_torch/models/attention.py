"""GQA attention block with RoPE, qk-norm, optional qkv bias, a KV-cache
decode and cross-attention (the port's ``repro.models.attention``).

`Attention` holds the parameters; the prefill/decode math is in plain
functions that take it, as the JAX package's functions take its parameter
dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import attention_backend as _ab
from repro_torch.core.gemm_backend import matmul as _bmm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.models.layers import (
    RMSNorm,
    apply_rope,
    blockwise_attention,
    decode_attention,
    normal_,
    param,
    rmsnorm,
)

__all__ = [
    "Attention",
    "attention_forward",
    "attention_prefill",
    "attention_decode",
    "cross_attention_forward",
    "cross_attention_decode",
    "precompute_cross_kv",
]


def _attend(q, k, v, *, causal: bool, q_chunk: int, k_chunk: int, attn_impl: str) -> torch.Tensor:
    """The switch for every prefill/training attention contraction; the
    `attention_backend` context wins over the per-call (config) value."""
    impl = _ab.resolve_attn_impl(attn_impl)
    if impl == "sfc":
        # the SFC band flash forward (K11); the config's chunks are hints
        return _ab.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    if impl == "flash_pallas":
        return _fa.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    raise ValueError(f"unknown attn_impl {impl!r}; pick from {_ab.ATTN_IMPLS}")


def _attend_cached(q, k, v, valid: torch.Tensor, *, attn_impl: str) -> torch.Tensor:
    """The decode-path switch: "sfc" runs the whole (batch, head) fan-out as
    one launch (K14); "flash_pallas" and "blockwise" decode in plain torch,
    as in the JAX package."""
    impl = _ab.resolve_attn_impl(attn_impl)
    if impl == "sfc":
        return _ab.decode_attention(q, k, v, valid)
    if impl in _ab.ATTN_IMPLS:
        return decode_attention(q, k, v, valid)
    raise ValueError(f"unknown attn_impl {impl!r}; pick from {_ab.ATTN_IMPLS}")


class Attention(nn.Module):
    """Projection weights (in, out) plus optional qkv biases and per-head
    q/k RMS norms (Qwen3)."""

    def __init__(
        self,
        *,
        d_model: int,
        n_heads: int,
        kv_heads: int,
        head_dim: Optional[int] = None,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        dtype,
        device,
    ):
        super().__init__()
        hd = head_dim or d_model // n_heads
        kw = dict(dtype=dtype, device=device)
        self.wq = param((d_model, n_heads * hd), **kw)
        self.wk = param((d_model, kv_heads * hd), **kw)
        self.wv = param((d_model, kv_heads * hd), **kw)
        self.wo = param((n_heads * hd, d_model), **kw)
        for name, width in (("bq", n_heads * hd), ("bk", kv_heads * hd), ("bv", kv_heads * hd)):
            self.register_parameter(name, param((width,), **kw) if qkv_bias else None)
        self.q_norm = RMSNorm(hd, **kw) if qk_norm else None
        self.k_norm = RMSNorm(hd, **kw) if qk_norm else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()
        for norm in (self.q_norm, self.k_norm):
            if norm is not None:
                norm.init()


def _project_qkv(p: Attention, x: torch.Tensor, *, n_heads: int, kv_heads: int):
    b, s, _ = x.shape
    q = _bmm(x, p.wq)
    k = _bmm(x, p.wk)
    v = _bmm(x, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    hd = q.shape[-1] // n_heads
    q = q.reshape(b, s, n_heads, hd)
    k = k.reshape(b, s, kv_heads, hd)
    v = v.reshape(b, s, kv_heads, hd)
    if p.q_norm is not None:  # per-head RMS (Qwen3)
        q = rmsnorm(q, p.q_norm.scale)
        k = rmsnorm(k, p.k_norm.scale)
    return q, k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _rope_qk(q, k, positions, *, rope_theta, rotary_pct, mrope_sections, mrope_positions):
    """q and k rotated at ``positions`` (M-RoPE: at ``mrope_positions``
    where given); unchanged at ``rotary_pct`` 0."""
    if rotary_pct <= 0:
        return q, k
    kw = dict(theta=rope_theta, rotary_pct=rotary_pct, mrope_sections=mrope_sections,
              mrope_positions=mrope_positions)
    return apply_rope(q, positions, **kw), apply_rope(k, positions, **kw)


def attention_forward(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    kv_heads: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10000.0,
    rotary_pct: float = 1.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
    causal: bool = True,
    q_chunk: int = 512,
    k_chunk: int = 512,
    attn_impl: str = "blockwise",
) -> torch.Tensor:
    """Self-attention for training / prefill (no cache returned)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads=n_heads, kv_heads=kv_heads)
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k = _rope_qk(q, k, positions, rope_theta=rope_theta, rotary_pct=rotary_pct,
                    mrope_sections=mrope_sections, mrope_positions=mrope_positions)
    o = _attend(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk, attn_impl=attn_impl)
    return _bmm(o.reshape(b, s, -1), p.wo)


def attention_prefill(
    p: Attention,
    x: torch.Tensor,
    *,
    n_heads: int,
    kv_heads: int,
    cache_len: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10000.0,
    rotary_pct: float = 1.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
    q_chunk: int = 512,
    k_chunk: int = 512,
    attn_impl: str = "blockwise",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns the output and a KV cache right-padded to cache_len."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    q, k, v = _project_qkv(p, x, n_heads=n_heads, kv_heads=kv_heads)
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k = _rope_qk(q, k, positions, rope_theta=rope_theta, rotary_pct=rotary_pct,
                    mrope_sections=mrope_sections, mrope_positions=mrope_positions)
    o = _attend(q, k, v, causal=True, q_chunk=q_chunk, k_chunk=k_chunk, attn_impl=attn_impl)
    pad = cache_len - s
    cache = {
        "k": F.pad(k, (0, 0, 0, 0, 0, pad)),
        "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
    }
    return _bmm(o.reshape(b, s, -1), p.wo), cache


def attention_decode(
    p: Attention,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],  # k/v (B, T, Hkv, D)
    index: int,  # current length, shared by the batch
    *,
    n_heads: int,
    kv_heads: int,
    rope_theta: float = 10000.0,
    rotary_pct: float = 1.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, 1)
    attn_impl: str = "blockwise",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the KV cache.  The new k/v are written into
    ``cache`` in place (the JAX package returns a new cache; in place saves
    a copy of the whole cache per step) and the same dict is returned.
    The token's position is ``index`` on every M-RoPE axis unless
    ``mrope_positions`` (3, B, 1) names them, as in the JAX package."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads=n_heads, kv_heads=kv_heads)
    positions = torch.full((b, 1), index, device=x.device)
    q, k = _rope_qk(q, k, positions, rope_theta=rope_theta, rotary_pct=rotary_pct,
                    mrope_sections=mrope_sections, mrope_positions=mrope_positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, index] = k[:, 0].to(ck.dtype)
    cv[:, index] = v[:, 0].to(cv.dtype)
    valid = torch.full((b,), index + 1, dtype=torch.int32, device=x.device)
    o = _attend_cached(q, ck, cv, valid, attn_impl=attn_impl)
    return _bmm(o.reshape(b, 1, -1), p.wo), cache


# ---------------------------------------------------------------------------
# cross-attention (enc-dec; the seamless-m4t decoder)
# ---------------------------------------------------------------------------


def cross_attention_forward(
    p: Attention,
    x: torch.Tensor,  # (B, S_dec, d) decoder side
    memory: torch.Tensor,  # (B, S_enc, d) encoder output
    *,
    n_heads: int,
    kv_heads: int,
    q_chunk: int = 512,
    k_chunk: int = 512,
    attn_impl: str = "blockwise",
) -> torch.Tensor:
    """Attention of the decoder's rows over the encoder memory: no mask, no
    rotary embedding, no qkv bias (as in the JAX package); the projections
    through the GEMM backend."""
    b, s, _ = x.shape
    t = memory.shape[1]
    q = _bmm(x, p.wq).reshape(b, s, n_heads, -1)
    k = _bmm(memory, p.wk).reshape(b, t, kv_heads, -1)
    v = _bmm(memory, p.wv).reshape(b, t, kv_heads, -1)
    if p.q_norm is not None:
        q = rmsnorm(q, p.q_norm.scale)
        k = rmsnorm(k, p.k_norm.scale)
    o = _attend(q, k, v, causal=False, q_chunk=q_chunk, k_chunk=k_chunk, attn_impl=attn_impl)
    return _bmm(o.reshape(b, s, -1), p.wo)


def cross_attention_decode(
    p: Attention,
    x: torch.Tensor,  # (B, 1, d)
    mem_kv: Dict[str, torch.Tensor],  # `precompute_cross_kv` of the encoder memory
    mem_len: int,
    *,
    n_heads: int,
    kv_heads: int,
    attn_impl: str = "blockwise",
) -> torch.Tensor:
    """One decoder token over the precomputed memory k/v, the first
    ``mem_len`` rows of each valid."""
    del kv_heads  # the memory's k/v carry their heads
    b = x.shape[0]
    q = _bmm(x, p.wq).reshape(b, 1, n_heads, -1)
    if p.q_norm is not None:
        q = rmsnorm(q, p.q_norm.scale)
    valid = torch.full((b,), int(mem_len), dtype=torch.int32, device=x.device)
    o = _attend_cached(q, mem_kv["k"], mem_kv["v"], valid, attn_impl=attn_impl)
    return _bmm(o.reshape(b, 1, -1), p.wo)


def precompute_cross_kv(p: Attention, memory: torch.Tensor, *, kv_heads: int) -> Dict[str, torch.Tensor]:
    """The memory's k and v (B, S_enc, Hkv, D) that each decode step reads."""
    b, t, _ = memory.shape
    k = _bmm(memory, p.wk).reshape(b, t, kv_heads, -1)
    v = _bmm(memory, p.wv).reshape(b, t, kv_heads, -1)
    if p.k_norm is not None:
        k = rmsnorm(k, p.k_norm.scale)
    return {"k": k, "v": v}
