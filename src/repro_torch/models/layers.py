"""Foundational layers in plain torch (the port's ``repro.models.layers``).

Conventions, as in the JAX package: weights are stored ``(in, out)`` so a
projection is ``x @ w`` and the GEMM kernel receives (K, N); compute follows
the input's type; norms, rope angles and softmax statistics run in f32.
Modules hold parameters; the math is in plain functions on tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.gemm_backend import glu_matmul as _bglu, matmul as _bmm

__all__ = [
    "param",
    "normal_",
    "rmsnorm",
    "layernorm",
    "RMSNorm",
    "LayerNorm",
    "make_norm",
    "rope_frequencies",
    "rope_angles",
    "apply_rope",
    "blockwise_attention",
    "decode_attention",
    "MLP",
    "cross_entropy_loss",
]


def param(shape, *, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; `normal_` or a module's ``init`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator, scale: float = 0.02) -> None:
    """normal(0, 1) x scale drawn in f32 from ``generator``, cast to the
    parameter's type (the JAX package's ``dense_init``/``embed_init``)."""
    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
    p.copy_(draw.mul_(scale))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype, device):
        super().__init__()
        self.scale = param((dim,), dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, dtype, device):
        super().__init__()
        self.scale = param((dim,), dtype=dtype, device=device)
        self.bias = param((dim,), dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias)


def make_norm(kind: str):
    """The norm module class a config's ``norm`` names."""
    if kind == "rmsnorm":
        return RMSNorm
    if kind == "layernorm":
        return LayerNorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary position embeddings (standard / partial / M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (..., S) -> f32 angles (..., S, head_dim/2)."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    return positions[..., None].float() * inv


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) token positions
    *,
    theta: float = 10000.0,
    rotary_pct: float = 1.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S) for M-RoPE
) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved), f32 angles.
    ``rotary_pct < 1`` rotates only the leading fraction of head_dim
    (StableLM).  ``mrope_sections`` splits the rotary half-dims into (t, h,
    w) sections, each driven by its own axis of ``mrope_positions``
    (Qwen2-VL M-RoPE); without them every axis carries ``positions``, which
    is plain RoPE."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if mrope_sections is not None:
        if mrope_positions is None:
            # text tokens carry identical (t, h, w) positions
            mrope_positions = positions[None].expand(len(mrope_sections), *positions.shape)
        # angles per axis, then each axis's section of the frequencies, in order
        bounds = [sum(mrope_sections[:i]) for i in range(len(mrope_sections) + 1)]
        ang = torch.cat([rope_angles(mrope_positions[i], rot, theta)[..., bounds[i]:bounds[i + 1]]
                         for i in range(len(mrope_sections))], dim=-1)
    else:
        ang = rope_angles(positions, rot, theta)  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention — plain torch online softmax
# ---------------------------------------------------------------------------

_NEG = -1e30


def _attend_block(q, k, v, mask, scale):
    """q (B,H,qc,D), k/v (B,H,kc,D), additive f32 mask (qc, kc)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + mask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o.float(), m, l


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool = True,
    q_chunk: int = 512,
    k_chunk: int = 512,
    q_offset: int = 0,  # absolute position of q[0] (for caches)
) -> torch.Tensor:
    """Memory-bounded attention with the JAX package's online softmax.

    GQA: Hkv divides H; kv heads are repeated per group.  Only the (q, k)
    chunk pairs that meet the causal band are visited, and each pair's
    (o, m, l) merges into its q chunk's running statistics; masked scores
    are -1e30 and the final division guards l with max(l, 1e-30).
    """
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{hkv} kv heads do not divide {h} heads")
    groups = h // hkv
    scale = 1.0 / math.sqrt(d)

    q_chunk = min(q_chunk, s)
    k_chunk = min(k_chunk, t)
    nq = (s + q_chunk - 1) // q_chunk
    nk = (t + k_chunk - 1) // k_chunk
    sp, tp = nq * q_chunk, nk * k_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, sp - s)).transpose(1, 2)  # (B,H,S,D)
    kp = F.pad(k, (0, 0, 0, 0, 0, tp - t)).repeat_interleave(groups, dim=2).transpose(1, 2)
    vp = F.pad(v, (0, 0, 0, 0, 0, tp - t)).repeat_interleave(groups, dim=2).transpose(1, 2)

    q_pos = q_offset + torch.arange(sp, device=q.device)
    k_pos = torch.arange(tp, device=q.device)
    pairs = [
        (qi, ki)
        for qi in range(nq)
        for ki in range(nk)
        if not causal or ki * k_chunk <= q_offset + qi * q_chunk + q_chunk - 1
    ]

    # per-chunk running statistics in lists (no in-place writes), so that
    # autograd can differentiate the loop
    o_acc = [torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=q.device)] * nq
    m_acc = [torch.full((b, h, q_chunk), _NEG, dtype=torch.float32, device=q.device)] * nq
    l_acc = [torch.zeros((b, h, q_chunk), dtype=torch.float32, device=q.device)] * nq
    for qi, ki in pairs:
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        ks = slice(ki * k_chunk, (ki + 1) * k_chunk)
        kpos, qpos = k_pos[ks], q_pos[qs]
        valid = (kpos[None, :] < t).expand(q_chunk, k_chunk)
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        mask = torch.where(valid, 0.0, _NEG).float()
        o, m, l = _attend_block(qp[:, :, qs], kp[:, :, ks], vp[:, :, ks], mask, scale)
        m_new = torch.maximum(m_acc[qi], m)
        c1 = torch.exp(m_acc[qi] - m_new)
        c2 = torch.exp(m - m_new)
        o_acc[qi] = o_acc[qi] * c1[..., None] + o * c2[..., None]
        l_acc[qi] = l_acc[qi] * c1 + l * c2
        m_acc[qi] = m_new
    chunks = torch.stack(o_acc) / torch.clamp(torch.stack(l_acc)[..., None], min=1e-30)
    out = chunks.to(q.dtype).permute(1, 2, 0, 3, 4).reshape(b, h, sp, d)[:, :, :s]
    return out.transpose(1, 2)  # (B, S, H, D)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)  (cache)
    v: torch.Tensor,  # (B, T, Hkv, D)
    valid_len: torch.Tensor,  # (B,) number of valid cache entries
) -> torch.Tensor:
    """Single-token attention against a KV cache."""
    b, _, h, d = q.shape
    _, t, hkv, _ = k.shape
    groups = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, 1, hkv, groups, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.arange(t, device=q.device)[None, :] < valid_len[:, None]  # (B, T)
    s = torch.where(mask[:, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Gated (SwiGLU-style) or plain MLP; weights (in, out)."""

    def __init__(self, d_model: int, d_ff: int, *, gated: bool = True, act: str = "silu", dtype, device):
        super().__init__()
        self.act = act
        self.w_in = param((d_model, d_ff), dtype=dtype, device=device)
        self.w_out = param((d_ff, d_model), dtype=dtype, device=device)
        if gated:
            self.w_gate = param((d_model, d_ff), dtype=dtype, device=device)
        else:
            self.register_parameter("w_gate", None)

    def init(self, generator: torch.Generator) -> None:
        for p in (self.w_in, self.w_out, self.w_gate):
            if p is not None:
                normal_(p, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a gated MLP is one dual-B GLU projection: under sfc_cuda the
        # kernel traverses x once and the activation never leaves the flush
        if self.w_gate is not None:
            h = _bglu(x, self.w_gate, self.w_in, activation=self.act)
        else:
            h = _bmm(x, self.w_in, activation=self.act)
        return _bmm(h, self.w_out)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S)
    *,
    ignore_id: int = -1,
) -> torch.Tensor:
    """Mean next-token cross entropy in f32 over the labels that are not
    ``ignore_id``: an f32 logsumexp minus the picked logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # an ignored label picks any column; the mask zeroes its term
    picked = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)
