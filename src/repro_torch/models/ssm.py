"""Mamba2 (SSD) block: the chunked scan of a prefill and the recurrent
decode (the port's ``repro.models.ssm``).

The State-Space Dual form is a chunked linear attention with a per-head
scalar decay: within a chunk a masked quadratic product, between chunks a
state carried through a Python loop (the JAX package's ``lax.scan``), so
memory grows with S x L for chunk L, not S².  The two intra-chunk products
go through `core.gemm_backend.chunk_einsum`, which runs them on the SFC
fused kernel (K2) under "sfc_cuda": the scores ``C·Bᵀ`` in its f32-output
mode, the output ``w·x`` in the input type.  Decode is the O(1)-a-token
recurrence on the (B, H, N, P) state.

``in_proj`` and ``out_proj`` are plain ``torch.matmul``, as the JAX package
computes them with ``@`` outside any kernel; so is every other einsum here.
The depthwise causal conv sums its four taps one by one in the input type,
as the JAX package does (no ``conv1d``: cuDNN would sum in another order,
in TF32 by default); ``softplus`` is ``logaddexp(x, 0)``, JAX's formula.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.gemm_backend import chunk_einsum
from repro_torch.models.layers import normal_, param, rmsnorm

__all__ = [
    "CONV_WIDTH",
    "F32_PARAMS",
    "Mamba2",
    "softplus",
    "ssd_chunked",
    "ssd_decode_step",
    "mamba2_forward",
    "mamba2_decode",
]

CONV_WIDTH = 4
# the mixer's parameters the JAX package keeps in f32 whatever the model's type
F32_PARAMS = ("A_log", "D", "dt_bias")


class Mamba2(nn.Module):
    """The Mamba2 mixer's parameters, named as the JAX package's
    ``mamba2_init`` tree: ``in_proj`` (d_model, 2 d_inner + 2 G N + H),
    ``conv_w`` (4, conv_dim), ``conv_b``, ``A_log`` / ``D`` / ``dt_bias``
    (H,) in f32, ``norm_scale`` (d_inner,), ``out_proj`` (d_inner,
    d_model)."""

    def __init__(self, *, d_model: int, d_state: int = 64, head_dim: int = 64, expand: int = 2, n_groups: int = 1,
                 dtype, device):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        conv_dim = d_inner + 2 * n_groups * d_state
        d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = param((d_model, d_in_proj), **kw)
        self.conv_w = param((CONV_WIDTH, conv_dim), **kw)
        self.conv_b = param((conv_dim,), **kw)
        self.A_log = param((n_heads,), **f32)
        self.D = param((n_heads,), **f32)
        self.dt_bias = param((n_heads,), **f32)
        self.norm_scale = param((d_inner,), **kw)
        self.out_proj = param((d_inner, d_model), **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX package's ``mamba2_init`` rule with torch draws: normal x
        0.02 projections and conv taps, zero conv bias, ``A_log`` the log of
        1..16 spread over the heads, ``D`` ones, ``dt_bias`` the inverse
        softplus of a step drawn log-uniform in [0.001, 0.1], norm ones."""
        normal_(self.in_proj, generator)
        normal_(self.conv_w, generator)
        self.conv_b.zero_()
        h = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, device=self.A_log.device)))
        self.D.fill_(1.0)
        u = torch.rand((h,), generator=generator, device=self.dt_bias.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.norm_scale.fill_(1.0)
        normal_(self.out_proj, generator)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's own
    returns x past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C): tap i sees
    the input W - 1 - i steps back; the taps summed in order, then silu."""
    s = x.shape[1]
    out = 0
    for i in range(CONV_WIDTH):
        out = out + F.pad(x, (0, 0, CONV_WIDTH - 1 - i, 0))[:, :s, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)   dt-scaled inputs
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    log_a: torch.Tensor,  # (B, S, H)   per-step log decay (<= 0)
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    return_state: bool = False,
):
    """y_t = C_t · h_t with h_t = a_t h_{t-1} + B_t ⊗ x_t (per head), in
    chunks of ``min(chunk, S)`` steps, the last one zero-padded.  Returns y
    (B, S, H, P) in f32, and with ``return_state`` the final (B, H, N, P)
    f32 state too."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    L = min(chunk, s)
    nc = (s + L - 1) // L
    sp = nc * L
    pad = sp - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))

    xc = x.reshape(bsz, nc, L, h, p)
    bc = b_mat.reshape(bsz, nc, L, n)
    cc = c_mat.reshape(bsz, nc, L, n)
    la = log_a.reshape(bsz, nc, L, h).float()
    cum = torch.cumsum(la, dim=2)  # inclusive (B, NC, L, H)

    # intra-chunk: the masked quadratic with decay
    scores = chunk_einsum("bcin,bcjn->bcij", cc, bc, preferred_element_type=torch.float32)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, i, j, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # exp of -inf above the diagonal: the same weights as JAX's
    # where(mask, exp(decay), 0), whose gradient is NaN wherever the masked
    # decay overflows exp (at full width, 256-step chunks)
    w = torch.exp(decay.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    w = w * scores[..., None]  # (B, NC, i, j, H)
    y_intra = chunk_einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xc)

    # each chunk's own state: its inputs decayed to the chunk's end
    last = cum[:, :, -1:, :]  # (B, NC, 1, H)
    state_w = torch.exp(last - cum)
    s_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc.float(), state_w, xc.float())  # (B, NC, H, N, P)

    s_prev = (initial_state.float() if initial_state is not None
              else torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device))
    y_inter = []
    for c in range(nc):
        yc = torch.einsum("bin,bhnp->bihp", cc[:, c].float(), s_prev)
        y_inter.append(yc * torch.exp(cum[:, c])[..., None])
        s_prev = torch.exp(last[:, c, 0, :, None, None]) * s_prev + s_chunk[:, c]
    y = (y_intra.float() + torch.stack(y_inter, dim=1)).reshape(bsz, sp, h, p)[:, :s]
    if return_state:
        return y, s_prev
    return y


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, N, P)
    x: torch.Tensor,  # (B, H, P)
    b_vec: torch.Tensor,  # (B, N)
    c_vec: torch.Tensor,  # (B, N)
    log_a: torch.Tensor,  # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: (the new f32 state, y (B, H, P) f32)."""
    a = torch.exp(log_a.float())[:, :, None, None]
    upd = torch.einsum("bn,bhp->bhnp", b_vec.float(), x.float())
    s_new = a * state + upd
    y = torch.einsum("bn,bhnp->bhp", c_vec.float(), s_new)
    return s_new, y


def _split_proj(z_xbcdt: torch.Tensor, d_inner: int, gn: int, n_heads: int):
    z = z_xbcdt[..., :d_inner]
    xbc = z_xbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt = z_xbcdt[..., 2 * d_inner + 2 * gn:]
    if dt.shape[-1] != n_heads:
        raise ValueError(f"in_proj holds {dt.shape[-1]} dt columns, the mixer has {n_heads} heads")
    return z, xbc, dt


def _gated_out(mixer: Mamba2, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """rmsnorm(y · silu(z)) @ out_proj, y cast to the model's type first."""
    y = rmsnorm(y.to(dtype) * F.silu(z), mixer.norm_scale)
    return torch.matmul(y, mixer.out_proj)


def mamba2_forward(
    mixer: Mamba2,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    d_state: int = 64,
    head_dim: int = 64,
    n_groups: int = 1,
    chunk: int = 64,
    initial_state: Optional[Dict[str, torch.Tensor]] = None,
    return_state: bool = False,
):
    """The whole Mamba2 mixer over a sequence.  With ``return_state`` also
    ``{"ssm": (B, H, N, P) f32, "conv": (B, W - 1, conv_dim)}``, the state a
    decode continues from; ``initial_state`` continues from one."""
    bsz, s, _ = x.shape
    d_inner = mixer.norm_scale.shape[0]
    n_heads = mixer.A_log.shape[0]
    gn = n_groups * d_state

    proj = torch.matmul(x, mixer.in_proj)
    z, xbc, dt_raw = _split_proj(proj, d_inner, gn, n_heads)

    if initial_state is None:
        xbc_conv = _causal_conv(xbc, mixer.conv_w, mixer.conv_b)
        ext = torch.cat([torch.zeros_like(xbc[:, :1]).repeat(1, CONV_WIDTH - 1, 1), xbc], dim=1)
    else:
        ext = torch.cat([initial_state["conv"].to(xbc.dtype), xbc], dim=1)
        xbc_conv = _causal_conv(ext, mixer.conv_w, mixer.conv_b)[:, CONV_WIDTH - 1:]
    conv_tail = ext[:, -(CONV_WIDTH - 1):]

    xs = xbc_conv[..., :d_inner].reshape(bsz, s, n_heads, head_dim)
    b_mat = xbc_conv[..., d_inner:d_inner + gn]
    c_mat = xbc_conv[..., d_inner + gn:]

    dt = softplus(dt_raw.float() + mixer.dt_bias)  # (B, S, H)
    log_a = -torch.exp(mixer.A_log)[None, None, :] * dt
    x_scaled = xs * dt[..., None].to(xs.dtype)

    y = ssd_chunked(
        x_scaled, b_mat, c_mat, log_a, chunk=chunk,
        initial_state=None if initial_state is None else initial_state["ssm"],
        return_state=return_state,
    )
    if return_state:
        y, s_fin = y
    y = y + mixer.D[None, None, :, None] * xs.float()
    out = _gated_out(mixer, y.reshape(bsz, s, d_inner), z, x.dtype)
    if return_state:
        return out, {"ssm": s_fin, "conv": conv_tail.to(x.dtype)}
    return out


def mamba2_decode(
    mixer: Mamba2,
    x: torch.Tensor,  # (B, 1, d_model)
    state: Dict[str, torch.Tensor],  # {"ssm": (B, H, N, P), "conv": (B, W - 1, conv_dim)}
    *,
    d_state: int = 64,
    head_dim: int = 64,
    n_groups: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through the mixer: (out (B, 1, d_model), the new state)."""
    bsz = x.shape[0]
    d_inner = mixer.norm_scale.shape[0]
    n_heads = mixer.A_log.shape[0]
    gn = n_groups * d_state

    proj = torch.matmul(x[:, 0], mixer.in_proj)  # (B, proj)
    z, xbc, dt_raw = _split_proj(proj, d_inner, gn, n_heads)

    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, mixer.conv_w) + mixer.conv_b)
    new_conv = window[:, 1:]

    xs = conv_out[..., :d_inner].reshape(bsz, n_heads, head_dim)
    b_vec = conv_out[..., d_inner:d_inner + gn]
    c_vec = conv_out[..., d_inner + gn:]

    dt = softplus(dt_raw.float() + mixer.dt_bias)  # (B, H)
    log_a = -torch.exp(mixer.A_log)[None, :] * dt
    s_new, y = ssd_decode_step(state["ssm"], xs * dt[..., None].to(xs.dtype), b_vec, c_vec, log_a)
    y = y + mixer.D[None, :, None] * xs.float()
    out = _gated_out(mixer, y.reshape(bsz, d_inner), z, x.dtype)[:, None, :]
    return out, {"ssm": s_new, "conv": new_conv}
