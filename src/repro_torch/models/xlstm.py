"""xLSTM blocks: mLSTM (matrix memory, chunked parallel form) and sLSTM
(scalar memory, sequential recurrence), for xlstm-1.3b (the port's
``repro.models.xlstm``).

The mLSTM uses exponential input gates with the max-stabilizer; the
chunked form carries (C, n, m) from chunk to chunk through a Python loop
(the JAX package's ``lax.scan``), so a prefill holds S x L weights for
chunk L, while decode is the O(1)-a-token recurrence.  Its two intra-chunk
products go through `core.gemm_backend.chunk_einsum`, which runs them on
the SFC fused kernel (K2) under "sfc_cuda": the scores ``q·kᵀ`` bf16 in,
f32 out (K2's f32-output mode), the output ``att·v`` in f32 on the tile
kernel.  Every other product (the inter-chunk terms, the decode step, the
sLSTM recurrence) is ``torch.einsum``, and every projection a plain
``torch.matmul``, as the JAX package computes them with ``jnp.einsum`` and
``@`` outside any kernel.  The causal conv sums its four taps in order in
the input type (`ssm._causal_conv`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.gemm_backend import chunk_einsum
from repro_torch.models.layers import RMSNorm, normal_, param, rmsnorm
from repro_torch.models.ssm import CONV_WIDTH, _causal_conv

__all__ = [
    "MLSTMBlock",
    "SLSTMBlock",
    "mlstm_chunked",
    "mlstm_decode_step",
    "slstm_scan",
    "mlstm_block_forward",
    "mlstm_block_decode",
    "mlstm_block_init_state",
    "slstm_block_forward",
    "slstm_block_decode",
    "slstm_block_init_state",
]

_NEG = -1e30

# ---------------------------------------------------------------------------
# mLSTM core (chunked, stabilized)
# ---------------------------------------------------------------------------


def mlstm_chunked(
    q: torch.Tensor,  # (B, S, H, P)
    k: torch.Tensor,  # (B, S, H, P)
    v: torch.Tensor,  # (B, S, H, P)
    i_gate: torch.Tensor,  # (B, S, H) raw (log-space) input gate
    f_gate: torch.Tensor,  # (B, S, H) raw forget gate (log-sigmoid applied here)
    *,
    chunk: int = 64,
    initial_state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    return_state: bool = False,
):
    """Stabilized chunkwise mLSTM: C_t = f'C + i' k vᵀ, n_t = f'n + i'k,
    h_t = (q·C) / max(|q·n|, exp(-m)) with a running log-stabilizer m, in
    chunks of ``min(chunk, S)`` steps.  A ragged tail is padded as the JAX
    package pads it: q, k, v with zeros, the input gate with -1e30 (no
    input) and the forget gate with 30 (keep the state).  Returns h (B, S,
    H, P) in f32, and with ``return_state`` the final f32 (C (B, H, P, P),
    n (B, H, P), m (B, H))."""
    bsz, s, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    L = min(chunk, s)
    nc = (s + L - 1) // L
    sp = nc * L
    pad = sp - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=_NEG)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=30.0)

    qc = (q * scale).reshape(bsz, nc, L, h, p)
    kc = k.reshape(bsz, nc, L, h, p)
    vc = v.reshape(bsz, nc, L, h, p)
    ic = i_gate.reshape(bsz, nc, L, h).float()
    fc = F.logsigmoid(f_gate.reshape(bsz, nc, L, h).float())
    fcum = torch.cumsum(fc, dim=2)  # (B, NC, L, H) inclusive
    # g_i = max_{j<=i} (i_j - fcum_j): the running max of the intra stabilizer
    g = torch.cummax(ic - fcum, dim=2).values

    if initial_state is None:
        c_prev = torch.zeros((bsz, h, p, p), dtype=torch.float32, device=q.device)
        n_prev = torch.zeros((bsz, h, p), dtype=torch.float32, device=q.device)
        m_prev = torch.full((bsz, h), _NEG, dtype=torch.float32, device=q.device)
    else:
        c_prev, n_prev, m_prev = initial_state

    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        q_i, k_i, v_i, i_i, fcum_i, g_i = qc[:, c], kc[:, c], vc[:, c], ic[:, c], fcum[:, c], g[:, c]
        # the local stabilizer of each position
        m_loc = fcum_i + torch.maximum(m_prev[:, None, :], g_i)  # (B, L, H)
        # intra-chunk weights w_ij = exp(fcum_i - fcum_j + i_j - m_loc_i), j <= i
        dlog = (fcum_i[:, :, None, :] - fcum_i[:, None, :, :] + i_i[:, None, :, :]
                - m_loc[:, :, None, :])  # (B, i, j, H)
        # exp of -inf above the diagonal (JAX: where(mask, exp(dlog), 0), NaN
        # gradients where the masked dlog overflows exp; the same weights)
        w = torch.exp(dlog.masked_fill(~mask[None, :, :, None], float("-inf")))
        qk = chunk_einsum("blhp,bjhp->bljh", q_i, k_i, preferred_element_type=torch.float32)
        att = w * qk  # (B, i, j, H)
        num_intra = chunk_einsum("bljh,bjhp->blhp", att, v_i.float())
        den_intra = att.sum(dim=2)  # (B, L, H)
        # the inter-chunk part, decayed from the chunk's start
        inter_scale = torch.exp(m_prev[:, None, :] + fcum_i - m_loc)  # (B, L, H)
        num_inter = torch.einsum("blhp,bhpo->blho", q_i.float(), c_prev) * inter_scale[..., None]
        den_inter = torch.einsum("blhp,bhp->blh", q_i.float(), n_prev) * inter_scale
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_loc))[..., None])
        # the carry, stabilized at the chunk's end
        f_last = fcum_i[:, -1, :]  # (B, H)
        m_new = m_loc[:, -1, :]
        kv_w = torch.exp(f_last[:, None, :] - fcum_i + i_i - m_new[:, None, :])  # (B, L, H)
        decay = torch.exp(m_prev + f_last - m_new)
        c_prev = decay[:, :, None, None] * c_prev + torch.einsum("blh,blhp,blho->bhpo", kv_w, k_i.float(),
                                                                 v_i.float())
        n_prev = decay[:, :, None] * n_prev + torch.einsum("blh,blhp->bhp", kv_w, k_i.float())
        m_prev = m_new
    out = torch.stack(hs, dim=1).reshape(bsz, sp, h, p)[:, :s]
    if return_state:
        return out, (c_prev, n_prev, m_prev)
    return out


def mlstm_decode_step(
    state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # C (B, H, P, P), n (B, H, P), m (B, H)
    q: torch.Tensor,  # (B, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, H)
    f_gate: torch.Tensor,  # (B, H)
):
    """One step of the recurrence: (the new f32 (C, n, m), h (B, H, P) f32).
    ``fp * C`` and ``ip * k vᵀ`` are each rounded, then added, as in the
    JAX package."""
    c_prev, n_prev, m_prev = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    flog = F.logsigmoid(f_gate.float())
    ilog = i_gate.float()
    m_new = torch.maximum(flog + m_prev, ilog)
    fp = torch.exp(flog + m_prev - m_new)
    ip = torch.exp(ilog - m_new)
    c_new = fp[..., None, None] * c_prev + ip[..., None, None] * torch.einsum("bhp,bho->bhpo", k.float(), v.float())
    n_new = fp[..., None] * n_prev + ip[..., None] * k.float()
    qs = q.float() * scale
    num = torch.einsum("bhp,bhpo->bho", qs, c_new)
    den = torch.einsum("bhp,bhp->bh", qs, n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return (c_new, n_new, m_new), h


# ---------------------------------------------------------------------------
# sLSTM core (sequential)
# ---------------------------------------------------------------------------


def slstm_scan(
    gates_x: torch.Tensor,  # (B, S, H, 4, P) pre-activations from the input (z, i, f, o)
    r_kernel: torch.Tensor,  # (H, P, 4, P) per-head recurrent weights
    *,
    initial_state: Optional[Tuple[torch.Tensor, ...]] = None,
    return_state: bool = False,
    segment: int = 256,
):
    """Stabilized sLSTM: c = f'c + i'z, n = f'n + i', h = o · c / n, one
    Python loop over the steps.

    The JAX package scans segments of ``min(segment, S)`` steps under
    ``jax.checkpoint``, which changes only the backward's memory; its time
    axis is zero-padded to whole segments first, so the carry it returns
    has also run the padded steps (zero pre-activations).  This loop runs
    the same steps, the padded ones included, and returns that carry; the
    outputs are the first S steps'.  Returns h (B, S, H, P) in f32, and
    with ``return_state`` the f32 carry (c, n, m, h), each (B, H, P)."""
    bsz, s, h, _, p = gates_x.shape
    if initial_state is None:
        zeros = torch.zeros((bsz, h, p), dtype=torch.float32, device=gates_x.device)
        c, n, m, h_prev = zeros, torch.ones_like(zeros), zeros, zeros
    else:
        c, n, m, h_prev = initial_state
    seg = min(segment, s)
    sp = (s + seg - 1) // seg * seg
    gx = F.pad(gates_x.float(), (0, 0, 0, 0, 0, 0, 0, sp - s))
    r = r_kernel.float()
    hs = []
    for t in range(sp):
        rec = torch.einsum("bhp,hpgo->bhgo", h_prev, r)
        pre = gx[:, t] + rec  # (B, H, 4, P)
        z = torch.tanh(pre[:, :, 0])
        i_log = pre[:, :, 1]
        f_log = F.logsigmoid(pre[:, :, 2])
        o = torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(f_log + m, i_log)
        ip = torch.exp(i_log - m_new)
        fp = torch.exp(f_log + m - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        m = m_new
        h_prev = o * c / n.clamp_min(1e-6)
        hs.append(h_prev)
    out = torch.stack(hs[:s], dim=1)
    if return_state:
        return out, (c, n, m, h_prev)
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    """The mLSTM block's parameters, named as the JAX package's
    ``mlstm_block_init`` tree (d_inner = 2 d_model, H heads of d_inner / H):
    ``norm``, ``w_up`` (d_model, 2 d_inner: x_in and z), ``conv_w`` (4,
    d_inner), ``conv_b``, ``wq`` / ``wk`` / ``wv`` (d_inner, d_inner),
    ``w_if`` (d_inner, 2 H), ``b_if``, ``o_norm`` (the head dim),
    ``w_down`` (d_inner, d_model)."""

    def __init__(self, *, d_model: int, n_heads: int, dtype, device):
        super().__init__()
        d_inner = 2 * d_model
        kw = dict(dtype=dtype, device=device)
        self.norm = RMSNorm(d_model, **kw)
        self.w_up = param((d_model, 2 * d_inner), **kw)
        self.conv_w = param((CONV_WIDTH, d_inner), **kw)
        self.conv_b = param((d_inner,), **kw)
        self.wq = param((d_inner, d_inner), **kw)
        self.wk = param((d_inner, d_inner), **kw)
        self.wv = param((d_inner, d_inner), **kw)
        self.w_if = param((d_inner, 2 * n_heads), **kw)
        self.b_if = param((2 * n_heads,), **kw)
        self.o_norm = RMSNorm(d_inner // n_heads, **kw)
        self.w_down = param((d_inner, d_model), **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX package's rule with torch draws: normal x 0.02
        projections and conv taps (``w_if`` x 0.01), zero conv bias, input
        gate biases 0 and forget gate biases spread over [3, 6], norms 1."""
        self.norm.init()
        for w in (self.w_up, self.conv_w, self.wq, self.wk, self.wv, self.w_down):
            normal_(w, generator)
        normal_(self.w_if, generator, scale=0.01)
        self.conv_b.zero_()
        h = self.b_if.shape[0] // 2
        dev = self.b_if.device
        self.b_if.copy_(torch.cat([torch.zeros(h, device=dev), torch.linspace(3.0, 6.0, h, device=dev)]))
        self.o_norm.init()


class SLSTMBlock(nn.Module):
    """The sLSTM block's parameters, named as the JAX package's
    ``slstm_block_init`` tree: ``norm``, ``w_gates`` (d_model, 4 d_model:
    z, i, f, o), ``b_gates``, ``r_kernel`` (H, P, 4, P), ``w_out``
    (d_model, d_model)."""

    def __init__(self, *, d_model: int, n_heads: int, dtype, device):
        super().__init__()
        hd = d_model // n_heads
        kw = dict(dtype=dtype, device=device)
        self.norm = RMSNorm(d_model, **kw)
        self.w_gates = param((d_model, 4 * d_model), **kw)
        self.b_gates = param((4 * d_model,), **kw)
        self.r_kernel = param((n_heads, hd, 4, hd), **kw)
        self.w_out = param((d_model, d_model), **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX package's rule with torch draws: normal x 0.02 weights,
        gate biases 0 but the forget gate's, each head's spread over [3, 6]."""
        self.norm.init()
        for w in (self.w_gates, self.r_kernel, self.w_out):
            normal_(w, generator)
        h, hd = self.r_kernel.shape[:2]
        d = h * hd
        dev = self.b_gates.device
        forget = torch.linspace(3.0, 6.0, h, device=dev).repeat_interleave(hd)
        self.b_gates.copy_(torch.cat([torch.zeros(2 * d, device=dev), forget, torch.zeros(d, device=dev)]))


def _mlstm_block_core(block: MLSTMBlock, x: torch.Tensor, n_heads: int):
    """The shared pre-processing: (q, k, v, i, f, z, x_in)."""
    b, s, _ = x.shape
    up = torch.matmul(rmsnorm(x, block.norm.scale), block.w_up)
    d_inner = up.shape[-1] // 2
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    # causal conv (width 4) + silu on the q / k path
    x_conv = _causal_conv(x_in, block.conv_w, block.conv_b)
    hd = d_inner // n_heads
    q = torch.matmul(x_conv, block.wq).reshape(b, s, n_heads, hd)
    k = torch.matmul(x_conv, block.wk).reshape(b, s, n_heads, hd)
    v = torch.matmul(x_in, block.wv).reshape(b, s, n_heads, hd)
    if_gates = torch.matmul(x_in, block.w_if) + block.b_if
    return q, k, v, if_gates[..., :n_heads], if_gates[..., n_heads:], z, x_in


def mlstm_block_forward(
    block: MLSTMBlock,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    n_heads: int,
    chunk: int = 64,
    initial_state=None,
    return_state: bool = False,
):
    """The mLSTM block over a sequence (residual included).  With
    ``return_state`` also ``((C, n, m), conv_tail (B, W - 1, d_inner))``,
    the tail the last W - 1 raw conv inputs, zero-padded when S < W - 1.
    ``initial_state``'s (C, n, m) continues the recurrence; its conv tail
    is not read (the JAX package's conv starts from zeros)."""
    b, s, _ = x.shape
    q, k, v, i_gate, f_gate, z, x_in = _mlstm_block_core(block, x, n_heads)
    core = mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk,
                         initial_state=None if initial_state is None else initial_state[0],
                         return_state=return_state)
    if return_state:
        core, st = core
        zeros = torch.zeros((b, CONV_WIDTH - 1, x_in.shape[-1]), dtype=x_in.dtype, device=x_in.device)
        st = (st, torch.cat([zeros, x_in], dim=1)[:, -(CONV_WIDTH - 1):])
    core = rmsnorm(core.to(x.dtype), block.o_norm.scale)
    core = core.reshape(b, s, -1) * F.silu(z)
    out = x + torch.matmul(core, block.w_down)
    if return_state:
        return out, st
    return out


def mlstm_block_decode(block: MLSTMBlock, x: torch.Tensor, state, *, n_heads: int):
    """One token (B, 1, d_model) through the block; ``state`` = ((C, n, m),
    conv_tail (B, W - 1, d_inner)).  Returns (out, the new state)."""
    b = x.shape[0]
    core_state, conv_tail = state
    up = torch.matmul(rmsnorm(x, block.norm.scale)[:, 0], block.w_up)
    d_inner = up.shape[-1] // 2
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    window = torch.cat([conv_tail, x_in[:, None, :]], dim=1)
    x_conv = F.silu(torch.einsum("bwc,wc->bc", window, block.conv_w) + block.conv_b)
    hd = d_inner // n_heads
    q = torch.matmul(x_conv, block.wq).reshape(b, n_heads, hd)
    k = torch.matmul(x_conv, block.wk).reshape(b, n_heads, hd)
    v = torch.matmul(x_in, block.wv).reshape(b, n_heads, hd)
    if_g = torch.matmul(x_in, block.w_if) + block.b_if
    new_core, h_out = mlstm_decode_step(core_state, q, k, v, if_g[..., :n_heads], if_g[..., n_heads:])
    h_out = rmsnorm(h_out.to(x.dtype), block.o_norm.scale)
    h_out = h_out.reshape(b, -1) * F.silu(z)
    out = x + torch.matmul(h_out, block.w_down)[:, None, :]
    return out, (new_core, window[:, 1:])


def mlstm_block_init_state(block: MLSTMBlock, batch: int, n_heads: int, dtype):
    """The empty state of a block: ((C, n, m) in f32, conv tail in ``dtype``)."""
    d_inner = block.conv_b.shape[0]
    hd = d_inner // n_heads
    f32 = dict(dtype=torch.float32, device=block.conv_b.device)
    core = (torch.zeros((batch, n_heads, hd, hd), **f32), torch.zeros((batch, n_heads, hd), **f32),
            torch.full((batch, n_heads), _NEG, **f32))
    return core, torch.zeros((batch, CONV_WIDTH - 1, d_inner), dtype=dtype, device=block.conv_b.device)


def slstm_block_forward(
    block: SLSTMBlock,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    n_heads: int,
    initial_state=None,
    return_state: bool = False,
):
    """The sLSTM block over a sequence (residual included); with
    ``return_state`` also the carry (c, n, m, h)."""
    b, s, d = x.shape
    hd = d // n_heads
    gx = torch.matmul(rmsnorm(x, block.norm.scale), block.w_gates) + block.b_gates
    gx = gx.reshape(b, s, 4, n_heads, hd).transpose(2, 3)  # (B, S, H, 4, P)
    core = slstm_scan(gx, block.r_kernel, initial_state=initial_state, return_state=return_state)
    if return_state:
        core, st = core
    out = x + torch.matmul(core.reshape(b, s, d).to(x.dtype), block.w_out)
    if return_state:
        return out, st
    return out


def slstm_block_decode(block: SLSTMBlock, x: torch.Tensor, state, *, n_heads: int):
    """One token through the block: the forward over one step from
    ``state``, as in the JAX package.  Returns (out, the new carry)."""
    return slstm_block_forward(block, x, n_heads=n_heads, initial_state=state, return_state=True)


def slstm_block_init_state(batch: int, d_model: int, n_heads: int, *, device):
    """The empty carry (c 0, n 1, m 0, h 0), each (B, H, P) f32."""
    hd = d_model // n_heads
    zeros = torch.zeros((batch, n_heads, hd), dtype=torch.float32, device=device)
    return zeros, torch.ones_like(zeros), zeros.clone(), zeros.clone()
