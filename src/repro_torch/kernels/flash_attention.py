"""Dense-grid causal flash forward: the CUDA port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas`` (K15) behind its
``flash_attention`` wrapper, beside its plain PyTorch version.

The TPU kernel walks every (q chunk, k chunk) pair of a dense grid in
ascending k order and skips the compute of chunks above the causal
diagonal; it stores no logsumexp.  On the card this is the flash-forward
kernel of ``csrc/sfc_attention.cu`` in its dense mode: each q row's k
tiles are uploaded in ascending order (the tiles the TPU kernel computes,
without the skipped ones) and no lse is stored.  GQA is resolved by the
kernel's head map (q head h reads kv head ``h // groups``) instead of
expanding K and V, and the (B, S, H, D) layout is kept.  A bf16 call whose
operands TMA can describe takes ``flash_fwd_wgmma_kernel`` (W q heads of
one kv head a CTA, sharing each k / v tile), every other call
``flash_fwd_kernel`` (`sfc_attention.launch_flash_fwd`).  A CPU tensor goes
to `flash_attention_plain`; a CUDA tensor launches a kernel or raises.
The wrapper is a `kernels.entry.kernel_entry`.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import List

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.entry import kernel_entry
from repro_torch.kernels.sfc_attention import NEG, check_fwd_shapes, launch_flash_fwd, pad_seq, require_no_grad

__all__ = ["flash_attention", "flash_attention_plain"]


def _k_tiles(nq: int, nk: int, q_chunk: int, k_chunk: int, causal: bool) -> List[List[int]]:
    """Per q chunk, the k chunks the TPU kernel computes, ascending: all of
    them, or under ``causal`` those whose first position is at most the q
    chunk's last (the kernel's ``needed`` predicate)."""
    return [
        [ki for ki in range(nk) if not causal or ki * k_chunk <= qi * q_chunk + q_chunk - 1]
        for qi in range(nq)
    ]


def flash_attention_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 128,
    k_chunk: int = 128,
) -> torch.Tensor:
    """The plain version of the dense-grid kernel, on any device: chunks
    clipped to the sequences (``min(chunk, S)``) as the TPU wrapper clips
    them, zero padding to chunk multiples, ascending k chunks per q chunk
    with `_flash_kernel`'s f32 online softmax (masks ``kpos < T`` and,
    under ``causal``, ``kpos <= qpos``)."""
    check_fwd_shapes(q, k, v, None, None, 0)
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    qc, kc = min(q_chunk, s), min(k_chunk, t)
    nq, nk = math.ceil(s / qc), math.ceil(t / kc)
    heads = torch.arange(h, device=q.device) // (h // hkv)
    qp = pad_seq(q, nq * qc).float().transpose(1, 2) * (1.0 / math.sqrt(d))  # (B, H, Sp, D)
    kp = pad_seq(k, nk * kc).float()[:, :, heads].transpose(1, 2)
    vp = pad_seq(v, nk * kc).float()[:, :, heads].transpose(1, 2)
    o = torch.empty((b, h, nq * qc, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(qc, device=q.device)[:, None]
    cols = torch.arange(kc, device=q.device)[None, :]
    for qi, tiles in enumerate(_k_tiles(nq, nk, qc, kc, causal)):
        acc = torch.zeros((b, h, qc, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, qc, 1), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        qs = slice(qi * qc, (qi + 1) * qc)
        for ki in tiles:
            ks = slice(ki * kc, (ki + 1) * kc)
            sc = qp[:, :, qs] @ kp[:, :, ks].transpose(-1, -2)
            qpos, kpos = qi * qc + rows, ki * kc + cols
            valid = kpos < t
            if causal:
                valid = valid & (kpos <= qpos)
            sc = torch.where(valid, sc, torch.full_like(sc, NEG))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            acc = acc * alpha + p @ vp[:, :, ks]
            m = m_new
            l = l * alpha + p.sum(dim=-1, keepdim=True)
        o[:, :, qs] = acc / torch.clamp_min(l, 1e-30)
    return o[:, :, :s].transpose(1, 2).to(q.dtype)


@functools.lru_cache(maxsize=256)
def _device_dense(nq: int, nk: int, causal: bool, device: torch.device):
    """(k tile per task, row starts) of the ascending dense table over the
    kernel's tile, int32, uploaded once per shape."""
    qc, kc = build.ATTN_TILE
    tiles = _k_tiles(nq, nk, qc, kc, causal)
    tab_k = np.asarray([ki for row in tiles for ki in row], np.int32)
    row_start = np.concatenate([[0], np.cumsum([len(row) for row in tiles])]).astype(np.int32)
    return torch.from_numpy(tab_k).to(device), torch.from_numpy(row_start).to(device)


@kernel_entry
def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool = True,
    q_chunk: int = 128,
    k_chunk: int = 128,
) -> torch.Tensor:
    """Dense-grid flash attention in the (B, S, H, D) layout, forward only.

    On a CPU tensor it runs `flash_attention_plain` with the given chunks.
    On a CUDA tensor it launches the kernel, whose chunks are its compiled
    tile (``build.ATTN_TILE``; the chunk arguments are the TPU's VMEM
    blocks and do not apply), and adds one to ``flash_attention.launches``
    and to ``launches_by_kernel[(kernel, W)]`` (the tile kernel's W: 1).
    Inputs that need a gradient raise.
    """
    require_no_grad("flash_attention", q, k, v)
    check_fwd_shapes(q, k, v, None, None, 0)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    qc, kc = build.ATTN_TILE
    tab_k, row_start = _device_dense(math.ceil(q.shape[1] / qc), math.ceil(k.shape[1] / kc), bool(causal),
                                     q.device)
    o, _, key = launch_flash_fwd(q, k, v, tab_k, row_start, causal=causal, seq_q=q.shape[1], seq_k=k.shape[1],
                                 q_offset=0, want_lse=False)
    if key is not None:
        flash_attention.launches += 1
        flash_attention.launches_by_kernel[key] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_kernel = collections.Counter()
