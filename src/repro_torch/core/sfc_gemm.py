"""Executable reference of the paper's Listing 1 (SFC-CA GEMM) in plain torch.

Mirrors the listing's structure line for line, as ``repro.core.sfc_gemm``
does in JAX:

  * blocked tensors  A[Mb][Kb][bm][bk], B[Nb][Kb][bk][bn],
                     C[K_layers][Nb][Mb][bm][bn]            (lines 1-3)
  * a precomputed SFC map over the Mb x Nb C-tile grid      (line 5)
  * one fused task loop over Mb*Nb*K_layers items, the layer index and the
    SFC index recovered with div/mod                        (lines 11-14)
  * per task: zero_tpp + k_block_factor batch-reduce GEMMs   (lines 16-21)
  * a final add_reduce over the K_layers C copies           (lines 26-35)

The OpenMP worker dimension is a sequential Python loop: task results are
disjoint C tiles, so the semantics are the same.  This is the port's
``sfc_reference`` backend, the semantics oracle, not a fast path.
"""

from __future__ import annotations

import torch

from repro_torch.core.sfc import create_sfc_map

__all__ = ["block_a", "block_b", "unblock_c", "sfc_ca_gemm_reference"]


def block_a(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """A[M][K] -> A[Mb][Kb][bm][bk]  (paper line 1)."""
    m, k = a.shape
    return a.reshape(m // bm, bm, k // bk, bk).permute(0, 2, 1, 3)


def block_b(b: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """B[K][N] -> B[Nb][Kb][bk][bn]  (paper line 2)."""
    k, n = b.shape
    return b.reshape(k // bk, bk, n // bn, bn).permute(2, 0, 1, 3)


def unblock_c(c_blocked: torch.Tensor) -> torch.Tensor:
    """C[Nb][Mb][bm][bn] -> C[M][N]."""
    nb, mb, bm, bn = c_blocked.shape
    return c_blocked.permute(1, 2, 0, 3).reshape(mb * bm, nb * bn)


def sfc_ca_gemm_reference(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int = 32,
    bn: int = 32,
    bk: int = 32,
    k_layers: int = 1,
    k_block_factor: int = 1,
    acc_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """C = A @ B via the SFC-CA algorithm (paper Listing 1). Shapes must be
    divisible by the blocking factors and K by k_layers*k_block_factor*bk."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shape {(m, n, k)} not divisible by blocks {(bm, bn, bk)}")
    mb_cnt, nb_cnt, kb_cnt = m // bm, n // bn, k // bk
    if kb_cnt % (k_layers * k_block_factor):
        raise ValueError(
            f"Kb={kb_cnt} must divide by K_layers*k_block_factor="
            f"{k_layers * k_block_factor}"
        )

    a_blk = block_a(a.to(acc_dtype), bm, bk)  # [Mb][Kb][bm][bk]
    b_blk = block_b(b.to(acc_dtype), bk, bn)  # [Nb][Kb][bk][bn]

    sfc = create_sfc_map(mb_cnt, nb_cnt)  # line 5
    im_tab = sfc.im_table().tolist()
    in_tab = sfc.in_table().tolist()

    kb_per_layer = kb_cnt // k_layers  # line 6
    kb_per_brgemm = kb_per_layer // k_block_factor  # line 7

    n_tasks = mb_cnt * nb_cnt * k_layers
    c = torch.zeros((k_layers, nb_cnt, mb_cnt, bm, bn), dtype=acc_dtype, device=a.device)  # line 3

    for i in range(n_tasks):  # lines 11-23, one fused-loop iteration
        i_layer = i // (mb_cnt * nb_cnt)  # line 12
        i_sfc = i % (mb_cnt * nb_cnt)  # line 13
        im, in_ = im_tab[i_sfc], in_tab[i_sfc]  # line 14
        c_tile = torch.zeros((bm, bn), dtype=acc_dtype, device=a.device)  # zero_tpp (line 16)
        for ik in range(k_block_factor):
            k0 = i_layer * kb_per_layer + ik * kb_per_brgemm  # line 18
            a_panel = a_blk[im, k0:k0 + kb_per_brgemm]  # (kb, bm, bk)
            b_panel = b_blk[in_, k0:k0 + kb_per_brgemm]  # (kb, bk, bn)
            # brgemm_tpp: C += sum_i A_i x B_i over the batch-reduce dim
            c_tile += torch.einsum("kmc,kcn->mn", a_panel, b_panel)  # lines 19-21
        c[i_layer, in_, im] = c_tile

    # lines 26-35: add_reduce across the K_layers copies of C
    c_final = c.sum(dim=0) if k_layers > 1 else c[0]
    return unblock_c(c_final).to(a.dtype)
