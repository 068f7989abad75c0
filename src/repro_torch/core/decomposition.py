"""The paper's blockwise split of the SFC index space over workers (§II-D,
Listing 1 lines 11-14): the part of ``repro.core.decomposition`` that the
port's persistent GEMM kernels use.

Each of T workers takes one contiguous, balanced range of the curve's
tasks, as ``#pragma omp parallel for`` static scheduling does.  On the H100
the workers are the wgmma kernels' persistent CTA clusters
(``kernels/csrc/sfc_gemm_wgmma.cuh``: ``segment`` computes the same ranges
on the device from (tasks, workers)), so consecutive tiles of one worker
share A or B panels in L2.  The worker patches, the implied worker grid and
the words-moved model of the JAX module wait for the distributed slice.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["partition_curve"]


def _block_ranges(n_items: int, n_workers: int) -> List[Tuple[int, int]]:
    """Blockwise (contiguous, balanced) split of [0, n_items) into n_workers
    ranges: the first ``n_items % n_workers`` ranges hold one item more."""
    base, rem = divmod(n_items, n_workers)
    ranges = []
    start = 0
    for w in range(n_workers):
        size = base + (1 if w < rem else 0)
        ranges.append((start, start + size))
        start += size
    return ranges


def partition_curve(mb: int, nb: int, n_workers: int) -> List[Tuple[int, int]]:
    """Blockwise partition of the 1-D SFC index space of an mb x nb grid."""
    return _block_ranges(mb * nb, n_workers)
