"""SFC-based work decomposition (paper §II-D, Figs. 3-4): the port's copy
of ``repro.core.decomposition``.

The paper partitions the 1-D SFC index space *blockwise* over T workers and
gets, implicitly, a 2-D worker decomposition whose aspect ratio matches the
C matrix.  With ``K_layers = c > 1`` the iteration space grows to
``Mb*Nb*c`` and the same blockwise split produces the 2.5D/3D CA processor
grids.

On the H100 the workers of `partition_curve` are the wgmma kernels'
persistent CTA groups (``kernels/csrc/sfc_gemm_wgmma.cuh``: ``segment``
computes the same ranges on the device from (tasks, workers)), so
consecutive tiles of one worker share A or B panels in L2.  The worker
patches, the implied worker grid and the words-moved count feed the
performance model (`core.perf_model`); all of it is host code on numpy, and
its results equal the JAX module's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.sfc import create_sfc_map

__all__ = [
    "WorkerPatch",
    "Decomposition",
    "partition_curve",
    "sfc_decompose",
    "implied_worker_grid",
    "sfc_grid_factorization",
    "divisor_factorizations",
    "words_moved",
]


@dataclasses.dataclass(frozen=True)
class WorkerPatch:
    """Contiguous SFC range assigned to one worker within one K-layer."""

    worker: int            # global worker id
    layer: int             # K-layer (0..c-1)
    start: int             # SFC range [start, stop) within the layer
    stop: int
    cells: np.ndarray      # (n, 2) (im, in) tiles covered
    bbox: Tuple[int, int, int, int]  # im_lo, im_hi, in_lo, in_hi (hi excl)

    @property
    def n_cells(self) -> int:
        return self.stop - self.start

    @property
    def bbox_shape(self) -> Tuple[int, int]:
        return (self.bbox[1] - self.bbox[0], self.bbox[3] - self.bbox[2])

    @property
    def is_rectangle(self) -> bool:
        h, w = self.bbox_shape
        return h * w == self.n_cells

    @property
    def n_rows(self) -> int:
        """Distinct im blocks touched -> number of A panels this worker reads."""
        return len(np.unique(self.cells[:, 0]))

    @property
    def n_cols(self) -> int:
        """Distinct in blocks touched -> number of B panels this worker reads."""
        return len(np.unique(self.cells[:, 1]))


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Full SFC-CA decomposition of an Mb x Nb (x c) tile space over T workers."""

    mb: int
    nb: int
    k_layers: int
    n_workers: int
    patches: Tuple[WorkerPatch, ...]

    @property
    def workers_per_layer(self) -> int:
        return self.n_workers // self.k_layers

    def layer_patches(self, layer: int) -> List[WorkerPatch]:
        return [p for p in self.patches if p.layer == layer]

    def implied_grid(self) -> Tuple[int, int]:
        return implied_worker_grid(self)


def _block_ranges(n_items: int, n_workers: int) -> List[Tuple[int, int]]:
    """Blockwise (contiguous, balanced) split of [0, n_items) into n_workers
    ranges — the effect of ``#pragma omp parallel for`` static scheduling in
    Listing 1."""
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


def sfc_decompose(
    mb: int,
    nb: int,
    n_workers: int,
    k_layers: int = 1,
) -> Decomposition:
    """Reproduce Listing 1 lines 11-14: the Mb*Nb*K_layers task space is
    split blockwise over T workers; the first Mb*Nb tasks (layer 0) land on
    the first T/c workers, etc.; within a layer, workers get contiguous SFC
    ranges."""
    if n_workers % k_layers != 0:
        raise ValueError(
            f"T={n_workers} must be divisible by K_layers={k_layers} "
            "(each layer gets an equal worker team, paper §II-D)"
        )
    sfc = create_sfc_map(mb, nb)
    per_layer = n_workers // k_layers
    patches: List[WorkerPatch] = []
    for layer in range(k_layers):
        for j, (start, stop) in enumerate(_block_ranges(mb * nb, per_layer)):
            cells = sfc.patch(start, stop)
            if stop > start:
                bbox = sfc.patch_bbox(start, stop)
            else:
                bbox = (0, 0, 0, 0)
            patches.append(
                WorkerPatch(
                    worker=layer * per_layer + j,
                    layer=layer,
                    start=start,
                    stop=stop,
                    cells=cells,
                    bbox=bbox,
                )
            )
    return Decomposition(
        mb=mb, nb=nb, k_layers=k_layers, n_workers=n_workers, patches=tuple(patches)
    )


def implied_worker_grid(decomp: Decomposition) -> Tuple[int, int]:
    """The 2-D worker grid that the blockwise SFC partition *implies* within a
    layer (paper: "the SFC yields implicitly a 2D core decomposition").

    We recover it from geometry: count how many distinct patches the first
    tile-column of the grid intersects (grid rows, tm) and how many the first
    tile-row intersects (grid cols, tn).  For the regular cases the paper
    shows (T a product of small powers of two) this is exact; for ragged T
    it reports the dominant patch tiling.
    """
    layer0 = decomp.layer_patches(0)
    per_layer = len(layer0)
    # workers whose patch touches im == 0 (first block-row of C)
    tn = sum(1 for p in layer0 if p.n_cells and (p.cells[:, 0] == 0).any())
    # workers whose patch touches in == 0 (first block-col of C)
    tm = sum(1 for p in layer0 if p.n_cells and (p.cells[:, 1] == 0).any())
    # For exact rectangular tilings tm*tn == per_layer; otherwise snap to the
    # divisor pair of per_layer closest (in log space) to the measured ratio.
    if tm * tn == per_layer:
        return tm, tn
    target = math.log(max(tm, 1) / max(tn, 1))
    best = min(
        divisor_factorizations(per_layer),
        key=lambda f: abs(math.log(f[0] / f[1]) - target),
    )
    return best


def divisor_factorizations(t: int) -> List[Tuple[int, int]]:
    """All (tm, tn) with tm*tn == t."""
    out = []
    for tm in range(1, t + 1):
        if t % tm == 0:
            out.append((tm, t // tm))
    return out


def sfc_grid_factorization(
    n_workers: int,
    mb: int,
    nb: int,
    k_layers: int = 1,
) -> Tuple[int, int]:
    """Worker-grid factorization chosen by the SFC partition ("patch vote").

    Used by the distributed CA matmul to translate the implicit SFC
    decomposition into explicit mesh axes.  Cheap: runs the real
    decomposition for the (small) tile grid and reads off the implied grid.
    """
    per_layer = n_workers // k_layers
    if per_layer <= 0 or n_workers % k_layers:
        raise ValueError(f"bad T={n_workers}, c={k_layers}")
    cells = mb * nb
    if cells > 16384:
        # Aspect-preserving surrogate grid with ~max(16*T, 4096) cells keeps
        # the host-side curve construction O(10k) even for huge tile grids.
        target = max(16 * per_layer, 4096)
        ar = mb / nb
        snb = max(1, int(round(math.sqrt(target / ar))))
        smb = max(1, int(round(ar * snb)))
        while smb * snb < per_layer:  # always enough cells to split
            smb *= 2
            snb *= 2
        mb, nb = smb, snb
    d = sfc_decompose(mb, nb, per_layer, 1)
    return implied_worker_grid(d)


def words_moved(
    M: int,
    N: int,
    K: int,
    tm: int,
    tn: int,
    c: int,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Per-worker words (bytes) moved from slow memory on the critical path for
    a (tm x tn x c) stationary-C decomposition — paper §II-C / §II-E.

      A panels:  each worker reads an (M/tm) x (K/c) slab of A
      B panels:  each worker reads a  (K/c) x (N/tn) slab of B
      C:         read+write its (M/tm) x (N/tn) patch once; with c > 1 the
                 reduction adds (c-1)/c extra read+write traffic per worker
                 (psum over layers; low-order term per the paper).
    """
    a = (M / tm) * (K / c) * dtype_bytes
    b = (K / c) * (N / tn) * dtype_bytes
    c_patch = (M / tm) * (N / tn) * dtype_bytes
    c_traffic = 2 * c_patch + (2 * c_patch * (c - 1) / c)
    return {
        "a_bytes": a,
        "b_bytes": b,
        "c_bytes": c_traffic,
        "total_bytes": a + b + c_traffic,
    }
