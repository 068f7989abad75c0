"""Generalized Hilbert ("gilbert") space-filling curves for arbitrary 2D rectangles.

The paper's SFC building block (§II-B): a locality-preserving bijection
between ``[0, W*H)`` and the cells of a ``W x H`` grid, valid for arbitrary
rectangle sides.  The construction follows the recursive generalized-Hilbert
scheme of Červený (2019), which the paper cites as its SFC generator.

The curve is computed once on the host with numpy; the CUDA kernels read the
resulting coordinates from a task table in device memory.  This is the
port's own copy of ``repro.core.sfc`` (the port never imports the JAX
package), and its tables are byte-identical to that module's.
"""

from __future__ import annotations

import functools
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "gilbert2d",
    "sfc_coords",
    "sfc_index_of",
    "sfc_coord_table",
    "sfc_inverse_table",
    "SFCMap",
    "create_sfc_map",
]


def _sgn(x: int) -> int:
    return (x > 0) - (x < 0)


def _generate2d(x: int, y: int, ax: int, ay: int, bx: int, by: int) -> Iterator[Tuple[int, int]]:
    """Recursive generalized-Hilbert generator over the parallelogram spanned
    by vectors (ax, ay) and (bx, by) anchored at (x, y)."""
    w = abs(ax + ay)
    h = abs(bx + by)

    dax, day = _sgn(ax), _sgn(ay)  # unit major direction
    dbx, dby = _sgn(bx), _sgn(by)  # unit orthogonal direction

    if h == 1:
        for _ in range(w):
            yield (x, y)
            x, y = x + dax, y + day
        return

    if w == 1:
        for _ in range(h):
            yield (x, y)
            x, y = x + dbx, y + dby
        return

    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2 = abs(ax2 + ay2)
    h2 = abs(bx2 + by2)

    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            # prefer even steps
            ax2, ay2 = ax2 + dax, ay2 + day
        # long case: split in two parts only
        yield from _generate2d(x, y, ax2, ay2, bx, by)
        yield from _generate2d(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
    else:
        if (h2 % 2) and (h > 2):
            # prefer even steps
            bx2, by2 = bx2 + dbx, by2 + dby
        # standard case: one step up, one long horizontal, one step back down
        yield from _generate2d(x, y, bx2, by2, ax2, ay2)
        yield from _generate2d(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
        yield from _generate2d(
            x + (ax - dax) + (bx2 - dbx),
            y + (ay - day) + (by2 - dby),
            -bx2,
            -by2,
            -(ax - ax2),
            -(ay - ay2),
        )


def gilbert2d(width: int, height: int) -> Iterator[Tuple[int, int]]:
    """Yield (x, y) cell coordinates of a ``width x height`` grid in
    generalized-Hilbert order.  Works for arbitrary positive sides."""
    if width <= 0 or height <= 0:
        raise ValueError(f"gilbert2d needs positive sides, got {width}x{height}")
    if width >= height:
        yield from _generate2d(0, 0, width, 0, 0, height)
    else:
        yield from _generate2d(0, 0, 0, height, width, 0)


@functools.lru_cache(maxsize=512)
def sfc_coord_table(width: int, height: int) -> np.ndarray:
    """``(W*H, 2)`` int32 array: row t = (x, y) of the t-th cell on the curve.

    ``x`` indexes the width/M-block dimension (``im``), ``y`` the
    height/N-block dimension (``in``).  The array is read-only.
    """
    tab = np.fromiter(
        (c for xy in gilbert2d(width, height) for c in xy),
        dtype=np.int32,
        count=2 * width * height,
    ).reshape(width * height, 2)
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=512)
def sfc_inverse_table(width: int, height: int) -> np.ndarray:
    """``(W, H)`` int32 array: entry [x, y] = 1-D SFC index of cell (x, y)."""
    tab = sfc_coord_table(width, height)
    inv = np.empty((width, height), dtype=np.int32)
    inv[tab[:, 0], tab[:, 1]] = np.arange(width * height, dtype=np.int32)
    inv.setflags(write=False)
    return inv


def sfc_coords(width: int, height: int, index: int) -> Tuple[int, int]:
    """Map a 1-D SFC index to its (x, y) cell."""
    x, y = sfc_coord_table(width, height)[index]
    return int(x), int(y)


def sfc_index_of(width: int, height: int, x: int, y: int) -> int:
    """Map a cell (x, y) to its 1-D SFC index."""
    return int(sfc_inverse_table(width, height)[x, y])


class SFCMap:
    """The paper's ``sfc_map`` object (Listing 1, line 5): a precomputed
    bijection between the 1-D task index space and the ``Mb x Nb`` C-tile grid.
    """

    def __init__(self, mb: int, nb: int):
        self.mb = int(mb)
        self.nb = int(nb)
        self.size = self.mb * self.nb
        self._coords = sfc_coord_table(self.mb, self.nb)
        self._inverse = sfc_inverse_table(self.mb, self.nb)

    def __call__(self, i_sfc: int) -> Tuple[int, int]:
        """Listing 1 line 14: ``map_sfc_index(sfc_map, i_sfc) -> (im, in)``."""
        im, in_ = self._coords[i_sfc]
        return int(im), int(in_)

    def coords(self) -> np.ndarray:
        """(size, 2) table of (im, in) per SFC index."""
        return self._coords

    def im_table(self) -> np.ndarray:
        return self._coords[:, 0]

    def in_table(self) -> np.ndarray:
        return self._coords[:, 1]

    def index_of(self, im: int, in_: int) -> int:
        return int(self._inverse[im, in_])

    def patch(self, start: int, stop: int) -> np.ndarray:
        """Cells covered by the contiguous SFC range [start, stop)."""
        return self._coords[start:stop]

    def patch_bbox(self, start: int, stop: int) -> Tuple[int, int, int, int]:
        """Bounding box (im_lo, im_hi, in_lo, in_hi), hi exclusive."""
        p = self.patch(start, stop)
        return (
            int(p[:, 0].min()),
            int(p[:, 0].max()) + 1,
            int(p[:, 1].min()),
            int(p[:, 1].max()) + 1,
        )

    def __repr__(self) -> str:
        return f"SFCMap(mb={self.mb}, nb={self.nb})"


def create_sfc_map(mb: int, nb: int) -> SFCMap:
    """Paper Listing 1, line 5."""
    return SFCMap(mb, nb)
