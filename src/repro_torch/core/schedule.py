"""One SFC schedule compiler: a unified task-table API for every masked
tile space.

The paper's claim (§II-B, §III) is that a single locality-preserving SFC
traversal subsumes per-shape, per-operator scheduling heroics.  The repo
had drifted back into bespoke table builders — one per kernel family
(gilbert tile orders for dense GEMM, widened prefetch tables for ragged
grouped GEMM, boustrophedon causal-band tables for attention).  This
module replaces all of them with one compiler:

    spec  = ScheduleSpec(...)          # declarative: tile space + mask +
                                       # traversal-order policy
    sched = compile_schedule(spec)     # canonical Schedule artifact
    tab   = sched.table                # (cols, T) int32 scalar-prefetch
                                       # task table the kernels consume

A :class:`ScheduleSpec` declares the *tile space* — major/minor extents,
per-major raggedness (an exclusive ``band`` end and/or an inclusive
``band_start``, e.g. a causal attention band shifted by a KV-cache
``q_offset``), ragged group extents for grouped (MoE) spaces — plus the
traversal-order policy:

``"gilbert"``
    generalized-Hilbert order over the dense ``major x minor`` rectangle,
    replicated ``layers`` times (the dense GEMM k-layer teams).  Columns
    ``(major, minor, layer)``.
``"serpentine"``
    boustrophedon over a (possibly ragged) band: one major row at a time —
    the accumulator-residency constraint of online-softmax attention — with
    the minor direction alternating per *non-empty* row so the panel that
    ends row ``i`` is adjacent to the panel that starts row ``i+1``.
    Columns ``(major, minor, first, last)``; ``first``/``last`` are the
    kernels' zero/flush predicates (a ragged row count cannot express them
    statically).
``"grouped"``
    one gilbert map per non-empty group over its own ``rows x minor``
    grid, majors offset into the packed global row space (offsets advance
    past empty groups too — the packed buffer reserves their rows).
    Columns ``(major, minor, group)``.
``"grouped-shared"``
    ONE shared gilbert map over ``major x minor`` replayed per group, each
    task carrying the group's packed row offset/extent so the kernel can
    bound a ragged contraction (the grouped TN weight-grad traversal).
    Columns ``(major, minor, group, group_off, group_len)``.

The compiler is pure host-side ``numpy``.  This is the port's own copy of
``repro.core.schedule``: every table and spec key it emits is byte-identical
to that module's (differentially tested in ``tests/test_torch_schedule.py``).
The CUDA GEMM kernel reads its ``(major, minor)`` rows from device memory.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.sfc import create_sfc_map

__all__ = [
    "ScheduleSpec",
    "Schedule",
    "compile_schedule",
    "gemm_spec",
    "grouped_gemm_spec",
    "grouped_tn_spec",
    "band_spec",
    "attention_spec",
]

ORDERS = ("gilbert", "serpentine", "grouped", "grouped-shared")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Declarative description of a masked tile space + traversal policy.

    ``major``/``minor`` are tile *counts* (the tile space is always 2-D;
    batch/head dims are kernel grid dims, not schedule dims).  ``band`` /
    ``band_start`` bound each major row's minor extent (exclusive end,
    inclusive start); ``groups`` gives per-group major extents for the
    grouped orders.  ``masked_sentinel`` keeps fully-masked major rows in
    the table as a single first-and-last task (the dK/dV backward must
    still flush an exact-zero output block for k tiles past the last q
    position).  All sequence fields are tuples so the spec is hashable —
    `compile_schedule` memoizes on it and `key` digests it for tune/robust
    namespacing.
    """

    order: str
    major: int
    minor: int
    layers: int = 1
    band: Optional[Tuple[int, ...]] = None
    band_start: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple[int, ...]] = None
    masked_sentinel: bool = False

    def __post_init__(self):
        if self.order not in ORDERS:
            raise ValueError(
                f"unknown traversal order {self.order!r}; pick from {ORDERS}"
            )
        if self.major < 0 or self.minor < 0:
            raise ValueError(
                f"negative tile space {self.major}x{self.minor}"
            )
        if self.layers < 1:
            raise ValueError(f"layers must be >= 1, got {self.layers}")
        if self.layers > 1 and self.order != "gilbert":
            raise ValueError(
                f"layers is a gilbert (dense GEMM) knob; order={self.order!r}"
            )
        for name in ("band", "band_start"):
            v = getattr(self, name)
            if v is not None:
                if self.order != "serpentine":
                    raise ValueError(
                        f"{name} requires order='serpentine', got {self.order!r}"
                    )
                if len(v) != self.major:
                    raise ValueError(
                        f"{name} has {len(v)} entries for {self.major} major rows"
                    )
        if self.groups is not None and not self.order.startswith("grouped"):
            raise ValueError(
                f"groups requires a grouped order, got {self.order!r}"
            )
        if self.order.startswith("grouped") and self.groups is None:
            raise ValueError(f"order={self.order!r} needs groups")
        if self.masked_sentinel and self.order != "serpentine":
            raise ValueError("masked_sentinel is a serpentine-band knob")

    @property
    def columns(self) -> Tuple[str, ...]:
        return {
            "gilbert": ("major", "minor", "layer"),
            "serpentine": ("major", "minor", "first", "last"),
            "grouped": ("major", "minor", "group"),
            "grouped-shared": (
                "major", "minor", "group", "group_off", "group_len"
            ),
        }[self.order]

    @property
    def key(self) -> str:
        """Short stable digest of the canonical spec — tune namespaces and
        robust-ladder shape keys derive from it, so knob winners and
        quarantines select per-schedule, not per call site."""
        canon = (
            f"{self.order}|{self.major}x{self.minor}|L{self.layers}"
            f"|b{self.band}|s{self.band_start}|g{self.groups}"
            f"|m{int(self.masked_sentinel)}"
        )
        return hashlib.sha1(canon.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The canonical compiled artifact: one ``(cols, T)`` int32 task table
    plus the column map the kernels' index-map closures consume."""

    spec: ScheduleSpec
    table: np.ndarray

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.spec.columns

    @property
    def num_tasks(self) -> int:
        return int(self.table.shape[1])

    @property
    def key(self) -> str:
        return self.spec.key

    def col(self, name: str) -> int:
        """Row index of a named column — the index-map constant."""
        try:
            return self.columns.index(name)
        except ValueError:
            raise KeyError(
                f"schedule {self.spec.order!r} has no column {name!r}; "
                f"columns: {self.columns}"
            ) from None


def _compile_gilbert(spec: ScheduleSpec) -> np.ndarray:
    sfc = create_sfc_map(spec.major, spec.minor)
    im = sfc.im_table()
    in_ = sfc.in_table()
    ims = np.tile(im, spec.layers)
    ins = np.tile(in_, spec.layers)
    layers = np.repeat(
        np.arange(spec.layers, dtype=np.int32), spec.major * spec.minor
    )
    return np.stack([ims, ins, layers]).astype(np.int32)


def _compile_serpentine(spec: ScheduleSpec) -> np.ndarray:
    n_major, n_minor = spec.major, spec.minor
    lo = spec.band_start if spec.band_start is not None else (0,) * n_major
    hi = spec.band if spec.band is not None else (n_minor,) * n_major
    cols = []
    flip = False
    for i in range(n_major):
        start, stop = int(lo[i]), int(hi[i])
        if stop - start <= 0:
            if spec.masked_sentinel:
                # fully-masked major row: its output block must still be
                # written, so one first-and-last task flushes exact zeros
                # (minor clamped in-range; the kernel's zero predicate
                # masks the whole tile).  The boustrophedon flip does NOT
                # toggle — the serpentine restarts as if the row were
                # absent, preserving end/start panel adjacency across it.
                cols.append(
                    np.asarray(
                        [[i], [max(n_minor - 1, 0)], [1], [1]], np.int32
                    )
                )
            continue
        ks = np.arange(start, stop, dtype=np.int32)
        if flip:
            ks = ks[::-1]
        flip = not flip
        n = ks.size
        first = np.zeros(n, np.int32)
        last = np.zeros(n, np.int32)
        first[0] = 1
        last[-1] = 1
        cols.append(np.stack([np.full(n, i, np.int32), ks, first, last]))
    if not cols:
        return np.zeros((4, 0), np.int32)
    return np.concatenate(cols, axis=1).astype(np.int32)


def _compile_grouped(spec: ScheduleSpec) -> np.ndarray:
    ims: list = []
    ins: list = []
    grps: list = []
    row_off = 0
    for g, rows in enumerate(spec.groups):
        if rows > 0:
            sfc = create_sfc_map(rows, spec.minor)
            ims.append(sfc.im_table() + row_off)
            ins.append(sfc.in_table())
            grps.append(np.full(rows * spec.minor, g, dtype=np.int32))
        # offsets advance past empty groups too: the packed row space
        # reserves their (zero) slabs
        row_off += rows
    if not ims:
        return np.zeros((3, 0), np.int32)
    return np.stack(
        [np.concatenate(ims), np.concatenate(ins), np.concatenate(grps)]
    ).astype(np.int32)


def _compile_grouped_shared(spec: ScheduleSpec) -> np.ndarray:
    sfc = create_sfc_map(spec.major, spec.minor)
    iks = sfc.im_table()
    ins = sfc.in_table()
    size = spec.major * spec.minor
    cols = []
    row_off = 0
    for g, rows in enumerate(spec.groups):
        cols.append(
            np.stack(
                [
                    iks,
                    ins,
                    np.full(size, g, dtype=np.int32),
                    np.full(size, row_off, dtype=np.int32),
                    np.full(size, rows, dtype=np.int32),
                ]
            )
        )
        row_off += rows
    if not cols:
        return np.zeros((5, 0), np.int32)
    return np.concatenate(cols, axis=1).astype(np.int32)


@functools.lru_cache(maxsize=512)
def compile_schedule(spec: ScheduleSpec) -> Schedule:
    """Compile a :class:`ScheduleSpec` into its canonical :class:`Schedule`.

    Pure host-side, memoized on the spec (all fields are hashable).  The
    returned table is read-only: every trace of every kernel family shares
    one compiled artifact per spec.
    """
    tab = {
        "gilbert": _compile_gilbert,
        "serpentine": _compile_serpentine,
        "grouped": _compile_grouped,
        "grouped-shared": _compile_grouped_shared,
    }[spec.order](spec)
    tab.setflags(write=False)
    return Schedule(spec=spec, table=tab)


# ---------------------------------------------------------------------------
# spec constructors — the per-kernel-family front-ends
# ---------------------------------------------------------------------------


def gemm_spec(mb: int, nb: int, k_layers: int = 1) -> ScheduleSpec:
    """Dense GEMM tile space: gilbert over ``mb x nb``, one replicated
    traversal per K layer (Listing-1 task order: layer-major, gilbert
    order within each layer)."""
    return ScheduleSpec(
        order="gilbert", major=mb, minor=nb, layers=k_layers
    )


def grouped_gemm_spec(row_blocks: Tuple[int, ...], nb: int) -> ScheduleSpec:
    """Ragged grouped (MoE) forward/NT tile space: per-expert gilbert maps
    over each expert's packed row slab."""
    return ScheduleSpec(
        order="grouped", major=sum(row_blocks), minor=nb,
        groups=tuple(int(r) for r in row_blocks),
    )


def grouped_tn_spec(
    row_blocks: Tuple[int, ...], kb: int, nb: int
) -> ScheduleSpec:
    """Grouped TN (weight-grad) tile space: every expert owns the same
    ``kb x nb`` output grid; one shared gilbert map replayed per expert
    with the packed row offset/extent bounding its ragged contraction."""
    return ScheduleSpec(
        order="grouped-shared", major=kb, minor=nb,
        groups=tuple(int(r) for r in row_blocks),
    )


def band_spec(
    n_major: int,
    n_minor: int,
    band: Optional[Tuple[int, ...]] = None,
) -> ScheduleSpec:
    """Boustrophedon band space (`core.sfc.sfc_band_table` semantics):
    ``band[i]`` is the exclusive minor extent of major row ``i``."""
    return ScheduleSpec(
        order="serpentine", major=n_major, minor=n_minor,
        band=None if band is None else tuple(int(b) for b in band),
    )


def attention_spec(
    nq: int,
    nk: int,
    *,
    causal: bool,
    q_chunk: int,
    k_chunk: int,
    transpose: bool = False,
    q_offset: int = 0,
) -> ScheduleSpec:
    """The (q, k) tile space of a flash-attention pass.

    Start-aligned causal convention: *global* q position ``q_offset + i``
    attends k positions ``0 .. q_offset + i`` — ``q_offset`` shifts the
    causal band by a KV-cache offset so a chunked prefill reuses the same
    schedule family (offset 0 is the plain start-aligned mask).  With
    ``transpose`` the table is k-row-major (the dK/dV traversal): each k
    tile's band of contributing q tiles is a ragged *start*, and k tiles
    entirely past the last q position keep a masked-sentinel task so their
    zero dK/dV block still flushes.
    """
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if not causal:
        if transpose:
            return band_spec(nk, nq)
        return band_spec(nq, nk)
    if not transpose:
        # q row i covers k tiles whose first position <= i's last global
        # position (q_offset + i*q_chunk + q_chunk - 1)
        band = np.minimum(
            (q_offset + np.arange(nq, dtype=np.int64) * q_chunk
             + q_chunk - 1) // k_chunk + 1,
            nk,
        )
        return band_spec(nq, nk, band=tuple(int(b) for b in band))
    # k row j contributes to q tiles whose last global position >= j's
    # first — a ragged *start* instead of a ragged end, same serpentine
    start = np.minimum(
        np.maximum(
            np.arange(nk, dtype=np.int64) * k_chunk - q_offset, 0
        ) // q_chunk,
        nq,
    )
    return ScheduleSpec(
        order="serpentine", major=nk, minor=nq,
        band_start=tuple(int(s) for s in start),
        masked_sentinel=True,
    )
