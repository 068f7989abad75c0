"""Performance models for SFC-CA GEMM (paper §III-B, §III-C): the port's
copy of ``repro.core.perf_model``.

Three layers of modelling, all host-side numpy (no kernel runs):

1. ``HardwareModel`` — (γ, β) pairs per memory level.  The paper extracts γ
   (cycles/flop with operands in fast memory) and β (cycles/byte from slow
   memory) from microbenchmarks; the models here are data-sheet numbers in
   *seconds*: ``TPU_V5E`` (the JAX package's, kept so that the port's CPU
   knob choices equal the JAX package's) and ``H100_SXM`` (the card the
   port's kernels run on).  `repro_torch.tune.calibrate` fits a device's
   overhead constants and a throughput derate on top of either.

2. ``simulate_patch_traversal`` — an *exact* event-level simulator of one
   worker traversing its SFC patch, classifying every BRGEMM invocation as
   BRGEMM₀/₁/₂/₃ (paper eqs. 1-4) under a finite fast-memory panel cache
   with LRU eviction.

3. ``analytical_time`` / ``choose_knobs_analytical`` / ``NearestNeighborModel``
   — the paper's closed-form roofline (infinite fast memory + capacity
   heuristic for k_block_factor) and its two knob predictors.

Every function returns what the JAX module's returns on the same
arguments; the tests hold them equal.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.decomposition import (
    divisor_factorizations,
    sfc_decompose,
    words_moved,
)

__all__ = [
    "HardwareModel",
    "TPU_V5E",
    "H100_SXM",
    "H100_SMS",
    "BRGemmCounts",
    "simulate_patch_traversal",
    "simulate_gemm",
    "simulate_train_gemm",
    "shared_memory_floor",
    "vmem_excess_bytes",
    "backward_gemm_shapes",
    "attention_phase_shapes",
    "simulate_flash_attention",
    "simulate_decode_attention",
    "unfused_attention_bytes",
    "unfused_decode_attention_bytes",
    "optimizer_update_bytes",
    "analytical_time",
    "roofline_best_time",
    "train_roofline_time",
    "choose_knobs_analytical",
    "choose_knobs_autotune",
    "NearestNeighborModel",
    "gemm_flops",
    "abft_overhead",
]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """γ/β cost model (paper §III-B), in seconds.

    gamma:      sec/FLOP with operands in fast memory (1 / peak throughput)
    beta:       sec/byte read from slow memory (1 / bandwidth)
    fast_bytes: per-worker fast memory capacity (paper: L2; TPU: VMEM;
                H100: an SM's share of the L2)
    name:       label for reports

    The trailing overhead fields are *calibrated platform constants*
    (`repro_torch.tune.calibrate` fits them from a measured micro-sweep and
    persists them per device kind alongside the knob cache).  Their
    defaults are inert — an uncalibrated model reproduces the pure
    datasheet γ/β roofline exactly:

    launch_overhead_s: fixed per-kernel-launch setup cost
    flush_overhead_s:  per-accumulator-drain latency (each output tile
                       drains once per K chunk; `simulate_gemm` charges the
                       per-worker critical-path drain count)
    drain_byte_s:      sec/byte of per-grid-step working set (streamed
                       panels + f32 accumulator tile) charged for every
                       step after the first — the measured per-step cost
                       grows with the step footprint, not just the count
    vmem_penalty:      sec per byte the per-grid-step working set overflows
                       ``vmem_budget_bytes`` (replaces the old hardcoded
                       VMEM-footprint guesses — fitted, not asserted)
    calibrated:        device kind the constants were fitted on ("" =
                       datasheet defaults)
    """

    name: str
    gamma: float
    beta: float
    fast_bytes: int
    # chip-level network (used by the distributed CA model)
    ici_beta: float = 0.0
    # calibrated platform constants (see `repro_torch.tune.calibrate`)
    launch_overhead_s: float = 0.0
    flush_overhead_s: float = 0.0
    drain_byte_s: float = 0.0
    vmem_penalty: float = 0.0
    # sec/byte charged on panel reuse the census credits but the measured
    # device does not deliver (0 = trust the LRU model fully)
    reuse_miss_beta: float = 0.0
    vmem_budget_bytes: int = 16 * 2**20  # TPU: Mosaic VMEM per core; H100: a CTA's shared memory
    calibrated: str = ""

    @property
    def peak_flops(self) -> float:
        return 1.0 / self.gamma

    @property
    def mem_bw(self) -> float:
        return 1.0 / self.beta

    @property
    def machine_balance(self) -> float:
        """FLOP/byte needed to be compute bound."""
        return self.beta / self.gamma


# TPU v5e, per task spec: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/ICI-link,
# 128 MiB VMEM (we budget 0.75 of it for panel residency, mirroring the
# paper's "within a fraction (e.g. 0.5) of the per core L2 cache").
TPU_V5E = HardwareModel(
    name="tpu_v5e",
    gamma=1.0 / 197e12,
    beta=1.0 / 819e9,
    fast_bytes=int(128 * 2**20 * 0.75),
    ici_beta=1.0 / 50e9,
)


# NVIDIA H100 SXM5, from its data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
# HBM3, a 50 MB L2 shared by 132 SMs, 228 KB of shared memory an SM (227 KB
# of it a CTA at most).
#
# fast_bytes: an SM's share of the L2, not its shared memory.  What the
# simulator's LRU cache decides is whether a worker's *next* tile finds its
# A or B panel still on chip (paper: per-core L2).  On the card a panel never
# stays in shared memory past its tile: the wgmma kernels' shared memory is
# a ring of 128 x 64 operand stages that the next tile's loads overwrite
# (`kernels/csrc/sfc_gemm_wgmma.cuh`), so the reuse between consecutive
# tiles of one worker, which the SFC order buys, is served by the L2.  Every
# SM streams at once, so one worker (an SM) holds 1/132 of it.  The CTA's
# shared-memory limit is the working-set budget (`vmem_budget_bytes`), the
# counterpart of the TPU's VMEM per core.
H100_SMS = 132
H100_SXM = HardwareModel(
    name="h100_sxm",
    gamma=1.0 / 989e12,
    beta=1.0 / 3.35e12,
    fast_bytes=50 * 2**20 // H100_SMS,
    vmem_budget_bytes=227 * 2**10,
)


def gemm_flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K


def vmem_excess_bytes(
    bm: int,
    bn: int,
    k_chunk: int,
    *,
    dtype_bytes: int = 2,
    n_b_mats: int = 1,
    hw: HardwareModel = None,
) -> float:
    """Bytes by which one grid step's working set — double-buffered A/B
    panels plus the f32 accumulator(s) — overflows the VMEM budget.  The
    calibrated ``hw.vmem_penalty`` coefficient converts this to seconds;
    an in-budget working set costs nothing (mirrors the fused-path VMEM
    check in `kernels.ops.fused_path_fits_vmem`, but as a fitted soft
    penalty instead of a hard fallback)."""
    budget = (hw.vmem_budget_bytes if hw is not None else 16 * 2**20)
    panels = (bm * k_chunk + n_b_mats * k_chunk * bn) * dtype_bytes * 2
    accs = bm * bn * 4 * n_b_mats
    return float(max(0, panels + accs - budget))


@dataclasses.dataclass
class BRGemmCounts:
    """BRGEMM invocation census for one worker (paper §III-B taxonomy)."""

    brgemm0: int = 0  # A and B both from slow memory
    brgemm1: int = 0  # only A from slow memory
    brgemm2: int = 0  # only B from slow memory
    brgemm3: int = 0  # both resident in fast memory
    time: float = 0.0  # modeled seconds on this worker's critical path
    slow_bytes: float = 0.0  # bytes read from slow memory (A/B panels)
    # panel bytes a reuse-free streamer would move (every BRGEMM re-reads
    # both panels); ``nocache_bytes - slow_bytes`` is the reuse the census
    # credits, which `hw.reuse_miss_beta` charges back when a calibrated
    # device doesn't deliver it
    nocache_bytes: float = 0.0

    @property
    def total(self) -> int:
        return self.brgemm0 + self.brgemm1 + self.brgemm2 + self.brgemm3

    def as_dict(self) -> Dict[str, float]:
        return {
            "brgemm0": self.brgemm0,
            "brgemm1": self.brgemm1,
            "brgemm2": self.brgemm2,
            "brgemm3": self.brgemm3,
            "time_s": self.time,
            "slow_bytes": self.slow_bytes,
        }


class _PanelCache:
    """LRU over (kind, row/col, k_chunk) panels with a byte budget."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.used = 0
        self._lru: "OrderedDict[Tuple, int]" = OrderedDict()

    def hit(self, key: Tuple) -> bool:
        if key in self._lru:
            self._lru.move_to_end(key)
            return True
        return False

    def insert(self, key: Tuple, nbytes: int) -> None:
        if nbytes > self.capacity:
            return  # uncacheable panel: always streamed
        while self.used + nbytes > self.capacity and self._lru:
            _, sz = self._lru.popitem(last=False)
            self.used -= sz
        self._lru[key] = nbytes
        self.used += nbytes


def simulate_patch_traversal(
    cells: np.ndarray,
    *,
    bm: int,
    bn: int,
    K: int,
    k_layers: int,
    k_block_factor: int,
    hw: HardwareModel,
    dtype_bytes: int = 2,
    c_resident_bytes: int = 0,
    n_b_mats: int = 1,
) -> BRGemmCounts:
    """Exact BRGEMM taxonomy for one worker walking ``cells`` (SFC order).

    Per C tile the worker performs ``k_block_factor`` BRGEMM calls, each
    contracting a K/(k_layers*k_block_factor) slab.  Panel residency is
    tracked with an LRU cache of ``hw.fast_bytes`` minus the worker's
    persistent C-patch footprint (paper: C stays in fast memory).

    ``n_b_mats > 1`` models the fused dual-B (GLU) kernel: each task
    streams that many B panels per A panel (they live and die together in
    the cache) and performs the matching multiple of FLOPs.
    """
    k_per_layer = K // k_layers
    k_chunk = max(1, k_per_layer // k_block_factor)
    n_chunks = max(1, k_per_layer // k_chunk)
    sa = bm * k_chunk * dtype_bytes  # A panel bytes per BRGEMM
    sb = k_chunk * bn * dtype_bytes * n_b_mats  # B panel bytes per BRGEMM
    g = gemm_flops(bm, bn, k_chunk) * n_b_mats  # FLOPs per BRGEMM

    budget = max(0, hw.fast_bytes - c_resident_bytes)
    cache = _PanelCache(budget)
    out = BRGemmCounts()

    for im, in_ in cells:
        for kc in range(n_chunks):
            a_key = ("A", int(im), kc)
            b_key = ("B", int(in_), kc)
            out.nocache_bytes += sa + sb
            a_hit = cache.hit(a_key)
            b_hit = cache.hit(b_key)
            if a_hit and b_hit:
                out.brgemm3 += 1
                t = g * hw.gamma  # eq. (4)
            elif a_hit:
                out.brgemm2 += 1  # only B from slow memory
                t = max(g * hw.gamma, hw.beta * sb)  # eq. (3)
                out.slow_bytes += sb
                cache.insert(b_key, sb)
            elif b_hit:
                out.brgemm1 += 1  # only A from slow memory
                t = max(g * hw.gamma, hw.beta * sa)  # eq. (2)
                out.slow_bytes += sa
                cache.insert(a_key, sa)
            else:
                out.brgemm0 += 1
                t = max(g * hw.gamma, hw.beta * (sa + sb))  # eq. (1)
                out.slow_bytes += sa + sb
                cache.insert(a_key, sa)
                cache.insert(b_key, sb)
            out.time += t
    return out


def simulate_gemm(
    M: int,
    N: int,
    K: int,
    *,
    n_workers: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    bm: int = 256,
    bn: int = 256,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    n_b_mats: int = 1,
) -> Dict[str, float]:
    """Whole-GEMM modeled time = max over workers of per-worker simulated time
    plus the C read/write and (c>1) the layer reduction — paper §III-B tail.
    Returns a dict with time, throughput and the taxonomy census.
    ``n_b_mats=2`` models the fused dual-B GLU kernel (see
    `simulate_patch_traversal`).
    """
    mb_blocks, nb_blocks = M // bm, N // bn
    d = sfc_decompose(mb_blocks, nb_blocks, n_workers, k_layers)
    worst: Optional[BRGemmCounts] = None
    total_slow = 0.0
    census = BRGemmCounts()
    for p in d.patches:
        c_bytes = p.n_cells * bm * bn * dtype_bytes  # persistent C patch (paper §II-E)
        r = simulate_patch_traversal(
            p.cells,
            bm=bm,
            bn=bn,
            K=K,
            k_layers=k_layers,
            k_block_factor=k_block_factor,
            hw=hw,
            dtype_bytes=dtype_bytes,
            c_resident_bytes=c_bytes,
            n_b_mats=n_b_mats,
        )
        total_slow += r.slow_bytes
        census.brgemm0 += r.brgemm0
        census.brgemm1 += r.brgemm1
        census.brgemm2 += r.brgemm2
        census.brgemm3 += r.brgemm3
        if worst is None or r.time > worst.time:
            worst = r
    assert worst is not None

    # C traffic: read+write the output once; with c copies, add the reduce.
    per_worker_c = (M * N / d.workers_per_layer) * dtype_bytes
    c_time = 2 * per_worker_c * hw.beta
    if k_layers > 1:
        # each worker reads (c-1) partial copies of its final patch + writes 1
        final_patch = (M * N / n_workers) * dtype_bytes
        c_time += (k_layers - 1) * 2 * final_patch * hw.beta
    # calibrated platform terms (all zero on an uncalibrated model): one
    # launch setup, the fitted flush latency per accumulator drain on the
    # per-worker critical path (each output tile drains once per K chunk —
    # drain count, not layer count, is what measurement tracks), and the
    # soft penalty for a VMEM-overflowing working set
    k_chunk = max(1, (K // k_layers) // k_block_factor)
    n_drains = (mb_blocks * nb_blocks / d.workers_per_layer) * k_block_factor
    flush_time = n_drains * hw.flush_overhead_s
    # per-grid-step working set: the panels one (tile, K-chunk) step streams
    # plus the f32 accumulator tile.  Steps after the first each pay
    # ``drain_byte_s`` per byte of it (nocache_bytes is the worst worker's
    # whole-traversal panel traffic, so / n_drains recovers the per-step
    # panel footprint).
    step_bytes = worst.nocache_bytes / max(n_drains, 1.0) + bm * bn * 4
    drain_time = hw.drain_byte_s * max(0.0, n_drains - 1.0) * step_bytes
    reuse_deficit = max(0.0, worst.nocache_bytes - worst.slow_bytes)
    reuse_time = hw.reuse_miss_beta * reuse_deficit
    overhead = (
        hw.launch_overhead_s
        + flush_time
        + drain_time
        + reuse_time
        + hw.vmem_penalty
        * vmem_excess_bytes(
            bm, bn, k_chunk, dtype_bytes=dtype_bytes, n_b_mats=n_b_mats, hw=hw
        )
    )
    time = worst.time + c_time + overhead
    flops = gemm_flops(M, N, K) * n_b_mats
    return {
        "time_s": time,
        "tflops": flops / time / 1e12,
        "gemm_time_s": worst.time,
        "c_time_s": c_time,
        "flush_time_s": flush_time,
        "drain_time_s": drain_time,
        "drain_step_bytes": step_bytes,
        "reuse_time_s": reuse_time,
        "reuse_deficit_bytes": reuse_deficit,
        "overhead_s": overhead,
        "slow_bytes_total": total_slow,
        **{k: v for k, v in census.as_dict().items() if k.startswith("brgemm")},
    }


def shared_memory_floor(
    M: int,
    N: int,
    K: int,
    *,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    n_b_mats: int = 1,
) -> float:
    """Aggregate compulsory-traffic bound: every A and B element crosses the
    shared slow-memory interface at least once and C is written once,
    regardless of per-worker locality.

    The per-worker simulator is (by design) nearly shape-oblivious: gilbert
    partitions hand every worker a square-ish patch, so equal-area shapes
    produce identical per-worker censuses.  The *footprints* M·K and K·N do
    depend on the full (M, N, K) — this floor is what keys the modeled time
    by shape.  Callers compose it explicitly: `benchmarks/gemm_sweep.py`
    charges it *serially* (per-worker time + floor, the conservative
    no-overlap bound it documents), while `simulate_train_gemm` treats it
    as a lower bound (max(per-phase time, floor)).
    """
    bytes_ = (M * K + n_b_mats * K * N + M * N) * dtype_bytes
    return bytes_ * hw.beta


def abft_overhead(
    M: int,
    N: int,
    K: int,
    *,
    bm: int = 256,
    bn: int = 256,
    k_block_factor: int = 1,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    n_b_mats: int = 1,
    n_workers: int = 1,
) -> Dict[str, float]:
    """Modeled cost of the ABFT checksum lane (``abft="detect"``).

    Two components, per the Walker & Skjellum data-movement accounting:

    * **Operand checksum reference** ``(eᵀA)·(Be)``: one extra streaming
      read of A and each B panel (``M·K + n_b_mats·K·N`` elements) plus
      ~2 FLOPs per element for the row/column sum reductions and the
      final length-K dot.  This runs at op level (XLA), so it pays the
      full slow-memory β on its reads.
    * **In-kernel checksum lane**: the flush sums its f32 accumulator
      tile (``bm·bn`` VPU adds per drain; every output tile drains
      ``k_block_factor`` times) and accumulates into a single f32 launch
      output — a 4-byte HBM write per launch, which is noise.  The lane
      reads nothing extra: the accumulator is already VMEM-resident at
      flush time.

    Relative to the GEMM itself the extra traffic is the
    O(1/bm + 1/bn) sliver the paper's analysis predicts — this function
    prices it so `tune`/bench gates can bound the overhead instead of
    guessing.  Both components partition perfectly (the ref pass over
    operand slices, the lane over output tiles), so pass the same
    ``n_workers`` as `simulate_gemm` to get a comparable per-worker time
    — `simulate_gemm`'s β/γ are per-worker rates and its ``time_s`` is
    the max over workers.  Returns ``{"time_s", "bytes", "flops"}`` with
    bytes/flops as chip totals and ``time_s`` per-worker.
    """
    ref_elems = M * K + n_b_mats * K * N
    ref_bytes = ref_elems * dtype_bytes
    ref_flops = 2.0 * ref_elems + 2.0 * K
    n_tiles = max(1, (M // max(bm, 1)) * (N // max(bn, 1)))
    lane_flops = float(n_tiles * k_block_factor) * bm * bn * n_b_mats
    lane_bytes = 4.0  # the per-launch f32 residual scalar
    flops = ref_flops + lane_flops
    bytes_ = ref_bytes + lane_bytes
    return {
        "time_s": (bytes_ * hw.beta + flops * hw.gamma) / max(n_workers, 1),
        "bytes": float(bytes_),
        "flops": float(flops),
    }


def backward_gemm_shapes(M: int, N: int, K: int) -> Dict[str, Tuple[int, int, int]]:
    """Resolver buckets of the two backward GEMMs of C(M,N) = A(M,K)·B(K,N):

      nt:  dA(M,K) = dC(M,N) · B(K,N)ᵀ   -> bucket (M, K, N)
      tn:  dB(K,N) = A(M,K)ᵀ · dC(M,N)   -> bucket (K, N, M)

    These are the ``op="nt"`` / ``op="tn"`` tune-cache namespaces: the
    backward contracts over N (resp. M), so its panel geometry — and its
    knob winners — differ from the forward's.
    """
    return {"nt": (M, K, N), "tn": (K, N, M)}


def attention_phase_shapes(
    sq: int, sk: int, d: int, *, n_heads: int = 0, cache_len: int = 0
) -> Dict[str, Tuple[int, int, int]]:
    """Tune-namespace buckets of the SFC attention kernels, the attention
    analogue of `backward_gemm_shapes`:

      attn_fwd / attn_bwd: bucket (Sq, Sk, D) — the flash band kernels
      attn_decode:         bucket (H, T, D)  — one decode step's fan-out

    The decode entry is only emitted when ``n_heads``/``cache_len`` are
    given (training-only callers have no decode shape)."""
    out = {"attn_fwd": (sq, sk, d), "attn_bwd": (sq, sk, d)}
    if n_heads and cache_len:
        out["attn_decode"] = (n_heads, cache_len, d)
    return out


# modeled MXU passes per band tile: the forward runs 2 (scores, P·V); the
# backward runs 7 across its two launches (dQ: S, dP, dS·K; dK/dV: S, dP,
# Pᵀ·dO, dSᵀ·Q — p is recomputed per pass, the flash trade)
_ATTN_TILE_DOTS = {"fwd": 2, "bwd": 7}


def simulate_flash_attention(
    b: int,
    h: int,
    sq: int,
    sk: int,
    d: int,
    *,
    q_chunk: int,
    k_chunk: int,
    causal: bool = True,
    phase: str = "fwd",
    hkv: Optional[int] = None,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Exact panel-traffic census of one SFC flash launch (fwd or bwd).

    Walks the same band task table the kernels walk
    (`core.sfc.sfc_band_table` order) with a one-panel memo per operand:
    a q panel streams once per band row, a k/v panel streams whenever the
    serpentine changes k tile — the boustrophedon row turns share exactly
    one panel, which is the locality the schedule buys.  KV bytes are
    charged per *kv head* (GQA groups share the panels through the index
    maps); masked tiles are absent from the table so they cost nothing —
    unlike a dense-grid kernel whose copies still stream.
    """
    if phase not in _ATTN_TILE_DOTS:
        raise ValueError(f"phase={phase!r}")
    from repro_torch.core.schedule import band_spec, compile_schedule

    hkv = hkv or h
    nq = (sq + q_chunk - 1) // q_chunk
    nk = (sk + k_chunk - 1) // k_chunk
    if causal:
        band = np.minimum(
            (np.arange(nq, dtype=np.int64) * q_chunk + q_chunk - 1)
            // k_chunk
            + 1,
            nk,
        )
    else:
        band = None
    tab = compile_schedule(
        band_spec(nq, nk, band=None if band is None else tuple(int(x) for x in band))
    ).table
    n_tiles = tab.shape[1]

    q_panel = q_chunk * d * dtype_bytes
    kv_panel = 2 * k_chunk * d * dtype_bytes  # K and V stream together
    q_bytes = 0.0
    kv_fetches = 0
    last_k = -1
    for t in range(n_tiles):
        if tab[2, t] == 1:  # new band row: q panel streams once
            q_bytes += q_panel
        if int(tab[1, t]) != last_k:
            kv_fetches += 1
            last_k = int(tab[1, t])
    # per-q-head traffic x (b*h), kv panels charged per kv head
    q_bytes = q_bytes * b * h
    kv_bytes = kv_fetches * kv_panel * b * hkv
    o_bytes = b * h * sq * d * dtype_bytes  # one output write
    if phase == "bwd":
        # dO/O/lse reads + dQ/dK/dV writes (f32 grads)
        o_bytes = (
            2 * b * h * sq * d * dtype_bytes
            + b * h * sq * 4
            + b * h * sq * d * 4
            + 2 * b * hkv * sk * d * 4
        )
    bytes_total = q_bytes + kv_bytes + o_bytes
    flops = (
        _ATTN_TILE_DOTS[phase]
        * 2.0
        * q_chunk
        * k_chunk
        * d
        * n_tiles
        * b
        * h
    )
    # calibrated launch setup: the backward is two launches (dQ, dK/dV)
    n_launches = 2 if phase == "bwd" else 1
    time = (
        max(flops * hw.gamma, bytes_total * hw.beta)
        + n_launches * hw.launch_overhead_s
    )
    return {
        "time_s": time,
        "bytes": bytes_total,
        "flops": flops,
        "tflops": flops / time / 1e12,
        "n_tiles": float(n_tiles),
        "kv_refetches": float(max(0, kv_fetches - nk)),
    }


def unfused_attention_bytes(
    b: int,
    h: int,
    sq: int,
    sk: int,
    d: int,
    *,
    hkv: Optional[int] = None,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
) -> float:
    """HBM bytes of the materialized-scores formulation: the (Sq, Sk) f32
    score matrix and the softmax'd P each make a write+read round trip,
    GQA K/V are repeat-expanded to all h heads, and Q/O move once — the
    traffic the flash kernels delete."""
    del hkv  # the einsum formulation expands kv heads to h
    s_round_trips = 2 * 2 * b * h * sq * sk * 4  # scores + P, f32 w+r
    qkv = b * h * (sq + 2 * sk) * d * dtype_bytes
    o = b * h * sq * d * dtype_bytes
    return s_round_trips + qkv + o


def simulate_decode_attention(
    b: int,
    h: int,
    hkv: int,
    t: int,
    d: int,
    *,
    valid_frac: float = 1.0,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """One decode step's attention on the SFC kernel: the cache streams
    once per *kv head* up to each sequence's valid length (the prefetch
    bound skips dead chunks entirely), q/o move once.  Bandwidth-bound by
    construction — the census is the roofline."""
    t_v = max(1, int(t * valid_frac))
    cache = 2 * b * hkv * t_v * d * dtype_bytes
    qo = 2 * b * h * d * dtype_bytes
    bytes_total = cache + qo
    flops = 4.0 * b * h * t_v * d
    time = (
        max(flops * hw.gamma, bytes_total * hw.beta) + hw.launch_overhead_s
    )
    return {
        "time_s": time,
        "bytes": bytes_total,
        "flops": flops,
        "tflops": flops / time / 1e12,
    }


def unfused_decode_attention_bytes(
    b: int,
    h: int,
    hkv: int,
    t: int,
    d: int,
    *,
    dtype_bytes: int = 2,
) -> float:
    """Decode-step bytes of `models.layers.decode_attention`: the cache is
    head-expanded to all h heads (jnp.repeat under einsum), every row of
    the padded cache is read regardless of valid length, and the (h, t)
    scores round-trip in f32 through the softmax."""
    cache = 2 * b * h * t * d * dtype_bytes
    scores = 2 * 2 * b * h * t * 4
    qo = 2 * b * h * d * dtype_bytes
    return cache + scores + qo


def optimizer_update_bytes(
    K: int,
    N: int,
    *,
    fused: bool,
    param_bytes: int = 2,
    grad_bytes: int = 4,
    state_bytes: int = 4,
) -> float:
    """HBM bytes of one AdamW step over a (K, N) weight.

    unfused: the TN kernel writes dW (f32) to HBM, the elementwise
    optimizer reads it back plus (mu, nu, master) and writes (mu, nu,
    master) plus the cast param — the dW round-trip is pure overhead,
    ~``2*grad_bytes/param_bytes``x the weight's own bytes.

    fused: the update runs in the TN flush — dW never leaves VMEM; only
    the compulsory state round-trip (read+write mu/nu/master) and the
    param write remain.
    """
    state = K * N * state_bytes * 3 * 2  # mu/nu/master read + write
    param = K * N * param_bytes  # W_new write
    if fused:
        return state + param
    dw = K * N * grad_bytes * 2  # dW: TN flush write + optimizer read
    return dw + state + param


def simulate_train_gemm(
    M: int,
    N: int,
    K: int,
    *,
    n_workers: int,
    k_layers: int = 1,
    k_block_factor: int = 1,
    bm: int = 256,
    bn: int = 256,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    optimizer: Optional[str] = None,  # None | "unfused" | "fused"
) -> Dict[str, float]:
    """Model one projection's *training* step: forward GEMM plus the two
    backward GEMMs (dA via NT, dB via TN), each simulated on its own output
    tile grid — the backward traffic the roofline/benchmarks report.

    ``optimizer`` adds the AdamW-step traffic for the (K, N) weight:
    "unfused" charges the dW HBM round-trip (TN flush write + optimizer
    read) plus the moment/master state traffic; "fused" drops the dW terms
    entirely (the TN-update flush) leaving only the compulsory state
    round-trip — the deleted ``opt_saved_bytes`` is reported so the win is
    quantified, not asserted.

    Returns per-phase times/bytes and totals; ``bwd_to_fwd`` is the modeled
    backward:forward cost ratio (≈2 for square shapes, higher when a
    backward bucket is more bandwidth-bound than the forward)."""
    phases = {"fwd": (M, N, K), **backward_gemm_shapes(M, N, K)}
    out: Dict[str, float] = {}
    total_t = total_b = 0.0
    for name, (m, n, k) in phases.items():
        mb = bm if m % bm == 0 else max(1, math.gcd(m, bm))
        nb = bn if n % bn == 0 else max(1, math.gcd(n, bn))
        r = simulate_gemm(
            m, n, k,
            n_workers=n_workers,
            k_layers=k_layers, k_block_factor=k_block_factor,
            bm=mb, bn=nb, hw=hw, dtype_bytes=dtype_bytes,
        )
        t = max(
            r["time_s"],
            shared_memory_floor(m, n, k, hw=hw, dtype_bytes=dtype_bytes),
        )
        out[f"{name}_time_s"] = t
        out[f"{name}_bytes"] = r["slow_bytes_total"]
        total_t += t
        total_b += r["slow_bytes_total"]
    if optimizer is not None:
        if optimizer not in ("unfused", "fused"):
            raise ValueError(f"optimizer={optimizer!r}")
        ob = optimizer_update_bytes(
            K, N, fused=optimizer == "fused", param_bytes=dtype_bytes
        )
        out["opt_bytes"] = ob
        out["opt_time_s"] = ob * hw.beta
        out["opt_saved_bytes"] = optimizer_update_bytes(
            K, N, fused=False, param_bytes=dtype_bytes
        ) - optimizer_update_bytes(K, N, fused=True, param_bytes=dtype_bytes)
        total_t += out["opt_time_s"]
        total_b += ob
    out["total_time_s"] = total_t
    out["total_bytes"] = total_b
    out["bwd_to_fwd"] = (
        (out["nt_time_s"] + out["tn_time_s"]) / out["fwd_time_s"]
        if out["fwd_time_s"] > 0
        else 0.0
    )
    out["tflops"] = 3 * gemm_flops(M, N, K) / total_t / 1e12
    return out


def analytical_time(
    M: int,
    N: int,
    K: int,
    *,
    tm: int,
    tn: int,
    c: int,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
) -> float:
    """Closed-form roofline (paper §III-B, infinite fast memory): per-worker
    time = max(compute, slow-memory traffic) + C traffic."""
    t = tm * tn * c
    flops_per_worker = gemm_flops(M, N, K) / t
    w = words_moved(M, N, K, tm, tn, c, dtype_bytes)
    compute = flops_per_worker * hw.gamma
    memory = (w["a_bytes"] + w["b_bytes"]) * hw.beta
    c_traffic = w["c_bytes"] * hw.beta
    return max(compute, memory) + c_traffic


def roofline_best_time(
    M: int,
    N: int,
    K: int,
    n_workers: int,
    *,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    max_c: int = 8,
) -> Tuple[float, Tuple[int, int, int]]:
    """Paper §III-B closing paragraph: iterate over all 2D/3D worker
    decompositions, report the minimum modeled time (the *tight roofline*)."""
    best = (math.inf, (n_workers, 1, 1))
    for c in range(1, max_c + 1):
        if n_workers % c:
            continue
        per_layer = n_workers // c
        for tm_, tn_ in divisor_factorizations(per_layer):
            t = analytical_time(
                M, N, K, tm=tm_, tn=tn_, c=c, hw=hw, dtype_bytes=dtype_bytes
            )
            if t < best[0]:
                best = (t, (tm_, tn_, c))
    return best


def train_roofline_time(
    M: int,
    N: int,
    K: int,
    n_workers: int,
    *,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    max_c: int = 8,
) -> Dict[str, float]:
    """Tight roofline for the full train step of one projection: the best
    worker decomposition of each of the three GEMMs (forward, NT, TN)
    independently — each backward bucket gets its own (tm, tn, c), exactly
    as each gets its own tune-cache namespace in the real kernels."""
    out: Dict[str, float] = {}
    total = 0.0
    phases = {"fwd": (M, N, K), **backward_gemm_shapes(M, N, K)}
    for name, (m, n, k) in phases.items():
        t, _ = roofline_best_time(
            m, n, k, n_workers, hw=hw, dtype_bytes=dtype_bytes, max_c=max_c
        )
        out[f"{name}_s"] = t
        total += t
    out["total_s"] = total
    out["tflops"] = 3 * gemm_flops(M, N, K) / total / 1e12
    return out


def choose_knobs_analytical(
    M: int,
    N: int,
    K: int,
    n_workers: int,
    *,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    bm: int = 256,
    bn: int = 256,
    l2_fraction: float = 0.5,
    max_c: int = 8,
    max_kbf: int = 8,
) -> Tuple[int, int]:
    """Paper §III-C method (2): analytical model picks K_layers; then
    k_block_factor is the smallest value whose A+B panel footprint fits
    ``l2_fraction`` of fast memory."""
    _, (tm, tn, c) = roofline_best_time(
        M, N, K, n_workers, hw=hw, dtype_bytes=dtype_bytes, max_c=max_c
    )
    k_per_layer = max(1, K // c)
    budget = hw.fast_bytes * l2_fraction
    kbf = 1
    while kbf < max_kbf:
        k_chunk = max(1, k_per_layer // kbf)
        footprint = (bm + bn) * k_chunk * dtype_bytes
        if footprint <= budget:
            break
        kbf *= 2
    return c, kbf


def choose_knobs_autotune(
    M: int,
    N: int,
    K: int,
    n_workers: int,
    *,
    hw: HardwareModel = TPU_V5E,
    dtype_bytes: int = 2,
    bm: int = 256,
    bn: int = 256,
    candidates_c: Sequence[int] = (1, 2, 4, 8),
    candidates_kbf: Sequence[int] = (1, 2, 4, 8),
) -> Tuple[Tuple[int, int], Dict[Tuple[int, int], float]]:
    """Paper §III-C method (1): exhaustively evaluate the (≤64) knob tuples.
    Ground truth here is the exact patch-traversal simulator (the container
    has no TPU to time): returns the argmin tuple and the full sweep."""
    sweep: Dict[Tuple[int, int], float] = {}
    for c in candidates_c:
        if n_workers % c or K // c < 1:
            continue
        # small problems may leave workers idle — legal, just inefficient
        for kbf in candidates_kbf:
            r = simulate_gemm(
                M,
                N,
                K,
                n_workers=n_workers,
                k_layers=c,
                k_block_factor=kbf,
                bm=bm,
                bn=bn,
                hw=hw,
                dtype_bytes=dtype_bytes,
            )
            sweep[(c, kbf)] = r["time_s"]
    best = min(sweep, key=sweep.get)
    return best, sweep


class NearestNeighborModel:
    """Paper §III-C method (3): 1-NN classifier over (M, N, K) space.

    Train: autotune a set of shapes (here: exact-simulator argmin).
    Predict: nearest neighbour in log-coordinate space -> its knob tuple.
    """

    def __init__(self) -> None:
        self._coords: Optional[np.ndarray] = None
        self._labels: List[Tuple[int, int]] = []

    @staticmethod
    def _embed(shapes: np.ndarray) -> np.ndarray:
        return np.log2(shapes.astype(np.float64))

    def fit(
        self,
        shapes: Sequence[Tuple[int, int, int]],
        labels: Sequence[Tuple[int, int]],
    ) -> "NearestNeighborModel":
        self._coords = self._embed(np.asarray(shapes, dtype=np.float64))
        self._labels = list(labels)
        return self

    def predict(self, M: int, N: int, K: int) -> Tuple[int, int]:
        if self._coords is None:
            raise RuntimeError("NearestNeighborModel not fitted")
        q = self._embed(np.asarray([[M, N, K]], dtype=np.float64))
        d = np.linalg.norm(self._coords - q, axis=1)
        return self._labels[int(np.argmin(d))]

    def fit_autotuned(
        self,
        shapes: Sequence[Tuple[int, int, int]],
        n_workers: int,
        **kw,
    ) -> "NearestNeighborModel":
        labels = []
        for (m, n, k) in shapes:
            best, _ = choose_knobs_autotune(m, n, k, n_workers, **kw)
            labels.append(best)
        return self.fit(shapes, labels)
