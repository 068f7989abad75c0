// The bf16 GEMMs of the main path on Hopper's own machinery: persistent
// CTAs that walk contiguous segments of the gilbert curve, TMA loads into a
// ring of shared-memory stages, and wgmma products.  Included by
// sfc_gemm_fused.cu into the bf16 forward parts, their ABFT twins and the
// bf16 -DSFC_BWD=1 part, inside its anonymous namespace (it uses that
// file's `activate`); the host needs <cuda.h> for CUtensorMap, included
// there.  The Hopper primitives (mbarriers, TMA, descriptors, wgmma, the
// tensor-map encoders) are hopper.cuh's, shared with the flash backward.
//
// sfc_gemm_wgmma_kernel replaces `repro/kernels/sfc_gemm.py::_fused_kernel`
// behind `sfc_gemm_batched_fused` and `sfc_gemm_fused` at more than 16
// rows (K2, and K1 past the cluster kernel's rows) for bf16 inputs whose
// rows TMA can describe: C[b] = epilogue(A[b] @ B[b or shared]), every
// epilogue flag and the GLU's preact mode, the arithmetic of fused_flush in
// its order with one cast.  sfc_gemm_wgmma_abft_kernel is its ABFT twin
// (the -DSFC_ABFT=1 parts), nt_wgmma_kernel replaces `sfc_gemm_nt`
// (`_nt_kernel`, K7) for bf16 calls: dA = dC @ W^T (+ dC2 @ W2^T),
// flushed in bf16.  Their grouped mode (`body`'s GROUPED) is K3 and K9:
// sfc_gemm_grouped_wgmma_kernel (and its lane twin
// sfc_gemm_grouped_wgmma_abft_kernel) replaces `sfc_gemm_grouped`
// (`_fused_kernel` over the grouped table), grouped_nt_wgmma_kernel
// `sfc_gemm_grouped_nt` (`_grouped_nt_kernel`).  The TN kernels of
// sfc_gemm_fused.cu (K8 `sfc_gemm_tn`, K10 `sfc_gemm_grouped_tn`: dW = A^T
// @ dC, its norm and AdamW-update modes) run the same main loop with kind
// kTn and a flush of their own (the `Flush` argument of `body`).
//
// What bounds them: at the main path's 512 token rows every product does
// 2 * 512 * K * N flops on (512 + N) * K inputs, far above the card's 295
// flops a byte, so the bf16 tensor-core rate bounds them; the 64 x 64 WMMA
// tile kernels reached 37-50 TFLOP/s there, loading each K step with
// synchronous 16-byte copies and two barriers.  A C tile of 128 x BN reads
// (128 + BN) x 64 bf16 a K step from L2 for 2 x 128 x BN x 64 flops: 64
// flops a byte at BN 128, 85 at 256, so with every SM busy the L2's rate
// bounds the narrow tile first.
//
// The design.  A CTA is two consumer warpgroups and one producer warp.  The
// producer's one thread keeps 3-D TMA loads of the A tile (128 rows x 64
// K) and the B tile (64 K x BN columns, N-major as the (K, N) weight is
// stored, in 64-column boxes; NT: BN rows of the (K, N) weight x 64 of its
// N, K-major) in flight through a ring of kStages stages, each guarded by a
// full / empty mbarrier pair; TMA writes the 128-byte swizzle that wgmma
// reads and fills zeros past the ragged M, N and K edges, so the main loop
// has no mask.  Each consumer warpgroup runs wgmma m64nBNk16 bf16 -> f32 on
// its 64 rows of the stage (B through the descriptor's transpose bit in the
// forward: no transposed copy exists), keeping one group of products in
// flight while it waits for the next stage.  The GLU's stage holds BN / 2
// columns of B beside the same columns of B_gate, so one instruction
// computes both accumulators of a 128 x BN / 2 C tile.  NT's dual form
// streams its second operand pair after the first into the same
// accumulator.  BN (128 or 256) is the launch configuration, chosen by the
// wrapper from the shape and the SM count (`kernels/sfc_gemm.py::
// wgmma_launch`): 256 where the wide tiles still fill the card.
//
// The paper's scheme (Listing 1, lines 11-14; `repro/core/decomposition.py::
// partition_curve`): the P workers of a launch take the C tiles of
// `compile_schedule(gemm_spec(mb, nb))` (batch element by batch element)
// in blockwise, balanced, contiguous segments, computed on the device from
// (n_tasks, P), so neighbouring tiles share A or B panels in L2, and one
// tile's epilogue overlaps the producer's loads of the next.  A worker is
// one CTA (one an SM), or, where a CTA has more than one tile, a group of
// up to 4 CTAs that take its segment's tiles in turn: on this card the L2
// is shared, and a panel is read from it once only if the tiles that use
// it run at once (`p.group`, the wrapper's choice).  The kernels keep no
// device-side counter or queue: a launch leaves no state behind and
// replays in a CUDA graph.  The flush runs from the registers: each thread
// owns pairs of adjacent columns of the accumulator fragment.
//
// The f32-output mode (`Flush` OutF32; sfc_gemm_wgmma_f32out_kernel and
// its lane twin): the forward's plain product on bf16 inputs, its raw f32
// accumulator written as it is, 8 bytes a store, for `chunk_einsum`'s SSD
// scores (the TPU kernel's f32 `out_dtype`).  What bounds it at the SSD's
// shapes (M and N 128-256, K 64): the flush's f32 bytes and the launch.
//
// ABFT: each task's kLaneSlots slots of the partials hold the f32 sums of
// its raw accumulators (the GLU's two together), over the rows and columns
// inside the output, one a consumer warp, written with no barrier; the
// wrapper sums the slots on the device.  The flush is the same code with
// the lane on or off.
//
// TN (kind kTn): C (R, C) = A^T @ dC over D token rows, A (D, R) and dC
// (D, C) read as stored.  A stage holds two 64 x 64 boxes of A (token rows
// x 64 of C's rows each, one a consumer warpgroup) and the BN columns of
// dC (the dual form: BN / 2 of dC beside the same ones of dC2, as the
// GLU's B beside B_gate), so A is M-major for wgmma, read through the
// descriptor's transpose bit as B is: no transposed copy exists.  The
// contraction is short (512 token rows: 8 stages a tile), so the producer
// is well into the next tile while the consumers flush.  The flush stages
// the tile through a shared-memory buffer of its own beside the ring
// (`kTnStageBytes`: one set's f32 tile, or both sets' bf16 dW), read back
// in whole rows, so its global traffic is 16-byte accesses along rows;
// the dual form's ring has 3 stages to leave it room.  Grouped (K10,
// `p.grp`): the task's batch element is its expert, whose rows [start,
// start + count) of A and dC it contracts; a box past the expert's last
// row reads the next expert's rows, so the consumers zero those rows of
// the stage (both operands) before the products read it; an expert with
// no rows loads nothing and flushes a zero tile.
//
// Grouped forward and NT (K3, K9; GROUPED): the experts' rows lie packed in
// one (T, K) A (NT: dC (T, N)), expert e's weights are batch element e of
// the 3-D B map ((E, K, N) forward, B_gate alike; NT's (E, N, K)).  The
// task table is `build_grouped_task_table` at 128-row blocks, rows
// (im_global, in, e): the task's first output row is start[e] + (im -
// first_block[e]) * 128 and its rows end at start[e] + count[e] (`grp`,
// (3, E)); an expert with no rows has no task.  A box past the expert's
// rows reads the next expert's rows (past T, TMA's zeros); output row r
// reads only row r of A, so the flush masks those rows and nothing is
// zeroed.  The flush writes at the packed rows with expert e's bias rows,
// and the lane sums the rows inside the expert only.  What bounds them: at
// olmoe's 32-80 rows an expert every launch reads every expert's weights
// once for 2 x rows flops a weight, so the weight bytes do; a stage's
// products (2 x 128 x 64 x 64 x 2 flops a CTA) take less time than its
// 8-16 KB of weights take to arrive at the CTA's share of 3.35 TB/s.
//
// Replicated (kind kRep; sfc_gemm_replicated_wgmma_kernel in the bf16
// -DSFC_REP=1 part): replaces `repro/kernels/sfc_gemm.py::sfc_gemm_batched`
// (`_sfc_gemm_batched_kernel`, K5) and `sfc_gemm_pallas` (K4) past 16 rows:
// copy l of batch element b is A[b][:, slab l] @ B[slab l, :], the raw f32
// accumulator written once in bf16 or f32, with no epilogue.  The task
// table is gemm_spec(mb, nb, k_layers)'s at 128-row blocks (layer-major,
// gilbert within a layer), batch element by batch element, walked as the
// forward's in contiguous segments; the producer's K coordinate starts at
// the task's layer x slab and runs that slab's steps (`rep_task_slab`).  A
// slab that is not a whole number of 64-wide steps would read the next
// layer's rows into its last stage: the wrapper routes such slabs to the
// tile kernel, so no stage is zeroed.  What bounds it: at 4 x 128 prefill
// rows the products are tensor-core bound as K2's; split over k_layers
// slabs it adds the copies' bytes (L x rows x N written).

#pragma once

#include "hopper.cuh"

namespace wg {

using namespace hopper;  // mbarriers, TMA, descriptors, wgmma, tensor maps

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 288;    // two consumer warpgroups, then the producer warp
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kBM = 128;         // C tile rows, 64 a consumer warpgroup (build.py WGMMA_TILE)
constexpr int kBN = 128;         // B columns a stage of the narrow tile; the wide one's 256 (build.py WGMMA_TILE)
constexpr int kBK = 64;          // K a stage: one 128-byte swizzle row of bf16 (build.py WGMMA_BK)
constexpr int kStages = 4;
constexpr int kLaneSlots = kConsumers / 32;  // ABFT partials a task, one a consumer warp (build.py WGMMA_LANE_SLOTS)
constexpr int kTileBytesA = kBM * kBK * 2;  // 16 KB
constexpr int kBoxBytes = kBox * kBK * 2;   // one 64 x 64 bf16 TMA box, 8 KB

enum Kind { kFwd = 0, kNt = 1, kTn = 2, kRep = 3 };

// TN's flush buffer, 72 KB: 128 rows of 144 f32, one set's 128 x 128
// tile or both sets' 128 x 64 (bf16 dW: both sets' 128 x 128), each row
// padded by 8 elements so the fragments' stores and the row reads meet no
// bank conflicts.
constexpr int kTnStageBytes = kBM * (kBN + 16) * 4;

// Stages of the ring: TN's dual form keeps 3, so its flush buffer fits.
template <int KIND, int BN>
__host__ __device__ constexpr int ring_stages() {
  return KIND == kTn && BN == 2 * kBN ? 3 : kStages;
}

// Shared memory of a CTA with BN B columns a stage: the ring (aligned to
// the 1024-byte swizzle period), its barriers, the consumers' 48-float
// scratch (the reductions; the TN flush's AdamW scalars) and TN's flush
// buffer.
template <int BN, int KIND = kFwd>
constexpr int smem_bytes() {
  return 1024 + ring_stages<KIND, BN>() * (kTileBytesA + BN * kBK * 2) + 256 + (KIND == kTn ? kTnStageBytes : 0);
}
static_assert(smem_bytes<2 * kBN>() <= 232448, "over the 227 KB a block may use");
static_assert(smem_bytes<kBN, kTn>() <= 232448 && smem_bytes<2 * kBN, kTn>() <= 232448, "TN: over the 227 KB");

struct Params {
  const int* tab;  // (2, tiles): the gilbert table of one batch element's C tiles
  int tiles;       // C tiles a batch element
  int n_tasks;     // batch * tiles
  int M, N, K;     // output rows a batch element, output cols, contraction
  int b_batched;   // forward: B has a batch dimension (TMA coordinate)
  int pairs;       // NT: operand pairs (2: the dual form)
  int group;       // CTAs of a worker: they take its segment's tasks in turn
  int pair_store;  // output rows hold whole bf16 pairs (N even)
  const bf16* bias;
  const bf16* gbias;
  const bf16* res;
  bf16* out;
  bf16* out_gate;  // preact: the gate pre-activation's output
  int has_scale;
  float out_scale;
  float* chk;  // ABFT: (n_tasks, kLaneSlots) f32 partials
  const int* grp;  // grouped (K3, K9, K10): (3, n_groups) per-expert row start, row count, first 128-row block
  int n_groups;
};

// Worker w's tasks of n_tasks split over n_workers: `_block_ranges`
// (repro/core/decomposition.py), contiguous and balanced, the first
// n_tasks % n_workers workers one task more.
__device__ __forceinline__ void segment(int n_tasks, int n_workers, int w, int& lo, int& hi) {
  const int base = n_tasks / n_workers, rem = n_tasks % n_workers;
  lo = w * base + min(w, rem);
  hi = lo + base + (w < rem ? 1 : 0);
}

// Task t: its batch element, its C tile's first row and column, and the
// end of the rows it writes (M).  GROUPED: task t of the (3, tiles)
// grouped table, b its expert, row0 a row of the packed output, the rows
// ending at the expert's last.
template <int TN, bool GROUPED = false>
__device__ __forceinline__ void task_tile(const Params& p, int t, int& b, int& row0, int& col0, int& row_end) {
  if constexpr (GROUPED) {
    b = __ldg(p.tab + 2 * p.tiles + t);
    const int start = __ldg(p.grp + b);
    row0 = start + (__ldg(p.tab + t) - __ldg(p.grp + 2 * p.n_groups + b)) * kBM;
    col0 = __ldg(p.tab + p.tiles + t) * TN;
    row_end = start + __ldg(p.grp + p.n_groups + b);
  } else {
    b = t / p.tiles;
    const int j = t - b * p.tiles;
    row0 = __ldg(p.tab + j) * kBM;
    col0 = __ldg(p.tab + p.tiles + j) * TN;
    row_end = p.M;
  }
}

// TN: the token rows of batch element (expert) b, [start, start + depth),
// and their K steps; the whole contraction but in the grouped mode.
__device__ __forceinline__ void tn_task_rows(const Params& p, int b, int& start, int& depth, int& steps) {
  start = 0;
  depth = p.K;
  if (p.grp != nullptr) {
    start = __ldg(p.grp + b);
    depth = __ldg(p.grp + p.n_groups + b);
  }
  steps = (depth + kBK - 1) / kBK;
}

// kRep's launch argument, after Params (as TN's flush is, so Params and
// the other kinds' code stay as they were): the copies' slab and count,
// and their type, F32 (the unfused GLU's copies) or bf16.
template <bool F32>
struct RepOut {
  static constexpr bool kF32 = F32;
  int slab;      // K rows a layer: a whole number of kBK steps or all of K
  int k_layers;  // copies a batch element
};

// kRep: task t (of batch element b) is a tile of copy l, l row 2 of the
// (3, tiles) table; it contracts K rows [l * slab, min((l + 1) * slab, K)),
// from `start` in `steps` steps (none for a layer past K).  The wrapper
// takes this kind only where a slab is a whole number of kBK steps or all
// of K, so a stage never reads the next layer's rows: past K TMA fills
// zeros.
__device__ __forceinline__ void rep_task_slab(const Params& p, int slab, int t, int b, int& start, int& steps) {
  const int layer = __ldg(p.tab + 2 * p.tiles + (t - b * p.tiles));
  start = layer * slab;
  const int depth = min(p.K - start, slab);
  steps = depth > 0 ? (depth + kBK - 1) / kBK : 0;
}

// Two adjacent outputs (gr, gc), (gr, gc + 1) from their raw accumulators
// v (and the GLU's gate g): the arithmetic of fused_flush in its order and
// one cast (NT: the cast only), the bias rows at vec_off; masked at the
// ragged edge (rows at row_end).  ABFT: the raw values flushed join the
// thread's lane sum.
template <bool NT, bool GLU, int ACT, bool ABFT>
__device__ __forceinline__ void flush_pair(const Params& p, long long c_off, int vec_off, int row_end, int gr, int gc,
                                           const float (&v)[2], const float (&g)[2], float& lane) {
  if (gr >= row_end || gc >= p.N) return;
  const bool two = gc + 1 < p.N;
  const size_t o = static_cast<size_t>(c_off) + static_cast<size_t>(gr) * p.N + gc;
  float y[2] = {0.0f, 0.0f}, yg[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e == 1 && !two) break;
    if constexpr (ABFT) {
      lane += v[e];
      if constexpr (GLU) lane += g[e];
    }
    if constexpr (NT) {
      y[e] = v[e];
    } else {
      float x = v[e];
      if (p.bias) x += __bfloat162float(p.bias[vec_off + gc + e]);
      if constexpr (GLU) {
        float gg = g[e];
        if (p.gbias) gg += __bfloat162float(p.gbias[vec_off + gc + e]);
        if (p.out_gate) {
          yg[e] = gg;
          y[e] = x;
        } else {
          y[e] = activate<ACT>(gg) * x;
        }
      } else {
        y[e] = activate<ACT>(x);
      }
      if (p.has_scale) y[e] *= p.out_scale;
      if (p.res) y[e] += __bfloat162float(p.res[o + e]);
    }
  }
  if (two && p.pair_store) {
    *reinterpret_cast<__nv_bfloat162*>(p.out + o) = __floats2bfloat162_rn(y[0], y[1]);
    if (GLU && p.out_gate) *reinterpret_cast<__nv_bfloat162*>(p.out_gate + o) = __floats2bfloat162_rn(yg[0], yg[1]);
  } else {
    p.out[o] = __float2bfloat16(y[0]);
    if (two) p.out[o + 1] = __float2bfloat16(y[1]);
    if (GLU && p.out_gate) {
      p.out_gate[o] = __float2bfloat16(yg[0]);
      if (two) p.out_gate[o + 1] = __float2bfloat16(yg[1]);
    }
  }
}

// kRep's flush: the raw accumulator of task t (batch element b), no
// epilogue, into its tile of copy l at (b * k_layers + l) * M * N of the
// (B, L, M, N) output, a pair of adjacent columns a store (N is a multiple
// of 8, so a pair inside the output is whole), masked at the ragged edge.
template <bool F32, int ACC>
__device__ __forceinline__ void rep_flush(const Params& p, int k_layers, const float (&acc)[ACC], int t, int b,
                                          int row0, int col0, int wgi, int tw) {
  const int lane_id = tw % 32;
  const int layer = __ldg(p.tab + 2 * p.tiles + (t - b * p.tiles));
  const size_t c_off = (static_cast<size_t>(b) * k_layers + layer) * p.M * p.N;
  const int r0 = row0 + wgi * 64 + (tw / 32) * 16 + lane_id / 4;
  const int c0 = col0 + 2 * (lane_id % 4);
#pragma unroll
  for (int q = 0; q < ACC / 2; ++q) {
    const int gr = r0 + 8 * (q & 1), gc = c0 + 8 * (q >> 1);
    if (gr >= p.M || gc >= p.N) continue;
    const size_t o = c_off + static_cast<size_t>(gr) * p.N + gc;
    if constexpr (F32) {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) = make_float2(acc[2 * q], acc[2 * q + 1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p.out + o) = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    }
  }
}

// The consumer warpgroups' named barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Each v[i] summed over the 256 consumer threads in a fixed order (the
// warp's butterfly, then the 8 warps in turn through red, 8 N floats);
// the sums are thread 0's.  Every consumer thread calls it.
template <int N>
__device__ __forceinline__ void consumers_sum(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[(threadIdx.x / 32) * N + i] = v[i];
  }
  consumers_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumers / 32; ++w) s += red[w * N + i];
      v[i] = s;
    }
  }
  consumers_sync();  // red is read before the next call writes it
}

// TN grouped: zero the token rows [keep, 64) of every 64 x 64 box of a
// stage (rows are whole 128-byte lines, so the swizzle does not matter),
// then order the stores before the products' reads.  All 256 consumer
// threads take part.
template <int STAGE_BYTES>
__device__ __forceinline__ void zero_stage_rows(unsigned char* stage, int keep) {
  constexpr int kBoxes = STAGE_BYTES / kBoxBytes;
  const int per_box = (kBK - keep) * 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < kBoxes * per_box; i += kConsumers) {
    const int box = i / per_box, rem = i - box * per_box;
    *reinterpret_cast<uint4*>(stage + box * kBoxBytes + (keep + rem / 8) * 128 + (rem % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  consumers_sync();
}

// The forward and NT kinds flush in the body.
struct NoFlush {};

// The forward kind's f32-output mode (the `Flush` argument of `body`): the
// raw f32 accumulator flushed as it is, no GLU, no epilogue, no bf16
// rounding (sfc_gemm_wgmma_f32out_kernel, sfc_gemm_fused.cu).
struct OutF32 {};
template <class F>
struct IsOutF32 {
  static constexpr bool value = false;
};
template <>
struct IsOutF32<OutF32> {
  static constexpr bool value = true;
};

// OutF32's two adjacent outputs (gr, gc), (gr, gc + 1) of the (batch, M,
// N) f32 output at c_off, one 8-byte store: gc is even and N a multiple of
// 8 (TMA's rows), so a pair that starts inside the output lies inside it;
// masked at the ragged rows (row_end).  ABFT: the values join the thread's
// lane sum in flush_pair's order.
template <bool ABFT>
__device__ __forceinline__ void flush_pair_f32(const Params& p, long long c_off, int row_end, int gr, int gc,
                                               const float (&v)[2], float& lane) {
  if (gr >= row_end || gc >= p.N) return;
  if constexpr (ABFT) {
    lane += v[0];
    lane += v[1];
  }
  const size_t o = static_cast<size_t>(c_off) + static_cast<size_t>(gr) * p.N + gc;
  *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + o) = make_float2(v[0], v[1]);
}

// The whole kernel: KIND the forward, the NT dA product, the TN dW product
// or the replicated copies (kRep); GLU the forward's dual-B form (TN: the
// dual form, dC beside dC2); BN the B columns a stage (128 or 256);
// GROUPED the forward's and NT's grouped mode (K3, K9).  Maps: the
// forward's (and kRep's) A, B, (unused), B_gate (kRep: unused); NT's A, B,
// A2, B2; TN's A, dC, (unused), dC2.  TN's flush is `fl(acc, t, b, row0,
// col0, wgi, tw, red, stg)` (sfc_gemm_fused.cu), stg its flush buffer;
// kRep's `Flush` is RepOut, the copies' slab, count and type (`rep_flush`);
// the forward's OutF32 its f32-output mode (`flush_pair_f32`).
template <int KIND, bool GLU, int ACT, bool ABFT, int BN, class Flush = NoFlush, bool GROUPED = false>
__device__ __forceinline__ void body(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const CUtensorMap& tm_a2,
                                     const CUtensorMap& tm_b2, const Params& p, const Flush& fl = Flush()) {
  constexpr bool NT = KIND == kNt, TN_KIND = KIND == kTn, REP = KIND == kRep;
  constexpr bool F32_OUT = IsOutF32<Flush>::value;
  static_assert(!F32_OUT || (KIND == kFwd && !GLU && !GROUPED), "the f32 output is the plain forward product's");
  static_assert(!(NT && (GLU || ABFT)), "NT has neither the GLU form nor the lane");
  static_assert(!(REP && (GLU || ABFT || GROUPED)), "the replicated copies are single products with no lane");
  static_assert(!(TN_KIND && ABFT), "TN's lane is its flush's");
  static_assert(!(TN_KIND && GROUPED), "K10's grouped mode is TN's own (p.grp, tn_task_rows)");
  static_assert(BN == kBN || BN == 2 * kBN, "the narrow or the wide tile");
  constexpr int TN = GLU ? BN / 2 : BN;  // C columns a tile
  constexpr int ACC = BN / 2;            // f32 accumulators a consumer thread (m64nBN)
  constexpr int Q = ACC / (GLU ? 4 : 2);  // bf16 output pairs a thread flushes a tile
  constexpr int B_BYTES = BN * kBK * 2;
  constexpr int STAGE_BYTES = kTileBytesA + B_BYTES;
  constexpr int STAGES = ring_stages<KIND, BN>();
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* red = reinterpret_cast<float*>(empty + STAGES);

  // the worker (group of p.group CTAs) and this CTA's first task of its segment
  int t_lo, t_hi;
  segment(p.n_tasks, gridDim.x / p.group, blockIdx.x / p.group, t_lo, t_hi);
  const int t_first = t_lo + blockIdx.x % p.group;
  const int steps_all = (p.K + kBK - 1) / kBK;  // every task's but TN's (`tn_task_rows`)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread keeps the ring full, task after task
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_first; t < t_hi; t += p.group) {
        int b, row0, col0, row_end, start = 0, steps = steps_all;
        task_tile<TN, GROUPED>(p, t, b, row0, col0, row_end);
        if constexpr (TN_KIND) {
          int depth;
          tn_task_rows(p, b, start, depth, steps);
        }
        if constexpr (REP) rep_task_slab(p, fl.slab, t, b, start, steps);
        // B's batch coordinate: the batch element's or (grouped) the expert's
        // weights; A's: the batch element's, or 0 for the packed rows
        const int bb = GROUPED || p.b_batched ? b : 0;
        for (int pair = 0; pair < p.pairs; ++pair) {
          for (int s = 0; s < steps; ++s) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * STAGE_BYTES;
            unsigned char* sb = st + kTileBytesA;
            mbar_expect_tx(&full[stage], STAGE_BYTES);
            const int k0 = (REP ? start : 0) + s * kBK;  // kRep: from the layer's slab
            if constexpr (TN_KIND) {
              // A: C's rows [row0, row0 + 128) over the stage's token rows, as stored
              tma_load(st, &tm_a, &full[stage], row0, start + k0, 0);
              tma_load(st + kBoxBytes, &tm_a, &full[stage], row0 + kBox, start + k0, 0);
            } else {
              tma_load(st, pair ? &tm_a2 : &tm_a, &full[stage], k0, row0, GROUPED ? 0 : b);
            }
            if constexpr (NT) {
              tma_load(sb, pair ? &tm_b2 : &tm_b, &full[stage], k0, col0, GROUPED ? bb : 0);
            } else {
              // 64-column boxes: B's columns, then (GLU) B_gate's same ones
              // (TN: dC's over the stage's token rows, then dC2's)
              const int kr = TN_KIND ? start + k0 : k0;
#pragma unroll
              for (int j = 0; j < BN / kBox; ++j) {
                if (GLU && j >= BN / (2 * kBox))
                  tma_load(sb + j * kBoxBytes, &tm_b2, &full[stage], col0 + (j - BN / (2 * kBox)) * kBox, kr,
                           GROUPED ? bb : 0);
                else
                  tma_load(sb + j * kBoxBytes, &tm_b, &full[stage], col0 + j * kBox, kr, bb);
              }
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wgi owns rows [64 wgi, 64 wgi + 64) of the tile
  const int wgi = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int lane_id = tw % 32;
  float acc[ACC];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_first; t < t_hi; t += p.group) {
    int b, row0, col0, row_end, depth = p.K, steps = steps_all;
    task_tile<TN, GROUPED>(p, t, b, row0, col0, row_end);
    if constexpr (TN_KIND) {
      int start;
      tn_task_rows(p, b, start, depth, steps);
    }
    if constexpr (REP) {
      int start;
      rep_task_slab(p, fl.slab, t, b, start, steps);
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    int prev = -1;  // the stage whose products may still be in flight
    for (int pair = 0; pair < p.pairs; ++pair) {
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        if (TN_KIND && p.grp != nullptr && depth - s * kBK < kBK)
          zero_stage_rows<STAGE_BYTES>(ring + stage * STAGE_BYTES, depth - s * kBK);
        const uint32_t a_base = smem_u32(ring + stage * STAGE_BYTES) + wgi * (kTileBytesA / 2);
        const uint32_t b_base = smem_u32(ring + stage * STAGE_BYTES + kTileBytesA);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: K-major rows of 128 B, 8-row groups 1024 B apart, 32 B a k16;
          // TN: the warpgroup's 64 x 64 box M-major, 8-row token groups
          // 1024 B apart, 2048 B a k16
          const uint64_t da = TN_KIND ? desc_sw128(a_base + kk * 2048, kBoxBytes, 1024)
                                      : desc_sw128(a_base + kk * 32, 16, 1024);
          // B: NT K-major as A; the forward (and TN) N-major, 64-column
          // boxes 8 KB apart (LBO), 8-row K groups 1024 B apart, 2048 B a k16
          const uint64_t db = NT ? desc_sw128(b_base + kk * 32, 16, 1024)
                                 : desc_sw128(b_base + kk * 2048, kBoxBytes, 1024);
          wgmma_tile<NT ? 0 : 1, TN_KIND ? 1 : 0>(acc, da, db);
        }
        wgmma_commit();
        // one group stays in flight: the previous step's products are done,
        // so its stage goes back to the producer
        wgmma_wait<1>();
        fence_acc(acc);
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    if constexpr (TN_KIND) {
      fl(acc, t, b, row0, col0, wgi, tw, red, ring + STAGES * STAGE_BYTES + 256);
      continue;
    }
    if constexpr (REP) {
      rep_flush<Flush::kF32>(p, fl.k_layers, acc, t, b, row0, col0, wgi, tw);
      continue;
    }

    // the flush: accumulator pair q holds rows r0 + 8 (q & 1), cols c0 + 8 (q >> 1) (+1);
    // the GLU's gate pair sits ACC / 2 registers further
    const int r0 = row0 + wgi * 64 + (tw / 32) * 16 + lane_id / 4;
    const int c0 = col0 + 2 * (lane_id % 4);
    // grouped: the packed rows, expert b's bias rows
    const long long c_off = GROUPED ? 0 : static_cast<long long>(b) * p.M * p.N;
    const int vec_off = GROUPED ? b * p.N : 0;
    float lane = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float v[2] = {acc[2 * q], acc[2 * q + 1]};
      const float g[2] = {GLU ? acc[2 * q + ACC / 2] : 0.0f, GLU ? acc[2 * q + ACC / 2 + 1] : 0.0f};
      if constexpr (F32_OUT)
        flush_pair_f32<ABFT>(p, c_off, row_end, r0 + 8 * (q & 1), c0 + 8 * (q >> 1), v, lane);
      else
        flush_pair<NT, GLU, ACT, ABFT>(p, c_off, vec_off, row_end, r0 + 8 * (q & 1), c0 + 8 * (q >> 1), v, g, lane);
    }
    if constexpr (ABFT) {
      // each consumer warp's sum into a slot of its own: no barrier, so
      // the warpgroups run as free of each other as without the lane
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lane += __shfl_xor_sync(0xffffffffu, lane, o);
      if (lane_id == 0) p.chk[static_cast<size_t>(t) * kLaneSlots + threadIdx.x / 32] = lane;
    }
  }
}

// ---------------------------------------------------------------------------
// the host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// One launch of `kernel` (of kind KIND, B columns BN a stage) over `ctas`
// persistent CTAs; `extra` (the TN kernels' flush) follows the Params
// argument.
template <int BN, int KIND = kFwd, typename Kernel, typename... Extra>
static int launch(Kernel kernel, bool* opted_in, int ctas, cudaStream_t s, const CUtensorMap& m0,
                  const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& m3, const Params& p,
                  const Extra&... extra) {
  if (p.group < 1 || ctas < p.group || ctas % p.group != 0 || ctas / p.group > p.n_tasks)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = smem_bytes<BN, KIND>();
  const int rc = opt_in(kernel, bytes, opted_in);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(ctas), kThreads, bytes, s>>>(m0, m1, m2, m3, p, extra...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
