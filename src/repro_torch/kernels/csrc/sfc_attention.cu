// SFC-scheduled attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Four kernels, each with a plain C entry point per (input type, head dim):
//
// flash_fwd_kernel replaces two TPU kernels:
//   * `repro/kernels/sfc_attention.py::sfc_flash_fwd` (`_flash_fwd_kernel`):
//     the band-table online-softmax flash forward that returns (o, lse);
//   * `repro/kernels/flash_attention.py::flash_attention_pallas`
//     (`_flash_kernel`): the dense-grid causal flash forward with no lse.
//   Both compute, per q row at global position q_offset + i,
//     o = softmax(scale * q k^T, masked) v,   lse = m + log(l)
//   with the f32 online softmax of the TPU kernels (masked scores are
//   -1e30, the final division guards l with max(l, 1e-30)).  They differ
//   only in the k order inside a q row, which is the task table the wrapper
//   uploads: the serpentine band of `core/schedule.py::attention_spec` for
//   the first, ascending k tiles for the second (which also stores no lse).
//
//   Grid: blockIdx.x is the band row (a 64-row q tile), blockIdx.y the
//   (batch, q head) pair.  The CTA walks its row's segment of the task table
//   [row_start[iq], row_start[iq + 1]) in table order, so the curve order
//   survives inside each row; the TPU grid's sequential task dimension, which
//   carried the accumulator from step to step, becomes this loop, and the
//   accumulator stays on the SM.  q, k and v are read in the model's
//   (B, S, H, D) layout through strides; a q head reads kv head h / groups,
//   so grouped K/V are never expanded.  Nothing is padded: rows past the
//   tensors' ends load as zeros and the masks (kpos < seq_k, qpos < seq_q,
//   causal kpos <= qpos + q_offset) do the rest, as in `_tile_mask`.
//
//   The q tile is staged in shared memory once, k and v tiles stream through
//   it.  Warp w owns q rows [16w, 16w + 16): its S = q k^T strip, its softmax
//   state (two lanes a row, in registers) and its rows of the f32 output
//   accumulator, so after each k/v tile lands the four warps run without
//   block barriers.  bf16 products go to the tensor cores through WMMA
//   16x16x16 fragments (P is rounded to bf16 for P v, as every bf16 flash
//   kernel does); f32 products are SIMT FMAs in full f32.
//
//   What bounds it on the H100 (derived from the H100 SXM data sheet's
//   3.35 TB/s and 989 TFLOP/s bf16): at the server's prefill (4 x 128
//   tokens, 32 q / 8 kv heads, D = 128, bf16) it reads q, k, v and writes o
//   and lse, 10.7 MB a layer, 3.2 us; its causal band is 0.54 GFLOP,
//   0.55 us: bytes bound it.  At 1 x 2000 tokens the band's 33 GFLOP bound
//   it instead.  What it leaves on the
//   table: no wgmma, TMA or multi-stage pipeline, so loads and math do not
//   overlap; the f32 accumulator round-trips through shared memory each k
//   tile (WMMA fragments have no documented element layout to rescale in
//   registers); and each CTA re-reads its kv head's k and v once per q head
//   of the group (from L2).
//
// decode_split_kernel replaces `repro/kernels/sfc_attention.py::
//   sfc_decode_attention_pallas` (:660, `_decode_kernel` :601): one launch
//   for the whole (batch, head) fan-out of a decode step, the kv head's GQA
//   group as its rows (padded only to the next of 1, 2, 4, 8, 16).  Each
//   sequence's live length valid_len[b] is read on the device and clamped
//   to [0, T], so rows past the live cache are never read and the host never
//   waits for the length; the cache is read in place in its stored (B, T,
//   Hkv, D) layout.  valid_len 0 gives zeros, as the TPU kernel's
//   max(l, 1e-30) does.
//
//   What bounds it: the bytes of the live cache (k and v, 2 x valid x D per
//   kv head) at 3.35 TB/s.  The first port ran one CTA per (batch, kv head),
//   4 x 8 = 32 CTAs on 132 SMs, each walking its cache serially with 8-byte
//   reads and three barriers a 64-row chunk: 1.67 ms on an H100
//   (chip_smoke.py) where the 4096-row check row's bytes take 8.8 us.  So
//   the wrapper cuts the capacity T into S segments of whole 64-row chunks
//   (S a function of the batch, the kv heads, T and the SM count, never of
//   valid_len: 2 CTAs an SM, at most a chunk each and 8) and launches
//   batch x Hkv clusters of S CTAs, still one launch.  Each CTA streams its
//   segment's live rows through a ring of 32-row (k, v) tiles with 16-byte
//   cp.async copies (at bf16 D 128, 4 stages: three 16 KB tiles in
//   flight).  Its eight warps take four rows of each tile apiece, each with
//   its own copies, its own online softmax of the group's rows in f32 on
//   the CUDA cores and no block barrier in the loop (with two barriers a
//   tile and the softmax shared by the CTA, a tile took as long on an idle
//   card as on a busy one: the warps waited on one another).  2 D bytes a
//   cache row carry 4 G D flops: at G <= 16 the FMAs stay under the byte
//   time, so there is no tensor-core path.  The warps' states merge in
//   warp order; after cluster.sync() the leader merges the segments' (m,
//   l, acc) in segment order, m* = max m_s, l = sum l_s e^(m_s - m*), o =
//   sum acc_s e^(m_s - m*) / max(l, 1e-30), reading its peers through
//   distributed shared memory: no atomics, no scratch in HBM, the same
//   result from run to run.  A segment with no live row reads nothing and
//   weighs nothing (m = -1e30, l = 0, acc = 0; e^(m_s - m*) is then 0, or 1
//   times zeros when no segment is live), so an empty cache still gives
//   zeros, not NaN.  At the server's 145-row cache (S = 3, 96 CTAs of two
//   tiles each) the launch and the cluster barrier bound it.
//
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel replace the training
//   backward `repro/kernels/sfc_attention.py::sfc_flash_bwd_dq`
//   (`_flash_bwd_dq_kernel`, K12) and `sfc_flash_bwd_dkv`
//   (`_flash_bwd_dkv_kernel`, K13).  Both recompute the (p, ds) prelude of
//   `_bwd_p_ds` per tile from the forward's lse and delta = rowsum(dO * O):
//     p = exp(scale * q k^T - lse) masked,  ds = p * (dO v^T - delta),
//   then dQ = scale * sum ds k over the q-major band (one CTA per q tile and
//   q head), dV = sum p^T dO and dK = scale * sum ds^T q over the k-major
//   band with the GQA group innermost (one CTA per k tile and kv head, the
//   two accumulators in shared memory for the whole walk: no atomics, no
//   per-q-head copies).  P, dS and the f32 accumulators go through shared
//   memory, as O does in the forward; in bf16, P and dS enter the tensor
//   cores as hi + lo bf16 pairs (store_split), so the gradients, sums that
//   cancel, keep f32 operands to about 2^-16.  No padding: loads past the
//   tensors' ends are zeros and the masks do the rest.
//
//   What bounds them on the H100: at the training step's shape (2 x 256
//   tokens, 32 / 8 heads, D 128, bf16, causal) K12 moves about 14.8 MB (q,
//   k, v, dO, lse, delta in, dQ out), 4.4 us at 3.35 TB/s, against 6 D
//   flops per attended pair (S, dP, dS k), 1.6 GFLOP, 1.6 us at the bf16
//   peak; K13 moves 12.7 MB (3.8 us) against 8 D flops a pair (2.2 us):
//   bytes bound both.  What they leave on the
//   table is the forward's: no wgmma, TMA or pipeline, and the products of S
//   and dP are recomputed by both kernels.  They stay for f32 (chip_smoke's
//   f32 gradient check), for GQA groups past 8 and for what TMA cannot
//   describe (`kernels/sfc_attention.py::uses_bwd_wgmma_kernel`).
//
// flash_bwd_dq_wgmma_kernel (K12) and flash_bwd_dkv_wgmma_kernel (K13) take
//   every other bf16 backward, with the same contract and tiles, on
//   Hopper's own machinery (hopper.cuh): a producer warp keeps TMA loads of
//   the model's strided (B, S, H, D) views (4-D tensor maps, 64-column
//   boxes, 128-byte swizzle, zeros past S and T) in flight through a ring of
//   full / empty mbarrier stages, and one consumer warpgroup runs wgmma (bf16
//   in, f32 accumulators) on 64 rows.  S, P, dP and dS live in the
//   accumulators' registers: an m64nN accumulator and wgmma's k16 A
//   fragment share their element layout, so P and dS enter the next product
//   from registers as their hi and lo bf16 fragments (store_split's pairs,
//   two wgmma a product) and never touch shared memory; dQ, dK and dV stay in
//   registers for the whole walk.  K13 computes the transposed strips S^T =
//   k q^T and dP^T = v dO^T (the k rows as M), with lse and delta indexed
//   by the q column, staged beside each q tile.  The GQA group, which kept
//   the tile kernel to 64 CTAs on 132 SMs at the training step, is split
//   across a cluster of C CTAs, each walking its part of the group's q
//   heads (C 2 there: 128 CTAs, one wave); after the walk the CTAs sum
//   their f32 partials in rank order through distributed shared memory
//   (the order `sfc_flash_bwd_dkv_plain(group_parts=C)` takes).  Both are
//   one launch, deterministic, with no atomics and no HBM scratch, and keep
//   nothing on the device between launches.  ptxas: K13 252 registers at
//   D 128 (one CTA an SM), K12 194 (two), 0 spills.
//
// One compilation unit holds one input type, chosen by -DSFC_ATTN_DTYPE
// (0: float32, 1: bfloat16) and named by -DSFC_ATTN_TAG, and one half,
// chosen by -DSFC_ATTN_PART (0: flash forward and decode, 1: the backward;
// the bf16 backward also holds the wgmma kernels), with the head dims 64
// and 128 (`repro_torch/kernels/build.py` builds all four parts at once).
// Every entry launches on the caller's stream and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the driver's encoder is fetched at run time: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <chrono>

#include "cuda_common.cuh"

#ifndef SFC_ATTN_DTYPE
#define SFC_ATTN_DTYPE 1
#endif
#ifndef SFC_ATTN_TAG
#define SFC_ATTN_TAG bf16
#endif
#ifndef SFC_ATTN_PART  // 0: flash forward and decode; 1: the backward (dq, dkv)
#define SFC_ATTN_PART 0
#endif

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;  // q rows of a tile (keep in step with build.py ATTN_TILE)
constexpr int kBK = 64;  // k rows of a tile
constexpr int kFwdThreads = 128;  // 4 warps x 16 q rows
constexpr int kDecChunk = 64;     // cache rows a decode segment is a multiple of (build.py DECODE_CHUNK)
constexpr int kMaxGroups = 16;    // GQA rows a decode CTA holds (build.py MAX_DECODE_GROUPS)
constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// shared-memory row pad: keeps rows 16-byte aligned (WMMA needs ld % 8 for
// bf16, % 4 for f32) and spreads banks
template <typename T>
constexpr int pad() {
  return 16 / (int)sizeof(T);
}

constexpr size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// dynamic shared memory of the forward kernel: q, k, v tiles in T, the f32
// score strip, P in T, the f32 output accumulator
template <typename T, int D>
struct FwdSmem {
  static constexpr int LDQ = D + pad<T>();    // q, k, v rows
  static constexpr int LDS = kBK + 4;         // f32 scores
  static constexpr int LDP = kBK + pad<T>();  // probabilities
  static constexpr int LDO = D + 4;           // f32 accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = align128(Q + (size_t)kBQ * LDQ * sizeof(T));
  static constexpr size_t V = align128(K + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t S = align128(V + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t P = align128(S + (size_t)kBQ * LDS * sizeof(float));
  static constexpr size_t O = align128(P + (size_t)kBQ * LDP * sizeof(T));
  static constexpr size_t BYTES = align128(O + (size_t)kBQ * LDO * sizeof(float));
};

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // (B, S, H, D) contiguous, input type
  float* lse;        // (B, S, H) contiguous f32, or null
  const int* tab_k;  // k tile of each task, rows back to back
  const int* row_start;  // (nq + 1): row iq's tasks are [row_start[iq], row_start[iq + 1])
  int S, T;          // rows of q and of k / v
  int seq_q, seq_k;  // mask extents (<= S, T)
  int H, groups, q_offset, causal;
  long long q_sb, q_ss, q_sh;  // element strides of q (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
};

// Stage rows [r0, r0 + ROWS) of one head (row stride ss, D contiguous
// elements) into shared memory with row stride LDS, zeros past nrows.  The
// wrapper guarantees 16-byte aligned rows.
template <typename T, int D, int ROWS, int LDS>
__device__ __forceinline__ void load_rows(T* __restrict__ s, const T* __restrict__ g, long long ss,
                                          int r0, int nrows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kFwdThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) v = __ldg(reinterpret_cast<const uint4*>(g + (long long)(r0 + r) * ss + c));
    *reinterpret_cast<uint4*>(s + r * LDS + c) = v;
  }
}

// S strip of warp w: rows [16w, 16w + 16) of q k^T into Ss (f32, unscaled).
template <int D, int LDQ, int LDS>
__device__ __forceinline__ void scores(const bf16* Qs, const bf16* Ks, float* Ss, int warp, int) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk, LDQ);
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      // k^T as a column-major B operand: element (kk + i, j) is Ks[j][kk + i]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Ks + n * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) {
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
  }
}

// f32: lane pair (row r, half) computes the row's columns half, half + 2, ...
template <int D, int LDQ, int LDS>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, float* Ss, int warp,
                                       int lane) {
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  float acc[kBK / 2];
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float q = Qs[r * LDQ + d];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) acc[j] = fmaf(q, Ks[(half + 2 * j) * LDQ + d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) Ss[r * LDS + half + 2 * j] = acc[j];
}

// O strip of warp w: O = O * alpha + P v.  bf16 on the tensor cores.
template <int D, int LDQ, int LDP, int LDO>
__device__ __forceinline__ void accumulate_pv(const bf16* Ps, const bf16* Vs, float* Os, int warp,
                                              int lane, float alpha) {
  using namespace nvcuda;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
#pragma unroll 8
  for (int j = 0; j < D / 2; ++j) Os[r * LDO + half + 2 * j] *= alpha;
  __syncwarp();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) wmma::load_matrix_sync(p[kk], Ps + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    float* optr = Os + warp * 16 * LDO + n * 16;
    wmma::load_matrix_sync(o, optr, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, Vs + kk * 16 * LDQ + n * 16, LDQ);
      wmma::mma_sync(o, p[kk], b, o);
    }
    wmma::store_matrix_sync(optr, o, LDO, wmma::mem_row_major);
  }
}

// f32: SIMT, lane pair (row r, half) owns the row's columns half, half + 2, ...
template <int D, int LDQ, int LDP, int LDO>
__device__ __forceinline__ void accumulate_pv(const float* Ps, const float* Vs, float* Os, int warp,
                                              int lane, float alpha) {
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = Os[r * LDO + half + 2 * j] * alpha;
  for (int kk = 0; kk < kBK; ++kk) {
    const float p = Ps[r * LDP + kk];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = fmaf(p, Vs[kk * LDQ + half + 2 * j], o[j]);
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) Os[r * LDO + half + 2 * j] = o[j];
}

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_kernel(const FwdParams p) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int iq = blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / p.groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int qpos = iq * kBQ + r;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows<T, D, kBQ, L::LDQ>(Qs, q, p.q_ss, iq * kBQ, p.S);
#pragma unroll 8
  for (int j = 0; j < D / 2; ++j) Os[r * L::LDO + half + 2 * j] = 0.0f;
  // running max and sum of this lane's row (both lanes of a row agree)
  float m_run = kNeg, l_run = 0.0f;

  const int t0 = __ldg(p.row_start + iq), t1 = __ldg(p.row_start + iq + 1);
  for (int t = t0; t < t1; ++t) {
    const int ik = __ldg(p.tab_k + t);
    __syncthreads();  // every warp is done with the previous k / v tile
    load_rows<T, D, kBK, L::LDQ>(Ks, k, p.k_ss, ik * kBK, p.T);
    load_rows<T, D, kBK, L::LDQ>(Vs, v, p.v_ss, ik * kBK, p.T);
    __syncthreads();

    scores<D, L::LDQ, L::LDS>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    // online softmax over the row's 64 scores, two lanes a row
    float s[kBK / 2];
    float smax = kNeg;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int kpos = ik * kBK + half + 2 * j;
      const bool ok = kpos < p.seq_k && qpos < p.seq_q && (!p.causal || kpos <= qpos + p.q_offset);
      s[j] = ok ? Ss[r * L::LDS + half + 2 * j] * p.scale : kNeg;
      smax = fmaxf(smax, s[j]);
    }
    smax = fmaxf(smax, __shfl_xor_sync(kFull, smax, 1));
    const float m_new = fmaxf(m_run, smax);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const float e = expf(s[j] - m_new);
      Ps[r * L::LDP + half + 2 * j] = from_f32<T>(e);
      sum += e;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

    accumulate_pv<D, L::LDQ, L::LDP, L::LDO>(Ps, Vs, Os, warp, lane, alpha);
    __syncwarp();
  }
  __syncwarp();

  // flush: a warp writes each of its rows with 32 lanes along D
  T* o = static_cast<T*>(p.o);
  for (int rr = 0; rr < 16; ++rr) {
    const float l_r = fmaxf(__shfl_sync(kFull, l_run, 2 * rr), kTiny);
    const float m_r = __shfl_sync(kFull, m_run, 2 * rr);
    const int row = warp * 16 + rr;
    const int pos = iq * kBQ + row;
    if (pos >= p.S) continue;  // warp-uniform
    const long long base = ((long long)b * p.S + pos) * p.H + h;
    for (int c = lane; c < D; c += 32) o[base * D + c] = from_f32<T>(Os[row * L::LDO + c] / l_r);
    if (p.lse != nullptr && lane == 0) p.lse[base] = m_r + logf(l_r);
  }
}

struct DecodeParams {
  const void* q;      // (B, 1, H, D) contiguous
  const void* k;      // (B, T, Hkv, D) strided, D contiguous
  const void* v;
  const int* valid;   // (B,) live cache lengths, on the device
  void* o;            // (B, 1, H, D) contiguous
  int H, Hkv, groups, T;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
};

// ---------------------------------------------------------------------------
// decode, split over the cache: one cluster of S CTAs per (batch, kv head)
// ---------------------------------------------------------------------------

constexpr int kDecTile = 32;      // cache rows per stage of the decode kernel's ring
constexpr int kDecThreads = 256;  // eight warps, four rows of a tile each
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxSplits = 8;     // segments of a cache, a portable cluster (build.py MAX_DECODE_SPLITS)

// the f32 values of one 16-byte chunk of a cache row
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// CPL consecutive elements of a cache row (8 or 16 bytes, aligned), as f32
template <int CPL>
__device__ __forceinline__ void load_cols(const unsigned char* p, float* out, bf16*) {
  static_assert(CPL == 2 || CPL == 4, "two or four columns a lane");
  if constexpr (CPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
}
template <int CPL>
__device__ __forceinline__ void load_cols(const unsigned char* p, float* out, float*) {
  if constexpr (CPL == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  }
}

// Dynamic shared memory of decode_split_kernel<T, D, KG>: the ring of
// (k, v) tiles (after the loop, the warps' states), then f32 arrays.  A
// row's pitch is its bytes + 64.
template <typename T, int D, int KG>
struct DecSplitSmem {
  static constexpr int ROW = D * (int)sizeof(T);
  static constexpr int PITCH = ROW + 64;
  static constexpr int NCH = ROW / 16;              // 16-byte chunks a row
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int ROWS_W = kDecTile / kDecWarps;  // rows a warp takes of a tile
  static constexpr int CPL = D / 32;                // P v columns a lane
  static constexpr int TILE = kDecTile * PITCH;
  static constexpr int STAGE = 2 * TILE;            // the k tile, then the v tile
  static constexpr int STAGES = 96 * 1024 / STAGE >= 4 ? 4 : (96 * 1024 / STAGE >= 3 ? 3 : 2);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int WACC_BYTES = 4 * kDecWarps * KG * D;  // the warps' acc [8][KG][D], over the ring
  static constexpr int Q = (RING > WACC_BYTES ? RING : WACC_BYTES) / 4;  // float offsets: q (scaled) [KG][D]
  static constexpr int P = Q + KG * D;              // the warps' probabilities [8][4][KG]
  static constexpr int WM = P + kDecWarps * ROWS_W * KG;  // the warps' m [8][KG]
  static constexpr int WL = WM + kDecWarps * KG;    // the warps' l [8][KG]
  static constexpr int PART = WL + kDecWarps * KG;  // the segment's m [KG], l [KG]
  static constexpr int BYTES = 4 * (PART + 2 * KG);
  static_assert(NCH % 8 == 0 && ROWS_W * 8 == 32, "a warp's rows are four, eight lanes a row");
};

// One CTA per (batch, kv head, segment); the segments of a (batch, kv
// head) are the S CTAs of one cluster, rank s taking cache rows
// [s * seg, (s + 1) * seg) clipped to T and to valid_len[b].  The CTA's
// eight warps run on their own, with no block barrier in the loop: warp w
// takes rows 4w..4w+3 of every 32-row tile, streams them through its part
// of a cp.async ring (its own commit groups, one __syncwarp a tile) and
// keeps its own online softmax of the group's KG rows (G padded to KG with
// zero q rows, whose outputs are not written) in f32 on the CUDA cores:
// lane (row, eighth) takes every eighth 16-byte chunk of k for the scores
// (joined by shuffles); for P v each lane owns D / 32 columns and takes
// each row's probabilities by shuffle.  After the loop the warps' states
// merge in warp order, then the leader (rank 0) merges the segments' (m,
// l, acc) in segment order through distributed shared memory and writes o.
// A segment with no live row keeps m = -1e30, l = 0, acc = 0, so it weighs
// nothing, and a group with no live row at all gives zeros.
// Two CTAs an SM (128 registers) for the groups of up to four rows, whose
// q columns sit in registers; one for the larger groups.
template <typename T, int D, int KG>
__global__ void __launch_bounds__(kDecThreads, KG <= 4 ? 2 : 1)
    decode_split_kernel(const DecodeParams p, const int seg) {
  using L = DecSplitSmem<T, D, KG>;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* fs = reinterpret_cast<float*>(dec_smem);
  float* wacc = fs;  // [kDecWarps][KG][D]; after the warp merge, [0] holds the segment's acc
  float* qs = fs + L::Q;
  float* ps = fs + L::P + (int)(threadIdx.x >> 5) * L::ROWS_W * KG;  // this warp's four rows
  float* wm = fs + L::WM;
  float* wl = fs + L::WL;
  float* pm = fs + L::PART;
  float* pl = pm + KG;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int bh = blockIdx.x / splits;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int G = p.groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int valid = min(max(__ldg(p.valid + b), 0), p.T);
  const long long s0 = (long long)s * seg;
  const int end = (int)min(min(s0 + seg, (long long)p.T), (long long)valid);
  const int ntiles = end > s0 ? (int)((end - s0 + kDecTile - 1) / kDecTile) : 0;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int row_w = warp * L::ROWS_W;  // the warp's first row of a tile

  // the warp's k and v rows of tile i into its stage of the ring, rows at
  // or past `end` zero-filled (so 0 * v stays 0); one commit group a call
  auto issue = [&](int i) {
    if (i < ntiles) {
      unsigned char* st = dec_smem + (i % L::STAGES) * L::STAGE;
      const long long r0 = s0 + (long long)i * kDecTile + row_w;
#pragma unroll
      for (int c = lane; c < 2 * L::ROWS_W * L::NCH; c += 32) {
        const int kv = c / (L::ROWS_W * L::NCH), rem = c % (L::ROWS_W * L::NCH);
        const int r = rem / L::NCH, ch = rem % L::NCH;
        const bool live = r0 + r < end;
        const long long row = live ? r0 + r : s0;
        const T* src = kv ? v + row * p.v_st : k + row * p.k_st;
        cp_async16(st + kv * L::TILE + (row_w + r) * L::PITCH + ch * 16, src + ch * L::EPC, live);
      }
    }
    cp_async_commit();
  };

  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + hk * G) * D;
  // scores in the log2 domain (q scaled by log2 e), so exp2f gives e^(s - m)
  const float qscale = p.scale * kLog2e;
  for (int e = tid; e < KG * D; e += kDecThreads) qs[e] = e / D < G ? to_f32(q[e]) * qscale : 0.0f;
#pragma unroll
  for (int i = 0; i < L::STAGES - 1; ++i) issue(i);
  __syncthreads();  // q is in shared memory

  float m_run[KG], l_run[KG], acc[KG][L::CPL];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m_run[g] = kNeg;
    l_run[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < L::CPL; ++c) acc[g][c] = 0.0f;
  }
  const int r4 = lane >> 3, eighth = lane & 7;
  // up to four group rows, the lane's q columns live in registers: read
  // from shared memory every tile they were the kernel's busiest traffic
  // (eight lanes' 16-byte reads 32 bytes apart, two to a bank)
  constexpr bool kQRegs = KG <= 4;
  float qr[kQRegs ? KG : 1][L::NCH / 8][L::EPC];
  if constexpr (kQRegs) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
#pragma unroll
      for (int j = 0; j < L::NCH / 8; ++j) {
#pragma unroll
        for (int e = 0; e < L::EPC; ++e) qr[g][j][e] = qs[g * D + (eighth + 8 * j) * L::EPC + e];
      }
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<L::STAGES - 2>();
    __syncwarp();  // the warp's rows of tile i have landed; every lane is done with tile i - 1
    issue(i + L::STAGES - 1);
    const unsigned char* st = dec_smem + (i % L::STAGES) * L::STAGE;
    // scores of the lane's row: eight lanes a row, each every eighth chunk
    float dot[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) dot[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < L::NCH / 8; ++j) {
      const int ch = eighth + 8 * j;
      float kf[L::EPC];
      unpack16(*reinterpret_cast<const uint4*>(st + (row_w + r4) * L::PITCH + ch * 16), kf,
               static_cast<T*>(nullptr));
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e) dot[g] = fmaf(qr[g][j][e], kf[e], dot[g]);
        } else {
#pragma unroll
          for (int e = 0; e < L::EPC; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + g * D + ch * L::EPC + e);
            dot[g] = fmaf(q4.x, kf[e], dot[g]);
            dot[g] = fmaf(q4.y, kf[e + 1], dot[g]);
            dot[g] = fmaf(q4.z, kf[e + 2], dot[g]);
            dot[g] = fmaf(q4.w, kf[e + 3], dot[g]);
          }
        }
      }
    }
    const bool live = s0 + (long long)i * kDecTile + row_w + r4 < end;
    // the warp's online softmax over its four rows
    float pr[KG];
#pragma unroll
    for (int g = 0; g < KG; ++g) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) dot[g] += __shfl_xor_sync(kFull, dot[g], off);
      float mx = live ? dot[g] : kNeg;
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
      const float m_new = fmaxf(m_run[g], mx);
      pr[g] = live ? exp2f(dot[g] - m_new) : 0.0f;
      if (eighth == 0) ps[r4 * KG + g] = pr[g];
      float sum = pr[g];
      sum += __shfl_xor_sync(kFull, sum, 8);
      sum += __shfl_xor_sync(kFull, sum, 16);
      const float alpha = exp2f(m_run[g] - m_new);
      l_run[g] = l_run[g] * alpha + sum;
      m_run[g] = m_new;
#pragma unroll
      for (int c = 0; c < L::CPL; ++c) acc[g][c] *= alpha;
    }
    __syncwarp();  // the four rows' probabilities
    // P v over the warp's four rows: the lane's D / 32 columns
    const unsigned char* vt = st + L::TILE + row_w * L::PITCH + lane * L::CPL * (int)sizeof(T);
#pragma unroll
    for (int rr = 0; rr < L::ROWS_W; ++rr) {
      float x[L::CPL];
      load_cols<L::CPL>(vt + rr * L::PITCH, x, static_cast<T*>(nullptr));
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float pg = ps[rr * KG + g];
#pragma unroll
        for (int c = 0; c < L::CPL; ++c) acc[g][c] = fmaf(pg, x[c], acc[g][c]);
      }
    }
  }

  // the warps' states, merged in warp order into the segment's (m, l, acc)
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int g = 0; g < KG; ++g) {
#pragma unroll
    for (int c = 0; c < L::CPL; ++c) wacc[(warp * KG + g) * D + lane * L::CPL + c] = acc[g][c];
    if (lane == 0) {
      wm[warp * KG + g] = m_run[g];
      wl[warp * KG + g] = l_run[g];
    }
  }
  __syncthreads();
  if (tid < KG) {
    float m = wm[tid];
    for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, wm[w * KG + tid]);
    float l = 0.0f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float e = exp2f(wm[w * KG + tid] - m);
      wm[w * KG + tid] = e;  // now the warp's weight
      l += wl[w * KG + tid] * e;
    }
    pm[tid] = m;
    pl[tid] = l;
  }
  __syncthreads();
  for (int e = tid; e < KG * D; e += kDecThreads) {
    const int g = e / D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) a += wacc[w * KG * D + e] * wm[w * KG + g];
    wacc[e] = a;  // the segment's acc [KG][D]
  }
  cluster.sync();  // every segment's state is visible to the cluster
  if (s == 0) {
    float* wts = wm;  // [kMaxSplits][KG] segment weights e^(m_s - m*)
    float* den = wl;  // [KG] max(l, 1e-30)
    if (tid < G) {
      float ms[kMaxSplits], ls[kMaxSplits];
      float mstar = kNeg;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j < splits) {
          ms[j] = cluster.map_shared_rank(pm, j)[tid];
          ls[j] = cluster.map_shared_rank(pl, j)[tid];
          mstar = fmaxf(mstar, ms[j]);
        }
      }
      float l = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j < splits) {
          const float w = exp2f(ms[j] - mstar);
          wts[j * KG + tid] = w;
          l += ls[j] * w;
        }
      }
      den[tid] = fmaxf(l, kTiny);
    }
    __syncthreads();
    T* o = static_cast<T*>(p.o) + ((long long)b * p.H + hk * G) * D;
    for (int e = tid; e < G * D; e += kDecThreads) {
      const int g = e / D;
      float part[kMaxSplits];
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) part[j] = j < splits ? cluster.map_shared_rank(wacc, j)[e] : 0.0f;
      float num = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j < splits) num += part[j] * wts[j * KG + g];
      }
      o[e] = from_f32<T>(num / den[g]);
    }
  }
  cluster.sync();  // the peers keep their shared memory until the leader has read it
}

// ---------------------------------------------------------------------------
// backward: dQ (K12) and dK / dV (K13)
// ---------------------------------------------------------------------------

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;      // dO, laid out as q
  const float* lse;      // (B, S, H) contiguous f32, from the forward
  const float* delta;    // (B, S, H) contiguous f32: rowsum(dO * O)
  void* dq;              // (B, S, H, D) contiguous, input type
  void* dk;              // (B, T, Hkv, D) contiguous, input type
  void* dv;
  const int* tab_minor;  // the other tile of each task, rows back to back
  const int* row_start;  // (n_rows + 1): row r's tasks are [row_start[r], row_start[r + 1])
  int S, T, seq_q, seq_k;
  int H, Hkv, groups, q_offset, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  float scale;
};

__device__ __forceinline__ bool attn_valid(const BwdParams& p, int qpos, int kpos) {
  return kpos < p.seq_k && qpos < p.seq_q && (!p.causal || kpos <= qpos + p.q_offset);
}

// An f32 operand x of a bf16 tensor-core product is stored as the pair
// hi = bf16(x), lo = bf16(x - hi), and the product runs on both: x k =
// hi k + lo k to about 2^-16 of |x|, where hi alone would carry x's bf16
// rounding (2^-9) into sums that cancel, as dQ, dK and dV do.  In f32 the
// SIMT products take x as it is.
template <typename T>
__host__ __device__ constexpr bool split_operand() {
  return sizeof(T) == 2;
}

template <typename T>
__device__ __forceinline__ void store_split(T* hi, T* lo, float x) {
  const T h = from_f32<T>(x);
  *hi = h;
  if constexpr (split_operand<T>()) *lo = from_f32<T>(x - to_f32(h));
}

// dynamic shared memory of the dQ kernel: q, dO, k, v tiles in T; the f32
// score and dP strips; dS in T (hi and, in bf16, lo); the f32 dQ
// accumulator
template <typename T, int D>
struct DqSmem {
  static constexpr int LDQ = D + pad<T>();
  static constexpr int LDS = kBK + 4;
  static constexpr int LDP = kBK + pad<T>();
  static constexpr int LDO = D + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = align128(Q + (size_t)kBQ * LDQ * sizeof(T));
  static constexpr size_t K = align128(DO + (size_t)kBQ * LDQ * sizeof(T));
  static constexpr size_t V = align128(K + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t S = align128(V + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t DP = align128(S + (size_t)kBQ * LDS * sizeof(float));
  static constexpr size_t DS = align128(DP + (size_t)kBQ * LDS * sizeof(float));
  static constexpr size_t DS_LO = align128(DS + (size_t)kBQ * LDP * sizeof(T));
  static constexpr size_t DQ = align128(DS_LO + (split_operand<T>() ? (size_t)kBQ * LDP * sizeof(T) : 0));
  static constexpr size_t BYTES = align128(DQ + (size_t)kBQ * LDO * sizeof(float));
};

// K12.  One CTA per (64-row q tile, (batch, q head)); it walks its row's
// segment of the q-major band table.  Per k tile: S = q k^T, P = exp(scale S
// - lse) masked, dP = dO v^T, dS = P (dP - delta), dQ += dS k.  Warp w owns
// q rows [16w, 16w + 16) through every step, as in the forward, so the
// warps meet at a block barrier only when a new k / v tile lands.  dQ stays
// in shared memory in f32 and takes the scale once, at the flush.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dq_kernel(const BwdParams p) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  T* dSs = reinterpret_cast<T*>(smem + L::DS);
  T* dSlo = reinterpret_cast<T*>(smem + L::DS_LO);
  float* dQs = reinterpret_cast<float*>(smem + L::DQ);

  const int iq = blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / p.groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int qpos = iq * kBQ + r;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows<T, D, kBQ, L::LDQ>(Qs, q, p.q_ss, iq * kBQ, p.S);
  load_rows<T, D, kBQ, L::LDQ>(dOs, dout, p.o_ss, iq * kBQ, p.S);
#pragma unroll 8
  for (int j = 0; j < D / 2; ++j) dQs[r * L::LDO + half + 2 * j] = 0.0f;
  const long long stat = ((long long)b * p.S + qpos) * p.H + h;
  const float lse_r = qpos < p.S ? p.lse[stat] : 0.0f;
  const float delta_r = qpos < p.S ? p.delta[stat] : 0.0f;

  const int t0 = __ldg(p.row_start + iq), t1 = __ldg(p.row_start + iq + 1);
  for (int t = t0; t < t1; ++t) {
    const int ik = __ldg(p.tab_minor + t);
    __syncthreads();  // every warp is done with the previous k / v tile
    load_rows<T, D, kBK, L::LDQ>(Ks, k, p.k_ss, ik * kBK, p.T);
    load_rows<T, D, kBK, L::LDQ>(Vs, v, p.v_ss, ik * kBK, p.T);
    __syncthreads();

    scores<D, L::LDQ, L::LDS>(Qs, Ks, Ss, warp, lane);
    scores<D, L::LDQ, L::LDS>(dOs, Vs, dPs, warp, lane);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBK / 2; ++j) {
      const int c = half + 2 * j;
      const float pr = attn_valid(p, qpos, ik * kBK + c) ? expf(Ss[r * L::LDS + c] * p.scale - lse_r) : 0.0f;
      store_split<T>(dSs + r * L::LDP + c, dSlo + r * L::LDP + c, pr * (dPs[r * L::LDS + c] - delta_r));
    }
    __syncwarp();
    accumulate_pv<D, L::LDQ, L::LDP, L::LDO>(dSs, Ks, dQs, warp, lane, 1.0f);
    if constexpr (split_operand<T>()) {
      __syncwarp();
      accumulate_pv<D, L::LDQ, L::LDP, L::LDO>(dSlo, Ks, dQs, warp, lane, 1.0f);
    }
    __syncwarp();
  }
  __syncwarp();

  T* dq = static_cast<T*>(p.dq);
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int pos = iq * kBQ + row;
    if (pos >= p.S) continue;  // warp-uniform
    const long long base = (((long long)b * p.S + pos) * p.H + h) * D;
    for (int c = lane; c < D; c += 32) dq[base + c] = from_f32<T>(dQs[row * L::LDO + c] * p.scale);
  }
}

// q rows of the dK / dV kernel's q tile: 64 in bf16; 32 in f32, where the
// 64-row tile's shared memory would exceed the 227 KB a block may use
// (keep in step with build.py ATTN_DKV_TILE)
template <typename T>
__host__ __device__ constexpr int dkv_bq() {
  return sizeof(T) == 2 ? 64 : 32;
}

// dynamic shared memory of the dK / dV kernel: q, dO (BQ rows) and k, v
// (64 rows) tiles in T; the f32 S and dP tiles; P and dS in T, each as its
// hi and lo pair (in f32 they overwrite S and dP in place); the two f32
// accumulators; lse and delta
template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ = dkv_bq<T>();
  static constexpr bool SEPARATE_P = split_operand<T>();
  static constexpr int LDQ = D + pad<T>();
  static constexpr int LDS = kBK + 4;
  static constexpr int LDP = SEPARATE_P ? kBK + pad<T>() : LDS;
  static constexpr int LDO = D + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = align128(Q + (size_t)BQ * LDQ * sizeof(T));
  static constexpr size_t K = align128(DO + (size_t)BQ * LDQ * sizeof(T));
  static constexpr size_t V = align128(K + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t S = align128(V + (size_t)kBK * LDQ * sizeof(T));
  static constexpr size_t DP = align128(S + (size_t)BQ * LDS * sizeof(float));
  static constexpr size_t TILE_P = SEPARATE_P ? (size_t)BQ * LDP * sizeof(T) : 0;
  static constexpr size_t P = align128(DP + (size_t)BQ * LDS * sizeof(float));
  static constexpr size_t P_LO = align128(P + TILE_P);
  static constexpr size_t DS = align128(P_LO + TILE_P);
  static constexpr size_t DS_LO = align128(DS + TILE_P);
  static constexpr size_t DK = align128(DS_LO + TILE_P);
  static constexpr size_t DV = align128(DK + (size_t)kBK * LDO * sizeof(float));
  static constexpr size_t STATS = align128(DV + (size_t)kBK * LDO * sizeof(float));
  static constexpr size_t BYTES = align128(STATS + 2 * (size_t)BQ * sizeof(float));
};

// S = q k^T and dP = dO v^T of one (BQ, 64) tile.  bf16: warp w computes q
// rows [16w, 16w + 16) on the tensor cores.
template <int D, int BQ, int LDQ, int LDS>
__device__ __forceinline__ void dkv_scores(const bf16* Qs, const bf16* Ks, float* Ss, int warp) {
  static_assert(BQ == 4 * 16, "one 16-row strip per warp");
  scores<D, LDQ, LDS>(Qs, Ks, Ss, warp, 0);
}

// f32: SIMT over the whole tile, element e = (row e / 64, col e % 64).
template <int D, int BQ, int LDQ, int LDS>
__device__ __forceinline__ void dkv_scores(const float* Qs, const float* Ks, float* Ss, int) {
  for (int e = threadIdx.x; e < BQ * kBK; e += kFwdThreads) {
    const int i = e / kBK, j = e % kBK;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(Qs[i * LDQ + d], Ks[j * LDQ + d], acc);
    Ss[i * LDS + j] = acc;
  }
}

// acc (64, D) += X^T Y for X (BQ, 64) and Y (BQ, D): dV += P^T dO and
// dK += dS^T q, contracted over the q rows, the TN move on the resident
// tiles.  bf16: warp w owns k rows [16w, 16w + 16); X^T is X read as a
// col_major matrix_a, so no transposed tile is stored.
template <int D, int BQ, int LDX, int LDY, int LDO>
__device__ __forceinline__ void dkv_accumulate(const bf16* Xs, const bf16* Ys, float* Acc, int warp) {
  using namespace nvcuda;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* aptr = Acc + warp * 16 * LDO + n * 16;
    wmma::load_matrix_sync(acc, aptr, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> x;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> y;
      wmma::load_matrix_sync(x, Xs + kk * 16 * LDX + warp * 16, LDX);
      wmma::load_matrix_sync(y, Ys + kk * 16 * LDY + n * 16, LDY);
      wmma::mma_sync(acc, x, y, acc);
    }
    wmma::store_matrix_sync(aptr, acc, LDO, wmma::mem_row_major);
  }
}

// f32: SIMT, element e = (k row e / D, column e % D).
template <int D, int BQ, int LDX, int LDY, int LDO>
__device__ __forceinline__ void dkv_accumulate(const float* Xs, const float* Ys, float* Acc, int) {
  for (int e = threadIdx.x; e < kBK * D; e += kFwdThreads) {
    const int kr = e / D, d = e % D;
    float acc = Acc[kr * LDO + d];
    for (int i = 0; i < BQ; ++i) acc = fmaf(Xs[i * LDX + kr], Ys[i * LDY + d], acc);
    Acc[kr * LDO + d] = acc;
  }
}

// K13.  One CTA per (64-row k tile, (batch, kv head)); it walks its row of
// the k-major band table and, innermost, the `groups` q heads of its kv
// head, as the TPU grid (b * hkv, T, groups) does.  dK and dV stay in shared
// memory in f32 across the whole walk, so the GQA group needs no atomics and
// no per-q-head copies; dK takes the scale once, at the flush.  A k tile past
// every q position walks one masked task and flushes zeros.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  using L = DkvSmem<T, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  T* Ps = L::SEPARATE_P ? reinterpret_cast<T*>(smem + L::P) : reinterpret_cast<T*>(Ss);
  T* Plo = reinterpret_cast<T*>(smem + L::P_LO);
  T* dSs = L::SEPARATE_P ? reinterpret_cast<T*>(smem + L::DS) : reinterpret_cast<T*>(dPs);
  T* dSlo = reinterpret_cast<T*>(smem + L::DS_LO);
  float* dKs = reinterpret_cast<float*>(smem + L::DK);
  float* dVs = reinterpret_cast<float*>(smem + L::DV);
  float* lse_s = reinterpret_cast<float*>(smem + L::STATS);
  float* delta_s = lse_s + BQ;

  const int ik = blockIdx.x;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int warp = threadIdx.x >> 5;

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows<T, D, kBK, L::LDQ>(Ks, k, p.k_ss, ik * kBK, p.T);
  load_rows<T, D, kBK, L::LDQ>(Vs, v, p.v_ss, ik * kBK, p.T);
  for (int e = threadIdx.x; e < kBK * L::LDO; e += kFwdThreads) {
    dKs[e] = 0.0f;
    dVs[e] = 0.0f;
  }

  const int t0 = __ldg(p.row_start + ik), t1 = __ldg(p.row_start + ik + 1);
  for (int t = t0; t < t1; ++t) {
    const int iq = __ldg(p.tab_minor + t);
    for (int g = 0; g < p.groups; ++g) {
      const int h = hk * p.groups + g;
      __syncthreads();  // the previous step is done with q, dO, P, dS
      load_rows<T, D, BQ, L::LDQ>(Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, iq * BQ, p.S);
      load_rows<T, D, BQ, L::LDQ>(dOs, static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh, p.o_ss, iq * BQ,
                                  p.S);
      for (int i = threadIdx.x; i < BQ; i += kFwdThreads) {
        const int qpos = iq * BQ + i;
        const long long stat = ((long long)b * p.S + qpos) * p.H + h;
        lse_s[i] = qpos < p.S ? p.lse[stat] : 0.0f;
        delta_s[i] = qpos < p.S ? p.delta[stat] : 0.0f;
      }
      __syncthreads();
      dkv_scores<D, BQ, L::LDQ, L::LDS>(Qs, Ks, Ss, warp);
      dkv_scores<D, BQ, L::LDQ, L::LDS>(dOs, Vs, dPs, warp);
      __syncthreads();
      for (int e = threadIdx.x; e < BQ * kBK; e += kFwdThreads) {
        const int i = e / kBK, j = e % kBK;
        const float pr =
            attn_valid(p, iq * BQ + i, ik * kBK + j) ? expf(Ss[i * L::LDS + j] * p.scale - lse_s[i]) : 0.0f;
        const float ds = pr * (dPs[i * L::LDS + j] - delta_s[i]);
        store_split<T>(Ps + i * L::LDP + j, Plo + i * L::LDP + j, pr);
        store_split<T>(dSs + i * L::LDP + j, dSlo + i * L::LDP + j, ds);
      }
      __syncthreads();
      dkv_accumulate<D, BQ, L::LDP, L::LDQ, L::LDO>(Ps, dOs, dVs, warp);
      dkv_accumulate<D, BQ, L::LDP, L::LDQ, L::LDO>(dSs, Qs, dKs, warp);
      if constexpr (split_operand<T>()) {
        dkv_accumulate<D, BQ, L::LDP, L::LDQ, L::LDO>(Plo, dOs, dVs, warp);
        dkv_accumulate<D, BQ, L::LDP, L::LDQ, L::LDO>(dSlo, Qs, dKs, warp);
      }
    }
  }
  __syncthreads();

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  for (int e = threadIdx.x; e < kBK * D; e += kFwdThreads) {
    const int kr = e / D, d = e % D;
    const int kpos = ik * kBK + kr;
    if (kpos >= p.T) continue;
    const long long out = (((long long)b * p.T + kpos) * p.Hkv + hk) * D + d;
    dk[out] = from_f32<T>(dKs[kr * L::LDO + d] * p.scale);
    dv[out] = from_f32<T>(dVs[kr * L::LDO + d]);
  }
}

#if SFC_ATTN_PART == 1 && SFC_ATTN_DTYPE == 1

// ---------------------------------------------------------------------------
// backward on wgmma and TMA (bf16): flash_bwd_dq_wgmma_kernel (K12) and
// flash_bwd_dkv_wgmma_kernel (K13)
// ---------------------------------------------------------------------------

#include "hopper.cuh"

namespace bw {

using namespace hopper;

constexpr int kThreads = 160;    // one consumer warpgroup, then the producer warp
constexpr int kConsumers = 128;  // threads of the consumer warpgroup: 64 tile rows, wgmma's M
constexpr int kStages = 2;       // ring stages: two CTAs an SM fit beside each other
constexpr int kMaxCluster = 8;   // CTAs of a K13 cluster, each a part of the GQA group (build.py MAX_BWD_CLUSTER)
constexpr int kBoxBytes = kBQ * kBox * 2;  // one 64-row x 64-column swizzled box: 8 KB
static_assert(kBQ == 64 && kBK == 64, "wgmma's M and the boxes are 64 rows");

// A 64-row tile of D bf16 columns: D / 64 boxes, each 64 rows of 128 bytes.
template <int D>
constexpr int tile_bytes() {
  return kBQ * D * 2;
}

// K12's shared memory: the q and dO tiles, then a ring of (k, v) stages,
// then the barriers, from a 1024-byte aligned base (the swizzle's period).
template <int D>
struct DqWgSmem {
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int RING = 2 * TILE;
  static constexpr int STAGE = 2 * TILE;  // k, then v
  static constexpr int BARS = RING + kStages * STAGE;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * kStages);
};

// K13's: the k and v tiles, then a ring of (q, dO, lse, delta) stages (the
// stats padded to 1024 bytes), then the barriers.  After the walk the ring
// holds the CTA's f32 dK / dV partials for the cluster's merge.
template <int D>
struct DkvWgSmem {
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int RING = 2 * TILE;
  static constexpr int STATS = 2 * TILE;  // in a stage: lse [64], delta [64]
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int BARS = RING + kStages * STAGE;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * kStages);
  static constexpr int PAIRS = D / 4;  // f32 pairs of one m64nD accumulator a thread
  static_assert(2 * PAIRS * kConsumers * 8 <= kStages * STAGE, "the partials fit in the ring");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// k16 step kk of a K-major operand (the contraction runs along the tile's D
// columns): 8-row groups 1024 B apart, 32 B a k16, 64-column boxes 8 KB apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}
// k16 step kk of an N-major operand (the contraction runs along the tile's
// rows, N along its D columns): 16 rows of 128 B a k16, the boxes 8 KB apart
// (LBO), 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_nmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, kBoxBytes, 1024);
}

// Row (0..63) and column of accumulator i of consumer thread tw in an
// m64nN strip: warp w owns rows 16w..16w+15; pair i / 2 sits 8 rows down
// when odd and 8 columns right per two pairs.
__device__ __forceinline__ int acc_row(int tw, int i) { return (tw / 32) * 16 + (tw % 32) / 4 + ((i & 2) ? 8 : 0); }
__device__ __forceinline__ int acc_col(int tw, int i) { return (i / 4) * 8 + 2 * (tw % 4) + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) | (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// store_split in registers: the hi and lo bf16 A fragments of a 64 x 64 f32
// strip.  An m64nN accumulator and wgmma's k16 A fragment share their
// element layout, so k16 slice kk's fragment is accumulators 8kk..8kk+7,
// two to a register, the lower column in the low half.
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const bf16 ha = __float2bfloat16(a), hb = __float2bfloat16(b);
      hi[kk][r] = pack_bf16(ha, hb);
      lo[kk][r] = pack_bf16(__float2bfloat16(a - __bfloat162float(ha)), __float2bfloat16(b - __bfloat162float(hb)));
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// K12.  One CTA per (64-row q tile, (batch, q head)), as flash_bwd_dq_kernel;
// the producer warp's one thread loads the q and dO tiles once and streams
// the band row's (k, v) tiles through the ring; the consumer warpgroup runs,
// per k tile, S = q k^T and dP = dO v^T (wgmma, both operands K-major from
// shared memory), P and dS in the accumulators' registers, and dQ += dS k
// with dS's hi and lo fragments from registers and k through the
// descriptor's transpose bit.  dQ stays in registers and takes the scale
// once, at the flush.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const BwdParams p) {
  using L = DqWgSmem<D>;
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* sm = align1024(bw_smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int iq = blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / p.groups;
  const int t0 = __ldg(p.row_start + iq), t1 = __ldg(p.row_start + iq + 1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, 2 * L::TILE);
#pragma unroll
      for (int j = 0; j < D / kBox; ++j) {
        tma_load_4d(sm + L::Q + j * kBoxBytes, &tm_q, qbar, j * kBox, h, iq * kBQ, b);
        tma_load_4d(sm + L::DO + j * kBoxBytes, &tm_do, qbar, j * kBox, h, iq * kBQ, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        const int ik = __ldg(p.tab_minor + t);
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = sm + L::RING + stage * L::STAGE;
        mbar_expect_tx(&full[stage], L::STAGE);
#pragma unroll
        for (int j = 0; j < D / kBox; ++j) {
          tma_load_4d(st + j * kBoxBytes, &tm_k, &full[stage], j * kBox, hk, ik * kBK, b);
          tma_load_4d(st + L::TILE + j * kBoxBytes, &tm_v, &full[stage], j * kBox, hk, ik * kBK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int tw = threadIdx.x;
  int qpos[2];
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = iq * kBQ + acc_row(tw, 2 * r);
    const long long stat = ((long long)b * p.S + qpos[r]) * p.H + h;
    lse[r] = qpos[r] < p.S ? p.lse[stat] : 0.0f;
    delta[r] = qpos[r] < p.S ? p.delta[stat] : 0.0f;
  }
  float dq[D / 2];
  zero(dq);
  const uint32_t q_addr = smem_u32(sm + L::Q), do_addr = smem_u32(sm + L::DO);
  mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    const int ik = __ldg(p.tab_minor + t);
    mbar_wait(&full[stage], phase);
    const uint32_t k_addr = smem_u32(sm + L::RING + stage * L::STAGE), v_addr = k_addr + L::TILE;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0>(s, desc_kmajor(q_addr, kk), desc_kmajor(k_addr, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0>(dp, desc_kmajor(do_addr, kk), desc_kmajor(v_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float pr = attn_valid(p, qpos[r], ik * kBK + acc_col(tw, i)) ? expf(s[i] * p.scale - lse[r]) : 0.0f;
      s[i] = pr * (dp[i] - delta[r]);  // dS
    }
    uint32_t hi[4][4], lo[4][4];
    split_frags(s, hi, lo);
    fence_acc(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<1>(dq, hi[kk], desc_nmajor(k_addr, kk));
      wgmma_rs<1>(dq, lo[kk], desc_nmajor(k_addr, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  bf16* out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int pos = iq * kBQ + acc_row(tw, i);
    if (pos >= p.S) continue;
    const long long o = (((long long)b * p.S + pos) * p.H + h) * D + acc_col(tw, i);
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
  }
}

// K13.  One cluster of C CTAs per (64-row k tile, (batch, kv head)), C a
// divisor of the GQA group's `groups` q heads (the wrapper's choice,
// `kernels/sfc_attention.py::bwd_wgmma_grid`: the largest that keeps the
// launch to one wave of the card at one CTA an SM, the kernel holding 252
// registers a thread; past one wave, the smallest of two waves or more:
// fewer, longer CTAs save the merge, more balance the band's uneven rows,
// `scripts/split_sweep.py k13`).  CTA g takes the
// group's q heads [g groups / C, (g + 1) groups / C) and walks the k-major
// band row with them innermost, as the tile kernel walks the whole group.
// The producer warp loads the k and v tiles once and streams (q, dO) of
// each (task, head) through the ring by TMA, its 32 lanes staging the q
// tile's lse and delta beside them (the stage's full barrier waits for the
// 32 lanes and the TMA bytes).  The consumer warpgroup computes the
// transposed strips S^T = k q^T and dP^T = v dO^T (the k rows as wgmma's M,
// both operands K-major as stored), P^T = exp(scale S^T - lse) masked and
// dS^T = P^T (dP^T - delta) with lse and delta indexed by the q column, in
// the accumulators' registers, then dV += P^T dO and dK += dS^T q with the
// hi and lo A fragments from registers and dO, q through the transpose
// bit.  P, dS and both accumulators never touch shared memory.  After the
// walk each CTA parks its f32 partials in its ring, and after
// cluster.sync() rank g sums its share of the elements over the cluster's
// CTAs in rank order, reading its peers through distributed shared memory:
// no atomics, no HBM scratch, the same result from run to run.  dK takes
// the scale once, there.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                               const BwdParams p) {
  using L = DkvWgSmem<D>;
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* sm = align1024(bw_smem_raw);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int g = static_cast<int>(cluster.block_rank());
  const int heads = p.groups / C;  // q heads a CTA
  const int ik = blockIdx.x / C;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int h0 = hk * p.groups + g * heads;
  const int t0 = __ldg(p.row_start + ik), t1 = __ldg(p.row_start + ik + 1);

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float dk[D / 2], dv[D / 2];
  if (threadIdx.x >= kConsumers) {
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::TILE);
#pragma unroll
      for (int j = 0; j < D / kBox; ++j) {
        tma_load_4d(sm + L::K + j * kBoxBytes, &tm_k, kvbar, j * kBox, hk, ik * kBK, b);
        tma_load_4d(sm + L::V + j * kBoxBytes, &tm_v, kvbar, j * kBox, hk, ik * kBK, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    // step n: the band row's task t0 + n / heads, the CTA's head n % heads
    for (int n = 0; n < (t1 - t0) * heads; ++n) {
      const int iq = __ldg(p.tab_minor + t0 + n / heads), h = h0 + n % heads;
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = sm + L::RING + stage * L::STAGE;
      float* stats = reinterpret_cast<float*>(st + L::STATS);
      for (int r = lane; r < kBQ; r += 32) {
        const int qpos = iq * kBQ + r;
        const long long stat = ((long long)b * p.S + qpos) * p.H + h;
        stats[r] = qpos < p.S ? p.lse[stat] : 0.0f;
        stats[kBQ + r] = qpos < p.S ? p.delta[stat] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[stage], 2 * L::TILE);
#pragma unroll
        for (int j = 0; j < D / kBox; ++j) {
          tma_load_4d(st + j * kBoxBytes, &tm_q, &full[stage], j * kBox, h, iq * kBQ, b);
          tma_load_4d(st + L::TILE + j * kBoxBytes, &tm_do, &full[stage], j * kBox, h, iq * kBQ, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    const int tw = threadIdx.x;
    zero(dk);
    zero(dv);
    const uint32_t k_addr = smem_u32(sm + L::K), v_addr = smem_u32(sm + L::V);
    const int kpos0 = ik * kBK + acc_row(tw, 0);
    mbar_wait(kvbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0; n < (t1 - t0) * heads; ++n) {
      const int iq = __ldg(p.tab_minor + t0 + n / heads);
      mbar_wait(&full[stage], phase);
      unsigned char* st = sm + L::RING + stage * L::STAGE;
      const uint32_t q_addr = smem_u32(st), do_addr = q_addr + L::TILE;
      const float* stats = reinterpret_cast<const float*>(st + L::STATS);
      float s[32], dp[32];
      zero(s);
      zero(dp);
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0>(s, desc_kmajor(k_addr, kk), desc_kmajor(q_addr, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0>(dp, desc_kmajor(v_addr, kk), desc_kmajor(do_addr, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = acc_col(tw, i);
        const int kpos = kpos0 + ((i & 2) ? 8 : 0);
        const float pr = attn_valid(p, iq * kBQ + c, kpos) ? expf(s[i] * p.scale - stats[c]) : 0.0f;
        dp[i] = pr * (dp[i] - stats[kBQ + c]);  // dS^T
        s[i] = pr;                              // P^T
      }
      uint32_t phi[4][4], plo[4][4], dshi[4][4], dslo[4][4];
      split_frags(s, phi, plo);
      split_frags(dp, dshi, dslo);
      fence_acc(dk);
      fence_acc(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(dv, phi[kk], desc_nmajor(do_addr, kk));
        wgmma_rs<1>(dv, plo[kk], desc_nmajor(do_addr, kk));
        wgmma_rs<1>(dk, dshi[kk], desc_nmajor(q_addr, kk));
        wgmma_rs<1>(dk, dslo[kk], desc_nmajor(q_addr, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();  // the consumers are done with the ring

  // the partials, slot (which, pair q, thread tw): [dK | dV][D / 4][128] float2
  float2* part = reinterpret_cast<float2*>(sm + L::RING);
  if (threadIdx.x < kConsumers) {
#pragma unroll
    for (int q = 0; q < L::PAIRS; ++q) {
      part[q * kConsumers + threadIdx.x] = make_float2(dk[2 * q], dk[2 * q + 1]);
      part[(L::PAIRS + q) * kConsumers + threadIdx.x] = make_float2(dv[2 * q], dv[2 * q + 1]);
    }
  }
  cluster.sync();  // every CTA's partials are visible to the cluster
  constexpr int kSlots = 2 * L::PAIRS * kConsumers;
  const int e_lo = kSlots * g / C, e_hi = kSlots * (g + 1) / C;
  for (int e = e_lo + threadIdx.x; e < e_hi; e += kThreads) {
    float2 acc = cluster.map_shared_rank(part, 0)[e];
    for (int j = 1; j < C; ++j) {
      const float2 x = cluster.map_shared_rank(part, j)[e];
      acc.x += x.x;
      acc.y += x.y;
    }
    const int out_dk = e < L::PAIRS * kConsumers, q = (e / kConsumers) % L::PAIRS, tw = e % kConsumers;
    const int kpos = ik * kBK + acc_row(tw, 2 * q);
    if (kpos >= p.T) continue;
    const float sc = out_dk ? p.scale : 1.0f;
    bf16* out = static_cast<bf16*>(out_dk ? p.dk : p.dv);
    const long long o = (((long long)b * p.T + kpos) * p.Hkv + hk) * D + acc_col(tw, 2 * q);
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(acc.x * sc, acc.y * sc);
  }
  cluster.sync();  // the peers keep their partials until every rank has read them
}

// The four maps of a backward launch, the model's strided (B, S, H, D)
// views: q and dO in 64-row boxes of one q head, k and v of one kv head.
template <int D>
int bwd_maps(const BwdParams& p, int batch, CUtensorMap (&m)[4]) {
  if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || !aligned16(p.dout))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = tensor_map_4d(&m[0], p.q, D, p.H, p.S, batch, p.q_sh, p.q_ss, p.q_sb, kBQ);
  if (rc == 0) rc = tensor_map_4d(&m[1], p.k, D, p.Hkv, p.T, batch, p.k_sh, p.k_ss, p.k_sb, kBK);
  if (rc == 0) rc = tensor_map_4d(&m[2], p.v, D, p.Hkv, p.T, batch, p.v_sh, p.v_ss, p.v_sb, kBK);
  if (rc == 0) rc = tensor_map_4d(&m[3], p.dout, D, p.H, p.S, batch, p.o_sh, p.o_ss, p.o_sb, kBQ);
  return rc;
}

template <int D>
int launch_dq_wgmma(const BwdParams& p, int n_rows, int batch, cudaStream_t s) {
  constexpr int bytes = DqWgSmem<D>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  CUtensorMap m[4];
  int rc = bwd_maps<D>(p, batch, m);
  if (rc != 0) return rc;
  static bool opted_in[kMaxDevices] = {};
  rc = opt_in(flash_bwd_dq_wgmma_kernel<D>, bytes, opted_in);
  if (rc != 0) return rc;
  flash_bwd_dq_wgmma_kernel<D><<<dim3((unsigned)n_rows, (unsigned)(batch * p.H)), kThreads, bytes, s>>>(
      m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// n_rows k tiles, a cluster of `cluster` CTAs each (a divisor of the group).
template <int D>
int launch_dkv_wgmma(const BwdParams& p, int n_rows, int batch, int cluster, cudaStream_t s) {
  constexpr int bytes = DkvWgSmem<D>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  if (cluster < 1 || cluster > kMaxCluster || p.groups % cluster != 0 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  int rc = bwd_maps<D>(p, batch, m);
  if (rc != 0) return rc;
  static bool opted_in[kMaxDevices] = {};
  rc = opt_in(flash_bwd_dkv_wgmma_kernel<D>, bytes, opted_in);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_rows * cluster), (unsigned)(batch * p.Hkv));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_wgmma_kernel<D>, m[0], m[1], m[2], m[3], p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace bw

#endif  // SFC_ATTN_PART == 1 && SFC_ATTN_DTYPE == 1

#if SFC_ATTN_DTYPE == 1
typedef bf16 ElemT;
#else
typedef float ElemT;
#endif

#if SFC_ATTN_PART == 0

template <int D>
int launch_fwd(const FwdParams& p, int nq, int bh, cudaStream_t s) {
  constexpr size_t bytes = FwdSmem<ElemT, D>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in[kMaxDevices] = {};
  const int rc = opt_in(flash_fwd_kernel<ElemT, D>, bytes, opted_in);
  if (rc != 0) return rc;
  flash_fwd_kernel<ElemT, D><<<dim3((unsigned)nq, (unsigned)bh), kFwdThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// The split kernel over batch * Hkv clusters of `splits` CTAs, one launch.
template <int D, int KG>
int launch_decode_split_kg(const DecodeParams& p, int batch, int splits, int seg, cudaStream_t s) {
  constexpr size_t bytes = DecSplitSmem<ElemT, D, KG>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in[kMaxDevices] = {};
  const int rc = opt_in(decode_split_kernel<ElemT, D, KG>, bytes, opted_in);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * p.Hkv * splits));
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_split_kernel<ElemT, D, KG>, p, seg);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The group's rows padded to the next of 1, 2, 4, 8, 16.
template <int D>
int launch_decode_split(const DecodeParams& p, int batch, int splits, int seg, cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits || seg < 1 || seg % kDecChunk != 0) return (int)cudaErrorInvalidValue;
  if (p.groups <= 1) return launch_decode_split_kg<D, 1>(p, batch, splits, seg, s);
  if (p.groups <= 2) return launch_decode_split_kg<D, 2>(p, batch, splits, seg, s);
  if (p.groups <= 4) return launch_decode_split_kg<D, 4>(p, batch, splits, seg, s);
  if (p.groups <= 8) return launch_decode_split_kg<D, 8>(p, batch, splits, seg, s);
  return launch_decode_split_kg<D, 16>(p, batch, splits, seg, s);
}

#else  // SFC_ATTN_PART == 1: the backward

template <int D>
int launch_dq(const BwdParams& p, int n_rows, int bh, cudaStream_t s) {
  constexpr size_t bytes = DqSmem<ElemT, D>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in[kMaxDevices] = {};
  const int rc = opt_in(flash_bwd_dq_kernel<ElemT, D>, bytes, opted_in);
  if (rc != 0) return rc;
  flash_bwd_dq_kernel<ElemT, D><<<dim3((unsigned)n_rows, (unsigned)bh), kFwdThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const BwdParams& p, int n_rows, int bh, cudaStream_t s) {
  constexpr size_t bytes = DkvSmem<ElemT, D>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in[kMaxDevices] = {};
  const int rc = opt_in(flash_bwd_dkv_kernel<ElemT, D>, bytes, opted_in);
  if (rc != 0) return rc;
  flash_bwd_dkv_kernel<ElemT, D><<<dim3((unsigned)n_rows, (unsigned)bh), kFwdThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, const int* tab_minor,
                     const int* row_start, int H, int groups, int S, int T, int seq_q, int seq_k,
                     int q_offset, int causal, const long long* strides, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.tab_minor = tab_minor;
  p.row_start = row_start;
  p.S = S;
  p.T = T;
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.H = H;
  p.Hkv = H / groups;
  p.groups = groups;
  p.q_offset = q_offset;
  p.causal = causal;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.scale = scale;
  return p;
}

#endif  // SFC_ATTN_PART

}  // namespace

#define SFC_CAT_(a, b, c, d) a##b##c##d
#define SFC_CAT(a, b, c, d) SFC_CAT_(a, b, c, d)

// Forward entry: one launch over an (nq, batch * H) grid.  lse may be null
// (the dense-mode flash forward stores none).
#define SFC_FWD_ENTRY(D)                                                                        \
  extern "C" int SFC_CAT(sfc_attn_fwd_, SFC_ATTN_TAG, _d, D)(                                   \
      const void* q, const void* k, const void* v, void* o, float* lse, const int* tab_k,       \
      const int* row_start, int nq, int batch, int H, int groups, int S, int T, int seq_q,      \
      int seq_k, int q_offset, int causal, long long q_sb, long long q_ss, long long q_sh,      \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,           \
      long long v_sh, float scale, void* stream) {                                              \
    FwdParams p;                                                                                \
    p.q = q;                                                                                    \
    p.k = k;                                                                                    \
    p.v = v;                                                                                    \
    p.o = o;                                                                                    \
    p.lse = lse;                                                                                \
    p.tab_k = tab_k;                                                                            \
    p.row_start = row_start;                                                                    \
    p.S = S;                                                                                    \
    p.T = T;                                                                                    \
    p.seq_q = seq_q;                                                                            \
    p.seq_k = seq_k;                                                                            \
    p.H = H;                                                                                    \
    p.groups = groups;                                                                          \
    p.q_offset = q_offset;                                                                      \
    p.causal = causal;                                                                          \
    p.q_sb = q_sb;                                                                              \
    p.q_ss = q_ss;                                                                              \
    p.q_sh = q_sh;                                                                              \
    p.k_sb = k_sb;                                                                              \
    p.k_ss = k_ss;                                                                              \
    p.k_sh = k_sh;                                                                              \
    p.v_sb = v_sb;                                                                              \
    p.v_ss = v_ss;                                                                              \
    p.v_sh = v_sh;                                                                              \
    p.scale = scale;                                                                            \
    return launch_fwd<D>(p, nq, batch * H, static_cast<cudaStream_t>(stream));                  \
  }

// Decode entry: one launch over batch * Hkv clusters of `splits` CTAs,
// segment s the cache rows [s * seg, (s + 1) * seg).  The k and v rows must
// start 16-byte aligned (checked by the caller).
#define SFC_DECODE_ENTRY(D)                                                                     \
  extern "C" int SFC_CAT(sfc_attn_decode_, SFC_ATTN_TAG, _d, D)(                                \
      const void* q, const void* k, const void* v, const int* valid, void* o, int batch, int H, \
      int Hkv, int T, long long k_sb, long long k_st, long long k_sh, long long v_sb,           \
      long long v_st, long long v_sh, float scale, int splits, int seg, void* stream) {         \
    if (H % Hkv != 0 || H / Hkv > kMaxGroups) return (int)cudaErrorInvalidValue;               \
    DecodeParams p;                                                                             \
    p.q = q;                                                                                    \
    p.k = k;                                                                                    \
    p.v = v;                                                                                    \
    p.valid = valid;                                                                            \
    p.o = o;                                                                                    \
    p.H = H;                                                                                    \
    p.Hkv = Hkv;                                                                                \
    p.groups = H / Hkv;                                                                         \
    p.T = T;                                                                                    \
    p.k_sb = k_sb;                                                                              \
    p.k_st = k_st;                                                                              \
    p.k_sh = k_sh;                                                                              \
    p.v_sb = v_sb;                                                                              \
    p.v_st = v_st;                                                                              \
    p.v_sh = v_sh;                                                                              \
    p.scale = scale;                                                                            \
    return launch_decode_split<D>(p, batch, splits, seg, static_cast<cudaStream_t>(stream));   \
  }

// Backward entries: dq over an (nq, batch * H) grid walking the q-major
// band; dkv over an (nk, batch * Hkv) grid walking the k-major band.
// strides: q, k, v, dO, each (batch, seq, head), in elements.
#define SFC_DQ_ENTRY(D)                                                                         \
  extern "C" int SFC_CAT(sfc_attn_dq_, SFC_ATTN_TAG, _d, D)(                                    \
      const void* q, const void* k, const void* v, const void* dout, const float* lse,          \
      const float* delta, void* dq, const int* tab_k, const int* row_start, int nq, int batch,  \
      int H, int groups, int S, int T, int seq_q, int seq_k, int q_offset, int causal,          \
      const long long* strides, float scale, void* stream) {                                    \
    if (groups < 1 || H % groups != 0) return (int)cudaErrorInvalidValue;                       \
    const BwdParams p = bwd_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, tab_k,      \
                                   row_start, H, groups, S, T, seq_q, seq_k, q_offset, causal,  \
                                   strides, scale);                                             \
    return launch_dq<D>(p, nq, batch * H, static_cast<cudaStream_t>(stream));                   \
  }

#define SFC_DKV_ENTRY(D)                                                                        \
  extern "C" int SFC_CAT(sfc_attn_dkv_, SFC_ATTN_TAG, _d, D)(                                   \
      const void* q, const void* k, const void* v, const void* dout, const float* lse,          \
      const float* delta, void* dk, void* dv, const int* tab_q, const int* row_start, int nk,   \
      int batch, int H, int groups, int S, int T, int seq_q, int seq_k, int q_offset,           \
      int causal, const long long* strides, float scale, void* stream) {                        \
    if (groups < 1 || H % groups != 0) return (int)cudaErrorInvalidValue;                       \
    const BwdParams p = bwd_params(q, k, v, dout, lse, delta, nullptr, dk, dv, tab_q,           \
                                   row_start, H, groups, S, T, seq_q, seq_k, q_offset, causal,  \
                                   strides, scale);                                             \
    return launch_dkv<D>(p, nk, batch * (H / groups), static_cast<cudaStream_t>(stream));       \
  }

// The wgmma backward's entries (bf16): the dq / dkv entries' arguments,
// the dK/dV entry's with `cluster` before the stream; its launch is batch *
// Hkv clusters of `cluster` CTAs (a divisor of the group, at most 8) per k
// tile.  q, k, v and dO need 16-byte aligned bases and strides of whole 16
// bytes, as TMA does.
#define SFC_DQ_WGMMA_ENTRY(D)                                                                   \
  extern "C" int SFC_CAT(sfc_attn_dq_wgmma_, SFC_ATTN_TAG, _d, D)(                              \
      const void* q, const void* k, const void* v, const void* dout, const float* lse,          \
      const float* delta, void* dq, const int* tab_k, const int* row_start, int nq, int batch,  \
      int H, int groups, int S, int T, int seq_q, int seq_k, int q_offset, int causal,          \
      const long long* strides, float scale, void* stream) {                                    \
    if (groups < 1 || H % groups != 0) return (int)cudaErrorInvalidValue;                       \
    const BwdParams p = bwd_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, tab_k,      \
                                   row_start, H, groups, S, T, seq_q, seq_k, q_offset, causal,  \
                                   strides, scale);                                             \
    return bw::launch_dq_wgmma<D>(p, nq, batch, static_cast<cudaStream_t>(stream));             \
  }

#define SFC_DKV_WGMMA_ENTRY(D)                                                                  \
  extern "C" int SFC_CAT(sfc_attn_dkv_wgmma_, SFC_ATTN_TAG, _d, D)(                             \
      const void* q, const void* k, const void* v, const void* dout, const float* lse,          \
      const float* delta, void* dk, void* dv, const int* tab_q, const int* row_start, int nk,   \
      int batch, int H, int groups, int S, int T, int seq_q, int seq_k, int q_offset,           \
      int causal, const long long* strides, float scale, int cluster, void* stream) {           \
    if (groups < 1 || H % groups != 0) return (int)cudaErrorInvalidValue;                       \
    const BwdParams p = bwd_params(q, k, v, dout, lse, delta, nullptr, dk, dv, tab_q,           \
                                   row_start, H, groups, S, T, seq_q, seq_k, q_offset, causal,  \
                                   strides, scale);                                             \
    return bw::launch_dkv_wgmma<D>(p, nk, batch, cluster, static_cast<cudaStream_t>(stream));   \
  }

#if SFC_ATTN_PART == 0
SFC_FWD_ENTRY(64)
SFC_FWD_ENTRY(128)
SFC_DECODE_ENTRY(64)
SFC_DECODE_ENTRY(128)
#else
SFC_DQ_ENTRY(64)
SFC_DQ_ENTRY(128)
SFC_DKV_ENTRY(64)
SFC_DKV_ENTRY(128)
#if SFC_ATTN_DTYPE == 1
SFC_DQ_WGMMA_ENTRY(64)
SFC_DQ_WGMMA_ENTRY(128)
SFC_DKV_WGMMA_ENTRY(64)
SFC_DKV_WGMMA_ENTRY(128)

// The host's cost of one tensor-map encoding (cuTensorMapEncodeTiled), the
// mean of `reps` in ns: rank 3, a (512, 2560) bf16 matrix in 128-row boxes
// as the wgmma GEMMs (K2, K7) map each operand; rank 4, a (2, 256, 32, 128)
// (B, S, H, D) view in 64-row boxes as the flash backward maps q, k, v, dO.
// `base`: any 16-byte aligned device pointer (the encoder does not read it).
// Negative: the encoder refused.
extern "C" double sfc_tensor_map_encode_ns(const void* base, int rank, int reps) {
  CUtensorMap m;
  int rc = 0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps && rc == 0; ++i) {
    rc = rank == 3 ? hopper::tensor_map(&m, base, 2560, 512, 1, 128)
                   : hopper::tensor_map_4d(&m, base, 128, 32, 256, 2, 128, 4096, 1048576, 64);
  }
  const auto t1 = std::chrono::steady_clock::now();
  if (rc != 0 || reps < 1) return -1.0;
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
#endif
#endif
