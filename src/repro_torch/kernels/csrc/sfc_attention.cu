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
// decode_kernel replaces `repro/kernels/sfc_attention.py::
//   sfc_decode_attention_pallas` (`_decode_kernel`): one launch for the whole
//   (batch, head) fan-out of a decode step.  One CTA per (batch, kv head); its
//   rows are the kv head's GQA group (no padding of the group to 8 rows).  The
//   k-chunk loop ends at valid_len[b], read on the device, so chunks past the
//   live cache are never read and the host never waits for the length; the
//   cache is read in place in its stored (B, T, Hkv, D) layout with no pad to
//   a chunk multiple.  valid_len is clamped to [0, T]; valid_len 0 gives
//   zeros, as the TPU kernel's max(l, 1e-30) does.
//
//   What bounds it: the bytes of the live cache (k and v, 2 x valid x D per
//   kv head) at 3.35 TB/s.  What it leaves on the table: with 4 x 8 = 32 CTAs
//   on 132 SMs it cannot reach the card's memory rate; splitting the cache
//   across CTAs (split-K with a merge) is a later kernel.
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
//   and dP are recomputed by both kernels.
//
// One compilation unit holds one input type, chosen by -DSFC_ATTN_DTYPE
// (0: float32, 1: bfloat16) and named by -DSFC_ATTN_TAG, and one half,
// chosen by -DSFC_ATTN_PART (0: flash forward and decode, 1: the backward),
// with the head dims 64 and 128 (`repro_torch/kernels/build.py` builds all
// four parts at once).  Every entry launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;  // q rows of a tile (keep in step with build.py ATTN_TILE)
constexpr int kBK = 64;  // k rows of a tile
constexpr int kFwdThreads = 128;  // 4 warps x 16 q rows
constexpr int kDecChunk = 64;     // cache rows per decode step of the loop
constexpr int kMaxGroups = 16;    // GQA rows a decode CTA holds (build.py MAX_DECODE_GROUPS)
constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

// One CTA of D threads per (batch, kv head).  Thread d owns output column d
// of every row of the group.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_kernel(const DecodeParams p) {
  constexpr int kWarps = D / 32;
  constexpr int kPer = D / 32;  // elements of a k row per lane
  __shared__ float qs[kMaxGroups][D];
  __shared__ float ss[kMaxGroups][kDecChunk];
  __shared__ float ms[kMaxGroups], ls[kMaxGroups], alphas[kMaxGroups];

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int G = p.groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int valid = min(max(__ldg(p.valid + b), 0), p.T);

  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + hk * G) * D;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int e = tid; e < G * D; e += D) qs[e / D][e % D] = to_f32(q[e]) * p.scale;
  if (tid < G) {
    ms[tid] = kNeg;
    ls[tid] = 0.0f;
  }
  float acc[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int j0 = 0; j0 < valid; j0 += kDecChunk) {
    // scores: warp w takes cache rows w, w + kWarps, ... of the chunk
    for (int jj = warp; jj < kDecChunk; jj += kWarps) {
      const int kpos = j0 + jj;
      float kv[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        kv[e] = kpos < valid ? to_f32(k[(long long)kpos * p.k_st + lane * kPer + e]) : 0.0f;
      }
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) dot = fmaf(qs[g][lane * kPer + e], kv[e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        if (lane == 0) ss[g][jj] = kpos < valid ? dot : kNeg;
      }
    }
    __syncthreads();
    // online softmax: warp w takes rows w, w + kWarps, ...
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNeg;
      for (int jj = lane; jj < kDecChunk; jj += 32) mx = fmaxf(mx, ss[g][jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int jj = lane; jj < kDecChunk; jj += 32) {
        const float e = expf(ss[g][jj] - m_new);
        ss[g][jj] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alphas[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // P v over the live rows of the chunk (rows past valid have p = 0)
    const int live = min(kDecChunk, valid - j0);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < G) acc[g] *= alphas[g];
    }
    for (int jj = 0; jj < live; ++jj) {
      const float x = to_f32(v[(long long)(j0 + jj) * p.v_st + tid]);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G) acc[g] = fmaf(ss[g][jj], x, acc[g]);
      }
    }
    __syncthreads();  // ss is rewritten by the next chunk
  }

  T* o = static_cast<T*>(p.o) + ((long long)b * p.H + hk * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g < G) o[g * D + tid] = from_f32<T>(acc[g] / fmaxf(ls[g], kTiny));
  }
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

#if SFC_ATTN_DTYPE == 1
typedef bf16 ElemT;
#else
typedef float ElemT;
#endif

// Above 48 KB of dynamic shared memory a launch is refused unless the kernel
// opts in; do it once per device (so no attribute call lands inside a CUDA
// graph capture).  `done` is the caller's per-kernel flag array.
template <typename Kernel>
int opt_in(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

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

template <int D>
int launch_decode(const DecodeParams& p, int batch, cudaStream_t s) {
  decode_kernel<ElemT, D><<<(unsigned)(batch * p.Hkv), D, 0, s>>>(p);
  return (int)cudaGetLastError();
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

// Decode entry: one launch over batch * Hkv CTAs.
#define SFC_DECODE_ENTRY(D)                                                                     \
  extern "C" int SFC_CAT(sfc_attn_decode_, SFC_ATTN_TAG, _d, D)(                                \
      const void* q, const void* k, const void* v, const int* valid, void* o, int batch, int H, \
      int Hkv, int T, long long k_sb, long long k_st, long long k_sh, long long v_sb,           \
      long long v_st, long long v_sh, float scale, void* stream) {                              \
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
    return launch_decode<D>(p, batch, static_cast<cudaStream_t>(stream));                      \
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
#endif
