// SFC-ordered fused GEMM for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `repro/kernels/sfc_gemm.py::_fused_kernel` in both
// of the modes the server uses: `sfc_gemm_fused` (plain, A (M, K)) and
// `sfc_gemm_batched_fused` (batched, A (B, M, K) against shared (K, N) or
// per-batch (B, K, N) weights).  It computes what that body computes:
//
//   C[b] = epilogue(A[b] @ B[b or shared])
//   epilogue = act(acc + bias) [GLU: act(acc_gate + gate_bias) * (acc + bias)]
//              * out_scale + residual
//
// on the f32 accumulator, with one cast to the output type.
//
// Order.  blockIdx.x is the task index t of the gilbert schedule that
// `repro_torch/core/schedule.py::compile_schedule(gemm_spec(mb, nb))` builds;
// the CTA reads its C tile (im, in) from the table's major / minor rows, and
// blockIdx.y is the batch element.  CTAs launched in curve order share A and
// B panels in the 50 MB L2, which is how the paper's locality reaches this
// card.  The TPU grid's sequential (K_layers, k_block_factor) dimensions
// become one K loop inside the CTA with the accumulator in registers: blocks
// run in parallel in no order, so nothing can carry over between them.
//
// What bounds it on the H100.  Decode (M = batch = 4) reads every weight
// once for 2*M flops a weight: it is bound by the bytes of B at 3.35 TB/s.
// Prefill (M = 128 rows per sequence, 4 sequences) does 2*M*N*K flops on
// (M + N)*K inputs and is bound by the bf16 tensor-core rate.
//
// The design is the simple one: a 64 x 64 C tile per CTA of 4 warps, A and B
// panels staged through shared memory one K step at a time (16-byte loads,
// zero-filled past the ragged M/N/K edge), bf16 products on the tensor cores
// through WMMA 16x16x16 fragments and f32 products as SIMT FMAs, then the
// accumulator goes through shared memory to a coalesced epilogue.  What it
// leaves on the table: no wgmma (the only path to the full bf16 rate), no
// TMA and no multi-stage pipeline, so loads and math do not overlap; no
// persistent CTAs walking curve segments.  At decode M = 4 only 4 of the 64
// tile rows were real and narrow N gave few CTAs (16 for N = 1024), so the
// weight stream could not reach the card's memory rate: the bf16 parts now
// launch sfc_gemm_cluster_kernel (below) for a plain-mode A of at most 16
// rows, and this kernel keeps every other shape, and f32.
//
// sfc_gemm_cluster_kernel replaces the same TPU kernel (`_fused_kernel`,
// `sfc_gemm_fused` at M <= 16: every decode projection and the decode LM
// head) with the paper's 2.5D replication of C over K layers, which the
// TPU collapsed into one accumulator: each C tile (64 columns, in the
// gilbert order of gemm_spec(1, nb)) is a thread-block cluster of L CTAs,
// CTA l running the K slab of layer l (layer_slab(K, L), the JAX package's
// partition), so nb * L CTAs stream the weights where nb did; L, chosen by
// the wrapper from nb and K, is the launch configuration, not a knob.  Each
// CTA streams its slab's (BK = 64) x 64 weight tiles (and the GLU's gate
// tiles) with the M rows of A through a 3-4 stage cp.async ring (16-byte
// copies, one barrier a step) and multiplies on the tensor cores swap-AB:
// the weight tile as WMMA 32x8x16's 32-row operand, A's rows as its
// 8-column one, so no 64-row tile of which 4 rows are real.  After
// cluster.sync() the leader adds its peers' f32 16 x 64 tiles from
// distributed shared memory in layer order and runs fused_flush (and, in
// the ABFT twin sfc_gemm_cluster_abft_kernel, tile_checksum) once: no
// atomics, no partial copies in HBM, one launch.  What bounds it: the
// weight bytes (2 M flops a weight); f32 stays on the kernel above.
//
// Grouped mode (K3, `repro/kernels/sfc_gemm.py::sfc_gemm_grouped`, the MoE
// expert GEMMs): when the entry gets a per-expert array `grp` (3, E) of row
// starts, row counts and first padded row blocks, it launches
// sfc_gemm_grouped_kernel, the same tile body under a name of its own (so a
// profiler trace tells K3 from K1/K2).  The task table has a third row, the
// expert, and each CTA computes one tile of its expert's product
// A[rows of e] @ B[e] with B, B_gate and the bias rows offset by the expert.
// Each expert's rows lie packed, unpadded, in A and C: the CTA masks its
// expert's last row block at the expert's row count, where the TPU kernel
// runs on rows padded to whole blocks.  The table keeps the TPU's padded
// block numbering (one gilbert map per expert over its row blocks), so the
// tile order is the TPU's.  What bounds it: at the olmoe shapes (80 rows an
// expert at prefill and training, 32 at decode) every launch reads each
// expert's weights once, 2 * rows flops a weight, far below the card's
// 295 flops a byte, so the weight bytes bound it; the 64-row tile is then
// mostly a weight stream, and at decode 32 of its 64 rows are real.
//
// Epilogue flags are template parameters.  One compilation unit holds one
// (input type, GLU, activation) part, chosen by -DSFC_DTYPE / -DSFC_GLU /
// -DSFC_ACT with its entry point named by -DSFC_ENTRY, so the build can run
// the parts in parallel (`repro_torch/kernels/build.py`).  The GLU parts also
// take the training forward's `preact` mode (`_FusedSpec.preact_out`): both
// biased pre-activations, A@B + bias and A@B_gate + gate_bias, flushed to two
// outputs from the one traversal of A, with no activation.
//
// -DSFC_BWD=1 compiles, instead of the fused forward, the two backward
// kernels of one input type (entries -DSFC_NT_ENTRY / -DSFC_TN_ENTRY):
//
// nt_kernel replaces `repro/kernels/sfc_gemm.py::sfc_gemm_nt` (`_nt_kernel`):
//   C = A @ B^T (+ A2 @ B2^T), the dA of a projection (A = dC (M, N), B = the
//   forward weight (K, N) as stored, so C is (M, K)).  One CTA per C tile in
//   gilbert order, as the fused kernel; the B operand is a row slab of the
//   untransposed weight, read by the tensor cores as a col_major WMMA
//   matrix_b, so no transposed copy exists in HBM.  The dual form (the GLU's
//   dg Wg^T + dh Wv^T) streams both operand pairs into one accumulator.
// tn_kernel replaces `sfc_gemm_tn` (`_tn_kernel`) in its dW mode:
//   C = A^T @ B (and C2 = A^T @ B2), the dW of a projection (A = the forward
//   activations (M, K), B = dC (M, N), C is (K, N)).  The loop over the M
//   token rows runs inside one CTA, so there are no atomics and the result is
//   deterministic; the A panel is loaded as stored and read as a col_major
//   matrix_a.  The dual form shares the A panel between two accumulators and
//   two outputs (the GLU's dWv, dWg).  Its ABFT checksum lane is a build
//   part of its own (-DSFC_ABFT=1, below).
// Both entries take the grouped mode too, with the per-expert `grp` array,
// and launch it as a kernel of its own over the same tile body:
// grouped_nt_kernel replaces `sfc_gemm_grouped_nt` (`_grouped_nt_kernel`, K9):
//   dA[rows of e] = dC_e @ B[e]^T (+ dC2_e @ B2[e]^T) with the expert's
//   weight read as stored (E, N, K), over the forward's grouped table.
// grouped_tn_kernel replaces `sfc_gemm_grouped_tn` in its dW mode
//   (`_grouped_tn_kernel`, K10): dW[e] = A_e^T @ dC_e (and dC2_e) over one
//   gilbert map of the (K, N) tiles replayed per expert; the CTA's contraction loop runs over its
//   expert's rows only (the TPU kernel's `rb` bound), so an expert with no
//   rows flushes a zero tile, with no atomics.  At 80 rows an expert the
//   loop is two steps deep: the launch is bound by the weight-sized output
//   it writes and by the re-reads of each expert's rows from L2.
//
// -DSFC_BWD=2 compiles tn_update_kernel (entry -DSFC_TNU_ENTRY), the same TN
// traversal with the TPU kernel's grad-and-update flush
// (`_apply_update_flush`) in place of the dW write, in two modes:
//   update: AdamW on each f32 dW tile, already staged in shared memory,
//     against the f32 master / mu / nu, read and written in place with
//     coalesced accesses; W is written in the input type, for bf16
//     stochastically rounded on request; the 12 AdamW scalars come from a
//     device vector (`optim/adamw.py::pack_adamw_hyper`), read once per CTA,
//     and the weight's salt is an argument; a gradient scale of 0 keeps the
//     state and writes the deterministic cast (the non-finite skip).
//   norm: only each tile's sum(dW^2), the first phase of the exact clip.
//   Both write the tile's sum(dW^2), taken before the scale, into a per-task
//   partials buffer that the wrapper sums on the device: no atomics, so the
//   norm is deterministic as the dW write is.  The stochastic-rounding bits
//   are the counter hash of the JAX package's interpret path
//   (`tile_random_bits`, `_tile_seed`), so they equal the plain version's.
//   The flush arithmetic uses the _rn intrinsics, so no product is fused
//   into an FMA and each step rounds as the plain version's does.
//   What bounds it: per weight element it reads 12 B of state and writes
//   14 B (at 2 x 256 token rows that is at least as long as the bf16
//   products); the flush has no vector loads and runs once per tile after
//   the main loop, so its traffic does not overlap the products.
// What bounds them on the H100: the training step's 512 token rows make
// every dA and dW a 2*512*K*N flop product over (512 + K)*N or (K + N)*512
// inputs, tensor-core bound at the bf16 peak for every projection.  What
// they leave on the table is the fused kernel's: no wgmma, no TMA, no
// pipeline, and (TN) each CTA re-reads its A and B panels from L2.
//
// -DSFC_REP=1 compiles, instead, the replicated 2.5D form of one input type
// (entries -DSFC_REP_ENTRY / -DSFC_ADD_REDUCE_ENTRY), the paper's own
// scheme (Listing 1, lines 26-35), which the TPU collapsed into one
// accumulator for want of a second worker; on this card the SMs are the
// workers again, so it is split-K across SMs:
// sfc_gemm_replicated_kernel replaces `sfc_gemm_pallas` (`_sfc_gemm_kernel`,
//   K4) and `sfc_gemm_batched` (`_sfc_gemm_batched_kernel`, K5): the task
//   table of gemm_spec(mb, nb, k_layers) (layer-major, gilbert within a
//   layer) gives each CTA a C tile (im, in) and a layer l; it runs the fused
//   kernel's main loop over the layer's K slab [l * k_slab, (l + 1) * k_slab)
//   clipped to K (the slab is the JAX package's: K padded to a multiple of
//   k_layers * k_block_factor, split evenly) and writes the tile of copy l
//   once, in the input type or in f32 (the unfused GLU's copies).  k_layers
//   CTAs share each C tile with no atomics; blockIdx.y is the batch element
//   against a shared or per-batch B.  No epilogue: it runs after the sum.
// add_reduce_kernel replaces `add_reduce_pallas` (`_add_reduce_kernel`,
//   `_add_reduce_batched_kernel`, K6): (B, L, M, N) copies -> (B, M, N),
//   each output the f32 sum of its L copies in layer order, cast once to
//   the copies' type, 16-byte vector loads where M*N allows.
// What bounds them: at decode (M = 4) K4 reads the weight once, 2*M flops a
// weight, so the weight bytes bound it as they bound K1; split over k_layers
// slabs the same bytes stream through k_layers times as many CTAs (16 for
// k/v's N = 1024 at L = 1, 128 at L = 8), at the price of L copies of C
// written and read back by K6, which is bound by (L + 1) M N elements of
// bytes.  At prefill (4 x 128 rows) the products are tensor-core bound and
// the split only adds copies.
//
// -DSFC_ABFT=1 compiles, beside any of the forward parts, the -DSFC_BWD=1
// part or the -DSFC_BWD=2 part, the same kernels with the TPU kernels' ABFT
// checksum lane (`_FusedSpec.abft`, sfc_gemm.py:175-178, :216-224, :246-252;
// `_tn_kernel`'s `abft`, :1355-1368, :1388-1392), under names of their own
// and behind entries of their own, so the parts above keep their code:
// sfc_gemm_fused_abft_kernel (K1/K2) and sfc_gemm_grouped_abft_kernel (K3)
// for the forward part's (GLU, activation) and every epilogue flag of it;
// tn_abft_kernel (K8 dW); tn_update_abft_kernel (K8's update and norm
// modes).  After the main loop each task sums its raw f32 accumulator
// tile (the GLU's two together; the TN dual form's two sets apart), before
// the epilogue, the cast or AdamW, over the rows and cols inside the
// output only, and thread 0 writes that sum into the task's slot of an
// (n_sets, batch * n_tasks) f32 partials buffer, which the wrapper sums on
// the device: the TPU's launch-resident accumulator needs an ordered grid,
// and atomics would make the checksum vary from run to run.  The lane
// reads the tile from shared memory once more after the flush (64 x 64
// f32, 16 KB) and adds a block reduction and one 4-byte write a task; the
// flush is the same code, so the outputs are bitwise those without it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cuda_common.cuh"

#ifndef SFC_DTYPE  // 0: float32 inputs, 1: bfloat16 inputs
#define SFC_DTYPE 1
#endif
#ifndef SFC_GLU  // 1: dual-B gated form
#define SFC_GLU 0
#endif
#ifndef SFC_ACT  // 0: none, 1: silu, 2: gelu (tanh form), 3: relu
#define SFC_ACT 0
#endif
#ifndef SFC_ENTRY
#define SFC_ENTRY sfc_gemm_fused_entry
#endif
#ifndef SFC_BWD  // 1: the NT / TN backward kernels instead; 2: the TN update / norm kernel
#define SFC_BWD 0
#endif
#ifndef SFC_NT_ENTRY
#define SFC_NT_ENTRY sfc_gemm_nt_entry
#endif
#ifndef SFC_TN_ENTRY
#define SFC_TN_ENTRY sfc_gemm_tn_entry
#endif
#ifndef SFC_TNU_ENTRY
#define SFC_TNU_ENTRY sfc_gemm_tn_update_entry
#endif
#ifndef SFC_REP  // 1: the replicated form's kernels (K4/K5 and K6) instead
#define SFC_REP 0
#endif
#ifndef SFC_REP_ENTRY
#define SFC_REP_ENTRY sfc_gemm_replicated_entry
#endif
#ifndef SFC_ADD_REDUCE_ENTRY
#define SFC_ADD_REDUCE_ENTRY sfc_add_reduce_entry
#endif
#ifndef SFC_ABFT  // 1: the ABFT checksum lanes of the part's kernels instead
#define SFC_ABFT 0
#endif
#ifndef SFC_TN_ABFT_ENTRY
#define SFC_TN_ABFT_ENTRY sfc_gemm_tn_abft_entry
#endif
#ifndef SFC_TNU_ABFT_ENTRY
#define SFC_TNU_ABFT_ENTRY sfc_gemm_tn_update_abft_entry
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64;  // C tile rows (keep in step with build.py TILE)
constexpr int kBN = 64;  // C tile cols
constexpr int kThreads = 128;
constexpr int kLDC = kBN + 4;  // f32 epilogue tile, row stride in floats

// K step and shared-memory row strides; the pads keep 16-byte (and, for
// WMMA, 32-byte) alignment of every fragment while spreading banks.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BK = 64;
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = kBN + 8;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int LDA = BK + 4;
  static constexpr int LDB = kBN + 4;
};

struct Params {
  const void* a;
  const void* b;
  const void* bg;
  const void* bias;
  const void* gbias;
  const void* res;
  void* out;
  void* out_gate;  // preact mode: the gate pre-activation's output
  const int* tab;  // (2, n_tasks): row 0 = major (im), row 1 = minor (in)
  int n_tasks;
  int M, N, K;
  long long a_bstride;  // elements between batch elements of A
  long long b_bstride;  // 0 when B is shared across the batch
  float out_scale;
  int vec_a;  // rows of A may be read as 16-byte vectors
  int vec_b;  // rows of B (and B_gate) may be read as 16-byte vectors
};

// The grouped mode's second argument (K3): (3, n_groups) per-expert row
// start, row count and first padded row block; the table's third row is
// the expert.  Apart from Params, so K1/K2's argument is as it was.
struct GroupRows {
  const int* grp;
  int n_groups;
};

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

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == 1) {
    return x * (1.0f / (1.0f + expf(-x)));  // silu = x * sigmoid(x)
  } else if constexpr (ACT == 2) {
    // jax.nn.gelu's default tanh approximation
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(inner));
  } else if constexpr (ACT == 3) {
    return fmaxf(x, 0.0f);
  } else {
    return x;
  }
}

// Stage rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major matrix
// with nrows x ncols elements and row stride ld into shared memory (row
// stride LDS), writing zeros outside the matrix: the ragged edge is masked
// here, so padding contributes nothing to the contraction.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(T* __restrict__ s, const T* __restrict__ g, int ld,
                                          int r0, int c0, int nrows, int ncols, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COLS % VEC == 0, "tile width must hold whole 16-byte vectors");
  if (vec) {
    // vec is set only when ncols % VEC == 0 and rows start 16-byte aligned,
    // so a vector that starts inside the matrix lies wholly inside it
    constexpr int PER_ROW = COLS / VEC;
    constexpr int N_VEC = ROWS * PER_ROW;
#pragma unroll
    for (int it = 0; it < (N_VEC + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      if (i < N_VEC) {
        const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
        const int gr = r0 + r, gc = c0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < nrows && gc < ncols) {
          v = __ldg(reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gc));
        }
        *reinterpret_cast<uint4*>(s + r * LDS + c) = v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      const int gr = r0 + r, gc = c0 + c;
      T v = from_f32<T>(0.0f);
      if (gr < nrows && gc < ncols) v = g[(size_t)gr * ld + gc];
      s[r * LDS + c] = v;
    }
  }
}

// bf16: tensor cores through WMMA.  4 warps in a 2 x 2 grid, each owning a
// 32 x 32 quarter of the C tile as 2 x 2 fragments (and as many again for the
// gate accumulator of the GLU form).  Leaves the f32 accumulators in Cs/Cgs.
// The K loop runs over [k_lo, k_hi): the whole depth [0, K) for the fused
// kernels, one layer's slab for the replicated one (K4/K5).
template <bool GLU>
__device__ __forceinline__ void mainloop(const Params& p, int M, const bf16* A, const bf16* B,
                                         const bf16* Bg, int row0, int col0, int k_lo, int k_hi, bf16* As,
                                         bf16* Bs, bf16* Bgs, float* Cs, float* Cgs) {
  using namespace nvcuda;
  constexpr int BK = Cfg<bf16>::BK, LDA = Cfg<bf16>::LDA, LDB = Cfg<bf16>::LDB;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accg[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if constexpr (GLU) wmma::fill_fragment(accg[i][j], 0.0f);
    }
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K step
    load_tile<bf16, kBM, BK, LDA>(As, A, p.K, row0, k0, M, k_hi, p.vec_a);
    load_tile<bf16, BK, kBN, LDB>(Bs, B, p.N, k0, col0, k_hi, p.N, p.vec_b);
    if constexpr (GLU) load_tile<bf16, BK, kBN, LDB>(Bgs, Bg, p.N, k0, col0, k_hi, p.N, p.vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      if constexpr (GLU) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], Bgs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(accg[i][j], af[i], bf[j], accg[i][j]);
        }
      }
    }
  }
  __syncthreads();  // Cs/Cgs alias the operand tiles
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* c = Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16;
      wmma::store_matrix_sync(c, acc[i][j], kLDC, wmma::mem_row_major);
      if constexpr (GLU) {
        float* cg = Cgs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16;
        wmma::store_matrix_sync(cg, accg[i][j], kLDC, wmma::mem_row_major);
      }
    }
  }
}

// f32: SIMT FMAs in full f32 (no TF32, so the result holds the plain
// version's rtol 1e-4).  Threads form an 8 (N) x 16 (M) grid, each owning
// 4 rows x 8 cols of the C tile.
template <bool GLU>
__device__ __forceinline__ void mainloop(const Params& p, int M, const float* A, const float* B,
                                         const float* Bg, int row0, int col0, int k_lo, int k_hi, float* As,
                                         float* Bs, float* Bgs, float* Cs, float* Cgs) {
  constexpr int BK = Cfg<float>::BK, LDA = Cfg<float>::LDA, LDB = Cfg<float>::LDB;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[4][8];
  float accg[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.0f;
      accg[i][j] = 0.0f;
    }
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile<float, kBM, BK, LDA>(As, A, p.K, row0, k0, M, k_hi, p.vec_a);
    load_tile<float, BK, kBN, LDB>(Bs, B, p.N, k0, col0, k_hi, p.N, p.vec_b);
    if constexpr (GLU) load_tile<float, BK, kBN, LDB>(Bgs, Bg, p.N, k0, col0, k_hi, p.N, p.vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * LDB + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if constexpr (GLU) {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bgs[kk * LDB + tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) accg[i][j] = fmaf(a[i], b[j], accg[i][j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Cs[(ty * 4 + i) * kLDC + tx * 8 + j] = acc[i][j];
      if constexpr (GLU) Cgs[(ty * 4 + i) * kLDC + tx * 8 + j] = accg[i][j];
    }
  }
}

// The CTA's sum of v in a fixed order (a warp butterfly, then warp 0's lane 0
// over the warp sums); valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();  // red may still be read by a previous call
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  }
  return s;
}

// The ABFT checksum lane of one task (the TPU kernels' launch-resident
// `chk` output, sfc_gemm.py:246-252 and :1388-1392): thread 0 writes to
// *dst the f32 sum of the raw accumulator tile in shared memory (and of the
// GLU's gate accumulator with it, TWO), over the tile's rows and cols that
// lie inside the R x C output
// only, so what lies past a ragged edge never enters the sum.  Each task
// writes its own slot of a per-task partials buffer and the wrapper sums it
// on the device: no atomics, the checksum as deterministic as the output.
template <bool TWO>
__device__ __forceinline__ void tile_checksum(const float* Cs, const float* C2s, int R, int C, int row0, int col0,
                                              float* dst) {
  __shared__ float red[kThreads / 32];
  float s = 0.0f;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (row0 + r >= R || col0 + c >= C) continue;
    s += Cs[r * kLDC + c];
    if constexpr (TWO) s += C2s[r * kLDC + c];
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) *dst = total;
}

#if SFC_DTYPE == 1
typedef bf16 ElemT;
#else
typedef float ElemT;
#endif

#if SFC_REP

// K4/K5: one 64 x 64 tile of copy `layer` of batch element blockIdx.y.  The
// table is (3, n_tasks): major (im), minor (in), layer.  Ragged edges are
// masked by the main loop (M, N and the slab's end) and by the write.
// At least 4 CTAs an SM (128 registers): a decode product split 8 ways
// has 128-1216 short CTAs, and a fourth resident CTA takes a 512-CTA
// launch (q) in one wave on 132 SMs.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads, 4) sfc_gemm_replicated_kernel(const Params p, const int k_layers,
                                                                           const int k_slab) {
  constexpr int A_ELEMS = kBM * Cfg<T>::LDA;
  constexpr int B_ELEMS = Cfg<T>::BK * Cfg<T>::LDB;
  constexpr int OPERAND_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int t = blockIdx.x;
  const int row0 = __ldg(p.tab + t) * kBM;
  const int col0 = __ldg(p.tab + p.n_tasks + t) * kBN;
  const int layer = __ldg(p.tab + 2 * p.n_tasks + t);
  const long long bi = blockIdx.y;
  const T* A = static_cast<const T*>(p.a) + bi * p.a_bstride;
  const T* B = static_cast<const T*>(p.b) + bi * p.b_bstride;
  const int k_lo = (int)min((long long)layer * k_slab, (long long)p.K);
  const int k_hi = (int)min((long long)k_lo + k_slab, (long long)p.K);
  mainloop<false>(p, p.M, A, B, nullptr, row0, col0, k_lo, k_hi, As, Bs, nullptr, Cs, nullptr);
  __syncthreads();
  OutT* out = static_cast<OutT*>(p.out) + (bi * k_layers + layer) * (long long)p.M * p.N;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < p.M && gc < p.N) out[(size_t)gr * p.N + gc] = from_f32<OutT>(Cs[r * kLDC + c]);
  }
}

constexpr int kReduceThreads = 256;

// K6: out[b, j] = sum over l of copies[b, l, j], in f32 in layer order, cast
// once to T; total = batch * mn outputs.  vec: mn is a whole number of
// 16-byte vectors and both arrays start 16-byte aligned, so each thread
// reads one vector of every copy and writes one.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) add_reduce_kernel(const T* __restrict__ c, T* __restrict__ out,
                                                                     int layers, long long mn, long long total,
                                                                     int vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const long long stride = (long long)gridDim.x * kReduceThreads;
  const long long first = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (vec) {
    for (long long e = first * VEC; e < total; e += stride * VEC) {
      const long long b = e / mn, j = e - b * mn;
      const T* src = c + b * layers * mn + j;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      for (int l = 0; l < layers; ++l) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + l * mn));
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += to_f32(x[i]);
      }
      uint4 res;
      T* y = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = from_f32<T>(acc[i]);
      *reinterpret_cast<uint4*>(out + e) = res;
    }
  } else {
    for (long long e = first; e < total; e += stride) {
      const long long b = e / mn, j = e - b * mn;
      const T* src = c + b * layers * mn + j;
      float acc = 0.0f;
      for (int l = 0; l < layers; ++l) acc += to_f32(src[l * mn]);
      out[e] = from_f32<T>(acc);
    }
  }
}

#elif !SFC_BWD

// The fused kernel's flush of one C tile from the f32 accumulators in
// shared memory: C (and the residual, the preact gate output) at c_off in
// their arrays, the bias rows at vec_off; M bounds the tile's rows.
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT>
__device__ __forceinline__ void fused_flush(const Params& p, int M, const float* Cs, const float* Cgs, int row0,
                                            int col0, long long c_off, long long vec_off) {
  const T* bias = static_cast<const T*>(p.bias) + (BIAS ? vec_off : 0);
  const T* gbias = static_cast<const T*>(p.gbias) + (GBIAS ? vec_off : 0);
  const T* res = static_cast<const T*>(p.res) + (RES ? c_off : 0);
  T* out = static_cast<T*>(p.out) + c_off;
  T* out_gate = static_cast<T*>(p.out_gate) + (PREACT ? c_off : 0);
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= p.N) continue;
    float v = Cs[r * kLDC + c];
    if constexpr (BIAS) v += to_f32(bias[gc]);
    float y;
    if constexpr (GLU) {
      float g = Cgs[r * kLDC + c];
      if constexpr (GBIAS) g += to_f32(gbias[gc]);
      if constexpr (PREACT) {
        out_gate[(size_t)gr * p.N + gc] = from_f32<T>(g);
        y = v;
      } else {
        y = activate<ACT>(g) * v;
      }
    } else {
      y = activate<ACT>(v);
    }
    if constexpr (SCALE) y *= p.out_scale;
    if constexpr (RES) y += to_f32(res[(size_t)gr * p.N + gc]);
    out[(size_t)gr * p.N + gc] = from_f32<T>(y);
  }
}

// One task's C tile: K1/K2 (batch element blockIdx.y) or, GROUPED, K3 (the
// task's expert's packed rows against its own weights and bias rows; its
// row block is renumbered from the expert's first padded block, and the
// expert's row count masks its last block).  ABFT: the checksum lane, the
// sum of the raw accumulators (both for the GLU) before the epilogue, into
// chk[blockIdx.y * n_tasks + blockIdx.x]; the flush is the same code.
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT, bool GROUPED,
          bool ABFT = false>
__device__ __forceinline__ void fused_tile(const Params& p, const GroupRows& g, float* chk = nullptr) {
  static_assert(!PREACT || (GLU && !SCALE && !RES), "preact flushes the two biased pre-activations");
  static_assert(!GROUPED || !RES, "the grouped mode has no residual");
  constexpr int A_ELEMS = kBM * Cfg<T>::LDA;
  constexpr int B_ELEMS = Cfg<T>::BK * Cfg<T>::LDB;
  constexpr int OPERAND_BYTES = (A_ELEMS + B_ELEMS * (GLU ? 2 : 1)) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float) * (GLU ? 2 : 1);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory is capped at 48 KB");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + A_ELEMS;
  T* Bgs = Bs + B_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);
  float* Cgs = Cs + kBM * kLDC;

  // the task's C tile, in curve order
  const int t = blockIdx.x;
  int row0 = __ldg(p.tab + t) * kBM;
  const int col0 = __ldg(p.tab + p.n_tasks + t) * kBN;
  const long long bi = blockIdx.y;
  const T* A = static_cast<const T*>(p.a) + bi * p.a_bstride;
  const T* B = static_cast<const T*>(p.b) + bi * p.b_bstride;
  const T* Bg = static_cast<const T*>(p.bg);  // GLU weights are shared
  if constexpr (GROUPED) {
    int M = p.M;
    long long c_off = bi * (long long)p.M * p.N, vec_off = 0;
    if (g.grp != nullptr) {  // always taken; a run-time branch all the same (sfc_gemm_grouped_kernel)
      const int e = __ldg(p.tab + 2 * p.n_tasks + t);
      const int r_start = __ldg(g.grp + e);
      M = __ldg(g.grp + g.n_groups + e);
      row0 -= __ldg(g.grp + 2 * g.n_groups + e) * kBM;
      const size_t w_off = (size_t)e * p.K * p.N;
      A = static_cast<const T*>(p.a) + (size_t)r_start * p.K;
      B = static_cast<const T*>(p.b) + w_off;
      if constexpr (GLU) Bg += w_off;
      c_off = (long long)r_start * p.N;
      vec_off = (long long)e * p.N;
    }
    mainloop<GLU>(p, M, A, B, Bg, row0, col0, 0, p.K, As, Bs, Bgs, Cs, Cgs);
    __syncthreads();
    fused_flush<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT>(p, M, Cs, Cgs, row0, col0, c_off, vec_off);
    if constexpr (ABFT) tile_checksum<GLU>(Cs, Cgs, M, p.N, row0, col0, chk + t);
  } else {
    mainloop<GLU>(p, p.M, A, B, Bg, row0, col0, 0, p.K, As, Bs, Bgs, Cs, Cgs);
    __syncthreads();
    fused_flush<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT>(p, p.M, Cs, Cgs, row0, col0, bi * (long long)p.M * p.N,
                                                              0);
    if constexpr (ABFT) tile_checksum<GLU>(Cs, Cgs, p.M, p.N, row0, col0, chk + bi * p.n_tasks + t);
  }
}

// K1/K2
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT>
__global__ void __launch_bounds__(kThreads) sfc_gemm_fused_kernel(const Params p) {
  fused_tile<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, false>(p, GroupRows{nullptr, 0});
}

// K3, the grouped mode: a kernel of its own so that a profiler trace tells
// it from K1/K2.  The entry launches it only with a grp array, yet its
// offsets sit on a run-time branch: with the branch resolved at compile
// time nvcc spent more registers on the tile (the bf16 GLU 250 in place of
// 168, w_out 135 in place of 102), fewer CTAs fit an SM, and the grouped
// launches ran 1.01-1.54x slower at olmoe's shapes on an H100
// (scripts/dense_kernel_ab.py).
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool PREACT>
__global__ void __launch_bounds__(kThreads) sfc_gemm_grouped_kernel(const Params p, const GroupRows g) {
  fused_tile<T, GLU, ACT, BIAS, GBIAS, SCALE, false, PREACT, true>(p, g);
}

#if SFC_ABFT
// The checksum lane's kernels (a build part of their own, -DSFC_ABFT=1):
// K1/K2 and K3 with the lane, under names of their own, so the parts
// above keep their code.
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT>
__global__ void __launch_bounds__(kThreads) sfc_gemm_fused_abft_kernel(const Params p, float* chk) {
  fused_tile<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, false, true>(p, GroupRows{nullptr, 0}, chk);
}

template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool PREACT>
__global__ void __launch_bounds__(kThreads) sfc_gemm_grouped_abft_kernel(const Params p, const GroupRows g,
                                                                          float* chk) {
  fused_tile<T, GLU, ACT, BIAS, GBIAS, SCALE, false, PREACT, true, true>(p, g, chk);
}
#endif

template <bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT = false>
void launch(const Params& p, const GroupRows& g, float* chk, dim3 grid, cudaStream_t s) {
#if SFC_ABFT
  if constexpr (!RES) {
    if (g.grp != nullptr) {
      sfc_gemm_grouped_abft_kernel<ElemT, SFC_GLU != 0, SFC_ACT, BIAS, GBIAS, SCALE, PREACT>
          <<<grid, kThreads, 0, s>>>(p, g, chk);
      return;
    }
  }
  sfc_gemm_fused_abft_kernel<ElemT, SFC_GLU != 0, SFC_ACT, BIAS, GBIAS, SCALE, RES, PREACT>
      <<<grid, kThreads, 0, s>>>(p, chk);
#else
  (void)chk;
  if constexpr (!RES) {  // the entry refuses a residual in the grouped mode
    if (g.grp != nullptr) {
      sfc_gemm_grouped_kernel<ElemT, SFC_GLU != 0, SFC_ACT, BIAS, GBIAS, SCALE, PREACT>
          <<<grid, kThreads, 0, s>>>(p, g);
      return;
    }
  }
  sfc_gemm_fused_kernel<ElemT, SFC_GLU != 0, SFC_ACT, BIAS, GBIAS, SCALE, RES, PREACT>
      <<<grid, kThreads, 0, s>>>(p);
#endif
}

template <bool BIAS, bool GBIAS, bool SCALE>
void launch_res(const Params& p, const GroupRows& g, float* chk, dim3 grid, cudaStream_t s) {
  if (p.res)
    launch<BIAS, GBIAS, SCALE, true>(p, g, chk, grid, s);
  else
    launch<BIAS, GBIAS, SCALE, false>(p, g, chk, grid, s);
}

template <bool BIAS, bool GBIAS>
void launch_scale(const Params& p, const GroupRows& g, float* chk, bool scale, dim3 grid, cudaStream_t s) {
#if SFC_GLU
  if (p.out_gate) {  // preact: the entry has refused a scale and a residual
    launch<BIAS, GBIAS, false, false, true>(p, g, chk, grid, s);
    return;
  }
#endif
  if (scale)
    launch_res<BIAS, GBIAS, true>(p, g, chk, grid, s);
  else
    launch_res<BIAS, GBIAS, false>(p, g, chk, grid, s);
}

template <bool BIAS>
void launch_gbias(const Params& p, const GroupRows& g, float* chk, bool scale, dim3 grid, cudaStream_t s) {
#if SFC_GLU
  if (p.gbias) {
    launch_scale<BIAS, true>(p, g, chk, scale, grid, s);
    return;
  }
#endif
  launch_scale<BIAS, false>(p, g, chk, scale, grid, s);
}

#if SFC_DTYPE == 1 && defined(SFC_CLUSTER_ENTRY)

// ---------------------------------------------------------------------------
// K1 at M <= 16 rows: split-K across a thread-block cluster (bf16 parts)
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;  // A rows the cluster kernel takes (build.py SPLIT_MAX_ROWS)
constexpr int kMaxLayers = 8;   // CTAs (K layers) a cluster, a portable cluster (build.py MAX_CLUSTER_LAYERS)

// The ring of (A, B[, B_gate]) stages in dynamic shared memory; after the
// main loop the f32 partial tiles of the two K halves (and their gates)
// alias it.  Three GLU stages or four plain ones keep 3 or 4 CTAs an SM.
template <bool GLU>
struct SplitCfg {
  static constexpr int BK = Cfg<bf16>::BK;
  static constexpr int LDA = Cfg<bf16>::LDA;
  static constexpr int LDB = Cfg<bf16>::LDB;
  static constexpr int STAGES = GLU ? 3 : 4;
  static constexpr int A_ELEMS = kSplitRows * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS * (GLU ? 2 : 1);
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int C_FLOATS = kSplitRows * kLDC;  // one f32 partial tile
  static constexpr int SETS = GLU ? 2 : 1;            // the tile, and the gate's
  static constexpr int C_BYTES = 2 * SETS * C_FLOATS * 4;
  static constexpr int BYTES = RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
};

// K rows [k0, k0 + BK) clipped to k_hi and the tile's 64 columns clipped to
// N of a (K, N) weight into a stage, zeros outside: 16-byte cp.async copies
// when rows are whole vectors (vec_b), else element loads.
__device__ __forceinline__ void split_stage_b(const Params& p, const bf16* B, int col0, int k0, int k_hi, bf16* Bs) {
  constexpr int BK = SplitCfg<false>::BK, LDB = SplitCfg<false>::LDB;
  if (p.vec_b) {
    for (int i = threadIdx.x; i < BK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool in = k0 + r < k_hi && col0 + c < p.N;
      cp_async16(Bs + r * LDB + c, in ? B + (size_t)(k0 + r) * p.N + col0 + c : B, in);
    }
  } else {
    for (int i = threadIdx.x; i < BK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const bool in = k0 + r < k_hi && col0 + c < p.N;
      Bs[r * LDB + c] = in ? B[(size_t)(k0 + r) * p.N + col0 + c] : from_f32<bf16>(0.0f);
    }
  }
}

// One stage: the M rows of A over [k0, k0 + BK) (vec_a: 16-byte copies,
// one a thread; the slab and K are whole vectors) and the weights' rows.
template <bool GLU>
__device__ __forceinline__ void split_issue(const Params& p, int col0, int k0, int k_hi, bf16* st) {
  using C = SplitCfg<GLU>;
  const bf16* A = static_cast<const bf16*>(p.a);
  bf16* As = st;
  if (p.vec_a) {
    const int r = threadIdx.x / (C::BK / 8), c = (threadIdx.x % (C::BK / 8)) * 8;
    if (r < p.M) {
      const bool in = k0 + c < k_hi;
      cp_async16(As + r * C::LDA + c, in ? A + (size_t)r * p.K + k0 + c : A, in);
    }
  } else {
    for (int i = threadIdx.x; i < p.M * C::BK; i += kThreads) {
      const int r = i / C::BK, c = i % C::BK;
      As[r * C::LDA + c] = k0 + c < k_hi ? A[(size_t)r * p.K + k0 + c] : from_f32<bf16>(0.0f);
    }
  }
  split_stage_b(p, static_cast<const bf16*>(p.b), col0, k0, k_hi, st + C::A_ELEMS);
  if constexpr (GLU) split_stage_b(p, static_cast<const bf16*>(p.bg), col0, k0, k_hi, st + C::A_ELEMS + C::B_ELEMS);
}

// The CTA's product over K rows [k_lo, k_hi) into Cs (and Cs + C_FLOATS,
// the gate), rows < M of a 16 x 64 f32 tile at row stride kLDC (A's rows
// past M in the ring are never written: they reach only C rows past M,
// which nothing reads).  Swap-AB on
// the tensor cores: the weight tile is the 32-row operand (32 columns of C
// by 16 of K, read col-major from its stage) and A the 8-column one (16 of
// K by 8 rows of C), WMMA 32x8x16.  Warp w takes C columns 32 (w & 1) and
// the k16 steps w >> 1, w >> 1 + 2 of each BK step; the two K halves'
// tiles are added in order at the end.
template <bool GLU>
__device__ __forceinline__ void split_mainloop(const Params& p, int col0, int k_lo, int k_hi, unsigned char* smem,
                                               float* Cs) {
  using namespace nvcuda;
  using C = SplitCfg<GLU>;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  const int wn = warp & 1, kh = warp >> 1;
  const int mt = (p.M + 7) / 8;  // 8-row slices of C that hold rows
  wmma::fragment<wmma::accumulator, 32, 8, 16, float> acc[2], accg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::fill_fragment(acc[i], 0.0f);
    if constexpr (GLU) wmma::fill_fragment(accg[i], 0.0f);
  }
  const int nsteps = k_hi > k_lo ? (k_hi - k_lo + C::BK - 1) / C::BK : 0;
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nsteps) split_issue<GLU>(p, col0, k_lo + st * C::BK, k_hi, ring + st * C::STAGE_ELEMS);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's stage
    const int nxt = s + C::STAGES - 1;
    if (nxt < nsteps) split_issue<GLU>(p, col0, k_lo + nxt * C::BK, k_hi, ring + (nxt % C::STAGES) * C::STAGE_ELEMS);
    cp_async_commit();
    const bf16* As = ring + (s % C::STAGES) * C::STAGE_ELEMS;
    const bf16* Bs = As + C::A_ELEMS;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = (kh + 2 * j) * 16;
      wmma::fragment<wmma::matrix_a, 32, 8, 16, bf16, wmma::col_major> wa;
      wmma::fragment<wmma::matrix_b, 32, 8, 16, bf16, wmma::col_major> xb[2];
      wmma::load_matrix_sync(wa, Bs + kk * C::LDB + wn * 32, C::LDB);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi < mt) {
          wmma::load_matrix_sync(xb[mi], As + mi * 8 * C::LDA + kk, C::LDA);
          wmma::mma_sync(acc[mi], wa, xb[mi], acc[mi]);
        }
      }
      if constexpr (GLU) {
        wmma::load_matrix_sync(wa, Bs + C::B_ELEMS + kk * C::LDB + wn * 32, C::LDB);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi < mt) wmma::mma_sync(accg[mi], wa, xb[mi], accg[mi]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the partial tiles alias the ring
  float* half = Cs + kh * C::SETS * C::C_FLOATS;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi < mt) {
      wmma::store_matrix_sync(half + mi * 8 * kLDC + wn * 32, acc[mi], kLDC, wmma::mem_col_major);
      if constexpr (GLU) {
        wmma::store_matrix_sync(half + C::C_FLOATS + mi * 8 * kLDC + wn * 32, accg[mi], kLDC, wmma::mem_col_major);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C::SETS * p.M * kBN; i += kThreads) {
    const int set = i / (p.M * kBN), e = i % (p.M * kBN);
    float* c = Cs + set * C::C_FLOATS + (e / kBN) * kLDC + e % kBN;
    *c += c[C::SETS * C::C_FLOATS];
  }
}

// One C tile of a plain-mode product with M <= 16 rows: the cluster of
// `layers` CTAs of task blockIdx.x / layers, CTA l (its rank) running the
// K slab [l * slab, (l + 1) * slab) clipped to K.  After cluster.sync()
// the leader adds its peers' f32 tiles, read through distributed shared
// memory, in layer order (P_0 + P_1 + ... + P_{L-1}), then flushes the
// epilogue once; ABFT: the lane sums that raw tile before the epilogue.
template <bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT, bool ABFT>
__device__ __forceinline__ void cluster_tile(const Params& p, int slab, float* chk) {
  namespace cg = cooperative_groups;
  using C = SplitCfg<GLU>;
  extern __shared__ __align__(128) unsigned char split_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int layers = (int)cluster.num_blocks();
  const int layer = (int)cluster.block_rank();
  const int t = blockIdx.x / layers;
  const int col0 = __ldg(p.tab + p.n_tasks + t) * kBN;  // one row block: the major row is 0
  const int k_lo = (int)min((long long)layer * slab, (long long)p.K);
  const int k_hi = (int)min((long long)k_lo + slab, (long long)p.K);
  float* Cs = reinterpret_cast<float*>(split_smem);
  split_mainloop<GLU>(p, col0, k_lo, k_hi, split_smem, Cs);
  cluster.sync();  // every layer's partial tile is in its CTA's shared memory
  if (layer == 0) {
    for (int i = threadIdx.x; i < C::SETS * p.M * kBN; i += kThreads) {
      const int set = i / (p.M * kBN), e = i % (p.M * kBN);
      const int off = set * C::C_FLOATS + (e / kBN) * kLDC + e % kBN;
      float v = Cs[off];
      for (int l = 1; l < layers; ++l) v += cluster.map_shared_rank(Cs, l)[off];
      Cs[off] = v;
    }
  }
  cluster.sync();  // the leader has read every peer (they may exit) and holds the sum
  if (layer != 0) return;
  fused_flush<bf16, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT>(p, p.M, Cs, Cs + C::C_FLOATS, 0, col0, 0, 0);
  if constexpr (ABFT) tile_checksum<GLU>(Cs, Cs + C::C_FLOATS, p.M, p.N, 0, col0, chk + t);
}

// The CTAs an SM holds (the ring's size allows as many): 3 for the GLU, 4
// otherwise, up to 170 and 128 registers a thread.
#if SFC_ABFT
template <bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT>
__global__ void __launch_bounds__(kThreads, GLU ? 3 : 4)
    sfc_gemm_cluster_abft_kernel(const Params p, const int slab, float* chk) {
  cluster_tile<GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, true>(p, slab, chk);
}
#else
template <bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT>
__global__ void __launch_bounds__(kThreads, GLU ? 3 : 4) sfc_gemm_cluster_kernel(const Params p, const int slab) {
  cluster_tile<GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, false>(p, slab, nullptr);
}
#endif

template <bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT = false>
int cluster_launch(const Params& p, float* chk, int layers, int slab, cudaStream_t s) {
  constexpr bool GLU = SFC_GLU != 0;
#if SFC_ABFT
  const auto kernel = &sfc_gemm_cluster_abft_kernel<GLU, SFC_ACT, BIAS, GBIAS, SCALE, RES, PREACT>;
#else
  const auto kernel = &sfc_gemm_cluster_kernel<GLU, SFC_ACT, BIAS, GBIAS, SCALE, RES, PREACT>;
#endif
  constexpr size_t bytes = SplitCfg<GLU>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in[kMaxDevices] = {};
  const int rc = opt_in(kernel, bytes, opted_in);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.n_tasks * layers));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)layers;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#if SFC_ABFT
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, slab, chk);
#else
  (void)chk;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, slab);
#endif
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool BIAS, bool GBIAS, bool SCALE>
int cluster_launch_res(const Params& p, float* chk, int layers, int slab, cudaStream_t s) {
  if (p.res) return cluster_launch<BIAS, GBIAS, SCALE, true>(p, chk, layers, slab, s);
  return cluster_launch<BIAS, GBIAS, SCALE, false>(p, chk, layers, slab, s);
}

template <bool BIAS, bool GBIAS>
int cluster_launch_scale(const Params& p, float* chk, bool scale, int layers, int slab, cudaStream_t s) {
#if SFC_GLU
  if (p.out_gate) return cluster_launch<BIAS, GBIAS, false, false, true>(p, chk, layers, slab, s);
#endif
  if (scale) return cluster_launch_res<BIAS, GBIAS, true>(p, chk, layers, slab, s);
  return cluster_launch_res<BIAS, GBIAS, false>(p, chk, layers, slab, s);
}

template <bool BIAS>
int cluster_launch_gbias(const Params& p, float* chk, bool scale, int layers, int slab, cudaStream_t s) {
#if SFC_GLU
  if (p.gbias) return cluster_launch_scale<BIAS, true>(p, chk, scale, layers, slab, s);
#endif
  return cluster_launch_scale<BIAS, false>(p, chk, scale, layers, slab, s);
}

#endif  // SFC_DTYPE == 1 && SFC_CLUSTER_ENTRY

#else  // SFC_BWD

struct BwdParams {
  const void* a;
  const void* b;
  const void* a2;  // NT dual: second addend's A (else null)
  const void* b2;  // NT / TN dual: second B (else null)
  void* out;
  void* out2;      // TN dual: second output
  const int* tab;  // (2, n_tasks) gilbert table over the (R, C) output tiles
  int n_tasks;
  int R, C, D;     // output rows, output cols, contraction length
  int vec_a, vec_b;
  // grouped mode (null otherwise): (3, n_groups) per-expert row start, row
  // count and first padded row block; the table's third row is the expert
  const int* grp;
  int n_groups;
};

// Shared-memory strides of the NT operand tiles (64 output rows or cols x
// BK contraction) and of the TN ones (BK contraction rows x 64).
template <typename T>
struct NtCfg {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int LD = BK + 16 / (int)sizeof(T);
};
template <typename T>
struct TnCfg {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int LD = kBM + 16 / (int)sizeof(T);
};

// NT, bf16: 4 warps in a 2 x 2 grid of 32 x 32 quarters.  Both tiles are
// stored (64, BK) row-major; the B tile read as col_major is B^T.
template <bool DUAL>
__device__ __forceinline__ void nt_mainloop(const BwdParams& p, const bf16* A, const bf16* B, const bf16* A2,
                                            const bf16* B2, int R, int row0, int col0, bf16* As, bf16* Bs,
                                            bf16* A2s, bf16* B2s, float* Cs) {
  using namespace nvcuda;
  constexpr int BK = NtCfg<bf16>::BK, LD = NtCfg<bf16>::LD;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  for (int k0 = 0; k0 < p.D; k0 += BK) {
    __syncthreads();
    load_tile<bf16, kBM, BK, LD>(As, A, p.D, row0, k0, R, p.D, p.vec_a);
    load_tile<bf16, kBN, BK, LD>(Bs, B, p.D, col0, k0, p.C, p.D, p.vec_b);
    if constexpr (DUAL) {
      load_tile<bf16, kBM, BK, LD>(A2s, A2, p.D, row0, k0, R, p.D, p.vec_a);
      load_tile<bf16, kBN, BK, LD>(B2s, B2, p.D, col0, k0, p.C, p.D, p.vec_b);
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < (DUAL ? 2 : 1); ++pass) {
      const bf16* as = pass ? A2s : As;
      const bf16* bs = pass ? B2s : Bs;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * LD + kk, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], bs + (wn * 32 + j * 16) * LD + kk, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // Cs aliases the operand tiles
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16, acc[i][j], kLDC,
                              wmma::mem_row_major);
    }
  }
}

// NT, f32: SIMT FMAs in full f32; threads form an 8 (cols) x 16 (rows) grid,
// each owning 4 rows x 8 cols of the C tile.
template <bool DUAL>
__device__ __forceinline__ void nt_mainloop(const BwdParams& p, const float* A, const float* B, const float* A2,
                                            const float* B2, int R, int row0, int col0, float* As, float* Bs,
                                            float* A2s, float* B2s, float* Cs) {
  constexpr int BK = NtCfg<float>::BK, LD = NtCfg<float>::LD;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < p.D; k0 += BK) {
    __syncthreads();
    load_tile<float, kBM, BK, LD>(As, A, p.D, row0, k0, R, p.D, p.vec_a);
    load_tile<float, kBN, BK, LD>(Bs, B, p.D, col0, k0, p.C, p.D, p.vec_b);
    if constexpr (DUAL) {
      load_tile<float, kBM, BK, LD>(A2s, A2, p.D, row0, k0, R, p.D, p.vec_a);
      load_tile<float, kBN, BK, LD>(B2s, B2, p.D, col0, k0, p.C, p.D, p.vec_b);
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < (DUAL ? 2 : 1); ++pass) {
      const float* as = pass ? A2s : As;
      const float* bs = pass ? B2s : Bs;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(ty * 4 + i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bs[(tx * 8 + j) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * kLDC + tx * 8 + j] = acc[i][j];
  }
}

// TN, bf16: the (BK, 64) A panel read as col_major is the A^T slab; B and
// B2 are (BK, 64) row-major slabs of dC.
template <bool DUAL>
__device__ __forceinline__ void tn_mainloop(const BwdParams& p, const bf16* A, const bf16* B, const bf16* B2, int D,
                                            int row0, int col0, bf16* As, bf16* Bs,
                                            bf16* B2s, float* Cs, float* C2s) {
  using namespace nvcuda;
  constexpr int BK = TnCfg<bf16>::BK, LD = TnCfg<bf16>::LD;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if constexpr (DUAL) wmma::fill_fragment(acc2[i][j], 0.0f);
    }
  }
  for (int m0 = 0; m0 < D; m0 += BK) {
    __syncthreads();
    load_tile<bf16, BK, kBM, LD>(As, A, p.R, m0, row0, D, p.R, p.vec_a);
    load_tile<bf16, BK, kBN, LD>(Bs, B, p.C, m0, col0, D, p.C, p.vec_b);
    if constexpr (DUAL) load_tile<bf16, BK, kBN, LD>(B2s, B2, p.C, m0, col0, D, p.C, p.vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], As + kk * LD + wm * 32 + i * 16, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], Bs + kk * LD + wn * 32 + j * 16, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      if constexpr (DUAL) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], B2s + kk * LD + wn * 32 + j * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc2[i][j], af[i], bf[j], acc2[i][j]);
        }
      }
    }
  }
  __syncthreads();  // Cs/C2s alias the operand tiles
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16;
      wmma::store_matrix_sync(Cs + off, acc[i][j], kLDC, wmma::mem_row_major);
      if constexpr (DUAL) wmma::store_matrix_sync(C2s + off, acc2[i][j], kLDC, wmma::mem_row_major);
    }
  }
}

// TN, f32: SIMT; a thread owns 4 rows x 8 cols of the C tile (and of C2).
template <bool DUAL>
__device__ __forceinline__ void tn_mainloop(const BwdParams& p, const float* A, const float* B, const float* B2, int D,
                                            int row0, int col0, float* As, float* Bs,
                                            float* B2s, float* Cs, float* C2s) {
  constexpr int BK = TnCfg<float>::BK, LD = TnCfg<float>::LD;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[4][8];
  float acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.0f;
      acc2[i][j] = 0.0f;
    }
  }
  for (int m0 = 0; m0 < D; m0 += BK) {
    __syncthreads();
    load_tile<float, BK, kBM, LD>(As, A, p.R, m0, row0, D, p.R, p.vec_a);
    load_tile<float, BK, kBN, LD>(Bs, B, p.C, m0, col0, D, p.C, p.vec_b);
    if constexpr (DUAL) load_tile<float, BK, kBN, LD>(B2s, B2, p.C, m0, col0, D, p.C, p.vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LD + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * LD + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if constexpr (DUAL) {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = B2s[kk * LD + tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(a[i], b[j], acc2[i][j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Cs[(ty * 4 + i) * kLDC + tx * 8 + j] = acc[i][j];
      if constexpr (DUAL) C2s[(ty * 4 + i) * kLDC + tx * 8 + j] = acc2[i][j];
    }
  }
}

// Coalesced flush of one f32 C tile (in shared memory) into an (R, C)
// row-major output, masked at the ragged edge: one rounding to T.
template <typename T>
__device__ __forceinline__ void flush_tile(const float* Cs, T* out, int row0, int col0, int R, int C) {
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < R && gc < C) out[(size_t)gr * C + gc] = from_f32<T>(Cs[r * kLDC + c]);
  }
}

// One task's output tile of the NT kernel: out (R, p.C) = A @ B^T
// (+ A2 @ B2^T), the operands already at the tile's matrix.
template <typename T, bool DUAL>
__device__ __forceinline__ void nt_tile(const BwdParams& p, const T* A, const T* B, const T* A2, const T* B2, T* out,
                                        int R, int row0, int col0) {
  constexpr int TILE = kBM * NtCfg<T>::LD;
  constexpr int OPERAND_BYTES = TILE * (DUAL ? 4 : 2) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory is capped at 48 KB");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE;
  T* A2s = Bs + TILE;
  T* B2s = A2s + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  nt_mainloop<DUAL>(p, A, B, A2, B2, R, row0, col0, As, Bs, A2s, B2s, Cs);
  __syncthreads();
  flush_tile<T>(Cs, out, row0, col0, R, p.C);
}

// K7
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads) nt_kernel(const BwdParams p) {
  const int t = blockIdx.x;
  nt_tile<T, DUAL>(p, static_cast<const T*>(p.a), static_cast<const T*>(p.b), static_cast<const T*>(p.a2),
                   static_cast<const T*>(p.b2), static_cast<T*>(p.out), p.R, __ldg(p.tab + t) * kBM,
                   __ldg(p.tab + p.n_tasks + t) * kBN);
}

// K9, a kernel of its own for the trace: the dC rows of the task's expert
// against its (C, D) weight slab, into the expert's rows of dA.  The
// offsets sit on a run-time branch, as K3's do (bf16 dual: 96 registers,
// 168 with the branch resolved at compile time).
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads) grouped_nt_kernel(const BwdParams p) {
  const int t = blockIdx.x;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const T* a2 = static_cast<const T*>(p.a2);
  const T* b2 = static_cast<const T*>(p.b2);
  T* out = static_cast<T*>(p.out);
  int rows = p.R;
  int row0 = __ldg(p.tab + t) * kBM;
  if (p.grp != nullptr) {
    const int e = __ldg(p.tab + 2 * p.n_tasks + t);
    const size_t r_start = (size_t)__ldg(p.grp + e);
    const size_t w_off = (size_t)e * p.C * p.D;
    a += r_start * p.D;
    b += w_off;
    if constexpr (DUAL) {
      a2 += r_start * p.D;
      b2 += w_off;
    }
    out += r_start * p.C;
    rows = __ldg(p.grp + p.n_groups + e);
    row0 -= __ldg(p.grp + 2 * p.n_groups + e) * kBM;
  }
  nt_tile<T, DUAL>(p, a, b, a2, b2, out, rows, row0, __ldg(p.tab + p.n_tasks + t) * kBN);
}

// One task's output tile of the TN kernel: out (p.R, p.C) = A^T @ B (and
// out2 = A^T @ B2), the contraction over D rows, the operands already at
// the tile's matrix.  ABFT: the checksum lane, each set's raw dW tile
// summed apart into chk[set * n_tasks + blockIdx.x]; the flush is the same.
template <typename T, bool DUAL, bool ABFT = false>
__device__ __forceinline__ void tn_tile(const BwdParams& p, const T* A, const T* B, const T* B2, T* out, T* out2,
                                        int D, int row0, int col0, float* chk = nullptr) {
  constexpr int TILE = TnCfg<T>::BK * TnCfg<T>::LD;
  constexpr int OPERAND_BYTES = TILE * (DUAL ? 3 : 2) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float) * (DUAL ? 2 : 1);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory is capped at 48 KB");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE;
  T* B2s = Bs + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  float* C2s = Cs + kBM * kLDC;
  tn_mainloop<DUAL>(p, A, B, B2, D, row0, col0, As, Bs, B2s, Cs, C2s);
  __syncthreads();
  flush_tile<T>(Cs, out, row0, col0, p.R, p.C);
  if constexpr (DUAL) flush_tile<T>(C2s, out2, row0, col0, p.R, p.C);
  if constexpr (ABFT) {
    tile_checksum<false>(Cs, nullptr, p.R, p.C, row0, col0, chk + blockIdx.x);
    if constexpr (DUAL) tile_checksum<false>(C2s, nullptr, p.R, p.C, row0, col0, chk + p.n_tasks + blockIdx.x);
  }
}

// K8 dW
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads) tn_kernel(const BwdParams p) {
  const int t = blockIdx.x;
  tn_tile<T, DUAL>(p, static_cast<const T*>(p.a), static_cast<const T*>(p.b), static_cast<const T*>(p.b2),
                   static_cast<T*>(p.out), static_cast<T*>(p.out2), p.D, __ldg(p.tab + t) * kBM,
                   __ldg(p.tab + p.n_tasks + t) * kBN);
}

#if SFC_ABFT
// K8 dW with the checksum lane (the -DSFC_BWD=1 -DSFC_ABFT=1 part)
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads) tn_abft_kernel(const BwdParams p, float* chk) {
  const int t = blockIdx.x;
  tn_tile<T, DUAL, true>(p, static_cast<const T*>(p.a), static_cast<const T*>(p.b), static_cast<const T*>(p.b2),
                         static_cast<T*>(p.out), static_cast<T*>(p.out2), p.D, __ldg(p.tab + t) * kBM,
                         __ldg(p.tab + p.n_tasks + t) * kBN, chk);
}
#endif

// K10 dW, a kernel of its own for the trace: the contraction runs over the
// task's expert's rows only, and the tile lands in the expert's (R, C)
// slice of the (E, R, C) output.  The offsets sit on a run-time branch,
// as K3's do (bf16 dual: 128 registers, 182 with the branch resolved at
// compile time).
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads) grouped_tn_kernel(const BwdParams p) {
  const int t = blockIdx.x;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const T* b2 = static_cast<const T*>(p.b2);
  T* out = static_cast<T*>(p.out);
  T* out2 = static_cast<T*>(p.out2);
  int depth = p.D;
  if (p.grp != nullptr) {
    const int e = __ldg(p.tab + 2 * p.n_tasks + t);
    const size_t r_start = (size_t)__ldg(p.grp + e);
    const size_t o_off = (size_t)e * p.R * p.C;
    a += r_start * p.R;
    b += r_start * p.C;
    out += o_off;
    if constexpr (DUAL) {
      b2 += r_start * p.C;
      out2 += o_off;
    }
    depth = __ldg(p.grp + p.n_groups + e);
  }
  tn_tile<T, DUAL>(p, a, b, b2, out, out2, depth, __ldg(p.tab + t) * kBM, __ldg(p.tab + p.n_tasks + t) * kBN);
}

BwdParams bwd_params(const void* a, const void* b, const void* a2, const void* b2, void* out, void* out2,
                     const int* tab, int n_tasks, int R, int C, int D, int vec_a, int vec_b) {
  BwdParams p;
  p.a = a;
  p.b = b;
  p.a2 = a2;
  p.b2 = b2;
  p.out = out;
  p.out2 = out2;
  p.tab = tab;
  p.n_tasks = n_tasks;
  p.R = R;
  p.C = C;
  p.D = D;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  p.grp = nullptr;
  p.n_groups = 0;
  return p;
}

#if SFC_BWD == 2

// lanes of the (12,) hyper vector (optim/adamw.py HYP_*); the salt lane is
// not read, the salt is an argument
enum { kLR, kB1, k1MB1, kB2, k1MB2, kEPS, kWD, kB1C, kB2C, kSCALE, kSEED };

struct UpdParams {
  void* w;  // update mode: W (R, C) in the input type, written in place
  void* w2;
  float* mst;  // f32 master, mu, nu (R, C), read and written in place
  float* mu;
  float* nu;
  float* mst2;
  float* mu2;
  float* nu2;
  const float* hyper;  // null: norm mode
  unsigned salt;
  float* partials;  // (n_sets, n_tasks): each task's sum(dW^2)
};

// repro/kernels/sfc_gemm.py::_hash_u32 (murmur3-style finalizer)
__device__ __forceinline__ unsigned hash_u32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// repro/kernels/sfc_gemm.py::_tile_seed: the step's bits, the weight's salt,
// the tile (im, in), and one more salt of 1 for the dual form's second set
__device__ __forceinline__ unsigned tile_seed(unsigned step_bits, unsigned salt, unsigned im, unsigned in,
                                              int set) {
  unsigned h = hash_u32(step_bits ^ 0x2545F491u);
  h = hash_u32(h ^ salt * 0x85EBCA77u);
  h = hash_u32(h ^ im * 0x9E3779B1u);
  h = hash_u32(h ^ in * 0x9E3779B1u);
  if (set) h = hash_u32(h ^ 0x9E3779B1u);
  return h;
}

// W from the new master: a plain cast, or for bf16 with SR the stochastic
// rounding of repro/kernels/sfc_gemm.py::stochastic_round_to (non-finite
// values are cast)
template <typename T>
__device__ __forceinline__ T write_w(float x, unsigned bits, bool sr);
template <>
__device__ __forceinline__ float write_w<float>(float x, unsigned, bool) {
  return x;
}
template <>
__device__ __forceinline__ bf16 write_w<bf16>(float x, unsigned bits, bool sr) {
  const unsigned u = __float_as_uint(x);
  if (sr && (u & 0x7F800000u) != 0x7F800000u) x = __uint_as_float((u + (bits & 0xFFFFu)) & 0xFFFF0000u);
  return __float2bfloat16(x);  // exact after the truncation
}

// One set's flush from the f32 C tile in shared memory: sum(dW^2), and in
// update mode AdamW in the TPU kernel's expression order.
template <typename T, bool UPDATE, bool SR>
__device__ __forceinline__ void update_flush(const float* Cs, const BwdParams& p, const UpdParams& u, int set,
                                             const float* hv, unsigned seed, int row0, int col0, float* red) {
  T* W = static_cast<T*>(set ? u.w2 : u.w);
  float* mst = set ? u.mst2 : u.mst;
  float* mu = set ? u.mu2 : u.mu;
  float* nu = set ? u.nu2 : u.nu;
  const bool skip = UPDATE && hv[kSCALE] == 0.0f;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= p.R || gc >= p.C) continue;
    const float acc = Cs[r * kLDC + c];
    sq = __fadd_rn(sq, __fmul_rn(acc, acc));
    if constexpr (UPDATE) {
      const size_t idx = (size_t)gr * p.C + gc;
      const float m0 = mu[idx], v0 = nu[idx], w0 = mst[idx];
      const float g = __fmul_rn(acc, hv[kSCALE]);
      float m1 = __fadd_rn(__fmul_rn(hv[kB1], m0), __fmul_rn(hv[k1MB1], g));
      float v1 = __fadd_rn(__fmul_rn(hv[kB2], v0), __fmul_rn(hv[k1MB2], __fmul_rn(g, g)));
      const float mhat = __fdiv_rn(m1, hv[kB1C]);
      const float nhat = __fdiv_rn(v1, hv[kB2C]);
      const float step = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(nhat), hv[kEPS])), __fmul_rn(hv[kWD], w0));
      float w1 = __fsub_rn(w0, __fmul_rn(hv[kLR], step));
      if (skip) {  // a select: a NaN gradient cannot reach the state
        m1 = m0;
        v1 = v0;
        w1 = w0;
      }
      mu[idx] = m1;
      nu[idx] = v1;
      mst[idx] = w1;
      unsigned bits = 0u;
      if constexpr (SR) bits = hash_u32(seed ^ ((unsigned)r * 0x9E3779B1u) ^ ((unsigned)c * 0x85EBCA77u));
      W[idx] = write_w<T>(w1, bits, SR && !skip);
    }
  }
  const float total = block_sum(sq, red);
  if (threadIdx.x == 0) u.partials[(size_t)set * p.n_tasks + blockIdx.x] = total;
}

// One task of K8's update / norm modes.  ABFT: the checksum lane, each
// set's raw dW tile (before the scale and AdamW) summed apart into
// chk[set * n_tasks + blockIdx.x].
template <typename T, bool DUAL, bool UPDATE, bool SR, bool ABFT>
__device__ __forceinline__ void tn_update_tile(const BwdParams& p, const UpdParams& u, float* chk) {
  constexpr int TILE = TnCfg<T>::BK * TnCfg<T>::LD;
  constexpr int OPERAND_BYTES = TILE * (DUAL ? 3 : 2) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float) * (DUAL ? 2 : 1);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  static_assert(SMEM_BYTES + 64 <= 48 * 1024, "static shared memory is capped at 48 KB");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[kThreads / 32];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE;
  T* B2s = Bs + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  float* C2s = Cs + kBM * kLDC;
  const int t = blockIdx.x;
  const int im = __ldg(p.tab + t), in = __ldg(p.tab + p.n_tasks + t);
  const int row0 = im * kBM, col0 = in * kBN;
  float hv[kSEED + 1];
#pragma unroll
  for (int i = 0; i <= kSEED; ++i) hv[i] = UPDATE ? __ldg(u.hyper + i) : 0.0f;
  tn_mainloop<DUAL>(p, static_cast<const T*>(p.a), static_cast<const T*>(p.b), static_cast<const T*>(p.b2), p.D,
                    row0, col0, As, Bs, B2s, Cs, C2s);
  __syncthreads();
  if constexpr (ABFT) {
    tile_checksum<false>(Cs, nullptr, p.R, p.C, row0, col0, chk + t);
    if constexpr (DUAL) tile_checksum<false>(C2s, nullptr, p.R, p.C, row0, col0, chk + p.n_tasks + t);
  }
  const unsigned step_bits = __float_as_uint(hv[kSEED]);
  update_flush<T, UPDATE, SR>(Cs, p, u, 0, hv, SR ? tile_seed(step_bits, u.salt, im, in, 0) : 0u, row0, col0,
                              red);
  if constexpr (DUAL)
    update_flush<T, UPDATE, SR>(C2s, p, u, 1, hv, SR ? tile_seed(step_bits, u.salt, im, in, 1) : 0u, row0, col0,
                                red);
}

template <typename T, bool DUAL, bool UPDATE, bool SR>
__global__ void __launch_bounds__(kThreads) tn_update_kernel(const BwdParams p, const UpdParams u) {
  tn_update_tile<T, DUAL, UPDATE, SR, false>(p, u, nullptr);
}

#if SFC_ABFT
// K8's update / norm modes with the checksum lane (the -DSFC_BWD=2
// -DSFC_ABFT=1 part)
template <typename T, bool DUAL, bool UPDATE, bool SR>
__global__ void __launch_bounds__(kThreads) tn_update_abft_kernel(const BwdParams p, const UpdParams u, float* chk) {
  tn_update_tile<T, DUAL, UPDATE, SR, true>(p, u, chk);
}
#endif

// repro/kernels/sfc_gemm.py::_grouped_tn_kernel's flush seed: `_tile_seed`
// with one more lane, 2e + set, hashed for every expert and set (K8's
// `tile_seed` adds a lane for its second set only)
__device__ __forceinline__ unsigned grouped_tile_seed(unsigned step_bits, unsigned salt, unsigned im, unsigned in,
                                                      unsigned lane) {
  return hash_u32(tile_seed(step_bits, salt, im, in, 0) ^ lane * 0x9E3779B1u);
}

// K10 update / norm (repro/kernels/sfc_gemm.py::sfc_gemm_grouped_tn with
// master, mu, nu and hyper; body `_grouped_tn_kernel`, flush
// `_apply_update_flush`), a kernel of its own for the trace: K10 dW's walk
// over the task's expert's rows (its offsets on the same run-time branch)
// feeding K8's flush, which writes W, master, mu and nu at the expert's
// (R, C) slice of the (E, R, C) stacks.  An empty expert contracts nothing
// and flushes a zero tile: the g = 0 update (moment decay and weight decay)
// in the same launch.  Bound by the state's bytes (12 B read, 14 B written
// a weight in update mode); one CTA a tile, no atomics, no padding.
template <typename T, bool DUAL, bool UPDATE, bool SR>
__global__ void __launch_bounds__(kThreads) grouped_tn_update_kernel(const BwdParams p, const UpdParams u) {
  constexpr int TILE = TnCfg<T>::BK * TnCfg<T>::LD;
  constexpr int OPERAND_BYTES = TILE * (DUAL ? 3 : 2) * (int)sizeof(T);
  constexpr int EPI_BYTES = kBM * kLDC * (int)sizeof(float) * (DUAL ? 2 : 1);
  constexpr int SMEM_BYTES = OPERAND_BYTES > EPI_BYTES ? OPERAND_BYTES : EPI_BYTES;
  static_assert(SMEM_BYTES + 64 <= 48 * 1024, "static shared memory is capped at 48 KB");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[kThreads / 32];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TILE;
  T* B2s = Bs + TILE;
  float* Cs = reinterpret_cast<float*>(smem);
  float* C2s = Cs + kBM * kLDC;
  const int t = blockIdx.x;
  const int im = __ldg(p.tab + t), in = __ldg(p.tab + p.n_tasks + t);
  const int row0 = im * kBM, col0 = in * kBN;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const T* b2 = static_cast<const T*>(p.b2);
  UpdParams v = u;
  int depth = p.D, e = 0;
  if (p.grp != nullptr) {
    e = __ldg(p.tab + 2 * p.n_tasks + t);
    const size_t r_start = (size_t)__ldg(p.grp + e);
    const size_t o_off = (size_t)e * p.R * p.C;
    a += r_start * p.R;
    b += r_start * p.C;
    if constexpr (DUAL) b2 += r_start * p.C;
    if constexpr (UPDATE) {
      v.w = static_cast<T*>(u.w) + o_off;
      v.mst = u.mst + o_off;
      v.mu = u.mu + o_off;
      v.nu = u.nu + o_off;
      if constexpr (DUAL) {
        v.w2 = static_cast<T*>(u.w2) + o_off;
        v.mst2 = u.mst2 + o_off;
        v.mu2 = u.mu2 + o_off;
        v.nu2 = u.nu2 + o_off;
      }
    }
    depth = __ldg(p.grp + p.n_groups + e);
  }
  float hv[kSEED + 1];
#pragma unroll
  for (int i = 0; i <= kSEED; ++i) hv[i] = UPDATE ? __ldg(u.hyper + i) : 0.0f;
  tn_mainloop<DUAL>(p, a, b, b2, depth, row0, col0, As, Bs, B2s, Cs, C2s);
  __syncthreads();
  const unsigned step_bits = __float_as_uint(hv[kSEED]);
  const unsigned lane = 2u * (unsigned)e;
  update_flush<T, UPDATE, SR>(Cs, p, v, 0, hv, SR ? grouped_tile_seed(step_bits, u.salt, im, in, lane) : 0u, row0,
                              col0, red);
  if constexpr (DUAL)
    update_flush<T, UPDATE, SR>(C2s, p, v, 1, hv, SR ? grouped_tile_seed(step_bits, u.salt, im, in, lane + 1u) : 0u,
                                row0, col0, red);
}

// The update kernel (K8's, or K10's when GROUPED) of one (UPDATE, SR)
// instantiation.
template <bool DUAL, bool GROUPED, bool UPDATE, bool SR>
auto tn_update_entry() {
  if constexpr (GROUPED)
    return &grouped_tn_update_kernel<ElemT, DUAL, UPDATE, SR>;
  else
    return &tn_update_kernel<ElemT, DUAL, UPDATE, SR>;
}

template <bool DUAL, bool GROUPED>
int launch_tn_update(const BwdParams& p, const UpdParams& u, bool sr, cudaStream_t s) {
  void (*kernel)(const BwdParams, const UpdParams) = tn_update_entry<DUAL, GROUPED, false, false>();
  if (u.hyper != nullptr) {
    // an f32 W has nothing to dither: the cast is the rounding
    constexpr bool kCanRound = SFC_DTYPE == 1;
    kernel = kCanRound && sr ? tn_update_entry<DUAL, GROUPED, true, kCanRound>()
                             : tn_update_entry<DUAL, GROUPED, true, false>();
  }
  kernel<<<(unsigned)p.n_tasks, kThreads, 0, s>>>(p, u);
  return (int)cudaGetLastError();
}

#if SFC_ABFT
// K8's update / norm kernel with the checksum lane (K10 has none, as in the
// JAX package)
template <bool DUAL>
int launch_tn_update_abft(const BwdParams& p, const UpdParams& u, bool sr, float* chk, cudaStream_t s) {
  void (*kernel)(const BwdParams, const UpdParams, float*) = &tn_update_abft_kernel<ElemT, DUAL, false, false>;
  if (u.hyper != nullptr) {
    constexpr bool kCanRound = SFC_DTYPE == 1;
    kernel = kCanRound && sr ? &tn_update_abft_kernel<ElemT, DUAL, true, kCanRound>
                             : &tn_update_abft_kernel<ElemT, DUAL, true, false>;
  }
  kernel<<<(unsigned)p.n_tasks, kThreads, 0, s>>>(p, u, chk);
  return (int)cudaGetLastError();
}
#endif

#endif  // SFC_BWD == 2

#endif  // SFC_BWD

}  // namespace

#if SFC_REP

// K4/K5: out (batch, k_layers, M, N) partial copies of a (batch, M, K) @ b,
// b (K, N) shared (b_bstride 0) or (batch, K, N); copy l contracts over
// [l * k_slab, (l + 1) * k_slab) clipped to K.  tab is gemm_spec(mb, nb,
// k_layers)'s (3, n_tasks) table; out_f32 writes f32 copies (else the input
// type).  Returns cudaGetLastError() after the launch.
extern "C" int SFC_REP_ENTRY(const void* a, const void* b, void* out, int out_f32, const int* tab, int n_tasks,
                             int batch, int M, int N, int K, long long a_bstride, long long b_bstride, int k_layers,
                             int k_slab, int vec_a, int vec_b, void* stream) {
  if (k_layers < 1 || k_slab < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = a;
  p.b = b;
  p.out = out;
  p.tab = tab;
  p.n_tasks = n_tasks;
  p.M = M;
  p.N = N;
  p.K = K;
  p.a_bstride = a_bstride;
  p.b_bstride = b_bstride;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  const dim3 grid((unsigned)n_tasks, (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    sfc_gemm_replicated_kernel<ElemT, float><<<grid, kThreads, 0, s>>>(p, k_layers, k_slab);
  else
    sfc_gemm_replicated_kernel<ElemT, ElemT><<<grid, kThreads, 0, s>>>(p, k_layers, k_slab);
  return (int)cudaGetLastError();
}

// K6: out (batch, mn) = the f32 sum over l of copies (batch, layers, mn),
// cast to the copies' type; vec asks for 16-byte vectors (mn a multiple of
// 16 / sizeof(T), both pointers 16-byte aligned).
extern "C" int SFC_ADD_REDUCE_ENTRY(const void* copies, void* out, int layers, int batch, long long mn, int vec,
                                    void* stream) {
  if (layers < 1 || batch < 1 || mn < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)batch * mn;
  const long long items = vec ? total / (16 / (long long)sizeof(ElemT)) : total;
  const long long want = (items + kReduceThreads - 1) / kReduceThreads;
  const long long blocks = want < 132LL * 16 ? want : 132LL * 16;  // a grid-stride loop past 16 a SM
  add_reduce_kernel<ElemT><<<(unsigned)blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ElemT*>(copies), static_cast<ElemT*>(out), layers, mn, total, vec);
  return (int)cudaGetLastError();
}

#elif !SFC_BWD

// One launch of the fused kernel over a (n_tasks, batch) grid.  Pointers
// that are null switch their epilogue term off; a non-null out_gate selects
// the preact mode (GLU parts only, no scale or residual).  A non-null grp
// (3, n_groups) selects the grouped mode: tab is (3, n_tasks), B and B_gate
// are (n_groups, K, N), the biases (n_groups, N), M is the total row count,
// and there is no batch and no residual.  Returns cudaGetLastError() after
// the launch, so a refused launch reaches the caller.  The -DSFC_ABFT=1
// part's entry takes one more pointer, chk: the (batch * n_tasks) f32
// partials of the checksum lane, one a task.
static int fused_entry(const void* a, const void* b, const void* b_gate, const void* bias, const void* gate_bias,
                       const void* residual, void* out, void* out_gate, const int* tab, int n_tasks, int batch, int M,
                       int N, int K, long long a_bstride, long long b_bstride, int has_scale, float out_scale,
                       int vec_a, int vec_b, const int* grp, int n_groups, float* chk, void* stream) {
  if ((SFC_GLU != 0) != (b_gate != nullptr)) return (int)cudaErrorInvalidValue;
  if (!SFC_GLU && gate_bias != nullptr) return (int)cudaErrorInvalidValue;
  if (out_gate != nullptr && (!SFC_GLU || residual != nullptr || has_scale)) return (int)cudaErrorInvalidValue;
  if (grp != nullptr && (batch != 1 || residual != nullptr || n_groups < 1)) return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.bg = b_gate;
  p.bias = bias;
  p.gbias = gate_bias;
  p.res = residual;
  p.out = out;
  p.out_gate = out_gate;
  p.tab = tab;
  p.n_tasks = n_tasks;
  p.M = M;
  p.N = N;
  p.K = K;
  p.a_bstride = a_bstride;
  p.b_bstride = b_bstride;
  p.out_scale = out_scale;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  const GroupRows g{grp, n_groups};
  const dim3 grid((unsigned)n_tasks, (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias)
    launch_gbias<true>(p, g, chk, has_scale != 0, grid, s);
  else
    launch_gbias<false>(p, g, chk, has_scale != 0, grid, s);
  return (int)cudaGetLastError();
}

#if !SFC_ABFT
extern "C" int SFC_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                         const void* gate_bias, const void* residual, void* out, void* out_gate,
                         const int* tab, int n_tasks, int batch, int M, int N, int K,
                         long long a_bstride, long long b_bstride, int has_scale, float out_scale,
                         int vec_a, int vec_b, const int* grp, int n_groups, void* stream) {
  return fused_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, n_tasks, batch, M, N, K, a_bstride,
                     b_bstride, has_scale, out_scale, vec_a, vec_b, grp, n_groups, nullptr, stream);
}
#else
extern "C" int SFC_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                         const void* gate_bias, const void* residual, void* out, void* out_gate,
                         const int* tab, int n_tasks, int batch, int M, int N, int K,
                         long long a_bstride, long long b_bstride, int has_scale, float out_scale,
                         int vec_a, int vec_b, const int* grp, int n_groups, float* chk, void* stream) {
  if (chk == nullptr) return (int)cudaErrorInvalidValue;
  return fused_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, n_tasks, batch, M, N, K, a_bstride,
                     b_bstride, has_scale, out_scale, vec_a, vec_b, grp, n_groups, chk, stream);
}
#endif

#if SFC_DTYPE == 1 && defined(SFC_CLUSTER_ENTRY)
// One launch of the cluster kernel (K1 at M <= 16): n_tasks clusters of
// `layers` CTAs over the (2, n_tasks) table of gemm_spec(1, nb), CTA l of
// a cluster the K slab [l * slab, (l + 1) * slab).  Plain mode only (no
// batch, no grouped mode); the epilogue pointers as SFC_ENTRY's.  vec_a
// also needs slab % 8 == 0.  The -DSFC_ABFT=1 part's entry takes chk, the
// (n_tasks) f32 partials of the lane.  Returns the launch's CUDA error.
static int cluster_entry(const void* a, const void* b, const void* b_gate, const void* bias, const void* gate_bias,
                         const void* residual, void* out, void* out_gate, const int* tab, int n_tasks, int M, int N,
                         int K, int layers, int slab, int has_scale, float out_scale, int vec_a, int vec_b, float* chk,
                         void* stream) {
  if ((SFC_GLU != 0) != (b_gate != nullptr)) return (int)cudaErrorInvalidValue;
  if (!SFC_GLU && gate_bias != nullptr) return (int)cudaErrorInvalidValue;
  if (out_gate != nullptr && (!SFC_GLU || residual != nullptr || has_scale)) return (int)cudaErrorInvalidValue;
  if (M < 1 || M > kSplitRows || layers < 1 || layers > kMaxLayers || slab < 1) return (int)cudaErrorInvalidValue;
  if (vec_a && slab % 8 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.bg = b_gate;
  p.bias = bias;
  p.gbias = gate_bias;
  p.res = residual;
  p.out = out;
  p.out_gate = out_gate;
  p.tab = tab;
  p.n_tasks = n_tasks;
  p.M = M;
  p.N = N;
  p.K = K;
  p.a_bstride = 0;
  p.b_bstride = 0;
  p.out_scale = out_scale;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias) return cluster_launch_gbias<true>(p, chk, has_scale != 0, layers, slab, s);
  return cluster_launch_gbias<false>(p, chk, has_scale != 0, layers, slab, s);
}

#if !SFC_ABFT
extern "C" int SFC_CLUSTER_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                                 const void* gate_bias, const void* residual, void* out, void* out_gate,
                                 const int* tab, int n_tasks, int M, int N, int K, int layers, int slab,
                                 int has_scale, float out_scale, int vec_a, int vec_b, void* stream) {
  return cluster_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, n_tasks, M, N, K, layers, slab,
                       has_scale, out_scale, vec_a, vec_b, nullptr, stream);
}
#else
extern "C" int SFC_CLUSTER_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                                 const void* gate_bias, const void* residual, void* out, void* out_gate,
                                 const int* tab, int n_tasks, int M, int N, int K, int layers, int slab,
                                 int has_scale, float out_scale, int vec_a, int vec_b, float* chk, void* stream) {
  if (chk == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, n_tasks, M, N, K, layers, slab,
                       has_scale, out_scale, vec_a, vec_b, chk, stream);
}
#endif
#endif  // SFC_DTYPE == 1 && SFC_CLUSTER_ENTRY

#elif SFC_BWD == 1 && SFC_ABFT

// TN (K8 dW) with the checksum lane: SFC_TN_ENTRY's arguments without the
// grouped mode (K10 has no lane), plus chk, the (n_sets, n_tasks) f32
// partials: chk[set * n_tasks + t] = the sum of task t's raw dW tile.
extern "C" int SFC_TN_ABFT_ENTRY(const void* a, const void* b, const void* b2, void* out, void* out2, const int* tab,
                                 int n_tasks, int R, int C, int D, int vec_a, int vec_b, float* chk, void* stream) {
  const bool dual = out2 != nullptr;
  if ((!dual && b2 != nullptr) || (dual && b2 == nullptr && D > 0) || chk == nullptr) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(a, b, nullptr, b2, out, out2, tab, n_tasks, R, C, D, vec_a, vec_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dual)
    tn_abft_kernel<ElemT, true><<<(unsigned)n_tasks, kThreads, 0, s>>>(p, chk);
  else
    tn_abft_kernel<ElemT, false><<<(unsigned)n_tasks, kThreads, 0, s>>>(p, chk);
  return (int)cudaGetLastError();
}

#elif SFC_BWD == 1

// NT: out (R, C) = a (R, D) @ b (C, D)^T [+ a2 @ b2^T when a2 is non-null],
// one CTA per task of the gilbert table over the output tiles.  A non-null
// grp (3, n_groups) selects the grouped mode: tab is the grouped table
// (3, n_tasks), b (and b2) is (n_groups, C, D), R the total row count, and
// each expert's rows use its own weight slab.
extern "C" int SFC_NT_ENTRY(const void* a, const void* b, const void* a2, const void* b2, void* out,
                            const int* tab, int n_tasks, int R, int C, int D, int vec_a, int vec_b,
                            const int* grp, int n_groups, void* stream) {
  if ((a2 == nullptr) != (b2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (grp != nullptr && n_groups < 1) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(a, b, a2, b2, out, nullptr, tab, n_tasks, R, C, D, vec_a, vec_b);
  p.grp = grp;
  p.n_groups = n_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grp != nullptr && a2)
    grouped_nt_kernel<ElemT, true><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else if (grp != nullptr)
    grouped_nt_kernel<ElemT, false><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else if (a2)
    nt_kernel<ElemT, true><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else
    nt_kernel<ElemT, false><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// TN: out (R, C) = a (D, R)^T @ b (D, C) [and out2 = a^T @ b2 when out2 is
// non-null; b2 may then be null only for an empty contraction, D == 0,
// whose operands are never read], the contraction over the D rows inside
// each CTA.  A non-null grp (3, n_groups) selects the grouped dW mode: tab
// is (3, n_tasks), one gilbert map of the (R, C) tiles per expert with the
// expert in its third row; out (and out2) is (n_groups, R, C), D the total
// row count, and each expert contracts over its own rows.
extern "C" int SFC_TN_ENTRY(const void* a, const void* b, const void* b2, void* out, void* out2,
                            const int* tab, int n_tasks, int R, int C, int D, int vec_a, int vec_b,
                            const int* grp, int n_groups, void* stream) {
  const bool dual = out2 != nullptr;
  if ((!dual && b2 != nullptr) || (dual && b2 == nullptr && D > 0)) return (int)cudaErrorInvalidValue;
  if (grp != nullptr && n_groups < 1) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(a, b, nullptr, b2, out, out2, tab, n_tasks, R, C, D, vec_a, vec_b);
  p.grp = grp;
  p.n_groups = n_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grp != nullptr && dual)
    grouped_tn_kernel<ElemT, true><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else if (grp != nullptr)
    grouped_tn_kernel<ElemT, false><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else if (dual)
    tn_kernel<ElemT, true><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  else
    tn_kernel<ElemT, false><<<(unsigned)n_tasks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

#else  // SFC_BWD == 2

// TN with the update flush: norm mode when hyper is null (only partials is
// written: partials[set * n_tasks + t] = the task's sum(dW^2)), else update
// mode, which also writes w, master, mu and nu (and the second set when
// n_sets is 2) in place; b2 may be null only for an empty contraction (D ==
// 0).  sr asks for the stochastic rounding of a bf16 W.  A non-null grp (3,
// n_groups) selects the grouped mode (K10): tab is the grouped TN table (3,
// n_tasks), D the total row count, w and the state (n_groups, R, C) stacks,
// each expert contracting over its own rows.  The -DSFC_ABFT=1 part's entry
// takes one more pointer, chk, the (n_sets, n_tasks) f32 partials of the
// checksum lane (chk[set * n_tasks + t] = the sum of task t's raw dW tile),
// and no grouped mode (K10 has no lane).
static int tnu_entry(const void* a, const void* b, const void* b2, int n_sets, void* w, void* w2, float* master,
                     float* mu, float* nu, float* master2, float* mu2, float* nu2, const float* hyper, int salt, int sr,
                     float* partials, const int* tab, int n_tasks, int R, int C, int D, int vec_a, int vec_b,
                     const int* grp, int n_groups, float* chk, void* stream) {
  const bool dual = n_sets == 2;
  if (n_sets != 1 && n_sets != 2) return (int)cudaErrorInvalidValue;
  if ((!dual && b2 != nullptr) || (dual && b2 == nullptr && D > 0)) return (int)cudaErrorInvalidValue;
  if (partials == nullptr) return (int)cudaErrorInvalidValue;
  if (hyper != nullptr) {
    if (!w || !master || !mu || !nu) return (int)cudaErrorInvalidValue;
    if (dual != (w2 && master2 && mu2 && nu2)) return (int)cudaErrorInvalidValue;
  }
  if (grp != nullptr && n_groups < 1) return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(a, b, nullptr, b2, nullptr, nullptr, tab, n_tasks, R, C, D, vec_a, vec_b);
  p.grp = grp;
  p.n_groups = n_groups;
  UpdParams u;
  u.w = w;
  u.w2 = w2;
  u.mst = master;
  u.mu = mu;
  u.nu = nu;
  u.mst2 = master2;
  u.mu2 = mu2;
  u.nu2 = nu2;
  u.hyper = hyper;
  u.salt = (unsigned)salt;
  u.partials = partials;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if SFC_ABFT
  if (grp != nullptr || chk == nullptr) return (int)cudaErrorInvalidValue;
  return dual ? launch_tn_update_abft<true>(p, u, sr != 0, chk, s) : launch_tn_update_abft<false>(p, u, sr != 0, chk, s);
#else
  (void)chk;
  if (grp != nullptr)
    return dual ? launch_tn_update<true, true>(p, u, sr != 0, s) : launch_tn_update<false, true>(p, u, sr != 0, s);
  return dual ? launch_tn_update<true, false>(p, u, sr != 0, s) : launch_tn_update<false, false>(p, u, sr != 0, s);
#endif
}

#if SFC_ABFT
extern "C" int SFC_TNU_ABFT_ENTRY(const void* a, const void* b, const void* b2, int n_sets, void* w, void* w2,
                                  float* master, float* mu, float* nu, float* master2, float* mu2, float* nu2,
                                  const float* hyper, int salt, int sr, float* partials, const int* tab, int n_tasks,
                                  int R, int C, int D, int vec_a, int vec_b, float* chk, void* stream) {
  return tnu_entry(a, b, b2, n_sets, w, w2, master, mu, nu, master2, mu2, nu2, hyper, salt, sr, partials, tab,
                   n_tasks, R, C, D, vec_a, vec_b, nullptr, 0, chk, stream);
}
#else
extern "C" int SFC_TNU_ENTRY(const void* a, const void* b, const void* b2, int n_sets, void* w, void* w2,
                             float* master, float* mu, float* nu, float* master2, float* mu2, float* nu2,
                             const float* hyper, int salt, int sr, float* partials, const int* tab, int n_tasks, int R,
                             int C, int D, int vec_a, int vec_b, const int* grp, int n_groups, void* stream) {
  return tnu_entry(a, b, b2, n_sets, w, w2, master, mu, nu, master2, mu2, nu2, hyper, salt, sr, partials, tab,
                   n_tasks, R, C, D, vec_a, vec_b, grp, n_groups, nullptr, stream);
}
#endif

#endif  // SFC_BWD
