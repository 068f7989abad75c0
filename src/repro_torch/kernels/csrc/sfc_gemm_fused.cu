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
// rows and sfc_gemm_wgmma_kernel (sfc_gemm_wgmma.cuh) for the other bf16
// calls whose rows TMA can describe, and this kernel keeps the rest, and f32.
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
// 295 flops a byte, so the weight bytes bound it.  This tile kernel now
// keeps f32 and the bf16 calls TMA cannot describe: every other bf16 call
// takes sfc_gemm_grouped_wgmma_kernel, the grouped mode of the wgmma body
// (sfc_gemm_wgmma.cuh), 128-row tiles of the table at 128-row blocks,
// persistent CTAs over curve segments and a TMA ring, behind the bf16
// parts' wgmma entry (its lane twin sfc_gemm_grouped_wgmma_abft_kernel).
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
//   weight read as stored (E, N, K), over the forward's grouped table; it
//   keeps f32 and the bf16 calls TMA cannot describe, the others take
//   grouped_nt_wgmma_kernel (the NT wgmma entry's grouped mode, below).
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
//   the copies' type, 16-byte vector loads where M*N allows; the copies
//   are read in chunks of 8 whose loads are all in flight before the
//   chunk's adds, V vectors a thread, on a grid from the SM count.
// What bounds them: at decode (M = 4) K4 reads the weight once, 2*M flops a
// weight, so the weight bytes bound it as they bound K1; split over k_layers
// slabs the same bytes stream through k_layers times as many CTAs (16 for
// k/v's N = 1024 at L = 1, 128 at L = 8), at the price of L copies of C
// written and read back by K6, which is bound by (L + 1) M N elements of
// bytes.  At prefill (4 x 128 rows) the products are tensor-core bound and
// the split only adds copies.  The 64 x 64 tile kernel streamed each K
// step with synchronous copies, one CTA a (tile, layer) task, which left
// most SMs idle at decode (k/v: 16 CTAs) and the tensor cores idle at
// prefill, so the bf16 replicated part holds two more kernels, each behind
// an entry of its own, and sfc_gemm_replicated_kernel keeps f32 and the
// rest:
// sfc_gemm_replicated_cluster_kernel (-DSFC_REP_CLUSTER_ENTRY) takes K4 at
//   a bf16 plain-mode A of at most 16 rows (every decode projection and
//   the LM head): K1's cluster design, each (tile, layer) task a cluster of
//   L' CTAs over sub-slabs of the layer's slab through the same split-K
//   main loop and rank-order DSMEM sum (`split_mainloop`, `cluster_sum`,
//   shared with the forward parts), so nb x k_layers x L' CTAs stream the
//   weights; L' is the wrapper's (`replicated_cluster_split`).
// sfc_gemm_replicated_wgmma_kernel (-DSFC_REP_WGMMA_ENTRY) takes the other
//   bf16 calls whose rows TMA can describe and whose slab is a whole number
//   of 64-wide steps (or all of K): K5's prefill and K4 past 16 rows, as
//   the replicated mode of the wgmma body (sfc_gemm_wgmma.cuh, kind kRep).
//
// sfc_gemm_wgmma_kernel (K2, and K1 past the cluster kernel's 16 rows) and
// nt_wgmma_kernel (K7), in sfc_gemm_wgmma.cuh, take every bf16 call whose
// rows TMA can describe (16-byte rows and bases): persistent CTAs over
// contiguous segments of the curve, TMA into a ring of stages, wgmma.  The
// bf16 forward parts hold the first behind -DSFC_WGMMA_ENTRY (its lane
// twin sfc_gemm_wgmma_abft_kernel in their -DSFC_ABFT=1 twins), the bf16
// -DSFC_BWD=1 part the second behind -DSFC_NT_WGMMA_ENTRY; with a `grp`
// array the same entries launch their grouped mode, K3's
// sfc_gemm_grouped_wgmma_kernel (lane twin
// sfc_gemm_grouped_wgmma_abft_kernel) and K9's grouped_nt_wgmma_kernel;
// the kernels above keep every other call and their code.  The TN products (K8, and
// K10 in its grouped mode) run the same main loop with A read as A^T
// through wgmma's transpose bit and a flush of their own (`TnFlush`,
// below), in all three modes: tn_wgmma_kernel / grouped_tn_wgmma_kernel
// (dW, the bf16 -DSFC_BWD=1 part, -DSFC_TN_WGMMA_ENTRY),
// tn_update_wgmma_kernel / grouped_tn_update_wgmma_kernel (norm and
// update, the bf16 -DSFC_BWD=2 part, -DSFC_TNU_WGMMA_ENTRY) and K8's lane
// twins tn_wgmma_abft_kernel / tn_update_wgmma_abft_kernel (the bf16 TN
// lane parts).  The update flush is bound by its state's bytes (12 read,
// 14 written a weight): it stages the tile in shared memory and walks it
// by rows, 16-byte state accesses along each row, two batches in flight
// a thread, where the 64 x 64 tile kernel's flush read one element a
// thread after its main loop.
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
//
// The f32-output mode (the TPU kernel's `out_dtype`, sfc_gemm.py:265-269,
// :286: `acc.astype(spec.out_dtype)` with an f32 out_dtype on bf16 inputs;
// the SSD scores of `chunk_einsum`, repro/models/ssm.py:97-99, and the
// mLSTM qk block ask for it).  Only the plain product, with no epilogue,
// no GLU and no preact, has a caller, so the bf16 part of (no GLU, no
// activation) and its lane twin hold it, behind entries of their own
// (-DSFC_F32_ENTRY, -DSFC_WGMMA_F32_ENTRY) and under kernel names of their
// own, so no other instantiation changes: sfc_gemm_fused_f32out_kernel
// (the 64 x 64 tile kernel; also the route of a plain-mode A of at most 16
// rows, which the cluster kernel keeps in bf16) and
// sfc_gemm_wgmma_f32out_kernel (the wgmma body's forward kind with an f32
// flush of the raw accumulator, `wg::OutF32`), and their lane twins
// sfc_gemm_fused_f32out_abft_kernel / sfc_gemm_wgmma_f32out_abft_kernel.
// The flush writes the f32 accumulator as it is: no bf16 rounding.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the driver's encoder is fetched at run time: no -lcuda)
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

#if SFC_DTYPE == 1 && (defined(SFC_CLUSTER_ENTRY) || defined(SFC_REP_CLUSTER_ENTRY))

// ---------------------------------------------------------------------------
// Split-K across a thread-block cluster at M <= 16 rows: the main loop and
// the reduction of K1's cluster kernel (the bf16 forward parts) and of K4's
// (the bf16 replicated part), one code for both
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;  // A rows the cluster kernels take (build.py SPLIT_MAX_ROWS)
constexpr int kMaxLayers = 8;   // CTAs (K slabs) a cluster, a portable cluster (build.py MAX_CLUSTER_LAYERS)

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

// After split_mainloop: each of the cluster's `n` CTAs holds its f32
// partial tile in Cs (rows < M, and the gate's for the GLU).  The leader
// (rank 0) adds its peers' tiles, read through distributed shared memory,
// in rank order (P_0 + P_1 + ... + P_{n-1}) into its own.  Returns whether
// this CTA is the leader, which then holds the sum; the peers may exit.
template <bool GLU>
__device__ __forceinline__ bool cluster_sum(cooperative_groups::cluster_group& cluster, int n, int rank, int M,
                                            float* Cs) {
  using C = SplitCfg<GLU>;
  cluster.sync();  // every rank's partial tile is in its CTA's shared memory
  if (rank == 0) {
    for (int i = threadIdx.x; i < C::SETS * M * kBN; i += kThreads) {
      const int set = i / (M * kBN), e = i % (M * kBN);
      const int off = set * C::C_FLOATS + (e / kBN) * kLDC + e % kBN;
      float v = Cs[off];
      for (int l = 1; l < n; ++l) v += cluster.map_shared_rank(Cs, l)[off];
      Cs[off] = v;
    }
  }
  cluster.sync();  // the leader has read every peer (they may exit) and holds the sum
  return rank == 0;
}

#endif  // SFC_DTYPE == 1 && (SFC_CLUSTER_ENTRY || SFC_REP_CLUSTER_ENTRY)

#if SFC_REP

// K4/K5: one 64 x 64 tile of copy `layer` of batch element blockIdx.y.  The
// table is (3, n_tasks): major (im), minor (in), layer.  Ragged edges are
// masked by the main loop (M, N and the slab's end) and by the write.  It
// keeps f32 and the bf16 calls that neither sfc_gemm_replicated_cluster_kernel
// nor sfc_gemm_replicated_wgmma_kernel (below) takes.
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

#if SFC_DTYPE == 1 && defined(SFC_REP_CLUSTER_ENTRY)

// K4 at a bf16 plain-mode A of at most 16 rows (the decode projections and
// the LM head): task t of gemm_spec(1, nb, k_layers)'s (3, n_tasks) table,
// a 64-column tile of copy l, is a cluster of `split` CTAs, CTA r (its
// rank) the sub-slab [l * slab + r * sub, l * slab + (r + 1) * sub) of
// layer l's slab, clipped to the slab and to K, through K1's split-K main
// loop; the leader adds the f32 partials in rank order (`cluster_sum`) and
// writes the tile of copy l once, in OutT (bf16, or f32: the unfused GLU's
// copies).  4 CTAs an SM (the 45 KB ring, 128 registers).
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 4)
    sfc_gemm_replicated_cluster_kernel(const Params p, const int slab, const int sub) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char split_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / split;
  const int col0 = __ldg(p.tab + p.n_tasks + t) * kBN;  // one row block: the major row is 0
  const int layer = __ldg(p.tab + 2 * p.n_tasks + t);
  const long long s_lo = (long long)layer * slab;
  const long long s_hi = min(s_lo + slab, (long long)p.K);  // a layer past K: s_hi = K <= s_lo, no step
  const int k_lo = (int)min(s_lo + (long long)rank * sub, s_hi);
  const int k_hi = (int)min((long long)k_lo + sub, s_hi);
  float* Cs = reinterpret_cast<float*>(split_smem);
  split_mainloop<false>(p, col0, k_lo, k_hi, split_smem, Cs);
  if (!cluster_sum<false>(cluster, split, rank, p.M, Cs)) return;
  OutT* out = static_cast<OutT*>(p.out) + (long long)layer * p.M * p.N;
  for (int i = threadIdx.x; i < p.M * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (col0 + c < p.N) out[(size_t)r * p.N + col0 + c] = from_f32<OutT>(Cs[r * kLDC + c]);
  }
}

#endif  // SFC_DTYPE == 1 && SFC_REP_CLUSTER_ENTRY

#if SFC_DTYPE == 1 && defined(SFC_REP_WGMMA_ENTRY)

// K5 (and K4 past 16 rows) on wgmma and TMA: the replicated mode of the
// wgmma body (sfc_gemm_wgmma.cuh, kind kRep), persistent CTAs over curve
// segments of the (batch element, layer, C tile) tasks; F32 writes f32
// copies (the unfused GLU's), else bf16.
#include "sfc_gemm_wgmma.cuh"

template <int BN, bool F32>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_replicated_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                                     const __grid_constant__ CUtensorMap tm_a2,
                                     const __grid_constant__ CUtensorMap tm_b2, const wg::Params p,
                                     const wg::RepOut<F32> r) {
  wg::body<wg::kRep, false, 0, false, BN, wg::RepOut<F32>>(tm_a, tm_b, tm_a2, tm_b2, p, r);
}

#endif  // SFC_DTYPE == 1 && SFC_REP_WGMMA_ENTRY

// K6's launch limits: threads a CTA at most (`sfc_gemm.add_reduce_launch`
// takes 128), and the copies a chunk whose loads are all issued before the
// chunk's first add.
constexpr int kReduceMaxThreads = 256;
constexpr int kReduceChunk = 8;

// Reads of data read once: the non-coherent path, no L1 line.
__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
__device__ __forceinline__ float ld_once(const float* p) {
  float r;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ bf16 ld_once(const bf16* p) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(r) : "l"(p));
  return __ushort_as_bfloat16(r);
}

// K6: out[b, j] = sum over l of copies[b, l, j], in f32 in layer order, cast
// once to T.  blockIdx.y is the batch element b; inside it Idx (int where
// layers * mn and a pass's reach fit, else long long) indexes the copies, so
// no thread divides.  The element range is cut into 16-byte slots (the last
// ragged where mn is not a whole number of vectors); a pass of a CTA covers
// blockDim.x * V consecutive slots, and the CTAs stride over the slots
// (gridDim.x from `add_reduce_launch`).  Bound by bytes (the L copies read
// once, C written once) and, at decode's few kilobytes, by latency: the
// copies are read in chunks of kReduceChunk whose loads, each under its own
// `l < layers` test, are all issued before the chunk's first add, so a
// thread waits one memory round trip a chunk, not one a copy.  Every
// address is clamped into the copies (a slot past the end reads the last
// slot and is never stored), so a load hoisted out of its test stays in
// bounds.  The adds keep layer order and stop at ``layers``, so the result
// is bitwise the layer-order loop's.  (With each chunk's loads written
// unguarded, exactly as many as there were copies, ptxas put the adds
// between the loads (cuobjdump -sass), in every load form tried: nc and
// no_allocate, __ldg, __ldcs, a __syncwarp between loads and adds; decode
// k / v at 8 copies took 0.0030 ms against 0.0021, split_sweep k6 on the
// H100.)
//   VEC: mn is a whole number of vectors and both arrays 16-byte aligned.
// Thread t of a pass takes slots base + i * blockDim.x + t (i < V), so each
// load instruction of a warp reads 512 contiguous bytes.  Else the pass's
// V x 16 / sizeof(T) elements a thread, base * 16 / sizeof(T) + q *
// blockDim.x + t, one at a time, each with its chunk of loads (an odd M·N
// or a misaligned view: off the main path).
template <typename T, int V, bool VEC, typename Idx>
__global__ void __launch_bounds__(kReduceMaxThreads) add_reduce_kernel(const T* __restrict__ c, T* __restrict__ out,
                                                                        int layers, Idx mn) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements a slot
  const T* src = c + (long long)blockIdx.y * layers * mn;
  T* dst = out + (long long)blockIdx.y * mn;
  const Idx slots = (mn + kVec - 1) / kVec, per_cta = (Idx)blockDim.x * V;
  const Idx t = (Idx)threadIdx.x;
  for (Idx base = (Idx)blockIdx.x * per_cta; base < slots; base += (Idx)gridDim.x * per_cta) {
    if constexpr (VEC) {
      const uint4* in = reinterpret_cast<const uint4*>(src);
      const Idx lstride = mn / kVec;  // vectors a copy
      float acc[V][kVec];
#pragma unroll
      for (int i = 0; i < V; ++i) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = 0.0f;
      }
      for (int l0 = 0; l0 < layers; l0 += kReduceChunk) {
        uint4 raw[kReduceChunk][V];
#pragma unroll
        for (int u = 0; u < kReduceChunk; ++u) {
          const Idx at = (Idx)min(l0 + u, layers - 1) * lstride;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (l0 + u < layers) raw[u][i] = ld_once(in + at + min(base + i * (Idx)blockDim.x + t, slots - 1));
          }
        }
#pragma unroll
        for (int u = 0; u < kReduceChunk; ++u) {
          if (l0 + u >= layers) break;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const T* x = reinterpret_cast<const T*>(&raw[u][i]);
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[i][e] += to_f32(x[e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const Idx s = base + i * (Idx)blockDim.x + t;
        if (s >= slots) continue;
        uint4 res;
        T* y = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[e] = from_f32<T>(acc[i][e]);
        reinterpret_cast<uint4*>(dst)[s] = res;
      }
    } else {
      const Idx first = base * kVec;
#pragma unroll 1
      for (int q = 0; q < V * kVec; ++q) {
        const Idx j = first + q * (Idx)blockDim.x + t;
        if (j >= mn) break;
        float acc = 0.0f;
        for (int l0 = 0; l0 < layers; l0 += kReduceChunk) {
          T x[kReduceChunk];
#pragma unroll
          for (int u = 0; u < kReduceChunk; ++u) {
            if (l0 + u < layers) x[u] = ld_once(src + (Idx)min(l0 + u, layers - 1) * mn + j);
          }
#pragma unroll
          for (int u = 0; u < kReduceChunk; ++u) {
            if (l0 + u >= layers) break;
            acc += to_f32(x[u]);
          }
        }
        dst[j] = from_f32<T>(acc);
      }
    }
  }
}

#elif !SFC_BWD

// The fused kernel's flush of one C tile from the f32 accumulators in
// shared memory: C (and the residual, the preact gate output) at c_off in
// their arrays, the bias rows at vec_off; M bounds the tile's rows.  C is
// written in OutT: the input type, or f32 in the f32-output mode.
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT,
          typename OutT = T>
__device__ __forceinline__ void fused_flush(const Params& p, int M, const float* Cs, const float* Cgs, int row0,
                                            int col0, long long c_off, long long vec_off) {
  const T* bias = static_cast<const T*>(p.bias) + (BIAS ? vec_off : 0);
  const T* gbias = static_cast<const T*>(p.gbias) + (GBIAS ? vec_off : 0);
  const T* res = static_cast<const T*>(p.res) + (RES ? c_off : 0);
  OutT* out = static_cast<OutT*>(p.out) + c_off;
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
    out[(size_t)gr * p.N + gc] = from_f32<OutT>(y);
  }
}

// One task's C tile: K1/K2 (batch element blockIdx.y) or, GROUPED, K3 (the
// task's expert's packed rows against its own weights and bias rows; its
// row block is renumbered from the expert's first padded block, and the
// expert's row count masks its last block).  ABFT: the checksum lane, the
// sum of the raw accumulators (both for the GLU) before the epilogue, into
// chk[blockIdx.y * n_tasks + blockIdx.x]; the flush is the same code.
template <typename T, bool GLU, int ACT, bool BIAS, bool GBIAS, bool SCALE, bool RES, bool PREACT, bool GROUPED,
          bool ABFT = false, typename OutT = T>
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
    fused_flush<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, OutT>(p, M, Cs, Cgs, row0, col0, c_off, vec_off);
    if constexpr (ABFT) tile_checksum<GLU>(Cs, Cgs, M, p.N, row0, col0, chk + t);
  } else {
    mainloop<GLU>(p, p.M, A, B, Bg, row0, col0, 0, p.K, As, Bs, Bgs, Cs, Cgs);
    __syncthreads();
    fused_flush<T, GLU, ACT, BIAS, GBIAS, SCALE, RES, PREACT, OutT>(p, p.M, Cs, Cgs, row0, col0,
                                                                    bi * (long long)p.M * p.N, 0);
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
// (scripts/dense_kernel_ab.py).  It runs f32 and the bf16 calls whose rows
// TMA cannot describe; the other bf16 calls take
// sfc_gemm_grouped_wgmma_kernel (sfc_gemm_wgmma.cuh, the wgmma entry).
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

#ifdef SFC_F32_ENTRY
// The f32-output mode of K1/K2 on the tile kernel (bf16 inputs, no GLU, no
// epilogue): the raw f32 accumulator written as it is.  The route of the
// calls whose rows TMA cannot describe and of a plain-mode A of at most 16
// rows (the cluster kernel writes bf16 only).
#if SFC_ABFT
__global__ void __launch_bounds__(kThreads) sfc_gemm_fused_f32out_abft_kernel(const Params p, float* chk) {
  fused_tile<bf16, false, 0, false, false, false, false, false, false, true, float>(p, GroupRows{nullptr, 0}, chk);
}
#else
__global__ void __launch_bounds__(kThreads) sfc_gemm_fused_f32out_kernel(const Params p) {
  fused_tile<bf16, false, 0, false, false, false, false, false, false, false, float>(p, GroupRows{nullptr, 0});
}
#endif
#endif  // SFC_F32_ENTRY

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

#if SFC_DTYPE == 1 && defined(SFC_WGMMA_ENTRY)

// ---------------------------------------------------------------------------
// K2 (and K1 past 16 rows) on wgmma and TMA: persistent CTAs over curve
// segments (bf16 parts; sfc_gemm_wgmma.cuh)
// ---------------------------------------------------------------------------

#include "sfc_gemm_wgmma.cuh"

// Maps: A, B, (unused: A again), B_gate (B again without the GLU); BN: B
// columns a stage, the narrow (128) or the wide (256) tile.
#if SFC_ABFT
template <bool GLU, int ACT, int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_wgmma_abft_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                               const __grid_constant__ CUtensorMap tm_unused,
                               const __grid_constant__ CUtensorMap tm_bg, const wg::Params p) {
  wg::body<wg::kFwd, GLU, ACT, true, BN>(tm_a, tm_b, tm_unused, tm_bg, p);
}
// K3 with the lane: the grouped mode of the same body
template <bool GLU, int ACT, int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_grouped_wgmma_abft_kernel(const __grid_constant__ CUtensorMap tm_a,
                                       const __grid_constant__ CUtensorMap tm_b,
                                       const __grid_constant__ CUtensorMap tm_unused,
                                       const __grid_constant__ CUtensorMap tm_bg, const wg::Params p) {
  wg::body<wg::kFwd, GLU, ACT, true, BN, wg::NoFlush, true>(tm_a, tm_b, tm_unused, tm_bg, p);
}
#else
template <bool GLU, int ACT, int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_unused, const __grid_constant__ CUtensorMap tm_bg,
                          const wg::Params p) {
  wg::body<wg::kFwd, GLU, ACT, false, BN>(tm_a, tm_b, tm_unused, tm_bg, p);
}
// K3: the grouped mode of the same body, a kernel of its own so that a
// profiler trace tells it from K2
template <bool GLU, int ACT, int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                                  const __grid_constant__ CUtensorMap tm_unused,
                                  const __grid_constant__ CUtensorMap tm_bg, const wg::Params p) {
  wg::body<wg::kFwd, GLU, ACT, false, BN, wg::NoFlush, true>(tm_a, tm_b, tm_unused, tm_bg, p);
}
#endif

#ifdef SFC_WGMMA_F32_ENTRY
// K2's f32-output mode (and K1's past 16 rows): the forward kind's main
// loop, the raw f32 accumulator flushed as it is (`wg::OutF32`); no GLU,
// no epilogue.  Maps as sfc_gemm_wgmma_kernel's.
#if SFC_ABFT
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_wgmma_f32out_abft_kernel(const __grid_constant__ CUtensorMap tm_a,
                                      const __grid_constant__ CUtensorMap tm_b,
                                      const __grid_constant__ CUtensorMap tm_unused,
                                      const __grid_constant__ CUtensorMap tm_bg, const wg::Params p) {
  wg::body<wg::kFwd, false, 0, true, BN, wg::OutF32>(tm_a, tm_b, tm_unused, tm_bg, p);
}
#else
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    sfc_gemm_wgmma_f32out_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                                 const __grid_constant__ CUtensorMap tm_unused,
                                 const __grid_constant__ CUtensorMap tm_bg, const wg::Params p) {
  wg::body<wg::kFwd, false, 0, false, BN, wg::OutF32>(tm_a, tm_b, tm_unused, tm_bg, p);
}
#endif
#endif  // SFC_WGMMA_F32_ENTRY

#endif  // SFC_DTYPE == 1 && SFC_WGMMA_ENTRY

#if SFC_DTYPE == 1 && defined(SFC_CLUSTER_ENTRY)

// ---------------------------------------------------------------------------
// K1 at M <= 16 rows: split-K across a thread-block cluster (bf16 parts;
// the main loop and the reduction are the shared section's, above)
// ---------------------------------------------------------------------------

// One C tile of a plain-mode product with M <= 16 rows: the cluster of
// `layers` CTAs of task blockIdx.x / layers, CTA l (its rank) running the
// K slab [l * slab, (l + 1) * slab) clipped to K.  The leader adds its
// peers' f32 tiles in layer order (`cluster_sum`), then flushes the
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
  if (!cluster_sum<GLU>(cluster, layers, layer, p.M, Cs)) return;
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

// lanes of the (12,) hyper vector (optim/adamw.py HYP_*); the salt lane is
// not read, the salt is an argument
enum { kLR, kB1, k1MB1, kB2, k1MB2, kEPS, kWD, kB1C, kB2C, kSCALE, kSEED };

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

// repro/kernels/sfc_gemm.py::_grouped_tn_kernel's flush seed: `_tile_seed`
// with one more lane, 2e + set, hashed for every expert and set (K8's
// `tile_seed` adds a lane for its second set only)
__device__ __forceinline__ unsigned grouped_tile_seed(unsigned step_bits, unsigned salt, unsigned im, unsigned in,
                                                      unsigned lane) {
  return hash_u32(tile_seed(step_bits, salt, im, in, 0) ^ lane * 0x9E3779B1u);
}

// The stochastic-rounding bits of the element at (r, c) of its 64 x 64
// tile, from the tile's seed (`tile_random_bits`)
__device__ __forceinline__ unsigned element_bits(unsigned seed, int r, int c) {
  return hash_u32(seed ^ ((unsigned)r * 0x9E3779B1u) ^ ((unsigned)c * 0x85EBCA77u));
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

// AdamW of one weight from its f32 dW in the TPU kernel's expression order
// (`_apply_update_flush`), each step rounded as the plain version's (the
// _rn intrinsics: no product fused into an FMA); a gradient scale of 0 is
// a select that keeps the state, so a NaN gradient cannot reach it.
__device__ __forceinline__ void adamw(float acc, const float* hv, bool skip, float m0, float v0, float w0,
                                      float& m1, float& v1, float& w1) {
  const float g = __fmul_rn(acc, hv[kSCALE]);
  m1 = __fadd_rn(__fmul_rn(hv[kB1], m0), __fmul_rn(hv[k1MB1], g));
  v1 = __fadd_rn(__fmul_rn(hv[kB2], v0), __fmul_rn(hv[k1MB2], __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m1, hv[kB1C]);
  const float nhat = __fdiv_rn(v1, hv[kB2C]);
  const float step = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(nhat), hv[kEPS])), __fmul_rn(hv[kWD], w0));
  w1 = __fsub_rn(w0, __fmul_rn(hv[kLR], step));
  if (skip) {
    m1 = m0;
    v1 = v0;
    w1 = w0;
  }
}

#if SFC_DTYPE == 1 && (defined(SFC_NT_WGMMA_ENTRY) || defined(SFC_TN_WGMMA_ENTRY) || defined(SFC_TNU_WGMMA_ENTRY))
#include "sfc_gemm_wgmma.cuh"
#endif

#if SFC_DTYPE == 1 && defined(SFC_NT_WGMMA_ENTRY)
// K7 on wgmma and TMA (sfc_gemm_wgmma.cuh).  Maps: dC, W, dC2, W2 (the
// first pair again without the dual form); BN: the tile's columns.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    nt_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_a2, const __grid_constant__ CUtensorMap tm_b2,
                    const wg::Params p) {
  wg::body<wg::kNt, false, 0, false, BN>(tm_a, tm_b, tm_a2, tm_b2, p);
}
// K9: the grouped mode of the same body (a kernel of its own: a profiler
// trace tells it from K7)
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    grouped_nt_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                            const __grid_constant__ CUtensorMap tm_a2, const __grid_constant__ CUtensorMap tm_b2,
                            const wg::Params p) {
  wg::body<wg::kNt, false, 0, false, BN, wg::NoFlush, true>(tm_a, tm_b, tm_a2, tm_b2, p);
}
#endif

#if SFC_DTYPE == 1 && (defined(SFC_TN_WGMMA_ENTRY) || defined(SFC_TNU_WGMMA_ENTRY))

// ---------------------------------------------------------------------------
// K8 and K10 on wgmma and TMA: the TN kind of sfc_gemm_wgmma.cuh's main loop
// with a flush from the accumulator registers in one of three modes
// ---------------------------------------------------------------------------

enum TnMode { kDw = 0, kNorm = 1, kUpdate = 2 };

// What a TN flush writes, per operand set: dW (R, C) in dW mode; W, master,
// mu and nu in place in update mode (K10: (E, R, C) stacks, the expert's
// slice); the (n_sets, n_tasks) partials of sum(dW^2) in norm and update
// modes; the (n_sets, n_tasks) checksum lane under ABFT.
struct TnArgs {
  bf16* out[2];
  bf16* w[2];
  float* mst[2];
  float* mu[2];
  float* nu[2];
  const float* hyper;  // update: the (12,) AdamW vector
  unsigned salt;
  int sr;  // update: stochastically round W
  float* partials;
  float* chk;
  int R, C, n_tasks;
};

// The flush of one task's 128 x CPS tile a set (CPS 128 columns, 64 for
// the dual form's norm and update), run by the 256 consumer threads.
// Their accumulator fragments (pair q of a set: rows r0 + 8 (q & 1), cols
// c0 + 8 (q >> 1) and + 1; the dual form's second set ACC / 2 registers
// further) give each set's sum(dW^2) (norm and update modes) and raw sum
// (ABFT) in the fragment's order, summed over the threads in a fixed order
// into the task's slots of the partials and chk: no atomics, and the
// update mode's norms bitwise the norm mode's.  The writes go through the
// flush buffer `stg`, rows padded to CPS + 8: dW is staged in bf16 and
// stored as 16-byte row chunks; the update stages every set's f32 tile
// (no accumulator stays live past it) and runs AdamW on 4-column chunks
// along whole rows, the state of kBatch chunks a thread (48 bytes each:
// master, mu, nu) loaded while the previous batch's arithmetic runs, so a
// warp reads and writes whole row segments and keeps two batches in
// flight.  W is stochastically rounded
// with the bits of the element's 64 x 64 sub-tile (im, in, r, c), the
// plain version's and the JAX package's.  The 12 AdamW scalars sit in
// shared memory (red[32, 44)).
template <int MODE, bool DUAL, bool GROUPED, bool ABFT>
struct TnFlush {
  TnArgs a;

  // update: row chunks a thread loads at once, two batches in flight (4
  // chunks spilled past the 168 registers the 9 warps leave a thread and
  // ran 1.2-1.4x slower; scripts/dense_kernel_ab.py, K8 / K10 rows)
  static constexpr int kBatch = 2;

  template <int ACC>
  __device__ __forceinline__ void operator()(const float (&acc)[ACC], int t, int e, int row0, int col0, int wgi,
                                             int tw, float* red, unsigned char* stg) const {
    constexpr int SETS = DUAL ? 2 : 1;
    constexpr int Q = ACC / (2 * SETS);  // pairs a set a thread
    constexpr int CPS = 4 * Q;           // C columns a set
    constexpr int LD = CPS + 8;          // the flush buffer's row, in elements
    constexpr int kSet = ACC / 2;        // the second set's first register
    constexpr int SUMS = (MODE != kDw ? SETS : 0) + (ABFT ? SETS : 0);
    static_assert(CPS % 64 == 0, "whole 64 x 64 sub-tiles");
    static_assert(MODE == kNorm || SETS * wg::kBM * LD * (MODE == kDw ? 2 : 4) <= wg::kTnStageBytes,
                  "every set's staged tile fits the flush buffer");
    const int lane_id = tw % 32;
    const int lr0 = wgi * 64 + (tw / 32) * 16 + lane_id / 4;  // the fragment's first row and col in the tile
    const int lc0 = 2 * (lane_id % 4);
    const size_t off = GROUPED ? static_cast<size_t>(e) * a.R * a.C : 0;
    float sums[SUMS > 0 ? SUMS : 1];
#pragma unroll
    for (int set = 0; set < SETS; ++set) {
      float sq = 0.0f, lane = 0.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int gr = row0 + lr0 + 8 * (q & 1), gc = col0 + lc0 + 8 * (q >> 1);
        if (gr >= a.R || gc >= a.C) continue;
        const float x0 = acc[set * kSet + 2 * q], x1 = acc[set * kSet + 2 * q + 1];
        if constexpr (MODE != kDw) {
          sq = __fadd_rn(sq, __fmul_rn(x0, x0));
          sq = __fadd_rn(sq, __fmul_rn(x1, x1));
        }
        if constexpr (ABFT) lane += x0 + x1;
      }
      if constexpr (MODE != kDw) sums[set] = sq;
      if constexpr (ABFT) sums[(MODE != kDw ? SETS : 0) + set] = lane;
    }
    if constexpr (MODE == kDw) {
      // both sets' bf16 tiles, then CPS / 8 chunks of 8 a row
      constexpr int C8 = CPS / 8;
      bf16* sh = reinterpret_cast<bf16*>(stg);
      wg::consumers_sync();  // the last tile's readers of the buffer are done
#pragma unroll
      for (int set = 0; set < SETS; ++set) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          *reinterpret_cast<__nv_bfloat162*>(sh + (set * wg::kBM + lr0 + 8 * (q & 1)) * LD + lc0 + 8 * (q >> 1)) =
              __floats2bfloat162_rn(acc[set * kSet + 2 * q], acc[set * kSet + 2 * q + 1]);
      }
      wg::consumers_sync();
#pragma unroll
      for (int set = 0; set < SETS; ++set) {
#pragma unroll
        for (int k = 0; k < wg::kBM * C8 / wg::kConsumers; ++k) {
          const int i = threadIdx.x + k * wg::kConsumers, row = i / C8, c8 = 8 * (i % C8);
          const int gr = row0 + row, gc = col0 + c8;
          if (gr < a.R && gc < a.C)
            *reinterpret_cast<uint4*>(a.out[set] + off + static_cast<size_t>(gr) * a.C + gc) =
                *reinterpret_cast<const uint4*>(sh + (set * wg::kBM + row) * LD + c8);
        }
      }
    }
    if constexpr (MODE == kUpdate) {
      constexpr int C4 = CPS / 4;                                 // chunks of 4 a row
      constexpr int kBatches = wg::kBM * C4 / wg::kConsumers / kBatch;  // a thread's, a set
      float* hv = red + 32;
      if (threadIdx.x <= kSEED) hv[threadIdx.x] = __ldg(a.hyper + threadIdx.x);
      float* sf = reinterpret_cast<float*>(stg);
      wg::consumers_sync();  // the buffer's last readers are done
#pragma unroll
      for (int set = 0; set < SETS; ++set) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          *reinterpret_cast<float2*>(sf + (set * wg::kBM + lr0 + 8 * (q & 1)) * LD + lc0 + 8 * (q >> 1)) =
              make_float2(acc[set * kSet + 2 * q], acc[set * kSet + 2 * q + 1]);
      }
      wg::consumers_sync();  // staged; the scalars are in
      const bool skip = hv[kSCALE] == 0.0f, dither = a.sr && !skip;
      const unsigned step_bits = __float_as_uint(hv[kSEED]);
      // a thread's chunks share its column chunk c4 and lie RS rows apart:
      // chunk k at row rt + k RS
      constexpr int RS = wg::kConsumers / C4;
      static_assert(64 % RS == 0, "a chunk's sub-tile row half is (kk RS) >> 6");
      const int c4 = 4 * (threadIdx.x % C4), rt = threadIdx.x / C4;
      const bool col_in = col0 + c4 < a.C;
      const int c = (col0 + c4) & 63;  // the chunk's first column in its 64 x 64 sub-tile
      const size_t base = off + static_cast<size_t>(row0 + rt) * a.C + col0 + c4;
      const size_t step = static_cast<size_t>(RS) * a.C;
#pragma unroll
      for (int set = 0; set < SETS; ++set) {
        const float* st = sf + set * wg::kBM * LD + rt * LD + c4;
        float* mst = a.mst[set] + base;
        float* mu = a.mu[set] + base;
        float* nu = a.nu[set] + base;
        bf16* w = a.w[set] + base;
        float4 m0[2][kBatch], v0[2][kBatch], w0[2][kBatch];
        auto load = [&](int b, int slot) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int kk = b * kBatch + k;
            if (col_in && row0 + rt + kk * RS < a.R) {
              m0[slot][k] = __ldcs(reinterpret_cast<const float4*>(mu + kk * step));
              v0[slot][k] = __ldcs(reinterpret_cast<const float4*>(nu + kk * step));
              w0[slot][k] = __ldcs(reinterpret_cast<const float4*>(mst + kk * step));
            }
          }
        };
        load(0, 0);
        // the seeds of the thread's two 64 x 64 sub-tiles (row halves) in its column block
        unsigned seed[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const unsigned im = (row0 >> 6) + i, in = (col0 + c4) >> 6;
          seed[i] = !dither ? 0u
                    : GROUPED ? grouped_tile_seed(step_bits, a.salt, im, in, 2u * e + set)
                              : tile_seed(step_bits, a.salt, im, in, set);
        }
#pragma unroll
        for (int b = 0; b < kBatches; ++b) {
          if (b + 1 < kBatches) load(b + 1, (b + 1) & 1);
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int kk = b * kBatch + k, row = rt + kk * RS;
            if (!col_in || row0 + row >= a.R) continue;
            const float4 g = *reinterpret_cast<const float4*>(st + kk * RS * LD);
            const float4 mm = m0[b & 1][k], vv = v0[b & 1][k], ww = w0[b & 1][k];
            float4 m1, v1, w1;
            adamw(g.x, hv, skip, mm.x, vv.x, ww.x, m1.x, v1.x, w1.x);
            adamw(g.y, hv, skip, mm.y, vv.y, ww.y, m1.y, v1.y, w1.y);
            adamw(g.z, hv, skip, mm.z, vv.z, ww.z, m1.z, v1.z, w1.z);
            adamw(g.w, hv, skip, mm.w, vv.w, ww.w, m1.w, v1.w, w1.w);
            __stcs(reinterpret_cast<float4*>(mu + kk * step), m1);
            __stcs(reinterpret_cast<float4*>(nu + kk * step), v1);
            __stcs(reinterpret_cast<float4*>(mst + kk * step), w1);
            const unsigned s0 = seed[(kk * RS) >> 6];
            const int r = (row0 + row) & 63;
            const __nv_bfloat162 lo = __halves2bfloat162(
                write_w<bf16>(w1.x, dither ? element_bits(s0, r, c) : 0u, dither),
                write_w<bf16>(w1.y, dither ? element_bits(s0, r, c + 1) : 0u, dither));
            const __nv_bfloat162 hi = __halves2bfloat162(
                write_w<bf16>(w1.z, dither ? element_bits(s0, r, c + 2) : 0u, dither),
                write_w<bf16>(w1.w, dither ? element_bits(s0, r, c + 3) : 0u, dither));
            uint2 packed;
            packed.x = *reinterpret_cast<const unsigned*>(&lo);
            packed.y = *reinterpret_cast<const unsigned*>(&hi);
            *reinterpret_cast<uint2*>(w + kk * step) = packed;
          }
        }
      }
    }
    if constexpr (SUMS > 0) {
      wg::consumers_sum<SUMS>(sums, red);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int set = 0; set < SETS; ++set) {
          if constexpr (MODE != kDw) a.partials[static_cast<size_t>(set) * a.n_tasks + t] = sums[set];
          if constexpr (ABFT) a.chk[static_cast<size_t>(set) * a.n_tasks + t] = sums[(MODE != kDw ? SETS : 0) + set];
        }
      }
    }
  }
};

// The B columns of a TN wgmma kernel's stage: 128 C columns a set (the
// dual form's 128 of dC beside the same 128 of dC2), but 64 a set for the
// dual form's norm and update, whose flush would otherwise hold the
// second set's 64 accumulators a thread over the first set's AdamW.
template <int MODE, bool DUAL>
__host__ __device__ constexpr int tn_bn() {
  return DUAL && MODE == kDw ? 2 * wg::kBN : wg::kBN;
}

// Every TN wgmma kernel.  Maps: A, dC, (A again), dC2 (dC again without
// the dual form).
#define SFC_TN_WGMMA_KERNEL(NAME, MODE_, GROUPED_, ABFT_)                                                     \
  template <bool DUAL, bool UPDATE = false>                                                                   \
  __global__ void __launch_bounds__(wg::kThreads, 1)                                                          \
      NAME(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,               \
           const __grid_constant__ CUtensorMap tm_a2, const __grid_constant__ CUtensorMap tm_b2,             \
           const wg::Params p, const TnFlush<MODE_, DUAL, GROUPED_, ABFT_> fl) {                              \
    wg::body<wg::kTn, DUAL, 0, false, tn_bn<MODE_, DUAL>()>(tm_a, tm_b, tm_a2, tm_b2, p, fl);                \
  }

#if SFC_BWD == 1 && !SFC_ABFT
SFC_TN_WGMMA_KERNEL(tn_wgmma_kernel, kDw, false, false)          // K8 dW
SFC_TN_WGMMA_KERNEL(grouped_tn_wgmma_kernel, kDw, true, false)  // K10 dW
#elif SFC_BWD == 1
SFC_TN_WGMMA_KERNEL(tn_wgmma_abft_kernel, kDw, false, true)  // K8 dW with the checksum lane
#elif !SFC_ABFT
// K8's and K10's norm (UPDATE false) and update modes
SFC_TN_WGMMA_KERNEL(tn_update_wgmma_kernel, UPDATE ? kUpdate : kNorm, false, false)
SFC_TN_WGMMA_KERNEL(grouped_tn_update_wgmma_kernel, UPDATE ? kUpdate : kNorm, true, false)
#else
SFC_TN_WGMMA_KERNEL(tn_update_wgmma_abft_kernel, UPDATE ? kUpdate : kNorm, false, true)  // with the lane
#endif
#undef SFC_TN_WGMMA_KERNEL

// The maps and Params of a TN wgmma launch: A (D, R) and dC / dC2 (D, C)
// row-major bf16, read in 64 x 64 boxes; the tasks are `experts` copies of
// the (2, tiles) table (K10: task t is expert t / tiles's, grp its (3,
// experts) rows).  R and C multiples of 8, D >= 1, every operand 16-byte
// aligned, as TMA needs.  Returns a CUDA error code, 0 if the launch can go.
static int tn_wgmma_setup(const void* a, const void* b, const void* b2, const int* tab, int tiles, int experts,
                          int R, int C, int D, int group, const int* grp, CUtensorMap* ma, CUtensorMap* mb,
                          CUtensorMap* mb2, wg::Params* p) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (R < 1 || C < 1 || D < 1 || R % 8 != 0 || C % 8 != 0 || tiles < 1 || experts < 1) return kInvalid;
  if (grp == nullptr && experts != 1) return kInvalid;
  if (!wg::aligned16(a) || !wg::aligned16(b) || !wg::aligned16(b2)) return kInvalid;
  *p = wg::Params{};
  p->tab = tab;
  p->tiles = tiles;
  p->n_tasks = experts * tiles;
  p->M = R;
  p->N = C;
  p->K = D;
  p->pairs = 1;
  p->group = group;
  p->grp = grp;
  p->n_groups = experts;
  int rc = wg::tensor_map(ma, a, R, D, 1, wg::kBK);
  if (rc == 0) rc = wg::tensor_map(mb, b, C, D, 1, wg::kBK);
  if (rc == 0 && b2 != nullptr) rc = wg::tensor_map(mb2, b2, C, D, 1, wg::kBK);
  if (rc == 0 && b2 == nullptr) *mb2 = *mb;
  return rc;
}

// One launch of a TN wgmma kernel with its flush; `opted`: the kernel's
// opt-in flags, one a device.
template <int MODE, bool DUAL, bool GROUPED, bool ABFT, typename Kernel>
static int tn_wgmma_launch(Kernel kernel, bool* opted, int ctas, cudaStream_t s, const CUtensorMap& ma,
                           const CUtensorMap& mb, const CUtensorMap& mb2, const wg::Params& p,
                           const TnFlush<MODE, DUAL, GROUPED, ABFT>& fl) {
  return wg::launch<tn_bn<MODE, DUAL>(), wg::kTn>(kernel, opted, ctas, s, ma, mb, ma, mb2, p, fl);
}

#endif  // SFC_DTYPE == 1 && (SFC_TN_WGMMA_ENTRY || SFC_TNU_WGMMA_ENTRY)

#if SFC_BWD == 2

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
      float m1, v1, w1;
      adamw(acc, hv, skip, mu[idx], nu[idx], mst[idx], m1, v1, w1);
      mu[idx] = m1;
      nu[idx] = v1;
      mst[idx] = w1;
      W[idx] = write_w<T>(w1, SR ? element_bits(seed, r, c) : 0u, SR && !skip);
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

#if SFC_DTYPE == 1 && defined(SFC_REP_CLUSTER_ENTRY)
// K4 on the cluster kernel: out (k_layers, M, N) copies of a (M, K) @ b
// (K, N), M <= 16, bf16 (out_f32: f32 copies).  tab is gemm_spec(1, nb,
// k_layers)'s (3, n_tasks) table; each task a cluster of `split` CTAs over
// sub-slabs of `sub` rows of its layer's slab.  vec_a also needs slab and
// sub multiples of 8.  Returns the launch's CUDA error.
extern "C" int SFC_REP_CLUSTER_ENTRY(const void* a, const void* b, void* out, int out_f32, const int* tab,
                                     int n_tasks, int M, int N, int K, int slab, int split, int sub, int vec_a,
                                     int vec_b, void* stream) {
  if (M < 1 || M > kSplitRows || split < 1 || split > kMaxLayers || slab < 1 || sub < 1 || n_tasks < 1)
    return (int)cudaErrorInvalidValue;
  if (vec_a && (slab % 8 != 0 || sub % 8 != 0)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = a;
  p.b = b;
  p.out = out;
  p.tab = tab;
  p.n_tasks = n_tasks;
  p.M = M;
  p.N = N;
  p.K = K;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  const auto kernel = out_f32 ? &sfc_gemm_replicated_cluster_kernel<float> : &sfc_gemm_replicated_cluster_kernel<bf16>;
  constexpr size_t bytes = SplitCfg<false>::BYTES;
  static bool opted_in[2][kMaxDevices] = {};
  const int rc = opt_in(kernel, bytes, opted_in[out_f32 ? 1 : 0]);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tasks * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, slab, sub);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
#endif  // SFC_DTYPE == 1 && SFC_REP_CLUSTER_ENTRY

#if SFC_DTYPE == 1 && defined(SFC_REP_WGMMA_ENTRY)
// K5 (and K4 past 16 rows) on the wgmma kernel: out (batch, k_layers, M,
// N) copies of a (batch, M, K) @ b, b (K, N) shared or, b_batched, (batch,
// K, N); bf16 inputs, out_f32 f32 copies.  tab is gemm_spec(mb, nb,
// k_layers)'s (3, tiles) table at 128-row blocks, 128 x 128 or with `wide`
// 128 x 256 C tiles; `ctas` persistent CTAs in workers of `group`.  K and
// N multiples of 8 and a, b 16-byte aligned, as TMA needs; slab a
// multiple of 64 or at least K.  Returns the launch's CUDA error.
extern "C" int SFC_REP_WGMMA_ENTRY(const void* a, const void* b, void* out, int out_f32, const int* tab, int tiles,
                                   int batch, int b_batched, int M, int N, int K, int k_layers, int slab, int wide,
                                   int ctas, int group, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || K % 8 != 0 || batch < 1 || tiles < 1 || k_layers < 1) return kInvalid;
  if (slab < 1 || (slab % wg::kBK != 0 && slab < K)) return kInvalid;
  if (!wg::aligned16(a) || !wg::aligned16(b)) return kInvalid;
  wg::Params p = {};
  p.tab = tab;
  p.tiles = tiles;
  p.n_tasks = batch * tiles;
  p.M = M;
  p.N = N;
  p.K = K;
  p.b_batched = b_batched;
  p.pairs = 1;
  p.group = group;
  p.pair_store = 1;
  p.out = static_cast<bf16*>(out);
  CUtensorMap ma, mb;
  int rc = wg::tensor_map(&ma, a, K, M, batch, wg::kBM);
  if (rc == 0) rc = wg::tensor_map(&mb, b, N, K, b_batched ? batch : 1, wg::kBK);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted[4][kMaxDevices] = {};  // narrow, wide; bf16, f32 copies
  constexpr int kNarrow = wg::kBN, kWide = 2 * wg::kBN;
  if (wide && out_f32)
    return wg::launch<kWide, wg::kRep>(&sfc_gemm_replicated_wgmma_kernel<kWide, true>, opted[3], ctas, s, ma, mb, ma,
                                       mb, p, wg::RepOut<true>{slab, k_layers});
  if (wide)
    return wg::launch<kWide, wg::kRep>(&sfc_gemm_replicated_wgmma_kernel<kWide, false>, opted[1], ctas, s, ma, mb, ma,
                                       mb, p, wg::RepOut<false>{slab, k_layers});
  if (out_f32)
    return wg::launch<kNarrow, wg::kRep>(&sfc_gemm_replicated_wgmma_kernel<kNarrow, true>, opted[2], ctas, s, ma, mb,
                                         ma, mb, p, wg::RepOut<true>{slab, k_layers});
  return wg::launch<kNarrow, wg::kRep>(&sfc_gemm_replicated_wgmma_kernel<kNarrow, false>, opted[0], ctas, s, ma, mb,
                                       ma, mb, p, wg::RepOut<false>{slab, k_layers});
}
#endif  // SFC_DTYPE == 1 && SFC_REP_WGMMA_ENTRY

namespace {

// One K6 launch of V vectors a thread: 32-bit indexing where the batch
// element's copies and one pass's reach past them stay under 2^31.
template <int V, bool VEC>
int launch_add_reduce(const ElemT* c, ElemT* out, int layers, long long mn, dim3 grid, int threads,
                      cudaStream_t s) {
  constexpr long long kVec = 16 / (long long)sizeof(ElemT);
  const long long reach = (long long)grid.x * threads * V * kVec;
  if ((long long)layers * mn + reach <= 0x7fffffffLL) {
    add_reduce_kernel<ElemT, V, VEC, int><<<grid, threads, 0, s>>>(c, out, layers, (int)mn);
  } else {
    add_reduce_kernel<ElemT, V, VEC, long long><<<grid, threads, 0, s>>>(c, out, layers, mn);
  }
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_add_reduce(const ElemT* c, ElemT* out, int layers, long long mn, dim3 grid, int threads, int v,
                      cudaStream_t s) {
  if (v == 1) return launch_add_reduce<1, VEC>(c, out, layers, mn, grid, threads, s);
  if (v == 2) return launch_add_reduce<2, VEC>(c, out, layers, mn, grid, threads, s);
  return launch_add_reduce<4, VEC>(c, out, layers, mn, grid, threads, s);
}

}  // namespace

// K6: out (batch, mn) = the f32 sum over l of copies (batch, layers, mn),
// cast to the copies' type, on a (ctas, batch) grid of CTAs of `threads`,
// v (1, 2 or 4) vectors a thread a pass (`sfc_gemm.add_reduce_launch`);
// vec asks for 16-byte vectors (mn a multiple of 16 / sizeof(T), both
// pointers 16-byte aligned).
extern "C" int SFC_ADD_REDUCE_ENTRY(const void* copies, void* out, int layers, int batch, long long mn, int vec,
                                    int threads, int v, int ctas, void* stream) {
  if (layers < 1 || batch < 1 || batch > 65535 || mn < 1 || ctas < 1 || threads < 32 ||
      threads > kReduceMaxThreads || threads % 32 != 0 || (v != 1 && v != 2 && v != 4) ||
      (vec && mn % (16 / (long long)sizeof(ElemT)) != 0))
    return (int)cudaErrorInvalidValue;
  const auto* c = static_cast<const ElemT*>(copies);
  auto* o = static_cast<ElemT*>(out);
  const dim3 grid((unsigned)ctas, (unsigned)batch);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_add_reduce<true>(c, o, layers, mn, grid, threads, v, s)
             : launch_add_reduce<false>(c, o, layers, mn, grid, threads, v, s);
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

#ifdef SFC_F32_ENTRY
// K1/K2's f32-output mode on the tile kernel: out (batch, M, N) f32 = a
// (batch, M, K) @ b, b (K, N) shared or, with b_bstride, (batch, K, N);
// bf16 inputs, no epilogue.  The other arguments as SFC_ENTRY's.  The
// -DSFC_ABFT=1 part's entry takes chk, the (batch * n_tasks) f32 partials
// of the lane.  Returns the launch's CUDA error.
static int f32_entry(const void* a, const void* b, void* out, const int* tab, int n_tasks, int batch, int M, int N,
                     int K, long long a_bstride, long long b_bstride, int vec_a, int vec_b, float* chk,
                     void* stream) {
  if (n_tasks < 1 || batch < 1 || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (SFC_ABFT && chk == nullptr) return (int)cudaErrorInvalidValue;
  Params p = {};
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
  p.out_scale = 1.0f;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  const dim3 grid((unsigned)n_tasks, (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if SFC_ABFT
  sfc_gemm_fused_f32out_abft_kernel<<<grid, kThreads, 0, s>>>(p, chk);
#else
  (void)chk;
  sfc_gemm_fused_f32out_kernel<<<grid, kThreads, 0, s>>>(p);
#endif
  return (int)cudaGetLastError();
}

#if !SFC_ABFT
extern "C" int SFC_F32_ENTRY(const void* a, const void* b, void* out, const int* tab, int n_tasks, int batch, int M,
                             int N, int K, long long a_bstride, long long b_bstride, int vec_a, int vec_b,
                             void* stream) {
  return f32_entry(a, b, out, tab, n_tasks, batch, M, N, K, a_bstride, b_bstride, vec_a, vec_b, nullptr, stream);
}
#else
extern "C" int SFC_F32_ENTRY(const void* a, const void* b, void* out, const int* tab, int n_tasks, int batch, int M,
                             int N, int K, long long a_bstride, long long b_bstride, int vec_a, int vec_b, float* chk,
                             void* stream) {
  return f32_entry(a, b, out, tab, n_tasks, batch, M, N, K, a_bstride, b_bstride, vec_a, vec_b, chk, stream);
}
#endif
#endif  // SFC_F32_ENTRY

#if SFC_DTYPE == 1 && defined(SFC_WGMMA_ENTRY)
// One launch of the wgmma kernel: `ctas` persistent CTAs, the tasks (batch
// element, C tile of tab) split into contiguous segments, one a CTA.  A
// (batch, M, K); B (K, N) or, b_batched, (batch, K, N); tab the (2, tiles)
// table of one batch element's C tiles, 128 x 128 (the GLU's 128 x 64), or
// with `wide` 128 x 256 (the GLU's 128 x 128); the epilogue pointers as
// SFC_ENTRY's (bias, gate_bias (N,), residual, out, out_gate (batch, M,
// N)).  A non-null grp (3, n_groups) selects the grouped mode (K3,
// sfc_gemm_grouped_wgmma_kernel): tab is the (3, tiles) grouped table at
// 128-row blocks, A the (M, K) packed rows of every expert, B and B_gate
// (n_groups, K, N), the biases (n_groups, N); batch 1, no residual, no
// b_batched.  K and N multiples of 8 and A, B, B_gate 16-byte aligned, as
// TMA needs.  The -DSFC_ABFT=1 part's entry takes chk, the (batch * tiles,
// wg::kLaneSlots) f32 partials of the lane.  Returns the launch's CUDA error.
static int wgmma_entry(const void* a, const void* b, const void* b_gate, const void* bias, const void* gate_bias,
                       const void* residual, void* out, void* out_gate, const int* tab, int tiles, int batch,
                       int b_batched, int M, int N, int K, int wide, int ctas, int group, int has_scale,
                       float out_scale, const int* grp, int n_groups, float* chk, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const bool grouped = grp != nullptr;
  if ((SFC_GLU != 0) != (b_gate != nullptr) || (SFC_GLU && b_batched)) return kInvalid;
  if (!SFC_GLU && gate_bias != nullptr) return kInvalid;
  if (out_gate != nullptr && (!SFC_GLU || residual != nullptr || has_scale)) return kInvalid;
  if (grouped && (batch != 1 || b_batched || residual != nullptr || n_groups < 1)) return kInvalid;
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || K % 8 != 0 || batch < 1 || tiles < 1) return kInvalid;
  if (!wg::aligned16(a) || !wg::aligned16(b) || !wg::aligned16(b_gate)) return kInvalid;
  if (SFC_ABFT && chk == nullptr) return kInvalid;
  wg::Params p = {};
  p.tab = tab;
  p.tiles = tiles;
  p.n_tasks = batch * tiles;
  p.M = M;
  p.N = N;
  p.K = K;
  p.b_batched = b_batched;
  p.pairs = 1;
  p.group = group;
  p.pair_store = 1;  // N is even
  p.bias = static_cast<const bf16*>(bias);
  p.gbias = static_cast<const bf16*>(gate_bias);
  p.res = static_cast<const bf16*>(residual);
  p.out = static_cast<bf16*>(out);
  p.out_gate = static_cast<bf16*>(out_gate);
  p.has_scale = has_scale;
  p.out_scale = out_scale;
  p.chk = chk;
  p.grp = grp;
  p.n_groups = n_groups;
  // B's (and B_gate's) batch dimension: the batch elements' or the experts' weights
  const int b_count = grouped ? n_groups : b_batched ? batch : 1;
  CUtensorMap ma, mb, mg;
  int rc = wg::tensor_map(&ma, a, K, M, batch, wg::kBM);
  if (rc == 0) rc = wg::tensor_map(&mb, b, N, K, b_count, wg::kBK);
  if (rc == 0 && b_gate != nullptr) rc = wg::tensor_map(&mg, b_gate, N, K, b_count, wg::kBK);
  if (rc != 0) return rc;
  if (b_gate == nullptr) mg = mb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted[4][kMaxDevices] = {};  // narrow, wide; grouped narrow, wide
  constexpr int kNarrow = wg::kBN, kWide = 2 * wg::kBN;
  constexpr bool GLU = SFC_GLU != 0;
#if SFC_ABFT
  if (grouped && wide)
    return wg::launch<kWide>(&sfc_gemm_grouped_wgmma_abft_kernel<GLU, SFC_ACT, kWide>, opted[3], ctas, s, ma, mb, ma,
                             mg, p);
  if (grouped)
    return wg::launch<kNarrow>(&sfc_gemm_grouped_wgmma_abft_kernel<GLU, SFC_ACT, kNarrow>, opted[2], ctas, s, ma, mb,
                               ma, mg, p);
  if (wide)
    return wg::launch<kWide>(&sfc_gemm_wgmma_abft_kernel<GLU, SFC_ACT, kWide>, opted[1], ctas, s, ma, mb, ma, mg, p);
  return wg::launch<kNarrow>(&sfc_gemm_wgmma_abft_kernel<GLU, SFC_ACT, kNarrow>, opted[0], ctas, s, ma, mb, ma, mg,
                             p);
#else
  if (grouped && wide)
    return wg::launch<kWide>(&sfc_gemm_grouped_wgmma_kernel<GLU, SFC_ACT, kWide>, opted[3], ctas, s, ma, mb, ma, mg,
                             p);
  if (grouped)
    return wg::launch<kNarrow>(&sfc_gemm_grouped_wgmma_kernel<GLU, SFC_ACT, kNarrow>, opted[2], ctas, s, ma, mb, ma,
                               mg, p);
  if (wide)
    return wg::launch<kWide>(&sfc_gemm_wgmma_kernel<GLU, SFC_ACT, kWide>, opted[1], ctas, s, ma, mb, ma, mg, p);
  return wg::launch<kNarrow>(&sfc_gemm_wgmma_kernel<GLU, SFC_ACT, kNarrow>, opted[0], ctas, s, ma, mb, ma, mg, p);
#endif
}

#if !SFC_ABFT
extern "C" int SFC_WGMMA_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                               const void* gate_bias, const void* residual, void* out, void* out_gate,
                               const int* tab, int tiles, int batch, int b_batched, int M, int N, int K, int wide,
                               int ctas, int group, int has_scale, float out_scale, const int* grp, int n_groups,
                               void* stream) {
  return wgmma_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, tiles, batch, b_batched, M, N, K,
                     wide, ctas, group, has_scale, out_scale, grp, n_groups, nullptr, stream);
}
#else
extern "C" int SFC_WGMMA_ENTRY(const void* a, const void* b, const void* b_gate, const void* bias,
                               const void* gate_bias, const void* residual, void* out, void* out_gate,
                               const int* tab, int tiles, int batch, int b_batched, int M, int N, int K, int wide,
                               int ctas, int group, int has_scale, float out_scale, const int* grp, int n_groups,
                               float* chk, void* stream) {
  return wgmma_entry(a, b, b_gate, bias, gate_bias, residual, out, out_gate, tab, tiles, batch, b_batched, M, N, K,
                     wide, ctas, group, has_scale, out_scale, grp, n_groups, chk, stream);
}
#endif

#ifdef SFC_WGMMA_F32_ENTRY
// K2's f32-output mode on the wgmma kernel (and K1's past 16 rows): out
// (batch, M, N) f32 = a (batch, M, K) @ b, b (K, N) or, b_batched, (batch,
// K, N); bf16 inputs, no epilogue; the other arguments as
// SFC_WGMMA_ENTRY's.  K and N multiples of 8 and a, b 16-byte aligned, as
// TMA needs.  The -DSFC_ABFT=1 part's entry takes chk, the (batch * tiles,
// wg::kLaneSlots) f32 partials of the lane.  Returns the launch's CUDA
// error.
static int wgmma_f32_entry(const void* a, const void* b, void* out, const int* tab, int tiles, int batch,
                           int b_batched, int M, int N, int K, int wide, int ctas, int group, float* chk,
                           void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || K % 8 != 0 || batch < 1 || tiles < 1) return kInvalid;
  if (!wg::aligned16(a) || !wg::aligned16(b) || !wg::aligned16(out)) return kInvalid;
  if (SFC_ABFT && chk == nullptr) return kInvalid;
  wg::Params p = {};
  p.tab = tab;
  p.tiles = tiles;
  p.n_tasks = batch * tiles;
  p.M = M;
  p.N = N;
  p.K = K;
  p.b_batched = b_batched;
  p.pairs = 1;
  p.group = group;
  p.pair_store = 1;  // N is even
  p.out = static_cast<bf16*>(out);  // written as f32 by the OutF32 flush
  p.out_scale = 1.0f;
  p.chk = chk;
  CUtensorMap ma, mb;
  int rc = wg::tensor_map(&ma, a, K, M, batch, wg::kBM);
  if (rc == 0) rc = wg::tensor_map(&mb, b, N, K, b_batched ? batch : 1, wg::kBK);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted[2][kMaxDevices] = {};  // narrow, wide
  constexpr int kNarrow = wg::kBN, kWide = 2 * wg::kBN;
#if SFC_ABFT
  if (wide)
    return wg::launch<kWide>(&sfc_gemm_wgmma_f32out_abft_kernel<kWide>, opted[1], ctas, s, ma, mb, ma, mb, p);
  return wg::launch<kNarrow>(&sfc_gemm_wgmma_f32out_abft_kernel<kNarrow>, opted[0], ctas, s, ma, mb, ma, mb, p);
#else
  if (wide) return wg::launch<kWide>(&sfc_gemm_wgmma_f32out_kernel<kWide>, opted[1], ctas, s, ma, mb, ma, mb, p);
  return wg::launch<kNarrow>(&sfc_gemm_wgmma_f32out_kernel<kNarrow>, opted[0], ctas, s, ma, mb, ma, mb, p);
#endif
}

#if !SFC_ABFT
extern "C" int SFC_WGMMA_F32_ENTRY(const void* a, const void* b, void* out, const int* tab, int tiles, int batch,
                                   int b_batched, int M, int N, int K, int wide, int ctas, int group, void* stream) {
  return wgmma_f32_entry(a, b, out, tab, tiles, batch, b_batched, M, N, K, wide, ctas, group, nullptr, stream);
}
#else
extern "C" int SFC_WGMMA_F32_ENTRY(const void* a, const void* b, void* out, const int* tab, int tiles, int batch,
                                   int b_batched, int M, int N, int K, int wide, int ctas, int group, float* chk,
                                   void* stream) {
  return wgmma_f32_entry(a, b, out, tab, tiles, batch, b_batched, M, N, K, wide, ctas, group, chk, stream);
}
#endif
#endif  // SFC_WGMMA_F32_ENTRY
#endif  // SFC_DTYPE == 1 && SFC_WGMMA_ENTRY

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

#if SFC_DTYPE == 1 && defined(SFC_NT_WGMMA_ENTRY)
// NT on the wgmma kernel: out (R, C) = a (R, D) @ b (C, D)^T [+ a2 @ b2^T
// when a2 is non-null], bf16, `ctas` persistent CTAs over the (2, tiles)
// table of the 128 x 128 output tiles (`wide`: 128 x 256), each a
// contiguous segment of it.  A non-null grp (3, n_groups) selects the
// grouped mode (K9, grouped_nt_wgmma_kernel): tab is the (3, tiles)
// grouped table at 128-row blocks, b (and b2) is (n_groups, C, D), R the
// packed rows of every expert.  D a multiple of 8 and every operand
// 16-byte aligned, as TMA needs.  Returns the launch's CUDA error.
extern "C" int SFC_NT_WGMMA_ENTRY(const void* a, const void* b, const void* a2, const void* b2, void* out,
                                  const int* tab, int tiles, int R, int C, int D, int wide, int ctas, int group,
                                  const int* grp, int n_groups, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const bool grouped = grp != nullptr;
  if ((a2 == nullptr) != (b2 == nullptr) || (grouped && n_groups < 1)) return kInvalid;
  if (R < 1 || C < 1 || D < 1 || D % 8 != 0 || tiles < 1) return kInvalid;
  if (!wg::aligned16(a) || !wg::aligned16(b) || !wg::aligned16(a2) || !wg::aligned16(b2)) return kInvalid;
  wg::Params p = {};
  p.tab = tab;
  p.tiles = tiles;
  p.n_tasks = tiles;
  p.M = R;
  p.N = C;
  p.K = D;
  p.pairs = a2 != nullptr ? 2 : 1;
  p.group = group;
  p.pair_store = C % 2 == 0;
  p.out = static_cast<wg::bf16*>(out);
  p.grp = grp;
  p.n_groups = n_groups;
  constexpr int kNarrow = wg::kBN, kWide = 2 * wg::kBN;
  const int bn = wide ? kWide : kNarrow;
  const int b_count = grouped ? n_groups : 1;  // the experts' weights
  CUtensorMap ma, mb, ma2, mb2;
  int rc = wg::tensor_map(&ma, a, D, R, 1, wg::kBM);
  if (rc == 0) rc = wg::tensor_map(&mb, b, D, C, b_count, bn);
  if (rc == 0 && a2 != nullptr) rc = wg::tensor_map(&ma2, a2, D, R, 1, wg::kBM);
  if (rc == 0 && a2 != nullptr) rc = wg::tensor_map(&mb2, b2, D, C, b_count, bn);
  if (rc != 0) return rc;
  if (a2 == nullptr) {
    ma2 = ma;
    mb2 = mb;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted[4][kMaxDevices] = {};  // narrow, wide; grouped narrow, wide
  if (grouped && wide)
    return wg::launch<kWide>(&grouped_nt_wgmma_kernel<kWide>, opted[3], ctas, s, ma, mb, ma2, mb2, p);
  if (grouped) return wg::launch<kNarrow>(&grouped_nt_wgmma_kernel<kNarrow>, opted[2], ctas, s, ma, mb, ma2, mb2, p);
  if (wide) return wg::launch<kWide>(&nt_wgmma_kernel<kWide>, opted[1], ctas, s, ma, mb, ma2, mb2, p);
  return wg::launch<kNarrow>(&nt_wgmma_kernel<kNarrow>, opted[0], ctas, s, ma, mb, ma2, mb2, p);
}
#endif  // SFC_DTYPE == 1 && SFC_NT_WGMMA_ENTRY

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

#if SFC_BWD == 1 && SFC_DTYPE == 1 && defined(SFC_TN_WGMMA_ENTRY)
// TN (K8 dW; K10 dW with grp) on the wgmma kernel: out (R, C) = a (D,
// R)^T @ b (D, C) [and out2 = a^T @ b2 when out2 is non-null], bf16,
// `ctas` persistent CTAs over contiguous segments of the `experts` x
// `tiles` tasks of the (2, tiles) table of the 128 x 128 output tiles.  A
// non-null grp (3, experts) selects the grouped mode: expert e contracts
// its rows [grp[e], grp[e] + grp[experts + e]) into its (R, C) slice of
// the (experts, R, C) outputs.  The -DSFC_ABFT=1 part's entry needs chk,
// the (n_sets, experts * tiles) f32 partials of the lane, and takes no
// grouped mode (K10 has no lane); the other takes no chk.  R and C
// multiples of 8, D >= 1 and every operand 16-byte aligned, as TMA needs.
// Returns the launch's CUDA error.
extern "C" int SFC_TN_WGMMA_ENTRY(const void* a, const void* b, const void* b2, void* out, void* out2,
                                  const int* tab, int tiles, int experts, int R, int C, int D, int ctas, int group,
                                  const int* grp, float* chk, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const bool dual = out2 != nullptr;
  if (out == nullptr || dual != (b2 != nullptr)) return kInvalid;
  if ((chk != nullptr) != (SFC_ABFT != 0) || (SFC_ABFT && grp != nullptr)) return kInvalid;
  if (!wg::aligned16(out) || !wg::aligned16(out2)) return kInvalid;
  CUtensorMap ma, mb, mb2;
  wg::Params p;
  const int rc = tn_wgmma_setup(a, b, b2, tab, tiles, experts, R, C, D, group, grp, &ma, &mb, &mb2, &p);
  if (rc != 0) return rc;
  TnArgs f = {};
  f.out[0] = static_cast<bf16*>(out);
  f.out[1] = static_cast<bf16*>(out2);
  f.chk = chk;
  f.R = R;
  f.C = C;
  f.n_tasks = p.n_tasks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool opted[4][kMaxDevices] = {};
#if SFC_ABFT
  if (dual)
    return tn_wgmma_launch(&tn_wgmma_abft_kernel<true>, opted[0], ctas, s, ma, mb, mb2, p,
                                 TnFlush<kDw, true, false, true>{f});
  return tn_wgmma_launch(&tn_wgmma_abft_kernel<false>, opted[1], ctas, s, ma, mb, mb2, p,
                                TnFlush<kDw, false, false, true>{f});
#else
  if (grp != nullptr && dual)
    return tn_wgmma_launch(&grouped_tn_wgmma_kernel<true>, opted[2], ctas, s, ma, mb, mb2, p,
                                 TnFlush<kDw, true, true, false>{f});
  if (grp != nullptr)
    return tn_wgmma_launch(&grouped_tn_wgmma_kernel<false>, opted[3], ctas, s, ma, mb, mb2, p,
                                  TnFlush<kDw, false, true, false>{f});
  if (dual)
    return tn_wgmma_launch(&tn_wgmma_kernel<true>, opted[0], ctas, s, ma, mb, mb2, p,
                                 TnFlush<kDw, true, false, false>{f});
  return tn_wgmma_launch(&tn_wgmma_kernel<false>, opted[1], ctas, s, ma, mb, mb2, p,
                                TnFlush<kDw, false, false, false>{f});
#endif
}
#endif  // SFC_BWD == 1 && SFC_DTYPE == 1 && SFC_TN_WGMMA_ENTRY

#if SFC_BWD == 2 && SFC_DTYPE == 1 && defined(SFC_TNU_WGMMA_ENTRY)
namespace {
// The update (UPDATE) or norm kernel of the part for one dual form: K8's,
// or K10's when grouped (the part without the lane), or K8's lane twin.
template <bool DUAL, bool UPDATE>
int tnu_wgmma_dispatch(bool grouped, int ctas, cudaStream_t s, const CUtensorMap& ma, const CUtensorMap& mb,
                       const CUtensorMap& mb2, const wg::Params& p, const TnArgs& f) {
  constexpr int MODE = UPDATE ? kUpdate : kNorm;
  static bool opted[2][kMaxDevices] = {};
#if SFC_ABFT
  (void)grouped;
  return tn_wgmma_launch(&tn_update_wgmma_abft_kernel<DUAL, UPDATE>, opted[0], ctas, s, ma, mb, mb2, p,
                               TnFlush<MODE, DUAL, false, true>{f});
#else
  if (grouped)
    return tn_wgmma_launch(&grouped_tn_update_wgmma_kernel<DUAL, UPDATE>, opted[1], ctas, s, ma, mb, mb2, p,
                                 TnFlush<MODE, DUAL, true, false>{f});
  return tn_wgmma_launch(&tn_update_wgmma_kernel<DUAL, UPDATE>, opted[0], ctas, s, ma, mb, mb2, p,
                               TnFlush<MODE, DUAL, false, false>{f});
#endif
}
}  // namespace

// TN with the update flush on the wgmma kernel (K8's and, with grp, K10's
// update and norm modes): SFC_TNU_ENTRY's operands and modes (norm when
// hyper is null) over SFC_TN_WGMMA_ENTRY's launch (table, tiles, experts,
// CTAs, grouped rows); partials and chk are (n_sets, experts * tiles).
// The -DSFC_ABFT=1 part's entry needs chk and takes no grouped mode; the
// other takes no chk.  Every operand and state pointer 16-byte aligned.
// Returns the launch's CUDA error.
extern "C" int SFC_TNU_WGMMA_ENTRY(const void* a, const void* b, const void* b2, int n_sets, void* w, void* w2,
                                   float* master, float* mu, float* nu, float* master2, float* mu2, float* nu2,
                                   const float* hyper, int salt, int sr, float* partials, const int* tab, int tiles,
                                   int experts, int R, int C, int D, int ctas, int group, const int* grp, float* chk,
                                   void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const bool dual = n_sets == 2, update = hyper != nullptr;
  if (n_sets != 1 && n_sets != 2) return kInvalid;
  if (dual != (b2 != nullptr) || partials == nullptr) return kInvalid;
  if ((chk != nullptr) != (SFC_ABFT != 0) || (SFC_ABFT && grp != nullptr)) return kInvalid;
  if (update) {
    if (!w || !master || !mu || !nu || dual != (w2 && master2 && mu2 && nu2)) return kInvalid;
    const void* state[] = {w, w2, master, mu, nu, master2, mu2, nu2};
    for (const void* x : state)
      if (!wg::aligned16(x)) return kInvalid;
  }
  CUtensorMap ma, mb, mb2;
  wg::Params p;
  const int rc = tn_wgmma_setup(a, b, b2, tab, tiles, experts, R, C, D, group, grp, &ma, &mb, &mb2, &p);
  if (rc != 0) return rc;
  TnArgs f = {};
  f.w[0] = static_cast<bf16*>(w);
  f.w[1] = static_cast<bf16*>(w2);
  f.mst[0] = master;
  f.mst[1] = master2;
  f.mu[0] = mu;
  f.mu[1] = mu2;
  f.nu[0] = nu;
  f.nu[1] = nu2;
  f.hyper = hyper;
  f.salt = static_cast<unsigned>(salt);
  f.sr = sr != 0;
  f.partials = partials;
  f.chk = chk;
  f.R = R;
  f.C = C;
  f.n_tasks = p.n_tasks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grouped = grp != nullptr;
  if (dual)
    return update ? tnu_wgmma_dispatch<true, true>(grouped, ctas, s, ma, mb, mb2, p, f)
                  : tnu_wgmma_dispatch<true, false>(grouped, ctas, s, ma, mb, mb2, p, f);
  return update ? tnu_wgmma_dispatch<false, true>(grouped, ctas, s, ma, mb, mb2, p, f)
                : tnu_wgmma_dispatch<false, false>(grouped, ctas, s, ma, mb, mb2, p, f);
}
#endif  // SFC_BWD == 2 && SFC_DTYPE == 1 && SFC_TNU_WGMMA_ENTRY
