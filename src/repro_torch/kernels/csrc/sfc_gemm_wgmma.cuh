// The bf16 GEMMs of the main path on Hopper's own machinery: persistent
// CTAs that walk contiguous segments of the gilbert curve, TMA loads into a
// ring of shared-memory stages, and wgmma products.  Included by
// sfc_gemm_fused.cu into the bf16 forward parts, their ABFT twins and the
// bf16 -DSFC_BWD=1 part, inside its anonymous namespace (it uses that
// file's `activate`); the host needs <cuda.h> for CUtensorMap, included
// there.
//
// sfc_gemm_wgmma_kernel replaces `repro/kernels/sfc_gemm.py::_fused_kernel`
// behind `sfc_gemm_batched_fused` and `sfc_gemm_fused` at more than 16
// rows (K2, and K1 past the cluster kernel's rows) for bf16 inputs whose
// rows TMA can describe: C[b] = epilogue(A[b] @ B[b or shared]), every
// epilogue flag and the GLU's preact mode, the arithmetic of fused_flush in
// its order with one cast.  sfc_gemm_wgmma_abft_kernel is its ABFT twin
// (the -DSFC_ABFT=1 parts), nt_wgmma_kernel replaces `sfc_gemm_nt`
// (`_nt_kernel`, K7) for bf16 non-grouped calls: dA = dC @ W^T
// (+ dC2 @ W2^T), flushed in bf16.
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
// ABFT: each task's slot of the partials holds the f32 sum of its raw
// accumulators (the GLU's two together), over the rows and columns inside
// the output; the wrapper sums the slots on the device.  The flush is the
// same code with the lane on or off.

#pragma once

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 288;    // two consumer warpgroups, then the producer warp
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kBM = 128;         // C tile rows, 64 a consumer warpgroup (build.py WGMMA_TILE)
constexpr int kBN = 128;         // B columns a stage of the narrow tile; the wide one's 256 (build.py WGMMA_TILE)
constexpr int kBK = 64;          // K a stage: one 128-byte swizzle row of bf16 (build.py WGMMA_BK)
constexpr int kStages = 4;
constexpr int kBox = 64;         // columns of one N-major TMA box: one 128-byte swizzle row
constexpr int kTileBytesA = kBM * kBK * 2;  // 16 KB

// Shared memory of a CTA with BN B columns a stage: the ring (aligned to
// the 1024-byte swizzle period) and its barriers.
template <int BN>
constexpr int smem_bytes() {
  return 1024 + kStages * (kTileBytesA + BN * kBK * 2) + 128;
}
static_assert(smem_bytes<2 * kBN>() <= 232448, "over the 227 KB a block may use");

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
  float* chk;  // ABFT: (n_tasks) f32 partials
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A (c0, c1, c2) box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators are written by the tensor cores until wait_group: keep
// the compiler from moving their reads and writes across it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, K-major) @ B (16 x N); TB: B N-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16<TB>(d, da, db);
}
template <int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16<TB>(d, da, db);
}

// Worker w's tasks of n_tasks split over n_workers: `_block_ranges`
// (repro/core/decomposition.py), contiguous and balanced, the first
// n_tasks % n_workers workers one task more.
__device__ __forceinline__ void segment(int n_tasks, int n_workers, int w, int& lo, int& hi) {
  const int base = n_tasks / n_workers, rem = n_tasks % n_workers;
  lo = w * base + min(w, rem);
  hi = lo + base + (w < rem ? 1 : 0);
}

// Task t: its batch element and its C tile's first row and column.
template <int TN>
__device__ __forceinline__ void task_tile(const Params& p, int t, int& b, int& row0, int& col0) {
  b = t / p.tiles;
  const int j = t - b * p.tiles;
  row0 = __ldg(p.tab + j) * kBM;
  col0 = __ldg(p.tab + p.tiles + j) * TN;
}

// Two adjacent outputs (gr, gc), (gr, gc + 1) from their raw accumulators
// v (and the GLU's gate g): the arithmetic of fused_flush in its order and
// one cast (NT: the cast only); masked at the ragged edge.  ABFT: the raw
// values flushed join the thread's lane sum.
template <bool NT, bool GLU, int ACT, bool ABFT>
__device__ __forceinline__ void flush_pair(const Params& p, long long c_off, int gr, int gc, const float (&v)[2],
                                           const float (&g)[2], float& lane) {
  if (gr >= p.M || gc >= p.N) return;
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
      if (p.bias) x += __bfloat162float(p.bias[gc + e]);
      if constexpr (GLU) {
        float gg = g[e];
        if (p.gbias) gg += __bfloat162float(p.gbias[gc + e]);
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

// The consumer warpgroups' named barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// The whole kernel: NT selects the dA product, GLU the forward's dual-B
// form, BN the B columns a stage (128 or 256).  Maps: the forward's A, B,
// (unused), B_gate; NT's A, B, A2, B2.
template <bool NT, bool GLU, int ACT, bool ABFT, int BN>
__device__ __forceinline__ void body(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const CUtensorMap& tm_a2,
                                     const CUtensorMap& tm_b2, const Params& p) {
  static_assert(!(NT && (GLU || ABFT)), "NT has neither the GLU form nor the lane");
  static_assert(BN == kBN || BN == 2 * kBN, "the narrow or the wide tile");
  constexpr int TN = GLU ? BN / 2 : BN;  // C columns a tile
  constexpr int ACC = BN / 2;            // f32 accumulators a consumer thread (m64nBN)
  constexpr int Q = ACC / (GLU ? 4 : 2);  // bf16 output pairs a thread flushes a tile
  constexpr int B_BYTES = BN * kBK * 2;
  constexpr int STAGE_BYTES = kTileBytesA + B_BYTES;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * STAGE_BYTES);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(empty + kStages);

  // the worker (group of p.group CTAs) and this CTA's first task of its segment
  int t_lo, t_hi;
  segment(p.n_tasks, gridDim.x / p.group, blockIdx.x / p.group, t_lo, t_hi);
  const int t_first = t_lo + blockIdx.x % p.group;
  const int steps = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        int b, row0, col0;
        task_tile<TN>(p, t, b, row0, col0);
        const int bb = p.b_batched ? b : 0;
        for (int pair = 0; pair < p.pairs; ++pair) {
          for (int s = 0; s < steps; ++s) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * STAGE_BYTES;
            unsigned char* sb = st + kTileBytesA;
            mbar_expect_tx(&full[stage], STAGE_BYTES);
            const int k0 = s * kBK;
            tma_load(st, pair ? &tm_a2 : &tm_a, &full[stage], k0, row0, b);
            if constexpr (NT) {
              tma_load(sb, pair ? &tm_b2 : &tm_b, &full[stage], k0, col0, 0);
            } else {
              // 64-column boxes: B's columns, then (GLU) B_gate's same ones
#pragma unroll
              for (int j = 0; j < BN / kBox; ++j) {
                if (GLU && j >= BN / (2 * kBox))
                  tma_load(sb + j * kBox * kBK * 2, &tm_b2, &full[stage], col0 + (j - BN / (2 * kBox)) * kBox, k0, 0);
                else
                  tma_load(sb + j * kBox * kBK * 2, &tm_b, &full[stage], col0 + j * kBox, k0, bb);
              }
            }
            if (++stage == kStages) {
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
    int b, row0, col0;
    task_tile<TN>(p, t, b, row0, col0);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    int prev = -1;  // the stage whose products may still be in flight
    for (int pair = 0; pair < p.pairs; ++pair) {
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_base = smem_u32(ring + stage * STAGE_BYTES) + wgi * (kTileBytesA / 2);
        const uint32_t b_base = smem_u32(ring + stage * STAGE_BYTES + kTileBytesA);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: K-major rows of 128 B, 8-row groups 1024 B apart, 32 B a k16
          const uint64_t da = desc_sw128(a_base + kk * 32, 16, 1024);
          // B: NT K-major as A; the forward N-major, 64-column boxes 8 KB
          // apart (LBO), 8-row K groups 1024 B apart, 2048 B a k16
          const uint64_t db = NT ? desc_sw128(b_base + kk * 32, 16, 1024)
                                 : desc_sw128(b_base + kk * 2048, kBox * kBK * 2, 1024);
          wgmma_tile<NT ? 0 : 1>(acc, da, db);
        }
        wgmma_commit();
        // one group stays in flight: the previous step's products are done,
        // so its stage goes back to the producer
        wgmma_wait<1>();
        fence_acc(acc);
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(&empty[prev]);

    // the flush: accumulator pair q holds rows r0 + 8 (q & 1), cols c0 + 8 (q >> 1) (+1);
    // the GLU's gate pair sits ACC / 2 registers further
    const int r0 = row0 + wgi * 64 + (tw / 32) * 16 + lane_id / 4;
    const int c0 = col0 + 2 * (lane_id % 4);
    const long long c_off = static_cast<long long>(b) * p.M * p.N;
    float lane = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float v[2] = {acc[2 * q], acc[2 * q + 1]};
      const float g[2] = {GLU ? acc[2 * q + ACC / 2] : 0.0f, GLU ? acc[2 * q + ACC / 2 + 1] : 0.0f};
      flush_pair<NT, GLU, ACT, ABFT>(p, c_off, r0 + 8 * (q & 1), c0 + 8 * (q >> 1), v, g, lane);
    }
    if constexpr (ABFT) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lane += __shfl_xor_sync(0xffffffffu, lane, o);
      if (lane_id == 0) red[threadIdx.x / 32] = lane;
      consumers_sync();
      if (threadIdx.x == 0) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kConsumers / 32; ++i) s += red[i];
        p.chk[t] = s;
      }
      consumers_sync();  // red is read before the next tile writes it
    }
  }
}

// ---------------------------------------------------------------------------
// the host side: tensor maps and the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library links without -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a (batch, rows, cols) row-major bf16 array read in boxes of
// box_rows x 64 columns with the 128-byte swizzle; zeros past every edge.
static int tensor_map(CUtensorMap* map, const void* base, long long cols, long long rows, long long batch,
                      int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2, static_cast<cuuint64_t>(cols * rows) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

static bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One launch of `kernel` (B columns BN a stage) over `ctas` persistent CTAs.
template <int BN, typename Kernel>
static int launch(Kernel kernel, bool* opted_in, int ctas, cudaStream_t s, const CUtensorMap& m0,
                  const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& m3, const Params& p) {
  if (p.group < 1 || ctas < p.group || ctas % p.group != 0 || ctas / p.group > p.n_tasks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = opt_in(kernel, smem_bytes<BN>(), opted_in);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem_bytes<BN>(), s>>>(m0, m1, m2, m3, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
