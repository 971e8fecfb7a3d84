// The tensor-core GEMM of the fused f32 GEMM+RNG kernels: C[e] = A[e] @
// B[e] with f32 sums on f32 operands split into exact bf16 triples, and
// the dropout plane emitted by the CTAs' spare warps while their consumer
// warpgroups run the k-loop. The dense host (gemm_rng.cu) launches it with
// E = 1, the grouped host (gemm_rng_grouped.cu) with one product an
// expert; each is a library of its own. (The bf16 hosts run a persistent
// body of their own, gemm_bf16.cuh.)
//
// Operands. A (E, M, K) and B (E, K, N) are row-major f32 (E = 1: the
// dense host), B as the model keeps its weight: wgmma reads the 16-bit
// parts of B MN-major through the instruction's transpose bit, so nothing
// is transposed. C (E, M, N) is row-major f32. Rows lie K (A), N (B, C)
// elements apart; K and N must be multiples of 4 (TMA's 16-byte row
// stride), and the tensor maps read zeros past M, N and K -- for the
// grouped host 3-D maps over (K, M, E) and (N, K, E), so an expert's last
// CTA row reads zeros past its M rows, never the next expert's -- and no
// tile size has to divide the product.
//
// The CTA (384 threads, one an SM; gemm_fp8.cuh's layout): warpgroup 0 is
// the producer -- its warp 0 keeps TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle, mbarrier completion) in flight over a ring of stages of
// A (128 rows, K-major) and B (MN-major), and its warps 1-3 compute and
// store this CTA's share of the dropout plane (gemm_emit.cuh::emit_share)
// while the consumers multiply; with no plane asked for they exit at once.
// Warpgroups 1 and 2 are the consumers, 64 rows of C each, the f32
// accumulator in registers (64 floats a thread) and m64n128k16 bf16 wgmma
// products. CTAs walk the tiles expert by expert, in bands of GROUP_M tile
// rows, so a wave of CTAs shares its bands of A and B in L2; C stores stop
// at each expert's M rows.
//
// The operand policy (Ops) holds the stage's tile loads, the products of a
// stage, the k-loop and the store:
//  - F32Ops: both operands f32, each split into its exact bf16 triple (hi =
//    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); flash_sm90.cuh
//    ::split3) and each f32 product a b taken as the six part products
//    whose parts reach 2^-16 of it -- lo.hi, mid.mid, hi.lo, mid.hi,
//    hi.mid, hi.hi, the smallest first (part_a / part_b). The three left
//    out are each within 2^-24 of |a||b|, so the result is the f32 product
//    up to about 2^-23 of sum |a||b| and the order of the f32 sums. Stages
//    of 32 k (one 128-byte f32 row) come by TMA into a ring of four. The
//    two consumer warpgroups split each stage's B (32 k x 128 n, half each)
//    into one of two bf16 triple buffers in shared memory (MN-major, the
//    128-byte swizzle), and each thread splits its own fragments of A
//    straight from the f32 stage into registers (wgmma's RS form: A's parts
//    never reach shared memory, whose bandwidth the products and the splits
//    share) just before the stage's products; then the f32 stage goes back
//    to the producer. A stage's twelve products (six part products over two
//    k16 slices) sum from zero on the tensor cores while the next stage's B
//    is split; then the stage's sum is folded into C by one f32 add an
//    element, as the JAX kernel folds its k-blocks -- a sum chained over
//    all of K inside the tensor core misses the f32 limit
//    (scripts/probe_gemm_f32.py). The accumulator, the stage's sum and its
//    A fragments take more than the launch's 168 registers a thread: the
//    producer warpgroup gives the consumers its spare ones (setmaxnreg). C
//    is written as it is.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "flash_sm90.cuh"
#include "gemm_emit.cuh"
#include "gemm_sm90.cuh"

namespace repro_gemm {
namespace tc {

using namespace sm90;

constexpr int BM = 128;  // CTA rows: two consumer warpgroups of 64
constexpr int BN = 128;  // CTA columns: the n of one wgmma
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GROUP_M = 8;

// ------------------------------------------------------------ f32

// the 256 threads of both consumer warpgroups (named barrier 1)
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// eight f32 values (x, then y) -> their triples, as bf16 pairs
__device__ __forceinline__ void split8(const float4& x, const float4& y,
                                       uint32_t (&hi)[4], uint32_t (&mid)[4],
                                       uint32_t (&lo)[4]) {
  using repro_flash::tc::split3;
  split3(x.x, x.y, hi[0], mid[0], lo[0]);
  split3(x.z, x.w, hi[1], mid[1], lo[1]);
  split3(y.x, y.y, hi[2], mid[2], lo[2]);
  split3(y.z, y.w, hi[3], mid[3], lo[3]);
}

struct F32Ops {
  using T = float;
  static constexpr int kRowAlign = 4;  // elements in 16 bytes
  static constexpr int BK = 32;        // k of a stage (a multiple of 32)
  static constexpr int STAGES = 4;     // f32 stages in the TMA ring
  static constexpr int SLICES = BK / 16;       // k16 slices a stage
  static constexpr int A_BOX = BM * 32 * 4;    // 128 rows of 32 k (128 B)
  static constexpr int A_BYTES = (BK / 32) * A_BOX;
  static constexpr int B_BOX = BK * 32 * 4;    // BK k rows of 32 n
  static constexpr int STAGE_BYTES = A_BYTES + 4 * B_BOX;
  // a bf16 triple buffer of B: each part BK k rows of 128 n as two boxes
  // of 64 n (128 bytes)
  static constexpr int B_HALF = BK * 64 * 2;
  static constexpr int PART_B = 2 * B_HALF;
  static constexpr int TRIPLE = 3 * PART_B;
  static constexpr int EXTRA_BYTES = 2 * TRIPLE;
  // registers a thread after setmaxnreg: the producer gives the consumers
  // what their accumulator, a stage's sum and a stage's A fragments need
  // (gemm_fp8.cuh's split; at the launch's 168 a thread they spill)
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = 224;  // 128 * 56 + 256 * 224 <= 65536

  // A: boxes of 32 k x 128 rows (x 1 expert); B: boxes of 32 n x BK rows
  template <bool GROUPED>
  static bool make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                        const void* b, int E, int M, int N, int K) {
    return make_map<GROUPED>(ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, E,
                             M, K, K, 32, BM) &&
           make_map<GROUPED>(mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, E,
                             K, N, N, 32, BK);
  }

  template <bool GROUPED>
  __device__ static __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* ma,
                                              const CUtensorMap* mb,
                                              uint32_t bar, int kt, int m0,
                                              int n0, int ex) {
#pragma unroll
    for (int i = 0; i < BK / 32; ++i)
      tma_load<GROUPED>(dst + i * A_BOX, ma, bar, kt * BK + 32 * i, m0, ex);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tma_load<GROUPED>(dst + A_BYTES + i * B_BOX, mb, bar, n0 + 32 * i,
                        kt * BK, ex);
  }

  // The f32 stage at `stage` holds boxes of rows of 128 bytes in TMA's
  // 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8).

  // Consumer warpgroup w's thread t splits half of the stage's B (BK k x
  // 128 n) into the triple buffer at `tb`: 8 consecutive n a unit, BK / 16
  // units. A quarter warp's 16-byte loads and stores each fall on eight
  // distinct chunks of 128 bytes (no bank conflict): one k row, the odd
  // 32-n box taking its two chunks in the other order.
  __device__ static __forceinline__ void split_b(uint32_t stage, uint32_t tb,
                                                 int w, int t) {
    using repro_flash::tc::ld_shared_f4;
    using repro_flash::tc::pinned;
    using repro_flash::tc::st_shared_u4;
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      // k row u / 16, n 8 (u % 16) .. + 7
      const int u = t + 128 * w + 256 * i;
      const int k = u / 16, n8 = u % 16;
      const int odd = (n8 / 4) & 1;
      const int c0 = 2 * (n8 % 4);
      const uint32_t src = pinned(stage) + A_BYTES + (n8 / 4) * B_BOX +
                           k * 128;
      const float4 f0 = ld_shared_f4(src + (((c0 + odd) ^ (k & 7)) << 4));
      const float4 f1 =
          ld_shared_f4(src + (((c0 + 1 - odd) ^ (k & 7)) << 4));
      uint32_t hi[4], mid[4], lo[4];
      split8(odd ? f1 : f0, odd ? f0 : f1, hi, mid, lo);
      const uint32_t dst = pinned(tb) + (n8 / 8) * B_HALF + k * 128 +
                           (((n8 % 8) ^ (k & 7)) << 4);
      st_shared_u4(dst, hi);
      st_shared_u4(dst + PART_B, mid);
      st_shared_u4(dst + 2 * PART_B, lo);
    }
  }

  // Thread t's A fragments of warpgroup w's 64 rows of the stage, split
  // into triples: fa[part][slice] is the m64k16 A operand of k16 slice
  // `slice` (rows 16 (t / 32) + t % 32 / 4, + 8; k 2 (t % 4), + 1, + 8, + 9
  // of the slice: flash_sm90.cuh's fragment layout) -- wgmma's RS form,
  // so A's parts never reach shared memory.
  __device__ static __forceinline__ void a_frags(
      uint32_t stage, int w, int t, uint32_t (&fa)[3][SLICES][4]) {
    using repro_flash::tc::pinned;
    using repro_flash::tc::split3;
    const int c = t % 4;
    const int r0 = 64 * w + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < SLICES; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 8 * (q & 1), k = 16 * j + 2 * c + 8 * (q >> 1);
        const uint32_t at = pinned(stage) + (k / 32) * A_BOX + r * 128 +
                            ((((k % 32) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4;
        float x, y;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                     : "=f"(x), "=f"(y)
                     : "r"(at));
        split3(x, y, fa[0][j][q], fa[1][j][q], fa[2][j][q]);
      }
  }

  // d = this warpgroup's 64 rows of the stage's A B: the six part products,
  // the smallest first, each over the stage's k16 slices, A's parts from the
  // fragments `fa`, B's from the triple buffer at `tb` (MN-major); d is
  // replaced by the first. The caller fences and commits.
  __device__ static __forceinline__ void products(
      float (&d)[64], const uint32_t (&fa)[3][SLICES][4], uint32_t tb) {
    using repro_flash::tc::part_a;
    using repro_flash::tc::part_b;
    using repro_flash::tc::wgmma_rs;
    const uint64_t db = smem_desc_mn(tb, B_HALF);
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int j = 0; j < SLICES; ++j)
        wgmma_rs<128>(d, fa[part_a(n)][j],
                      db + ((part_b(n) * PART_B + 2048 * j) >> 4),
                      n > 0 || j > 0);
  }

  // The k-loop of consumer warpgroup w (rows m0 + 64 w .. of expert ex's C,
  // which starts at `c`) over the f32 ring and the B triple buffers at
  // `tri`, and its store.
  __device__ static __forceinline__ void consume(uint32_t ring, uint32_t tri,
                                                 uint32_t full,
                                                 uint32_t empty,
                                                 T* __restrict__ c, int M,
                                                 int N, int K, int m0,
                                                 int n0, int w) {
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int nkt = (K + BK - 1) / BK;

    // stage kt's half of B into triple kt % 2
    auto split_stage = [&](int kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      split_b(ring + s * STAGE_BYTES, tri + (kt % 2) * TRIPLE, w, t);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    };

    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    split_stage(0);
    bar_consumers();
    for (int kt = 0; kt < nkt; ++kt) {
      // this thread's A fragments of stage kt, whose full barrier its B
      // split waited for; then the f32 stage goes back
      const int s = kt % STAGES;
      uint32_t fa[3][SLICES][4];
      a_frags(ring + s * STAGE_BYTES, w, t, fa);
      mbar_arrive(empty + 8 * s);
      wgmma_fence();
      products(d, fa, tri + (kt % 2) * TRIPLE);
      wgmma_commit();
      // the next stage's B into the other triple, whose products both
      // warpgroups finished before the last barrier, while this one's
      // products run
      if (kt + 1 < nkt) split_stage(kt + 1);
      wgmma_wait0();
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = acc[i] + d[i];
      // both halves of the next B split, and every read of this triple
      bar_consumers();
    }

    // store: acc's fragment layout -- row warp * 16 + lane / 4 (+ 8),
    // column 8 g + 2 (lane % 4) (+ 1); N is a multiple of 4, so a pair is
    // in or out together
    const int r0 = m0 + 64 * w + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      T* crow = c + static_cast<size_t>(r) * N;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const int col = n0 + 8 * g + 2 * (lane % 4);
        if (col < N)
          *reinterpret_cast<float2*>(crow + col) =
              make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
      }
    }
  }
};

// ------------------------------------------------------------ the body

// the ring (1024-byte aligned for the swizzle), the policy's buffers past
// it, then the ring's full / empty barriers
template <class Ops>
constexpr int smem_bytes() {
  return 1024 + Ops::STAGES * Ops::STAGE_BYTES + Ops::EXTRA_BYTES +
         16 * Ops::STAGES;
}

template <class Ops, int ROUNDS, bool GROUPED>
__global__ void __launch_bounds__(NT, 1)
    gemm_rng_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       typename Ops::T* __restrict__ c, int M, int N, int K,
                       int tiles_m, int tiles_n, Emit e) {
  constexpr int STAGES = Ops::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t extra = ring + STAGES * Ops::STAGE_BYTES;
  const uint32_t full = extra + Ops::EXTRA_BYTES;
  const uint32_t empty = full + 8 * STAGES;

  // this CTA's tile: expert, then bands of GROUP_M tile rows walked
  // column by column
  const int per_expert = tiles_m * tiles_n;
  const int ex = GROUPED ? blockIdx.x / per_expert : 0;
  const int r = blockIdx.x % per_expert;
  const int band = r / (GROUP_M * tiles_n);
  const int first_m = band * GROUP_M;
  const int band_rows = min(tiles_m - first_m, GROUP_M);
  const int in_band = r % (GROUP_M * tiles_n);
  const int m0 = (first_m + in_band % band_rows) * BM;
  const int n0 = (in_band / band_rows) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (Ops::kProducerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
          Ops::kProducerRegs));
    const int t = threadIdx.x;
    if (t == 0) {
      const int nkt = (K + Ops::BK - 1) / Ops::BK;
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(empty + 8 * s, ((kt / STAGES) + 1) & 1);
        mbar_expect_tx(full + 8 * s, Ops::STAGE_BYTES);
        Ops::template load<GROUPED>(ring + s * Ops::STAGE_BYTES, &map_a,
                                    &map_b, full + 8 * s, kt, m0, n0, ex);
      }
    } else if (t >= 32 && e.mask != nullptr) {
      emit_share<ROUNDS>(e, blockIdx.x, gridDim.x, t - 32, 96);
    }
  } else {
    if constexpr (Ops::kConsumerRegs > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          Ops::kConsumerRegs));
    Ops::consume(ring, extra, full, empty,
                 c + static_cast<size_t>(ex) * M * N, M, N, K, m0, n0,
                 wg - 1);
  }
}

// ------------------------------------------------------------ the host

template <class Ops, int ROUNDS, bool GROUPED>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, typename Ops::T* c,
           int E, int M, int N, int K, const Emit& e, cudaStream_t s) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long ctas = static_cast<long long>(E) * tiles_m * tiles_n;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<Ops>();
  auto kernel = gemm_rng_tc_kernel<Ops, ROUNDS, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(ctas), NT, smem, s>>>(ma, mb, c, M, N, K,
                                                  tiles_m, tiles_n, e);
  return static_cast<int>(cudaGetLastError());
}

// C[e] = A[e] @ B[e] for E experts (GROUPED; else E = 1, the dense host) in
// the policy's dtype, f32 sums, and, when `mask` is not null, the layout's
// rectangles of the packed keep plane. K and N must be multiples of
// Ops::kRowAlign and A, B and C must start on 16 bytes; an expert's rows
// follow the last one's. Returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for bad sizes, a layout that does not tile the
// plane, an unimplemented round count or a tensor map the driver refuses.
template <class Ops, bool GROUPED>
int run(const void* a, const void* b, void* c, int E, int M, int N, int K,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || (!GROUPED && E != 1) || M <= 0 || N <= 0 || K <= 0 ||
      K % Ops::kRowAlign || N % Ops::kRowAlign ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e) ||
      (mask != nullptr && !layout_tiles_plane(e)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!Ops::template make_maps<GROUPED>(&ma, &mb, a, b, E, M, N, K))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename Ops::T;
  T* C = static_cast<T*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr)
    return launch<Ops, 7, GROUPED>(ma, mb, C, E, M, N, K, e, s);
  switch (rounds) {
    case 3: return launch<Ops, 3, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 5: return launch<Ops, 5, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 7: return launch<Ops, 7, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 10: return launch<Ops, 10, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc
}  // namespace repro_gemm
