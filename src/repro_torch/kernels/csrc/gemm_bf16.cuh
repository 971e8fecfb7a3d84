// The bf16 tensor-core GEMM of the fused bf16 GEMM+RNG kernels, shared by
// the dense host (gemm_rng_bf16.cu) and the grouped host
// (gemm_rng_grouped_bf16.cu): C[e] = A[e] @ B[e] from bf16 operands with
// f32 sums, C rounded once to bf16, and the dropout plane emitted by the
// CTAs' spare warps while their consumer warpgroups run the k-loop.
//
// Operands. A (E, M, K) and B (E, K, N) are row-major bf16 (E = 1: the
// dense host), B as the model keeps its weight: wgmma reads a 16-bit B
// MN-major through the instruction's transpose bit, so nothing is
// transposed. C (E, M, N) is row-major bf16. Rows lie K (A), N (B, C)
// elements apart; K and N must be multiples of 8 (TMA's 16-byte row
// stride), and the tensor maps read zeros past M, N and K -- for the
// grouped host 3-D maps over (K, M, E) and (N, K, E), so an expert's last
// CTA row reads zeros past its M rows, never the next expert's -- and no
// tile size has to divide the product.
//
// What it computes: every product a[i,k] * b[k,j] of two bf16 values is
// exact, the sums over k are f32 (wgmma's accumulator), and C[i,j] is that
// f32 sum rounded to bf16 once -- the JAX kernels' dot_general with
// preferred_element_type=f32 into an f32 scratch, cast to the operand
// dtype at the flush. Only the order of the f32 sums differs from the plain
// version's.
//
// The CTA (384 threads, one an SM; gemm_fp8.cuh's layout without its
// conversion and rescale): warpgroup 0 is the producer -- its warp 0 keeps
// TMA loads (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion)
// in flight over a ring of STAGES stages of A (128 rows x 64 k, K-major)
// and B (64 k x 128 n as two 64-n boxes, MN-major), and its warps 1-3
// compute and store this CTA's share of the dropout plane
// (gemm_emit.cuh::emit_share) while the consumers multiply; with no plane
// asked for they exit at once. Warpgroups 1 and 2 are the consumers: 64
// rows each, four m64n128k16 products a stage with both operands in shared
// memory and the f32 accumulator in registers (64 floats a thread); a
// stage goes back to the producer once the products of the next one are
// issued. CTAs walk the tiles expert by expert, in bands of GROUP_M tile
// rows, so a wave of CTAs shares its bands of A and B in L2; C stores stop
// at each expert's M rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gemm_emit.cuh"
#include "gemm_sm90.cuh"

namespace repro_gemm {
namespace bf16 {

using namespace sm90;

constexpr int BM = 128;  // CTA rows: two consumer warpgroups of 64
constexpr int BN = 128;  // CTA columns: the n of one wgmma
constexpr int BK = 64;   // k of a stage: one 128-byte row of bf16
constexpr int KS = 16;   // k of one bf16 wgmma
constexpr int STAGES = 5;
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GROUP_M = 8;
constexpr int A_BYTES = BM * BK * 2;       // 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;         // 64 k rows of 64 n (128 bytes)
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX;
// the ring (1024-byte aligned for the swizzle), then its full / empty
// barriers
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;

// The k-loop of consumer warpgroup w (rows m0 + 64 w .. of expert ex's C,
// which starts at `c`) and its store.
__device__ __forceinline__ void consume(uint32_t ring, uint32_t full,
                                        uint32_t empty,
                                        __nv_bfloat16* __restrict__ c, int M,
                                        int N, int K, int m0, int n0, int w) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int nkt = (K + BK - 1) / BK;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t stage = ring + s * STAGE_BYTES;
    // A: this warpgroup's 64 rows, K-major; slice j 32 bytes on (2 in the
    // descriptor's address field). B: MN-major, slice j 16 k rows (2048
    // bytes) on, its second 64 n one box (B_BOX bytes) on.
    const uint64_t da = smem_desc(stage + w * (64 * 128));
    const uint64_t db = smem_desc_mn(stage + A_BYTES, B_BOX);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / KS; ++j)
      wgmma_m64n128k16_bf16_bmn(d, da + 2 * j, db + (2048 >> 4) * j, 1);
    wgmma_commit();
    // the previous stage's products are done: its tiles go back
    wgmma_wait1();
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait0();
  fence_regs(d);

  // store: d's fragment layout -- row warp * 16 + lane / 4 (+ 8), column
  // 8 g + 2 (lane % 4) (+ 1); N is even, so a pair is in or out together
  const int r0 = m0 + 64 * w + warp * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    __nv_bfloat16* crow = c + static_cast<size_t>(r) * N;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int col = n0 + 8 * g + 2 * (lane % 4);
      if (col < N)
        *reinterpret_cast<__nv_bfloat162*>(crow + col) =
            __floats2bfloat162_rn(d[4 * g + 2 * h], d[4 * g + 2 * h + 1]);
    }
  }
}

template <int ROUNDS, bool GROUPED>
__global__ void __launch_bounds__(NT, 1)
    gemm_rng_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         __nv_bfloat16* __restrict__ c, int M, int N, int K,
                         int tiles_m, int tiles_n, Emit e) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;
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
    const int t = threadIdx.x;
    if (t == 0) {
      const int nkt = (K + BK - 1) / BK;
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(empty + 8 * s, ((kt / STAGES) + 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t dst = ring + s * STAGE_BYTES;
        tma_load<GROUPED>(dst, &map_a, full + 8 * s, kt * BK, m0, ex);
        tma_load<GROUPED>(dst + A_BYTES, &map_b, full + 8 * s, n0, kt * BK,
                          ex);
        tma_load<GROUPED>(dst + A_BYTES + B_BOX, &map_b, full + 8 * s,
                          n0 + 64, kt * BK, ex);
      }
    } else if (t >= 32 && e.mask != nullptr) {
      emit_share<ROUNDS>(e, blockIdx.x, gridDim.x, t - 32, 96);
    }
  } else {
    consume(ring, full, empty, c + static_cast<size_t>(ex) * M * N, M, N, K,
            m0, n0, wg - 1);
  }
}

// ------------------------------------------------------------ the host

template <int ROUNDS, bool GROUPED>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, __nv_bfloat16* c,
           int E, int M, int N, int K, const Emit& e, cudaStream_t s) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long ctas = static_cast<long long>(E) * tiles_m * tiles_n;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_rng_bf16_kernel<ROUNDS, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(ctas), NT, SMEM_BYTES, s>>>(ma, mb, c, M, N, K,
                                                       tiles_m, tiles_n, e);
  return static_cast<int>(cudaGetLastError());
}

// C[e] = A[e] @ B[e] for E experts (GROUPED; else E = 1, the dense host),
// bf16 operands, f32 sums, C rounded to bf16, and, when `mask` is not
// null, the layout's rectangles of the packed keep plane. K and N must be
// multiples of 8 and A, B and C must start on 16 bytes; an expert's rows
// follow the last one's. Returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for bad sizes, an unimplemented round count or a
// tensor map the driver refuses.
template <bool GROUPED>
int run(const void* a, const void* b, void* c, int E, int M, int N, int K,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || (!GROUPED && E != 1) || M <= 0 || N <= 0 || K <= 0 ||
      K % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e) ||
      (mask != nullptr && !layout_tiles_plane(e)))
    return static_cast<int>(cudaErrorInvalidValue);
  // A: boxes of 64 k x 128 rows (x 1 expert); B: boxes of 64 n x 64 k rows
  CUtensorMap ma, mb;
  if (!make_map<GROUPED>(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, E, M,
                         K, K, BK, BM) ||
      !make_map<GROUPED>(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, E, K,
                         N, N, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr)
    return launch<7, GROUPED>(ma, mb, C, E, M, N, K, e, s);
  switch (rounds) {
    case 3: return launch<3, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 5: return launch<5, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 7: return launch<7, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    case 10: return launch<10, GROUPED>(ma, mb, C, E, M, N, K, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bf16
}  // namespace repro_gemm
