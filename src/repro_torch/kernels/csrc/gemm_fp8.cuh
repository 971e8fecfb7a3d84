// The e4m3 tensor-core GEMM of the fused fp8 GEMM+RNG kernels, shared by
// the dense host (gemm_rng_fp8.cu) and the grouped host
// (gemm_rng_grouped_fp8.cu): C[e] ~= A[e] @ B[e] from e4m3 operands with one
// f32 scale per operand tile, and the dropout plane emitted by the CTAs'
// spare warps while their consumer warpgroups run the k-loop.
//
// Operands. A (E, M, K) is row-major e4m3fn; B is handed over K-major, as
// Bt (E, N, K) row-major; their rows lie ldk >= K bytes apart, a multiple
// of 16 (TMA's row stride: a K of 8 x an odd number, as bk = 344 gives,
// comes zero-padded), with its scales to match: a_s (E * M / bm, K /
// bk) and bt_s (E * N / bn, K / bk), row-major f32, one per (bm, bk) tile
// of A and (bk, bn) tile of B -- the JAX logical GEMM blocks, the expert
// folded into the tile-row index as JAX's grouped host folds it. C (E, M,
// N) is row-major in the operands' model dtype (OutT): f32, or bf16 for
// bf16 operands (the e4m3 values quantized from their exact f32 upcast),
// rounded once from the f32 accumulator at the store -- JAX's out_dtype
// cast at the flush.
//
// What it computes: for each k-block kb of bk columns, the block's partial
// product p = sum over the block of a[i,k] * b[k,j], and C += p *
// (a_s[i/bm][kb] * bt_s[j/bn][kb]) with every accumulator element reading
// its own row and column scale (JAX's scale tiles cut across the kernel's
// 128 x 128 CTA tiles: bm = 240 or 192, bn = 176) -- JAX's order: p is
// summed on the tensor cores from zero (scale-d = 0) over its k-block and
// folded into the f32 accumulator as acc + p * (a_s * b_s), written out as
// two multiplies and an add (no fmaf: the build's --fmad=false keeps them
// apart, the plain version's order). A k16 slice that straddles a k-block
// end (bk = 344 = 21 * 16 + 8) is issued once for each of its two
// k-blocks, with A's 8 k outside that block zeroed in shared memory: a
// product with a zero is exactly zero, so each p is exactly its in-block
// sum. Any bk that is a multiple of 8 works so.
//
// Why f16 tensor cores. The e4m3 bytes are what the kernel reads; the
// products run as f16 wgmma (m64n128k16, f32 sums), after an exact e4m3 ->
// f16 conversion in shared memory (cvt.rn.f16x2.e4m3x2): every e4m3 value
// is an f16 value and every product of two is exact. The e4m3 wgmma
// (m64nNk32.f32.e4m3.e4m3) sums its 32 exact products in a narrower format
// than f32 (about 14 bits, DeepSeek-V3 report, arXiv:2412.19437 sec.
// 3.3.2), so its C misses the plain version's 1e-3 (1 + |C|) even when
// folded into f32 after every instruction (scripts/probe_e4m3_wgmma.py
// measures it); the f16 products and f32 sums stay within f32 rounding.
//
// The CTA (384 threads, one an SM): warpgroup 0 is the producer -- its
// warp 0 keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle, mbarrier
// completion) in flight over a ring of STAGES8 stages of 128 rows x 128 k
// of A and of Bt, and its warps 1-3 compute and store this CTA's share of
// the dropout plane (gemm_emit.cuh::emit_share) while the consumers
// multiply; with no plane asked for they exit at once. Warpgroups 1 and 2
// are the consumers: 64 rows each, one wgmma a k16 slice with both
// operands in shared memory, the k-block's sum and the accumulator in
// registers (64 + 64 floats a thread). While a stage's eight products run
// (back to back when no k-block ends inside the stage), the two convert
// the next stage from e4m3 into the other of two f16 stages, each its own
// 64 rows of A and half of Bt's. The register budget is the launch's 168 a
// thread: ptxas gives the consumers' code no more after their
// setmaxnreg.inc (a 512-thread layout with a converter warpgroup spilled
// the accumulators at 128). The tensor maps zero-fill rows past M (past
// the capacity of each expert: a 3-D map over (K, M, E)) and columns past
// K, and never read the next expert's rows. CTAs walk the tiles in bands
// of GROUP_M tile rows, so a wave of CTAs shares its bands of A and Bt in
// L2.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gemm_emit.cuh"
#include "gemm_sm90.cuh"

namespace repro_gemm {
namespace fp8 {

using namespace sm90;

constexpr int BM = 128;  // CTA rows: two consumer warpgroups of 64
constexpr int BN = 128;  // CTA columns: the n of one wgmma
constexpr int BK = 128;  // k of a stage: one 128-byte row of e4m3, two
                         // 128-byte rows ("atoms") of f16
constexpr int KS = 16;   // k of one f16 wgmma
constexpr int STAGES8 = 2;   // e4m3 ring, filled by TMA
constexpr int STAGES16 = 2;  // f16 stages: one multiplied, one converted
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GROUP_M = 8;
constexpr int E8_A = BM * BK;           // bytes, rows of 128 e4m3
constexpr int E8_STAGE = E8_A + BN * BK;
constexpr int ATOM = 128 * 128;         // bytes: 128 rows x 64 f16
constexpr int F16_A = 2 * ATOM;         // A's two atoms, then Bt's
constexpr int F16_STAGE = 4 * ATOM;
constexpr int SCALE_FLOATS = 64 + BN;  // a consumer's row and column scales
// the f16 stages (1024-byte aligned for the swizzle), the e4m3 ring, its
// full / empty barriers, and each consumer's scales of two k-blocks
constexpr int SMEM_BYTES = 1024 + STAGES16 * F16_STAGE + STAGES8 * E8_STAGE +
                           16 * STAGES8 + 2 * 2 * SCALE_FLOATS * 4;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 128 * 56 + 256 * 224 <= 65536

struct Scales {
  const float* a_s;   // (E * gm, gk)
  const float* bt_s;  // (E * gn, gk)
  int bm, bn, bk, gm, gn, gk;
};

// ------------------------------------------------------------ PTX helpers
// (the TMA, mbarrier and wgmma ones are gemm_sm90.cuh's)

// the 128 threads of consumer warpgroup w (named barriers 1 and 2)
__device__ __forceinline__ void bar_consumer(int w) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// four e4m3 bytes -> four f16 (exact: every e4m3 value is an f16 value)
__device__ __forceinline__ uint2 e4m3x4_to_f16x4(uint32_t v) {
  uint2 out;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;"
      : "=r"(out.x)
      : "h"(static_cast<unsigned short>(v & 0xFFFFu)));
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;"
      : "=r"(out.y)
      : "h"(static_cast<unsigned short>(v >> 16)));
  return out;
}

// the 256 threads of both consumer warpgroups (named barrier 3)
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// C elements from the f32 accumulator: as they are, or rounded once to
// bf16 (round to nearest even); a pair is two neighbouring columns
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------------------ the consumer

// The k-loop of consumer warpgroup w (rows m0 + 64 w ..) and its store.
// The warpgroup also converts its share of the next stage -- its own 64
// rows of A and 64 of Bt's 128 -- from the e4m3 ring into the f16 stage
// wgmma reads (both in the 128-byte swizzle), while this stage's products
// run.
template <bool GROUPED, typename OutT>
__device__ __forceinline__ void consume(uint32_t ring8, uint32_t ring16,
                                        uint32_t full8, uint32_t empty8,
                                        float* scale_buf,
                                        OutT* __restrict__ c, int M, int N,
                                        int K, int m0, int n0, int ex,
                                        const Scales& sc, int w) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int bk = sc.bk;
  const int nkt = (K + BK - 1) / BK;

  // e4m3 chunk c (16 k) of a row -> f16 chunks 2 c, 2 c + 1 of atom c / 4
  auto convert = [&](int kt) {
    const int s8 = kt % STAGES8;
    mbar_wait(full8 + 8 * s8, (kt / STAGES8) & 1);
    const uint32_t src = ring8 + s8 * E8_STAGE;
    const uint32_t dst = ring16 + (kt % STAGES16) * F16_STAGE;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // a quarter warp takes four chunks of one atom in two rows r and
      // r ^ 5 of an 8-row block: the swizzle then puts its eight loads
      // and its eight stores on eight distinct 16-byte bank groups
      const int q = t + 128 * (i % 4);
      const int op = i / 4;           // A, then Bt
      const int quarter = q / 8;
      const int pair = quarter % 4;
      const int row = 64 * w + 8 * ((quarter / 4) % 8) +
                      ((q % 8) < 4 ? pair : pair ^ 5);
      const int ch = 4 * (quarter / 32) + q % 4;
      const uint4 v = ld_shared_v4(src + op * E8_A + row * BK +
                                   ((ch ^ (row & 7)) << 4));
      const uint32_t out = dst + op * F16_A + (ch / 4) * ATOM + row * 128;
      const uint2 f0 = e4m3x4_to_f16x4(v.x), f1 = e4m3x4_to_f16x4(v.y);
      const uint2 f2 = e4m3x4_to_f16x4(v.z), f3 = e4m3x4_to_f16x4(v.w);
      st_shared_v4(out + (((2 * (ch % 4)) ^ (row & 7)) << 4),
                   make_uint4(f0.x, f0.y, f1.x, f1.y));
      st_shared_v4(out + (((2 * (ch % 4) + 1) ^ (row & 7)) << 4),
                   make_uint4(f2.x, f2.y, f3.x, f3.y));
    }
    // the f16 stage is visible to wgmma (the async proxy); the e4m3 stage
    // goes back to the producer
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(empty8 + 8 * s8);
  };

  // thread t stages row scale t (t < 64) and column scale t of each k-block
  const int row_t = m0 + 64 * w + t;
  const int col_t = n0 + t;
  const int a_base =
      (t < 64 && row_t < M) ? (ex * sc.gm + row_t / sc.bm) * sc.gk : -1;
  const int b_base = col_t < N ? (ex * sc.gn + col_t / sc.bn) * sc.gk : -1;
  float next_a = a_base >= 0 ? __ldg(sc.a_s + a_base) : 0.f;
  float next_b = b_base >= 0 ? __ldg(sc.bt_s + b_base) : 0.f;
  int scales_kb = -1;

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
  int pieces = 0;  // slices summed into d since the last fold

  // d holds k-block kb's sum: acc += d * (a_s * b_s), element by element
  auto fold = [&](int kb) {
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
    float* buf = scale_buf + (kb & 1) * SCALE_FLOATS;
    if (kb != scales_kb) {
      // k-blocks come in order, each folded at least once
      if (t < 64) buf[t] = next_a;
      buf[64 + t] = next_b;
      const int nk = kb + 1;
      next_a = (a_base >= 0 && nk < sc.gk) ? __ldg(sc.a_s + a_base + nk) : 0.f;
      next_b = (b_base >= 0 && nk < sc.gk) ? __ldg(sc.bt_s + b_base + nk)
                                           : 0.f;
      scales_kb = kb;
      bar_consumer(w);
    }
    const int r = warp * 16 + lane / 4;
    const float as0 = buf[r];
    const float as1 = buf[r + 8];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const float2 bs =
          *reinterpret_cast<const float2*>(buf + 64 + 8 * g + 2 * (lane % 4));
      acc[4 * g + 0] = acc[4 * g + 0] + d[4 * g + 0] * (as0 * bs.x);
      acc[4 * g + 1] = acc[4 * g + 1] + d[4 * g + 1] * (as0 * bs.y);
      acc[4 * g + 2] = acc[4 * g + 2] + d[4 * g + 2] * (as1 * bs.x);
      acc[4 * g + 3] = acc[4 * g + 3] + d[4 * g + 3] * (as1 * bs.y);
    }
    pieces = 0;
  };

  convert(0);
  bar_consumers();
  int kb = 0;           // the k-block the next product belongs to
  int kb_end = bk;      // and where it ends
  for (int kt = 0;; ++kt) {
    const int s = kt % STAGES16;
    const uint32_t a_tile = ring16 + s * F16_STAGE + w * (64 * 128);
    const uint64_t da0 = smem_desc(a_tile);
    const uint64_t db0 = smem_desc(ring16 + s * F16_STAGE + F16_A);
    // slice j: atom j / 4, 32 bytes (2 in the address field) per slice
    constexpr uint64_t kAtomDesc = ATOM >> 4;
    wgmma_fence();
    const int k_lo = kt * BK;
    if (k_lo + BK <= K && k_lo + BK <= kb_end) {
      // the whole stage in k-block kb: its eight products back to back
#pragma unroll
      for (int j = 0; j < BK / KS; ++j)
        wgmma_m64n128k16(d, da0 + (j / 4) * kAtomDesc + 2 * (j % 4),
                         db0 + (j / 4) * kAtomDesc + 2 * (j % 4),
                         j == 0 ? pieces : 1);
      pieces += BK / KS;
      if (k_lo + BK == kb_end) {
        fold(kb);
        ++kb;
        kb_end += bk;
      }
    } else {
      // a k-block ends inside the stage, or K does
#pragma unroll
      for (int j = 0; j < BK / KS; ++j) {
        const int k0 = kt * BK + j * KS;
        if (k0 >= K) break;
        // K is a multiple of 8: a last slice past it holds the tensor
        // maps' zeros, and straddles the last k-block's end at K
        const int k1 = k0 + KS;
        const uint64_t da = da0 + (j / 4) * kAtomDesc + 2 * (j % 4);
        const uint64_t db = db0 + (j / 4) * kAtomDesc + 2 * (j % 4);
        if (k1 <= kb_end) {
          wgmma_m64n128k16(d, da, db, pieces);
          ++pieces;
          if (k1 == kb_end) {
            fold(kb);
            ++kb;
            kb_end += bk;
            wgmma_fence();
          }
          continue;
        }
        // the slice straddles k-block kb's end, which is k0 + 8 (bk is a
        // multiple of 8): thread t holds 8 of the 64 rows x 16 k of this
        // warpgroup's slice (row t / 2, k from k0 + 8 (t % 2), at its
        // swizzled place) and keeps them for the pass of their k-block only
        const int row = t / 2;
        const uint32_t chunk = a_tile + (j / 4) * ATOM + row * 128 +
                               ((((2 * (j % 4)) + (t & 1)) ^ (row & 7)) << 4);
        const uint4 orig = ld_shared_v4(chunk);
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          st_shared_v4(chunk,
                       (t & 1) == pass ? orig : make_uint4(0u, 0u, 0u, 0u));
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          bar_consumer(w);
          wgmma_fence();
          wgmma_m64n128k16(d, da, db, pieces);
          ++pieces;
          if (pass == 0 || k1 == kb_end) {
            fold(kb);
            ++kb;
            kb_end += bk;
            // every warp's reads of this copy are done before the next one
            bar_consumer(w);
            wgmma_fence();
          }
        }
      }
    }
    if (kt == nkt - 1) {
      // the last k-block ended at K and its fold waited for every product;
      // the wait here only tells the compiler so, on the loop's one exit
      wgmma_commit();
      wgmma_wait0();
      break;
    }
    // this stage's products stay in flight (an unfinished piece carries on
    // into the next stage) while the next stage is converted into the f16
    // stage of the previous one, whose products both warpgroups finished
    wgmma_commit();
    wgmma_wait1();
    bar_consumers();
    convert(kt + 1);
    bar_consumers();
  }

  // store: d's fragment layout -- row warp * 16 + lane / 4 (+ 8), column
  // 8 g + 2 (lane % 4) (+ 1); each element rounded once to OutT
  if constexpr (GROUPED) c += static_cast<size_t>(ex) * M * N;
  const int r0 = m0 + 64 * w + warp * 16 + lane / 4;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    OutT* crow = c + static_cast<size_t>(r) * N;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int col = n0 + 8 * g + 2 * (lane % 4);
      const float x = acc[4 * g + 2 * h];
      const float y = acc[4 * g + 2 * h + 1];
      if (pairs && col + 1 < N) {
        store2(crow + col, x, y);
      } else {
        if (col < N) store1(crow + col, x);
        if (col + 1 < N) store1(crow + col + 1, y);
      }
    }
  }
}

// ------------------------------------------------------------ the kernel

template <int ROUNDS, bool GROUPED, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    gemm_rng_fp8_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        OutT* __restrict__ c, int M, int N, int K,
                        int tiles_m, int tiles_n, Scales sc, Emit e) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring16 = (raw + 1023u) & ~1023u;
  const uint32_t ring8 = ring16 + STAGES16 * F16_STAGE;
  const uint32_t full8 = ring8 + STAGES8 * E8_STAGE;
  const uint32_t empty8 = full8 + 8 * STAGES8;
  float* scales =
      reinterpret_cast<float*>(smem_raw + (empty8 + 8 * STAGES8 - raw));

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
    for (int s = 0; s < STAGES8; ++s) {
      mbar_init(full8 + 8 * s, 1);
      mbar_init(empty8 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int t = threadIdx.x;
    if (t == 0) {
      const int nkt = (K + BK - 1) / BK;
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES8;
        if (kt >= STAGES8)
          mbar_wait(empty8 + 8 * s, ((kt / STAGES8) + 1) & 1);
        mbar_expect_tx(full8 + 8 * s, E8_STAGE);
        const uint32_t dst = ring8 + s * E8_STAGE;
        tma_load<GROUPED>(dst, &map_a, full8 + 8 * s, kt * BK, m0, ex);
        tma_load<GROUPED>(dst + E8_A, &map_b, full8 + 8 * s, kt * BK, n0,
                          ex);
      }
    } else if (t >= 32 && e.mask != nullptr) {
      emit_share<ROUNDS>(e, blockIdx.x, gridDim.x, t - 32, 96);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume<GROUPED, OutT>(ring8, ring16, full8, empty8,
                     scales + (wg - 1) * 2 * SCALE_FLOATS, c, M, N, K, m0,
                     n0, ex, sc, wg - 1);
  }
}

// ------------------------------------------------------------ the host

template <int ROUNDS, bool GROUPED, typename OutT>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, OutT* c, int E,
           int M, int N, int K, const Scales& sc, const Emit& e,
           cudaStream_t s) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long ctas = static_cast<long long>(E) * tiles_m * tiles_n;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_rng_fp8_kernel<ROUNDS, GROUPED, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(ctas), NT, SMEM_BYTES, s>>>(
      ma, mb, c, M, N, K, tiles_m, tiles_n, sc, e);
  return static_cast<int>(cudaGetLastError());
}

// C[e] ~= dequantized A[e] @ Bt[e]^T for E experts (GROUPED; else E = 1,
// the dense host), C as OutT (f32, or bf16 rounded once; C starts on 16
// bytes), and, when `mask` is not null, the layout's rectangles of
// the packed keep plane. (bm, bk) and (bn, bk) are the scale tiles of A and
// Bt; they must divide (M, K) and (N, K), and bk must be a multiple of 8.
// The rows of A and Bt lie ldk bytes apart (ldk >= K, a multiple of 16:
// TMA's row stride; an expert's rows follow the last one's), and both
// operands start on 16 bytes; the maps read zeros past K. Returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes,
// an unimplemented round count or a tensor map the driver refuses.
template <bool GROUPED, typename OutT>
int run(const void* a, const void* bt, const void* a_s, const void* bt_s,
        void* c, int E, int M, int N, int K, int ldk, int bm, int bn, int bk,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || (!GROUPED && E != 1) || M <= 0 || N <= 0 || K <= 0 ||
      bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn || K % bk ||
      bk % 8 || ldk < K || ldk % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(bt) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scales sc{static_cast<const float*>(a_s),
                  static_cast<const float*>(bt_s), bm, bn, bk, M / bm,
                  N / bn, K / bk};
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e) ||
      (mask != nullptr && !layout_tiles_plane(e)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  // boxes of 128 k x 128 rows of e4m3 (BM == BN == 128)
  if (!make_map<GROUPED>(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, E, M, K,
                         ldk, BK, BM) ||
      !make_map<GROUPED>(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bt, E, N, K,
                         ldk, BK, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  OutT* C = static_cast<OutT*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr)
    return launch<7, GROUPED, OutT>(ma, mb, C, E, M, N, K, sc, e, s);
  switch (rounds) {
    case 3: return launch<3, GROUPED, OutT>(ma, mb, C, E, M, N, K, sc, e, s);
    case 5: return launch<5, GROUPED, OutT>(ma, mb, C, E, M, N, K, sc, e, s);
    case 7: return launch<7, GROUPED, OutT>(ma, mb, C, E, M, N, K, sc, e, s);
    case 10:
      return launch<10, GROUPED, OutT>(ma, mb, C, E, M, N, K, sc, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fp8
}  // namespace repro_gemm
