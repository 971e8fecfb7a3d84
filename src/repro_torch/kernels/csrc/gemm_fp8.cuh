// The e4m3 SIMT GEMM tile of the fused fp8 GEMM+RNG kernels, shared by the
// dense host (gemm_rng_fp8.cu) and the grouped host
// (gemm_rng_grouped_fp8.cu): C[e] ~= A[e] @ B[e] from e4m3 operands with one
// f32 scale per operand tile, the dropout plane's blocks emitted by the CTAs
// before their k-loops (gemm_emit.cuh).
//
// A (E, M, K) and B (E, K, N) are row-major e4m3fn bytes; a_s (E * M / bm,
// K / bk) and b_s (E * K / bk, N / bn) are row-major f32 scales, one per
// (bm, bk) tile of A and (bk, bn) tile of B -- the JAX logical GEMM blocks,
// with the expert folded into the tile-row index as JAX's grouped host
// folds it (quantize_tiled of the (E * M, K) and (E * K, N) reshapes). C
// (E, M, N) is row-major f32: for each k-block kb of bk columns, a partial
// sum p = sum over the block of a[i,k] * b[k,j] (e4m3 decoded exactly to
// f32, each product exact in f32), then C += p * (a_s[i/bm][kb] *
// b_s[kb][j/bn]) -- JAX's order of rounding, not dequantize-then-multiply.
// The scale tiles are JAX's, not the CTA's: bm and bn may be smaller than
// the 128 x 128 CTA tile or cut across it, so every accumulator row and
// column reads its own scale. bk is a multiple of 8, so k-blocks end on the
// 8-deep k-slices of the tiling. Expert e is blockIdx.z of a grouped launch
// (GROUPED: its own kernel name, so a profile tells the hosts apart); a
// dense launch (GROUPED false, E = 1) has no expert offsets and runs the
// arithmetic it ran before the grouped host existed. Rows past M of an
// expert read zeros and write nothing.
//
// The tiling is gemm_f32.cuh's with the loads decoding e4m3 to f32 in
// shared memory and a second 8 x 8 register tile for the k-block's partial
// sums: f32 FMAs, 173 registers, so one 256-thread CTA an SM.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_emit.cuh"

namespace repro_gemm {
namespace fp8 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKS = 8;  // k-slice depth
constexpr int NT = 256;
constexpr int PAD = 4;  // keeps float4 alignment of every smem row

// e4m3fn -> f32, exact: 1 sign, 4 exponent (bias 7), 3 mantissa bits; no
// infinities, NaN at 0x7f / 0xff; subnormals are m * 2^-9.
__device__ __forceinline__ float e4m3_to_f32(uint32_t v) {
  const uint32_t sign = (v & 0x80u) << 24;
  const uint32_t e = (v >> 3) & 0xFu;
  const uint32_t m = v & 0x7u;
  if (e == 0xFu && m == 0x7u) return __uint_as_float(sign | 0x7FC00000u);
  if (e == 0u)
    return __uint_as_float(sign |
                           __float_as_uint(static_cast<float>(m) *
                                           0.001953125f));
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

struct Scales {
  const float* a_s;  // (E * M / bm, gk): expert e's rows from e * M / bm
  const float* b_s;  // (E * gk, gn): expert e's rows from e * gk
  int bm, bn, bk, gk, gn;
};

template <int ROUNDS, bool GROUPED>
__global__ void __launch_bounds__(NT)
    gemm_rng_fp8_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ b,
                        float* __restrict__ c, int M, int N, int K,
                        Scales sc, bool a_vec, bool b_vec, Emit e) {
  __shared__ __align__(16) float As[BKS][BM + PAD];
  __shared__ __align__(16) float Bs[BKS][BN + PAD];
  if (e.mask != nullptr) emit_blocks<ROUNDS>(e);

  if constexpr (GROUPED) {
    // this CTA's expert: its operands, result and scale rows
    const size_t ex = blockIdx.z;
    a += ex * M * K;
    b += ex * K * N;
    c += ex * M * N;
    sc.a_s += ex * (M / sc.bm) * sc.gk;
    sc.b_s += ex * sc.gk * sc.gn;
  }

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // loader coordinates: A is 128 rows x 8 k (4 bytes per thread), B is
  // 8 k x 128 cols (4 bytes per thread)
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;

  float acc[8][8];
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKS) {
    {
      const int gr = m0 + a_row;
      const int gk = k0 + a_k;
      uint32_t w = 0;
      if (gr < M) {
        const uint8_t* src = a + static_cast<size_t>(gr) * K + gk;
        if (a_vec) {
          w = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w |= static_cast<uint32_t>(src[u]) << (8 * u);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        As[a_k + u][a_row] = e4m3_to_f32((w >> (8 * u)) & 0xFFu);
    }
    {
      const int gk = k0 + b_k;
      const int gc = n0 + b_col;
      uint32_t w = 0;
      const uint8_t* src = b + static_cast<size_t>(gk) * N + gc;
      if (b_vec && gc + 3 < N) {
        w = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc + u < N) w |= static_cast<uint32_t>(src[u]) << (8 * u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Bs[b_k][b_col + u] = e4m3_to_f32((w >> (8 * u)) & 0xFFu);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    __syncthreads();
    if ((k0 + BKS) % sc.bk == 0) {
      // end of k-block kb: rescale its partial sums onto the accumulator
      const int kb = k0 / sc.bk;
      float as_[8], bs_[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
        as_[i] = r < M ? sc.a_s[(r / sc.bm) * sc.gk + kb] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
        bs_[j] = col < N ? sc.b_s[kb * sc.gn + col / sc.bn] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = acc[i][j] + part[i][j] * (as_[i] * bs_[j]);
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (col < N) c[static_cast<size_t>(r) * N + col] = acc[i][j];
    }
  }
}

template <int ROUNDS, bool GROUPED>
int launch(const uint8_t* a, const uint8_t* b, float* c, int E, int M,
           int N, int K, const Scales& sc, const Emit& e, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  // 4-byte loads need 4-byte rows and a 4-byte base (K % 8 == 0 here; an
  // expert's base is then 4-byte aligned too)
  const bool a_vec = reinterpret_cast<uintptr_t>(a) % 4 == 0;
  const bool b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  gemm_rng_fp8_kernel<ROUNDS, GROUPED>
      <<<grid, NT, 0, s>>>(a, b, c, M, N, K, sc, a_vec, b_vec, e);
  return static_cast<int>(cudaGetLastError());
}


// C[e] ~= dequantized A[e] @ B[e] for E experts (GROUPED; else E = 1, the
// dense host) and, when `mask` is not null, the layout's blocks of the
// packed keep plane. (bm, bk) and (bk, bn) are the scale tiles; they must
// divide (M, K) and (K, N), and bk must be a multiple of 8. Returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes
// or an unimplemented round count.
template <bool GROUPED>
int run(const void* a, const void* b, const void* a_s, const void* b_s,
        void* c, int E, int M, int N, int K, int bm, int bn, int bk,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || E > 65535 || (!GROUPED && E != 1) || M <= 0 || N <= 0 ||
      K <= 0 || bm <= 0 ||
      bn <= 0 || bk <= 0 || M % bm || N % bn || K % bk || bk % BKS)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* B = static_cast<const uint8_t*>(b);
  float* C = static_cast<float*>(c);
  const Scales sc{static_cast<const float*>(a_s),
                  static_cast<const float*>(b_s), bm, bn, bk, K / bk,
                  N / bn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask == nullptr)
    return launch<7, GROUPED>(A, B, C, E, M, N, K, sc, e, s);
  switch (rounds) {
    case 3: return launch<3, GROUPED>(A, B, C, E, M, N, K, sc, e, s);
    case 5: return launch<5, GROUPED>(A, B, C, E, M, N, K, sc, e, s);
    case 7: return launch<7, GROUPED>(A, B, C, E, M, N, K, sc, e, s);
    case 10: return launch<10, GROUPED>(A, B, C, E, M, N, K, sc, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fp8
}  // namespace repro_gemm
