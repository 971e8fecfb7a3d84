// The f32 SIMT GEMM tile of the fused GEMM+RNG kernels, shared by the dense
// host (gemm_rng.cu, one product) and the grouped host (gemm_rng_grouped.cu,
// one product per expert): C[e] = A[e] @ B[e] in f32, with the dropout
// plane's blocks emitted by the CTAs before their k-loops (gemm_emit.cuh).
//
// A (E, M, K), B (E, K, N) and C (E, M, N) are row-major f32; expert e is
// blockIdx.z of a grouped launch (GROUPED: its own kernel name, so a
// profile tells the hosts apart). A dense launch (GROUPED false, E = 1)
// has no expert offsets at all and runs the arithmetic it ran before the
// grouped host existed. Each element of C is one f32 sum over k in order of
// k-tiles. Rows and columns past (M, N) of an expert are guarded: the last
// CTA row of an expert whose M is not a multiple of 128 (a MoE capacity of
// 480 rows) reads zeros there and writes nothing, and never touches the
// next expert's rows.
//
// The tiling: 128 x 128 C tiles, 8-deep k-slices of A (stored transposed)
// and B in shared memory, an 8 x 8 register tile per thread (two 4 x 4
// quadrants 64 apart, so shared-memory reads are conflict-free float4s),
// f32 FMA accumulation. No tensor cores (f32 operands, TF32 is off in the
// port), no double buffering yet.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_emit.cuh"

namespace repro_gemm {
namespace f32 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKS = 8;  // k-slice depth
constexpr int NT = 256;
constexpr int PAD = 4;  // keeps float4 alignment of every smem row

template <int ROUNDS, bool GROUPED>
__global__ void __launch_bounds__(NT)
    gemm_rng_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K, bool a_vec,
                    bool b_vec, Emit e) {
  __shared__ __align__(16) float As[BKS][BM + PAD];
  __shared__ __align__(16) float Bs[BKS][BN + PAD];
  if (e.mask != nullptr) emit_blocks<ROUNDS>(e);

  if constexpr (GROUPED) {
    // this CTA's expert
    const size_t ex = blockIdx.z;
    a += ex * M * K;
    b += ex * K * N;
    c += ex * M * N;
  }

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // loader coordinates: A is 128 rows x 8 k (4 per thread), B is 8 k x
  // 128 cols (4 per thread)
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKS) {
    {
      const int gr = m0 + a_row;
      const int gk = k0 + a_k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gr < M) {
        const float* src = a + static_cast<size_t>(gr) * K + gk;
        if (a_vec && gk + 3 < K) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (gk + u < K) v[u] = src[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) As[a_k + u][a_row] = v[u];
    }
    {
      const int gk = k0 + b_k;
      const int gc = n0 + b_col;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < K) {
        const float* src = b + static_cast<size_t>(gk) * N + gc;
        if (b_vec && gc + 3 < N) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (gc + u < N) v[u] = src[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) Bs[b_k][b_col + u] = v[u];
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
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
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
int launch(const float* a, const float* b, float* c, int E, int M, int N,
           int K, const Emit& e, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  // float4 loads need 16-byte rows and a 16-byte base (every expert's
  // base is then 16-byte aligned too)
  const bool a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  gemm_rng_kernel<ROUNDS, GROUPED>
      <<<grid, NT, 0, s>>>(a, b, c, M, N, K, a_vec, b_vec, e);
  return static_cast<int>(cudaGetLastError());
}

// C[e] = A[e] @ B[e] for E experts (GROUPED; else E = 1, the dense host)
// and, when `mask` is not null, the layout's blocks of the packed keep
// plane. Returns cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for bad sizes or an unimplemented round count.
template <bool GROUPED>
int run(const void* a, const void* b, void* c, int E, int M, int N, int K,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || E > 65535 || (!GROUPED && E != 1) || M <= 0 || N <= 0 ||
      K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask == nullptr)
    return launch<7, GROUPED>(A, B, C, E, M, N, K, e, s);
  switch (rounds) {
    case 3: return launch<3, GROUPED>(A, B, C, E, M, N, K, e, s);
    case 5: return launch<5, GROUPED>(A, B, C, E, M, N, K, e, s);
    case 7: return launch<7, GROUPED>(A, B, C, E, M, N, K, e, s);
    case 10: return launch<10, GROUPED>(A, B, C, E, M, N, K, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32
}  // namespace repro_gemm
