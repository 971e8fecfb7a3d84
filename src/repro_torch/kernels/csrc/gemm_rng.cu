// Fused GEMM + dropout RNG: C = A @ B in f32, and the packed keep plane of
// one attention layer emitted by the same kernel, under the product.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::_gemm_rng_kernel
// (gemm_rng.py:143, pl.pallas_call at :241) and, with the emission off
// (mask == nullptr), gemm_rng.py::_plain_gemm_impl.kern (:304,
// pallas_call at :319) -- the paper's Region 3 host, whose mask the
// standalone Philox kernel makes instead. The emission is a run-time
// switch, so both variants run one compiled main loop and their times
// differ by the emission alone.
//
// What it computes. A (M, K) and B (K, N) are row-major f32; C (M, N) is
// row-major f32, each element one f32 sum over k in order of k-tiles. The
// plane is the flattened (rows_valid = B*H*SQ/32, SK) int32 layout, cut
// into the rb x ck rectangles of the JAX emission layout
// (gemm_rng.py::mask_emission_layout, judged on the JAX logical GEMM grid
// by the Python wrapper): block s covers rows [s / n_cb * rb, + rb) clipped
// to rows_valid and cols [s % n_cb * ck, + ck). Bits are position-based
// (philox.cuh::packed_word), so they do not depend on which CTA writes a
// block: CTA t (row-major over the CTA grid) writes blocks t, t + n_ctas,
// ... < n_valid_blocks, before its k-loop -- the CUDA form of JAX's
// "kk == 0" emission. Only valid blocks are written: the TPU's dummy
// overflow band (mask_rows_alloc) is BlockSpec plumbing with no bits.
//
// What bounds it on an H100: f32 operations. The QKV product of a
// llama2-7b training step at B=2, S=2048 (4096 x 12288 x 4096) is 412
// GFLOP, about 6.2 ms at the 67 TFLOP/s f32 (non-tensor-core) rate,
// against 0.34 GB of operands and result (0.1 ms at 3.35 TB/s); its plane
// is 8.4 M words of 8 Philox calls each, about 1 % of the GEMM's issue
// slots. The design is the textbook SIMT tiling: 128 x 128 C tiles, 8-deep
// k-slices of A (stored transposed) and B in shared memory, an 8 x 8
// register tile per thread (two 4 x 4 quadrants 64 apart, so shared-memory
// reads are conflict-free float4s), f32 FMA accumulation. No tensor cores
// (f32 operands, TF32 is off in the port), no double buffering yet. The
// RNG issues beside the FMA stream of the CTAs that own a block; nothing
// else waits for it.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKS = 8;  // k-slice depth
constexpr int NT = 256;
constexpr int PAD = 4;  // keeps float4 alignment of every smem row

struct Emit {
  int32_t* mask;  // nullptr: plain GEMM (Region 3)
  int rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks;
  uint32_t k0, k1, salt, bh_offset, heads_local, heads_global, threshold;
};

template <int ROUNDS>
__device__ void emit_blocks(const Emit& e) {
  const int n_ctas = gridDim.x * gridDim.y;
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  for (int s = t; s < e.n_valid_blocks; s += n_ctas) {
    const int r0 = (s / e.n_cb) * e.rb;
    const int r1 = min(r0 + e.rb, e.rows_valid);
    const int c0 = (s % e.n_cb) * e.ck;
    const int words = (r1 - r0) * e.ck;
    for (int i = threadIdx.x; i < words; i += NT) {
      const int r = r0 + i / e.ck;
      const int c = c0 + i % e.ck;
      e.mask[static_cast<size_t>(r) * e.sk + c] =
          static_cast<int32_t>(repro_philox::packed_word<ROUNDS>(
              static_cast<uint32_t>(r), static_cast<uint32_t>(c),
              static_cast<uint32_t>(e.sq32), e.heads_local, e.heads_global,
              e.bh_offset, e.salt, e.k0, e.k1, e.threshold));
    }
  }
}

template <int ROUNDS>
__global__ void __launch_bounds__(NT)
    gemm_rng_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K, bool a_vec,
                    bool b_vec, Emit e) {
  __shared__ __align__(16) float As[BKS][BM + PAD];
  __shared__ __align__(16) float Bs[BKS][BN + PAD];
  if (e.mask != nullptr) emit_blocks<ROUNDS>(e);

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

template <int ROUNDS>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           const Emit& e, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  // float4 loads need 16-byte rows and a 16-byte base
  const bool a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  gemm_rng_kernel<ROUNDS>
      <<<grid, NT, 0, s>>>(a, b, c, M, N, K, a_vec, b_vec, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A @ B (f32) and, when `mask` is not null, the layout's blocks of the
// packed keep plane. Launches on `stream`; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for bad sizes or an unimplemented round
// count.
extern "C" int repro_gemm_rng(const void* a, const void* b, void* c, int M,
                              int N, int K, void* mask, int rows_valid,
                              int sk, int sq32, int rb, int ck, int n_cb,
                              int n_valid_blocks, uint32_t key_lo,
                              uint32_t key_hi, uint32_t salt,
                              uint32_t bh_offset, int heads_local,
                              int heads_global, uint32_t threshold,
                              int rounds, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Emit e{static_cast<int32_t*>(mask), rows_valid, sk, sq32, rb, ck, n_cb,
         n_valid_blocks, key_lo, key_hi, salt, bh_offset,
         static_cast<uint32_t>(heads_local),
         static_cast<uint32_t>(heads_global), threshold};
  if (mask == nullptr) return launch<7>(A, B, C, M, N, K, e, s);
  if (rows_valid <= 0 || sk <= 0 || sq32 <= 0 || rb <= 0 || ck <= 0 ||
      n_cb <= 0 || n_valid_blocks < 0 || heads_local <= 0 ||
      heads_global <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rounds) {
    case 3: return launch<3>(A, B, C, M, N, K, e, s);
    case 5: return launch<5>(A, B, C, M, N, K, e, s);
    case 7: return launch<7>(A, B, C, M, N, K, e, s);
    case 10: return launch<10>(A, B, C, M, N, K, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
