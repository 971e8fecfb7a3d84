// Flash-attention backward at f32 q/k/v/dO with the paper's dropout modes:
// dq, and dk / dv per query head, from scores recomputed with the
// forward's lse.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// _dq_kernel (flash_attention_bwd.py:77, pl.pallas_call at :266) and
// ::_dkv_kernel (:137, pallas_call at :288) at f32 (f32 only: the bf16
// instances are the tensor-core kernels of flash_dq_bf16.cu and
// flash_dkv_bf16.cu).
//
// What they compute (flash_attention_bwd.py:10-15). With keep mask K and
// P = exp(S * scale - lse) recomputed per tile (invalid scores masked to
// -0.7 * FLT_MAX as in the forward):
//     dP = K / (1-p) o (dO V^T),  dS = P o (dP - Delta),
//     dq = dS K * scale,  dk = dS^T Q * scale,  dv = (K o P / (1-p))^T dO,
// Delta = rowsum(dO o O) given by the caller (computed in torch, as JAX
// computes it outside its kernels). The dq kernel runs one CTA per (q-block,
// head, batch) over the k-blocks; the dkv kernel one CTA per (k-block,
// head, batch) over the q-blocks, and writes dk and dv of its query head:
// the GQA group sum stays in torch, as in JAX. Each output element is
// written by exactly one thread of one CTA -- no atomics -- so a training
// step is bitwise reproducible run to run. Keep bits come from the same
// sources as the forward (flash_common.cuh::keep_nibbles).
//
// What bounds them on an H100: f32 operations. Causal at B=2, H=32,
// S=2048, D=128: dq does three products over the valid half (103 GFLOP,
// about 1.5 ms at 67 TFLOP/s), dkv four (137 GFLOP, about 2.1 ms); their
// operands are under 0.3 GB (0.1 ms). The design is the forward's: every
// O(S^2) tile lives in registers and shared memory (dq: Q, dO, K, V and the
// dS tile, 149 KB at D = 128; dkv: K, V, Q, dO and two 64 x 64 tiles,
// 165 KB), one CTA an SM, f32 FMAs on the SIMT units (f32 operands: the
// tensor cores would round them).
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace repro_flash;

struct Bwd {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;  // (B, H, SK, D): per query head
  float* dv;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * BQ * (D + 1) + BQ * PP) * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * BQ * (D + 1) + 2 * BQ * PP) * 4;
}

// s = Q K^T and dp = dO V^T over one 64 x 64 tile, this thread's 4 x 4.
template <int D>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(4 * ty + i) * LD + d];
      gv[i] = dOs[(4 * ty + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// p = exp(masked s * scale - lse); dp <- dropped and scaled dp; p_drop the
// dropped probability (the dv operand); ds = p * (dp - delta).
template <int MODE>
__device__ __forceinline__ void grad_tiles(const Bwd& p, int b, int h,
                                           int q_start, int k_start, int ty,
                                           int tx, const float lse[4],
                                           const float delta[4],
                                           float s[4][4], float dp[4][4],
                                           float p_drop[4][4]) {
  const int q_offset = p.SK - p.SQ;
  uint32_t nib[4];
  keep_nibbles<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, ty, tx,
                     nib);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q_start + 4 * ty + i + q_offset;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float sc = s[i][j] * p.scale;
      if ((p.causal || p.local_window > 0) &&
          !score_valid(q_pos, k_start + tx + 16 * j, p.causal,
                       p.local_window))
        sc = neg_big();
      const float pr = expf(sc - lse[i]);
      float g = dp[i][j];
      float pd = pr;
      if (MODE != kNone) {
        const bool keep = (nib[j] >> i) & 1u;
        g = keep ? g * p.dp.inv_keep : 0.f;
        pd = keep ? pr * p.dp.inv_keep : 0.f;
      }
      p_drop[i][j] = pd;
      s[i][j] = pr * (g - delta[i]);  // ds
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Bwd p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = qi * BQ;
  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SQ + q_start;
  const size_t kv_base = (static_cast<size_t>(b) * p.KV + kvh) * p.SK * D;

  load_tile<D>(Qs, p.q + row0 * D, BQ);
  load_tile<D>(dOs, p.dout + row0 * D, BQ);
  float lse[4], delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = p.lse[row0 + 4 * ty + i];
    delta[i] = p.delta[row0 + 4 * ty + i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = p.SK / BK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_start = ki * BK;
    if (!tile_runs(q_start, k_start, p.SK - p.SQ, p.causal, p.local_window))
      continue;
    __syncthreads();
    load_tile<D>(Ks, p.k + kv_base + static_cast<size_t>(k_start) * D, BK);
    load_tile<D>(Vs, p.v + kv_base + static_cast<size_t>(k_start) * D, BK);
    __syncthreads();
    float s[4][4], dp[4][4], pd[4][4];
    score_tiles<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    grad_tiles<MODE>(p, b, h, q_start, k_start, ty, tx, lse, delta, s, dp,
                     pd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(4 * ty + i) * PP + tx + 16 * j] = s[i][j] * p.scale;
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dSs[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(g[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c)
      p.dq[(row0 + 4 * ty + i) * D + tx + 16 * c] = acc[i][c];
}

template <int D, int MODE>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Bwd p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pds = dOs + BQ * LD;
  float* dSs = Pds + BQ * PP;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int k_start = ki * BK;
  const size_t kv_base = (static_cast<size_t>(b) * p.KV + kvh) * p.SK * D;
  const size_t q_base = (static_cast<size_t>(b) * p.H + h) * p.SQ;

  load_tile<D>(Ks, p.k + kv_base + static_cast<size_t>(k_start) * D, BK);
  load_tile<D>(Vs, p.v + kv_base + static_cast<size_t>(k_start) * D, BK);
  // this thread accumulates key rows k_start + 4*ty + i, cols tx + 16*c
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int nq = p.SQ / BQ;
  for (int qi = 0; qi < nq; ++qi) {
    const int q_start = qi * BQ;
    if (!tile_runs(q_start, k_start, p.SK - p.SQ, p.causal, p.local_window))
      continue;
    __syncthreads();
    load_tile<D>(Qs, p.q + (q_base + q_start) * D, BQ);
    load_tile<D>(dOs, p.dout + (q_base + q_start) * D, BQ);
    float lse[4], delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lse[i] = p.lse[q_base + q_start + 4 * ty + i];
      delta[i] = p.delta[q_base + q_start + 4 * ty + i];
    }
    __syncthreads();
    float s[4][4], dp[4][4], pd[4][4];
    score_tiles<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    grad_tiles<MODE>(p, b, h, q_start, k_start, ty, tx, lse, delta, s, dp,
                     pd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Pds[(4 * ty + i) * PP + tx + 16 * j] = pd[i][j];
        dSs[(4 * ty + i) * PP + tx + 16 * j] = s[i][j] * p.scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pds[r * PP + 4 * ty + i];
        gv[i] = dSs[r * PP + 4 * ty + i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float o = dOs[r * LD + tx + 16 * c];
        const float qv = Qs[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], o, dv[i][c]);
          dk[i][c] = fmaf(gv[i], qv, dk[i][c]);
        }
      }
    }
  }
  const size_t out0 = (static_cast<size_t>(b) * p.H + h) * p.SK + k_start;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      p.dk[(out0 + 4 * ty + i) * D + tx + 16 * c] = dk[i][c];
      p.dv[(out0 + 4 * ty + i) * D + tx + 16 * c] = dv[i][c];
    }
}

template <int D, int MODE, bool DQ>
int launch(const Bwd& p, cudaStream_t s) {
  if constexpr (DQ) {
    constexpr int smem = dq_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<D, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_kernel<D, MODE><<<dim3(p.SQ / BQ, p.H, p.B), NT, smem, s>>>(p);
  } else {
    constexpr int smem = dkv_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<D, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_kernel<D, MODE><<<dim3(p.SK / BK, p.H, p.B), NT, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DQ>
int launch_mode(const Bwd& p, int mode, cudaStream_t s) {
  switch (mode) {
    case kNone: return launch<D, kNone, DQ>(p, s);
    case kPremask: return launch<D, kPremask, DQ>(p, s);
    case kCounters: return launch<D, kCounters, DQ>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DQ>
int launch_bwd(const Bwd& p, int D, int mode, cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV || p.SQ % BQ ||
      p.SK % BK || p.SQ <= 0 || p.SK <= 0 || p.dp.heads_global == 0 ||
      (mode == kPremask && p.dp.plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_mode<16, DQ>(p, mode, s);
    case 32: return launch_mode<32, DQ>(p, mode, s);
    case 64: return launch_mode<64, DQ>(p, mode, s);
    case 128: return launch_mode<128, DQ>(p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Bwd make_bwd(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk,
             void* dv, int B, int H, int KV, int SQ, int SK, float scale,
             int causal, int local_window, const void* plane,
             uint32_t threshold, float inv_keep, uint32_t key_lo,
             uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
             int heads_global, int rounds) {
  return Bwd{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<float*>(dq),
             static_cast<float*>(dk), static_cast<float*>(dv), B, H, KV, SQ,
             SK, scale, causal, local_window,
             Dropout{static_cast<const int32_t*>(plane), threshold, key_lo,
                     key_hi, salt, bh_offset,
                     static_cast<uint32_t>(heads_global), rounds,
                     inv_keep}};
}

}  // namespace

// The two backward kernels, each on `stream`, with the arguments of
// repro_flash_fwd plus dout, lse (B,H,SQ) and delta (B,H,SQ), all
// contiguous and f32.
// repro_flash_dq writes dq (B,H,SQ,D); repro_flash_dkv writes dk and dv per
// query head, (B,H,SK,D). Each returns the CUDA error code (0 on success).
#define REPRO_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, void *dq, void *dk, void *dv,     \
      int B, int H, int KV, int SQ, int SK, int D, float scale, int causal, \
      int local_window, int mode, const void *plane, uint32_t threshold,    \
      float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,      \
      uint32_t bh_offset, int heads_global, int rounds, void *stream
#define REPRO_BWD_PARAMS                                                    \
  make_bwd(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, SQ, SK, scale,  \
           causal, local_window, plane, threshold, inv_keep, key_lo,        \
           key_hi, salt, bh_offset, heads_global, rounds)

extern "C" int repro_flash_dq(REPRO_BWD_ARGS) {
  return launch_bwd<true>(REPRO_BWD_PARAMS, D, mode,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_dkv(REPRO_BWD_ARGS) {
  return launch_bwd<false>(REPRO_BWD_PARAMS, D, mode,
                           static_cast<cudaStream_t>(stream));
}
