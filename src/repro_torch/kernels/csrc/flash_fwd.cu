// Flash-attention forward with the paper's dropout modes: online softmax
// over k-blocks, out (B, H, SQ, D) and the row log-sum-exp (B, H, SQ).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300), reached
// through flash_attention_mosaic (:388-433), at f32 q/k/v (f32 only: the
// bf16 instance is the tensor-core kernel of flash_fwd_bf16.cu).
//
// What it computes (the JAX kernel's rules, :126-168). One CTA per (q-block
// of 64 rows, head h, batch b) walks the k-blocks in order. Scores are
// (q . k) * scale; with `causal` a tile with no valid score is skipped and
// invalid scores become -0.7 * FLT_MAX (queries sit at k positions
// q + SK - SQ; a local window also needs k > q - window). The running max m
// and denominator l follow the online softmax, l summing the UNDROPPED
// probabilities; dropout zeroes a probability's numerator term only, and
// 1/(1-p) is applied once at the end. l == 0 becomes 1; lse = m + log(l).
// Dropout bits: MODE kPremask reads bit q % 32 of word (q / 32, k) of the
// (b, h) plane; kCounters re-derives them from the Philox counters
// (x0 = k, x1 = q / 4, x2 = global_bh(b * H + h), x3 = salt) -- "replay"
// with the seed-salt words of the plan, "fused" with bh_offset 0. GQA: head
// h reads kv head h / (H / KV). The bits do not depend on the tiling; only
// the order of float sums does.
//
// What bounds it on an H100: f32 operations. Causal at B=2, H=32, S=2048,
// D=128 is 69 GFLOP of products (QK^T and PV over the valid half), about
// 1.0 ms at 67 TFLOP/s; its operands are 0.2 GB (0.06 ms). The design keeps
// every O(S^2) value on chip: Q (64 x D), one K-or-V (64 x D) and the
// probability tile (64 x 64) in shared memory (83 KB at D = 128, two CTAs
// an SM), a 4 x 4 score tile and a 4 x D/16 output tile in registers per
// thread, f32 FMAs on the SIMT units (f32 operands: the tensor cores would
// round them). K and V share one buffer, loaded in turn. Dropout costs one
// Philox call per thread and key column for four rows (kCounters) or one
// word load (kPremask).
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace repro_flash;

struct Fwd {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

template <int D>
constexpr int fwd_smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BQ * PP) * 4;
}

template <int D, int MODE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Fwd p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = qi * BQ;
  const int q_offset = p.SK - p.SQ;
  const size_t kv_base = (static_cast<size_t>(b) * p.KV + kvh) * p.SK * D;

  load_tile<D>(Qs, p.q + ((static_cast<size_t>(b) * p.H + h) * p.SQ +
                          q_start) * D, BQ);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_big();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = p.SK / BK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_start = ki * BK;
    if (!tile_runs(q_start, k_start, q_offset, p.causal, p.local_window))
      continue;  // uniform over the CTA
    __syncthreads();  // the previous tile's reads of KVs and Ps are done
    load_tile<D>(KVs, p.k + kv_base + static_cast<size_t>(k_start) * D, BK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    uint32_t nib[4];
    keep_nibbles<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, ty,
                       tx, nib);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + 4 * ty + i + q_offset;
      float mc = neg_big();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * p.scale;
        if ((p.causal || p.local_window > 0) &&
            !score_valid(q_pos, k_start + tx + 16 * j, p.causal,
                         p.local_window))
          s[i][j] = neg_big();
        mc = fmaxf(mc, s[i][j]);
      }
      mc = row_max16(mc);
      const float m_new = fmaxf(m[i], mc);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        const bool keep = (nib[j] >> i) & 1u;
        Ps[(4 * ty + i) * PP + tx + 16 * j] = keep ? e : 0.f;
      }
      rs = row_sum16(rs);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();  // Ps written; every read of K in KVs is done
    load_tile<D>(KVs, p.v + kv_base + static_cast<size_t>(k_start) * D, BK);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = acc[i][c] * alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = KVs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = l[i] == 0.f ? 1.f : l[i];
    const size_t row = (static_cast<size_t>(b) * p.H + h) * p.SQ + q_start +
                       4 * ty + i;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      p.o[row * D + tx + 16 * c] = acc[i][c] / li * p.dp.inv_keep;
    if (tx == 0) p.lse[row] = m[i] + logf(li);
  }
}

template <int D, int MODE>
int launch(const Fwd& p, cudaStream_t s) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.SQ / BQ, p.H, p.B);
  flash_fwd_kernel<D, MODE><<<grid, NT, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mode(const Fwd& p, int mode, cudaStream_t s) {
  switch (mode) {
    case kNone: return launch<D, kNone>(p, s);
    case kPremask: return launch<D, kPremask>(p, s);
    case kCounters: return launch<D, kCounters>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out, lse <- flash attention of f32 q (B,H,SQ,D), k/v (B,KV,SK,D), all
// contiguous; out and lse f32; SQ and SK multiples of 64; D in {16, 32, 64,
// 128}. mode 0 = none, 1 = premask (plane), 2 = counters (key words).
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ % BQ || SK % BK ||
      SQ <= 0 || SK <= 0 || heads_global <= 0 ||
      (mode == kPremask && plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fwd p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(out),
              static_cast<float*>(lse), B, H, KV, SQ, SK, scale, causal,
              local_window,
              Dropout{static_cast<const int32_t*>(plane), threshold, key_lo,
                      key_hi, salt, bh_offset,
                      static_cast<uint32_t>(heads_global), rounds,
                      inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_mode<16>(p, mode, s);
    case 32: return launch_mode<32>(p, mode, s);
    case 64: return launch_mode<64>(p, mode, s);
    case 128: return launch_mode<128>(p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
