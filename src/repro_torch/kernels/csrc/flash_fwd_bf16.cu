// Flash-attention forward at bf16 q/k/v on Hopper's tensor cores: out
// (B, H, SQ, D) in bf16 and the row log-sum-exp (B, H, SQ) in f32, with the
// paper's dropout modes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300) at bf16
// q/k/v, reached through flash_attention_mosaic (:388-433). The f32
// instance is csrc/flash_fwd.cu.
//
// What it computes: exactly the JAX kernel's bf16 instance, which upcasts
// the bf16 tiles to f32 (:108-110), multiplies in f32, multiplies the f32
// probabilities P by V (:155-157) and rounds O once (:289). Scores S = (q .
// k) * scale come from bf16 wgmma products -- every product of two bf16
// values is exact in f32 -- with f32 sums. The online softmax follows
// flash_fwd.cu's rules: invalid scores take neg_big() (queries at key
// positions q + SK - SQ; causal, and a local window when causal), l sums
// the undropped probabilities, l == 0 becomes 1, 1/(1-p) is applied once
// at the end, lse = m + log(l). P enters P V as the exact triple hi + mid
// + lo (flash_sm90.cuh): three bf16 products into the same f32
// accumulator are f32 P times V up to the order of the sums. Keep bits:
// premask reads the plane, replay / fused re-derive them from the Philox
// counters (flash_sm90.cuh::keep_fwd). GQA: head h reads kv head
// h / (H / KV).
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the
// products of the valid half are 69 GFLOP (0.07 ms at 989 TFLOP/s bf16),
// the exponentials and the replayed keep bits are SIMT work the tensor
// cores cannot take (the same 0.07 ms at the issue rate), the operands
// 0.1 GB. The triple doubles the tensor-core work (the PV half three
// times); chip_smoke.py's bound does not count it.
//
// The design: one warpgroup (128 threads) a CTA per (64 query rows, head,
// batch), q-blocks launched longest first. Q is loaded once by TMA; K and V
// tiles come through a two-stage TMA ring with mbarriers, the next k-block
// in flight while this one computes. S = Q K^T is an m64n64 wgmma with both
// operands K-major in shared memory; the softmax runs on the S accumulator
// in registers (a row's four lanes reduce by shuffles); P's hi, mid and lo
// are register A operands of m64nDk16 products against V, read MN-major. The
// keep bits are made while the S product runs. O stays in registers (D / 2
// floats a thread): each k-block's P V is a product of its own that one
// f32 add folds into O, as the JAX kernel folds its blocks (a product
// chained over all k-blocks inside the tensor core carries its f32
// accumulation over 384 steps: flash_sm90.cuh has what that did). O is
// rounded once to bf16 at the store. Shared
// memory: Q and two stages of K and V, 80 KB at D = 128 -- two CTAs an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

template <int D>
constexpr int fwd_smem_bytes() {
  // alignment slack, Q, two stages of K and V, three mbarriers
  return 1024 + 5 * tile_bytes<D>() + 24;
}

template <int D, int MODE>
__global__ void __launch_bounds__(WG, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          FwdArgs p) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = qs + TILE;  // stage s: K at ring + 2 s TILE, then V
  const uint32_t bar = ring + 4 * TILE;  // Q's barrier, then stage s's

  const int t = threadIdx.x, w = t / 32, l = t % 32, c = l % 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = qi * BQ;
  const int q_offset = p.SK - p.SQ;
  const int kv_row = (b * p.KV + kvh) * p.SK;

  // the k-blocks that hold a valid score: one contiguous run
  int k_first = 0, n = 0;
  for (int ki = 0; ki < p.SK / BK; ++ki)
    if (tile_runs(q_start, ki * BK, q_offset, p.causal, p.local_window)) {
      if (n == 0) k_first = ki;
      ++n;
    }

  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, TILE);
    load_tile<D>(qs, &map_q, bar, (b * p.H + h) * p.SQ + q_start);
    for (int s = 0; s < 2 && s < n; ++s) {
      const uint32_t full = bar + 8 + 8 * s;
      mbar_expect_tx(full, 2 * TILE);
      load_tile<D>(ring + 2 * s * TILE, &map_k, full,
                   kv_row + (k_first + s) * BK);
      load_tile<D>(ring + (2 * s + 1) * TILE, &map_v, full,
                   kv_row + (k_first + s) * BK);
    }
  }

  float o[D / 2];
  zero(o);
  float m[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
  mbar_wait_or_trap(bar, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const int k_start = (k_first + it) * BK;
    const uint32_t ks = ring + 2 * s * TILE, vs = ks + TILE;
    mbar_wait_or_trap(bar + 8 + 8 * s, (it >> 1) & 1);

    float sc[32];  // replaced by the first product
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(sc, desc_k<D>(qs, j), desc_k<D>(ks, j), j);
    wgmma_commit();
    uint32_t kb[2];
    keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
    wgmma_wait0();
    fence_acc(sc);

    // online softmax on the fragment: element (hh, g, e) is sc[4g+2hh+e]
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
      float mc = neg_big();
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[4 * g + 2 * hh + e] * p.scale;
          if ((p.causal || p.local_window > 0) &&
              !score_valid(q_pos, k_start + 8 * g + 2 * c + e, p.causal,
                           p.local_window))
            v = neg_big();
          sc[4 * g + 2 * hh + e] = v;
          mc = fmaxf(mc, v);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m[hh], mc);
      alpha[hh] = expf(m[hh] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ev = expf(sc[4 * g + 2 * hh + e] - m_new);
          rs += ev;
          sc[4 * g + 2 * hh + e] =
              ((kb[hh] >> (2 * g + e)) & 1u) ? ev : 0.f;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      lsum[hh] = alpha[hh] * lsum[hh] + rs;
      m[hh] = m_new;
    }

    // O = O * alpha + P V, as the JAX kernel: this k-block's P V (P = hi +
    // mid + lo) is a product of its own, then one f32 add per element
    uint32_t pa[3][4][4];
    a_frags(sc, pa);
    float pv[D / 2];  // replaced by the first product
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        wgmma_rs<D>(pv, pa[i][j], desc_mn<D>(vs, j), i + j);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(pv);
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[4 * g + i] = o[4 * g + i] * alpha[i / 2] + pv[4 * g + i];

    // every warp's products on this stage are done: refill it
    __syncthreads();
    if (t == 0 && it + 2 < n) {
      const uint32_t full = bar + 8 + 8 * s;
      mbar_expect_tx(full, 2 * TILE);
      load_tile<D>(ks, &map_k, full, kv_row + (k_start + 2 * BK));
      load_tile<D>(vs, &map_v, full, kv_row + (k_start + 2 * BK));
    }
  }

  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SQ + q_start +
                      16 * w + l / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float li = lsum[hh] == 0.f ? 1.f : lsum[hh];
    __nv_bfloat16* orow = p.o + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g + 2 * c) =
          __floats2bfloat162_rn(o[4 * g + 2 * hh] / li * p.dp.inv_keep,
                                o[4 * g + 2 * hh + 1] / li * p.dp.inv_keep);
    if (c == 0) p.lse[row0 + 8 * hh] = m[hh] + logf(li);
  }
}

template <int D, int MODE>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const FwdArgs& p, cudaStream_t s) {
  constexpr int smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel_sm90<D, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SQ / BQ, p.H, p.B), WG, smem, s>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_d(const void* q, const void* k, const void* v, const FwdArgs& p,
          int mode, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (!make_tile_map<D>(&mq, q, p.B * p.H * p.SQ) ||
      !make_tile_map<D>(&mk, k, p.B * p.KV * p.SK) ||
      !make_tile_map<D>(&mv, v, p.B * p.KV * p.SK))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kNone: return launch<D, kNone>(mq, mk, mv, p, s);
    case kPremask: return launch<D, kPremask>(mq, mk, mv, p, s);
    case kCounters: return launch<D, kCounters>(mq, mk, mv, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out, lse <- flash attention of bf16 q (B,H,SQ,D), k/v (B,KV,SK,D), all
// contiguous and on 16 bytes; out bf16, lse f32; SQ and SK multiples of 64;
// D in {16, 32, 64, 128}. The arguments of repro_flash_fwd (flash_fwd.cu):
// mode 0 = none, 1 = premask (plane), 2 = counters (key words). Launches
// on `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs p{static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                  B, H, KV, SQ, SK, scale, causal, local_window,
                  Dropout{static_cast<const int32_t*>(plane), threshold,
                          key_lo, key_hi, salt, bh_offset,
                          static_cast<uint32_t>(heads_global), rounds,
                          inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run_d<16>(q, k, v, p, mode, s);
    case 32: return run_d<32>(q, k, v, p, mode, s);
    case 64: return run_d<64>(q, k, v, p, mode, s);
    case 128: return run_d<128>(q, k, v, p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_fwd_bf16_smem_bytes(int D) {
  switch (D) {
    case 16: return fwd_smem_bytes<16>();
    case 32: return fwd_smem_bytes<32>();
    case 64: return fwd_smem_bytes<64>();
    case 128: return fwd_smem_bytes<128>();
    default: return 0;
  }
}
