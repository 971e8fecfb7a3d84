// Flash-attention dq at f32 q/k/v/dO on Hopper's tensor cores, with the
// paper's dropout modes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// _dq_kernel (flash_attention_bwd.py:77, pl.pallas_call at :266) at f32.
// The bf16 instance is csrc/flash_dq_bf16.cu; dk / dv at f32 are
// csrc/flash_dkv_f32.cu.
//
// What it computes (flash_attention_bwd.py:10-15). With keep mask K, P =
// exp(S * scale - lse) recomputed from the forward's lse (invalid scores
// masked to neg_big() as in the forward) and Delta = rowsum(dO o O) from
// the caller (torch, as JAX computes it outside its kernels):
//     dP = K / (1-p) o (dO V^T),   dS = P o (dP - Delta),
//     dq = sum over k-blocks of (dS * scale) K.
// Every product has f32 operands on both sides. Each is the sum of the
// six bf16 part products of the operands' exact triples that reach 2^-16
// (flash_sm90.cuh), with f32 sums: the f32 product up to about 2^-23 of
// sum |a||b| and the order of the sums. Each element of dq is written by
// one thread, no atomics: a training step stays bitwise reproducible.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the three
// products of the valid half are 103 GFLOP; six bf16 products apiece are
// 0.63 ms at 989 TFLOP/s (1.54 ms at the f32 SIMT rate of 67 TFLOP/s);
// the exponentials and the replayed keep bits are SIMT work the tensor
// cores cannot take (0.07 ms at the issue rate), and so are the splits
// (about 12 instructions a pair of values); the operands and dq 0.34 GB
// (0.10 ms at 3.35 TB/s).
//
// The design is flash_dq_bf16.cu's with every operand tile split: one
// warpgroup (128 threads) a CTA per (64 query rows, head, batch), q-blocks
// launched longest first, walking the k-blocks that hold a valid score.
// The f32 tiles come by TMA into one staging tile (plain rows) and the
// threads split them into bf16 triples (split_tile) in the swizzled layout
// the products read: Q and dO once, then each k-block's K and V. S = Q K^T
// and dP = dO V^T are the six part products each, both sides K-major in
// shared memory, committed apart: the keep bits are made under both, P's
// exponentials under dP. Once dP is done the V triple is free, and the
// next k-block's V (its TMA issued a k-block earlier) is split into it;
// K's TMA then fills the stage while dS K runs, and is split once dS K is
// done. dS * scale replaces dP in the accumulator registers and its three
// parts become the register A operands of dS K (K's triple read MN-major,
// the transpose bit); each k-block's dS K is a product of its own (64
// columns at a time at D = 128), folded into dq by f32 adds as the JAX
// kernel folds its blocks. Shared memory: the Q, dO, K and V triples (192
// KB at D = 128) and the f32 staging tile (32 KB), 225 KB -- one CTA an
// SM, as the SIMT kernel it replaces.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_f32_wide.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

struct DqArgs {
  const float* lse;
  const float* delta;
  float* dq;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

template <int D>
constexpr int dq_smem_bytes() {
  // alignment slack, the Q, dO, K and V triples, the f32 staging tile, two
  // mbarriers
  return 1024 + 12 * tile_bytes<D>() + tile_bytes32<D>() + 16;
}

template <int D, int MODE>
__global__ void __launch_bounds__(WG, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, DqArgs p) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int TILE32 = tile_bytes32<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + 3 * TILE;  // each triple hi, mid, lo
  const uint32_t ks = dos + 3 * TILE;
  const uint32_t vs = ks + 3 * TILE;
  const uint32_t stage = vs + 3 * TILE;
  const uint32_t bar = stage + TILE32;  // the first loads', then the stage's

  const int t = threadIdx.x, w = t / 32, l = t % 32, c = l % 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = qi * BQ;
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ + q_start;
  const int kv_row = (b * p.KV + kvh) * p.SK;

  // the k-blocks that hold a valid score: one contiguous run
  int k_first = 0, n = 0;
  for (int ki = 0; ki < p.SK / BK; ++ki)
    if (tile_runs(q_start, ki * BK, q_offset, p.causal, p.local_window)) {
      if (n == 0) k_first = ki;
      ++n;
    }

  // this thread's rows: q_start + 16 w + l / 4 + 8 hh
  const size_t row0 = static_cast<size_t>(q_row) + 16 * w + l / 4;
  float dq[D / 2];
  zero(dq);
  if (n > 0) {
    if (t == 0) {
      for (int i = 0; i < 2; ++i) mbar_init(bar + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t br,
                    int row) { tma_load<false>(dst, map, br, 0, row, 0); };
    // Q into the stage, dO into the K triple's space and the first K into
    // the V triple's far end: split into their triples in turn, each
    // source read before its space is written
    if (t == 0) {
      mbar_expect_tx(bar, 3 * TILE32);
      load(stage, &map_q, bar, q_row);
      load(ks, &map_do, bar, q_row);
      load(ks + 4 * TILE, &map_k, bar, kv_row + k_first * BK);
    }
    float lse[2], delta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lse[hh] = p.lse[row0 + 8 * hh];
      delta[hh] = p.delta[row0 + 8 * hh];
    }
    mbar_wait_or_trap(bar, 0);
    split_tile<D>(stage, qs);
    split_tile<D>(ks, dos);
    __syncthreads();
    uint32_t ph = 0;  // completed phases of the stage's barrier
    if (t == 0) {
      mbar_expect_tx(bar + 8, TILE32);
      load(stage, &map_v, bar + 8, kv_row + k_first * BK);
    }
    split_tile<D>(ks + 4 * TILE, ks);
    mbar_wait_or_trap(bar + 8, ph++ & 1);
    __syncthreads();
    split_tile<D>(stage, vs);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t == 0 && n > 1) {
      mbar_expect_tx(bar + 8, TILE32);
      load(stage, &map_v, bar + 8, kv_row + (k_first + 1) * BK);
    }

    for (int it = 0; it < n; ++it) {
      const int k_start = (k_first + it) * BK;
      // S = Q K^T, then dP = dO V^T, committed apart (rows are queries,
      // columns keys): the keep bits are made under both products, P's
      // exponentials under the dP product
      float sc[32], dp[32];  // replaced by their first products
      wgmma_fence();
      score6<D>(sc, qs, ks);
      wgmma_commit();
      score6<D>(dp, dos, vs);
      wgmma_commit();
      uint32_t kb[2];
      keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
      wgmma_wait1();
      fence_acc(sc);

      // element i = 4 g + 2 hh + e: query q_start + 16w + l/4 + 8hh, key
      // k_start + 8g + 2c + e; sc becomes P, then dp becomes dS * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
        float v = sc[i] * p.scale;
        if ((p.causal || p.local_window > 0) &&
            !score_valid(q_pos, k_start + 8 * g + 2 * c + e, p.causal,
                         p.local_window))
          v = neg_big();
        sc[i] = expf(v - lse[hh]);
      }
      wgmma_wait0();
      fence_acc(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        float gd = dp[i];
        if (MODE != kNone)
          gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
        dp[i] = sc[i] * (gd - delta[hh]) * p.scale;
      }

      // every warp's dP products are done: the next k-block's V into the
      // free V triple, then its K into the stage while dS K runs
      const bool next = it + 1 < n;
      if (next) {
        mbar_wait_or_trap(bar + 8, ph++ & 1);
        __syncthreads();
        split_tile<D>(stage, vs);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (t == 0) {
          mbar_expect_tx(bar + 8, TILE32);
          load(stage, &map_k, bar + 8, kv_row + k_start + BK);
        }
      }

      // dq += dS K, both sides as triples: this k-block's product is one
      // of its own, folded into dq by f32 adds
      uint32_t a[3][4][4];
      a_frags(dp, a);
      add_product6<D>(dq, a, ks);

      // every warp's dS K products are done: the next K into its triple,
      // then the V after it into the stage
      if (next) {
        mbar_wait_or_trap(bar + 8, ph++ & 1);
        __syncthreads();
        split_tile<D>(stage, ks);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (t == 0 && it + 2 < n) {
          mbar_expect_tx(bar + 8, TILE32);
          load(stage, &map_v, bar + 8, kv_row + k_start + 2 * BK);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = p.dq + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<float2*>(row + 8 * g + 2 * c) =
          make_float2(dq[4 * g + 2 * hh], dq[4 * g + 2 * hh + 1]);
  }
}

template <int D, int MODE>
int launch(const CUtensorMap (&maps)[4], const DqArgs& p, cudaStream_t s) {
  constexpr int smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<D, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SQ / BQ, p.H, p.B), WG, smem, s>>>(maps[0], maps[1],
                                                     maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_d(const void* q, const void* k, const void* v, const void* dout,
          const DqArgs& p, int mode, cudaStream_t s) {
  CUtensorMap maps[4];
  if (!make_tile_map32<D>(&maps[0], q, p.B * p.H * p.SQ) ||
      !make_tile_map32<D>(&maps[1], k, p.B * p.KV * p.SK) ||
      !make_tile_map32<D>(&maps[2], v, p.B * p.KV * p.SK) ||
      !make_tile_map32<D>(&maps[3], dout, p.B * p.H * p.SQ))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kNone: return launch<D, kNone>(maps, p, s);
    case kPremask: return launch<D, kPremask>(maps, p, s);
    case kCounters: return launch<D, kCounters>(maps, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The D = 256 instance (flash_f32_wide.cuh): two warpgroups on the same 64
// query rows, each both score products in full and dS K and dq over one
// 128-column half of K. Q and dO are split once into their triples; each
// k-block's K and V come as 32-column slices, twelve steps of two: S =
// Q K^T over K's slices, dP = dO V^T over V's (four steps each, the part
// products chained over D), then dq += dS K over the half's slices of K
// (four steps, each warpgroup one slice a step, each folded into dq by
// f32 adds). The keep bits are made under S's first step. Shared memory: the
// Q and dO triples (192 KB) and two slice triples (24 KB), 222,208 bytes
// -- one CTA an SM. A kernel of its own, so that the instances above keep
// their machine code. It keeps this first design (both warpgroups run the
// score products, the fills one after another with the products) on
// Stream, scores and add_half until it is split like the forward and dkv
// (flash_wide_map.cuh): its machine code is unchanged by them.
template <int D, int MODE>
__global__ void __launch_bounds__(wide::THREADS, 1)
    flash_dq_kernel_wide(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout, DqArgs p) {
  static_assert(D == wide::D, "the wide instance is the D = 256 one");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + 3 * wide::TILE;  // each triple hi, mid, lo
  const uint32_t buf = dos + 3 * wide::TILE;  // two slice triples

  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_start = qi * BQ;
  const int q_offset = p.SK - p.SQ;
  const size_t q_row = static_cast<size_t>(b * p.H + h) * p.SQ + q_start;
  const size_t kv_row = static_cast<size_t>(b * p.KV + kvh) * p.SK;

  // the k-blocks that hold a valid score: one contiguous run
  int k_first = 0, n = 0;
  for (int ki = 0; ki < p.SK / BK; ++ki)
    if (tile_runs(q_start, ki * BK, q_offset, p.causal, p.local_window)) {
      if (n == 0) k_first = ki;
      ++n;
    }

  // this thread's rows: q_start + 16 w + l / 4 + 8 hh; its warpgroup's
  // half of dq
  const size_t row0 = q_row + 16 * w + l / 4;
  float dq[wide::HALF / 2];
  zero(dq);
  if (n > 0) {
    float lse[2], delta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lse[hh] = p.lse[row0 + 8 * hh];
      delta[hh] = p.delta[row0 + 8 * hh];
    }
    // step j of k-block j / 12: S over K (0-3), dP over V (4-7), dq over
    // the halves of K (8-11)
    auto sl = wide::stream(
        [&](int j) {
          const int it = j / 12, r = j % 12;
          const float* rows =
              (r / 4 == 1 ? v : k) +
              (kv_row + static_cast<size_t>(k_first + it) * BK) * wide::D;
          return r < 8 ? wide::score_pair(rows, r % 4)
                       : wide::half_pair(rows, r % 4);
        });
    wide::split_rows(q + q_row * wide::D, qs);
    wide::split_rows(dout + q_row * wide::D, dos);

    for (int it = 0; it < n; ++it) {
      const int k_start = (k_first + it) * BK;
      // S = Q K^T, then dP = dO V^T (rows are queries, columns keys); the
      // keep bits made under S's first step
      float sc[32], dp[32];
      uint32_t kb[2];
      wide::scores(sc, sl, qs, buf, [&] {
        keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
      });
      wide::scores(dp, sl, dos, buf);

      // element i = 4 g + 2 hh + e: query q_start + 16w + l/4 + 8hh, key
      // k_start + 8g + 2c + e; sc becomes P, then dp becomes dS * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
        float x = sc[i] * p.scale;
        if ((p.causal || p.local_window > 0) &&
            !score_valid(q_pos, k_start + 8 * g + 2 * c + e, p.causal,
                         p.local_window))
          x = neg_big();
        const float pr = expf(x - lse[hh]);
        float gd = dp[i];
        if (MODE != kNone)
          gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
        dp[i] = pr * (gd - delta[hh]) * p.scale;
      }

      // dq += dS K over this warpgroup's half, both sides as triples
      uint32_t a[3][4][4];
      a_frags(dp, a);
      wide::add_half(dq, sl, a, buf);
    }
  }
  wide::store_half(p.dq + q_row * wide::D, dq);
}

// alignment slack, the Q and dO triples, two slice triples
constexpr int kWideSmemBytes = 1024 + 6 * wide::TILE + 2 * wide::SLICE3;

int launch_wide(const void* q, const void* k, const void* v,
                const void* dout, const DqArgs& p, int mode, cudaStream_t s) {
  constexpr int D = wide::D;
  if (mode != kNone && mode != kPremask && mode != kCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mode == kNone      ? flash_dq_kernel_wide<D, kNone>
                      : mode == kPremask ? flash_dq_kernel_wide<D, kPremask>
                                         : flash_dq_kernel_wide<D, kCounters>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SQ / BQ, p.H, p.B), wide::THREADS, kWideSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (B,H,SQ,D) f32 from f32 q (B,H,SQ,D), k/v (B,KV,SK,D), dout
// (B,H,SQ,D), lse and delta (B,H,SQ), all contiguous and on 16 bytes; SQ
// and SK multiples of 64; D in {16, 32, 64, 128, 256}; mode 0 none, 1 premask
// (plane (B,H,SQ/32,SK) int32), 2 counters (the Philox key words; replay
// and fused). dk and dv are not written (repro_flash_dkv,
// flash_dkv_f32.cu, takes the same arguments). Launches on `stream`;
// returns the CUDA error code (0 on success), cudaErrorInvalidValue for
// what it does not take or a tensor map that cuTensorMapEncodeTiled
// refuses.
extern "C" int repro_flash_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  (void)dk;
  (void)dv;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta), static_cast<float*>(dq),
                 B, H, KV, SQ, SK, scale, causal, local_window,
                 Dropout{static_cast<const int32_t*>(plane), threshold,
                         key_lo, key_hi, salt, bh_offset,
                         static_cast<uint32_t>(heads_global), rounds,
                         inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run_d<16>(q, k, v, dout, p, mode, s);
    case 32: return run_d<32>(q, k, v, dout, p, mode, s);
    case 64: return run_d<64>(q, k, v, dout, p, mode, s);
    case 128: return run_d<128>(q, k, v, dout, p, mode, s);
    case 256: return launch_wide(q, k, v, dout, p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_dq_smem_bytes(int D) {
  switch (D) {
    case 16: return dq_smem_bytes<16>();
    case 32: return dq_smem_bytes<32>();
    case 64: return dq_smem_bytes<64>();
    case 128: return dq_smem_bytes<128>();
    case 256: return kWideSmemBytes;
    default: return 0;
  }
}
