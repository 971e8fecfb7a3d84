// The flash-attention forward on Hopper's tensor cores, one body for both
// operand dtypes: out (B, H, SQ, D) in q's dtype and the row log-sum-exp
// (B, H, SQ) in f32, with the paper's dropout modes. flash_fwd_bf16.cu
// instantiates it at bf16 q/k/v (Bf16Ops), flash_fwd_f32.cu at f32
// (F32Ops); each is a library of its own.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300), reached
// through flash_attention_mosaic (:388-433), at both dtypes.
//
// What it computes: the JAX kernel's rules (:126-168). A CTA of one
// warpgroup (128 threads) per 64 query rows, or of two per 128 (Ops::
// kWarpgroups), of one head and batch -- q-blocks launched longest first
// -- walks the k-blocks that hold a valid score for one of its rows
// (causal: a tile with none is skipped; a k-block with none for one
// warpgroup's rows adds exact zeros to them, or is reset by the first
// valid one's alpha = 0). Scores are (q . k) * scale; invalid ones take
// neg_big() (queries at key positions q + SK - SQ; causal, and a local
// window when causal). The online softmax runs on the S accumulator in
// registers (a row's four lanes reduce by shuffles): l sums the undropped
// probabilities, l == 0 becomes 1, 1/(1-p) is applied once at the end,
// lse = m + log(l). P enters P V as the exact triple hi + mid + lo of
// register A operands (flash_sm90.cuh), and each k-block's P V is a
// product of its own that f32 adds fold into O = O * alpha + P V, as the
// JAX kernel folds its blocks. Keep bits: premask reads the plane, replay
// / fused re-derive them from the Philox counters (keep_fwd), while the S
// product runs. GQA: head h reads kv head h / (H / KV). O stays in
// registers (D / 2 floats a thread) and is rounded once to q's dtype at
// the store. The bits do not depend on the tiling; only the order of
// float sums does.
//
// The operand policy (Ops) is what differs between the dtypes: the
// warpgroups a CTA (each taking 64 query rows of its own), where the tiles
// come from, the S = Q K^T product and the P V product.
//  - Bf16Ops: one warpgroup. Q by TMA once; K and V tiles through a
//    two-stage TMA ring with mbarriers, the next k-block in flight while
//    this one computes. S is D / 16 m64n64k16 wgmma with both operands
//    K-major in shared memory (a product of two bf16 values is exact in
//    f32); P V is the three parts of P against V, read MN-major, at the
//    full width D, then one f32 multiply-add an element. 80 KB of shared
//    memory at D = 128: two CTAs an SM. Up to D = 128 only: at D = 256 the
//    O accumulator and P V's own would take 256 registers a thread, so
//    flash_fwd_bf16.cu's kernel of its own accumulates P V into O inside
//    the tensor core, 128 query rows a CTA (flash_fwd_kernel_wide).
//  - F32Ops: both operands of both products are f32, each split into its
//    exact bf16 triple and multiplied as the six part products that reach
//    2^-16, smallest first (flash_sm90.cuh: score6, add_product6). The f32
//    tiles come by TMA into a staging tile of plain rows and all the
//    CTA's threads split them (split_tile). The splits are the kernel's
//    largest SIMT cost, so two warpgroups (128 query rows, a Q triple
//    each) share one K and one V triple: each split serves twice the rows,
//    and one warpgroup's softmax runs beside the other's products. Q is
//    split once; then each k-block's V while the S products run, and the
//    next k-block's K while P V's first column chunk runs; each staging
//    load is issued as soon as the split before it is done. O is scaled by
//    alpha, then each NC-column chunk of P V is a product of its own
//    folded in by f32 adds (the same arithmetic as the bf16 fold, with
//    --fmad=false). Shared memory: two Q triples and the K and V triples
//    (192 KB at D = 128) and one 32 KB staging tile, 230,408 bytes -- one
//    CTA an SM.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace repro_flash {
namespace fwd {

using namespace repro_flash::tc;

template <class Out>
struct FwdArgs {
  Out* o;
  float* lse;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x,
                                       float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// Where the k-blocks of a CTA's walk start: its kv rows, the first valid
// k-block and how many there are.
struct Walk {
  int kv_row, k_first, n;
  __device__ __forceinline__ int row(int it) const {
    return kv_row + (k_first + it) * BK;
  }
};

// ------------------------------------------------------------ bf16 q/k/v

template <int D>
struct Bf16Ops {
  using Out = __nv_bfloat16;
  static constexpr int kWarpgroups = 1;  // each 64 query rows of its own
  static constexpr int TILE = tile_bytes<D>();
  // alignment slack, Q, two stages of K and V, three mbarriers
  static constexpr int kSmemBytes = 1024 + 5 * TILE + 24;

  static bool make_map(CUtensorMap* map, const void* ptr, int rows) {
    return make_tile_map<D>(map, ptr, rows);
  }

  const CUtensorMap *mq, *mk, *mv;
  uint32_t qs, ring, bar;  // stage s: K at ring + 2 s TILE, then V
  Walk wk;

  __device__ __forceinline__ Bf16Ops(uint32_t base, const CUtensorMap* q,
                                     const CUtensorMap* k,
                                     const CUtensorMap* v)
      : mq(q), mk(k), mv(v), qs(base), ring(base + TILE),
        bar(base + 5 * TILE) {}  // Q's barrier, then stage s's

  // the barriers, then Q and the first two stages in flight
  __device__ __forceinline__ void start(int q_row, const Walk& w) {
    wk = w;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, TILE);
      load_tile<D>(qs, mq, bar, q_row);
      for (int s = 0; s < 2 && s < wk.n; ++s) {
        const uint32_t full = bar + 8 + 8 * s;
        mbar_expect_tx(full, 2 * TILE);
        load_tile<D>(ring + 2 * s * TILE, mk, full, wk.row(s));
        load_tile<D>(ring + (2 * s + 1) * TILE, mv, full, wk.row(s));
      }
    }
  }

  __device__ __forceinline__ void ready() const { mbar_wait_or_trap(bar, 0); }

  // S = Q K^T of k-block `it`, issued and committed
  __device__ __forceinline__ void score(float (&sc)[32], int it) const {
    const int s = it & 1;
    const uint32_t ks = ring + 2 * s * TILE;
    mbar_wait_or_trap(bar + 8 + 8 * s, (it >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(sc, desc_k<D>(qs, j), desc_k<D>(ks, j), j);
    wgmma_commit();
  }

  __device__ __forceinline__ void under_score(int) const {}

  // O = O * alpha + P V (P = hi + mid + lo) of k-block `it`, then the
  // stage refilled with k-block it + 2
  __device__ __forceinline__ void add_pv(float (&o)[D / 2],
                                         const float (&alpha)[2],
                                         const uint32_t (&pa)[3][4][4],
                                         int it) const {
    const int s = it & 1;
    const uint32_t ks = ring + 2 * s * TILE, vs = ks + TILE;
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
    if (threadIdx.x == 0 && it + 2 < wk.n) {
      const uint32_t full = bar + 8 + 8 * s;
      mbar_expect_tx(full, 2 * TILE);
      load_tile<D>(ks, mk, full, wk.row(it + 2));
      load_tile<D>(vs, mv, full, wk.row(it + 2));
    }
  }
};

// ------------------------------------------------------------- f32 q/k/v

template <int D>
struct F32Ops {
  using Out = float;
  static constexpr int kWarpgroups = 2;  // each 64 query rows of its own
  static constexpr int THREADS = kWarpgroups * WG;
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int TILE32 = tile_bytes32<D>();
  // alignment slack, a Q triple a warpgroup, the K and V triples, the f32
  // staging tile, one mbarrier
  static constexpr int kSmemBytes = 1024 + 12 * TILE + TILE32 + 8;

  static bool make_map(CUtensorMap* map, const void* ptr, int rows) {
    return make_tile_map32<D>(map, ptr, rows);
  }

  const CUtensorMap *mq, *mk, *mv;
  // the triples (hi, mid, lo TILE apart): warpgroup g's Q at qs + 3 g TILE,
  // then K and V; the staging tile st and its barrier. The loads land in
  // st in the order of the walk -- K of the next k-block, then its V --
  // so a K wait is on an even phase, a V wait on an odd one.
  uint32_t qs, ks, vs, st, bar;
  Walk wk;

  __device__ __forceinline__ F32Ops(uint32_t base, const CUtensorMap* q,
                                    const CUtensorMap* k,
                                    const CUtensorMap* v)
      : mq(q), mk(k), mv(v), qs(base), ks(base + 6 * TILE),
        vs(base + 9 * TILE), st(base + 12 * TILE), bar(st + TILE32) {}

  // one tile into st, the barrier's next phase
  __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map,
                                       int row) const {
    mbar_expect_tx(bar, TILE32);
    tma_load<false>(dst, map, bar, 0, row, 0);
  }

  // the barrier, then the CTA's two Q tiles (into st and the K triple's
  // space) and the first K (into the V triple's far end) in flight
  __device__ __forceinline__ void start(int q_row, const Walk& w) {
    wk = w;
    if (wk.n == 0) return;
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, 3 * TILE32);
      tma_load<false>(st, mq, bar, 0, q_row, 0);
      tma_load<false>(ks, mq, bar, 0, q_row + BQ, 0);
      tma_load<false>(vs + TILE, mk, bar, 0, wk.row(0), 0);
    }
  }

  // the Q and first K tiles into their triples, each source read before
  // its space is written; the first V in flight
  __device__ __forceinline__ void ready() const {
    if (wk.n == 0) return;
    mbar_wait_or_trap(bar, 0);
    split_tile<D, THREADS>(st, qs);
    split_tile<D, THREADS>(ks, qs + 3 * TILE);
    __syncthreads();
    if (threadIdx.x == 0) load(st, mv, wk.row(0));
    split_tile<D, THREADS>(vs + TILE, ks);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // S = Q K^T of k-block `it` (the six part products), issued and committed
  __device__ __forceinline__ void score(float (&sc)[32], int) const {
    wgmma_fence();
    score6<D>(sc, qs + (threadIdx.x / WG) * 3 * TILE, ks);
    wgmma_commit();
  }

  // while S runs: k-block it's V into the V triple, free since the last
  // k-block's closing barrier; then the next K in flight
  __device__ __forceinline__ void under_score(int it) const {
    mbar_wait_or_trap(bar, 1);
    split_tile<D, THREADS>(st, vs);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && it + 1 < wk.n) load(st, mk, wk.row(it + 1));
  }

  // O = O * alpha + P V (both split) of k-block `it`; while its first
  // column chunk runs, k-block it + 1's K into the K triple, once every
  // warp's S is done; then the next V in flight
  __device__ __forceinline__ void add_pv(float (&o)[D / 2],
                                         const float (&alpha)[2],
                                         const uint32_t (&pa)[3][4][4],
                                         int it) const {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = o[i] * alpha[(i / 2) % 2];
    const bool next = it + 1 < wk.n;
    add_product6<D>(o, pa, vs, [&] {
      if (!next) return;
      mbar_wait_or_trap(bar, 0);
      __syncthreads();
      split_tile<D, THREADS>(st, ks);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    });
    if (next) {
      __syncthreads();
      if (threadIdx.x == 0) load(st, mv, wk.row(it + 1));
    }
  }
};

// ------------------------------------------------------------- the body

template <int D, int MODE, class Ops>
__global__ void __launch_bounds__(WG * Ops::kWarpgroups, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     FwdArgs<typename Ops::Out> p) {
  extern __shared__ uint8_t smem_raw[];
  Ops ops((smem_u32(smem_raw) + 1023u) & ~1023u, &map_q, &map_k, &map_v);

  // warpgroup g of the CTA takes query rows q_start .. q_start + 63; the
  // last CTA's second warpgroup may lie past SQ (no rows: it takes part in
  // the loads and splits, makes no keep bits and stores nothing)
  constexpr int WGS = Ops::kWarpgroups;
  const int t = WGS == 1 ? threadIdx.x : threadIdx.x % WG;
  const int w = t / 32, l = t % 32, c = l % 4;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_cta = qi * BQ * WGS;
  const int q_start = q_cta + (WGS == 1 ? 0 : BQ * (threadIdx.x / WG));
  const bool has_rows = WGS == 1 || q_start < p.SQ;
  const int q_offset = p.SK - p.SQ;
  const int kv_row = (b * p.KV + kvh) * p.SK;

  // the k-blocks that hold a valid score for a row of the CTA: one
  // contiguous run (a warpgroup's k-block without one adds exact zeros)
  int k_first = 0, n = 0;
  for (int ki = 0; ki < p.SK / BK; ++ki) {
    bool run = false;
#pragma unroll
    for (int g = 0; g < WGS; ++g)
      run = run || tile_runs(q_cta + BQ * g, ki * BK, q_offset, p.causal,
                             p.local_window);
    if (run) {
      if (n == 0) k_first = ki;
      ++n;
    }
  }

  ops.start((b * p.H + h) * p.SQ + q_cta, Walk{kv_row, k_first, n});
  float o[D / 2];
  zero(o);
  float m[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
  ops.ready();

  for (int it = 0; it < n; ++it) {
    const int k_start = (k_first + it) * BK;
    float sc[32];  // replaced by the first product
    ops.score(sc, it);
    uint32_t kb[2] = {0u, 0u};
    if (has_rows)
      keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
    ops.under_score(it);
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

    uint32_t pa[3][4][4];
    a_frags(sc, pa);
    ops.add_pv(o, alpha, pa, it);
  }

  if (!has_rows) return;
  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SQ + q_start +
                      16 * w + l / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float li = lsum[hh] == 0.f ? 1.f : lsum[hh];
    typename Ops::Out* orow = p.o + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      store2(orow + 8 * g + 2 * c, o[4 * g + 2 * hh] / li * p.dp.inv_keep,
             o[4 * g + 2 * hh + 1] / li * p.dp.inv_keep);
    if (c == 0) p.lse[row0 + 8 * hh] = m[hh] + logf(li);
  }
}

// ------------------------------------------------------------- the host

template <int D, int MODE, template <int> class Ops>
int launch(const CUtensorMap (&maps)[3],
           const FwdArgs<typename Ops<D>::Out>& p, cudaStream_t s) {
  constexpr int smem = Ops<D>::kSmemBytes;
  constexpr int WGS = Ops<D>::kWarpgroups;
  auto kernel = flash_fwd_kernel<D, MODE, Ops<D>>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.SQ / BQ + WGS - 1) / WGS, p.H, p.B), WG * WGS, smem,
           s>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, template <int> class Ops>
int run_d(const void* q, const void* k, const void* v,
          const FwdArgs<typename Ops<D>::Out>& p, int mode, cudaStream_t s) {
  CUtensorMap maps[3];
  if (!Ops<D>::make_map(&maps[0], q, p.B * p.H * p.SQ) ||
      !Ops<D>::make_map(&maps[1], k, p.B * p.KV * p.SK) ||
      !Ops<D>::make_map(&maps[2], v, p.B * p.KV * p.SK))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kNone: return launch<D, kNone, Ops>(maps, p, s);
    case kPremask: return launch<D, kPremask, Ops>(maps, p, s);
    case kCounters: return launch<D, kCounters, Ops>(maps, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out, lse <- flash attention of q (B,H,SQ,D), k/v (B,KV,SK,D) in the
// policy's dtype, all contiguous and on 16 bytes; out in that dtype, lse
// f32; SQ and SK multiples of 64; D in {16, 32, 64, 128} (the D = 256
// kernels are their libraries' own). mode 0 = none,
// 1 = premask (plane (B,H,SQ/32,SK) int32), 2 = counters (the Philox key
// words: replay and fused). Launches on `stream`; returns the CUDA error
// code (0 on success), cudaErrorInvalidValue for what it does not take or
// a tensor map that cuTensorMapEncodeTiled refuses.
template <template <int> class Ops>
int run(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, int H, int KV, int SQ, int SK, int D, float scale, int causal,
        int local_window, int mode, const void* plane, uint32_t threshold,
        float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
        uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  using Out = typename Ops<16>::Out;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs<Out> p{static_cast<Out*>(out), static_cast<float*>(lse),
                       B, H, KV, SQ, SK, scale, causal, local_window,
                       Dropout{static_cast<const int32_t*>(plane), threshold,
                               key_lo, key_hi, salt, bh_offset,
                               static_cast<uint32_t>(heads_global), rounds,
                               inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run_d<16, Ops>(q, k, v, p, mode, s);
    case 32: return run_d<32, Ops>(q, k, v, p, mode, s);
    case 64: return run_d<64, Ops>(q, k, v, p, mode, s);
    case 128: return run_d<128, Ops>(q, k, v, p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
template <template <int> class Ops>
int smem_bytes(int D) {
  switch (D) {
    case 16: return Ops<16>::kSmemBytes;
    case 32: return Ops<32>::kSmemBytes;
    case 64: return Ops<64>::kSmemBytes;
    case 128: return Ops<128>::kSmemBytes;
    default: return 0;
  }
}

}  // namespace fwd
}  // namespace repro_flash
