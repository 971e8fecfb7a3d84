// Flash-attention dq at bf16 q/k/v/dO on Hopper's tensor cores, with the
// paper's dropout modes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// _dq_kernel (flash_attention_bwd.py:77, pl.pallas_call at :266) at bf16.
// The f32 instance is csrc/flash_dq_f32.cu; dk / dv at bf16 are
// csrc/flash_dkv_bf16.cu.
//
// What it computes: exactly the JAX kernel's bf16 instance, which upcasts
// the bf16 tiles to f32 (:107-112), multiplies the f32 ds by k (:127-130)
// and rounds dq once (:300-311). With keep mask K, P = exp(S * scale -
// lse) recomputed from the forward's lse (invalid scores masked to
// neg_big() as in the forward) and Delta from the caller:
//     dP = K / (1-p) o (dO V^T),   dS = P o (dP - Delta),
//     dq = sum over k-blocks of (dS * scale) K,
// dS scaled before its product as flash_dq_f32.cu and flash_dkv_bf16.cu
// scale it. S = Q K^T and dP = dO V^T are bf16 wgmma products (exact products,
// f32 sums); dS * scale enters its product as the exact triple hi + mid +
// lo (flash_sm90.cuh), so that product is the f32-operand product up to
// the order of the sums. Each element of dq is written by one thread, no
// atomics: a training step stays bitwise reproducible.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the three
// products of the valid half are 103 GFLOP (0.10 ms at 989 TFLOP/s bf16);
// the exponentials and the replayed keep bits are SIMT work the tensor
// cores cannot take (0.07 ms at the issue rate); the operands 0.1 GB. The
// triple makes the tensor-core work 5/3 of that (dS K three times);
// chip_smoke.py's bound does not count it.
//
// The design is the forward's (flash_fwd_bf16.cu) with one more score
// product and no online softmax: one warpgroup (128 threads) a CTA per (64
// query rows, head, batch), q-blocks launched longest first, walking the
// k-blocks that hold a valid score. Q and dO are loaded once by TMA, the
// rows' lse and Delta once into registers; K and V tiles come through a
// two-stage TMA ring with mbarriers, the next k-block in flight while this
// one computes. S = Q K^T and dP = dO V^T are m64n64 wgmma with all
// operands K-major in shared memory, committed apart: the keep bits are
// made while both run (flash_sm90.cuh::keep_fwd: the fragment's rows are
// queries, its columns keys) and P's exponentials while dP runs (one
// commit for both was 0.11 ms slower at the shape above, replay). dS *
// scale replaces dP in the accumulator registers and its three parts
// become the register A operands of dS K (m64nDk16, K read MN-major
// through the transpose bit). dq stays in registers (D / 2 floats a
// thread); each k-block's dS K is a product of its own (64 columns at a
// time at D = 128), folded into dq by f32 adds as the JAX kernel folds its
// blocks (chained over all blocks inside the tensor core, or with a pair
// hi + lo, the sums moved 0.2 % of the bf16 roundings: flash_sm90.cuh).
// Its products add the lo parts of every slice first, then mid, then hi:
// against the plain version that order rounded 0.0577 % of dq's bf16
// values apart at the shape above (replay), the slice-by-slice order
// 0.0615 %, and fewer at every shape and mode measured.
// dq is rounded once to bf16 at the store. Shared memory: Q, dO and two
// stages of K and V, 99 KB at D = 128 -- two CTAs an SM.
//
// At D = 256 (recurrentgemma's LOCAL layer) dq alone takes 128 registers a
// thread: flash_dq_kernel_wide below, a kernel of its own, so the instances
// above keep their machine code.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"
#include "flash_wide_map.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

struct DqArgs {
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

template <int D>
constexpr int dq_smem_bytes() {
  // alignment slack, Q, dO, two stages of K and V, three mbarriers
  return 1024 + 6 * tile_bytes<D>() + 24;
}

template <int D, int MODE>
__global__ void __launch_bounds__(WG, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, DqArgs p) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + TILE;
  const uint32_t ring = dos + TILE;  // stage s: K at ring + 2 s TILE, then V
  const uint32_t bar = ring + 4 * TILE;  // Q / dO's barrier, then stage s's

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

  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 2 * TILE);
    load_tile<D>(qs, &map_q, bar, q_row);
    load_tile<D>(dos, &map_do, bar, q_row);
    for (int s = 0; s < 2 && s < n; ++s) {
      const uint32_t full = bar + 8 + 8 * s;
      mbar_expect_tx(full, 2 * TILE);
      load_tile<D>(ring + 2 * s * TILE, &map_k, full,
                   kv_row + (k_first + s) * BK);
      load_tile<D>(ring + (2 * s + 1) * TILE, &map_v, full,
                   kv_row + (k_first + s) * BK);
    }
  }

  // this thread's rows: q_start + 16 w + l / 4 + 8 hh
  const size_t row0 = static_cast<size_t>(q_row) + 16 * w + l / 4;
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse[hh] = p.lse[row0 + 8 * hh];
    delta[hh] = p.delta[row0 + 8 * hh];
  }
  float dq[D / 2];
  zero(dq);
  mbar_wait_or_trap(bar, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const int k_start = (k_first + it) * BK;
    const uint32_t ks = ring + 2 * s * TILE, vs = ks + TILE;
    mbar_wait_or_trap(bar + 8 + 8 * s, (it >> 1) & 1);

    // S = Q K^T, then dP = dO V^T, committed apart (rows are queries,
    // columns keys): the keep bits are made under both products, P's
    // exponentials under the dP product
    float sc[32], dp[32];  // replaced by their first products
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(sc, desc_k<D>(qs, j), desc_k<D>(ks, j), j);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(dp, desc_k<D>(dos, j), desc_k<D>(vs, j), j);
    wgmma_commit();
    uint32_t kb[2];
    keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
    wgmma_wait1();
    fence_acc(sc);

    // element (hh, g, e): query q_start + 16w + l/4 + 8hh, key k_start +
    // 8g + 2c + e; sc becomes P, then dp becomes dS * scale
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * g + 2 * hh + e;
          float v = sc[i] * p.scale;
          if ((p.causal || p.local_window > 0) &&
              !score_valid(q_pos, k_start + 8 * g + 2 * c + e, p.causal,
                           p.local_window))
            v = neg_big();
          sc[i] = expf(v - lse[hh]);
        }
    }
    wgmma_wait0();
    fence_acc(dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * g + 2 * hh + e;
          float gd = dp[i];
          if (MODE != kNone)
            gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
          dp[i] = sc[i] * (gd - delta[hh]) * p.scale;
        }

    // dq += dS K with dS as hi + mid + lo, the smallest parts first: this
    // k-block's product is one of its own, folded into dq by f32 adds
    uint32_t a[3][4][4];
    a_frags(dp, a);
    add_product<D, true>(dq, a, ks);

    // every warp's products on this stage are done: refill it
    __syncthreads();
    if (t == 0 && it + 2 < n) {
      const uint32_t full = bar + 8 + 8 * s;
      mbar_expect_tx(full, 2 * TILE);
      load_tile<D>(ks, &map_k, full, kv_row + k_start + 2 * BK);
      load_tile<D>(vs, &map_v, full, kv_row + k_start + 2 * BK);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* row = p.dq + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dq[4 * g + 2 * hh], dq[4 * g + 2 * hh + 1]);
  }
}

// ------------------------------------------------- the D = 256 instance
//
// The shape of the bf16 forward's (flash_fwd_bf16.cu): 128 query rows a
// CTA of three warpgroups. Warpgroup 0 is the producer: its thread 0
// loads both consumers' Q and dO tiles once and walks each k-block's V,
// then its K, through a ring of three tile slots (TMA, full and empty
// mbarriers; flash_wide_map.cuh: dq_bf16_tile), and it gives its
// registers to the consumers (setmaxnreg: 24 a thread left, 240 for the
// consumers). Warpgroups 1 and 2 are the consumers, 64 query rows each
// over the full D = 256 (fwd_bf16_q_start), both reading every K and V
// tile: S = Q K^T and dP = dO V^T are run once for each row, and each K
// and V byte in shared memory serves 128 rows. A consumer issues S and dP
// of a k-block together, committed apart, makes P's exponentials under
// dP and dS * scale once dP is done (the keep bits of its own rows,
// made once, under its dq product before), splits dS into its triple and
// releases V; then issues dq += dS K (m64n256k16, dS's parts as register
// A operands, K read MN-major) into dq, one m64n256 accumulator (128
// registers a thread) inside the tensor core, smallest parts first, makes
// the next k-block's keep bits under it and releases K once it is done.
// The two consumers take turns at issuing (named barriers 1 and 2: a
// ping-pong), so one's exponentials, dS and keep bits run under the
// other's products. Where SQ % 128 == 64 the last CTA's second consumer
// has no rows and stays out of the walk, the turns and the releases.
// Shared memory: Q and dO of both consumers (128 KB), three tile slots
// (96 KB), seven mbarriers: 230,456 bytes -- one CTA an SM. What bounds
// it: at recurrentgemma's LOCAL layer (1 x 16 x 4096 x 256, one kv head,
// window 2048) its three products take 0.156 ms at the bf16 tensor rate
// (dS K three times over with the triple); on the H100 the output
// products run at 1.5-1.8x their clocks, slowed by the consumers' SIMT
// work beside them (scripts/probe_wgmma_rate.py, PERF.md).
constexpr int WIDE_D = 256;
constexpr int WIDE_TILE = tile_bytes<WIDE_D>();
constexpr int WIDE_THREADS = 3 * WG;
// registers a thread after setmaxnreg (the launch's 168 x 384 in all)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: consumer cw's turn to issue products is barrier 1 + cw
constexpr int kTurnBarrier = 1;
constexpr int kSlots = repro_flash::wide_map::DQ_BF16_SLOTS;
// alignment slack, Q and dO of both consumers, the slots, Q and dO's
// mbarrier and the slots' full and empty ones
constexpr int kWideSmemBytes =
    1024 + (4 + kSlots) * WIDE_TILE + (1 + 2 * kSlots) * 8;

template <int D, int MODE>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_dq_kernel_wide(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         DqArgs p) {
  static_assert(D == WIDE_D, "the wide instance is the D = 256 one");
  namespace map = repro_flash::wide_map;
  constexpr int TILE = WIDE_TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q of cw
  const uint32_t dos = qs + 2 * TILE;   // dO of consumer cw
  const uint32_t slots = dos + 2 * TILE;  // slot i at slots + i TILE
  // Q and dO's barrier; then the slots' full and empty ones
  const uint32_t qd_full = slots + kSlots * TILE;
  const uint32_t full = qd_full + 8, empty = full + 8 * kSlots;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ;
  const int kv_row = (b * p.KV + kvh) * p.SK;
  // consumers with rows: 1, or 2
  const int groups = map::fwd_bf16_has_rows(qi, 1, p.SQ) ? 2 : 1;
  const map::Run run =
      map::dq_bf16_k_run(qi, p.SQ, p.SK, p.causal, p.local_window);
  const int k_first = run.first, n = run.n;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + 8 * i, 1);
      // a slot goes back once every consumer warp is done with it
      mbar_init(empty + 8 * i, groups * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(qd_full, 2 * groups * TILE);
      for (int cw = 0; cw < groups; ++cw) {
        const int row = q_row + map::fwd_bf16_q_start(qi, cw);
        load_tile<D>(qs + cw * TILE, &map_q, qd_full, row);
        load_tile<D>(dos + cw * TILE, &map_do, qd_full, row);
      }
      for (int tile = 0; tile < 2 * n; ++tile) {
        const int slot = map::dq_bf16_slot(tile);
        const bool k = tile & 1;
        // the slot held tile - kSlots: the same phase of its empty barrier
        if (tile >= kSlots)
          mbar_wait_spin(empty + 8 * slot,
                         map::dq_bf16_parity(tile - kSlots));
        mbar_expect_tx(full + 8 * slot, TILE);
        load_tile<D>(slots + slot * TILE, k ? &map_k : &map_v,
                     full + 8 * slot, kv_row + (k_first + tile / 2) * BK);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  if (cw >= groups) return;  // past SQ: no rows
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int q_start = map::fwd_bf16_q_start(qi, cw);
  const uint32_t qa = qs + cw * TILE, da = dos + cw * TILE;
  // the turns: consumer 0 issues first; each waits for its turn before
  // issuing and hands it over after (consumer 1 not after its last: the
  // other issues no more)
  const bool pingpong = groups == 2;
  const int mine = kTurnBarrier + cw, other = kTurnBarrier + 1 - cw;

  // this thread's rows: q_start + 16 w + l / 4 + 8 hh
  const size_t row0 = static_cast<size_t>(q_row) + q_start + 16 * w + l / 4;
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse[hh] = p.lse[row0 + 8 * hh];
    delta[hh] = p.delta[row0 + 8 * hh];
  }
  float dq[D / 2];
  zero(dq);

  if (n > 0) {
    mbar_wait_spin(qd_full, 0);
    if (pingpong && cw == 1) named_arrive(other, 2 * WG);
    uint32_t kb[2];
    keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_first * BK, kb);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const int k_start = (k_first + j) * BK;
      const int kt = map::dq_bf16_tile(j, true), vt = map::dq_bf16_tile(j, false);
      const uint32_t ks = slots + map::dq_bf16_slot(kt) * TILE;
      const uint32_t vs = slots + map::dq_bf16_slot(vt) * TILE;

      // S = Q K^T, then dP = dO V^T (rows are queries, columns keys),
      // committed apart
      float sc[32], dp[32];  // replaced by their first products
      if (pingpong) named_sync(mine, 2 * WG);
      wgmma_fence();
      mbar_wait_spin(full + 8 * map::dq_bf16_slot(kt), map::dq_bf16_parity(kt));
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        wgmma_ss_n64(sc, desc_k<D>(qa, jj), desc_k<D>(ks, jj), jj);
      wgmma_commit();
      mbar_wait_spin(full + 8 * map::dq_bf16_slot(vt), map::dq_bf16_parity(vt));
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        wgmma_ss_n64(dp, desc_k<D>(da, jj), desc_k<D>(vs, jj), jj);
      wgmma_commit();
      if (pingpong) named_arrive(other, 2 * WG);

      // element (hh, g, e): query q_start + 16w + l/4 + 8hh, key k_start +
      // 8g + 2c + e; sc becomes P under dP, then dp becomes dS * scale
      const bool whole = map::tile_full(q_start, k_start, q_offset, p.causal,
                                        p.local_window);
      wgmma_wait1();
      fence_acc(sc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * g + 2 * hh + e;
            float v = sc[i] * p.scale;
            if (!whole && !score_valid(q_pos, k_start + 8 * g + 2 * c + e,
                                       p.causal, p.local_window))
              v = neg_big();
            sc[i] = expf(v - lse[hh]);
          }
      }
      wgmma_wait0();
      fence_acc(dp);
      if (l == 0) mbar_arrive(empty + 8 * map::dq_bf16_slot(vt));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int g = 0; g < 8; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * g + 2 * hh + e;
            float gd = dp[i];
            if (MODE != kNone)
              gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
            dp[i] = sc[i] * (gd - delta[hh]) * p.scale;
          }
      uint32_t a[3][4][4];
      a_frags(dp, a);

      // dq += dS K: lo of every k16 slice, then mid, then hi, into dq
      // inside the tensor core (K MN-major, m64n256k16)
      if (pingpong) named_sync(mine, 2 * WG);
      wgmma_fence();
#pragma unroll
      for (int i = 2; i >= 0; --i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          wgmma_rs<D>(dq, a[i][jj], desc_mn<D>(ks, jj), 1);
      wgmma_commit();
      if (pingpong && (cw == 0 || j + 1 < n)) named_arrive(other, 2 * WG);
      // the next k-block's keep bits under dq (the premask loads not sunk
      // below the products)
      if (j + 1 < n) {
        keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start + BK,
                       kb);
        asm volatile("" : "+r"(kb[0]), "+r"(kb[1]));
      }
      wgmma_wait0();
      fence_acc(dq);
      hold(a);
      if (l == 0) mbar_arrive(empty + 8 * map::dq_bf16_slot(kt));
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* row = p.dq + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dq[4 * g + 2 * hh], dq[4 * g + 2 * hh + 1]);
  }
}

template <int D, int MODE>
int launch(const CUtensorMap (&maps)[4], const DqArgs& p, cudaStream_t s) {
  // only the kernel this D runs is instantiated
  constexpr bool wide = D == WIDE_D;
  constexpr int smem = wide ? kWideSmemBytes : dq_smem_bytes<D>();
  const auto kernel = [] {
    if constexpr (wide)
      return flash_dq_kernel_wide<D, MODE>;
    else
      return flash_dq_kernel<D, MODE>;
  }();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(wide ? repro_flash::wide_map::fwd_bf16_ctas(p.SQ)
                       : p.SQ / BQ,
                  p.H, p.B);
  kernel<<<grid, wide ? WIDE_THREADS : WG, smem, s>>>(maps[0], maps[1],
                                                       maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_d(const void* q, const void* k, const void* v, const void* dout,
          const DqArgs& p, int mode, cudaStream_t s) {
  CUtensorMap maps[4];
  if (!make_tile_map<D>(&maps[0], q, p.B * p.H * p.SQ) ||
      !make_tile_map<D>(&maps[1], k, p.B * p.KV * p.SK) ||
      !make_tile_map<D>(&maps[2], v, p.B * p.KV * p.SK) ||
      !make_tile_map<D>(&maps[3], dout, p.B * p.H * p.SQ))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kNone: return launch<D, kNone>(maps, p, s);
    case kPremask: return launch<D, kPremask>(maps, p, s);
    case kCounters: return launch<D, kCounters>(maps, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq (B,H,SQ,D) bf16 from bf16 q (B,H,SQ,D), k/v (B,KV,SK,D), dout
// (B,H,SQ,D) and f32 lse, delta (B,H,SQ), all contiguous and on 16 bytes;
// SQ and SK multiples of 64; D in {16, 32, 64, 128, 256}. The arguments
// of repro_flash_dq (flash_dq_f32.cu); dk and dv are not written. Launches on
// `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_dq_bf16(
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
                 static_cast<const float*>(delta),
                 static_cast<__nv_bfloat16*>(dq),
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
    case 256: return run_d<256>(q, k, v, dout, p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_dq_bf16_smem_bytes(int D) {
  switch (D) {
    case 16: return dq_smem_bytes<16>();
    case 32: return dq_smem_bytes<32>();
    case 64: return dq_smem_bytes<64>();
    case 128: return dq_smem_bytes<128>();
    case 256: return kWideSmemBytes;
    default: return 0;
  }
}
