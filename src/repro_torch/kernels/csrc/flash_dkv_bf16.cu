// Flash-attention dk / dv at bf16 q/k/v/dO on Hopper's tensor cores, per
// query head, with the paper's dropout modes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// _dkv_kernel (flash_attention_bwd.py:137, pl.pallas_call at :288) at bf16.
// The f32 instance is csrc/flash_dkv_f32.cu; dq (_dq_kernel, :77) is
// csrc/flash_dq_f32.cu and csrc/flash_dq_bf16.cu.
//
// What it computes: exactly the JAX kernel's bf16 instance, which upcasts
// the bf16 tiles to f32 (:168-173), multiplies the f32 p_drop by dO and the
// f32 ds by q (:192-198) and rounds dk and dv once (:300-311). With keep
// mask K, P = exp(S * scale - lse) recomputed from the forward's lse
// (invalid scores masked to neg_big() as in the forward) and Delta from the
// caller:
//     P_drop = K o P / (1-p),   dP = K / (1-p) o (dO V^T),
//     dS = P o (dP - Delta) * scale,   dV = P_drop^T dO,   dK = dS^T Q,
// dS scaled before its product as flash_dkv_f32.cu scales it. S^T = K Q^T and
// dP^T = V dO^T are bf16 wgmma products (exact products, f32 sums);
// P_drop and dS enter their products as exact triples hi + mid + lo
// (flash_sm90.cuh), so those are the f32-operand products up to the order
// of the sums. dk and dv are written per query head, each element by
// one thread, no atomics: a training step stays bitwise reproducible, and
// the GQA group sum stays in torch.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the four
// products of the valid half are 137 GFLOP (0.14 ms at 989 TFLOP/s bf16);
// the exponentials and the replayed keep bits are SIMT work (0.07 ms at
// the issue rate); the operands 0.1 GB. The triples add 2x the tensor-core
// work (dV and dK three times); chip_smoke.py's bound does not count it.
//
// The design: one warpgroup (128 threads) a CTA per (64 keys, head, batch),
// walking the q-blocks that hold a valid score. K and V are loaded once by
// TMA; each q-block's Q and dO tiles, lse and Delta come through a
// two-stage ring (TMA tiles, bulk copies of the rows' lse and Delta). The
// CTA computes the transposed tiles directly: S^T and dP^T as m64n64
// wgmma with both operands K-major in shared memory, so the keys are the
// accumulator rows, and their fragments become the register A operands of
// dV += P_drop^T dO and dK += dS^T Q (m64nDk16, B = dO or Q read MN-major).
// dK and dV stay in registers (D / 2 floats each a thread: 128 at D = 128,
// with S^T and dP^T on top); each q-block's products are products of their
// own (64 columns at a time at D = 128), folded into dK and dV by f32 adds
// as the JAX kernel folds its blocks (chained over all q-blocks inside the
// tensor core, its f32 accumulation moved 0.2 % of dk's bf16 roundings
// against the plain version; folded, 0.05 %; the SIMT kernel, 0.04 %).
// P_drop's three fragments replace S^T and are consumed before dS's
// replace dP^T: the peak is dK, dV, dP^T, one set of fragments and a
// chunk, about 240 live values. Shared memory: K, V and two stages of Q,
// dO, lse, Delta, 99 KB at D = 128 -- two CTAs an SM.
//
// At D = 256 (recurrentgemma's LOCAL layer) dK and dV alone would take 256
// registers a thread: flash_dkv_kernel_wide below, a kernel of its own, so
// the instances above keep their machine code.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"
#include "flash_wide_map.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

struct DkvArgs {
  const float* lse;
  const float* delta;
  __nv_bfloat16* dk;  // (B, H, SK, D): per query head
  __nv_bfloat16* dv;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

// a ring stage: Q, dO, then the q-block's 64 lse and 64 Delta values
template <int D>
__host__ __device__ constexpr int stage_bytes() {
  return (2 * tile_bytes<D>() + 2 * 256 + 1023) / 1024 * 1024;
}

template <int D>
constexpr int dkv_smem_bytes() {
  // alignment slack, K, V, two stages, three mbarriers
  return 1024 + 2 * tile_bytes<D>() + 2 * stage_bytes<D>() + 24;
}

template <int D, int MODE>
__global__ void __launch_bounds__(WG, 1)
    flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          DkvArgs p) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int STAGE = stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t ring = vs + TILE;
  const uint32_t bar = ring + 2 * STAGE;  // K / V's barrier, then stage s's

  const int t = threadIdx.x, w = t / 32, l = t % 32, c = l % 4;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int k_start = ki * BK;
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ;
  const float* lse_g = p.lse + q_row;
  const float* delta_g = p.delta + q_row;

  // the q-blocks that hold a valid score: one contiguous run
  int q_first = 0, n = 0;
  for (int qi = 0; qi < p.SQ / BQ; ++qi)
    if (tile_runs(qi * BQ, k_start, q_offset, p.causal, p.local_window)) {
      if (n == 0) q_first = qi;
      ++n;
    }

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_stage = [&](int s, int q_start) {
    const uint32_t st = ring + s * STAGE, full = bar + 8 + 8 * s;
    mbar_expect_tx(full, 2 * TILE + 2 * 256);
    load_tile<D>(st, &map_q, full, q_row + q_start);
    load_tile<D>(st + TILE, &map_do, full, q_row + q_start);
    bulk_load(st + 2 * TILE, lse_g + q_start, 256, full);
    bulk_load(st + 2 * TILE + 256, delta_g + q_start, 256, full);
  };
  if (threadIdx.x == 0) {
    const int kv_row = (b * p.KV + kvh) * p.SK + k_start;
    mbar_expect_tx(bar, 2 * TILE);
    load_tile<D>(ks, &map_k, bar, kv_row);
    load_tile<D>(vs, &map_v, bar, kv_row);
    for (int s = 0; s < 2 && s < n; ++s) load_stage(s, (q_first + s) * BQ);
  }

  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  mbar_wait_or_trap(bar, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const int q_start = (q_first + it) * BQ;
    const uint32_t qt = ring + s * STAGE, dot = qt + TILE;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_raw + (qt + 2 * TILE - raw));
    const float* delta_s = lse_s + 64;
    mbar_wait_or_trap(bar + 8 + 8 * s, (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[32], dpt[32];  // replaced by their first products
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(st, desc_k<D>(ks, j), desc_k<D>(qt, j), j);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(dpt, desc_k<D>(vs, j), desc_k<D>(dot, j), j);
    wgmma_commit();
    uint32_t kb[2];
    keep_dkv<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
    wgmma_wait0();
    fence_acc(st);
    fence_acc(dpt);

    // element (hh, g, e): key k_start + 16w + l/4 + 8hh, query q_start +
    // 8g + 2c + e; st becomes P_drop, dpt becomes dS * scale
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k_start + 16 * w + l / 4 + 8 * hh;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * g + 2 * c + e;
          const int i = 4 * g + 2 * hh + e;
          float sc = st[i] * p.scale;
          if ((p.causal || p.local_window > 0) &&
              !score_valid(q_start + qc + q_offset, key, p.causal,
                           p.local_window))
            sc = neg_big();
          const float pr = expf(sc - lse_s[qc]);
          float gd = dpt[i];
          float pd = pr;
          if (MODE != kNone) {
            const bool keep = (kb[hh] >> (2 * g + e)) & 1u;
            gd = keep ? gd * p.dp.inv_keep : 0.f;
            pd = keep ? pr * p.dp.inv_keep : 0.f;
          }
          st[i] = pd;
          dpt[i] = pr * (gd - delta_s[qc]) * p.scale;
        }
    }

    // dV += P_drop^T dO, then dK += dS^T Q, each operand as hi + mid + lo:
    // each q-block's product is one of its own, folded into dV / dK by f32
    // adds as the JAX kernel folds its blocks, 64 columns at a time;
    // P_drop's fragments are released before dS's are made
    uint32_t a[3][4][4];
    a_frags(st, a);
    add_product<D>(dv, a, dot);
    a_frags(dpt, a);
    add_product<D>(dk, a, qt);

    // every warp's products and reads of this stage are done: refill it
    __syncthreads();
    if (threadIdx.x == 0 && it + 2 < n) load_stage(s, q_start + 2 * BQ);
  }

  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SK + k_start +
                      16 * w + l / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* krow = p.dk + (row0 + 8 * hh) * D;
    __nv_bfloat16* vrow = p.dv + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dk[4 * g + 2 * hh], dk[4 * g + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dv[4 * g + 2 * hh], dv[4 * g + 2 * hh + 1]);
    }
  }
}

// ------------------------------------------------- the D = 256 instance
//
// 64 keys a CTA of three warpgroups. Warpgroup 0 is the producer: its
// thread 0 loads K and V once and walks the q-blocks' Q, dO, lse and Delta
// through a ring of two stages (TMA tiles and bulk copies, full and empty
// mbarriers), and it gives its registers to the consumers (setmaxnreg: 24
// a thread left, 240 for the consumers). Warpgroups 1 and 2 are the
// consumers (flash_wide_map.cuh). Each computes the m64n32 columns of
// S^T = K Q^T and dP^T = V dO^T of its own 32 queries of the q-block over
// the full D (B the Q or dO tile's rows from dkv_query0), committed apart,
// with their keep bits (keep_dkv_half) and exponentials: no score product
// and no keep bit is made twice. Its P_drop^T and dS^T halves cross
// through a 32 KB exchange in shared memory, so each holds the whole
// 64 x 64 fragment, split into the exact triple, as the register A
// operand of dV += P_drop^T dO and dK += dS^T Q over its own 128 columns
// (m64n128k16, dO and Q read MN-major); dV and dK are two m64n128
// accumulators (128 registers a thread) that the products accumulate into
// inside the tensor core, the smallest parts first. A q-block's dK is
// issued together with the next q-block's S^T and dP^T, and the next
// one's exponentials and dS run under it; its keep bits run under dV. A
// stage goes back once the dK that reads it is done. The two consumers meet
// twice a q-block at named barrier 1 (the other's halves are read; the
// halves are written). Shared memory: K, V, two stages of Q and dO (192
// KB), their lse and Delta, the exchange, five mbarriers: 231,464 bytes
// -- one CTA an SM. What bounds it: at recurrentgemma's LOCAL layer its
// four products take 0.209 ms at the bf16 tensor rate (dV and dK three
// times over with the triples); on the H100 its output products run at
// about 1.5x their clocks beside the consumers' SIMT work, and the two
// consumers meet at the exchange (PERF.md).
constexpr int WIDE_D = 256;
constexpr int WIDE_TILE = tile_bytes<WIDE_D>();
constexpr int WIDE_THREADS = 3 * WG;
// registers a thread after setmaxnreg (the launch's 168 x 384 in all)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// the two consumers' named barrier (__syncthreads is 0)
constexpr int kXchgBarrier = 1;
// a stage's 64 lse and 64 Delta values
constexpr int kStageRows = 2 * BQ * 4;
constexpr int kXchgBytes = wide_map::DKV_BF16_XCHG_FLOATS * 4;
// alignment slack, K, V, two stages of Q and dO and of lse and Delta, the
// exchange, five mbarriers
constexpr int kWideSmemBytes =
    1024 + 6 * WIDE_TILE + 2 * kStageRows + kXchgBytes + 5 * 8;

// float4 k (elements 4 k .. 4 k + 3) of thread t's half in region r of
// the exchange at x (dkv_xchg: float4s of a warpgroup side by side)
__device__ __forceinline__ uint32_t xchg_at(uint32_t x, int r, int t,
                                            int k) {
  return x + 4 * (r * wide_map::DKV_XCHG_FLOATS +
                  wide_map::dkv_xchg(t, 4 * k));
}
__device__ __forceinline__ void st_shared_f4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// consumer cw's 64 x 64 fragment (dkv_full) from its own m64n32 half and
// the other's, read from region r of the exchange
__device__ __forceinline__ void full_frag(const float (&mine)[16], int cw,
                                          uint32_t x, int r, int t,
                                          float (&full)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 o = ld_shared_f4(xchg_at(x, r, t, k));
    const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * k + e;
      full[wide_map::dkv_full(0, i)] = cw == 0 ? mine[i] : other[e];
      full[wide_map::dkv_full(1, i)] = cw == 0 ? other[e] : mine[i];
    }
  }
}

// acc (64 x 128, this consumer's output columns) += A B for A the triple
// of a 64 x 64 fragment and B the 64-row tile at b from its columns,
// read MN-major: lo of every k16 slice, then mid, then hi, into the
// accumulator inside the tensor core
__device__ __forceinline__ void issue_out(float (&acc)[64],
                                          const uint32_t (&a)[3][4][4],
                                          uint32_t b) {
#pragma unroll
  for (int i = 2; i >= 0; --i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs<128>(acc, a[i][j], desc_mn<WIDE_D>(b, j), 1);
}

template <int D, int MODE>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_dkv_kernel_wide(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          DkvArgs p) {
  static_assert(D == WIDE_D, "the wide instance is the D = 256 one");
  namespace map = repro_flash::wide_map;
  constexpr int TILE = WIDE_TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t ring = vs + TILE;  // stage s: Q at ring + 2 s TILE, dO next
  const uint32_t rows = ring + 4 * TILE;  // stage s's lse, Delta
  const uint32_t xchg = rows + 2 * kStageRows;
  // K and V's barrier; then the stages' full and empty ones, two each
  const uint32_t kv_full = xchg + kXchgBytes;
  const uint32_t full = kv_full + 8, empty = full + 16;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int k_start = ki * BK;
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ;
  const map::Run run =
      map::q_run(k_start, p.SQ, q_offset, p.causal, p.local_window);
  const int q_first = run.first, n = run.n;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      // a stage goes back once every consumer warp is done with it
      mbar_init(empty + 8 * s, 2 * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n > 0) {
      const int kv_row = (b * p.KV + kvh) * p.SK + k_start;
      mbar_expect_tx(kv_full, 2 * TILE);
      load_tile<D>(ks, &map_k, kv_full, kv_row);
      load_tile<D>(vs, &map_v, kv_full, kv_row);
      for (int it = 0; it < n; ++it) {
        const int s = it & 1;
        const int q_start = (q_first + it) * BQ;
        const uint32_t f = full + 8 * s, st = ring + 2 * s * TILE;
        // stage s held q-block it - 2: its phase (it / 2 - 1) emptied
        if (it >= 2) mbar_wait_spin(empty + 8 * s, ((it >> 1) - 1) & 1);
        mbar_expect_tx(f, 2 * TILE + kStageRows);
        load_tile<D>(st, &map_q, f, q_row + q_start);
        load_tile<D>(st + TILE, &map_do, f, q_row + q_start);
        bulk_load(rows + s * kStageRows, p.lse + q_row + q_start, 256, f);
        bulk_load(rows + s * kStageRows + 256, p.delta + q_row + q_start,
                  256, f);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int q0 = map::dkv_query0(cw);  // its queries of a q-block
  const int col0 = map::dkv_bf16_col0(cw);
  // its columns of a Q or dO tile: col0 / 64 boxes in
  const uint32_t cols = (col0 / 64) * 64 * row_bytes<D>();
  // its queries' rows of a Q or dO tile, the B of its score products
  const uint32_t qrows = q0 * row_bytes<D>();
  const float* rows_p = reinterpret_cast<const float*>(smem_raw + (rows - raw));

  float dk[64], dv[64];
  zero(dk);
  zero(dv);
  float st[16], dpt[16];  // S^T, dP^T halves; then P, dS * scale
  uint32_t a[3][4][4];    // the triple of P_drop^T, then of dS^T
  uint32_t kb[2];

  // S^T and dP^T of q-block `it` (stage it & 1) over the full D, committed
  // apart
  auto issue_scores = [&](int it) {
    const uint32_t qt = ring + 2 * (it & 1) * TILE, dot = qt + TILE;
    mbar_wait_spin(full + 8 * (it & 1), (it >> 1) & 1);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n32(st, desc_k<D>(ks, j), desc_k<D>(qt + qrows, j), j);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n32(dpt, desc_k<D>(vs, j), desc_k<D>(dot + qrows, j), j);
    wgmma_commit();
  };

  // element (hh, g, e) of a half: key k_start + 16w + l/4 + 8hh, query
  // q_start + q0 + 8g + 2c + e. P of q-block `it` from S^T (into st)
  auto probs = [&](int it) {
    const int q_start = (q_first + it) * BQ;
    const float* lse_s = rows_p + (it & 1) * kStageRows / 4;
    const bool whole = map::tile_full(q_start, k_start, q_offset, p.causal,
                                      p.local_window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k_start + 16 * w + l / 4 + 8 * hh;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = q0 + 8 * g + 2 * c + e;
          const int i = 4 * g + 2 * hh + e;
          float sc = st[i] * p.scale;
          if (!whole && !score_valid(q_start + qc + q_offset, key, p.causal,
                                     p.local_window))
            sc = neg_big();
          st[i] = expf(sc - lse_s[qc]);
        }
    }
  };
  // dS * scale of q-block `it` from P and dP^T (into dpt)
  auto grads = [&](int it) {
    const float* delta_s = rows_p + (it & 1) * kStageRows / 4 + BQ;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = q0 + 8 * g + 2 * c + e;
          const int i = 4 * g + 2 * hh + e;
          float gd = dpt[i];
          if (MODE != kNone)
            gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
          dpt[i] = st[i] * (gd - delta_s[qc]) * p.scale;
        }
  };
  // P_drop = P o K / (1-p), element i of the half
  auto dropped = [&](int i) {
    const int g = i / 4, e = i % 2, hh = (i / 2) % 2;
    if (MODE == kNone) return st[i];
    return ((kb[hh] >> (2 * g + e)) & 1u) ? st[i] * p.dp.inv_keep : 0.f;
  };

  // q-block `it` once its P and dS halves are made: the halves cross (once
  // the other consumer has read the q-block before's, both write theirs,
  // then read), dV += P_drop^T dO over this consumer's columns with the
  // next q-block's keep bits under it, then dS^T's triple into a
  auto exchange_dv = [&](int it) {
    const uint32_t dot = ring + 2 * (it & 1) * TILE + TILE;
    named_sync(kXchgBarrier, 2 * WG);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      st_shared_f4(xchg_at(xchg, map::dkv_bf16_region(0, cw), t, k),
                   dropped(4 * k), dropped(4 * k + 1), dropped(4 * k + 2),
                   dropped(4 * k + 3));
      st_shared_f4(xchg_at(xchg, map::dkv_bf16_region(1, cw), t, k),
                   dpt[4 * k], dpt[4 * k + 1], dpt[4 * k + 2],
                   dpt[4 * k + 3]);
    }
    named_sync(kXchgBarrier, 2 * WG);
    {
      float mine[16], whole_p[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i] = dropped(i);
      full_frag(mine, cw, xchg, map::dkv_bf16_region(0, 1 - cw), t,
                whole_p);
      a_frags(whole_p, a);
    }
    wgmma_fence();
    issue_out(dv, a, dot + cols);
    wgmma_commit();
    if (it + 1 < n) {
      keep_dkv_half<MODE>(p.dp, b, h, p.H, p.SQ, p.SK,
                          (q_first + it + 1) * BQ + q0, k_start, kb);
      asm volatile("" : "+r"(kb[0]), "+r"(kb[1]));
    }
    wgmma_wait0();
    fence_acc(dv);
    hold(a);
    float whole_s[32];
    full_frag(dpt, cw, xchg, map::dkv_bf16_region(1, 1 - cw), t, whole_s);
    a_frags(whole_s, a);
  };

  // No product is in flight where the walk's loop begins (ptxas serializes
  // every product of a kernel whose products cross a loop's back edge):
  // q-block 0's scores go first; each step issues dK of its q-block with
  // the next one's S^T and dP^T, makes the next P and dS under dK and
  // waits for all; the last q-block's dK goes alone.
  if (n > 0) {
    mbar_wait_spin(kv_full, 0);
    keep_dkv_half<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_first * BQ + q0,
                        k_start, kb);
    wgmma_fence();
    issue_scores(0);
    wgmma_wait1();
    fence_acc(st);
    probs(0);
    wgmma_wait0();
    fence_acc(dpt);
    grads(0);
  }
#pragma unroll 1
  for (int it = 0; it + 1 < n; ++it) {
    exchange_dv(it);
    wgmma_fence();
    issue_scores(it + 1);
    issue_out(dk, a, ring + 2 * (it & 1) * TILE + cols);
    wgmma_commit();
    wgmma_wait2();
    fence_acc(st);
    probs(it + 1);
    wgmma_wait1();
    fence_acc(dpt);
    grads(it + 1);
    wgmma_wait0();
    fence_acc(dk);
    hold(a);
    // dK was the last to read q-block it's stage: it goes back
    if (l == 0) mbar_arrive(empty + 8 * (it & 1));
  }
  if (n > 0) {
    exchange_dv(n - 1);
    wgmma_fence();
    issue_out(dk, a, ring + 2 * ((n - 1) & 1) * TILE + cols);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(dk);
    hold(a);
  }

  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SK + k_start +
                      16 * w + l / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* krow = p.dk + (row0 + 8 * hh) * D + col0;
    __nv_bfloat16* vrow = p.dv + (row0 + 8 * hh) * D + col0;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dk[4 * g + 2 * hh], dk[4 * g + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * g + 2 * c) =
          __floats2bfloat162_rn(dv[4 * g + 2 * hh], dv[4 * g + 2 * hh + 1]);
    }
  }
}

template <int D, int MODE>
int launch(const CUtensorMap (&maps)[4], const DkvArgs& p, cudaStream_t s) {
  // only the kernel this D runs is instantiated
  constexpr bool wide = D == WIDE_D;
  constexpr int smem = wide ? kWideSmemBytes : dkv_smem_bytes<D>();
  const auto kernel = [] {
    if constexpr (wide)
      return flash_dkv_kernel_wide<D, MODE>;
    else
      return flash_dkv_kernel_sm90<D, MODE>;
  }();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SK / BK, p.H, p.B), wide ? WIDE_THREADS : WG, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_d(const void* q, const void* k, const void* v, const void* dout,
          const DkvArgs& p, int mode, cudaStream_t s) {
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

// dk, dv (B,H,SK,D) per query head, bf16, from bf16 q (B,H,SQ,D), k/v
// (B,KV,SK,D), dout (B,H,SQ,D) and f32 lse, delta (B,H,SQ), all contiguous
// and on 16 bytes; SQ and SK multiples of 64; D in {16, 32, 64, 128, 256}. The
// arguments of repro_flash_dkv (flash_dkv_f32.cu); dq is not written. Launches
// on `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  (void)dq;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs p{static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv),
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
extern "C" int repro_flash_dkv_bf16_smem_bytes(int D) {
  switch (D) {
    case 16: return dkv_smem_bytes<16>();
    case 32: return dkv_smem_bytes<32>();
    case 64: return dkv_smem_bytes<64>();
    case 128: return dkv_smem_bytes<128>();
    case 256: return kWideSmemBytes;
    default: return 0;
  }
}
