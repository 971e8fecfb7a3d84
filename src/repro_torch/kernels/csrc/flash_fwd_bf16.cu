// Flash-attention forward at bf16 q/k/v on Hopper's tensor cores: out
// (B, H, SQ, D) in bf16 and the row log-sum-exp (B, H, SQ) in f32, with the
// paper's dropout modes -- the Bf16Ops instance of flash_fwd_sm90.cuh's
// body at D <= 128 (the f32 instance is flash_fwd_f32.cu) and a kernel of
// its own at D = 256 (flash_fwd_kernel_wide, below).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300) at bf16
// q/k/v, reached through flash_attention_mosaic (:388-433).
//
// What it computes: exactly the JAX kernel's bf16 instance, which upcasts
// the bf16 tiles to f32 (:108-110), multiplies in f32, multiplies the f32
// probabilities P by V (:155-157) and rounds O once (:289). Scores S = (q .
// k) * scale come from bf16 wgmma products -- every product of two bf16
// values is exact in f32 -- with f32 sums. P enters P V as the exact
// triple hi + mid + lo (flash_sm90.cuh): three bf16 products into the
// same f32 accumulator are f32 P times V up to the order of the sums.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the
// products of the valid half are 69 GFLOP (0.07 ms at 989 TFLOP/s bf16),
// the exponentials and the replayed keep bits are SIMT work the tensor
// cores cannot take (the same 0.07 ms at the issue rate), the operands
// 0.1 GB. The triple doubles the tensor-core work (the PV half three
// times); chip_smoke.py's bound does not count it.
//
// The design at D <= 128 (flash_fwd_sm90.cuh): one warpgroup a CTA, K and
// V through a two-stage TMA ring, S an m64n64 wgmma with both operands
// K-major in shared memory, the keep bits made while it runs, the softmax
// on its accumulator, P's parts register A operands of m64nDk16 products
// against V read MN-major, each k-block's P V folded into O by one f32
// multiply-add an element (a product chained over all k-blocks inside the
// tensor core carries its f32 accumulation over 384 steps: flash_sm90.cuh
// has what that did). Shared memory: Q and two stages of K and V, 80 KB at
// D = 128 -- two CTAs an SM.
#include <cstdint>

#include "flash_fwd_sm90.cuh"
#include "flash_wide_map.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

// ------------------------------------------------- the D = 256 instance
//
// 128 query rows a CTA of three warpgroups. Warpgroup 0 is the producer:
// its thread 0 loads both consumers' Q tiles and walks K and V through
// rings of two stages each (TMA, full and empty mbarriers; K's stage goes
// back once both consumers' S is done, V's once their P V is), and it
// gives its registers to the consumers (setmaxnreg: 24 a thread left, 240
// for the consumers). Warpgroups 1 and 2 are the consumers, 64 query rows
// each over the full D = 256 (flash_wide_map.cuh: fwd_bf16_q_start), both
// reading every K and V stage: S = Q K^T is run once for each row, and each
// K and V byte in shared memory serves 128 rows. O is one m64n256
// accumulator, 128 f32 registers a thread: it is scaled by alpha in
// registers and P V (P the exact triple hi + mid + lo of register A
// operands, m64n256k16, V read MN-major) accumulates into it inside the
// tensor core, smallest parts first, so no second accumulator holds P V.
// Each consumer issues S of k-block j together with P V of k-block j - 1,
// makes the keep bits while they run, runs the softmax of j once S is done
// -- under P V of j - 1 -- and only then waits for P V, scales O and splits
// P. The two consumers take turns at issuing their products (named
// barriers 1 and 2: a ping-pong), so one's softmax and keep bits run under
// the other's products. Where SQ % 128 == 64 the last CTA's second
// consumer has no rows and stays out of the walk, the turns and the stage
// releases. Shared memory: Q (64 KB), two K and two V stages (128 KB),
// nine mbarriers: 197,704 bytes -- one CTA an SM. A kernel of its own, so
// that the body's instances keep their machine code.
constexpr int WIDE_D = 256;
constexpr int WIDE_TILE = tile_bytes<WIDE_D>();
constexpr int WIDE_THREADS = 3 * WG;
// registers a thread after setmaxnreg (the launch's 168 x 384 in all)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: consumer cw's turn to issue products is barrier 1 + cw
constexpr int kTurnBarrier = 1;

// A consumer warpgroup: this thread's O, m, l and P of its 64 query rows,
// the products it issues and its softmax
template <int MODE>
struct Consumer {
  const fwd::FwdArgs<__nv_bfloat16>& p;
  uint32_t qa, ks, vs;  // its Q tile; K's and V's stages (TILE apart)
  uint32_t k_full, v_full;
  int q_start, q_offset, w, l, c;
  float o[WIDE_D / 2];
  float m[2], lsum[2];
  float sc[32];          // S, then P, of the k-block in hand
  uint32_t pa[3][4][4];  // P's triple, the A operand of P V

  // S = Q K^T of the walk's k-block j (16 k16 slices, both K-major),
  // issued once its K has landed, and committed
  __device__ __forceinline__ void issue_s(int j) {
    const uint32_t kt = ks + (j & 1) * WIDE_TILE;
    mbar_wait_spin(k_full + 8 * (j & 1), (j >> 1) & 1);
#pragma unroll
    for (int jj = 0; jj < WIDE_D / 16; ++jj)
      wgmma_ss_n64(sc, desc_k<WIDE_D>(qa, jj), desc_k<WIDE_D>(kt, jj), jj);
    wgmma_commit();
  }

  // O += P V of k-block j (P's lo, then mid, then hi parts, each over the
  // four k16 slices; V MN-major, m64n256k16), issued once its V has
  // landed, and committed
  __device__ __forceinline__ void issue_pv(int j) {
    const uint32_t vt = vs + (j & 1) * WIDE_TILE;
    mbar_wait_spin(v_full + 8 * (j & 1), (j >> 1) & 1);
#pragma unroll
    for (int i = 2; i >= 0; --i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wgmma_rs<WIDE_D>(o, pa[i][jj], desc_mn<WIDE_D>(vt, jj), 1);
    wgmma_commit();
  }

  // online softmax of the k-block at k_start on S (element (hh, g, e) is
  // sc[4g+2hh+e]): sc becomes P (the undropped probabilities times the keep
  // bits kb), alpha[hh] the rescale of its rows' O
  __device__ __forceinline__ void softmax(int k_start,
                                          const uint32_t (&kb)[2],
                                          float (&alpha)[2]) {
    const bool full = repro_flash::wide_map::tile_full(
        q_start, k_start, q_offset, p.causal, p.local_window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
      float mc = neg_big();
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[4 * g + 2 * hh + e] * p.scale;
          if (!full && !score_valid(q_pos, k_start + 8 * g + 2 * c + e,
                                    p.causal, p.local_window))
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
          sc[4 * g + 2 * hh + e] = ((kb[hh] >> (2 * g + e)) & 1u) ? ev : 0.f;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      lsum[hh] = alpha[hh] * lsum[hh] + rs;
      m[hh] = m_new;
    }
  }

  // O scaled by alpha, P split into its triple: once P V of the k-block
  // before is done
  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < WIDE_D / 2; ++i) o[i] = o[i] * alpha[(i / 2) % 2];
    a_frags(sc, pa);
  }
};

template <int D, int MODE>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_fwd_kernel_wide(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ fwd::FwdArgs<__nv_bfloat16>
                              p) {
  static_assert(D == WIDE_D, "the wide instance is the D = 256 one");
  namespace map = repro_flash::wide_map;
  constexpr int TILE = WIDE_TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q of cw
  const uint32_t ks = qs + 2 * TILE;  // K's stage s at ks + s TILE
  const uint32_t vs = ks + 2 * TILE;  // V's stage s at vs + s TILE
  // Q's barrier; then K's full, K's empty, V's full, V's empty, two each
  const uint32_t q_full = vs + 2 * TILE;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 16;
  const uint32_t v_full = k_empty + 16, v_empty = v_full + 16;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ;
  const int kv_row = (b * p.KV + kvh) * p.SK;
  // consumers with rows: 1, or 2
  const int groups = map::fwd_bf16_has_rows(qi, 1, p.SQ) ? 2 : 1;

  // the k-blocks that hold a valid score for a row of the CTA: one
  // contiguous run (a consumer's k-block without one adds exact zeros)
  int k_first = 0, n = 0;
  for (int ki = 0; ki < p.SK / BK; ++ki) {
    bool run = false;
    for (int cw = 0; cw < groups; ++cw)
      run = run || tile_runs(map::fwd_bf16_q_start(qi, cw), ki * BK,
                             q_offset, p.causal, p.local_window);
    if (run) {
      if (n == 0) k_first = ki;
      ++n;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      // a stage goes back once every consumer warp is done with it
      mbar_init(k_empty + 8 * s, groups * WG / 32);
      mbar_init(v_empty + 8 * s, groups * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(q_full, groups * TILE);
      for (int cw = 0; cw < groups; ++cw)
        load_tile<D>(qs + cw * TILE, &map_q, q_full,
                     q_row + map::fwd_bf16_q_start(qi, cw));
      for (int j = 0; j < n; ++j) {
        const int s = j & 1;
        const int row = kv_row + (k_first + j) * BK;
        // stage s held k-block j - 2: its phase (j / 2 - 1) emptied
        if (j >= 2) mbar_wait_spin(k_empty + 8 * s, ((j >> 1) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, TILE);
        load_tile<D>(ks + s * TILE, &map_k, k_full + 8 * s, row);
        if (j >= 2) mbar_wait_spin(v_empty + 8 * s, ((j >> 1) - 1) & 1);
        mbar_expect_tx(v_full + 8 * s, TILE);
        load_tile<D>(vs + s * TILE, &map_v, v_full + 8 * s, row);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  if (cw >= groups) return;  // past SQ: no rows
  const int t = threadIdx.x % WG, lane = t % 32;
  Consumer<MODE> cs{p,
                    qs + cw * TILE,
                    ks,
                    vs,
                    k_full,
                    v_full,
                    map::fwd_bf16_q_start(qi, cw),
                    q_offset,
                    t / 32,
                    lane,
                    lane % 4};
  zero(cs.o);
  cs.m[0] = cs.m[1] = neg_big();
  cs.lsum[0] = cs.lsum[1] = 0.f;
  // the turns: consumer 0 issues first; each waits for its turn before
  // issuing and hands it over after (consumer 1 not after its last: the
  // other issues no more)
  const bool pingpong = groups == 2;
  const int mine = kTurnBarrier + cw, other = kTurnBarrier + 1 - cw;

  if (n > 0) {
    mbar_wait_spin(q_full, 0);
    if (pingpong && cw == 1) named_arrive(other, 2 * WG);
    // k-block 0: S alone
    uint32_t kb[2];
    keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, cs.q_start, k_first * BK,
                   kb);
    if (pingpong) named_sync(mine, 2 * WG);
    wgmma_fence();
    cs.issue_s(0);
    if (pingpong) named_arrive(other, 2 * WG);
    wgmma_wait0();
    fence_acc(cs.sc);
    if (lane == 0) mbar_arrive(k_empty);
    float alpha[2];
    cs.softmax(k_first * BK, kb, alpha);
    cs.rescale(alpha);
    // k-block j: S of j with P V of j - 1, the softmax of j under P V
#pragma unroll 1
    for (int j = 1; j < n; ++j) {
      const int k_start = (k_first + j) * BK;
      // the keep bits while the other consumer's products run, made here
      // (the premask loads not sunk below the products)
      keep_fwd<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, cs.q_start, k_start, kb);
      asm volatile("" : "+r"(kb[0]), "+r"(kb[1]));
      if (pingpong) named_sync(mine, 2 * WG);
      wgmma_fence();
      cs.issue_s(j);
      cs.issue_pv(j - 1);
      if (pingpong) named_arrive(other, 2 * WG);
      wgmma_wait1();
      fence_acc(cs.sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * (j & 1));
      cs.softmax(k_start, kb, alpha);
      wgmma_wait0();
      fence_acc(cs.o);
      hold(cs.pa);
      if (lane == 0) mbar_arrive(v_empty + 8 * ((j - 1) & 1));
      cs.rescale(alpha);
    }
    // P V of the last k-block
    if (pingpong) named_sync(mine, 2 * WG);
    wgmma_fence();
    cs.issue_pv(n - 1);
    if (pingpong && cw == 0) named_arrive(other, 2 * WG);
    wgmma_wait0();
    fence_acc(cs.o);
    hold(cs.pa);
    if (lane == 0) mbar_arrive(v_empty + 8 * ((n - 1) & 1));
  }

  const size_t row0 = static_cast<size_t>(q_row) + cs.q_start +
                      16 * cs.w + lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float li = cs.lsum[hh] == 0.f ? 1.f : cs.lsum[hh];
    __nv_bfloat16* orow = p.o + (row0 + 8 * hh) * WIDE_D;
#pragma unroll
    for (int g = 0; g < WIDE_D / 8; ++g)
      fwd::store2(orow + 8 * g + 2 * cs.c,
                  cs.o[4 * g + 2 * hh] / li * p.dp.inv_keep,
                  cs.o[4 * g + 2 * hh + 1] / li * p.dp.inv_keep);
    if (cs.c == 0) p.lse[row0 + 8 * hh] = cs.m[hh] + logf(li);
  }
}

// alignment slack, Q of both consumers, two K and two V stages, nine
// mbarriers
constexpr int kWideSmemBytes = 1024 + 6 * WIDE_TILE + 9 * 8;

int run_wide(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int H, int KV, int SQ, int SK, float scale,
             int causal, int local_window, int mode, const void* plane,
             uint32_t threshold, float inv_keep, uint32_t key_lo,
             uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
             int heads_global, int rounds, cudaStream_t s) {
  constexpr int D = WIDE_D;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr) ||
      (mode != kNone && mode != kPremask && mode != kCounters))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  if (!make_tile_map<D>(&maps[0], q, B * H * SQ) ||
      !make_tile_map<D>(&maps[1], k, B * KV * SK) ||
      !make_tile_map<D>(&maps[2], v, B * KV * SK))
    return static_cast<int>(cudaErrorInvalidValue);
  const fwd::FwdArgs<__nv_bfloat16> p{
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, H, KV,
      SQ, SK, scale, causal, local_window,
      Dropout{static_cast<const int32_t*>(plane), threshold, key_lo, key_hi,
              salt, bh_offset, static_cast<uint32_t>(heads_global), rounds,
              inv_keep}};
  const auto kernel = mode == kNone      ? flash_fwd_kernel_wide<D, kNone>
                      : mode == kPremask ? flash_fwd_kernel_wide<D, kPremask>
                                         : flash_fwd_kernel_wide<D, kCounters>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(repro_flash::wide_map::fwd_bf16_ctas(SQ), H, B),
           WIDE_THREADS, kWideSmemBytes, s>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out, lse <- flash attention of bf16 q/k/v; out bf16, lse f32. The
// arguments and return of repro_flash_fwd (flash_fwd_f32.cu):
// repro_flash::fwd::run at D <= 128, run_wide at D = 256.
extern "C" int repro_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  if (D == WIDE_D)
    return run_wide(q, k, v, out, lse, B, H, KV, SQ, SK, scale, causal,
                    local_window, mode, plane, threshold, inv_keep, key_lo,
                    key_hi, salt, bh_offset, heads_global, rounds,
                    static_cast<cudaStream_t>(stream));
  return repro_flash::fwd::run<repro_flash::fwd::Bf16Ops>(
      q, k, v, out, lse, B, H, KV, SQ, SK, D, scale, causal, local_window,
      mode, plane, threshold, inv_keep, key_lo, key_hi, salt, bh_offset,
      heads_global, rounds, stream);
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_fwd_bf16_smem_bytes(int D) {
  if (D == WIDE_D) return kWideSmemBytes;
  return repro_flash::fwd::smem_bytes<repro_flash::fwd::Bf16Ops>(D);
}
