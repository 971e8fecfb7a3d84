// Flash-attention forward at f32 q/k/v on Hopper's tensor cores: out
// (B, H, SQ, D) and the row log-sum-exp (B, H, SQ) in f32, with the
// paper's dropout modes -- the F32Ops instance of flash_fwd_sm90.cuh's
// body (the bf16 instance is flash_fwd_bf16.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300) at f32
// q/k/v, reached through flash_attention_mosaic (:388-433).
//
// What it computes: the JAX kernel's f32 instance. Both products have f32
// operands on both sides -- S = Q K^T and P V -- and each is the sum of
// the six bf16 part products of the operands' exact triples that reach
// 2^-16 (flash_sm90.cuh: score6, add_product6), smallest first, with f32
// sums: the f32 product up to about 2^-23 of sum |a||b| and the order of
// the sums. A product that split one operand and rounded the other once
// to bf16 would be about 2^-9 off: another function.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the
// products of the valid half are 68.7 GFLOP; six bf16 products apiece are
// 0.42 ms at 989 TFLOP/s (1.03 ms at the f32 SIMT rate of 67 TFLOP/s, the
// rate of the SIMT kernel this one replaced); the exponentials and the
// replayed keep bits are SIMT work the tensor cores cannot take (0.07 ms
// at the issue rate), and so are the splits (about 12 instructions a pair
// of values, Q once and K and V each k-block); the operands, O and lse
// move 0.27 GB (0.08 ms at 3.35 TB/s).
//
// The design (flash_fwd_sm90.cuh, F32Ops): the f32 dq kernel's
// (flash_dq_f32.cu) on the forward's body, with two warpgroups a CTA (128
// query rows of one head and batch, q-blocks launched longest first)
// sharing the K and V triples, so each split serves 128 rows. The f32
// tiles come by TMA into a staging tile and the CTA's 256 threads split
// them into bf16 triples in the layout the products read: Q once, then
// each k-block's V while the S products run and the next k-block's K
// while P V's first column chunk runs. P is an exact register triple
// (a_frags); each 64-column chunk of P V is a product of its own folded
// into O by f32 adds. Shared memory: two Q triples, the K and V triples
// and one f32 staging tile, 230,408 bytes at D = 128 -- one CTA an SM.
// Measured on the H100 (PERF.md row 4): without the splits (a wrong
// output, for timing) the one-warpgroup version ran 0.43 ms faster in
// none mode (1.32 ms); two warpgroups took it to 1.04 ms, replay from
// 1.76 to 1.30 ms.
#include <cstdint>

#include "flash_f32_wide.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

// The D = 256 instance (flash_f32_wide.cuh), split by D: two warpgroups
// on the same 64 query rows, warpgroup wg owning D's columns 128 wg ..
// (flash_wide_map.cuh). Q is split once into its triple. Each k-block is
// eight steps a warpgroup, each one 32-column slice of its own half, split
// by the warpgroup's 128 threads into one of its two slice buffers: K's
// four slices, over which it reduces its partial scores (m64n64, the part
// products chained over its 128 columns of D), then V's four, each an
// m64n32 product of P and the slice folded into its 32 columns of O by f32
// adds. While a step's products run, the warpgroup splits the next step's
// slice (loaded into registers a step earlier) into the other buffer and
// loads the one after: one barrier a step, the warpgroup's own. After the
// fourth step the two partial score tiles cross through shared memory
// (with the two row groups' keep bits, each warpgroup having made one),
// and each warpgroup adds them -- the same sum in both -- and runs the
// online softmax of flash_fwd_sm90.cuh's body in full. Shared memory: the
// Q triple (96 KB), four slice triples (48 KB) and the exchange (33 KB),
// 182,272 bytes -- one CTA an SM. Steps of two slices (one m64n64 product
// of P V) spilled and ran 5 % slower. A kernel of its own, so that the
// body's instances keep their machine code.
template <int D, int MODE>
__global__ void __launch_bounds__(wide::THREADS, 1)
    flash_fwd_kernel_wide(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          fwd::FwdArgs<float> p) {
  static_assert(D == wide::D, "the wide instance is the D = 256 one");
  namespace map = wide_map;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;  // hi, mid, lo
  const uint32_t bufs = qs + 3 * wide::TILE;   // two slice triples a wg
  const uint32_t xchg = bufs + 4 * wide::SLICE3;
  float* xs = reinterpret_cast<float*>(smem_raw + (xchg - raw));
  uint32_t* xk = reinterpret_cast<uint32_t*>(xs + map::FWD_XCHG_FLOATS);

  const int wg = threadIdx.x / WG;
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const uint32_t mine = bufs + 2 * wg * wide::SLICE3;
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

  float o[wide::HALF / 2];  // this warpgroup's half of O
  zero(o);
  float m[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
  if (n > 0) {
    // the slice step r of k-block it walks, into registers, and from them
    // into the buffer at dst
    using Regs = wide::SliceRegs<WG>;
    auto load = [&](int it, int r) {
      return wide::load_slice<WG>(
          (map::fwd_reads_v(r) ? v : k) +
              (kv_row + static_cast<size_t>(k_first + it) * BK) * wide::D,
          map::fwd_slice(wg, r), t);
    };
    auto store = [&](const Regs& x, uint32_t dst) {
      wide::store_slice<WG>(x, dst, t);
      wide::fence_async();
    };
    wide::split_rows(q + q_row * wide::D, qs);
    Regs pre = load(0, 0);
    store(pre, mine);
    __syncthreads();
    pre = load(0, 1);

    for (int it = 0; it < n; ++it) {
      const int k_start = (k_first + it) * BK;
      const bool full = map::tile_full(q_start, k_start, q_offset, p.causal,
                                       p.local_window);
      float sc[32];
      uint32_t kb[2], my_kb = 0;
      uint32_t pa[3][4][4];
#pragma unroll
      for (int r = 0; r < map::FWD_STEPS; ++r) {
        const uint32_t cur = mine + (r % 2) * wide::SLICE3;
        // while the step's products run: the next step's slice into the
        // other buffer (its products done: the last step's barrier), then
        // the registers loaded with the one after
        auto fill = [&] {
          if (r + 1 < map::FWD_STEPS || it + 1 < n)
            store(pre, mine + ((r + 1) % 2) * wide::SLICE3);
          if (r + 2 < map::FWD_STEPS || it + 1 < n)
            pre = load(it + (r + 2) / map::FWD_STEPS,
                       (r + 2) % map::FWD_STEPS);
        };
        if (!map::fwd_reads_v(r)) {
          // this warpgroup's partial S = Q K^T over the slice
          wgmma_fence();
          wide::score_slice<64>(sc, qs, map::fwd_slice(wg, r), cur, r == 0);
          wgmma_commit();
          if (r == 0)
            my_kb = wide::keep_fwd_rows<MODE>(p.dp, b, h, p.H, p.SQ, p.SK,
                                              q_start, k_start,
                                              map::fwd_keep_rows(wg));
          fill();
          wgmma_wait0();
          fence_acc(sc);
        } else {
          // O's 32 columns of the slice += P V
          float part[wide::SW / 2];
          wgmma_fence();
          wide::product_slice(part, pa, cur);
          wgmma_commit();
          fill();
          wgmma_wait0();
          fence_acc(part);
          const int blk = r - map::FWD_STEPS / 2;
#pragma unroll
          for (int i = 0; i < wide::SW / 2; ++i)
            o[(wide::SW / 2) * blk + i] += part[i];
        }
        if (r == map::FWD_STEPS / 2 - 1) {
          // the partial scores and keep words across; S = the sum of both
#pragma unroll
          for (int i = 0; i < 32; i += 4)
            *reinterpret_cast<float4*>(xs + map::fwd_xchg(wg, t, i)) =
                make_float4(sc[i], sc[i + 1], sc[i + 2], sc[i + 3]);
          xk[map::fwd_keep_xchg(wg, t)] = my_kb;
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            const float4 y = *reinterpret_cast<const float4*>(
                xs + map::fwd_xchg(1 - wg, t, i));
            sc[i] += y.x;
            sc[i + 1] += y.y;
            sc[i + 2] += y.z;
            sc[i + 3] += y.w;
          }
          const uint32_t other_kb = xk[map::fwd_keep_xchg(1 - wg, t)];
          kb[0] = wg == 0 ? my_kb : other_kb;
          kb[1] = wg == 0 ? other_kb : my_kb;
          __syncthreads();  // both read: the next k-block may write

          // online softmax on the fragment: element (hh, g, e) is
          // sc[4g+2hh+e]
          float alpha[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
            float mc = neg_big();
#pragma unroll
            for (int g = 0; g < 8; ++g)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float x = sc[4 * g + 2 * hh + e] * p.scale;
                if (!full && !score_valid(q_pos, k_start + 8 * g + 2 * c + e,
                                          p.causal, p.local_window))
                  x = neg_big();
                sc[4 * g + 2 * hh + e] = x;
                mc = fmaxf(mc, x);
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
          // O = O * alpha, then P V over the half's slices of V
#pragma unroll
          for (int i = 0; i < wide::HALF / 2; ++i)
            o[i] = o[i] * alpha[(i / 2) % 2];
          a_frags(sc, pa);
        }
        wide::wg_sync(wg);
      }
    }
  }

  float li[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) li[hh] = lsum[hh] == 0.f ? 1.f : lsum[hh];
#pragma unroll
  for (int i = 0; i < wide::HALF / 2; ++i)
    o[i] = o[i] / li[(i / 2) % 2] * p.dp.inv_keep;
  wide::store_half(p.o + q_row * wide::D, o);
  if (c == 0 && threadIdx.x < WG) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      p.lse[q_row + 16 * w + l / 4 + 8 * hh] = m[hh] + logf(li[hh]);
  }
}

// alignment slack, the Q triple, four slice triples, the exchange
constexpr int kWideSmemBytes =
    1024 + 3 * wide::TILE + 4 * wide::SLICE3 +
    4 * (wide_map::FWD_XCHG_FLOATS + wide_map::FWD_KEEP_WORDS);

// the D = 256 instance's launch, with repro_flash::fwd::run's checks
int run_wide(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int H, int KV, int SQ, int SK, float scale,
             int causal, int local_window, int mode, const void* plane,
             uint32_t threshold, float inv_keep, uint32_t key_lo,
             uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
             int heads_global, int rounds, cudaStream_t s) {
  constexpr int D = wide::D;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || SQ <= 0 || SK <= 0 ||
      SQ % BQ || SK % BK || heads_global <= 0 || align % 16 ||
      (mode == kPremask && plane == nullptr) ||
      (mode != kNone && mode != kPremask && mode != kCounters))
    return static_cast<int>(cudaErrorInvalidValue);
  const fwd::FwdArgs<float> p{
      static_cast<float*>(out), static_cast<float*>(lse), B, H, KV, SQ, SK,
      scale, causal, local_window,
      Dropout{static_cast<const int32_t*>(plane), threshold, key_lo, key_hi,
              salt, bh_offset, static_cast<uint32_t>(heads_global), rounds,
              inv_keep}};
  const auto kernel = mode == kNone      ? flash_fwd_kernel_wide<D, kNone>
                      : mode == kPremask ? flash_fwd_kernel_wide<D, kPremask>
                                         : flash_fwd_kernel_wide<D, kCounters>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(SQ / BQ, H, B), wide::THREADS, kWideSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out, lse <- flash attention of f32 q (B,H,SQ,D), k/v (B,KV,SK,D), all
// contiguous and on 16 bytes; out and lse f32; SQ and SK multiples of 64;
// D in {16, 32, 64, 128, 256}; mode 0 = none, 1 = premask (plane), 2 = counters
// (key words). Launches on `stream`; returns the CUDA error code (0 on
// success), cudaErrorInvalidValue for what it does not take or a tensor
// map that cuTensorMapEncodeTiled refuses (repro_flash::fwd::run).
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  if (D == repro_flash::wide::D)
    return run_wide(q, k, v, out, lse, B, H, KV, SQ, SK, scale, causal,
                    local_window, mode, plane, threshold, inv_keep, key_lo,
                    key_hi, salt, bh_offset, heads_global, rounds,
                    static_cast<cudaStream_t>(stream));
  return repro_flash::fwd::run<repro_flash::fwd::F32Ops>(
      q, k, v, out, lse, B, H, KV, SQ, SK, D, scale, causal, local_window,
      mode, plane, threshold, inv_keep, key_lo, key_hi, salt, bh_offset,
      heads_global, rounds, stream);
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_fwd_smem_bytes(int D) {
  if (D == repro_flash::wide::D) return kWideSmemBytes;
  return repro_flash::fwd::smem_bytes<repro_flash::fwd::F32Ops>(D);
}
