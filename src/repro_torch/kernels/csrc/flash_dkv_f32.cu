// Flash-attention dk / dv at f32 q/k/v/dO on Hopper's tensor cores, per
// query head, with the paper's dropout modes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_bwd.py::
// _dkv_kernel (flash_attention_bwd.py:137, pl.pallas_call at :288) at f32.
// The bf16 instance is csrc/flash_dkv_bf16.cu; dq at f32 is
// csrc/flash_dq_f32.cu.
//
// What it computes (flash_attention_bwd.py:10-15). With keep mask K, P =
// exp(S * scale - lse) recomputed from the forward's lse (invalid scores
// masked to neg_big() as in the forward) and Delta from the caller:
//     P_drop = K o P / (1-p),   dP = K / (1-p) o (dO V^T),
//     dS = P o (dP - Delta) * scale,   dV = P_drop^T dO,   dK = dS^T Q.
// Every product has f32 operands on both sides. Each is the sum of the six
// bf16 part products of the operands' exact triples that reach 2^-16
// (flash_sm90.cuh), with f32 sums. dk and dv are written per query head,
// each element by one thread, no atomics: a training step stays bitwise
// reproducible, and the GQA group sum stays in torch.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the four
// products of the valid half are 137 GFLOP; six bf16 products apiece are
// 0.83 ms at 989 TFLOP/s (2.05 ms at the f32 SIMT rate of 67 TFLOP/s);
// the exponentials, the replayed keep bits and the splits are SIMT work
// (the first two 0.07 ms at the issue rate); the operands, dk and dv 0.40
// GB (0.12 ms at 3.35 TB/s).
//
// The design is flash_dkv_bf16.cu's with every operand tile split: one
// warpgroup (128 threads) a CTA per (64 keys, head, batch), walking the
// q-blocks that hold a valid score. The f32 tiles come by TMA into one
// staging tile (plain rows), the rows' lse and Delta by bulk copies, and
// the threads split the tiles into bf16 triples (split_tile) in the
// swizzled layout the products read: K and V once, then each q-block's Q
// and dO. The CTA computes the transposed tiles directly: S^T = K Q^T and
// dP^T = V dO^T, the six part products each with both sides K-major in
// shared memory, so the keys are the accumulator rows; the keep bits are
// made under both, P's exponentials under dP^T. Their fragments' triples
// become the register A operands of dK += dS^T Q and then dV += P_drop^T
// dO (Q and dO read MN-major, the transpose bit; dK first: in the other
// order ptxas interleaved dS with P_drop's split and spilled). Once dK is
// done the Q triple is free and the next q-block's Q (its TMA issued a
// q-block earlier, with its lse and Delta) is split into it; dO's TMA then
// fills the stage while dV runs, and is split once dV is done. dK and dV
// stay in registers (D / 2 floats each a thread); each q-block's products
// are products of their own (32 columns at a time at D = 128: with 64 the
// accumulators spilled), folded into dK and dV by f32 adds as the JAX
// kernel folds its blocks. Shared memory: the K, V, Q and dO triples (192
// KB at D = 128), the f32 staging tile with its lse and Delta (32.5 KB)
// and this q-block's lse and Delta, 226 KB -- one CTA an SM, as the SIMT
// kernel it replaces.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_f32_wide.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace repro_flash;
using namespace repro_flash::tc;

struct DkvArgs {
  const float* lse;
  const float* delta;
  float* dk;  // (B, H, SK, D): per query head
  float* dv;
  int B, H, KV, SQ, SK;
  float scale;
  int causal, local_window;
  Dropout dp;
};

// columns of one chunk of the dK and dV products: 32 at D = 128 (16
// floats a thread), where 64 spilled
template <int D>
__host__ __device__ constexpr int dkv_chunk() {
  return D == 128 ? 32 : chunk_cols<D>();
}

template <int D>
constexpr int dkv_smem_bytes() {
  // alignment slack, the K, V, Q and dO triples, the f32 staging tile and
  // its 64 lse and 64 Delta values, this q-block's lse and Delta, two
  // mbarriers
  return 1024 + 12 * tile_bytes<D>() + tile_bytes32<D>() + 2 * 512 + 16;
}

template <int D, int MODE>
__global__ void __launch_bounds__(WG, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, DkvArgs p) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int TILE32 = tile_bytes32<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + 3 * TILE;  // each triple hi, mid, lo
  const uint32_t qs = vs + 3 * TILE;
  const uint32_t dos = qs + 3 * TILE;
  const uint32_t stage = dos + 3 * TILE;  // f32 tile, then lse, Delta
  const uint32_t rows = stage + TILE32 + 512;  // this q-block's
  const uint32_t bar = rows + 512;  // the first loads', then the stage's
  const float* lse_s =
      reinterpret_cast<const float*>(smem_raw + (rows - raw));
  const float* delta_s = lse_s + 64;

  const int t = threadIdx.x, w = t / 32, l = t % 32, c = l % 4;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int k_start = ki * BK;
  const int q_offset = p.SK - p.SQ;
  const int q_row = (b * p.H + h) * p.SQ;

  // the q-blocks that hold a valid score: one contiguous run
  int q_first = 0, n = 0;
  for (int qi = 0; qi < p.SQ / BQ; ++qi)
    if (tile_runs(qi * BQ, k_start, q_offset, p.causal, p.local_window)) {
      if (n == 0) q_first = qi;
      ++n;
    }

  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  if (n > 0) {
    if (t == 0) {
      for (int i = 0; i < 2; ++i) mbar_init(bar + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t br,
                    int row) { tma_load<false>(dst, map, br, 0, row, 0); };
    // the next q-block's Q, lse and Delta into the stage
    auto load_q = [&](int q_start) {
      mbar_expect_tx(bar + 8, TILE32 + 512);
      load(stage, &map_q, bar + 8, q_row + q_start);
      bulk_load(stage + TILE32, p.lse + q_row + q_start, 256, bar + 8);
      bulk_load(stage + TILE32 + 256, p.delta + q_row + q_start, 256,
                bar + 8);
    };
    // K into the stage, V into the Q triple's space and the first Q into
    // the dO triple's far end, the first lse and Delta aside: split into
    // their triples in turn, each source read before its space is written
    if (t == 0) {
      const int kv_row = (b * p.KV + kvh) * p.SK + k_start;
      const int q0 = q_row + q_first * BQ;
      mbar_expect_tx(bar, 3 * TILE32 + 512);
      load(stage, &map_k, bar, kv_row);
      load(qs, &map_v, bar, kv_row);
      load(qs + 4 * TILE, &map_q, bar, q0);
      bulk_load(rows, p.lse + q0, 256, bar);
      bulk_load(rows + 256, p.delta + q0, 256, bar);
    }
    mbar_wait_or_trap(bar, 0);
    split_tile<D>(stage, ks);
    split_tile<D>(qs, vs);
    __syncthreads();
    uint32_t ph = 0;  // completed phases of the stage's barrier
    if (t == 0) {
      mbar_expect_tx(bar + 8, TILE32);
      load(stage, &map_do, bar + 8, q_row + q_first * BQ);
    }
    split_tile<D>(qs + 4 * TILE, qs);
    mbar_wait_or_trap(bar + 8, ph++ & 1);
    __syncthreads();
    split_tile<D>(stage, dos);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t == 0 && n > 1) load_q((q_first + 1) * BQ);

    for (int it = 0; it < n; ++it) {
      const int q_start = (q_first + it) * BQ;
      // S^T = K Q^T, then dP^T = V dO^T, committed apart (rows are keys,
      // columns queries): the keep bits are made under both products,
      // P's exponentials under the dP^T product
      float st[32], dpt[32];  // replaced by their first products
      wgmma_fence();
      score6<D>(st, ks, qs);
      wgmma_commit();
      score6<D>(dpt, vs, dos);
      wgmma_commit();
      uint32_t kb[2];
      keep_dkv<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start, k_start, kb);
      wgmma_wait1();
      fence_acc(st);

      // element i = 4 g + 2 hh + e: key k_start + 16w + l/4 + 8hh, query
      // q_start + 8g + 2c + e; st becomes P, then P_drop, dpt dS * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        const int key = k_start + 16 * w + l / 4 + 8 * hh;
        const int qc = 8 * g + 2 * c + e;
        float sc = st[i] * p.scale;
        if ((p.causal || p.local_window > 0) &&
            !score_valid(q_start + qc + q_offset, key, p.causal,
                         p.local_window))
          sc = neg_big();
        st[i] = expf(sc - lse_s[qc]);
      }
      wgmma_wait0();
      fence_acc(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        const int qc = 8 * g + 2 * c + e;
        const float pr = st[i];
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

      // dK += dS^T Q, both sides as triples: each q-block's product is
      // one of its own, folded into dK by f32 adds; dS's fragments are
      // released before P_drop's are made
      uint32_t a[3][4][4];
      a_frags(dpt, a);
      add_product6<D, dkv_chunk<D>()>(dk, a, qs);

      // every warp's dK products and reads of lse and Delta are done: the
      // next q-block's Q into the free Q triple and its rows' lse and
      // Delta aside, then its dO into the stage while dV runs
      const bool next = it + 1 < n;
      if (next) {
        mbar_wait_or_trap(bar + 8, ph++ & 1);
        __syncthreads();
        split_tile<D>(stage, qs);
        st_shared_f1(rows + 4 * t, ld_shared_f1(stage + TILE32 + 4 * t));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (t == 0) {
          mbar_expect_tx(bar + 8, TILE32);
          load(stage, &map_do, bar + 8, q_row + q_start + BQ);
        }
      }

      // dV += P_drop^T dO, folded in the same way
      a_frags(st, a);
      add_product6<D, dkv_chunk<D>()>(dv, a, dos);

      // every warp's dV products are done: the next dO into its triple,
      // then the Q, lse and Delta after it into the stage
      if (next) {
        mbar_wait_or_trap(bar + 8, ph++ & 1);
        __syncthreads();
        split_tile<D>(stage, dos);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (t == 0 && it + 2 < n) load_q(q_start + 2 * BQ);
      }
    }
  }

  const size_t row0 = (static_cast<size_t>(b) * p.H + h) * p.SK + k_start +
                      16 * w + l / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* krow = p.dk + (row0 + 8 * hh) * D;
    float* vrow = p.dv + (row0 + 8 * hh) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      *reinterpret_cast<float2*>(krow + 8 * g + 2 * c) =
          make_float2(dk[4 * g + 2 * hh], dk[4 * g + 2 * hh + 1]);
      *reinterpret_cast<float2*>(vrow + 8 * g + 2 * c) =
          make_float2(dv[4 * g + 2 * hh], dv[4 * g + 2 * hh + 1]);
    }
  }
}

template <int D, int MODE>
int launch(const CUtensorMap (&maps)[4], const DkvArgs& p, cudaStream_t s) {
  constexpr int smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_kernel<D, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SK / BK, p.H, p.B), WG, smem, s>>>(maps[0], maps[1],
                                                     maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_d(const void* q, const void* k, const void* v, const void* dout,
          const DkvArgs& p, int mode, cudaStream_t s) {
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

namespace map = wide_map;

// A CTA of the D = 256 instance: where its tiles and rows lie, and its
// walks over the q-blocks (flash_dkv_kernel_wide)
template <int MODE>
struct DkvWide {
  const float* q;
  const float* dout;
  const DkvArgs& p;  // the kernel's own (__grid_constant__): no copy
  // K, V triples; the slice buffers; this q-block's 64 lse, then 64 Delta;
  // the exchange; a zero word
  uint32_t ks, vs, buf, rows, xchg, zero_word;
  int tid, wg, t, c;
  int k_start, q_offset, b, h;
  int key0, q0;      // this thread's first key; its warpgroup's first query
  uint32_t my_rows;  // the warpgroup's rows of a slice (its score B)
  size_t q_row;
  map::Run run;

  // the 64 rows that step r of q-block it walks, the address read after
  // the barrier before it (ld_shared_u32 of the zero word)
  __device__ __forceinline__ const float* block(int it, int r) const {
    return (map::dkv_reads_do(r) ? dout : q) +
           (q_row + static_cast<size_t>(run.first + it) * BQ) * wide::D +
           wide::ld_shared_u32(zero_word);
  }

  __device__ __forceinline__ float kept(float x, const uint32_t (&kb)[2],
                                        int i) const {
    const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
    if (MODE == kNone) return x;
    return ((kb[hh] >> (2 * g + e)) & 1u) ? x * p.dp.inv_keep : 0.f;
  }

  // this warpgroup's half of a 64 x 64 fragment across (the first
  // warpgroup writes, the second reads and writes, the first reads), then
  // the whole fragment's triple
  __device__ __forceinline__ void across(const float (&mine)[16],
                                         uint32_t (&a)[3][4][4]) const {
    float other[16];
    auto slot = [&](int i) { return xchg + 4 * map::dkv_xchg(t, i); };
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) st_shared_f1(slot(i), mine[i]);
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        other[i] = ld_shared_f1(slot(i));
        st_shared_f1(slot(i), mine[i]);
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) other[i] = ld_shared_f1(slot(i));
    }
    float full[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      full[map::dkv_full(0, i)] = wg == 0 ? mine[i] : other[i];
      full[map::dkv_full(1, i)] = wg == 0 ? other[i] : mine[i];
    }
    a_frags(full, a);
  }

  // One walk over the q-blocks into acc, this warpgroup's half of dV (DV:
  // its dO phase's products) or of dK (dP^T, then dK over Q's slices;
  // map::dkv_steps)
  template <bool DV>
  __device__ __forceinline__ void walk(float (&acc)[wide::HALF / 2]) const {
    constexpr bool DK = !DV;
    constexpr int STEPS = map::dkv_steps(DK);
    for (int it = 0; it < run.n; ++it) {
      const int q_start = (run.first + it) * BQ;
      const bool full = map::tile_full(q_start, k_start, q_offset, p.causal,
                                       p.local_window);
      float pr[16], dpt[16];  // this warpgroup's S^T, then P; dP^T, dS^T
      uint32_t kb[2];
      uint32_t a[3][4][4];  // P_drop^T's triple, or dS^T's
#pragma unroll
      for (int r = 0; r < STEPS; ++r) {
        const int s = map::dkv_slice(r);
        const bool own = map::dkv_owner(s) == wg;
        // the step's two slices into the buffer once every product on it
        // is done, visible to the tensor cores (block() reads the zero
        // word: the loads stay behind the barrier)
        __syncthreads();
        wide::SliceRegs<wide::THREADS> x[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          x[j] = wide::load_slice<wide::THREADS>(
              block(it, r), s + j, tid);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wide::store_slice<wide::THREADS>(x[j], buf + j * wide::SLICE3,
                                           tid);
        wide::fence_async();
        __syncthreads();
        if (map::dkv_phase(r) == 0) {
          // S^T of this warpgroup's queries over the two slices
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wide::score_slice<32>(pr, ks, s + j,
                                  buf + j * wide::SLICE3 + my_rows,
                                  r == 0 && j == 0);
          wgmma_commit();
          if (r == 0) {
            keep_dkv_half<MODE>(p.dp, b, h, p.H, p.SQ, p.SK,
                                      q_start + q0, k_start, kb);
            if (tid < 64)
              st_shared_f1(rows + 4 * tid, p.lse[q_row + q_start + tid]);
            else if (tid < 128)
              st_shared_f1(rows + 4 * tid,
                           p.delta[q_row + q_start + tid - 64]);
          }
          wgmma_wait0();
          fence_acc(pr);
        } else if (DK && map::dkv_phase(r) == 1) {
          // dP^T of this warpgroup's queries over the two slices
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wide::score_slice<32>(dpt, vs, s + j,
                                  buf + j * wide::SLICE3 + my_rows,
                                  r == map::DKV_PHASE && j == 0);
          wgmma_commit();
          wgmma_wait0();
          fence_acc(dpt);
        } else {
          // dV (over dO's slices) or dK (over Q's) of their 64 columns by
          // the warpgroup that owns them
          float part[wide::SW];
          if (own) {
            wgmma_fence();
            wide::product_pair(part, a, buf);
            wgmma_commit();
          }
          if (own) {
            wgmma_wait0();
            fence_acc(part);
#pragma unroll
            for (int i = 0; i < wide::SW; ++i)
              acc[wide::SW * map::dkv_block(s) + i] += part[i];
          }
        }
        if (r == map::DKV_PHASE - 1) {
          // P of this warpgroup's queries (element i = 4 g + 2 hh + e: key
          // key0 + 8 hh, query q_start + q0 + 8 g + 2 c + e); P_drop
          // across (DV)
          float pd[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
            const int qc = q0 + 8 * g + 2 * c + e;
            float x = pr[i] * p.scale;
            if (!full && !score_valid(q_start + qc + q_offset, key0 + 8 * hh,
                                      p.causal, p.local_window))
              x = neg_big();
            pr[i] = expf(x - ld_shared_f1(rows + 4 * qc));
            pd[i] = kept(pr[i], kb, i);
          }
          if (DV) across(pd, a);
        } else if (DK && r == 2 * map::DKV_PHASE - 1) {
          // dS^T of this warpgroup's queries, across
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int g = i / 4, e = i % 2;
            const int qc = q0 + 8 * g + 2 * c + e;
            dpt[i] = pr[i] *
                     (kept(dpt[i], kb, i) - ld_shared_f1(rows + 256 + 4 * qc)) *
                     p.scale;
          }
          across(dpt, a);
        }
      }
    }
  }
};

// The D = 256 instance (flash_f32_wide.cuh), split by queries: two
// warpgroups on the same 64 keys, warpgroup wg taking the 32 queries
// dkv_query0(wg) .. of every score tile and owning D's columns 128 wg ..
// of dK and dV (flash_wide_map.cuh). K and V are split once into their
// triples. The CTA walks its q-blocks twice, in steps of two 32-column
// slices that its 256 threads split into the one pair of slice buffers
// between two barriers. The first walk makes dV: Q's slices for S^T = K
// Q^T (each warpgroup an m64n32 product of its queries over the full D,
// its keep bits made under the first step), P and P_drop of its queries,
// P_drop^T's halves crossing through shared memory into the whole 64 x 64
// fragment's triple, then dO's slices, each pair one m64n64 product dV +=
// P_drop^T dO by the warpgroup that owns both (folded in by f32 adds). The
// second makes dK: S^T again, dP^T = V dO^T over dO's slices, dS^T across
// the same way, dK += dS^T Q over Q's slices. Five products a pair where
// both warpgroups running every score product took eight; the score
// products' halves cost about what whole ones did, so the gain is the
// output products' width and the fewer walked slices. What was tried and
// lost (PERF.md): one walk making both (four products) held dK, dV, P,
// dP^T and the triple at once, spilled 1.4 KB at 255 registers and crashed
// ptxas; one-slice steps (m64n32 output products) ran slower; splitting
// the next step's slices under the products (two pairs of buffers, in V's
// space during the dV walk) or loading them a step ahead gained nothing
// and spilled. The loads read their address after the step's first
// barrier (the zero word, DkvWide::block): ptxas otherwise hoisted the
// read-only loads of later steps above the barriers and spilled. Shared
// memory: the K and V triples (192 KB), the pair of slice triples (24 KB),
// this q-block's lse and Delta, the exchange (8 KB: the first warpgroup
// writes its half, the second takes it and leaves its own in the same
// floats) and the zero word, 230,928 bytes -- one CTA an SM; 227-241
// registers, no spill. A kernel of its own, so that the instances above
// keep their machine code.
template <int D, int MODE>
__global__ void __launch_bounds__(wide::THREADS, 1)
    flash_dkv_kernel_wide(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const __grid_constant__ DkvArgs p) {
  static_assert(D == wide::D, "the wide instance is the D = 256 one");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + 3 * wide::TILE;  // each triple hi, mid, lo
  const uint32_t buf = vs + 3 * wide::TILE;  // two slice triples
  const uint32_t rows = buf + 2 * wide::SLICE3;  // 64 lse, then 64 Delta
  const uint32_t zero_word = rows + 512 + 4 * map::DKV_XCHG_FLOATS;
  if (threadIdx.x == 0) wide::st_shared_u32(zero_word, 0);

  // the warpgroup, uniform across each warp to the compiler (CUTLASS's
  // canonical_warp_group_idx): products under a branch on it are not then
  // serialized (ptxas's C7518)
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int t = tid % WG, w = t / 32, l = t % 32;
  const int ki = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int k_start = ki * BK;
  const int q_offset = p.SK - p.SQ;
  const size_t bh = static_cast<size_t>(b) * p.H + h;
  const size_t kv_row = static_cast<size_t>(b * p.KV + kvh) * p.SK + k_start;
  const int q0 = map::dkv_query0(wg);
  float* dk_rows = p.dk + (bh * p.SK + k_start) * wide::D;
  float* dv_rows = p.dv + (bh * p.SK + k_start) * wide::D;
  const DkvWide<MODE> cta{
      q, dout, p, ks, vs, buf, rows, rows + 512, zero_word, tid, wg, t,
      l % 4, k_start, q_offset, b, h, k_start + 16 * w + l / 4, q0,
      static_cast<uint32_t>(q0 * wide::SW * 2), bh * p.SQ,
      map::q_run(k_start, p.SQ, q_offset, p.causal, p.local_window)};

  // this warpgroup's half of dV, then of dK, each zeroed where its walk
  // begins (zeros kept through the other walk were spilled)
  float acc[wide::HALF / 2];
  zero(acc);
  if (cta.run.n > 0) {
    // fenced, and the zero word seen, by the first step's barriers
    wide::split_rows(k + kv_row * wide::D, ks);
    wide::split_rows(v + kv_row * wide::D, vs);
    cta.template walk<true>(acc);
  }
  wide::store_half(dv_rows, acc);
  zero(acc);
  if (cta.run.n > 0) cta.template walk<false>(acc);
  wide::store_half(dk_rows, acc);
}

// alignment slack, the K and V triples, two slice triples, a q-block's lse
// and Delta, the exchange, the zero word (on 16 bytes)
constexpr int kWideSmemBytes = 1024 + 6 * wide::TILE + 2 * wide::SLICE3 +
                               512 + 4 * wide_map::DKV_XCHG_FLOATS + 16;

int launch_wide(const void* q, const void* k, const void* v,
                const void* dout, const DkvArgs& p, int mode,
                cudaStream_t s) {
  constexpr int D = wide::D;
  if (mode != kNone && mode != kPremask && mode != kCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mode == kNone      ? flash_dkv_kernel_wide<D, kNone>
                      : mode == kPremask ? flash_dkv_kernel_wide<D, kPremask>
                                         : flash_dkv_kernel_wide<D, kCounters>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.SK / BK, p.H, p.B), wide::THREADS, kWideSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dk, dv (B,H,SK,D) per query head, f32, from f32 q (B,H,SQ,D), k/v
// (B,KV,SK,D), dout (B,H,SQ,D), lse and delta (B,H,SQ), all contiguous and
// on 16 bytes; SQ and SK multiples of 64; D in {16, 32, 64, 128, 256}; the
// arguments of repro_flash_dq (flash_dq_f32.cu). dq is not written.
// Launches on `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_dkv(
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
                  static_cast<const float*>(delta), static_cast<float*>(dk),
                  static_cast<float*>(dv),
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
extern "C" int repro_flash_dkv_smem_bytes(int D) {
  switch (D) {
    case 16: return dkv_smem_bytes<16>();
    case 32: return dkv_smem_bytes<32>();
    case 64: return dkv_smem_bytes<64>();
    case 128: return dkv_smem_bytes<128>();
    case 256: return kWideSmemBytes;
    default: return 0;
  }
}
