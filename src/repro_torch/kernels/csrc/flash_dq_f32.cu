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

// ------------------------------------------------- the D = 256 instance
//
// Two warpgroups on the same 64 query rows, the score products split
// between them by D (flash_wide_map.cuh: dq_slice), as in the forward's
// wide kernel: warpgroup wg reduces partial S = Q K^T and dP = dO V^T over
// its own 128 columns of D (m64n64, the part products chained over them),
// the partials cross through shared memory (two rounds of 16 floats a
// thread through one 8 KB region) and both add them -- x + y == y + x, so
// both hold the same S and dP -- and each makes the whole dS and dq += dS K
// over its own 128 output columns (m64n32 a slice, each slice's product
// folded into dq by f32 adds). A warpgroup thus touches only its own half
// of K and V: per k-block twelve slices of 32 columns, K's four for S, V's
// four for dP, K's four again for dS K.
//
// The walked slices come split. flash_dq_kernel_triples first writes K and
// V, once a call, as their exact bf16 triples (split3) into a workspace in
// device memory, each 64 x 32 part of a slice one 4 KB run already in the
// slice buffer's 64-byte swizzle (flash_wide_map.cuh: dq_ws_part). Each
// warpgroup then owns one slice triple in shared memory, a ring of three
// part stages (hi, mid, lo) with full and empty mbarriers: its thread 0
// issues each part by one bulk copy (TMA), and a step's products run in
// three groups by the slice's part (lo, then mid, then hi), each committed
// apart, so each part goes back -- and the next step's part is issued into
// it -- as soon as its group is done, under the rest of the step. No
// thread loads or splits a walked slice, and no step waits at a CTA
// barrier; the exchanges are the only ones (four a k-block).
//
// The score products take Q's and dO's parts from registers (ldmatrix,
// once a step: m64n64k16 with A from registers, B K-major): read by each
// product from shared memory, A and B together were 4 KB a product, more
// than shared memory gives the tensor cores at their rate. Each warpgroup
// makes the keep bits of one row group (keep_fwd_rows), which cross with
// S; a k-block's are made under the first dq step of the k-block before.
// P is made under dP's first step. Q and dO are split once a CTA into the
// triples it keeps (split_rows). Shared memory: the Q and dO triples (192
// KB), two slice triples (24 KB), the exchanges (8 KB and 1 KB), twelve
// mbarriers: 231,520 bytes -- one CTA an SM. A kernel of its own, so that
// the instances above keep their machine code.
namespace split {

namespace map = repro_flash::wide_map;
using wide::D;
using wide::SLICE;
using wide::SW;

// the slice triple's part a group of a step reads, groups in order
__device__ __forceinline__ constexpr int group_part(int g) { return 2 - g; }

// d (+)= A B^T, m64n64k16 with A (64 x 16 bf16) from registers and B (64
// rows n x 16 k bf16) K-major in shared memory, f32 sums; d is replaced
// when `accumulate` is 0
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The A fragments of slice s of D (its k16 slices 2 s, 2 s + 1) of each
// part of the 64 x 256 triple at `a` (parts TILE apart, load_tile's layout:
// 64-column boxes of 128-byte rows in the 128-byte swizzle), one ldmatrix
// x4 each: a[part][j] the m64k16 A operand of k16 slice 2 s + j (its warp's
// rows 16 w ..). Read once a step, where the products read them from
// shared memory once each.
__device__ __forceinline__ void load_a(uint32_t (&a)[3][2][4], uint32_t at,
                                       int s) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x % WG) / 32;
  const int mat = lane / 8;  // 0: rows 0-7, k 0-7; 1: rows 8-15; 2, 3: k 8-15
  const int row = 16 * w + lane % 8 + 8 * (mat & 1);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * (2 * s + j) + 8 * (mat >> 1);
      const uint32_t addr = at + p * wide::TILE + (col / 64) * 64 * 128 +
                            swizzle<128>(row * 128 + (col % 64) * 2);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
          : "=r"(a[p][j][0]), "=r"(a[p][j][1]), "=r"(a[p][j][2]),
            "=r"(a[p][j][3])
          : "r"(addr)
          : "memory");
    }
}

// One group of a score step: d (+)= A B^T over the slice for the A parts
// that meet B part BP (lo: hi; mid: mid, hi; hi: lo, mid, hi, smallest
// first), A the fragments of load_a, B the slice triple at b (parts SLICE
// apart), K-major; d replaced by the first product when `first`
template <int BP>
__device__ __forceinline__ void score_group(float (&d)[32],
                                               const uint32_t (&a)[3][2][4],
                                               uint32_t b, bool first) {
  constexpr int N = 3 - BP;
  const uint64_t db = pinned(desc_k<SW>(b, 0));
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_rs_n64_kmajor(d, a[N - 1 - i][j],
                          desc_at(db, BP * SLICE + slice_bytes<SW>(j)),
                          !first || BP != 2 || j > 0);
}

// One group of a dq step: d (+)= A B for A the triple of the 64 x 64 dS
// fragment (a_frags) and B part BP of the slice triple at b, read MN-major
// (its rows keys): the A parts that meet BP, smallest first, over the four
// k16 slices; d replaced by the first product of the step.
template <int BP>
__device__ __forceinline__ void dq_group(float (&d)[SW / 2],
                                         const uint32_t (&a)[3][4][4],
                                         uint32_t b) {
  constexpr int N = 3 - BP;
  const uint64_t db = pinned(desc_mn<SW>(b, 0));
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs<SW>(d, a[N - 1 - i][j],
                   desc_at(db, BP * SLICE + j * 16 * row_bytes<SW>()),
                   BP != 2 || j > 0);
}

// A warpgroup's ring: its slice triple at buf, the full and empty
// barriers of part p at full + 8 p and empty + 8 p; `u` counts its steps
// (step u fills and empties each barrier's phase u)
struct Ring {
  const uint8_t* ws;
  int blocks, kb0, wg;
  bool loader;  // thread 0 of the warpgroup
  uint32_t buf, full, empty;
  uint32_t u;

  // part p of step r of the walk's k-block `it` into the buffer
  __device__ __forceinline__ void issue(int it, int r, int p) const {
    const uint32_t bar = full + 8 * p;
    mbar_expect_tx(bar, SLICE);
    bulk_load(buf + p * SLICE,
              ws + map::dq_ws_part(map::dq_reads_v(r), blocks, kb0 + it,
                                   map::dq_slice(wg, r), p),
              SLICE, bar);
  }

  // Issues a step's products: `groups(g)` issues group g, each group once
  // its part has landed, each committed apart
  template <class Groups>
  __device__ __forceinline__ void run(const Groups& groups) const {
    const uint32_t ph = u & 1;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      mbar_wait_spin(full + 8 * group_part(g), ph);
      wgmma_fence();
      groups(g);
      wgmma_commit();
    }
  }

  // Waits for the products of step r of k-block `it` (of the walk's n)
  // group by group: each group's part goes back once every warp is done
  // with it, and thread 0 issues the next step's part into it
  __device__ __forceinline__ void retire(int n, int it, int r) {
    const uint32_t ph = u & 1;
    const bool last = r + 1 == map::DQ_STEPS;
    const bool next = !last || it + 1 < n;
    const int nit = last ? it + 1 : it, nr = last ? 0 : r + 1;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (g == 0)
        wgmma_wait2();
      else if (g == 1)
        wgmma_wait1();
      else
        wgmma_wait0();
      const int p = group_part(g);
      if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * p);
      if (loader && next) {
        mbar_wait_spin(empty + 8 * p, ph);
        issue(nit, nr, p);
      }
    }
    ++u;
  }
};

// the groups of a score step over the slice, A from registers (load_a)
struct Scores {
  float (&d)[32];
  const uint32_t (&a)[3][2][4];
  uint32_t b;
  bool first;
  __device__ __forceinline__ void operator()(int g) const {
    if (g == 0)
      score_group<2>(d, a, b, first);
    else if (g == 1)
      score_group<1>(d, a, b, first);
    else
      score_group<0>(d, a, b, first);
  }
};

// the groups of a score step over slice s of D, A the triple at a (frags:
// its fragments, read by the products in flight until the step retires)
__device__ __forceinline__ void run_scores(const Ring& ring, float (&d)[32],
                                           uint32_t (&frags)[3][2][4],
                                           uint32_t a, int s, bool first) {
  load_a(frags, a, s);
  ring.run(Scores{d, frags, ring.buf, first});
}

// the groups of a dq step: d = dS B, dS the register triple a, B the slice
// triple at b
struct DqProducts {
  float (&d)[SW / 2];
  const uint32_t (&a)[3][4][4];
  uint32_t b;
  __device__ __forceinline__ void operator()(int g) const {
    if (g == 0)
      dq_group<2>(d, a, b);
    else if (g == 1)
      dq_group<1>(d, a, b);
    else
      dq_group<0>(d, a, b);
  }
};

// the partial score tile s of this warpgroup plus the other's, the same sum
// in both (map::dq_xchg; named barrier 1 across both warpgroups); with
// keep words (xk non-null), also this warpgroup's word of its row group
// (map::fwd_keep_rows) across: kb[hh] the word of row group hh
__device__ __forceinline__ void exchange(float (&s)[32], float* xs, int wg,
                                         int t, uint32_t* xk = nullptr,
                                         uint32_t my_kb = 0,
                                         uint32_t* kb = nullptr) {
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    if (wg == 0) {
#pragma unroll
      for (int i = 16 * round; i < 16 * round + 16; i += 4)
        *reinterpret_cast<float4*>(xs + map::dq_xchg(t, i)) =
            make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
    }
    if (xk && round == 0) xk[map::fwd_keep_xchg(wg, t)] = my_kb;
    named_sync(1, wide::THREADS);
    if (wg == 1) {
#pragma unroll
      for (int i = 16 * round; i < 16 * round + 16; i += 4) {
        const float4 y =
            *reinterpret_cast<const float4*>(xs + map::dq_xchg(t, i));
        *reinterpret_cast<float4*>(xs + map::dq_xchg(t, i)) =
            make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
        s[i] += y.x;
        s[i + 1] += y.y;
        s[i + 2] += y.z;
        s[i + 3] += y.w;
      }
    }
    if (xk && round == 0) {
      const uint32_t other = xk[map::fwd_keep_xchg(1 - wg, t)];
      // row group wg's word is this warpgroup's (map::fwd_keep_rows)
      kb[0] = wg == 0 ? my_kb : other;
      kb[1] = wg == 0 ? other : my_kb;
    }
    named_sync(1, wide::THREADS);
    if (wg == 0) {
#pragma unroll
      for (int i = 16 * round; i < 16 * round + 16; i += 4) {
        const float4 y =
            *reinterpret_cast<const float4*>(xs + map::dq_xchg(t, i));
        s[i] += y.x;
        s[i + 1] += y.y;
        s[i + 2] += y.z;
        s[i + 3] += y.w;
      }
    }
  }
}

// warpgroup wg's keep word (its row group, map::fwd_keep_rows) of the
// k-block at k_start
template <int MODE>
__device__ __forceinline__ uint32_t keep_word(const DqArgs& p, int b, int h,
                                              int q_start, int k_start,
                                              int wg) {
  if (MODE == kNone) return 0xFFFFu;
  return wide::keep_fwd_rows<MODE>(p.dp, b, h, p.H, p.SQ, p.SK, q_start,
                                   k_start, map::fwd_keep_rows(wg));
}

}  // namespace split

// K and V (each rows x D f32, rows = B KV SK) as their exact bf16 triples
// (split3) in dq's workspace (flash_wide_map.cuh: dq_ws_byte): one CTA a
// k-block of K (blockIdx.y 0) or V (1), eight 8-value units a thread
template <int D>
__global__ void __launch_bounds__(wide::THREADS)
    flash_dq_kernel_triples(const float* __restrict__ k,
                            const float* __restrict__ v,
                            uint8_t* __restrict__ ws, int blocks) {
  static_assert(D == wide::D, "the workspace's triples are D = 256 ones");
  namespace map = repro_flash::wide_map;
  const bool is_v = blockIdx.y != 0;
  const int kb = blockIdx.x;
  const float* src = (is_v ? v : k) + static_cast<size_t>(kb) * BK * D;
#pragma unroll 2
  for (int i = 0; i < BK * D / 8 / wide::THREADS; ++i) {
    const int unit = threadIdx.x + wide::THREADS * i;
    const int row = unit / (D / 8), col = 8 * (unit % (D / 8));
    const wide::Unit x = wide::load_unit(src + row * D + col);
    uint4 parts[3];
    split3(x.x.x, x.x.y, parts[0].x, parts[1].x, parts[2].x);
    split3(x.x.z, x.x.w, parts[0].y, parts[1].y, parts[2].y);
    split3(x.y.x, x.y.y, parts[0].z, parts[1].z, parts[2].z);
    split3(x.y.z, x.y.w, parts[0].w, parts[1].w, parts[2].w);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(
          ws + map::dq_ws_byte(is_v, blocks, kb, row, col, p)) = parts[p];
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(wide::THREADS, 1)
    flash_dq_kernel_split(const float* __restrict__ q,
                          const float* __restrict__ dout,
                          const uint8_t* __restrict__ ws, DqArgs p) {
  static_assert(D == wide::D, "the split instance is the D = 256 one");
  namespace map = repro_flash::wide_map;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;
  const uint32_t dos = qs + 3 * wide::TILE;   // each triple hi, mid, lo
  const uint32_t bufs = dos + 3 * wide::TILE;  // a slice triple a wg
  const uint32_t xchg = bufs + 2 * wide::SLICE3;
  // the keep words' exchange, then six mbarriers a warpgroup
  const uint32_t bars = xchg + 4 * (map::DQ_XCHG_FLOATS + map::FWD_KEEP_WORDS);
  float* xs = reinterpret_cast<float*>(smem_raw + (xchg - raw));
  uint32_t* xk = reinterpret_cast<uint32_t*>(xs + map::DQ_XCHG_FLOATS);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
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
    split::Ring ring{ws,
                     p.B * p.KV * p.SK / BK,
                     static_cast<int>(kv_row / BK) + k_first,
                     wg,
                     t == 0,
                     bufs + wg * wide::SLICE3,
                     bars + 48 * wg,
                     bars + 48 * wg + 24,
                     0u};
    if (t == 0) {
      for (int i = 0; i < 3; ++i) {
        mbar_init(ring.full + 8 * i, 1);
        mbar_init(ring.empty + 8 * i, WG / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < 3; ++i) ring.issue(0, 0, i);
    }
    float lse[2], delta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lse[hh] = p.lse[row0 + 8 * hh];
      delta[hh] = p.delta[row0 + 8 * hh];
    }
    wide::split_rows(q + q_row * D, qs);
    wide::split_rows(dout + q_row * D, dos);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // this warpgroup's keep word (its row group) of the first k-block
    // now, each next one's under a k-block's dq products
    uint32_t my_kb = split::keep_word<MODE>(p, b, h, q_start, k_first * BK,
                                            wg);
    for (int it = 0; it < n; ++it) {
      const int k_start = (k_first + it) * BK;
      const bool full = map::tile_full(q_start, k_start, q_offset, p.causal,
                                       p.local_window);
      // S, then dP (rows are queries, columns keys): this warpgroup's
      // partials over its half of D
      float sc[32], dp[32];
      uint32_t kb[2] = {0xFFFFu, 0xFFFFu};
#pragma unroll 1
      for (int r = 0; r < map::HALF_SLICES; ++r) {
        uint32_t frags[3][2][4];
        split::run_scores(ring, sc, frags, qs, map::dq_slice(wg, r), r == 0);
        ring.retire(n, it, r);
        hold(frags);
      }
      fence_acc(sc);
#pragma unroll 1
      for (int r = map::HALF_SLICES; r < 2 * map::HALF_SLICES; ++r) {
        uint32_t frags[3][2][4];
        split::run_scores(ring, dp, frags, dos, map::dq_slice(wg, r),
                          r == map::HALF_SLICES);
        if (r == map::HALF_SLICES) {
          // while dP's first products run: S and the keep words across,
          // then P
          if (MODE != kNone)
            split::exchange(sc, xs, wg, t, xk, my_kb, kb);
          else
            split::exchange(sc, xs, wg, t);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
            const int q_pos = q_start + 16 * w + l / 4 + 8 * hh + q_offset;
            float x = sc[i] * p.scale;
            if (!full && !score_valid(q_pos, k_start + 8 * g + 2 * c + e,
                                      p.causal, p.local_window))
              x = neg_big();
            sc[i] = expf(x - lse[hh]);
          }
        }
        ring.retire(n, it, r);
        hold(frags);
      }
      fence_acc(dp);
      split::exchange(dp, xs, wg, t);

      // element i = 4 g + 2 hh + e: query q_start + 16w + l/4 + 8hh, key
      // k_start + 8g + 2c + e; dp becomes dS * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int g = i / 4, hh = (i / 2) % 2, e = i % 2;
        float gd = dp[i];
        if (MODE != kNone)
          gd = ((kb[hh] >> (2 * g + e)) & 1u) ? gd * p.dp.inv_keep : 0.f;
        dp[i] = sc[i] * (gd - delta[hh]) * p.scale;
      }

      // dq += dS K over this warpgroup's half, both sides as triples
      uint32_t a[3][4][4];
      a_frags(dp, a);
#pragma unroll
      for (int r = 2 * map::HALF_SLICES; r < map::DQ_STEPS; ++r) {
        float part[wide::SW / 2];
        ring.run(split::DqProducts{part, a, ring.buf});
        if (r == 2 * map::HALF_SLICES && it + 1 < n)
          my_kb = split::keep_word<MODE>(p, b, h, q_start, k_start + BK, wg);
        ring.retire(n, it, r);
        fence_acc(part);
        const int blk = r - 2 * map::HALF_SLICES;
#pragma unroll
        for (int i = 0; i < wide::SW / 2; ++i)
          dq[(wide::SW / 2) * blk + i] += part[i];
      }
    }
  }
  wide::store_half(p.dq + q_row * D, dq);
}

// alignment slack, the Q and dO triples, two slice triples, the exchanges
// of the partial scores and of the keep words, twelve mbarriers
constexpr int kWideSmemBytes =
    1024 + 6 * wide::TILE + 2 * wide::SLICE3 +
    4 * (wide_map::DQ_XCHG_FLOATS + wide_map::FWD_KEEP_WORDS) + 2 * 6 * 8;

int launch_wide(const void* q, const void* k, const void* v,
                const void* dout, void* ws, const DqArgs& p, int mode,
                cudaStream_t s) {
  constexpr int D = wide::D;
  if ((mode != kNone && mode != kPremask && mode != kCounters) ||
      ws == nullptr || reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mode == kNone      ? flash_dq_kernel_split<D, kNone>
                      : mode == kPremask ? flash_dq_kernel_split<D, kPremask>
                                         : flash_dq_kernel_split<D, kCounters>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.B * p.KV * p.SK / BK;
  flash_dq_kernel_triples<D><<<dim3(blocks, 2), wide::THREADS, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<uint8_t*>(ws), blocks);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  kernel<<<dim3(p.SQ / BQ, p.H, p.B), wide::THREADS, kWideSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(dout),
      static_cast<const uint8_t*>(ws), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (B,H,SQ,D) f32 from f32 q (B,H,SQ,D), k/v (B,KV,SK,D), dout
// (B,H,SQ,D), lse and delta (B,H,SQ), all contiguous and on 16 bytes; SQ
// and SK multiples of 64; D in {16, 32, 64, 128, 256}; mode 0 none, 1 premask
// (plane (B,H,SQ/32,SK) int32), 2 counters (the Philox key words; replay
// and fused). dk and dv are not gradients here (repro_flash_dkv,
// flash_dkv_f32.cu, takes the same arguments): at D = 256 dk is a
// workspace on 16 bytes that the call writes K's and V's bf16 triples into,
// 12 B KV SK D bytes (wide_map::dq_ws_part); otherwise both are unused.
// Launches on `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
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
    case 256: return launch_wide(q, k, v, dout, dk, p, mode, s);
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
