// The pieces the f32 flash kernels share at head_dim 256 (the D = 256
// instances of flash_fwd_f32.cu, flash_dq_f32.cu and flash_dkv_f32.cu):
// their CTA, their tiles and slices in shared memory, the splits that fill
// them straight from device memory, and the products over slices.
//
// Why a tiling of their own. The f32 kernels hold every operand tile as
// its exact bf16 triple (flash_sm90.cuh), and at D = 128 the triples of
// four 64-row tiles already fill shared memory (230,408 to 231,440 of the
// 232,448 bytes a CTA may take). At D = 256 one 64 x 256 triple is 98,304
// bytes: two fit (the tiles a CTA keeps for its whole walk: Q in the
// forward, Q and dO in dq, K and V in dkv), the tiles it walks over do not.
// Those come as slices of 32 columns, each split into a slice triple of
// 12,288 bytes (a 64 x 32 bf16 tile in load_tile's D = 32 layout: 64-byte
// rows in the 64-byte swizzle) by the threads, straight from device
// memory: no TMA and no staging tile (dq's come split, by TMA:
// flash_dq_f32.cu).
// The walked tiles are shared by the CTAs of a head (MQA: by all heads), so
// the loads mostly hit L2.
//
// What bounds them. Six bf16 part products an f32 product (the parts that
// reach 2^-16, smallest first) on the tensor cores: at recurrentgemma's
// LOCAL layer (1 x 16 x 4096 x 256, window 2048) 0.63 ms for the forward's
// two products, 1.25 ms for dkv's four. Beside them, on the SIMT units:
// the splits (about 12 instructions a pair of values, every walked slice
// of every tile), the exponentials and, in replay, the keep bits.
//
// How they split their work (flash_wide_map.cuh says who takes what; each
// of the two warpgroups of a CTA holds one 128-column half of the output,
// 64 f32 accumulators a thread, as at D = 128):
//  - The forward and dq split the score products by D: each warpgroup
//    reduces a partial S (dq: and dP) over its own 128 columns of D
//    (m64n64), the two partial tiles cross through shared memory and both
//    add them, so both hold the same scores; each then touches only its
//    own half of every walked tile, one slice a step. The forward splits
//    the next step's slice (loaded into registers a step earlier) into the
//    other of its two buffers while the step's products run, with barriers
//    of its own. dq takes its slices already split: flash_dq_kernel_triples
//    writes K and V once a call as triples into device memory, in the
//    slice buffers' layout, and each warpgroup's thread 0 issues them part
//    by part by bulk copies (TMA) into a ring of three part stages with
//    full and empty mbarriers, each part of the next step issued as soon
//    as the products that read it in this step are done.
//  - dkv splits them by queries: each warpgroup computes the m64n32
//    columns of S^T and dP^T of its 32 queries over the full D, with their
//    keep bits and exponentials, and P_drop^T and dS^T cross through shared
//    memory so each holds the whole fragment for its output half; it walks
//    its q-blocks twice, for dV (Q, dO) and for dK (Q, dO, Q), in steps of
//    two slices filled between two CTA barriers, each output step one
//    m64n64 product.
// The warpgroup index is made warp-uniform (__shfl_sync), or ptxas
// serializes the products under the branches on it (C7518). Shared memory:
// the forward 182,272 bytes, dq 230,496, dkv 230,928 -- one CTA an SM.
// Products per pair of (query, key): the forward and dq 1x what the work
// needs, dkv 1.25x. Measured on the H100 (PERF.md,
// scripts/probe_flash_f32_d256_split.py): an m64n32 product costs about
// what an m64n64 one does, and the threads' splits of the walked slices,
// not the products, hold the forward and dkv (without them the forward
// runs 1.36 ms where it runs 1.85, dkv 3.5 where 5.4).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"
#include "flash_wide_map.cuh"

namespace repro_flash {
namespace wide {

using namespace repro_flash::tc;

constexpr int D = 256;
constexpr int THREADS = 2 * WG;          // two warpgroups a CTA
constexpr int HALF = D / 2;              // the output columns of one
constexpr int SW = 32;                   // columns of a slice
constexpr int TILE = tile_bytes<D>();    // a part of a 64 x 256 tile
constexpr int SLICE = tile_bytes<SW>();  // a part of a 64 x 32 slice
constexpr int SLICE3 = 3 * SLICE;        // a slice's triple

// 8 consecutive f32 values of a row
struct Unit {
  float4 x, y;
};

__device__ __forceinline__ Unit load_unit(const float* p) {
  const float4* v = reinterpret_cast<const float4*>(p);
  return Unit{__ldg(v), __ldg(v + 1)};
}

// the unit's triple: one 16-byte chunk of each part, at dst, dst + part,
// dst + 2 part
__device__ __forceinline__ void store_unit(const Unit& u, uint32_t dst,
                                           uint32_t part) {
  uint32_t hi[4], mid[4], lo[4];
  split3(u.x.x, u.x.y, hi[0], mid[0], lo[0]);
  split3(u.x.z, u.x.w, hi[1], mid[1], lo[1]);
  split3(u.y.x, u.y.y, hi[2], mid[2], lo[2]);
  split3(u.y.z, u.y.w, hi[3], mid[3], lo[3]);
  st_shared_u4(dst, hi);
  st_shared_u4(dst + part, mid);
  st_shared_u4(dst + 2 * part, lo);
}

// The 64 x 256 f32 rows at `src` (row-major) as the triple at dst (parts
// TILE apart) in load_tile's D = 256 layout, by the CTA's 256 threads
__device__ __forceinline__ void split_rows(const float* src, uint32_t dst) {
  const int t = threadIdx.x;
#pragma unroll 2
  for (int i = 0; i < 64 * D / 8 / THREADS; ++i) {
    const int u = t + THREADS * i;
    const int row = u / (D / 8), c8 = u % (D / 8);
    const int byte = 16 * c8;
    store_unit(load_unit(src + row * D + 8 * c8),
               dst + (byte / 128) * 64 * 128 +
                   swizzle<128>(row * 128 + byte % 128),
               TILE);
  }
}

// this warpgroup's HALF columns of a 64-row fragment (rows 16 w + l / 4
// and + 8) into the f32 rows at `rows` (row-major, D columns)
__device__ __forceinline__ void store_half(float* rows,
                                           const float (&acc)[HALF / 2]) {
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int col0 = HALF * (threadIdx.x / WG);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = rows + static_cast<size_t>(16 * w + l / 4 + 8 * hh) * D +
                 col0;
#pragma unroll
    for (int g = 0; g < HALF / 8; ++g)
      *reinterpret_cast<float2*>(row + 8 * g + 2 * c) =
          make_float2(acc[4 * g + 2 * hh], acc[4 * g + 2 * hh + 1]);
  }
}


// ------------------------------------------------ the split kernels' pieces
// (the forward's and dkv's wide kernels; flash_wide_map.cuh says which
// warpgroup takes which slice, rows and columns at each step)

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the 128 threads of warpgroup wg wait for each other (named barrier 1 +
// wg; __syncthreads is barrier 0)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// A thread's share of a 64 x 32 f32 slice split by THREADS threads: units
// t, t + THREADS, ... of its 256 (unit u: row u / 4, columns 8 (u % 4) ..)
template <int THREADS>
struct SliceRegs {
  Unit u[64 * SW / 8 / THREADS];
};

// slice s (columns 32 s ..) of the 64 rows at `rows` into registers
template <int THREADS>
__device__ __forceinline__ SliceRegs<THREADS> load_slice(const float* rows,
                                                         int s, int t) {
  SliceRegs<THREADS> r;
#pragma unroll
  for (int i = 0; i < 64 * SW / 8 / THREADS; ++i) {
    const int u = t + THREADS * i;
    r.u[i] = load_unit(rows + (u / 4) * D + SW * s + 8 * (u % 4));
  }
  return r;
}

// The 32-bit word at addr. Where a global address depends on it, its
// read-only loads (__ldg) stay behind the barrier before this read: ptxas
// may otherwise hoist the loads of later steps above the barriers, each
// step's registers then live across the whole walk.
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// the registers' triple into the slice buffer at buf (store_pair's layout)
template <int THREADS>
__device__ __forceinline__ void store_slice(const SliceRegs<THREADS>& r,
                                            uint32_t buf, int t) {
#pragma unroll
  for (int i = 0; i < 64 * SW / 8 / THREADS; ++i) {
    const int u = t + THREADS * i;
    store_unit(r.u[i],
               buf + swizzle<row_bytes<SW>()>((u / 4) * row_bytes<SW>() +
                                               16 * (u % 4)),
               SLICE);
  }
}

// d (+)= A B^T over slice s of D (columns 32 s .., k16 slices 2 s and
// 2 s + 1 of A): A the 64 x 256 triple at a (parts TILE apart), B the N
// rows of the slice triple from b (parts SLICE apart), both K-major; the
// six part products, smallest first; d replaced by the first when
// `first`. The caller fences and commits.
template <int N>
__device__ __forceinline__ void score_slice(float (&d)[N / 2], uint32_t a,
                                            int s, uint32_t b, bool first) {
  const uint64_t da = pinned(desc_k<D>(a, 0)), db = pinned(desc_k<SW>(b, 0));
#pragma unroll
  for (int n = 0; n < 6; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint64_t x = desc_at(da, part_a(n) * TILE +
                                         slice_bytes<D>(2 * s + j));
      const uint64_t y = desc_at(db, part_b(n) * SLICE + slice_bytes<SW>(j));
      const int acc = !first || n > 0 || j > 0;
      if constexpr (N == 64)
        wgmma_ss_n64(d, x, y, acc);
      else
        wgmma_ss_n32(d, x, y, acc);
    }
}

// d = A B for A the triple of a 64 x 64 fragment (a_frags) and B the slice
// triple at b read MN-major (its rows k): one m64n32 product of six part
// products, smallest first (add_product6's at D = 32, without its fence,
// commit and wait)
__device__ __forceinline__ void product_slice(float (&d)[SW / 2],
                                              const uint32_t (&a)[3][4][4],
                                              uint32_t b) {
  const uint64_t db = pinned(desc_mn<SW>(b, 0));
#pragma unroll
  for (int n = 0; n < 24; ++n) {
    const int j = n % 4;
    const uint64_t y =
        desc_at(db, part_b(n / 4) * SLICE + j * 16 * row_bytes<SW>());
    wgmma_rs<SW>(d, a[part_a(n / 4)][j], y, n);
  }
}

// d = A B for A the triple of a 64 x 64 fragment (a_frags) and B two slice
// triples side by side -- the slices at b and b + SLICE3, 64 columns --
// read MN-major: one m64n64 product of six part products, smallest first,
// the second slice the descriptor's next 32 columns (its leading offset)
__device__ __forceinline__ void product_pair(float (&d)[SW],
                                             const uint32_t (&a)[3][4][4],
                                             uint32_t b) {
  const uint64_t db = pinned(static_cast<uint64_t>(
      (desc_mn<SW>(b, 0) & ~(0x3FFFull << 16)) |
      (static_cast<uint64_t>(SLICE3 >> 4) << 16)));
#pragma unroll
  for (int n = 0; n < 24; ++n) {
    const int j = n % 4;
    const uint64_t y =
        desc_at(db, part_b(n / 4) * SLICE + j * 16 * row_bytes<SW>());
    wgmma_rs<2 * SW>(d, a[part_a(n / 4)][j], y, n);
  }
}

// keep_fwd's word kb[hh] alone (its rows 16 w + l / 4 + 8 hh): the
// forward's warpgroup hh makes it, half of the calls of keep_fwd
template <int MODE>
__device__ __forceinline__ uint32_t keep_fwd_rows(const Dropout& dp, int b,
                                                  int h, int H, int SQ,
                                                  int SK, int q_start,
                                                  int k_start, int hh) {
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int row = q_start + 16 * w + l / 4;
  uint32_t kb = 0;
  if (MODE == kPremask) {
    const int32_t* words =
        dp.plane +
        (static_cast<size_t>(b) * H + h) * (SQ / 32) * SK +
        static_cast<size_t>(row / 32) * SK + k_start + 2 * c;
    const int sh = (row & 31) + 8 * hh;  // row + 8 is in the same word
#pragma unroll
    for (int idx = 0; idx < 16; ++idx)
      kb |= ((static_cast<uint32_t>(words[8 * (idx >> 1) + (idx & 1)]) >>
              sh) & 1u) << idx;
  } else if (MODE == kCounters) {
    const uint32_t bh = repro_philox::global_bh(
        static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(H),
        dp.heads_global, dp.bh_offset);
    const int i = (l >> 2) & 3;  // this row within its group of 4
    uint32_t mine = 0;           // nibble j: key index 4 i + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = 4 * i + j;
      const uint32_t key = k_start + 8 * (idx >> 1) + 2 * c + (idx & 1);
      mine |= repro_philox::keep_nibble(
                  key, static_cast<uint32_t>((row >> 2) + 2 * hh), bh,
                  dp.salt, dp.k0, dp.k1, dp.threshold, dp.rounds)
              << (4 * j);
    }
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const uint32_t v =
          __shfl_sync(0xffffffffu, mine, (l & ~12) | (src << 2));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb |= ((v >> (4 * j + i)) & 1u) << (4 * src + j);
    }
  } else {
    kb = 0xFFFFu;
  }
  return kb;
}

}  // namespace wide
}  // namespace repro_flash
