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
//
// The design, the same in all three kernels:
//  - two warpgroups a CTA on the same 64 rows (q-blocks in the forward and
//    dq, k-blocks in dkv); each runs the score products in full (the same
//    arithmetic, so the same scores, probabilities and keep bits) and owns
//    one 128-column half of the output (O, dq, or dK and dV): 64 f32
//    accumulators a thread, as at D = 128, where a thread of one
//    warpgroup holding all 256 columns would need 128 and spill;
//  - the kept tiles split once into their triples (split_rows); the tiles
//    walked over come as slices of 32 columns, split into one of two slice
//    triples of 12,288 bytes (a slice is a 64 x 32 bf16 tile in
//    load_tile's D = 32 layout: 64-byte rows in the 64-byte swizzle);
//  - a score product (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T)
//    reduces over D slice by slice: each step holds two slices, and its
//    six part products, smallest first, add into the scores inside the
//    tensor core, 96 chained part products over D (48 at D = 128).
//    Folding each step's sum in by f32 adds, as the f32 GEMM folds its
//    stages, needs a fresh 32-register sum beside the scores: dq and dkv
//    then spilled (840 and 124 bytes) and dq ran 1.46x slower; chained,
//    dq, dk, dv read 0.50, 0.44, 0.35 of the smoke's f32 limit at its
//    shape (folded 0.23, 0.26, 0.12; the bf16-rounded control 10x the
//    limit; scripts/probe_flash_f32_d256.py --variants folded);
//  - a second product (P V, dS K, P_drop^T dO, dS^T Q) reads the slices of
//    the warpgroup's own half, one a step and warpgroup (slice s and 4 + s
//    in the two buffers), each an m64n32 product folded into its 32
//    columns of the output (add_product6 at D = 32);
//  - every slice is split from device memory by all 256 threads, one
//    16-byte chunk of each part a thread, when its step begins (Stream):
//    no TMA and no staging tile. The walked tiles are shared by the
//    CTAs of a head (MQA: by all heads), so the loads mostly hit L2;
//    loading the next step's values into registers while a step's
//    products ran left dq as fast and made dkv 2 % slower (variant
//    ahead).
// Shared memory: the forward 123,904 bytes, dq 222,208, dkv 222,720 -- one
// CTA an SM. Products per pair of (query, key): as at D = 128, plus the
// second warpgroup's score products (1.5x the forward's, 1.33x dq's; dkv
// runs S^T a third time, flash_dkv_f32.cu).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

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

// Thread t's unit of two slices (row t / 4, columns 8 (t % 4) ..)
struct Pair {
  Unit a, b;
};

// slices sa and sb (columns 32 sa .., 32 sb ..) of the 64 rows at `rows`
__device__ __forceinline__ Pair load_pair(const float* rows, int sa,
                                          int sb) {
  const int t = threadIdx.x;
  const float* p = rows + (t / 4) * D + 8 * (t % 4);
  return Pair{load_unit(p + SW * sa), load_unit(p + SW * sb)};
}

// the pair's triples into the two slice buffers at buf, SLICE3 apart
__device__ __forceinline__ void store_pair(const Pair& v, uint32_t buf) {
  const int t = threadIdx.x;
  const uint32_t off = swizzle<row_bytes<SW>()>((t / 4) * row_bytes<SW>() +
                                                16 * (t % 4));
  store_unit(v.a, buf + off, SLICE);
  store_unit(v.b, buf + SLICE3 + off, SLICE);
}

// The slices a CTA splits, one step at a time: `load(j)` is the Pair of
// step j.
template <class Load>
struct Stream {
  Load load;
  int j;

  // Step j's slices into the buffers at buf once every warp's products on
  // them are done (each warpgroup has waited on its own), the stores
  // visible to the tensor cores. `between` runs after the first barrier
  // (the CTA's other shared data of the step).
  template <class Between = Nothing>
  __device__ __forceinline__ void fill(uint32_t buf,
                                       Between&& between = Between()) {
    __syncthreads();
    store_pair(load(j++), buf);
    between();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
};

template <class Load>
__device__ __forceinline__ Stream<Load> stream(Load load) {
  return Stream<Load>{load, 0};
}

// d (+)= A B^T over slices sa and sb of D: A the 64 x 256 triple at a
// (parts TILE apart), B the slice triples in the buffers at buf, both read
// K-major; the six part products, smallest first, each over both slices'
// k16 steps; d replaced by the first when `first`. The caller fences and
// commits.
__device__ __forceinline__ void score_step(float (&d)[32], uint32_t a,
                                           uint32_t buf, int sa, int sb,
                                           bool first) {
  const uint64_t da = pinned(desc_k<D>(a, 0)), db = pinned(desc_k<SW>(buf, 0));
#pragma unroll
  for (int n = 0; n < 6; ++n)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < SW / 16; ++j)
        wgmma_ss_n64(
            d,
            desc_at(da, part_a(n) * TILE +
                            slice_bytes<D>((SW / 16) * (s ? sb : sa) + j)),
            desc_at(db, part_b(n) * SLICE + s * SLICE3 + slice_bytes<SW>(j)),
            !first || n > 0 || s > 0 || j > 0);
}

// The four score steps over the slices of the 64 rows the stream walks,
// the A triple at a: s = A B^T. `under` runs while the first step's
// products are in flight; `between` is the first step's fill's
// (Stream::fill).
template <class S, class Under = Nothing, class Between = Nothing>
__device__ __forceinline__ void scores(float (&s)[32], S& st, uint32_t a,
                                       uint32_t buf, Under&& under = Under(),
                                       Between&& between = Between()) {
#pragma unroll
  for (int step = 0; step < D / SW / 2; ++step) {
    if (step == 0)
      st.fill(buf, between);
    else
      st.fill(buf);
    wgmma_fence();
    score_step(s, a, buf, 2 * step, 2 * step + 1, step == 0);
    wgmma_commit();
    if (step == 0) under();
    wgmma_wait0();
    fence_acc(s);
  }
}

// acc (this warpgroup's HALF columns) += A B for A the triple of a 64 x 64
// fragment (a_frags) and B the slices of this warpgroup's half of the rows
// the stream walks: step s, slice s of the half (columns 32 s ..) from the
// warpgroup's buffer, an m64n32 product of six part products, smallest
// first, folded into those columns by f32 adds (add_product6)
template <class S>
__device__ __forceinline__ void add_half(float (&acc)[HALF / 2], S& st,
                                         const uint32_t (&a)[3][4][4],
                                         uint32_t buf) {
  const uint32_t mine = buf + (threadIdx.x / WG) * SLICE3;
#pragma unroll
  for (int s = 0; s < HALF / SW; ++s) {
    st.fill(buf);
    float part[SW / 2];
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) part[i] = acc[(SW / 2) * s + i];
    add_product6<SW>(part, a, mine);
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) acc[(SW / 2) * s + i] = part[i];
  }
}

// the Pair of a step that walks rows: a score step (slices 2 s, 2 s + 1)
// or a half step (slice s for the first warpgroup, 4 + s for the second)
__device__ __forceinline__ Pair score_pair(const float* rows, int s) {
  return load_pair(rows, 2 * s, 2 * s + 1);
}
__device__ __forceinline__ Pair half_pair(const float* rows, int s) {
  return load_pair(rows, s, HALF / SW + s);
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

}  // namespace wide
}  // namespace repro_flash
