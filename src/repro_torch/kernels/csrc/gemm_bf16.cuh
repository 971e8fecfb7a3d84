// The persistent tensor-core GEMM of the fused bf16 GEMM+RNG kernels: C[e]
// = A[e] @ B[e] on bf16 operands with f32 sums, C rounded to bf16 once, and
// the dropout plane emitted under the products. The dense host
// (gemm_rng_bf16.cu) launches it with E = 1, the grouped host
// (gemm_rng_grouped_bf16.cu) with one product an expert; each is a library
// of its own.
//
// Operands as gemm_tc.cuh's (the f32 hosts' body): A (E, M, K), B (E, K,
// N) and C (E, M, N) row-major bf16, B as the model keeps its weight and
// read MN-major through wgmma's transpose bit; K and N multiples of 8 (TMA's
// 16-byte row stride); the tensor maps read zeros past M, N and K (3-D
// maps over (K, M, E) and (N, K, E) for the grouped host, so an expert's
// last tile row never reads the next expert's rows), and C stores stop at
// each expert's M rows and at N.
//
// The grid is persistent: clusters of CLUSTER = 2 CTAs (384 threads, one
// an SM) on neighbouring tile rows of one tile column, as many clusters as
// can run at once, walking the cluster tiles c, c + G, ... of
// gemm_walk.cuh::cta_tile (expert by expert, bands of GROUP_M cluster
// rows), so the producer's TMA loads of a CTA's next tile run under its
// consumers' store of the last one. A tile is 128 x BN (BN = 256).
// Warpgroup 0 is the producer: its first thread keeps a ring of stages (64
// k of A, 128 rows, K-major; BN / 64 boxes of 64 n x 64 k of B, MN-major;
// 128-byte swizzle, mbarrier completion) in flight across the CTA's
// tiles. B is the same for both
// CTAs of a cluster: each loads every other box by TMA multicast into both
// CTAs' rings, so L2 serves each B tile once a cluster, and a stage goes
// back once the consumers of both are done with it. A box wholly past N is
// not loaded (only columns no store reaches read it), nor the A of a tile
// row past M. The producer's warps 1-3 emit the plane. Warpgroups 1 and 2
// are the consumers, 64 rows of C each: the f32 accumulator in registers
// (BN / 2 floats a thread; the producer gives them its spare registers by
// setmaxnreg) and one m64nBNk16 wgmma a k16 slice, four a stage; a stage
// goes back to the producers once the next one's products are issued. C
// is stored from the accumulator as bf16 pairs.
//
// The plane: each CTA owns an equal run of the plane's 32-word units
// (gemm_walk.cuh::share_of: a unit is 32 neighbouring words of one row, a
// warp's lanes), and its warps take the run's units from a counter in
// shared memory: the producer's warps 1-3 two at a time until it is spent,
// and each consumer warp one a stage, between the commit of the stage's
// products and the wait for the last stage's -- the Philox work issues
// while the tensor cores run. A unit's row, packed row and head row are
// divided out once for its 32 words. The bits are position-based
// (philox.cuh), so neither the split nor the order reaches them: bitwise
// the f32 and e4m3 hosts' planes for the same counters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gemm_emit.cuh"
#include "gemm_sm90.cuh"
#include "gemm_walk.cuh"

namespace repro_gemm {
namespace bf16 {

using namespace sm90;
using walk::BM;

constexpr int BK = 64;   // k of a stage: one 128-byte bf16 row
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
// registers a thread after setmaxnreg: the consumers' accumulator (128
// floats) and a unit of Philox beside it, within the launch's 168 x 384;
// more than that and setmaxnreg.inc waits forever
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// plane units a producer warp takes at a time (a consumer warp takes one
// a stage, between the commit and the wait of the stage's products)
constexpr int PRODUCER_UNITS = 2;

template <int BN>
struct Ring {
  static constexpr int STAGES = BN == 256 ? 4 : 6;  // 48 KB or 32 KB
  static constexpr int A_BYTES = BM * BK * 2;  // 128 rows of 128 bytes
  static constexpr int B_BOX = BK * 64 * 2;    // 64 k rows of 64 n
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX;
  // the ring (1024-byte aligned for the swizzle), its full / empty
  // barriers, the plane's unit counter
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 16;
};

#define REPRO_WGMMA_D128                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7,\n"                                      \
  " %8, %9, %10, %11, %12, %13, %14, %15,\n"                                \
  " %16, %17, %18, %19, %20, %21, %22, %23,\n"                              \
  " %24, %25, %26, %27, %28, %29, %30, %31,\n"                              \
  " %32, %33, %34, %35, %36, %37, %38, %39,\n"                              \
  " %40, %41, %42, %43, %44, %45, %46, %47,\n"                              \
  " %48, %49, %50, %51, %52, %53, %54, %55,\n"                              \
  " %56, %57, %58, %59, %60, %61, %62, %63,\n"                              \
  " %64, %65, %66, %67, %68, %69, %70, %71,\n"                              \
  " %72, %73, %74, %75, %76, %77, %78, %79,\n"                              \
  " %80, %81, %82, %83, %84, %85, %86, %87,\n"                              \
  " %88, %89, %90, %91, %92, %93, %94, %95,\n"                              \
  " %96, %97, %98, %99, %100, %101, %102, %103,\n"                          \
  " %104, %105, %106, %107, %108, %109, %110, %111,\n"                      \
  " %112, %113, %114, %115, %116, %117, %118, %119,\n"                      \
  " %120, %121, %122, %123, %124, %125, %126, %127},\n"
#define REPRO_WGMMA_OUT128(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),     \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),     \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),     \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),     \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),     \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),     \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),     \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),    \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),              \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),              \
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),              \
      "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),              \
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),              \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),              \
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d += A (64 x 16, shared, K-major) * B (16 x 256, shared, MN-major: the
// transpose bit), bf16 operands -- every product exact -- and f32 sums
__device__ __forceinline__ void wgmma_m64n256k16_bf16_bmn(float (&d)[128],
                                                          uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REPRO_WGMMA_D128
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : REPRO_WGMMA_OUT128(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef REPRO_WGMMA_D128
#undef REPRO_WGMMA_OUT128

// one k16 slice of the tile's products into d
template <int BN>
__device__ __forceinline__ void mma_slice(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_bf16_bmn(d, da, db);
  else
    wgmma_m64n128k16_bf16_bmn(d, da, db, 1);
}

// pins the accumulator at this point of the program, so its reads are not
// moved above the wait that completes the products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t atom_add_shared(uint32_t addr,
                                                    uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared::cta.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(addr), "r"(v)
               : "memory");
  return old;
}

// mbar_wait (gemm_sm90.cuh) that traps -- a launch error, not a hung card
// -- when the phase has not completed after 2^32 clocks (seconds): a load
// or a release that never comes. The loop is inside the asm, as there, and
// reads the clock only once the first try has failed.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t, %%clock64;\n"
      "sub.u64 t, t, t0;\n"
      "setp.gt.u64 p, t, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of the map at (inner, row[, expert]) into shared memory at `dst`
// of every CTA of the cluster in `mask`, each CTA's barrier at `bar`
// told of its bytes
template <bool GROUPED>
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int inner,
                                                   int row, int ex,
                                                   uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (GROUPED) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::
            "r"(dst),
        "l"(m), "r"(bar), "h"(mask), "r"(inner), "r"(row), "r"(ex)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(
            dst),
        "l"(m), "r"(bar), "h"(mask), "r"(inner), "r"(row)
        : "memory");
  }
}

// arrive on the barrier at `bar` in the shared memory of the cluster's
// other CTA of rank `rank` (CUTLASS's ClusterBarrier::arrive)
__device__ __forceinline__ void arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 a;\n"
      "mapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [a];\n}" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// The next N units of this CTA's share [sh.first, sh.end) of the plane,
// taken from the counter at `counter` by lane 0 of the calling warp and
// written by its 32 lanes (lane l: column c0 + l of each unit's row, when
// below sk; units past the share's end are skipped). A lane makes its N
// words at once: N independent Philox chains, whose latencies overlap.
// False, and nothing written, when the share is spent.
template <int ROUNDS, int N>
__device__ __forceinline__ bool emit_units(const Emit& e, uint32_t counter,
                                           walk::Share sh, int lane) {
  uint32_t u = 0;
  if (lane == 0) u = atom_add_shared(counter, N);
  u = sh.first + __shfl_sync(0xffffffffu, u, 0);
  if (u >= sh.end) return false;
  const uint32_t sk = static_cast<uint32_t>(e.sk);
  uint32_t word[N], row[N], col[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const walk::Unit at = walk::unit_at(u + i < sh.end ? u + i : u, sk,
                                        static_cast<uint32_t>(e.sq32));
    row[i] = at.row;
    col[i] = at.c0 + lane;
    word[i] = walk::word_at<ROUNDS>(
        col[i], at.q,
        repro_philox::global_bh(at.lbh, e.heads_local, e.heads_global,
                                e.bh_offset),
        e.salt, e.k0, e.k1, e.threshold);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (u + i < sh.end && col[i] < sk)
      e.mask[static_cast<size_t>(row[i]) * sk + col[i]] =
          static_cast<int32_t>(word[i]);
  return true;
}

template <int BN, int ROUNDS, bool GROUPED>
__global__ void __launch_bounds__(NT, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     __nv_bfloat16* __restrict__ c, int M, int N, int K,
                     int tiles_m, int tiles_n, int cluster_tiles, Emit e) {
  using R = Ring<BN>;
  constexpr int STAGES = R::STAGES;
  constexpr int CLUSTER = walk::CLUSTER;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * R::STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t counter = empty + 8 * STAGES;
  const int nkt = (K + BK - 1) / BK;
  // this CTA's rank in its cluster, the cluster and the clusters
  const int rank = blockIdx.x % CLUSTER;
  const int cluster = blockIdx.x / CLUSTER;
  const int clusters = gridDim.x / CLUSTER;
  const walk::Share sh =
      e.mask == nullptr
          ? walk::Share{0, 0}
          : walk::share_of(static_cast<uint32_t>(e.rows_valid) *
                               walk::units_per_row(e.sk),
                           blockIdx.x, gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // a stage goes back once every consumer warp of the cluster is done
      // with it: the CTAs' B tiles land in each other's shared memory
      mbar_init(empty + 8 * s, CLUSTER * 8);
    }
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(counter), "r"(0u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA's barriers ready before any other CTA's load or release
  // reaches them
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;" ::: "memory");

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // the ring runs on across the CTA's tiles: `it` counts its stages
      uint32_t it = 0;
      for (int t = cluster; t < cluster_tiles; t += clusters) {
        const walk::Tile at = walk::cta_tile(t, rank, tiles_m, tiles_n);
        const int m0 = at.mt * BM, n0 = at.nt * BN;
        const int boxes = min(BN / 64, (N - n0 + 63) / 64);
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const uint32_t s = it % STAGES;
          if (it >= STAGES) wait(empty + 8 * s, ((it / STAGES) + 1) & 1);
          const uint32_t dst = ring + s * R::STAGE_BYTES;
          // this CTA's A (none for a tile row past M: nothing is stored
          // there), and every B box of the stage: 1 / CLUSTER of them from
          // each CTA of the cluster
          mbar_expect_tx(full + 8 * s,
                         (m0 < M ? R::A_BYTES : 0) + boxes * R::B_BOX);
          if (m0 < M)
            tma_load<GROUPED>(dst, &map_a, full + 8 * s, kt * BK, m0, at.ex);
          for (int i = rank; i < boxes; i += CLUSTER) {
            const uint32_t box = dst + R::A_BYTES + i * R::B_BOX;
            if constexpr (CLUSTER == 1)
              tma_load<GROUPED>(box, &map_b, full + 8 * s, n0 + 64 * i,
                                kt * BK, at.ex);
            else
              tma_load_multicast<GROUPED>(box, &map_b, full + 8 * s,
                                          n0 + 64 * i, kt * BK, at.ex,
                                          (1u << CLUSTER) - 1);
          }
        }
      }
      // the CTA stays until every consumer warp of the cluster has let go
      // of its last stages: nothing reaches its shared memory after it
      // exits
      for (uint32_t j = it < STAGES ? 0 : it - STAGES; j < it; ++j)
        wait(empty + 8 * (j % STAGES), (j / STAGES) & 1);
    } else if (threadIdx.x >= 32 && sh.first < sh.end) {
      while (emit_units<ROUNDS, PRODUCER_UNITS>(e, counter, sh, lane)) {
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int w = wg - 1;          // rows 64 w .. of the tile
  const int warp = (threadIdx.x % 128) / 32;
  // a stage back to the producers of the cluster: one arrival a warp
  auto release = [&](uint32_t s) {
    if (lane != 0) return;
    mbar_arrive(empty + 8 * s);
    for (int r = 0; r < CLUSTER; ++r)
      if (r != rank) arrive_remote(empty + 8 * s, r);
  };
  bool emitting = sh.first < sh.end;
  uint32_t it = 0;
  for (int t = cluster; t < cluster_tiles; t += clusters) {
    const walk::Tile at = walk::cta_tile(t, rank, tiles_m, tiles_n);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      const uint32_t s = it % STAGES;
      wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t stage = ring + s * R::STAGE_BYTES;
      // A: this warpgroup's 64 rows, K-major; slice j 32 bytes on (2 in
      // the descriptor's address field). B: MN-major, slice j 16 k rows
      // (2048 bytes) on, each further 64 n one box (B_BOX bytes) on.
      const uint64_t da = smem_desc(stage + w * (64 * 128));
      const uint64_t db = smem_desc_mn(stage + R::A_BYTES, R::B_BOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        mma_slice<BN>(d, da + 2 * j, db + (2048 >> 4) * j);
      wgmma_commit();
      // a unit of the plane while the products run
      if (emitting) emitting = emit_units<ROUNDS, 1>(e, counter, sh, lane);
      // the previous stage's products are done: its tiles go back
      wgmma_wait1();
      if (kt > 0) release((it - 1) % STAGES);
    }
    wgmma_wait0();
    fence_acc(d);
    release((it - 1) % STAGES);

    // store: d's fragment layout -- row warp * 16 + lane / 4 (+ 8), column
    // 8 g + 2 (lane % 4) (+ 1); N is even, so a pair is in or out together
    __nv_bfloat16* ce = c + static_cast<size_t>(at.ex) * M * N;
    const int r0 = at.mt * BM + 64 * w + warp * 16 + lane / 4;
    const int n0 = at.nt * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      __nv_bfloat16* crow = ce + static_cast<size_t>(r) * N;
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        const int col = n0 + 8 * g + 2 * (lane % 4);
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(crow + col) =
              __floats2bfloat162_rn(d[4 * g + 2 * h], d[4 * g + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ the host

// resident_clusters' answers by device. Internal linkage: a static local
// of a template would be one object for every library of the process
// (GNU_UNIQUE), whatever each library's cluster size.
namespace {
int known_clusters[64] = {};
}  // namespace

// A launch of `ctas` CTAs in clusters of CLUSTER, `smem` bytes of dynamic
// shared memory each, on stream `s`; `attr` holds the cluster's shape.
inline cudaLaunchConfig_t cluster_launch(cudaLaunchAttribute* attr, int ctas,
                                         int smem, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = walk::CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of the kernel that can run at once on the current device
// (cudaOccupancyMaxActiveClusters, once a device): the persistent grid.
// Every instance has the same threads, cluster size and shared memory.
// Sets the kernel's dynamic shared memory first.
template <class Kernel>
int resident_clusters(Kernel kernel, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && known_clusters[dev] > 0) {
    *out = known_clusters[dev];
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(&attr, walk::CLUSTER, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*out <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < 64) known_clusters[dev] = *out;
  return 0;
}

template <int BN, int ROUNDS, bool GROUPED>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, __nv_bfloat16* c,
           int E, int M, int N, int K, const Emit& e, cudaStream_t s) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long cluster_tiles =
      static_cast<long long>(E) * walk::cluster_rows(tiles_m) * tiles_n;
  if (cluster_tiles > INT_MAX / walk::CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Ring<BN>::SMEM;
  auto kernel = gemm_bf16_kernel<BN, ROUNDS, GROUPED>;
  int clusters = 0;
  if (const int bad = resident_clusters(kernel, smem, &clusters)) return bad;
  if (cluster_tiles < clusters) clusters = static_cast<int>(cluster_tiles);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(&attr, clusters * walk::CLUSTER, smem, s);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, ma, mb, c, M, N, K, tiles_m, tiles_n,
                         static_cast<int>(cluster_tiles), e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool GROUPED>
int launch_rounds(const CUtensorMap& ma, const CUtensorMap& mb,
                  __nv_bfloat16* c, int E, int M, int N, int K,
                  const Emit& e, int rounds, cudaStream_t s) {
  if (e.mask == nullptr)
    return launch<BN, 7, GROUPED>(ma, mb, c, E, M, N, K, e, s);
  switch (rounds) {
    case 3: return launch<BN, 3, GROUPED>(ma, mb, c, E, M, N, K, e, s);
    case 5: return launch<BN, 5, GROUPED>(ma, mb, c, E, M, N, K, e, s);
    case 7: return launch<BN, 7, GROUPED>(ma, mb, c, E, M, N, K, e, s);
    case 10: return launch<BN, 10, GROUPED>(ma, mb, c, E, M, N, K, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C[e] = A[e] @ B[e] for E experts (GROUPED; else E = 1, the dense host),
// bf16 operands and C, f32 sums, and, when `mask` is not null, the packed
// keep plane the layout's rectangles tile. K and N must be multiples of 8
// and A, B and C must start on 16 bytes; an expert's rows follow the last
// one's. Returns cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for bad sizes, a layout that does not tile the plane, an unimplemented
// round count or a tensor map cuTensorMapEncodeTiled refuses.
template <bool GROUPED>
int run(const void* a, const void* b, void* c, int E, int M, int N, int K,
        void* mask, int rows_valid, int sk, int sq32, int rb, int ck,
        int n_cb, int n_valid_blocks, uint32_t key_lo, uint32_t key_hi,
        uint32_t salt, uint32_t bh_offset, int heads_local, int heads_global,
        uint32_t threshold, int rounds, void* stream) {
  if (E <= 0 || (!GROUPED && E != 1) || M <= 0 || N <= 0 || K <= 0 ||
      K % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Emit e;
  if (!make_emit(mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks,
                 key_lo, key_hi, salt, bh_offset, heads_local, heads_global,
                 threshold, &e) ||
      (mask != nullptr && !layout_tiles_plane(e)))
    return static_cast<int>(cudaErrorInvalidValue);
  // A: boxes of 64 k x 128 rows (x 1 expert); B: boxes of 64 n x 64 k rows
  CUtensorMap ma, mb;
  if (!make_map<GROUPED>(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, E, M,
                         K, K, BK, BM) ||
      !make_map<GROUPED>(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, E, K,
                         N, N, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rounds<walk::BN, GROUPED>(
      ma, mb, static_cast<__nv_bfloat16*>(c), E, M, N, K, e, rounds,
      static_cast<cudaStream_t>(stream));
}

}  // namespace bf16
}  // namespace repro_gemm
