// Standalone dropout-RNG kernel: the packed keep plane (B, H, SQ/32, SK) of
// one attention layer, one uint32 per (b, h, q32, k) holding the keep bits of
// query rows q32*32 .. q32*32+31 (bit q % 32).
//
// Replaces the TPU kernel src/repro/kernels/philox.py::_philox_kernel
// (philox.py:40, pl.pallas_call at philox.py:67). The TPU version walks an
// (8, 512) block grid sized for VMEM; this one has no column tiling, so it
// takes every SQ % 32 == 0 and every SK.
//
// What bounds it on an H100: instruction issue, not memory. A word needs 8
// Philox calls (4 query rows each) of ROUNDS rounds; a round is at least 4
// int32 instructions (two 32x32->64 multiplies, each giving both words,
// and two three-input xors; the key schedule is the same for every thread),
// and a call adds 4 compares and 4 bit merges: 288 instructions at 7
// rounds for 4 bytes stored. Against 132 SMs x 128 issue lanes a clock that
// is far above the 3.35 TB/s line, so the design spends nothing on memory
// tricks: one thread per output word, neighbouring threads on neighbouring
// k (coalesced 4-byte stores), the round count a template parameter so the
// chain unrolls.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
    philox_mask_kernel(uint32_t* __restrict__ out, long long rows, int sq32,
                       int sk, uint32_t key_lo, uint32_t key_hi,
                       uint32_t salt, uint32_t threshold,
                       uint32_t heads_local, uint32_t heads_global,
                       uint32_t bh_offset) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= sk) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t local_bh = static_cast<uint32_t>(r / sq32);
    const uint32_t q32 = static_cast<uint32_t>(r % sq32);
    const uint32_t bh = repro_philox::global_bh(local_bh, heads_local,
                                                heads_global, bh_offset);
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      // rows q = q32*32 + 4t + w share the counter x1 = q / 4
      const repro_philox::Words u = repro_philox::philox4x32<ROUNDS>(
          static_cast<uint32_t>(k), q32 * 8u + static_cast<uint32_t>(t), bh,
          salt, key_lo, key_hi);
      const int s = 4 * t;
      word |= static_cast<uint32_t>(u.w0 >= threshold) << s;
      word |= static_cast<uint32_t>(u.w1 >= threshold) << (s + 1);
      word |= static_cast<uint32_t>(u.w2 >= threshold) << (s + 2);
      word |= static_cast<uint32_t>(u.w3 >= threshold) << (s + 3);
    }
    out[r * sk + k] = word;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a round count the kernel does not implement.
extern "C" int repro_philox_mask(void* out, int batch, int heads_local,
                                 int sq32, int sk, uint32_t key_lo,
                                 uint32_t key_hi, uint32_t salt,
                                 uint32_t threshold, int rounds,
                                 int heads_global, uint32_t bh_offset,
                                 void* stream) {
  if (batch < 0 || heads_local <= 0 || sq32 < 0 || sk < 0 ||
      heads_global <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * heads_local * sq32;
  if (rows == 0 || sk == 0) return 0;
  const dim3 grid((sk + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t hl = static_cast<uint32_t>(heads_local);
  const uint32_t hg = static_cast<uint32_t>(heads_global);
  switch (rounds) {
    case 3:
      philox_mask_kernel<3><<<grid, kThreads, 0, s>>>(
          o, rows, sq32, sk, key_lo, key_hi, salt, threshold, hl, hg,
          bh_offset);
      break;
    case 5:
      philox_mask_kernel<5><<<grid, kThreads, 0, s>>>(
          o, rows, sq32, sk, key_lo, key_hi, salt, threshold, hl, hg,
          bh_offset);
      break;
    case 7:
      philox_mask_kernel<7><<<grid, kThreads, 0, s>>>(
          o, rows, sq32, sk, key_lo, key_hi, salt, threshold, hl, hg,
          bh_offset);
      break;
    case 10:
      philox_mask_kernel<10><<<grid, kThreads, 0, s>>>(
          o, rows, sq32, sk, key_lo, key_hi, salt, threshold, hl, hg,
          bh_offset);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
