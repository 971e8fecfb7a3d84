// Standalone dropout-RNG kernel: the packed keep plane (B, H, SQ/32, SK) of
// one attention layer, one uint32 per (b, h, q32, k) holding the keep bits of
// query rows q32*32 .. q32*32+31 (bit q % 32).
//
// Replaces the TPU kernel src/repro/kernels/philox.py::_philox_kernel
// (philox.py:40, pl.pallas_call at philox.py:67). The TPU version walks an
// (8, 512) block grid sized for VMEM; this one has no column tiling, so it
// takes every SQ % 32 == 0 and every SK.
//
// What bounds it on an H100: integer instructions, not memory. A word is
// 8 Philox calls of ROUNDS rounds (4 query rows each) and 32 keep bits for
// 4 bytes stored. Counting once what several words share (the counters
// differ per word only in k, and per call only in x1 = q32 * 8 + t), a
// word needs at least 224 instructions at 7 rounds: 72 32x32->64
// multiplies, 88 three-input xors and a compare and a merge a keep bit
// (chip_smoke.py philox_word_mix). The multiplies run only on the
// multiply-add pipe, at half its rate (IMAD.WIDE.U32, 32 a clock a SM), and
// the xors and compares only on the ALU pipe (64), so that pipe load, 2.31
// SM clocks a word, and not the 128 issue lanes (1.75) sets the least
// time (scripts/probe_philox.py measures the rates).
//
// The design:
// - packed_word_shared (philox.cuh) computes the shared parts of rounds
//   0-2 once a word, and a thread makes WORDS = 4 consecutive words of a
//   row, which share round 1's product of x0 too: 77.25 multiplies a word
//   in the SASS (the replaced kernel 83);
// - each product is one mul.wide.u32, and each keep bit the carry of a
//   subtract pushed into the word by an add with carry (push_keep): an
//   IADD3 on the ALU pipe and an IMAD.X on the multiply-add pipe, where
//   ptxas's own pack of compares, selects and P2R loads the ALU pipe;
// - a persistent grid (as many CTAs as fit at once: 4 of 256 threads a
//   SM at 7 rounds) that steps through the plane without a division
//   (philox_walk.cuh), the groups stored by 16-byte stores where SK % 4 ==
//   0, and the round count a template parameter so the chains unroll.
// What is left: the multiply-add pipe carries 77.25 x 2 + 34.5 = 189.5
// slots a word against the ALU's 130, and ptxas keeps the merges there.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "philox_walk.cuh"

namespace {

using repro_philox::walk::Cursor;
using repro_philox::walk::kThreads;
using repro_philox::walk::Plane;
using repro_philox::walk::WORDS;

// VEC: SK % WORDS == 0 and the plane 4 * WORDS bytes aligned, so every
// group is whole and stored by one vector store.
template <int ROUNDS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    philox_mask_kernel(uint32_t* __restrict__ out, Plane p, Cursor step,
                       uint32_t key_lo, uint32_t key_hi, uint32_t salt,
                       uint32_t threshold) {
  namespace walk = repro_philox::walk;
#pragma unroll 1
  for (Cursor c = walk::cursor_at(blockIdx.x * kThreads + threadIdx.x, p);
       c.b < p.batch; walk::advance(c, step, p)) {
    const uint32_t bh = walk::bh_of(c, p);
    const uint32_t k = c.grp * WORDS;
    uint32_t w[WORDS];
#pragma unroll
    for (int j = 0; j < WORDS; ++j)
      w[j] = repro_philox::packed_word_shared<ROUNDS>(
          k + j, c.q32, bh, salt, key_lo, key_hi, threshold);
    uint32_t* dst = out + c.word;
    if constexpr (VEC && WORDS == 4) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC && WORDS == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int j = 0; j < WORDS; ++j)
        if (VEC || k + j < p.sk) dst[j] = w[j];
    }
  }
}

using KernelFn = void (*)(uint32_t*, Plane, Cursor, uint32_t, uint32_t,
                          uint32_t, uint32_t);

template <int ROUNDS>
KernelFn kernel_of(bool vec) {
  return vec ? philox_mask_kernel<ROUNDS, true>
             : philox_mask_kernel<ROUNDS, false>;
}

// The instance for a round count (nullptr for one it does not implement),
// and the index of its entry in g_per_sm.
KernelFn kernel_for(int rounds, bool vec, int* index) {
  switch (rounds) {
    case 3: *index = 0; return kernel_of<3>(vec);
    case 5: *index = 1; return kernel_of<5>(vec);
    case 7: *index = 2; return kernel_of<7>(vec);
    case 10: *index = 3; return kernel_of<10>(vec);
    default: return nullptr;
  }
}

// SMs of each device and CTAs a SM each instance can hold there (0: not
// asked yet). Kept at namespace scope: a static local of an inline
// function would be one object across every library of the process.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_per_sm[kMaxDevices][4][2];

// The current device's SMs and the CTAs a SM of instance `fn`: what the
// persistent grid is sized from.
cudaError_t occupancy(KernelFn fn, int index, bool vec, int* sms,
                      int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  int& cached = g_per_sm[dev][index][vec];
  if (cached == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, reinterpret_cast<const void*>(fn), kThreads, 0);
    if (err != cudaSuccess) return err;
    if (cached == 0) return cudaErrorInvalidConfiguration;
  }
  *sms = g_sms[dev];
  *per_sm = cached;
  return cudaSuccess;
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
  const bool vec = sk % WORDS == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * WORDS) == 0;
  int index = 0;
  const KernelFn fn = kernel_for(rounds, vec, &index);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq32 == 0 || sk == 0) return 0;
  int sms = 0, per_sm = 0;
  const cudaError_t err = occupancy(fn, index, vec, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plane p = repro_philox::walk::plane_of(
      batch, heads_local, sq32, sk, static_cast<uint32_t>(heads_global),
      bh_offset);
  const repro_philox::walk::Launch at =
      repro_philox::walk::launch_of(p, sms, per_sm);
  fn<<<at.ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), p, at.step, key_lo, key_hi, salt,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

// CTAs a SM of the instance for `rounds` (vec: the one with vector
// stores) on the current device, from which a launch sizes its persistent
// grid; 0 if the round count has no instance or the query fails.
extern "C" int repro_philox_mask_ctas_per_sm(int rounds, int vec) {
  int index = 0, sms = 0, per_sm = 0;
  const KernelFn fn = kernel_for(rounds, vec != 0, &index);
  if (fn == nullptr ||
      occupancy(fn, index, vec != 0, &sms, &per_sm) != cudaSuccess)
    return 0;
  return per_sm;
}
