#!/usr/bin/env python3
"""The tensor cores' rate for the wgmma forms the flash kernels issue, on
the card. A probe, not part of the port: it builds one small CUDA library
whose kernel has every CTA (one an SM, 132) run one or two warpgroups,
each issuing batches of 12 chained bf16 m64nNk16 products into one f32
accumulator -- A from registers (RS) or from shared memory (SS), B from
shared memory K-major or MN-major (the transpose bit) in the 128-byte
swizzle of the flash kernels' tiles (``flash_sm90.cuh``: ``desc_k``,
``desc_mn``) -- committing each batch and waiting for all but the last
(two batches in flight), and prints for each form and warpgroup count the
SM clocks a product takes (``clock64`` around the batches, over the
products a warpgroup issued, divided by the warpgroups an SM runs) beside
what the tensor rate allows (N / 2 clocks: 2 x 64 x N x 16 operations at
4,096 a clock), and the TFLOP/s of the launch by CUDA events. With two
warpgroups it also runs each form with the second warpgroup issuing no
product but SIMT work for as long as the first issues its products --
f32 multiply-adds and exponentials, as a consumer's softmax, or 32-bit
integer multiply-adds, as its Philox keep bits -- and prints the first's
clocks a product under that load.

    python3 scripts/probe_wgmma_rate.py [--iters N]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a form, each with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

NS = (64, 128, 256)
# (name, A from registers, B MN-major)
FORMS = (("RS, B MN-major", True, True), ("RS, B K-major", True, False),
         ("SS, B K-major", False, False), ("SS, B MN-major", False, True))


def wgmma_fn(n: int, rs: bool, mn: bool) -> str:
    """The CUDA function issuing one m64n{n}k16 product of the form."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    name = f"mma_{'rs' if rs else 'ss'}_{'mn' if mn else 'k'}_{n}"
    if rs:
        a_ops = f"{{%{regs}, %{regs + 1}, %{regs + 2}, %{regs + 3}}}"
        return (
            f"__device__ __forceinline__ void {name}(float (&d)[{regs}], "
            f"const uint32_t (&a)[4], uint64_t db) {{\n"
            f'  asm volatile("wgmma.mma_async.sync.aligned.m64n{n}k16.f32.'
            f'bf16.bf16 {{{outs}}}, {a_ops}, %{regs + 4}, 1, 1, 1, '
            f'{int(mn)};"\n'
            f'      : {cons}\n'
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
            f'"l"(db));\n}}\n')
    return (
        f"__device__ __forceinline__ void {name}(float (&d)[{regs}], "
        f"uint64_t da, uint64_t db) {{\n"
        f'  asm volatile("wgmma.mma_async.sync.aligned.m64n{n}k16.f32.'
        f'bf16.bf16 {{{outs}}}, %{regs}, %{regs + 1}, 1, 1, 1, 0, '
        f'{int(mn)};"\n'
        f'      : {cons}\n'
        f'      : "l"(da), "l"(db));\n}}\n')


def source() -> str:
    funcs = "".join(wgmma_fn(n, rs, mn) for n in NS for _, rs, mn in FORMS)
    cases = []
    for n in NS:
        for f, (_, rs, mn) in enumerate(FORMS):
            name = f"mma_{'rs' if rs else 'ss'}_{'mn' if mn else 'k'}_{n}"
            call = (f"{name}(acc, a, desc(b, j % 4, {int(mn)}))" if rs else
                    f"{name}(acc, desc(sa, j % 4, 0), "
                    f"desc(b, j % 4, {int(mn)}))")
            cases.append(
                f"    case {n * 10 + f}: {{\n"
                f"      float acc[{n // 2}];\n"
                f"      for (int i = 0; i < {n // 2}; ++i) acc[i] = 0.f;\n"
                f"      if (simt && wg == 1) {{\n"
                f"        busy(simt, done, out);\n"
                f"        break;\n"
                f"      }}\n"
                f"      wgmma_fence();\n"
                f"      const long long t0 = clock64();\n"
                f"      for (int it = 0; it < iters; ++it) {{\n"
                f"#pragma unroll\n"
                f"        for (int j = 0; j < 12; ++j) {call};\n"
                f"        wgmma_commit();\n"
                f"        wgmma_wait1();\n"
                f"      }}\n"
                f"      wgmma_wait0();\n"
                f"      const long long t1 = clock64();\n"
                f"      if (threadIdx.x == 0) *done = 1;\n"
                f"      float s = 0.f;\n"
                f"      for (int i = 0; i < {n // 2}; ++i) s += acc[i];\n"
                f"      if (threadIdx.x % 128 == 0) {{\n"
                f"        out[2 * (blockIdx.x * 2 + wg)] = t1 - t0;\n"
                f"        out[2 * (blockIdx.x * 2 + wg) + 1] = (long long)s;"
                f"\n      }}\n"
                f"      break;\n    }}\n")
    return f"""// wgmma rate probe (scripts/probe_wgmma_rate.py)
#include <cuda_runtime.h>
#include <cstdint>
#include "gemm_sm90.cuh"
using namespace repro_gemm::sm90;

// a K-major (mn = 0) or MN-major (mn = 1) descriptor of k16 slice j of the
// 128-byte-swizzled 64-row tile at `tile` (flash_sm90.cuh: desc_k, desc_mn)
__device__ __forceinline__ uint64_t desc(uint32_t tile, int j, int mn) {{
  const uint32_t addr = mn ? tile + j * 16 * 128
                           : tile + (j / 4) * 64 * 128 + (j % 4) * 32;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(mn ? (64 * 128) >> 4 : 1) << 16) |
         (static_cast<uint64_t>((8 * 128) >> 4) << 32) | (1ull << 62);
}}

// SIMT work until *done: f32 multiply-adds and exponentials (simt = 1)
// or 32-bit integer multiply-adds (simt = 2), eight chains a thread
__device__ __forceinline__ void busy(int simt, volatile int* done,
                                  long long* out) {{
  float f[8];
  uint32_t u[8];
  for (int i = 0; i < 8; ++i) {{
    f[i] = 1.f + threadIdx.x * 1e-3f + i;
    u[i] = threadIdx.x * 2654435761u + i;
  }}
  while (!*done) {{
    for (int r = 0; r < 64; ++r) {{
      if (simt == 1) {{
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = expf(f[i] * 0.5f - 1.f) + 0.25f;
      }} else {{
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = u[i] * 0xD2511F53u + (u[i] >> 7);
      }}
    }}
  }}
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += f[i] + u[i];
  if (s == 1234.5f) out[0] = 0;
}}

{funcs}
__global__ void __launch_bounds__(256, 1)
    rate_kernel(int form, int iters, int simt, long long* out) {{
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base, b = base + 32768;
  __shared__ int done_flag;
  volatile int* done = &done_flag;
  if (threadIdx.x == 0) done_flag = 0;
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem_raw + (base - smem_u32(smem_raw)))[i] =
        0x3c003c00u ^ (i * 2654435761u & 0x00ff00ffu);
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u + threadIdx.x + i;
  switch (form) {{
{''.join(cases)}  }}
}}

extern "C" int repro_wgmma_rate(int form, int wgs, int iters, int simt,
                                void* out, void* stream) {{
  const int smem = 1024 + 65536;
  cudaError_t err = cudaFuncSetAttribute(
      rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rate_kernel<<<132, 128 * wgs, smem, static_cast<cudaStream_t>(stream)>>>(
      form, iters, simt, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000,
                    help="batches of 12 products a warpgroup")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_wgmma_rate: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    out_dir = build.build_dir() / "probe_wgmma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "wgmma_rate.cu"
    src.write_text(source())
    lib_path = out_dir / "libwgmma_rate.so"
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                          "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed\n{res.stdout}\n{res.stderr}")
    serialized = [ln for ln in (res.stdout + res.stderr).splitlines()
                  if "serialized" in ln]
    print(f"[build] ptxas's wgmma serialization advisories: "
          f"{serialized or 'none'}", flush=True)
    fn = ctypes.CDLL(str(lib_path)).repro_wgmma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(132 * 2 * 2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n in NS:
        for f, (label, _, _) in enumerate(FORMS):
            for wgs, simt in ((1, 0), (2, 0), (2, 1), (2, 2)):
                def run():
                    err = fn(n * 10 + f, wgs, args.iters, simt,
                             out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                ms = smoke.cuda_time_ms(run, 3, warmup=1)
                issuing = 1 if simt else wgs
                clocks = out.view(132, 2, 2)[:, :issuing, 0].double()
                per = float(clocks.mean()) / (args.iters * 12) / issuing
                flops = 132 * issuing * args.iters * 12 * 2 * 64 * n * 16
                beside = ("" if not simt else
                          ", the other warpgroup busy with "
                          + ("f32 multiply-adds and exponentials" if simt == 1
                             else "integer multiply-adds"))
                print(f"[rate] m64n{n}k16 {label}, {issuing} warpgroup(s) "
                      f"issuing an SM{beside}: {per:.1f} SM clocks a product "
                      f"(the tensor rate allows {n / 2:.0f}); "
                      f"{flops / ms / 1e9:.1f} TFLOP/s | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
