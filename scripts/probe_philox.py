#!/usr/bin/env python3
"""What bounds the standalone Philox kernel (``csrc/philox_mask.cu``) on
the card, what each of its design steps brings, and how it compares with
the kernel it replaced. A probe, not part of the port. It

1. measures the rates of the integer instructions a packed word is made
   of -- ``IMAD.WIDE.U32`` (both words used, or only the low one),
   ``IMAD.HI.U32``, ``IMAD``, ``LOP3``, ``ISETP``, the pack's subtract and
   add (or multiply-add) with carry, a 50/50 ``IMAD`` / ``LOP3`` mix, a
   C++ nibble of four compares (ptxas packs it by ``P2R``, which no PTX
   instruction maps to) and ``FFMA`` (128 a clock a SM: the method's
   check) -- in thread-instructions a clock a SM, with small kernels of
   its own (one CTA of 1024 threads a SM, eight independent chains a
   thread, cycles by ``clock64``), each beside the opcodes of its loop in
   the SASS;
2. prints the SASS instructions a word of ``philox_mask_kernel<7>``, by
   opcode (the loop of ``cuobjdump -sass`` over the words it makes), for
   the tree's kernel, its variants and, with ``--parent``, the parent's;
3. holds each of those kernels bitwise against the plain version
   (``philox_dropout_mask_plain``) on odd and shard-window planes;
4. times them in turns (CUDA events; the profiler's device time for the
   tree's and the parent's) at the serving plane 1x32x512x512, the QKV
   training plane 2x32x2048x2048 (the sequential yardstick's),
   TRAIN_SHAPE 1x32x4096x4096 and moonshot's 2x16x2048x2048 ((B, H, SQ,
   SK)), with the SM clock and power under each (nvidia-smi), beside the
   issue and pipe bounds of ``chip_smoke.philox_bound``;
5. with ``--parent DIR`` (the root of another checkout, e.g. unpacked
   from ``git archive <commit>``), says whether every other CUDA library
   of the tree runs the parent's machine code, instruction for
   instruction.

The variants each take one design step back or try another, from a copy
of ``csrc`` (joinable by "+"):

  no_shared_rounds  each of a word's 8 calls computed whole: its x0 and x2
                    made opaque (xor with a zero read from device memory,
                    2 instructions a call) so the compiler cannot share
                    rounds 0-2;
  one_word          one word a thread an iteration (WORDS = 1);
  two_words         two words a thread an iteration (WORDS = 2);
  not_persistent    one thread a group: as many CTAs as the plane needs;
  old_pack          the pack of the replaced kernel (compares, shifts and
                    ors: keep_nibble_of);
  nibble_pack       each call's nibble (keep_nibble_of) shifted into the
                    word: acc = acc << 4 | nibble (ptxas may pack a call's
                    four compares by P2R, on the ALU pipe);
  occupancy_5, occupancy_6  registers capped so that 5 (6) CTAs of 256
                    threads fit a SM (the kernel holds 4);
  plain_mul         __umulhi and a low multiply in place of mul.wide.u32.

    python3 scripts/probe_philox.py [--parent DIR] [--variants a,b|all|none]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
measurement, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build, philox, philox_common  # noqa: E402
from repro_torch.kernels.philox_common import threshold_from_p  # noqa: E402

KERNEL = philox.KERNEL
PLANES = {"serve": smoke.SERVE_SHAPE, "qkv": smoke.QKV_PLANE,
          "train": smoke.TRAIN_SHAPE, "moonshot": smoke.MOONSHOT_PLANE}
# (B, H, SQ, SK, heads_global, bh_offset): odd SKs, a multi-wave plane,
# shard windows
CHECKS = [(1, 32, 512, 512, 0, 0), (2, 3, 64, 1, 0, 0),
          (1, 4, 96, 97, 0, 0), (1, 2, 64, 6, 0, 0),
          (3, 5, 2080, 4097, 0, 0), (1, 4, 256, 384, 8, 12),
          (2, 3, 64, 97, 5, 7)]
_UNSHARED = r'''
// each call computed whole: x0 and x2 made opaque per call by a zero read
// from device memory, so that nothing of rounds 0-2 is shared
__device__ uint32_t g_zero;

template <int ROUNDS>
__device__ __forceinline__ uint32_t word_unshared(
    uint32_t k, uint32_t q32, uint32_t bh, uint32_t salt, uint32_t k0,
    uint32_t k1, uint32_t threshold) {
  using namespace repro_philox;
  const uint32_t zero = *reinterpret_cast<volatile uint32_t*>(&g_zero);
  uint32_t acc = 0;
#pragma unroll
  for (int t = 7; t >= 0; --t) {
    const uint32_t z = zero * static_cast<uint32_t>(t);
    uint32_t x0 = k ^ z, x1 = q32 * 8u + static_cast<uint32_t>(t),
             x2 = bh ^ z, x3 = salt;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const Wide d0 = mul_wide(kM0, x0);
      const Wide d1 = mul_wide(kM1, x2);
      x0 = d1.hi ^ x1 ^ (k0 + static_cast<uint32_t>(r) * kW0);
      x2 = d0.hi ^ x3 ^ (k1 + static_cast<uint32_t>(r) * kW1);
      x1 = d1.lo;
      x3 = d0.lo;
    }
    acc = push_keep(acc, x3, threshold);
    acc = push_keep(acc, x2, threshold);
    acc = push_keep(acc, x1, threshold);
    acc = push_keep(acc, x0, threshold);
  }
  return acc;
}

template <int ROUNDS, bool VEC>
'''
# variant -> (edits (file, old, new), words a thread an iteration)
VARIANTS = {
    "no_shared_rounds": (
        [("philox_mask.cu", "repro_philox::packed_word_shared<ROUNDS>(",
          "word_unshared<ROUNDS>("),
         ("philox_mask.cu", "\ntemplate <int ROUNDS, bool VEC>\n",
          _UNSHARED)], None),
    "one_word": (
        [("philox_walk.cuh", "constexpr int WORDS = 4;",
          "constexpr int WORDS = 1;")], 1),
    "two_words": (
        [("philox_walk.cuh", "constexpr int WORDS = 4;",
          "constexpr int WORDS = 2;")], 2),
    "not_persistent": (
        [("philox_walk.cuh",
          "const uint64_t most = static_cast<uint64_t>(sms) * per_sm;",
          "const uint64_t most = need;")], None),
    "old_pack": (
        [("philox.cuh",
          "    acc = push_keep(acc, x3, threshold);\n"
          "    acc = push_keep(acc, x2, threshold);\n"
          "    acc = push_keep(acc, x1, threshold);\n"
          "    acc = push_keep(acc, x0, threshold);\n"
          "  }\n  return acc;",
          "    acc |= keep_nibble_of(Words{x0, x1, x2, x3}, threshold)\n"
          "           << (4u * static_cast<uint32_t>(t));\n"
          "  }\n  return acc;")], None),
    "nibble_pack": (
        [("philox.cuh",
          "    acc = push_keep(acc, x3, threshold);\n"
          "    acc = push_keep(acc, x2, threshold);\n"
          "    acc = push_keep(acc, x1, threshold);\n"
          "    acc = push_keep(acc, x0, threshold);\n",
          "    acc = (acc << 4) | keep_nibble_of(Words{x0, x1, x2, x3}, "
          "threshold);\n")], None),
    "occupancy_5": (
        [("philox_mask.cu", "__global__ void __launch_bounds__(kThreads)",
          "__global__ void __launch_bounds__(kThreads, 5)")], None),
    "occupancy_6": (
        [("philox_mask.cu", "__global__ void __launch_bounds__(kThreads)",
          "__global__ void __launch_bounds__(kThreads, 6)")], None),
    "plain_mul": (
        [("philox.cuh",
          '  uint64_t p;\n  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : '
          '"r"(a), "r"(b));\n',
          "  const uint64_t p =\n      (static_cast<uint64_t>(__umulhi(a, "
          "b)) << 32) | (a * b);\n")], None),
}

RATES_SRC = r'''
#include <cstdint>
#include <cuda_runtime.h>

// One CTA of 1024 threads a SM (the dynamic shared memory keeps a second
// one out), eight independent chains a thread, OPS instructions a chain
// an iteration; thread 0 writes the CTA's clock64 cycles.
#define LOOP(BODY)                                                    \
  extern __shared__ uint32_t pad[];                                   \
  __syncthreads();                                                    \
  const long long t0 = clock64();                                     \
  for (int i = 0; i < iters; ++i) {                                   \
    _Pragma("unroll") for (int u = 0; u < 8; ++u) {                   \
      _Pragma("unroll") for (int c = 0; c < 8; ++c) { BODY; }         \
    }                                                                 \
  }                                                                   \
  __syncthreads();                                                    \
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;          \
  if (iters < 0) pad[threadIdx.x] = 0;

// every chain's multiplicand is the chain's own last value, so that
// ptxas cannot hoist a product out of the loop
__global__ void __launch_bounds__(1024) rate_imad_wide(
    uint32_t a, uint32_t b, int iters, long long* cycles, uint64_t* out) {
  uint64_t x[8];
  for (int c = 0; c < 8; ++c) x[c] = threadIdx.x + c;
  LOOP(asm volatile("{\n\t.reg .u32 l, h;\n\tmov.b64 {l, h}, %0;\n\t"
                    "mul.wide.u32 %0, l, %1;\n\t}" : "+l"(x[c])
                    : "r"(a + c)))
  uint64_t s = 0;
  for (int c = 0; c < 8; ++c) s ^= x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

#define RATE32(NAME, ASM)                                              \
  __global__ void __launch_bounds__(1024) NAME(                       \
      uint32_t a, uint32_t b, int iters, long long* cycles,          \
      uint64_t* out) {                                                \
    uint32_t x[8];                                                    \
    for (int c = 0; c < 8; ++c) x[c] = threadIdx.x + c;               \
    LOOP(asm volatile(ASM : "+r"(x[c]) : "r"(a + c), "r"(b)))         \
    uint32_t s = 0;                                                   \
    for (int c = 0; c < 8; ++c) s ^= x[c];                            \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                   \
  }

// a Philox-like step: both words of a product, xor'ed into the next input
RATE32(rate_imad_wide_xor,
       "{\n\t.reg .u32 l, h;\n\t.reg .u64 d;\n\t"
       "mul.wide.u32 d, %0, %1;\n\tmov.b64 {l, h}, d;\n\t"
       "xor.b32 %0, l, h;\n\t}")
RATE32(rate_imad_hi, "mad.hi.u32 %0, %0, %1, %2;")
RATE32(rate_imad, "mad.lo.u32 %0, %0, %1, %2;")
RATE32(rate_lop3, "lop3.b32 %0, %0, %1, %2, 0x96;")
// ISETP: a predicate chain xor'ed with a compare, in one block per
// instruction pair so the predicate lives across them
RATE32(rate_isetp,
       "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %0, 0;\n\t"
       "setp.ge.u32.xor p, %1, %2, p;\n\tsetp.ge.u32.xor p, %2, %1, p;\n\t"
       "setp.lt.u32.xor p, %1, %2, p;\n\tsetp.lt.u32.xor p, %2, %1, p;\n\t"
       "setp.gt.u32.xor p, %1, %2, p;\n\tsetp.gt.u32.xor p, %2, %1, p;\n\t"
       "selp.u32 %0, 1, 0, p;\n\t}")
// the pack's pair (push_keep): a subtract's carry out taken in by an add
// (acc + acc + carry)
RATE32(rate_pack,
       "{\n\t.reg .u32 d;\n\tsub.cc.u32 d, %0, %1;\n\t"
       "addc.u32 %0, %0, %0;\n\t}")
// the same with the carry taken in by a multiply-add by a run-time 2 (b)
RATE32(rate_pack_madc,
       "{\n\t.reg .u32 d;\n\tsub.cc.u32 d, %0, %1;\n\t"
       "madc.lo.u32 %0, %0, %2, 0;\n\t}")
// IMAD and LOP3, one each, on two chains
RATE32(rate_mix,
       "mad.lo.u32 %0, %0, %1, %2;\n\t"
       "lop3.b32 %0, %0, %1, %2, 0x96;")

// four compares packed into a nibble, in C++: ptxas's own form (P2R, if
// it makes one)
__global__ void __launch_bounds__(1024) rate_nibble(
    uint32_t a, uint32_t b, int iters, long long* cycles, uint64_t* out) {
  uint32_t x[8];
  for (int c = 0; c < 8; ++c) x[c] = threadIdx.x * 2654435761u + c;
  LOOP(x[c] = (x[c] * b) ^ ((x[c] >= a) | ((x[c] + 1u >= a) << 1) |
                            ((x[c] + 2u >= a) << 2) |
                            ((x[c] + 3u >= a) << 3)))
  uint32_t s = 0;
  for (int c = 0; c < 8; ++c) s ^= x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(1024) rate_ffma(
    uint32_t a, uint32_t b, int iters, long long* cycles, uint64_t* out) {
  float x[8];
  const float fa = __uint_as_float(0x3f800001u + (a & 1)),
              fb = __uint_as_float(0x3c000000u + (b & 1));
  for (int c = 0; c < 8; ++c) x[c] = threadIdx.x + c;
  LOOP(asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x[c])
                    : "f"(fa), "f"(fb)))
  float s = 0;
  for (int c = 0; c < 8; ++c) s += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_uint(s);
}

typedef void (*RateFn)(uint32_t, uint32_t, int, long long*, uint64_t*);

extern "C" int repro_rate(const char* name, int ctas, int smem, int iters,
                          long long* cycles, uint64_t* out) {
  RateFn fn = nullptr;
  const struct { const char* n; RateFn f; } table[] = {
      {"imad_wide", rate_imad_wide}, {"imad_wide_xor", rate_imad_wide_xor},
      {"imad_hi", rate_imad_hi},
      {"imad", rate_imad}, {"lop3", rate_lop3}, {"isetp", rate_isetp},
      {"pack", rate_pack}, {"pack_madc", rate_pack_madc},
      {"mix", rate_mix}, {"nibble", rate_nibble}, {"ffma", rate_ffma}};
  for (const auto& e : table) {
    const char* x = e.n;
    const char* y = name;
    while (*x && *x == *y) ++x, ++y;
    if (*x == 0 && *y == 0) fn = e.f;
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<ctas, 1024, smem>>>(0x9E3779B9u, 2u, iters, cycles, out);
  return static_cast<int>(cudaGetLastError());
}
'''
# name -> (SASS opcode the rate is of, instructions of it an iteration of
# one chain, what the kernel's loop is)
RATES = {
    "imad_wide": ("IMAD.WIDE.U32", 1, "mul.wide.u32 of the last low word"),
    "imad_wide_xor": ("IMAD.WIDE.U32", 1,
                      "mul.wide.u32, then the two words xor'ed"),
    "imad_hi": ("IMAD.HI.U32", 1, "mad.hi.u32"),
    "imad": ("IMAD", 1, "mad.lo.u32"),
    "lop3": ("LOP3.LUT", 1, "lop3.b32"),
    "isetp": ("ISETP", 6, "6 chained setp.*.xor"),
    "pack": (None, 2, "sub.cc + addc: acc + acc + carry (push_keep)"),
    "pack_madc": (None, 2, "sub.cc + madc.lo by a run-time 2"),
    "mix": (None, 2, "mad.lo + lop3 on one chain"),
    "nibble": ("P2R", 1, "a multiply and a nibble of 4 compares, C++"),
    "ffma": ("FFMA", 1, "fma.rn.f32"),
}


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuobjdump(lib) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def sass_functions(lib) -> list:
    """The library's kernels as sorted instruction sequences (SASS without
    addresses, encodings or function names): two libraries whose lists
    are equal run the same machine code."""
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    return sorted(tuple(instruction.findall(body))
                  for body in cuobjdump(lib).split("Function : ")[1:])


def functions(lib) -> dict:
    """mangled name -> [(address, instruction)] of each kernel."""
    out = {}
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    for body in cuobjdump(lib).split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        out[name] = [(int(a, 16), ins) for a, ins in line.findall(body)]
    return out


def opcode(ins: str) -> str:
    """The mnemonic of one SASS instruction (its predicate guard dropped)."""
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def loop_body(code):
    """The instructions of the function's largest loop: from a backward
    branch's target to the branch."""
    best = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
            if len(body) > len(best):
                best = body
    return best


def per_word(lib, words: int, rounds: int = 7) -> dict:
    """instance (VEC or not) -> (instructions a word, Counter of opcodes a
    word, CALLs in the loop) of philox_mask_kernel<rounds> in ``lib``."""
    out = {}
    for name, code in functions(lib).items():
        if f"philox_mask_kernelILi{rounds}E" not in name:
            continue
        vec = "Lb1E" in name
        body = loop_body(code)
        ops = Counter(opcode(i) for i in body)
        out["vec" if vec else "scalar"] = (
            len(body) / words, Counter({k: v / words for k, v in
                                        ops.items()}),
            sum(1 for i in body if opcode(i).startswith("CALL")))
    return out


def pipes(ops: Counter) -> str:
    """A word's instructions by pipe: the multiply-add pipe's (IMAD*), the
    ALU's (LOP3, ISETP, IADD3, SHF, LEA, SEL, P2R, ...), the rest."""
    imad = sum(v for k, v in ops.items() if k.startswith("IMAD"))
    alu = sum(v for k, v in ops.items()
              if k.split(".")[0] in ("LOP3", "ISETP", "IADD3", "SHF", "LEA",
                                     "SEL", "P2R", "R2P", "IABS", "ISCADD",
                                     "LOP", "PRMT", "BMSK", "SGXT", "FLO",
                                     "POPC", "MOV", "VIADD", "IMNMX"))
    rest = sum(ops.values()) - imad - alu
    return f"multiply-add pipe {imad:.1f}, ALU {alu:.1f}, other {rest:.1f}"


def nvcc_job(src: Path, lib: Path, extra=()):
    return subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str) -> str:
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    return (f"registers {sorted({int(r) for r in regs})}, spill bytes "
            f"{sorted({int(a) + int(b) for a, b in spills})}")


def build_all(parent, variants, out: Path):
    """(side, library) -> path: the tree's libraries (build.build_all), the
    variants' and the parent's philox_mask, with --parent the parent's
    other libraries, and the rate kernels; one nvcc each, together."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jobs = {}
    for name in variants:
        csrc = out / name
        shutil.copytree(build.CSRC, csrc)
        for part in name.split("+"):
            for fname, old, new in VARIANTS[part][0]:
                body = (csrc / fname).read_text()
                if body.count(old) != 1:
                    raise RuntimeError(f"{name}: the edit of {old!r} does "
                                       f"not apply to {fname}")
                (csrc / fname).write_text(body.replace(old, new))
        jobs[(name, KERNEL)] = csrc / f"{KERNEL}.cu"
    if parent is not None:
        pcsrc = Path(parent) / "src/repro_torch/kernels/csrc"
        for lib in build.sources():
            if (pcsrc / f"{lib}.cu").exists():
                jobs[("parent", lib)] = pcsrc / f"{lib}.cu"
    (out / "rates.cu").write_text(RATES_SRC)
    jobs[("rates", "rates")] = out / "rates.cu"
    procs = {key: (out / f"lib{key[0]}_{key[1]}.so",
                   nvcc_job(src, out / f"lib{key[0]}_{key[1]}.so"))
             for key, src in jobs.items()}
    libs = {("tree", name): path
            for name, path in build.build_all().items()}
    print(f"[build] tree {KERNEL}: "
          f"{ptxas_lines(build.log_path(KERNEL).read_text())}", flush=True)
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        if key[1] == KERNEL:
            print(f"[build] {key[0]} {KERNEL}: {ptxas_lines(log)}",
                  flush=True)
        libs[key] = lib
    return libs


def bind(lib):
    like = philox._kernel_fn()
    fn = ctypes.CDLL(str(lib)).repro_philox_mask
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn


def launcher(fn, out, rounds=7, threshold=None, heads_global=0,
             bh_offset=0):
    args = dict(key_lo=0x1234, key_hi=0x5678, salt=7,
                threshold=threshold_from_p(0.1) if threshold is None
                else threshold, rounds=rounds, heads_global=heads_global,
                bh_offset=bh_offset)

    def run():
        philox._fn = fn
        philox.philox_mask_into(out, **args)
    return run


def check(fn, label, card) -> bool:
    """The library's planes against the plain version, bitwise: p = 0.1
    on every plane of CHECKS (every round count at SK = 97), and on the
    first, thresholds 0 (p = 0), 2^31, 2^32 - 1 (p = 1) and one of the
    plane's own Philox words and the next (the compare's edge)."""
    ok = True
    edge = philox_common.philox4x32(77, 45 // 4, 1, 7, 0x1234, 0x5678,
                                    7)[45 % 4]
    cases = [(c, r, threshold_from_p(0.1)) for c in CHECKS
             for r in ((3, 5, 7, 10) if c[3] == 97 and not c[4] else (7,))]
    cases += [(CHECKS[0], 7, t) for t in (0, 2 ** 31, 2 ** 32 - 1, edge,
                                          edge + 1)]
    for (b, h, sq, sk, hg, off), rounds, thr in cases:
        out = torch.empty((b, h, sq // 32, sk), dtype=torch.int32,
                          device="cuda")
        launcher(fn, out, rounds, thr, hg, off)()
        want = philox._plain_words(
            b, h, sq // 32, sk, 0x1234, 0x5678, 7, thr, rounds, hg or h, off,
            out.device).reshape(out.shape)
        torch.cuda.synchronize()
        same = torch.equal(out, want)
        ok &= same
        if not same:
            print(f"[check] {label} {(b, h, sq, sk)} window ({hg}, {off}) "
                  f"rounds {rounds} threshold {thr:#x}: WRONG | {card}",
                  flush=True)
    print(f"[check] {label}: every plane == plain bitwise {ok} | {card}",
          flush=True)
    return ok


def rates(lib, card) -> None:
    fn = ctypes.CDLL(str(lib)).repro_rate
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = functions(lib)
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    out = torch.empty(sms * 1024, dtype=torch.int64, device="cuda")
    iters = 2000
    for name, (op, per, what) in RATES.items():
        err = fn(name.encode(), sms, 160 * 1024, iters, cycles.data_ptr(),
                 out.data_ptr())
        if err:
            raise RuntimeError(f"rate {name}: cudaError {err}")
        torch.cuda.synchronize()
        err = fn(name.encode(), sms, 160 * 1024, iters, cycles.data_ptr(),
                 out.data_ptr())
        torch.cuda.synchronize()
        cyc = statistics.median(cycles.tolist())
        body = loop_body(next(c for n, c in code.items()
                              if f"rate_{name}" in n))
        ops = Counter(opcode(i) for i in body)
        # instructions of the loop an iteration (the compiler may unroll
        # the iteration loop: count its chain ops to find how many)
        rate = 1024 * iters * 8 * 8 * per / cyc
        shown = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
        # the loop body holds `unroll` iterations of 64 chain steps (the
        # chain's own instructions counted by the opcode, else by the
        # loop's length less its 3 of control)
        steps = (ops[op] / per if op else (len(body) - 3) / per)
        unroll = max(1, round(steps / 64))
        all_rate = 1024 * iters / unroll * len(body) / cyc
        print(f"[rate] {name} ({what}): {rate:.1f} thread-instructions a "
              f"clock a SM of the {per} a chain step"
              + (f" ({op})" if op else "")
              + f"; all of the loop {all_rate:.1f}; median {cyc:.0f} cycles "
              f"a SM; its loop in the SASS {len(body)} instructions: "
              f"{shown} | {card}", flush=True)


def in_turns(fns: dict, rounds: int = 3, iters: int = 20) -> dict:
    """name -> (median ms, readings) of each callable, in turns (the order
    reversed every other round)."""
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(smoke.cuda_time_ms(fns[name], iters,
                                                  warmup=5))
    return {name: (statistics.median(t), t) for name, t in times.items()}


def clocks_under(fn, seconds: float = 1.5) -> str:
    """The SM clock and the board's power draw (nvidia-smi every 20 ms;
    medians) while ``fn`` runs back to back for about ``seconds``."""
    n = max(1, int(seconds * 1e3 / smoke.cuda_time_ms(fn, 3, warmup=2)))
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    sampler.terminate()
    rows = [ln.split(",") for ln in sampler.communicate()[0].splitlines()
            if ln.count(",") == 1]
    mhz = statistics.median(float(r[0]) for r in rows) if rows else None
    watts = statistics.median(float(r[1]) for r in rows) if rows else None
    return f"SM clock {mhz} MHz, power {watts} W (median of {len(rows)})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose "
                    "libraries to build and compare")
    ap.add_argument("--variants", default="all",
                    help="comma-separated variants, 'all' or 'none'")
    ap.add_argument("--no-rates", action="store_true",
                    help="skip the instruction-rate kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_philox: no CUDA device", file=sys.stderr)
        return 1
    variants = (list(VARIANTS) if args.variants == "all" else
                [] if args.variants == "none" else args.variants.split(","))
    for v in variants:
        for part in v.split("+"):
            VARIANTS[part]
    card = smi()
    libs = build_all(args.parent, variants, build.build_dir() / "probe_philox")
    words = int(re.search(r"constexpr int WORDS = (\d+);",
                          (build.CSRC / "philox_walk.cuh").read_text())[1])
    words_of = {"tree": words, "parent": 1}
    for v in variants:
        words_of[v] = next((VARIANTS[p][1] for p in v.split("+")
                            if VARIANTS[p][1]), words)
    sides = ["tree"] + (["parent"] if args.parent else []) + variants
    for side in sides:
        lib = ctypes.CDLL(str(libs[(side, KERNEL)]))
        occ = getattr(lib, "repro_philox_mask_ctas_per_sm", None)
        for inst, (n, ops, calls) in per_word(libs[(side, KERNEL)],
                                              words_of[side]).items():
            shown = ", ".join(f"{k} {v:.2f}" for k, v in ops.most_common())
            ctas = (f"; {occ(7, int(inst == 'vec'))} CTAs of 256 a SM"
                    if occ else "")
            print(f"[sass] {side} philox_mask_kernel<7> {inst}: {n:.2f} "
                  f"instructions a word ({words_of[side]} a loop "
                  f"iteration; {calls} CALL in the loop{ctas}); "
                  f"{pipes(ops)}; {shown} | {card}", flush=True)
    if args.parent:
        for lib in build.sources():
            if lib == KERNEL or ("parent", lib) not in libs:
                continue
            mine = sass_functions(libs[("tree", lib)])
            theirs = sass_functions(libs[("parent", lib)])
            print(f"[check] {lib}: {len(mine)} kernels, "
                  f"{sum(map(len, mine))} instructions; the parent's machine "
                  f"code, instruction for instruction: {mine == theirs}",
                  flush=True)
    fns = {side: bind(libs[(side, KERNEL)]) for side in sides}
    right = [side for side in sides if check(fns[side], side, card)]
    if "tree" not in right or (args.parent and "parent" not in right):
        raise AssertionError("the tree's or the parent's kernel is wrong")
    if not args.no_rates:
        rates(libs[("rates", "rates")], card)
    ops_rate = smoke.issue_ops_per_s()
    for label, shape in PLANES.items():
        b, h, sq, sk = shape
        out = torch.empty((b, h, sq // 32, sk), dtype=torch.int32,
                          device="cuda")
        turns = {side: launcher(fns[side], out) for side in
                 (["tree", "parent"] if args.parent else ["tree"])}
        t = in_turns(turns, iters=200 if label == "serve" else 20)
        prof = {side: smoke.device_time_ms(fn, "philox_mask_kernel", 50)
                for side, fn in turns.items()}
        bound, by = smoke.philox_bound(shape, 7, ops_rate)
        parts = smoke.philox_times_ms(shape, 7, ops_rate)
        words = b * h * (sq // 32) * sk
        line = "; ".join(
            f"{side} {ms:.5f} ms ({' / '.join(f'{x:.5f}' for x in r)}; "
            f"profiler {prof[side]}; {bound / (prof[side] or ms) * 100:.1f} "
            f"% of bound)" for side, (ms, r) in t.items())
        print(f"[time] {KERNEL} {label} {b}x{h}x{sq // 32}x{sk} ({words} "
              f"words): {line}; bound {bound:.5f} ms by {by} ("
              + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
              + f") | {card}", flush=True)
        if "parent" in t:
            print(f"[time] {label}: parent / tree "
                  f"{t['parent'][0] / t['tree'][0]:.3f} (events), "
                  + (f"{prof['parent'] / prof['tree']:.3f} (profiler)"
                     if prof["tree"] and prof["parent"] else "")
                  + f" | {card}", flush=True)
        for side, fn in turns.items():
            print(f"[clock] {label} {side}: {clocks_under(fn)} | {card}",
                  flush=True)
        if label in ("serve", "qkv", "train"):
            for v in [v for v in variants if v in right]:
                vt = in_turns({"tree": turns["tree"],
                               v: launcher(fns[v], out)})
                print(f"[time] {label} variant {v}: " + ", ".join(
                    f"{name} {ms:.5f} ms "
                    f"({' / '.join(f'{x:.5f}' for x in r)})"
                    for name, (ms, r) in vt.items())
                    + f"; {v} / tree {vt[v][0] / vt['tree'][0]:.3f} | "
                    f"{card}", flush=True)
        del out
        torch.cuda.empty_cache()
    philox._fn = None
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
