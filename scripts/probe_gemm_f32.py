#!/usr/bin/env python3
"""What holds the f32 GEMM+RNG kernels back, and how they compare with the
kernels they replaced. A probe, not part of the port: it builds
``csrc/gemm_rng.cu`` and ``csrc/gemm_rng_grouped.cu`` as they are and
variants of the dense one, each from a copy of ``csrc`` with
``gemm_tc.cuh`` edited:

  no_splits    the stage's splits left out, its loads kept (C is wrong:
               a timing only);
  no_products  the stage's twelve products left out (C is wrong: a timing
               only);
  chained      no fold: every product summed into C on the tensor cores;
               its C misses the limits (a sum chained over all of K inside
               the tensor core);
  no_maxnreg   the producer keeps its registers (no setmaxnreg): the
               consumers get the launch's 168 a thread and spill;
  a_smem       A's triple through shared memory as B's (wgmma's SS form),
               split under the last stage's products, instead of A's
               fragments from registers;
  bk64         stages of 64 k, two of them in the ring, so the fold and the
               barriers come half as often;

and, with ``--parent DIR`` (the root of another checkout, e.g. unpacked
from ``git archive <commit>``), that checkout's f32 kernels (the SIMT
ones in ``gemm_f32.cuh`` where it has them) and its bf16 and e4m3
kernels. It holds every right kernel's C against the plain version at
``F32_GEMM_TOL`` (1e-3 (1 + |C|), chip_smoke.py's limit) and against the
f64 product (each reading printed, the plain version's own beside them)
and its plane against the plain one bitwise; the bf16 kernels' C and
planes against the parent's bitwise (the two share a body since the f32
kernels moved onto the tensor cores), and the e4m3 kernels' too, with
the machine code of both (cuobjdump's SASS, instruction for
instruction); and times each f32 kernel in turns with the parent's
(kernel, parent, parent, kernel; CUDA events) at llama2-7b's four host
GEMMs at B=2, S=2048 (QKV, out-projection, gate+up, down) and
moonshot-v1-16b-a3b's expert gate and down einsums and rwkv6-7b's
channel-mix key GEMM (E = 1), emission on and off, the variants in turns
with the kernel at QKV, and the bf16 and e4m3 kernels in turns with the
parent's at QKV and the expert gate.

    python3 scripts/probe_gemm_f32.py [--parent DIR]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
timing, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.producer import pick_gemm_blocks  # noqa: E402
from repro_torch.kernels import build, gemm_rng, quant  # noqa: E402

TOL = 1e-3
PLANE = (2, 32, 2048)
DENSE = (("qkv", (4096, 12288, 4096)), ("out_proj", (4096, 4096, 4096)),
         ("gate_up", (4096, 22016, 4096)), ("down", (4096, 4096, 11008)))
GROUPED = (("gate", (64, 480, 2048, 1408), (2, 16, 2048)),
           ("down", (64, 480, 1408, 2048), (2, 16, 2048)),
           ("channel_mix", (1, 4096, 4096, 14336), PLANE))
K32, G32 = gemm_rng.KERNEL, gemm_rng.KERNEL_GROUPED
K16, G16 = gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_GROUPED_BF16
K8, G8 = gemm_rng.KERNEL_FP8, gemm_rng.KERNEL_GROUPED_FP8
# A's triple through shared memory (both operands of every product read
# from there, wgmma's SS form): each warpgroup splits its 64 rows of A into
# parts of 64-byte rows (the 64-byte swizzle) behind B's parts, under the
# last stage's products as B's split
A_SMEM_FNS = """  static constexpr int PART_A = BM * BK * 2;

  __device__ static __forceinline__ void split_a(uint32_t stage,
                                                 uint32_t ta, int w, int t) {
    using repro_flash::tc::ld_shared_f4;
    using repro_flash::tc::st_shared_u4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = t + 128 * i;
      const int row = 64 * w + u / 4, q = u % 4;
      const uint32_t src = stage + row * 128;
      const float4 x = ld_shared_f4(src + (((2 * q) ^ (row & 7)) << 4));
      const float4 y = ld_shared_f4(src + (((2 * q + 1) ^ (row & 7)) << 4));
      uint32_t hi[4], mid[4], lo[4];
      split8(x, y, hi, mid, lo);
      const uint32_t dst = ta + row * 64 + ((q ^ ((row >> 1) & 3)) << 4);
      st_shared_u4(dst, hi);
      st_shared_u4(dst + PART_A, mid);
      st_shared_u4(dst + 2 * PART_A, lo);
    }
  }

  __device__ static __forceinline__ void products_ss(float (&d)[64],
                                                     uint32_t tb, int w) {
    using repro_flash::tc::part_a;
    using repro_flash::tc::part_b;
    const uint32_t ta = tb + 3 * PART_B + w * (64 * 64);
    const uint64_t da = static_cast<uint64_t>((ta & 0x3FFFFu) >> 4) |
                        (1ull << 16) |
                        (static_cast<uint64_t>(512 >> 4) << 32) |
                        (2ull << 62);
    const uint64_t db = smem_desc_mn(tb, B_HALF);
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_m64n128k16_bf16_bmn(
            d, da + ((part_a(n) * PART_A + 32 * j) >> 4),
            db + ((part_b(n) * PART_B + 2048 * j) >> 4), n > 0 || j > 0);
  }

"""
K_LOOP = ("  // The k-loop of consumer warpgroup w (rows m0 + 64 w .. of "
          "expert ex's C,\n  // which starts at `c`) over the f32 ring")
# variant -> (edits of gemm_tc.cuh, whether its C is the kernel's)
VARIANTS = {
    "no_splits": ([("      split_b(ring + s * STAGE_BYTES, tri + (kt % 2) * "
                    "TRIPLE, w, t);\n", ""),
                   ("split3(x, y, fa[0][j][q], fa[1][j][q], fa[2][j][q]);",
                    "fa[0][j][q] = fa[1][j][q] = fa[2][j][q] = "
                    "__float_as_uint(x) ^ __float_as_uint(y);")], False),
    "no_products": ([("      products(d, fa, tri + (kt % 2) * TRIPLE);\n",
                      "      for (int i = 0; i < 64; ++i) d[i] = 0.f;\n")],
                    False),
    "chained": ([("      products(d, fa, tri + (kt % 2) * TRIPLE);\n",
                  "      products(acc, fa, tri + (kt % 2) * TRIPLE);\n"),
                 ("                      n > 0 || j > 0);",
                  "                      1);"),
                 ("      fence_regs(d);\n#pragma unroll\n      for (int i = "
                  "0; i < 64; ++i) acc[i] = acc[i] + d[i];\n",
                  "      fence_regs(acc);\n")], True),
    "no_maxnreg": ([("kProducerRegs = 56;", "kProducerRegs = 0;"),
                    ("kConsumerRegs = 224;", "kConsumerRegs = 0;")], True),
    "a_smem": ([("  static constexpr int TRIPLE = 3 * PART_B;",
                 "  static constexpr int TRIPLE = 3 * PART_B + 3 * BM * BK "
                 "* 2;"),
                (K_LOOP, A_SMEM_FNS + K_LOOP),
                ("      split_b(ring + s * STAGE_BYTES, tri + (kt % 2) * "
                 "TRIPLE, w, t);\n",
                 "      split_b(ring + s * STAGE_BYTES, tri + (kt % 2) * "
                 "TRIPLE, w, t);\n      split_a(ring + s * STAGE_BYTES, tri "
                 "+ (kt % 2) * TRIPLE + 3 * PART_B, w, t);\n"),
                ("      uint32_t fa[3][SLICES][4];\n      a_frags(ring + s * "
                 "STAGE_BYTES, w, t, fa);\n", ""),
                ("      products(d, fa, tri + (kt % 2) * TRIPLE);\n",
                 "      products_ss(d, tri + (kt % 2) * TRIPLE, w);\n")],
               True),
    "bk64": ([("static constexpr int BK = 32;",
               "static constexpr int BK = 64;"),
              ("static constexpr int STAGES = 4;",
               "static constexpr int STAGES = 2;")], True),
}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def build_libraries(parent):
    """(name, kernel) -> library: the variants and the parent's GEMMs, one
    nvcc each, all started together."""
    out = build.build_dir() / "probe_gemm_f32"
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        csrc = out / name
        shutil.copytree(build.CSRC, csrc)
        body = (csrc / "gemm_tc.cuh").read_text()
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   "apply to gemm_tc.cuh")
            body = body.replace(old, new)
        (csrc / "gemm_tc.cuh").write_text(body)
        jobs[(name, K32)] = csrc / "gemm_rng.cu"
    if parent is not None:
        csrc = Path(parent) / "src/repro_torch/kernels/csrc"
        for kernel in (K32, G32, K16, G16, K8, G8):
            jobs[("parent", kernel)] = csrc / f"{kernel}.cu"
    procs = {}
    for (name, kernel), src in jobs.items():
        lib = out / f"lib{name}_{kernel}.so"
        procs[(name, kernel)] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.build_all([K32, G32, K16, G16, K8, G8])
    for kernel in (K32, G32):
        for line in build.log_path(kernel).read_text().splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                print(f"[build] kernel {kernel}: {line.strip()}", flush=True)
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        advisories = sorted({re.sub(r" in function '[^']*'|line \d+", "",
                                    ln).strip()
                             for ln in log.splitlines() if "(C75" in ln})
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = sorted({int(r) for r in re.findall(
            r"(\d+) bytes spill stores", log)})
        print(f"[build] {key[0]} {key[1]}: {regs[0]}-{regs[-1]} registers, "
              f"spill stores {spills[-1]} bytes at most; ptxas "
              f"advisories: {advisories or 'none'}", flush=True)
        libs[key] = lib
    return libs


def quant_ops(a, w, blocks):
    """The dense e4m3 host's operands and scales (JAX's layout)."""
    return (*quant.quantize_tiled(a, blocks[0], blocks[2]),
            *quant.quantize_tiled(w, blocks[2], blocks[1]))


def sass_functions(lib) -> list:
    """The library's kernels as sorted instruction sequences (cuobjdump's
    SASS without addresses, encodings or function names): two libraries
    whose lists are equal run the same machine code."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    return sorted(tuple(instruction.findall(body))
                  for body in sass.split("Function : ")[1:])


def bind(lib, kernel):
    like = gemm_rng._kernel_fn(kernel)
    fn = getattr(ctypes.CDLL(str(lib)), gemm_rng._ENTRY[kernel][1])
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn


def within(got, want):
    err = (got.float() - want.float()).abs()
    return float((err / (TOL * (1 + want.float().abs()))).max())


def cuda_ms(fn, iters=10, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose GEMM "
                    "kernels to build and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gemm_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_libraries(args.parent)
    fns = {key: bind(lib, key[1]) for key, lib in libs.items()}
    for kernel in (K16, G16, K8, G8):
        if ("parent", kernel) in libs:
            mine = sass_functions(build.library_path(kernel))
            theirs = sass_functions(libs[("parent", kernel)])
            print(f"[check] {kernel}: {len(mine)} kernels, "
                  f"{sum(map(len, mine))} instructions; the same machine "
                  f"code as the parent's, instruction for instruction: "
                  f"{mine == theirs}", flush=True)
    for kernel in (K32, G32, K16, G16, K8, G8):
        fns[("kernel", kernel)] = gemm_rng._kernel_fn(kernel)
    card = smi()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(which, kernel, a, w, em):
        gemm_rng._fns[kernel] = fns[(which, kernel)]
        fwd = (gemm_rng._forward if a.dim() == 2
               else gemm_rng._forward_grouped)
        return fwd(a, w, em)

    cases = [(label, K32, K16, (1, m, k, n), PLANE)
             for label, (m, n, k) in DENSE]
    cases += [(label, G32, G16, shape, plane)
              for label, shape, plane in GROUPED]
    for label, k32, k16, (e, m, k, n), plane in cases:
        shape = (m, k) if k32 == K32 else (e, m, k)
        wshape = (k, n) if k32 == K32 else (e, k, n)
        a = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn(wshape, generator=gen, device="cuda")
        blocks = pick_gemm_blocks(m, n, k)
        _, em = gemm_rng._emission(a, w, *plane, plane[2], 0.1,
                                   torch.tensor(77), 5, 7, *blocks, 2048, 256,
                                   0, 0, grouped=k32 == G32)
        want_c = (a @ w if k32 == K32 else torch.bmm(a, w))
        exact = (a.double() @ w.double() if k32 == K32 else
                 torch.bmm(a.double(), w.double()))
        print(f"[check] {k32} {label} plain version (cuBLAS f32): "
              f"{within(want_c, exact):.4g} of {TOL} x (1+|C|) from the f64 "
              f"product | {card}", flush=True)
        want_plane = gemm_rng._plain_plane(em, a.device)
        sides = ["kernel"] + [s for s in ("parent",) if ("parent", k32)
                              in fns]
        if k32 == K32 and label == "qkv":
            sides += list(VARIANTS)
        for which in sides:
            c, mask = run(which, k32, a, w, em)
            torch.cuda.synchronize()
            right = which not in VARIANTS or VARIANTS[which][1]
            print(f"[check] {k32} {label} {which}: C {within(c, want_c):.4g}"
                  f" of {TOL} x (1+|C|) from the plain version, "
                  f"{within(c, exact):.4g} from the f64 product"
                  f"{'' if right else ' (timing only)'}"
                  f", plane == plain {torch.equal(mask, want_plane)} | "
                  f"{card}", flush=True)
        for which in sides[1:]:
            for emit in (em, None):
                times = {"kernel": [], which: []}
                for side in ("kernel", which, which, "kernel"):
                    times[side].append(cuda_ms(
                        lambda: run(side, k32, a, w, emit), iters=5))
                print(f"[time] {k32} {label} emission "
                      f"{'on' if emit else 'off'}: kernel {times['kernel']} "
                      f"ms, {which} {times[which]} ms (in turns) | {card}",
                      flush=True)
        if ("parent", k16) in fns and label in ("qkv", "gate"):
            a16, w16 = a.to(torch.bfloat16), w.to(torch.bfloat16)
            got = run("kernel", k16, a16, w16, em)
            want = run("parent", k16, a16, w16, em)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            print(f"[check] {k16} {label}: C and plane == the parent's "
                  f"bitwise {same} | {card}", flush=True)
            for emit in (em, None):
                times = {"kernel": [], "parent": []}
                for side in ("kernel", "parent", "parent", "kernel") * 3:
                    times[side].append(cuda_ms(
                        lambda: run(side, k16, a16, w16, emit),
                        iters=20, warmup=10))
                mk, mp = (statistics.median(times[x])
                          for x in ("kernel", "parent"))
                print(f"[time] {k16} {label} emission "
                      f"{'on' if emit else 'off'}: kernel {times['kernel']} "
                      f"ms, parent {times['parent']} ms (in turns); medians "
                      f"{mk:.4f} / {mp:.4f} ms ({(mk / mp - 1) * 100:+.2f} %)"
                      f" | {card}", flush=True)
            del a16, w16
            # the e4m3 kernels (their body untouched) on the kernels'
            # K-major operands, against the parent's
            k8 = K8 if k32 == K32 else G8
            ops = (quant_ops(a, w, blocks) if k32 == K32 else
                   gemm_rng.quantize_grouped(a, w, blocks))
            if k32 == K32:
                kmajor = (ops[0], ops[1], ops[2].T.contiguous(),
                          ops[3].T.contiguous())
                fp8 = gemm_rng.gemm_rng_fp8_kmajor
            else:
                kmajor = (*ops[:2], *gemm_rng.kmajor_grouped(*ops[2:],
                                                            blocks))
                fp8 = gemm_rng.gemm_rng_grouped_fp8_kmajor

            def run8(which, emit):
                gemm_rng._fns[k8] = fns[(which, k8)]
                return fp8(*kmajor, blocks, emit)

            same = all(torch.equal(x, y) for x, y in
                       zip(run8("kernel", em), run8("parent", em)))
            print(f"[check] {k8} {label}: C and plane == the parent's "
                  f"bitwise {same} | {card}", flush=True)
            for emit in (em, None):
                times = {"kernel": [], "parent": []}
                for side in ("kernel", "parent", "parent", "kernel") * 3:
                    times[side].append(cuda_ms(lambda: run8(side, emit),
                                               iters=20, warmup=10))
                mk, mp = (statistics.median(times[x])
                          for x in ("kernel", "parent"))
                print(f"[time] {k8} {label} emission "
                      f"{'on' if emit else 'off'}: kernel {times['kernel']} "
                      f"ms, parent {times['parent']} ms (in turns); medians "
                      f"{mk:.4f} / {mp:.4f} ms ({(mk / mp - 1) * 100:+.2f} %)"
                      f" | {card}", flush=True)
            del ops, kmajor
        del a, w, want_c, want_plane, exact
        torch.cuda.empty_cache()
    for kernel in (K32, G32, K16, G16, K8, G8):
        gemm_rng._fns[kernel] = fns[("kernel", kernel)]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
