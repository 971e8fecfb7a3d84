#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  0. the card: name, count, ``nvidia-smi`` name and power limit;
  1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all started together) for sm_90a and print ptxas's
     register and spill lines, the tensor-core kernels' dynamic shared
     memory and ptxas advisories, and the HGMMA (wgmma) instructions in
     each tensor-core library's SASS (``cuobjdump --dump-sass``); the
     flash libraries' registers and spills by head dim (the f32 ones may
     not spill at D = 128, none at D = 256), the f32 GEMM+RNG
     libraries' (which may not spill), and holds the flash libraries
     that gained the D = 256 instances to the parent commit's SASS at
     D <= 128 (FLASH_NARROW_SASS); where a checkout of the parent commit
     is unpacked in build/parent, its bf16 dq and dkv are built beside
     them for phase 2;
  2. each kernel against its plain PyTorch version on the card, then
     timed with CUDA events beside its bound and, where one PyTorch call
     computes the same function, that call's time: the Philox kernel
     bitwise (every round count and p in {0, 0.1, 1}, shard windows, SK
     of 1, 6, 97 and 4097, a plane of several waves of its persistent
     grid, a threshold equal to one of the plane's words, and the first
     and last head rows of a plane of 2^31 words; the plain version on
     the card against the plain version on the CPU), timed at the serving,
     QKV, training and moonshot planes beside its bound (philox_bound:
     the fewest instructions a word needs at the issue rate and on the
     busier integer pipe); the fused GEMM+RNG kernel at the training QKV
     shape (4096 x 12288 x 4096; on the tensor cores, both f32 operands
     split into exact bf16 triples, six part products an f32 product;
     plane bitwise, C within F32_GEMM_TOL of the plain version and
     F32_GEMM_F64_TOL of the f64 product, limits the plain GEMM on
     bf16-rounded A, W must fail; timed with the emission on and off in turns beside its bound at
     that rate and the f32 SIMT rate's) and at a Region-3 shape (its
     plain-GEMM variant); flash forward, dq and
     dkv at B=2, H=32, S=2048, D=128 in all four dropout modes, with a
     local window, with yi-6b's GQA (32 q / 4 kv heads), at D=64 and at
     SQ=1024 and 960 < SK (all three on the tensor cores, every f32
     product as six bf16 products of the operands' exact triples; their
     bound at that rate, the f32 SIMT rate's beside it, the forward's
     time against SDPA's forward and the dq + dkv pair's against SDPA's
     whole backward; f32 O and lse within F32_FWD_TOL, the gradients
     within GRAD_TOL, limits that the plain forward on bf16-rounded K, V
     and the plain backward on bf16-rounded K, V, dO must fail), and the
     f32 flash kernels at head_dim 256 (recurrentgemma-9b's LOCAL layer
     and small GQA / MHA shapes, as the bf16 ones below, at the f32
     limits with both controls; the
     redesigned bf16 dq and dkv timed in turns with the parent commit's
     where phase 1 built those, the share of the bf16 O, dq, dk and dv
     values that differ from the plain version's printed for the tree
     and the parent, SDPA's causal call without the window printed beside
     the masked one);
  3. serving: the reduced llama2 on the card against the same engine on
     the CPU, then ``ServeEngine`` on llama2-7b at full width and depth
     (f32 random weights from a seed): 8 requests, 4 slots, 64 new tokens
     each; every request finishes, logits stay finite, the Philox kernel
     launches exactly once per mask-cache miss (8 x 32 = 256), and every
     plane the cache created equals the plain version bitwise;
  4. training reference: ``make_train_step`` on the reduced llama2 and yi
     (B=2, S=128; S=256 for the bf16 MoE and RWKV-hybrid runs; site
     "qkv", flash kernels, replay and premask) on the
     card against the same steps on the CPU, 3 steps, allclose at 1e-4;
  5. training at width: llama2-7b at full width and 4 layers (f32 random
     weights from a seed, 1.07 B parameters), B=2, S=2048, p=0.1, site
     "qkv", remat="block": 3 steps planned "replay host=gemm_rng" and
     step 0 again planned "gemm_rng" (premask); every kernel launches as
     often as the schedule and remat imply; replay and premask give
     bitwise equal step-0 losses, gradients and updated weights; the
     plane the fused kernel emits for layer 0 equals the plain version;
     step 0 agrees with the same step through tensor ops only (site
     "xla", attn_impl "xla"); step time, tokens/s, peak memory and a
     profiler trace of one step;
  6. the fp8 host and the carried sites at the same width: site "ffn_up"
     with gemm_dtype "fp8" (the next layer's plane made under each
     block's gate+up GEMM by the e4m3 kernel), 3 replay steps and step 0
     again under premask (bootstrap plane from the Philox kernel, carried
     planes), bitwise equal as in 5; launches against the schedule's
     formula; then one step each of prev_gemm/fp8, ffn_down/fp8, qkv/fp8
     and ffn_up/f32, whose step-0 losses agree with the f32 ones (1e-4 in
     f32, within the e4m3 error in fp8);
  7. MoE training at width: moonshot-v1-16b-a3b at full width and 4 of
     its 48 layers (L0 dense, L1-L3 MoE: 64 experts top-6, capacity 480;
     2.46 B f32 parameters from a seed, the state donated to each step so
     one copy of it fits on the card), B=2, S=2048, p=0.1,
     remat="block", site "ffn_up" / fp8: the next layer's plane made under
     L0's dense gate+up GEMM (the e4m3 kernel) and under L1-L3's grouped
     expert gate einsum (the grouped e4m3 kernel); 3 replay steps and step
     0 again under premask, bitwise equal (loss, gradients, updated
     weights); launches against the schedule's formula; then one step
     each of ffn_down/fp8, ffn_up/f32, ffn_down/f32 (the grouped f32
     kernel) and qkv/f32, whose step-0 losses agree with ffn_up/f32's;
  8. bf16 training at width: llama2-7b as in 5 at compute_dtype=bf16
     (the f32 master cast to bf16 each step, f32 gradients and AdamW),
     site "qkv", gemm_dtype "bf16": the bf16 GEMM+RNG kernel under the
     QKV projection and the bf16 flash kernels; 3 replay steps and step 0
     again under premask, bitwise equal; launches against the formula;
     the layer-0 plane of the bf16 kernel bitwise the plain one; step
     time, tokens/s, peak memory and a profiler trace beside phase 5's
     qkv/f32 step; then one step each of ffn_up/bf16 (the carried gate+up
     host), qkv with gemm_dtype "f32" under bf16 compute (the same bf16
     kernel, bitwise the same loss), qkv/bf16 under f32 compute (the
     host's operands and C rounded to bf16, f32 flash; its step-0 loss
     and grad norm against qkv/f32's) and ffn_up/fp8 under bf16 compute
     (the e4m3 kernel writing bf16 C);
  9. MoE training at bf16 compute: moonshot-v1-16b-a3b as in 7 at
     compute_dtype=bf16, site "ffn_up" / bf16: the next layer's plane made
     under L0's dense gate+up GEMM (the bf16 GEMM+RNG kernel) and under
     L1-L3's expert gate einsum (the grouped bf16 kernel), the bf16 flash
     kernels; 3 replay steps and step 0 again under premask, bitwise equal
     (loss, gradients, updated weights); the plane L1's grouped host
     emits bitwise the plain one; launches against the formula; step
     time, tokens/s, peak memory and a profiler trace beside phase 7's;
     then one step each of ffn_down/bf16, ffn_up/f32 under bf16 compute
     (the same kernels, bitwise the same loss) and ffn_up/fp8 under bf16
     compute (the bf16-C instances of the dense and grouped e4m3 kernels);
 10. fused-mode dropout (the paper's baseline: the keep bits drawn inside
     the flash kernels) at llama2-7b width x 2, f32 and bf16 compute: one
     step plan each of no dropout, fused, overlap at site "xla" (the plane
     made by tensor ops, read by the kernels), qkv replay and qkv
     premask, from one state and batch -- step time, peak memory, busy
     share and device time by kernel each; fused and overlap/xla step-0
     loss and grad norm bitwise equal; the fused step's launches against
     the inert schedule's formula (flash kernels only); then two fused
     steps of moonshot-v1-16b-a3b x 4 at bf16 compute;
 11. the Griffin hybrid at width: recurrentgemma-9b at full width and 6
     of its 38 layers (two (R, R, A) super-blocks: RG-LRU blocks and
     LOCAL attention with window 2048 over one kv head, head_dim 256;
     2.36 B f32 parameters, the state donated to each step), B=1,
     S=4096, compute_dtype=bf16, the bf16 flash kernels' D = 256
     instances, site "ffn_up" / bf16 (L2's gate+up GEMM makes L5's plane,
     carried past the recurrent L3, L4): step 0 under premask and 3
     replay steps, step 0 bitwise equal; launches against the formula;
     step time, peak memory, busy share, device time by kernel, the
     RG-LRU scan's and the f32 unembedding's shares (each timed alone);
     then one fused step;
 12. the same at f32 compute: recurrentgemma-9b x 6 (GRIFFIN_F32_LAYERS)
     at full width, site "ffn_up" / f32 (the f32 GEMM+RNG host) on the
     f32 flash kernels' D = 256 instances, premask step 0 and 3 replay
     steps (step 0 bitwise equal), launches against the formula, one
     fused step, the same records; then the premask step 0 of one (R, R,
     A) super-block at the same width and batch, S=2304 (past the window),
     on the card and on the CPU, loss and grad norm within 1e-4 and 5e-3
     relative;
 13. serving every layer kind at width through the contiguous caches
     (``make_prefill_step`` / ``make_serve_step``: ``models.prefill`` and
     ``models.decode_step``), f32 random weights from a seed, TF32 off:
     recurrentgemma-9b x 6 (RG-LRU and LOCAL ring caches; B=2, prompt
     2560 past the 2048 window, 64 new tokens, the ring rolled in the
     prefill and wrapping in the decode), the same at kv_bits=8 (16 new
     tokens against the 16-bit run's logits), moonshot-v1-16b-a3b x 4
     (MoE decode at B=4, prompt 512, dropless capacity) and rwkv6-7b x 4
     (B=2, prompt 500, not a multiple of the 16-token chunk): each step's
     logits against the forward on the prompt plus the decoded tokens
     (teacher-forced) at SERVE_FWD_TOL, a control that must fail it (the
     ring unrolled; ``len`` one too many; the RWKV state one token too
     many), first-token time, decode tokens/s and peak memory. This path
     runs no CUDA kernel of the port: it is plain torch, as JAX's is
     plain jnp;
 14. the training launcher (``launch/train.py``'s ``train``, the path of
     ``python -m repro_torch.launch.train``) at llama2-7b's full width, 4
     layers (2 where three checkpoints of 12 bytes a parameter do not fit
     on the disk under build/), B=2, S=2048, site "qkv", f32, the flash
     kernels, replay, 8 steps: the schedule proven by the counter layer,
     the dropout contract frozen; run A twice uninterrupted under a
     TrajectoryRecorder (loss bits, the Philox kernel's digest of the probe
     plane), run B under a ChaosMonkey (killed mid-forward at step 4 and
     mid-backward at step 7) with a checkpoint every 3 steps and the write
     of step 6 killed before it is published: A's two runs must agree
     bitwise, and B's recovered loss bits and mask digests must equal A's
     bitwise; then the launcher resumes from B's checkpoint with
     the same plan ("dropout contract verified", steps 6-7 against A's),
     with site "ffn_up" ("recompiled": the counter layer proves the new
     schedule) and with p = 0.2 (ContractMismatchError, the control); the
     kernels' launches over every step run against the schedule's formula;
     step time, the checkpoint's host gather and write seconds, the stall
     a save adds to its step, restore seconds and time to recover, beside
     the card's name and power limit. The checkpoint directory is deleted
     at the end;
 15. ``site="auto"`` with the perf model calibrated on the card
     (``repro_torch.tune``): every host cell's (plain GEMM, standalone
     Philox, fused GEMM+RNG) triple timed in turns at llama2-7b's four host
     GEMMs and moonshot's grouped gate, f32 and bf16, the model fitted to
     them (it must beat the closed-form GH100 constants) and each cell's
     closed-form and calibrated predictions printed beside its measured
     time; the gated search on llama2-7b's QKV host at bf16
     (``philox_bits=8`` must die at the mask-bit gate, a candidate must
     pass all four gates); ``site="auto"`` at llama2-7b width x 4 resolved
     under the closed-form GH100 and under the calibrated table, each
     resolved site's 3 replay steps and premask step 0 bitwise the same
     steps at the site fixed (loss bits, the flash kernels' dropout
     operands' digests), step times printed; the Layer-2 walk of that step
     at full width on fake tensors (replay and premask clean, no kernel
     launched, the leaky mutant flagged MS-D1), its node counts and
     seconds. It adds no kernel: each one it runs is held against its
     plain version in phase 2.
 16. multi-rank (``repro_torch.launch.multirank``, spawned by
     ``launch.mesh.run_ranks`` after phase 1 built every kernel): two
     ranks sharing the one card over gloo (NCCL refuses two ranks on one
     device; gloo's CUDA payloads staged through the host), llama2-7b at
     full width x 2 layers, B=2, S=2048: (a) tensor parallel on (model=2),
     site "qkv", replay, at f32 and then bf16 compute, 2 steps each; (b)
     data parallel on (data=2), site "prev_gemm", premask, 2 steps; (c)
     moonshot-v1-16b-a3b at full width x 2 layers expert parallel on
     (data=2), site "ffn_up" on the grouped host at f32: one step, and its
     first MoE layer's forward and backward against the single-device
     layer on each source's tokens (y, the x gradient and the router's and
     experts' weight gradients 2e-4, aux 0.1, the hosted plane tile
     bitwise); and (d), beside them, one NCCL rank on a (model=1) mesh,
     one step.
     In every run the n-th dropout operand a rank's flash kernels read is
     the one of the (step, layer, forward or recomputation) the n-th call
     serves: bitwise its ``shard_plane_windows`` tile of that
     single-device plane, or its replay word with the rank's offset
     (digests), in the single-device run's modes; losses and grad norms
     against the same steps on one device here (2e-5 relative at f32,
     5e-5 at bf16); step times printed with the card's name and power
     limit -- two ranks sharing one card over gloo, not a scaling
     measurement.

Phase 2 also checks the e4m3 GEMM+RNG kernel against its plain version
at the four host shapes of phase 6 (QKV, out-projection, gate+up, down;
plane bitwise, also against the f32 kernel's; C within 1e-3 of the plain
version and under 0.06 of the f32 product), at three scale-tile shapes and
with a Region-3 call that emits nothing, and the grouped kernels (f32 on
the tensor cores as the dense f32 one, its emission-off variant, e4m3) at
moonshot's two expert host shapes and rwkv6-7b's channel-mix key GEMM
(E=1) in the same way (the f32 and e4m3 grouped kernels also at K = bk =
344, K not a multiple of 16: the e4m3 rows zero-padded to the tensor
maps' 16-byte stride, the f32 kernel's last 32-k stage reading the maps'
zeros past K); the bf16 GEMM+RNG kernel at the four host
shapes (plane bitwise the plain one's and the f32 host's, bf16 C within
1e-2 (1 + |C|) of the plain version, emission on and off in turns, and a
Region-3 call) and the bf16 flash kernels (the forward, dq and dkv on
the tensor cores) at B=2, H=32, S=2048, D=128 in all
four dropout modes, with a local window, with 4 kv heads, at D=64 and at
SQ=1024 and 960 < SK (within 1e-2 (|x| + rms(x)), lse 1e-4; each
output's share of its limit printed; replay == premask bitwise; a
planted fault in the keep bits must fail the check; the forward, dq and
dkv timed in none, premask and replay beside the SIMT floor of their
exponentials and keep bits), and at head_dim 256 (recurrentgemma-9b's
LOCAL layer: B=1, 16 heads over one kv head, S=4096; none, fused,
premask, replay, and replay with the window of 2048; the same limits,
replay == fused == premask bitwise, the planted fault; timed with the
window beside the bound and SDPA with the window as a mask); the
grouped bf16 kernel at the grouped host shapes
(plane bitwise the plain one's and the f32 grouped host's, bf16 C within
1e-2 (1 + |C|), emission on and off in turns, a Region-3 call through
both grouped hosts, and a planted fault -- one expert's C rows shifted by
one -- the check must fail) and the e4m3 kernels on bf16 operands at
llama2's gate+up and moonshot's expert gate (bf16 C bitwise the f32
instance's C rounded once, within 1e-2 (1 + |C|) of the plain version,
plane bitwise); the e4m3 kernels take B K-major (JAX's weight bytes
and scales transposed, bitwise what quantizing the transposed weight
gives, checked), are timed on those operands with the emission on and
off in turns (TFLOP/s, share of the bound, the plane's
share of the product), and their wrappers on JAX's (K, N) layout once;
phase 4 adds the reduced llama2 at prev_gemm/f32 and ffn_up/fp8, the
reduced llama2 and yi at qkv/bf16 under compute_dtype=bf16 (loss 1e-4,
grad norm 5e-3 relative, weights 4 lr; the measured differences are
printed), the reduced moonshot and arctic at ffn_up/f32 and
ffn_down/fp8, and the reduced moonshot, arctic and an RWKV hybrid at
ffn_up/bf16 and ffn_down/fp8 under compute_dtype=bf16 (the bf16
tolerances; the hybrid's losses after step 0 at 1e-3, its grad norm at
5e-2 and a leaf's change at 0.5, the spread of the JAX package against
itself on it), fused-mode dropout on the reduced llama2 and moonshot
under attn_impl "pallas" and "xla" at f32 and bf16 compute, and the
reduced recurrentgemma (RG-LRU, LOCAL window 32, head_dim 16) at
ffn_up/f32, prev_gemm/f32 and ffn_up/bf16 under bf16 compute, and at
head_dim 256 at ffn_up/f32 (the f32 D = 256 flash kernels), card
against CPU; every such run also holds each leaf's change over its 3
steps within 0.25 relative of the CPU's.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": {...}}`` record. Every phase runs, in order.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.distributed.chaos import (  # noqa: E402
    ChaosCheckpointer,
    ChaosError,
    TrajectoryMismatch,
    TrajectoryRecorder,
)
from repro_torch.kernels import build, launch_counts, philox  # noqa: E402
from repro_torch.kernels import philox_common  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd  # noqa
from repro_torch.kernels import gemm_rng  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.philox_common import (  # noqa: E402
    from_int32_bits,
    split_seed,
    threshold_from_p,
)
from repro_torch.tree import leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM data sheet, f32 without
                                   # tensor cores (the port's f32 kernels)
FP8_FLOPS_PER_S = 1979e12          # H100 SXM data sheet, dense e4m3 on
                                   # the tensor cores
F16_FLOPS_PER_S = 989e12           # the same, dense f16: the rate the e4m3
                                   # kernels multiply at (exact e4m3 -> f16)
BF16_FLOPS_PER_S = 989e12          # the same, dense bf16: the bf16 kernels'
                                   # bound (tensor cores)
F32_SPLIT_PRODUCTS = 6             # bf16 products the f32 tensor-core
                                   # kernels (flash forward, dq, dkv and
                                   # the GEMM+RNG hosts) run for one f32
                                   # product (both operands split into
                                   # exact triples)
SFU_PER_ISSUE_LANE = 1 / 8         # exponentials a clock: 16 an SM against
                                   # 128 issue lanes
ISSUE_LANES_PER_SM = 128           # 4 warp schedulers x 32 lanes a clock

SERVE_SHAPE = (1, 32, 512, 512)    # llama2-7b plane at max_model_len 512
TRAIN_SHAPE = (1, 32, 4096, 4096)  # a training-size plane
QKV_PLANE = (2, 32, 2048, 2048)    # llama2-7b's training plane at B=2,
                                   # S=2048 (the sequential yardstick's)
MOONSHOT_PLANE = (2, 16, 2048, 2048)  # moonshot-v1-16b-a3b's, B=2, S=2048
# a plane of 2^31 words (8 GiB), past 32-bit word indices
HUGE_PLANE = (4, 64, 16384, 16384)
# thread-instructions a clock a SM of Hopper's two integer pipes, each
# half of the 128 issue lanes (NVIDIA's throughput table for compute
# capability 9.0; scripts/probe_philox.py measured IMAD 64.0, LOP3 63.0,
# ISETP 62.6 and IMAD + LOP3 together 123.4 on an H100 SXM): the
# multiply-add pipe runs the 32x32->64 multiplies, the ALU pipe the xors
# and the compares; either takes the pack's merges
IMAD_PIPE_LANES = 64
ALU_PIPE_LANES = 64
# multiply-add pipe slots of one IMAD.WIDE.U32 (mul.wide.u32): it runs at
# half rate, 31.3 a clock a SM where both of its words are used (the probe)
MUL_WIDE_SLOTS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def issue_ops_per_s() -> float:
    """Thread-instructions a second: SMs x 128 issue lanes x the card's
    maximum SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def philox_word_mix(rounds: int) -> dict:
    """The fewest instructions one packed word needs (8 Philox calls of
    ``rounds`` rounds on the counters (k, q32 * 8 + t, bh, salt), and its
    32 keep bits), by kind, counting once what more than one word of the
    plane shares. A round is two 32x32->64 multiplies (one instruction
    each, giving both words) and two three-input xors; the key schedule is
    the same for every thread. Shared: round 0 entirely (its products of
    x0 = k and x2 = bh, y2 by column, y0 = .. ^ t by row), round 1's
    product of x0 (row and t) and of x2 (column), and y0 (head and
    column), round 2's product of x0 (head and column). What is left to a
    call of one word: 1 multiply and 3 xors in rounds 1-2, 2 of each in
    every later round; the pack, a compare and a merge a keep bit. 224 at
    7 rounds (PERF.md: 246 when only a word's own calls share, 288 when
    nothing is shared)."""
    assert rounds >= 3
    return {"multiplies": 8 * (1 + 2 * (rounds - 3)),
            "xors": 8 * (3 + 2 * (rounds - 3)),
            "compares": 32, "merges": 32}


def philox_word_ops(rounds: int) -> int:
    """Instructions one packed word needs at the fewest (philox_word_mix):
    224 at 7 rounds. Every bound that adds the plane's Philox work counts
    a word so, at the issue rate."""
    return sum(philox_word_mix(rounds).values())


def philox_word_pipe_clocks(rounds: int) -> float:
    """SM clocks one packed word needs on Hopper's two integer pipes: the
    multiplies on the multiply-add pipe, the xors and compares on the ALU
    pipe, the merges split between them to even the load; the busier pipe
    sets the time."""
    mix = philox_word_mix(rounds)
    mul = mix["multiplies"] * MUL_WIDE_SLOTS / IMAD_PIPE_LANES
    alu = (mix["xors"] + mix["compares"]) / ALU_PIPE_LANES
    merge = mix["merges"] / ((IMAD_PIPE_LANES + ALU_PIPE_LANES) / 2)
    return max(mul, alu, (mul + alu + merge) / 2)


def philox_times_ms(shape, rounds: int, ops_rate: float) -> dict:
    """One plane's least times: its 4-byte words written once against HBM
    ("bytes"), the fewest instructions a word needs at the issue rate
    ("issue"), and at the busier integer pipe ("pipes")."""
    b, h, sq, sk = shape
    words = b * h * (sq // 32) * sk
    sm_clocks = ops_rate / ISSUE_LANES_PER_SM
    return {"bytes": words * 4 / HBM_BYTES_PER_S * 1e3,
            "issue": words * philox_word_ops(rounds) / ops_rate * 1e3,
            "pipes": words * philox_word_pipe_clocks(rounds) / sm_clocks
            * 1e3}


def philox_bound(shape, rounds: int, ops_rate: float):
    """(bound_ms, bound_by) for one plane: the largest of
    philox_times_ms's three times ("bytes", or "operations" for the
    issue or the pipes' time)."""
    t = philox_times_ms(shape, rounds, ops_rate)
    ops = max(t["issue"], t["pipes"])
    return max(t["bytes"], ops), ("operations" if ops >= t["bytes"]
                                  else "bytes")


def device_time_ms(fn, kernel: str, iters: int):
    """Device time a call of the kernels whose name holds ``kernel`` (all
    of them: the f32 dq at head_dim 256 is two launches, its split pass and
    its products), from a torch.profiler trace of ``iters`` calls; None when
    three traces in a row hold no device time for it. The profiler has
    returned one such trace, unexplained, in a run whose other traces were
    whole (PERF.md, open questions), so an empty trace is taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total_us += getattr(evt, "device_time_total",
                                    getattr(evt, "cuda_time_total", 0.0))
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((from_int32_bits(a) - from_int32_bits(b)).abs().max())


# ------------------------------------------------------------------ phase 0
def phase_card(state) -> None:
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    state["smi"] = nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {state['kind']} x{state['count']} | nvidia-smi: "
        f"{state['smi']} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32} | cuBLAS bf16 reduced-precision "
        f"reductions (left at torch's default): "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")


# ------------------------------------------------------------------ phase 1
def phase_build(state) -> None:
    import ctypes
    import re
    t0 = time.perf_counter()
    parent = _start_parent_build()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f}s "
        f"-> {build.build_dir()}")
    state["parent_wide"] = _finish_parent_build(parent)
    for name in libs:
        for line in build.ptxas_report(name):
            if "(C75" not in line:   # advisories: once each, below
                log(f"[build] {name}: {line}")
    # the tensor-core kernels: dynamic shared memory (ptxas reports static
    # only), ptxas's advisories on the wgmma code, once each, and the wgmma
    # instructions (HGMMA) in the library's SASS: none means the products
    # did not reach the tensor cores
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # (library, the library and entry of its shared-memory report): the
    # grouped GEMMs share their dense kernel's layout and report
    flash_libs = ([(flash.SOURCES[name], flash.SOURCES[name], name)
                   for name in flash.KERNELS.values()]
                  + [(flash_bwd.SOURCES[name], flash_bwd.SOURCES[name], name)
                     for pair in flash_bwd.KERNELS.values() for name in pair])
    f32_libs = {flash.SOURCES[flash.KERNELS[torch.float32]],
                *(flash_bwd.SOURCES[n]
                  for n in flash_bwd.KERNELS[torch.float32])}
    for name, smem_lib, entry in (
            (gemm_rng.KERNEL, gemm_rng.KERNEL, gemm_rng.KERNEL),
            (gemm_rng.KERNEL_GROUPED, gemm_rng.KERNEL, gemm_rng.KERNEL),
            (gemm_rng.KERNEL_FP8, gemm_rng.KERNEL_FP8, gemm_rng.KERNEL_FP8),
            (gemm_rng.KERNEL_GROUPED_FP8, gemm_rng.KERNEL_FP8,
             gemm_rng.KERNEL_FP8),
            (gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_BF16,
             gemm_rng.KERNEL_BF16),
            (gemm_rng.KERNEL_GROUPED_BF16, gemm_rng.KERNEL_BF16,
             gemm_rng.KERNEL_BF16),
            *flash_libs):
        fn = getattr(ctypes.CDLL(str(libs[smem_lib])),
                     f"repro_{entry}_smem_bytes")
        dims = flash.KERNEL_HEAD_DIMS[torch.bfloat16 if entry.endswith(
            "bf16") else torch.float32]
        smem = (fn() if name.startswith("gemm") else
                ", ".join(f"{fn(d)} at D={d}" for d in dims))
        advisories = sorted({
            re.sub(r" in function '[^']*'|line \d+", "", ln).strip()
            for ln in build.log_path(name).read_text().splitlines()
            if "(C75" in ln})
        sass = subprocess.run([cuobjdump, "--dump-sass", str(libs[name])],
                              check=True, capture_output=True,
                              text=True).stdout
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        if hgmma == 0:
            raise AssertionError(f"{name}: no HGMMA instruction in its SASS")
        log(f"[build] {name}: {smem} bytes of dynamic shared memory a CTA; "
            f"{hgmma} HGMMA instructions in its SASS (cuobjdump); ptxas "
            f"advisories: {advisories or 'none'}")
    # the f32 GEMM+RNG kernels (both operands split, the accumulator and a
    # stage's sum in registers) and the persistent bf16 ones (a 128 x 256
    # f32 accumulator beside a unit of Philox) may not spill
    for name in (gemm_rng.KERNEL, gemm_rng.KERNEL_GROUPED,
                 gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_GROUPED_BF16):
        spills = [int(x) for line in build.ptxas_report(name)
                  for x in re.findall(r"(\d+) bytes spill", line)]
        regs = [int(x) for line in build.ptxas_report(name)
                for x in re.findall(r"Used (\d+) registers", line)]
        if not spills or max(spills):
            raise AssertionError(f"{name}: its instances spill ({spills})")
        log(f"[build] {name}: {min(regs)}-{max(regs)} registers, no spill "
            f"in its {len(regs)} instances")
    # the flash libraries by head dim: registers and spills of their
    # instances (one a dropout mode); the f32 ones may not spill at D =
    # 128, the main path's
    for name in sorted({lib for lib, _, _ in flash_libs}):
        by_d = _ptxas_by_head_dim(name)
        log(f"[build] {name} by head dim: " + "; ".join(
            f"D={d}: {min(r)}-{max(r)} registers, spill stores {max(st)} "
            f"/ loads {max(ld)} bytes" for d, (r, st, ld) in by_d.items()))
        if name in f32_libs and (128 not in by_d
                                 or max(by_d[128][1] + by_d[128][2])):
            raise AssertionError(f"{name}: the D = 128 instances spill "
                                 f"({by_d.get(128)})")
        # nor may the D = 256 ones (two warpgroups, the D = 128 instance's
        # accumulators a thread), bf16 or f32, nor keep a stack frame
        if 256 not in by_d or max(by_d[256][1] + by_d[256][2]):
            raise AssertionError(f"{name}: the D = 256 instances spill "
                                 f"({by_d.get(256)})")
        frames = _stack_frames(name, 256)
        if not frames or max(frames):
            raise AssertionError(f"{name}: the D = 256 instances keep a "
                                 f"stack frame ({frames} bytes)")
    # the libraries whose sources gained the D = 256 instances keep their
    # machine code at D <= 128: the digest of those kernels' SASS against
    # the build of the parent commit's sources (FLASH_NARROW_SASS)
    for name, want in FLASH_NARROW_SASS.items():
        digest, count = narrow_sass_digest(libs[name])
        if digest != want:
            raise AssertionError(f"{name}: the SASS of its {count} kernels "
                                 f"at D <= 128 changed (digest {digest}, "
                                 f"the parent's {want})")
        log(f"[build] {name}: its {count} kernels at D <= 128 run the "
            f"parent's SASS, instruction for instruction (digest {digest})")


# The parent commit's sources, where a checkout of it is unpacked beside
# this script (git archive <commit> | tar -x -C build/parent): phase 2
# times its bf16 dq and dkv at head_dim 256 in turns with the redesigned
# ones (REDESIGNED). A checkout of the committed files alone has none;
# phase 2 then quotes PROBE_IN_TURNS.
PARENT_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "parent", "src", "repro_torch",
                           "kernels", "csrc")
# dtype -> (kind, library) of each D = 256 kernel redesigned last
REDESIGNED = {torch.bfloat16: (("dq", "flash_dq_bf16"),
                               ("dkv", "flash_dkv_bf16"))}
PARENT_LIBS = tuple(lib for kernels in REDESIGNED.values()
                    for _, lib in kernels)


def _start_parent_build():
    """The parent's PARENT_LIBS, one nvcc each, started (None without a
    parent checkout)."""
    if not os.path.isdir(PARENT_CSRC):
        return None
    out = build.build_dir() / "parent"
    out.mkdir(parents=True, exist_ok=True)
    return {name: (out / f"libparent_{name}.so", subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-o",
         str(out / f"libparent_{name}.so"),
         os.path.join(PARENT_CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in PARENT_LIBS}


def _finish_parent_build(procs):
    """name -> the parent's library, once its nvcc is done (None without
    a parent checkout)."""
    if procs is None:
        log(f"[build] no parent checkout at {PARENT_CSRC}: phase 2 quotes "
            f"the parent timings of PROBE_IN_TURNS")
        return None
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc failed\n{out}")
        libs[name] = lib
    log(f"[build] the parent's {', '.join(libs)} from {PARENT_CSRC}")
    return libs


# the digest (narrow_sass_digest) of each flash library's kernels at head
# dims up to 128 as the parent commit's sources build them on the H100
# machine's toolkit (scripts/probe_flash_d256.py --parent for the bf16
# libraries and the f32 forward, scripts/probe_flash_f32_d256.py --parent
# for the f32 dq and dkv): the D = 256 instances left them unchanged
FLASH_NARROW_SASS = {"flash_fwd_bf16": "5723879813a3fa94",
                     "flash_dq_bf16": "48288393cc6d5c8b",
                     "flash_dkv_bf16": "afbc9e9f1114be08",
                     "flash_fwd_f32": "2d91498e26cf02bc",
                     "flash_dq_f32": "d0cb93aadc90a4f5",
                     "flash_dkv_f32": "8f21ffb879ca7812"}


def sass_by_function(lib) -> dict:
    """The library's flash kernels, by (kernel, head dim, dropout mode) --
    their first two template arguments; the mangled name itself carries a
    hash of the source's path for the kernels in an anonymous namespace
    -- -> their SASS instructions, without addresses or encodings."""
    import re
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    out = {}
    for body in sass.split("Function : ")[1:]:
        m = re.search(r"(flash_\w*?kernel\w*?)ILi(\d+)ELi(\d+)E",
                      body.split("\n", 1)[0])
        if m:
            out[(m.group(1), int(m.group(2)), int(m.group(3)))] = tuple(
                instruction.findall(body))
    return out


def narrow_sass_digest(lib) -> tuple:
    """(digest, kernels) of a flash library's instances at head dims up to
    128: a sha256 prefix of their (kernel, D, mode) keys and SASS, so two
    builds with equal digests run the same machine code there."""
    import hashlib
    kept = {key: code for key, code in sass_by_function(lib).items()
            if key[1] <= 128}
    h = hashlib.sha256()
    for key in sorted(kept):
        h.update(repr(key).encode())
        h.update("\n".join(kept[key]).encode())
    return h.hexdigest()[:16], len(kept)


def _stack_frames(name: str, head_dim: int) -> list:
    """The stack frame bytes of each flash kernel instance at head_dim in
    the library's ptxas report."""
    import re
    out, d = [], None
    for line in build.ptxas_report(name):
        m = re.search(r"flash_\w*kernel\w*ILi(\d+)E", line)
        if "Compiling entry" in line:
            d = int(m.group(1)) if m else None
        elif d == head_dim and (m := re.search(r"(\d+) bytes stack frame",
                                               line)):
            out.append(int(m.group(1)))
    return out


def _ptxas_by_head_dim(name: str) -> dict:
    """head dim -> (registers, spill store bytes, spill load bytes) of
    each flash kernel instance in the library's ptxas report (the first
    template argument of a ``flash_*_kernel`` is D)."""
    import re
    out, d = {}, None
    for line in build.ptxas_report(name):
        m = re.search(r"flash_\w*kernel\w*ILi(\d+)E", line)
        if "Compiling entry" in line:
            d = int(m.group(1)) if m else None
        elif d is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out.setdefault(d, ([], [], []))[1].append(int(m.group(1)))
            out[d][2].append(int(m.group(2)))
        elif d is not None and (m := re.search(r"Used (\d+) registers",
                                               line)):
            out.setdefault(d, ([], [], []))[0].append(int(m.group(1)))
    return dict(sorted(out.items()))


# ------------------------------------------------------------------ phase 2
def _check_philox(state, shape, p, seed, salt, rounds,
                  heads_global=0, bh_offset=0) -> torch.Tensor:
    b, h, sq, sk = shape
    got = philox.philox_dropout_mask(b, h, sq, sk, p, seed, salt, rounds,
                                     heads_global=heads_global,
                                     bh_offset=bh_offset, device="cuda")
    want = philox.philox_dropout_mask_plain(
        b, h, sq, sk, p, seed, salt, rounds, heads_global=heads_global,
        bh_offset=bh_offset, device="cuda")
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    state["philox_err"] = max(state.get("philox_err", 0), err)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        at = tuple(bad[0].tolist())
        raise AssertionError(f"philox kernel != plain at {shape} p={p} "
                             f"seed={seed} rounds={rounds} "
                             f"window=({heads_global},{bh_offset}): "
                             f"{len(bad)} words differ, the first at {at} "
                             f"({int(got[at])} against {int(want[at])})")
    return got


def _check_philox_threshold(state, shape, threshold) -> torch.Tensor:
    """The kernel at a raw threshold (not one of threshold_from_p's) against
    the plain version's words, bitwise."""
    b, h, sq, sk = shape
    out = torch.empty((b, h, sq // 32, sk), dtype=torch.int32, device="cuda")
    args = dict(key_lo=0x9E37, key_hi=0x79B9, salt=13, threshold=threshold,
                rounds=7)
    philox.philox_mask_into(out, **args)
    want = philox._plain_words(b, h, sq // 32, sk, 0x9E37, 0x79B9, 13,
                               threshold, 7, h, 0, out.device)
    torch.cuda.synchronize()
    state["philox_err"] = max(state["philox_err"],
                              max_abs_err(out, want.reshape(out.shape)))
    if not torch.equal(out, want.reshape(out.shape)):
        raise AssertionError(f"philox kernel != plain at {shape} "
                             f"threshold={threshold:#x}")
    return out


def _check_philox_huge(state) -> None:
    """HUGE_PLANE, 2^31 words: its first and last (b, h) rows bitwise the
    plain version's, each made alone as a shard window of one head."""
    b, h, sq, sk = HUGE_PLANE
    p, seed, salt = 0.1, 2 ** 36 + 3, 21
    got = philox.philox_dropout_mask(b, h, sq, sk, p, seed, salt, 7,
                                     device="cuda")
    for bb, hh in ((0, 0), (b - 1, h - 1)):
        want = philox.philox_dropout_mask_plain(
            1, 1, sq, sk, p, seed, salt, 7, heads_global=h,
            bh_offset=bb * h + hh, device="cuda")
        torch.cuda.synchronize()
        if not torch.equal(got[bb, hh], want[0, 0]):
            raise AssertionError(f"philox kernel != plain on head row "
                                 f"({bb}, {hh}) of {HUGE_PLANE}")
        state["philox_err"] = max(state["philox_err"],
                                  max_abs_err(got[bb, hh], want[0, 0]))
    log(f"[kernels] philox_mask {b}x{h}x{sq // 32}x{sk} "
        f"({got.numel()} words, {got.numel() * 4 / 2 ** 30:.1f} GiB): head "
        f"rows (0, 0) and ({b - 1}, {h - 1}) == plain bitwise")
    del got
    torch.cuda.empty_cache()


def _check_philox_plain_devices(state, shape, p, seed, salt,
                                rounds) -> None:
    """The plain version on the card (int64 tensor ops on CUDA) against
    the plain version on the CPU, bitwise: the kernel's checks hold it to
    the first."""
    b, h, sq, sk = shape
    args = (b, h, sq, sk, p, seed, salt, rounds)
    on_card = philox.philox_dropout_mask_plain(*args, device="cuda").cpu()
    on_cpu = philox.philox_dropout_mask_plain(*args, device="cpu")
    if not torch.equal(on_card, on_cpu):
        bad = (on_card != on_cpu).nonzero()
        raise AssertionError(f"philox plain version on the card != on the "
                             f"CPU at {shape}: {len(bad)} words differ, the "
                             f"first at {tuple(bad[0].tolist())}")
    log(f"[kernels] philox plain version {shape} p={p} seed={seed}: on the "
        f"card == on the CPU bitwise ({on_cpu.numel()} words)")


def phase_kernels(state) -> None:
    n = 0
    _check_philox(state, SERVE_SHAPE, 0.1, 0x1234, 7, 7); n += 1
    _check_philox_plain_devices(state, SERVE_SHAPE, 0.1, 0x1234, 7, 7)
    _check_philox_plain_devices(state, (2, 3, 1024, 96), 0.1, 5, 11, 7)
    _check_philox(state, TRAIN_SHAPE, 0.1, 2 ** 40 + 99, 3, 7); n += 1
    _check_philox(state, (2, 3, 1024, 96), 0.1, 5, 11, 7); n += 1
    # shard window: batch row 1, heads 4..7 of a (2, 8) plane
    whole = _check_philox(state, (2, 8, 256, 384), 0.1, 77, 2, 7)
    tile = _check_philox(state, (1, 4, 256, 384), 0.1, 77, 2, 7,
                         heads_global=8, bh_offset=1 * 8 + 4)
    if not torch.equal(tile[0], whole[1, 4:8]):
        raise AssertionError("shard-window tile != slice of the plane")
    n += 2
    for rounds in (3, 5, 7, 10):
        for p in (0.0, 0.1, 1.0):
            _check_philox(state, (1, 4, 256, 640), p, 2 ** 32 + 17,
                          rounds * 1000 + 3, rounds)
            n += 1
    # an array seed keys with key_hi = 0, an int seed with its top word
    lo = _check_philox(state, (1, 2, 64, 128), 0.1, torch.tensor(2 ** 33 + 5),
                       0, 7)
    hi = _check_philox(state, (1, 2, 64, 128), 0.1, 2 ** 33 + 5, 0, 7)
    assert split_seed(torch.tensor(2 ** 33 + 5)) == (5, 0)
    if torch.equal(lo, hi):
        raise AssertionError("key_hi did not reach the kernel")
    n += 2
    # SK of 1, 97 (odd: the scalar stores' tail), 6 and 4097 (several
    # waves of the persistent grid), and an odd-SK shard window
    for shape in ((2, 3, 64, 1), (1, 4, 96, 97), (1, 2, 64, 6),
                  (3, 5, 2080, 4097)):
        for rounds in ((3, 7) if shape[3] == 97 else (7,)):
            _check_philox(state, shape, 0.1, 2 ** 35 + 1, 5, rounds)
            n += 1
    _check_philox(state, (2, 3, 64, 97), 0.1, 2 ** 35 + 1, 5, 7,
                  heads_global=5, bh_offset=7)
    n += 1
    # the card's compare and pack (push_keep's subtract and multiply-add
    # with carry, in PTX) at a threshold equal to one of the plane's
    # Philox words: that bit is kept, and dropped at threshold + 1
    shape, (bb, hh, q, k) = (1, 2, 64, 98), (0, 1, 45, 77)
    word = philox_common.philox4x32(k, q // 4, bb * shape[1] + hh, 13,
                                    0x9E37, 0x79B9, 7)[q % 4]
    at = _check_philox_threshold(state, shape, word)
    past = _check_philox_threshold(state, shape, word + 1)
    bit = lambda t: (int(t[bb, hh, q // 32, k]) >> (q % 32)) & 1  # noqa
    if (bit(at), bit(past)) != (1, 0):
        raise AssertionError("a Philox word equal to the threshold must be "
                             "kept, one below it dropped")
    _check_philox_threshold(state, shape, 0x80000000)
    n += 3
    log(f"[kernels] philox_mask == plain bitwise on {n} cases "
        f"(max_abs_err {state['philox_err']}); a word equal to the "
        f"threshold kept, dropped at threshold + 1")
    _check_philox_huge(state)

    ops_rate = issue_ops_per_s()
    timings = {}
    for label, shape, iters, plain_iters in (
            ("serve", SERVE_SHAPE, 200, 10), ("qkv", QKV_PLANE, 20, 1),
            ("train", TRAIN_SHAPE, 20, 2), ("moonshot", MOONSHOT_PLANE, 20,
                                            1)):
        b, h, sq, sk = shape
        out = torch.empty((b, h, sq // 32, sk), dtype=torch.int32,
                          device="cuda")
        args = dict(key_lo=0x1234, key_hi=0, salt=7,
                    threshold=threshold_from_p(0.1), rounds=7)
        launch = lambda: philox.philox_mask_into(out, **args)  # noqa: E731
        event_ms = cuda_time_ms(launch, iters)
        prof_ms = device_time_ms(launch, "philox_mask_kernel", iters)
        ms = prof_ms if prof_ms is not None else event_ms
        plain_ms = cuda_time_ms(
            lambda: philox.philox_dropout_mask_plain(
                b, h, sq, sk, 0.1, 0x1234, 7, 7, device="cuda"),
            plain_iters, warmup=1)
        bound_ms, bound_by = philox_bound(shape, 7, ops_rate)
        parts = philox_times_ms(shape, 7, ops_rate)
        gelem = b * h * sq * sk / (ms * 1e-3) / 1e9
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        log(f"[kernels] philox_mask {label} plane {b}x{h}x{sq // 32}x{sk}: "
            f"device {prof_ms} ms (profiler), {event_ms:.5f} ms a launch "
            f"back to back (CUDA events); {gelem:.1f} Gelem/s; plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
            f"(bytes {parts['bytes']:.5f}, issue {parts['issue']:.5f} at "
            f"{philox_word_ops(7)} instructions a word and "
            f"{ops_rate / 1e12:.2f} Tinst/s, pipes {parts['pipes']:.5f} at "
            f"{philox_word_pipe_clocks(7):.3f} SM clocks a word), kernel at "
            f"{bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
        del out
    state["philox_timing"] = timings


# GEMM+RNG at the training QKV shape (B*S, (H+2KV)*hd, d_model of llama2-7b
# at B=2, S=2048) and at a Region-3 shape; flash at the training planes
QKV_SHAPE = (4096, 12288, 4096)
QKV_MASK = (2, 32, 2048)
REGION3 = (256, 768, 64, (1, 128, 256))
FLASH_SHAPE = (2, 32, 2048, 128)
# tolerances of a kernel against its plain version on the card: f32 sums
# of 4096 (GEMM) and 2048 (attention) terms in another order than the
# plain version's cuBLAS / torch sums, on O(1) random inputs. GEMM_TOL
# holds the e4m3 GEMMs against their plain versions (the same e4m3
# operands and scales); FWD_TOL the bf16 forward's f32 lse
GEMM_TOL = 1e-3
FWD_TOL = 1e-4
# the f32 GEMM+RNG C (rows 2, 3, 9, 10) against the plain version: the
# tensor-core kernels (six part products an f32 product, each 32-k stage
# folded into C by f32 adds) read 0.02-0.34 of it in the smoke's cases on
# the H100, about what the plain version (cuBLAS's f32 sum, in k order)
# reads against the f64 product itself (up to 0.39; 0.86 at K = 11008),
# so the limit stays; each run also holds C within F32_GEMM_F64_TOL of the
# f64 product, a limit the kernels read at most 0.2 of there (0.47 at K =
# 11008) and the plain version up to 1.08 of (2.9 at K = 11008), and
# holds both limits to a precision control they must fail, the plain GEMM
# on A and W rounded once to bf16 (``_gemm_precision_control``)
F32_GEMM_TOL = 1e-3
F32_GEMM_F64_TOL = 3e-4
# the f32 flash forward's O and lse: the tensor-core kernel (six part
# products an f32 product) reads at most 1.5e-6 x (1 + |x|) on the H100
# (PERF.md row 4), so the limit sits several times above that,
# where a lost part product or an operand kept to bf16 shows; each run
# holds it to a precision control it must fail
# (``_flash_fwd_precision_control``)
F32_FWD_TOL = 1e-5
# the f32 dq, dk, dv: the tensor-core kernels (six part products an f32
# product) read at most 6e-6 x (1 + |x|) in FLASH_CASES on the H100
# (PERF.md row 5), so the limit sits a few times above that, where a lost
# part product or an operand kept to bf16 shows; each run holds the limit
# to a precision control it must fail (``_flash_precision_control``)
GRAD_TOL = 2e-5
# bf16 C against its plain version: one bf16 ulp is 2^-8 of a value, and
# f32 sums in another order round either way near a rounding boundary
BF16_GEMM_TOL = 1e-2
# bf16 flash outputs (O, dq, and dk, dv per query head) against their
# plain versions, relative with a floor at the tensor's own scale: tol x
# (|want| + rms(want)). The kernel and the plain version each round their
# own f32 result once, so they differ by one bf16 ulp (at most 2^-7 of a
# value, under 1e-2) where the two f32 sums straddle a rounding boundary;
# the floor covers values near zero. A GQA group sum of per-head values
# rounded apart can differ by one ulp of its largest head where the heads
# nearly cancel, past this limit on some inputs for the SIMT kernels too
# (PERF.md 7): the dkv kernel is held on what it writes, per head, and the
# sums' ratios are printed. lse stays f32 and is held at FWD_TOL. Each run
# also plants a fault (FLASH_FAULT) that this limit, and the f32 ones, must
# fail (on the H100: 24-64 times this limit).
BF16_FLASH_TOL = 1e-2
# the planted fault: the keep bits of one plane word row (32 query rows)
# x 64 keys flipped, in batch 0, head 0, late rows -- a 64-key block of
# rows that attend to about 2,000 keys: (first row, first key)
FLASH_FAULT = (1984, 1024)


def _within(got, want, tol, scaled=False):
    """(max |got - want|, max |got - want| / limit, all within): the limit
    is tol x (1 + |want|), or with ``scaled`` tol x (|want| + rms(want));
    a NaN or an infinity on either side is not within."""
    err = (got - want).abs()
    floor = want.square().mean().sqrt() if scaled else 1.0
    limit = tol * (want.abs() + floor)
    ok = bool((err <= limit).all())
    return float(err.max()), float((err / limit).max()), ok


def _close(name, got, want, tol, state, key, scaled=False) -> float:
    """Max |got - want|, checked by ``_within``."""
    worst, _, ok = _within(got, want, tol, scaled)
    if not ok:
        rule = "(|want| + rms(want))" if scaled else "(1 + |want|)"
        raise AssertionError(f"{name}: max abs err {worst} beyond tol "
                             f"{tol} x {rule}, or not finite")
    state.setdefault("errs", {})
    state["errs"][key] = max(state["errs"].get(key, 0.0), worst)
    return worst


def gemm_rng_bound(m, n, k, mask_words, rounds, ops_rate, groups=1,
                   simt=False):
    """(bound_ms, bound_by) of ``groups`` f32 (m, k) x (k, n) products and
    one plane: operands and results read / written once, the plane written
    once, against HBM; the products as F32_SPLIT_PRODUCTS bf16 products
    each at the dense bf16 tensor-core rate, beside the plane's Philox
    instructions (philox_word_ops a word) at the issue rate (the larger
    time: the tensor cores and the SIMT lanes run side by side).
    With ``simt`` the f32 SIMT form instead (the bound of the SIMT kernels
    these replaced): the f32 FMAs at the f32 rate plus the Philox
    instructions, which share the SMs' issue slots."""
    t_bytes = 4 * (groups * (m * k + k * n + m * n) + mask_words) \
        / HBM_BYTES_PER_S
    flops = 2 * groups * m * n * k
    philox = mask_words * philox_word_ops(rounds) / ops_rate
    t_ops = (flops / F32_FLOPS_PER_S + philox if simt else
             max(F32_SPLIT_PRODUCTS * flops / BF16_FLOPS_PER_S, philox))
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def valid_pairs(sq, sk, causal, local_window) -> int:
    """Score elements a causal / windowed attention head needs."""
    q_pos = np.arange(sq)[:, None] + (sk - sq)
    k_pos = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= k_pos <= q_pos
    if local_window > 0:
        valid &= k_pos > q_pos - local_window
    return int(valid.sum())


def flash_bound(kind, b, h, s, d, pairs, elem=4, flops_rate=F32_FLOPS_PER_S,
                ops_rate=None, rounds=7):
    """(bound_ms, bound_by) of one MHA replay call (no plane): the matmul
    FLOPs the valid scores need (fwd QK^T and PV: 4D a pair; dq: 6D; dkv:
    8D) at ``flops_rate``, against each input read once and each output
    written once (``elem`` bytes an element of q/k/v/o/dO and the
    gradients; lse and delta f32). With ``ops_rate`` (the bf16 kernels,
    whose products could run on the tensor cores) the SIMT work that
    cannot is a third floor: an exponential a valid pair on the SFU (1/8
    of the issue lanes) and the replayed keep bits, philox_word_ops
    instructions per 32 pairs; tensor cores and SIMT lanes run side by
    side, so the floor is the larger time."""
    per = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d
    flops = per * pairs * b * h
    q_bytes = b * h * s * d * elem
    kv_bytes = 2 * b * h * s * d * elem
    row_bytes = b * h * s * 4
    moved = {"fwd": q_bytes + kv_bytes + q_bytes + row_bytes,
             "dq": 3 * q_bytes + kv_bytes + 2 * row_bytes,
             "dkv": 2 * q_bytes + kv_bytes + 2 * row_bytes + 2 * q_bytes}
    t_bytes = moved[kind] / HBM_BYTES_PER_S
    t_ops = flops / flops_rate
    if ops_rate is not None:
        t_ops = max(t_ops, simt_floor_ms(pairs * b * h, rounds, ops_rate,
                                         True) / 1e3)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def simt_floor_ms(pairs: int, rounds: int, ops_rate: float,
                  keep_bits: bool) -> float:
    """The SIMT work of ``pairs`` valid scores that the tensor cores cannot
    take, at the issue rate (flash_bound's third floor): an exponential a
    pair on the SFU and, with ``keep_bits``, the replayed keep bits
    (philox_word_ops instructions per 32 pairs)."""
    ops = pairs / SFU_PER_ISSUE_LANE
    if keep_bits:
        ops += pairs / 32 * philox_word_ops(rounds)
    return ops / ops_rate * 1e3


def _gemm_precision_control(tag, a, w, got, want, state, key) -> None:
    """The f32 GEMM+RNG C (``got``, f32 (E,) M x N) against the f64 product
    of A and W within F32_GEMM_F64_TOL, and a precision control both C
    checks must fail: the plain GEMM on A and W rounded once to bf16 (what
    a product that keeps an operand to bf16 computes) against ``want``, the
    plain GEMM on the f32 operands, and against the f64 product. Raises if
    the kernel misses the f64 limit or a limit would pass the control;
    prints each ratio to its limit, the plain version's own beside them."""
    def bf16(t):
        return t.to(torch.bfloat16).float()
    exact = torch.matmul(a.double(), w.double())
    err = _close(f"{tag} C against the f64 product", got, exact,
                 F32_GEMM_F64_TOL, state, f"{key}_f64")
    kernel64 = _within(got, exact, F32_GEMM_F64_TOL)[1]
    plain64 = _within(want, exact, F32_GEMM_F64_TOL)[1]
    ctl = torch.matmul(bf16(a), bf16(w))
    worst, ratio, ok = _within(ctl, want, F32_GEMM_TOL)
    ratio64, ok64 = _within(ctl, exact, F32_GEMM_F64_TOL)[1:]
    if ok or ok64:
        raise AssertionError(f"{tag}: an f32 GEMM limit passes the product "
                             f"of bf16-rounded A, W (max abs err {worst})")
    kernel = _within(got, want, F32_GEMM_TOL)[1]
    del exact, ctl
    log(f"[kernels] {tag} precision: the kernel at {kernel:.4g} of the "
        f"{F32_GEMM_TOL} x (1+|C|) limit from the plain version and at "
        f"{kernel64:.4g} of the {F32_GEMM_F64_TOL} x (1+|C|) limit from the "
        f"f64 product (max abs err {err:.3g}; the plain version itself at "
        f"{plain64:.4g} of it); the control (the plain GEMM on A, W rounded "
        f"once to bf16) at {ratio:.4g} and {ratio64:.4g} of them (max abs "
        f"err {worst:.3g}) -- both C checks fail the control")


def phase_kernels_train(state) -> None:
    """The training path's kernels against their plain versions, then
    timed at the training path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    ops_rate = issue_ops_per_s()
    timing = state.setdefault("timing", {})

    # ---- fused GEMM + RNG, and its Region-3 plain-GEMM variant
    m, n, k = QKV_SHAPE
    mb, mh, sq = QKV_MASK
    a, w = rnd(m, k), rnd(k, n)
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sq, p=0.1,
              seed=torch.tensor(77), salt=5)
    c, mask = gemm_rng.gemm_with_rng(a, w, **kw)
    want_c, want_mask = gemm_rng.gemm_with_rng_plain(a, w, **kw)
    torch.cuda.synchronize()
    if not torch.equal(mask, want_mask):
        raise AssertionError("gemm_rng plane != plain version")
    err = _close("gemm_rng C", c, want_c, F32_GEMM_TOL, state, "gemm_rng")
    _gemm_precision_control("gemm_rng", a, w, c, want_c, state,
                            "gemm_rng")
    m3, n3, k3, (b3, h3, s3) = REGION3
    a3, w3 = rnd(m3, k3), rnd(k3, n3)
    c3, none = gemm_rng.gemm_with_rng(a3, w3, mask_batch=b3, mask_heads=h3,
                                      mask_sq=s3, mask_sk=s3, p=0.1, seed=1,
                                      block_m=256, block_n=256, block_k=64)
    if none is not None or gemm_rng.variant_counts()["plain"] < 1:
        raise AssertionError("Region-3 shape did not run the plain variant")
    want3, _ = gemm_rng.gemm_with_rng_plain(
        a3, w3, mask_batch=b3, mask_heads=h3, mask_sq=s3, mask_sk=s3, p=0.1,
        seed=1, block_m=256, block_n=256, block_k=64)
    err3 = _close("gemm plain variant", c3, want3, F32_GEMM_TOL, state,
                  "gemm_rng")
    log(f"[kernels] gemm_rng {m}x{n}x{k} + plane {mb}x{mh}x{sq // 32}x{sq}"
        f": plane == plain bitwise, C max abs err {err:.3g} (tol "
        f"{F32_GEMM_TOL} x (1+|C|): 4096-term f32 sums in another order "
        f"than cuBLAS's); Region 3 {m3}x{n3}x{k3}: plane None, C max abs err "
        f"{err3:.3g}")
    launch = lambda: gemm_rng.gemm_with_rng(a, w, **kw)  # noqa: E731
    # the Region-3 variant at the same product and plane: a one-step
    # logical grid cannot host 4096 packed rows, so the emission is off
    launch_plain = lambda: gemm_rng.gemm_with_rng(  # noqa: E731
        a, w, block_m=m, block_n=n, **kw)
    before = gemm_rng.variant_counts()["plain"]
    if launch_plain()[1] is not None or \
            gemm_rng.variant_counts()["plain"] != before + 1:
        raise AssertionError("the Region-3 timing call emitted a plane")
    runs = {"rng": [], "plain": []}
    for variant in ("rng", "plain", "plain", "rng"):   # in turns
        runs[variant].append(cuda_time_ms(
            launch if variant == "rng" else launch_plain, 5))
    ms, plain3_ms = (float(np.mean(runs[v])) for v in ("rng", "plain"))
    plain_ms = cuda_time_ms(lambda: gemm_rng.gemm_with_rng_plain(a, w, **kw),
                            2, warmup=1)
    lib_ms = cuda_time_ms(lambda: a @ w, 10)
    words = mb * mh * (sq // 32) * sq
    bound_ms, bound_by = gemm_rng_bound(m, n, k, words, 7, ops_rate)
    plain3_bound, plain3_by = gemm_rng_bound(m, n, k, 0, 7, ops_rate)
    simt_ms = gemm_rng_bound(m, n, k, words, 7, ops_rate, simt=True)[0]
    plain3_simt = gemm_rng_bound(m, n, k, 0, 7, ops_rate, simt=True)[0]
    timing["gemm_rng"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms,
                              plain_variant_ms=plain3_ms,
                              plain_variant_bound_ms=plain3_bound,
                              plain_variant_bound_by=plain3_by,
                              plain_variant_plain_ms=lib_ms)
    log(f"[kernels] gemm_rng {m}x{n}x{k}: {ms:.4f} ms a launch (CUDA "
        f"events, in turns {runs['rng']}), {2 * m * n * k / ms / 1e9:.1f} "
        f"TFLOP/s; plain variant (Region 3, no plane) {plain3_ms:.4f} ms "
        f"(in turns {runs['plain']}, bound {plain3_bound:.4f} ms, "
        f"{plain3_bound / plain3_ms * 100:.1f}%; {plain3_simt:.4f} at the "
        f"f32 SIMT rate); torch.matmul {lib_ms:.4f} ms (the kernel "
        f"{ms / lib_ms:.3f}x of it); plain version {plain_ms:.2f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} at {F32_SPLIT_PRODUCTS} bf16 "
        f"products an f32 product ({simt_ms:.4f} at the f32 SIMT rate), "
        f"kernel at {bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
    del a, w, c, mask, want_c, want_mask

    # ---- flash forward, dq, dkv (at head_dim 128, then 256)
    _flash_kernels(state, rnd, torch.float32, ops_rate)
    _flash_kernels_wide(state, rnd, ops_rate, torch.float32)


# flash cases each dtype is checked in, (mode, local window, kv heads or
# None for H[, head_dim or None for D, SQ or None for S]) -- SK stays S, so
# an SQ below it puts the queries at key positions q + SK - SQ (at SQ =
# 960, 15 q-blocks: the f32 forward's last CTA has a second warpgroup with
# no rows); the main path's mode (replay, causal, MHA) is then timed
FLASH_CASES = {
    dtype: (("none", 0, None), ("fused", 0, None), ("premask", 0, None),
            ("replay", 0, None), ("replay", 512, None), ("replay", 0, 4),
            ("replay", 0, None, 64, None), ("replay", 0, None, None, 1024),
            ("replay", 0, None, None, 960))
    for dtype in (torch.float32, torch.bfloat16)
}


def _flash_fault(tag, q, k, v, do, plane, got, tols, bf16) -> None:
    """A planted fault the flash checks must fail: the plain versions on
    ``plane`` with the keep bits of one word row x 64 keys (FLASH_FAULT,
    batch 0, head 0) flipped, against the kernels' outputs ``got`` (o, dq,
    dk, dv) on the true plane. Raises if a check would pass it."""
    r0, c0 = FLASH_FAULT
    bad = plane.clone()
    bad[0, 0, r0 // 32, c0:c0 + 64] ^= -1
    args = dict(causal=True, dropout_p=0.1, mode="premask")
    fo, flse = flash.flash_attention_fwd_plain(q, k, v, bad, **args)
    want = (fo, *flash_bwd.flash_attention_bwd_plain(q, k, v, fo, flse, do,
                                                     bad, **args))
    out_tol, grad_tol = tols
    found, jax_rule = [], []
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (out_tol, grad_tol, grad_tol, grad_tol)):
        worst, ratio, ok = _within(g.float(), w.float(), tol, bf16)
        if ok:
            raise AssertionError(f"{tag}: the check passes a planted fault "
                                 f"in {name} (max abs err {worst})")
        found.append(f"{name} {worst:.3g} ({ratio:.3g} of the limit)")
        jax_rule.append(_within(g.float(), w.float(), 3e-2)[2])
    how = (f"; under JAX's 3e-2 x (1+|x|) it would pass in "
           f"{sum(jax_rule)} of 4" if bf16 else "")
    log(f"[kernels] {tag} planted fault (keep bits of rows {r0}-{r0 + 31} x "
        f"keys {c0}-{c0 + 63}, b0 h0, flipped): max abs err "
        f"{', '.join(found)} -- every check fails it{how}")


def _flash_precision_control(q, k, v, do, o, lse, plane, want) -> None:
    """A precision control the f32 dq, dk, dv checks must fail: the plain
    backward with K, V and dO rounded once to bf16 (what a product that
    splits only one operand keeps of the other) against ``want``, the
    plain backward on the f32 inputs (premask, causal). Raises if GRAD_TOL
    would pass it; prints its ratios to GRAD_TOL and to 1e-3 x (1+|x|)."""
    def bf16(t):
        return t.to(torch.bfloat16).float()
    got = flash_bwd.flash_attention_bwd_plain(
        q, bf16(k), bf16(v), o, lse, bf16(do), plane, causal=True,
        dropout_p=0.1, mode="premask")
    found = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        worst, ratio, ok = _within(g, w, GRAD_TOL)
        if ok:
            raise AssertionError(f"flash: the f32 limit passes dq, dk, dv on "
                                 f"bf16-rounded K, V, dO in {name} (max abs "
                                 f"err {worst})")
        found.append(f"{name} {ratio:.3g} ({_within(g, w, 1e-3)[1]:.3g} of "
                     f"1e-3 x (1+|x|))")
    log(f"[kernels] flash precision control (the plain backward on K, V, "
        f"dO rounded once to bf16) against the f32 plain backward: "
        f"{', '.join(found)} of the {GRAD_TOL} x (1+|x|) limit -- every "
        f"f32 gradient check fails it")


def _flash_fwd_precision_control(q, k, v, plane, want_o, want_lse) -> None:
    """A precision control the f32 O and lse checks must fail: the plain
    forward with K and V rounded once to bf16 (what a product that splits
    only one operand keeps of the other) against ``want_o``, ``want_lse``,
    the plain forward on the f32 inputs (premask, causal). Raises if
    F32_FWD_TOL would pass it; prints its ratios to F32_FWD_TOL and to
    FWD_TOL, the limit the SIMT forward was held to."""
    def bf16(t):
        return t.to(torch.bfloat16).float()
    got = flash.flash_attention_fwd_plain(q, bf16(k), bf16(v), plane,
                                          causal=True, dropout_p=0.1,
                                          mode="premask")
    found = []
    for name, g, w in zip(("o", "lse"), got, (want_o, want_lse)):
        worst, ratio, ok = _within(g, w, F32_FWD_TOL)
        if ok:
            raise AssertionError(f"flash: the f32 limit passes the forward "
                                 f"on bf16-rounded K, V in {name} (max abs "
                                 f"err {worst})")
        found.append(f"{name} {ratio:.4g} ({_within(g, w, FWD_TOL)[1]:.4g} "
                     f"of {FWD_TOL} x (1+|x|))")
    log(f"[kernels] flash forward precision control (the plain forward on K, "
        f"V rounded once to bf16) against the f32 plain forward: "
        f"{', '.join(found)} of the {F32_FWD_TOL} x (1+|x|) limit -- the f32 "
        f"O and lse checks fail it")


def _flash_kernels(state, rnd, dtype, ops_rate) -> None:
    """The flash forward, dq and dkv kernels of ``dtype`` (f32, or the bf16
    instances) against their plain versions in FLASH_CASES at
    FLASH_SHAPE (or the case's head_dim and SQ), causal; replay == premask
    bitwise; then timed on the main path's mode beside the bound and SDPA
    on the same inputs (no dropout), and each kernel in each dropout mode
    beside the SIMT floor (``simt_floor_ms``). f32 is held at
    F32_FWD_TOL (O and lse) / GRAD_TOL, bf16 at BF16_FLASH_TOL (lse, f32
    at both, at FWD_TOL); each dtype's checks must fail a planted fault
    (``_flash_fault``), and the f32 checks precision controls
    (``_flash_fwd_precision_control``, ``_flash_precision_control``)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.philox_common import seed_salt_smem
    bf16 = dtype == torch.bfloat16
    names = (flash.KERNELS[dtype], *flash_bwd.KERNELS[dtype])
    out_tol, grad_tol, lse_tol = (
        (BF16_FLASH_TOL, BF16_FLASH_TOL, FWD_TOL) if bf16
        else (F32_FWD_TOL, GRAD_TOL, F32_FWD_TOL))
    tag = "flash bf16" if bf16 else "flash"
    timing = state.setdefault("timing", {})
    b, h, s, d = FLASH_SHAPE
    plane = philox.philox_dropout_mask_plain(b, h, s, s, 0.1,
                                             torch.tensor(9), 3,
                                             device="cuda")
    seed_salt = seed_salt_smem(torch.tensor(9), 3)
    outs = {}
    for mode, window, kvh, *shape in FLASH_CASES[dtype]:
        kvh = kvh or h
        dd, sq = (shape + [None, None])[:2]
        dd, sq = dd or d, sq or s
        q, do = rnd(b, h, sq, dd), rnd(b, h, sq, dd)
        kk, vv = rnd(b, kvh, s, dd), rnd(b, kvh, s, dd)
        op = {"premask": plane, "replay": seed_salt}.get(mode)
        args = dict(causal=True, local_window=window, dropout_p=0.1,
                    mode=mode, seed=torch.tensor(9), salt=3)
        o, lse = flash.flash_attention_fwd(q, kk, vv, op, return_lse=True,
                                           **args)
        po, plse = flash.flash_attention_fwd_plain(q, kk, vv, op, **args)
        # dk, dv as the dkv kernel writes them, per query head: the GQA
        # group sum is the same torch sum on both sides
        dq, dk, dv = flash_bwd.flash_attention_bwd_heads(
            q, kk, vv, o, lse, do, op, **args)
        pdq, pdk, pdv = flash_bwd.flash_attention_bwd_plain(
            q, kk, vv, po, plse, do, op, **args)
        torch.cuda.synchronize()
        if any(t.dtype != dtype for t in (o, dq, dk, dv)) or \
                lse.dtype != torch.float32:
            raise AssertionError(f"{tag} output dtypes")
        label = (f"{mode} window={window} kv_heads={kvh} D={dd} SQ={sq} "
                 f"SK={s}")
        errs = [_close(f"{names[0]} {label}", o.float(), po.float(),
                       out_tol, state, names[0], scaled=bf16),
                _close(f"{names[0]} lse {label}", lse, plse, lse_tol, state,
                       names[0]),
                _close(f"{names[1]} {label}", dq.float(), pdq.float(),
                       grad_tol, state, names[1], scaled=bf16),
                _close(f"{names[2]} dk {label}", dk.float(), pdk.float(),
                       grad_tol, state, names[2], scaled=bf16),
                _close(f"{names[2]} dv {label}", dv.float(), pdv.float(),
                       grad_tol, state, names[2], scaled=bf16)]
        ratios = [_within(g.float(), w.float(), t, bf16)[1] for g, w, t in
                  ((o, po, out_tol), (dq, pdq, grad_tol),
                   (dk, pdk, grad_tol), (dv, pdv, grad_tol))]
        ratios.insert(1, _within(lse, plse, lse_tol)[1])
        if (dd, sq) == (d, s):
            outs[(mode, window, kvh)] = (q, kk, vv, do, o, lse, op)
        rule = ("x (|x| + rms(x)): one bf16 ulp where the f32 sums round "
                "apart" if bf16 else "x (1+|x|): 2048-term f32 sums in "
                "another order than the plain version's")
        if kvh != h:
            # each head's values rounded apart, then summed over 8 heads:
            # one rounding of a large value where the heads nearly cancel
            # moves the sum by more than the sum's limit, for the SIMT
            # kernels as well (PERF.md 7); printed, the heads are held
            gsum = [_within(*(x.reshape(b, kvh, h // kvh, s, dd).sum(2)
                              .float() for x in pair), grad_tol, bf16)[1]
                    for pair in ((dk, pdk), (dv, pdv))]
            rule += (f"; per query head, their GQA sums at "
                     f"{gsum[0]:.3g}, {gsum[1]:.3g} of that limit")
        log(f"[kernels] {tag} {b}x{h} {label}: max abs err o "
            f"{errs[0]:.3g} lse {errs[1]:.3g} (tol {out_tol}; lse "
            f"{lse_tol} x (1+|x|)), dq {errs[2]:.3g} dk {errs[3]:.3g} dv "
            f"{errs[4]:.3g} (tol {grad_tol} {rule}); o, lse, dq, dk, dv at "
            f"{', '.join(f'{r:.3g}' for r in ratios)} of their limits")
        if mode == "premask" and kvh == h:
            _flash_fault(tag, q, kk, vv, do, op, (o, dq, dk, dv),
                         (out_tol, grad_tol), bf16)
            if not bf16:
                _flash_fwd_precision_control(q, kk, vv, op, po, plse)
                _flash_precision_control(q, kk, vv, do, po, plse, op,
                                         (pdq, pdk, pdv))
        del q, do, kk, vv, o, lse, dq, dk, dv, po, plse, pdq, pdk, pdv
    # replay and premask consume the same bits: equal inputs, equal outputs
    q, kk, vv, do = outs[("replay", 0, h)][:4]
    args = dict(causal=True, dropout_p=0.1)
    o_r, l_r = flash.flash_attention_fwd(q, kk, vv, seed_salt, mode="replay",
                                         return_lse=True, **args)
    o_p, l_p = flash.flash_attention_fwd(q, kk, vv, plane, mode="premask",
                                         return_lse=True, **args)
    g_r = flash_bwd.flash_attention_bwd(q, kk, vv, o_r, l_r, do, seed_salt,
                                        mode="replay", **args)
    g_p = flash_bwd.flash_attention_bwd(q, kk, vv, o_p, l_p, do, plane,
                                        mode="premask", **args)
    if not (torch.equal(o_r, o_p) and all(torch.equal(x, y)
                                          for x, y in zip(g_r, g_p))):
        raise AssertionError(f"{tag} replay != premask on the same inputs")
    log(f"[kernels] {tag}: replay == premask bitwise (o, dq, dk, dv)")
    del o_r, o_p, g_r, g_p

    # timing on the main path's mode (replay, causal, MHA)
    q, kk, vv, do, o, lse, op = outs[("replay", 0, h)]
    args = dict(causal=True, dropout_p=0.1, mode="replay")
    pairs = valid_pairs(s, s, True, 0)
    fwd = lambda: flash.flash_attention_fwd(  # noqa: E731
        q, kk, vv, op, return_lse=True, **args)
    bwd = lambda: flash_bwd.flash_attention_bwd(  # noqa: E731
        q, kk, vv, o, lse, do, op, **args)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, kk, vv))
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    lib_fwd = cuda_time_ms(lambda: sdpa(q, kk, vv, is_causal=True), 10)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), do, retain_graph=True), 10)
    plain_fwd_ms = cuda_time_ms(lambda: flash.flash_attention_fwd_plain(
        q, kk, vv, op, **args), 2, warmup=1)
    plain_bwd_ms = cuda_time_ms(lambda: flash_bwd.flash_attention_bwd_plain(
        q, kk, vv, o, lse, do, op, **args), 2, warmup=1)
    bwd_ms = cuda_time_ms(bwd, 10)
    for name, kind in zip(names, ("fwd", "dq", "dkv")):
        if kind == "fwd":
            ms = cuda_time_ms(fwd, 10)
            how = "CUDA events"
        else:
            # both backward kernels run in one call: each one's device
            # time comes from a profiler trace of that call
            ms = device_time_ms(bwd, f"flash_{kind}_kernel", 10)
            if ms is None:
                raise AssertionError("the profiler saw no device time")
            how = (f"profiler; the whole backward call {bwd_ms:.4f} ms by "
                   f"CUDA events")
        f32_bound, f32_by = flash_bound(kind, b, h, s, d, pairs,
                                       elem=2 if bf16 else 4)
        if bf16:
            bound_ms, bound_by = flash_bound(
                kind, b, h, s, d, pairs, elem=2,
                flops_rate=BF16_FLOPS_PER_S, ops_rate=ops_rate)
            extra = (f" (bf16 tensor cores, 2-byte elements, exp and "
                     f"Philox issue work; at the f32 rate it multiplies "
                     f"at: {f32_bound:.4f} ms)")
        else:
            # six bf16 products an f32 product (both operands split into
            # exact triples) on the tensor cores, and the SIMT floor
            bound_ms, bound_by = flash_bound(
                kind, b, h, s, d, pairs, elem=4,
                flops_rate=BF16_FLOPS_PER_S / F32_SPLIT_PRODUCTS,
                ops_rate=ops_rate)
            extra = (f" (bf16 tensor cores at {F32_SPLIT_PRODUCTS} "
                     f"products an f32 product, exp and Philox issue work; "
                     f"at the f32 SIMT rate: {f32_bound:.4f} ms)")
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d * pairs * b * h
        plain_ms, lib_ms = ((plain_fwd_ms, lib_fwd) if kind == "fwd"
                            else (plain_bwd_ms, lib_bwd))
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms)
        log(f"[kernels] {name} {b}x{h}x{s}x{d} causal replay: {ms:.4f} ms a "
            f"launch ({how}), {flops / ms / 1e9:.1f} TFLOP/s; plain "
            f"{plain_ms:.2f} ms; SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq, dk, dv)'} "
            f"{lib_ms:.4f} ms (no dropout); bound {bound_ms:.4f} ms by "
            f"{bound_by}{extra}, kernel at {bound_ms / ms * 100:.1f}% of "
            f"bound | {state['smi']}")
    pair = timing[names[1]]["ms"] + timing[names[2]]["ms"]
    log(f"[kernels] {tag} dq + dkv {pair:.4f} ms against SDPA's whole "
        f"backward (dq, dk, dv; no dropout) {lib_bwd:.4f} ms: "
        f"{pair / lib_bwd:.3f}x | {state['smi']}")
    # the RNG's cost inside attention: the same inputs in each mode (none
    # draws no bits, premask reads them, replay makes them), against the
    # SIMT floor of the exponentials without and with the replayed bits
    q, kk, vv, do = outs[("replay", 0, h)][:4]
    floor_exp = simt_floor_ms(pairs * b * h, 7, ops_rate, False)
    floor_rng = simt_floor_ms(pairs * b * h, 7, ops_rate, True)
    modes = {}
    for kind, name in (("fwd", names[0]), ("dq", names[1]),
                       ("dkv", names[2])):
        for mode, op in (("none", None), ("premask", plane),
                         ("replay", seed_salt)):
            args = dict(causal=True, dropout_p=0.1, mode=mode)
            o, lse = flash.flash_attention_fwd(q, kk, vv, op,
                                               return_lse=True, **args)
            if kind == "fwd":
                ms = cuda_time_ms(lambda: flash.flash_attention_fwd(
                    q, kk, vv, op, **args), 10)
            else:
                ms = device_time_ms(lambda: flash_bwd.flash_attention_bwd(
                    q, kk, vv, o, lse, do, op, **args),
                    f"flash_{kind}_kernel", 10)
                if ms is None:
                    raise AssertionError("the profiler saw no device time")
            modes.setdefault(name, {})[mode] = ms
        t = modes[name]
        log(f"[kernels] {name} causal by dropout mode: none {t['none']:.4f}, "
            f"premask {t['premask']:.4f}, replay {t['replay']:.4f} ms a "
            f"launch; replay - premask {t['replay'] - t['premask']:+.4f} ms "
            f"(the keep bits made inside attention), premask - none "
            f"{t['premask'] - t['none']:+.4f} ms (read); SIMT floor "
            f"{floor_exp:.4f} ms for the exponentials, {floor_rng:.4f} ms "
            f"with the replayed bits ({floor_rng - floor_exp:.4f} ms of "
            f"Philox issue work) | {state['smi']}")
        timing[name]["modes_ms"] = dict(t)
    del outs, plane
    gc.collect()
    torch.cuda.empty_cache()


# the flash kernels at head_dim 256, recurrentgemma-9b's LOCAL layer: B=1,
# 16 query heads over one kv head (MQA), S=4096, causal; the dropout modes
# without a window, then replay with its window of 2048, the main path's
# mode, which is timed: (mode, local window)
WIDE_SHAPE = (1, 16, 1, 4096, 256)
WIDE_CASES = (("none", 0), ("fused", 0), ("premask", 0), ("replay", 0),
              ("replay", 2048))
# GQA and MHA at small shapes, two with SQ % 128 == 64 (the last CTA of
# the bf16 forward and dq with one row group): (mode, local window, B, H,
# KV, S)
WIDE_GQA_CASES = (("none", 0, 2, 4, 2, 192), ("premask", 128, 1, 4, 2, 320),
                  ("replay", 64, 1, 8, 2, 256), ("fused", 0, 1, 4, 4, 192))


def _flash_kernels_wide(state, rnd, ops_rate, dtype) -> None:
    """The flash forward, dq and dkv instances of ``dtype`` at head_dim 256
    (kernels of their own; the f32 ones stream the walked tiles in
    32-column slices) against their plain
    versions in WIDE_CASES -- bf16 at BF16_FLASH_TOL (lse at FWD_TOL),
    f32 at F32_FWD_TOL (O and lse) and GRAD_TOL, with the precision
    controls (``_flash_fwd_precision_control``,
    ``_flash_precision_control``) failing them -- and in WIDE_GQA_CASES
    (GQA, MHA, SQ % 128 == 64, every mode, with and without a window),
    replay == premask == fused bitwise on the same inputs (the same
    counters), a planted fault every check must fail (``_flash_fault``),
    then timed in replay with
    the window beside the bound and SDPA's forward and backward with the
    window as a boolean mask (kv expanded to the 16 heads), and each
    kernel by dropout mode (none, premask, replay, fused) with the
    window."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.philox_common import seed_salt_smem
    bf16 = dtype == torch.bfloat16
    b, h, kvh, s, d = WIDE_SHAPE
    names = [flash.instance(n, d) for n in
             (flash.KERNELS[dtype], *flash_bwd.KERNELS[dtype])]
    out_tol, grad_tol, lse_tol = (
        (BF16_FLASH_TOL, BF16_FLASH_TOL, FWD_TOL) if bf16
        else (F32_FWD_TOL, GRAD_TOL, F32_FWD_TOL))
    tag = f"flash {'bf16' if bf16 else 'f32'} D={d}"
    timing = state.setdefault("timing", {})
    seed = torch.tensor(9)
    plane = philox.philox_dropout_mask_plain(b, h, s, s, 0.1, seed, 3,
                                             device="cuda")
    seed_salt = seed_salt_smem(seed, 3)
    ops = {"premask": plane, "replay": seed_salt}
    q, do = rnd(b, h, s, d), rnd(b, h, s, d)
    kk, vv = rnd(b, kvh, s, d), rnd(b, kvh, s, d)
    outs, windowed = {}, None
    for mode, window in WIDE_CASES:
        op = ops.get(mode)
        args = dict(causal=True, local_window=window, dropout_p=0.1,
                    mode=mode, seed=seed, salt=3)
        before = launch_counts()
        o, lse = flash.flash_attention_fwd(q, kk, vv, op, return_lse=True,
                                           **args)
        po, plse = flash.flash_attention_fwd_plain(q, kk, vv, op, **args)
        dq, dk, dv = flash_bwd.flash_attention_bwd_heads(
            q, kk, vv, o, lse, do, op, **args)
        pdq, pdk, pdv = flash_bwd.flash_attention_bwd_plain(
            q, kk, vv, po, plse, do, op, **args)
        torch.cuda.synchronize()
        after = launch_counts()
        if any(after[n] != before[n] + 1 for n in names):
            raise AssertionError(f"{tag}: the D={d} instances did not "
                                 f"launch ({names})")
        if any(t.dtype != dtype for t in (o, dq, dk, dv)) or \
                lse.dtype != torch.float32:
            raise AssertionError(f"{tag} output dtypes")
        label = f"{mode} window={window} kv_heads={kvh} D={d} S={s}"
        ratios = []
        for name, key, got, want, t, scaled in (
                ("o", names[0], o, po, out_tol, bf16),
                ("lse", names[0], lse, plse, lse_tol, False),
                ("dq", names[1], dq, pdq, grad_tol, bf16),
                ("dk", names[2], dk, pdk, grad_tol, bf16),
                ("dv", names[2], dv, pdv, grad_tol, bf16)):
            _close(f"{key} {name} {label}", got.float(), want.float(), t,
                   state, key, scaled=scaled)
            ratio = _within(got.float(), want.float(), t, scaled)[1]
            ratios.append(f"{name} {ratio:.3g}")
        rule = (f"tol {out_tol} x (|x| + rms(x)), lse {lse_tol} x (1+|x|)"
                if bf16 else f"o, lse {out_tol}, dq, dk, dv {grad_tol} x "
                f"(1+|x|)")
        log(f"[kernels] {tag} {b}x{h} {label}: {', '.join(ratios)} of "
            f"their limits ({rule}; dk, dv per query head)")
        if window == 0:
            outs[mode] = (o, dq, dk, dv)
        elif bf16:
            # the orders of f32 sums, against the plain version's
            windowed = (po, pdq, pdk, pdv)
            log(f"[kernels] {tag} {label}: "
                + differing_shares((o, dq, dk, dv), windowed))
        if mode == "premask":
            _flash_fault(tag, q, kk, vv, do, plane, (o, dq, dk, dv),
                         (out_tol, grad_tol), bf16)
            if not bf16:
                _flash_fwd_precision_control(q, kk, vv, plane, po, plse)
                _flash_precision_control(q, kk, vv, do, po, plse, plane,
                                         (pdq, pdk, pdv))
        del po, plse, pdq, pdk, pdv
    # GQA and MHA, among them SQ % 128 == 64, at small shapes
    for mode, window, gb, gh, gkv, gs in WIDE_GQA_CASES:
        gq, gdo = rnd(gb, gh, gs, d), rnd(gb, gh, gs, d)
        gk, gv = rnd(gb, gkv, gs, d), rnd(gb, gkv, gs, d)
        op = {"premask": philox.philox_dropout_mask_plain(
            gb, gh, gs, gs, 0.1, seed, 3, device="cuda"),
              "replay": seed_salt}.get(mode)
        args = dict(causal=True, local_window=window, dropout_p=0.1,
                    mode=mode, seed=seed, salt=3)
        o, lse = flash.flash_attention_fwd(gq, gk, gv, op, return_lse=True,
                                           **args)
        po, plse = flash.flash_attention_fwd_plain(gq, gk, gv, op, **args)
        got = (o, lse, *flash_bwd.flash_attention_bwd_heads(
            gq, gk, gv, o, lse, gdo, op, **args))
        want = (po, plse, *flash_bwd.flash_attention_bwd_plain(
            gq, gk, gv, po, plse, gdo, op, **args))
        label = (f"{mode} window={window} {gb}x{gh} kv_heads={gkv} D={d} "
                 f"S={gs}")
        ratios = []
        for name, key, g, w, t, scaled in zip(
                ("o", "lse", "dq", "dk", "dv"),
                (names[0], names[0], names[1], names[2], names[2]), got, want,
                (out_tol, lse_tol, grad_tol, grad_tol, grad_tol),
                (bf16, False, bf16, bf16, bf16)):
            _close(f"{key} {name} {label}", g.float(), w.float(), t, state,
                   key, scaled=scaled)
            ratios.append(f"{name} "
                          f"{_within(g.float(), w.float(), t, scaled)[1]:.3g}")
        log(f"[kernels] {tag} {label}: {', '.join(ratios)} of their limits")
        del gq, gdo, gk, gv, o, lse, po, plse, got, want
    # replay, fused and premask consume the same bits
    for mode in ("replay", "fused"):
        if not all(torch.equal(x, y) for x, y in zip(outs[mode],
                                                     outs["premask"])):
            raise AssertionError(f"{tag}: {mode} != premask on the same "
                                 f"inputs")
    log(f"[kernels] {tag}: replay == fused == premask bitwise (o, dq, dk, "
        f"dv)")
    del outs

    # timing: replay with the window, recurrentgemma's LOCAL layer
    win = WIDE_CASES[-1][1]
    args = dict(causal=True, local_window=win, dropout_p=0.1)
    pairs = valid_pairs(s, s, True, win)
    o, lse = flash.flash_attention_fwd(q, kk, vv, seed_salt, mode="replay",
                                       return_lse=True, **args)
    ke, ve = (t.expand(b, h, s, d).contiguous() for t in (kk, vv))
    valid = flash.score_mask(0, s, s, s, True, win, q.device)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, ke, ve))
    lib_out = sdpa(qs, ks, vs, attn_mask=valid)
    lib_fwd = cuda_time_ms(lambda: sdpa(q, ke, ve, attn_mask=valid), 10)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), do, retain_graph=True), 10)
    # context, not a yardstick: SDPA causal without the window covers
    # more pairs than the kernels' (valid_pairs)
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    causal_fwd = cuda_time_ms(lambda: sdpa(q, ke, ve, is_causal=True), 10)
    causal_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), do, retain_graph=True), 10)
    causal_pairs = valid_pairs(s, s, True, 0) / pairs
    causal_ms = {True: causal_fwd, False: causal_bwd}
    del lib_out, qs, ks, vs
    kw = dict(args, mode="replay")
    plain_fwd = cuda_time_ms(lambda: flash.flash_attention_fwd_plain(
        q, kk, vv, seed_salt, **kw), 2, warmup=1)
    plain_bwd = cuda_time_ms(lambda: flash_bwd.flash_attention_bwd_plain(
        q, kk, vv, o, lse, do, seed_salt, **kw), 2, warmup=1)
    modes = {n: {} for n in names}
    for mode in ("none", "premask", "replay", "fused"):
        op = ops.get(mode)
        mk = dict(args, mode=mode, seed=seed, salt=3)
        om, lm = flash.flash_attention_fwd(q, kk, vv, op, return_lse=True,
                                           **mk)
        modes[names[0]][mode] = cuda_time_ms(
            lambda: flash.flash_attention_fwd(q, kk, vv, op, **mk), 10)
        for name, kind in zip(names[1:], ("dq", "dkv")):
            ms = device_time_ms(lambda: flash_bwd.flash_attention_bwd(
                q, kk, vv, om, lm, do, op, **mk), f"flash_{kind}_kernel", 10)
            if ms is None:
                raise AssertionError("the profiler saw no device time")
            modes[name][mode] = ms
    parent_ms = _time_parent_wide(state, dtype, q, kk, vv, do, seed_salt,
                                  args, windowed)
    for name, kind in zip(names, ("fwd", "dq", "dkv")):
        # bf16: the bf16 tensor cores; f32: six bf16 products an f32
        # product (both operands split into exact triples) on them; the
        # SIMT floor of the exponentials and the replayed bits beside
        bound_ms, bound_by = flash_bound(
            kind, b, h, s, d, pairs, elem=2 if bf16 else 4,
            flops_rate=BF16_FLOPS_PER_S / (1 if bf16 else F32_SPLIT_PRODUCTS),
            ops_rate=ops_rate)
        ms = modes[name]["replay"]
        plain_ms, lib_ms = ((plain_fwd, lib_fwd) if kind == "fwd"
                            else (plain_bwd, lib_bwd))
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms,
                            modes_ms=dict(modes[name]))
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d * pairs * b * h
        t = modes[name]
        rate = ("" if bf16 else
                f" at {F32_SPLIT_PRODUCTS} bf16 products an f32 product")
        log(f"[kernels] {name} {b}x{h} kv=1 S={s} D={d} causal window={win} "
            f"replay: {ms:.4f} ms a launch, {flops / ms / 1e9:.1f} TFLOP/s; "
            f"plain {plain_ms:.2f} ms; SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq, dk, dv)'} with "
            f"the window as a mask {lib_ms:.4f} ms (no dropout); bound "
            f"{bound_ms:.4f} ms by {bound_by}{rate}, kernel at "
            f"{bound_ms / ms * 100:.1f}% of bound; by mode: none "
            f"{t['none']:.4f}, premask {t['premask']:.4f}, replay "
            f"{t['replay']:.4f}, fused {t['fused']:.4f} ms; SDPA causal "
            f"without the window {causal_ms[kind == 'fwd']:.4f} ms "
            f"({causal_pairs:.2f}x the pairs) | {state['smi']}")
        if kind in parent_ms:
            timing[name]["parent_ms"] = parent_ms[kind]
    del plane, q, do, kk, vv, ke, ve, o, lse, windowed
    gc.collect()
    torch.cuda.empty_cache()


# The parent commit's bf16 dq and dkv at head_dim 256 against the
# redesigned ones, in turns, from this script's run with the parent
# checkout in build/parent (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the
# WIDE_SHAPE, replay, window 2048: kind -> (parent ms, redesigned ms), each
# the mean of its two turns
PROBE_IN_TURNS = {"dq": (1.1712, 0.6498), "dkv": (1.5157, 1.0705)}


def differing_shares(got, want) -> str:
    """The share of each bf16 output (O, dq, dk, dv) whose values differ
    from the plain version's, as one phrase."""
    return ", ".join(
        f"{name} {float((g != w).float().mean()) * 100:.4f} %"
        for name, g, w in zip(("O", "dq", "dk", "dv"), got, want)
    ) + " of their bf16 values differ from the plain version's"


def parent_kernel(kind, dtype, lib):
    """(module, kernel name, the parent library's entry point with the
    tree's argument types) of the flash kernel ``kind`` at ``dtype``."""
    import ctypes
    module = flash if kind == "fwd" else flash_bwd
    kname = (flash.KERNELS[dtype] if kind == "fwd" else
             flash_bwd.KERNELS[dtype][kind == "dkv"])
    fn = getattr(ctypes.CDLL(str(lib)), f"repro_{kname}")
    fn.argtypes, fn.restype = module._kernel_fn(kname).argtypes, ctypes.c_int
    return module, kname, fn


def time_flash(kind, q, k, v, do, op, kw, o, lse) -> float:
    """ms of one call of the flash kernel ``kind``: the forward by CUDA
    events, dq and dkv by the profiler (their backward call runs both)."""
    if kind == "fwd":
        return cuda_time_ms(lambda: flash.flash_attention_fwd(
            q, k, v, op, **kw), 10)
    ms = device_time_ms(lambda: flash_bwd.flash_attention_bwd(
        q, k, v, o, lse, do, op, **kw), f"flash_{kind}_kernel", 10)
    if ms is None:
        raise AssertionError("the profiler saw no device time")
    return ms


def in_turns(kind, module, kname, parent, q, k, v, do, op, kw):
    """(parent ms, tree ms) of the kernel ``kind`` in turns (parent, tree,
    tree, parent) on the same inputs, its entry point swapped in
    ``module``'s cache; the forward's o and lse feed the backward."""
    tree = module._kernel_fn(kname)
    o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True, **kw)
    times = {"parent": [], "tree": []}
    try:
        for who in ("parent", "tree", "tree", "parent"):
            module._fns[kname] = parent if who == "parent" else tree
            times[who].append(time_flash(kind, q, k, v, do, op, kw, o, lse))
    finally:
        module._fns[kname] = tree
    return times["parent"], times["tree"]


def flash_outputs(q, k, v, do, op, kw, entries=()):
    """O, dq, dk, dv of the flash kernels with the entry points
    ``entries`` ((module, kernel name, entry point) each, from
    ``parent_kernel``) swapped in for the call."""
    tree = {}
    try:
        for module, kname, fn in entries:
            tree[kname] = (module, module._kernel_fn(kname))
            module._fns[kname] = fn
        o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True,
                                           **kw)
        return (o, *flash_bwd.flash_attention_bwd_heads(q, k, v, o, lse, do,
                                                        op, **kw))
    finally:
        for kname, (module, fn) in tree.items():
            module._fns[kname] = fn


def _time_parent_wide(state, dtype, q, k, v, do, op, args,
                      windowed=None) -> dict:
    """The parent's kernels of REDESIGNED[dtype] at head_dim 256 in turns
    with the redesigned ones (parent, tree, tree, parent), replay with the
    window, where phase 1 built the parent's (``_start_parent_build``); the
    figures of PROBE_IN_TURNS otherwise. Given the plain version's outputs
    of that case (``windowed``: O, dq, dk, dv), the shares of the parent's
    bf16 outputs that differ from them are printed too. Returns kind ->
    the parent's mean ms."""
    kernels = REDESIGNED.get(dtype, ())
    libs = state.get("parent_wide")
    if not libs:
        for kind, lib in kernels:
            theirs, mine = PROBE_IN_TURNS[kind]
            log(f"[kernels] {lib} D=256: no parent at hand; in turns in "
                f"this script's run with the parent: parent {theirs} ms, "
                f"redesigned {mine} ms ({theirs / mine:.3f}x)")
        return {}
    entries = {kind: parent_kernel(kind, dtype, libs[lib])
               for kind, lib in kernels}
    kw = dict(args, mode="replay")
    out = {}
    for kind, lib in kernels:
        theirs, mine = in_turns(kind, *entries[kind], q, k, v, do, op, kw)
        log(f"[kernels] {lib} D=256 replay window={args['local_window']}: "
            f"in turns (parent, tree, tree, parent) {theirs[0]:.4f}, "
            f"{mine[0]:.4f}, {mine[1]:.4f}, {theirs[1]:.4f} ms: the "
            f"redesigned kernel {sum(theirs) / sum(mine):.3f}x the parent's "
            f"| {state['smi']}")
        out[kind] = sum(theirs) / len(theirs)
    if windowed is not None and entries:
        got = flash_outputs(q, k, v, do, op, kw, entries.values())
        log(f"[kernels] the parent's bf16 D=256 kernels, replay window="
            f"{args['local_window']}: " + differing_shares(got, windowed))
    return out


# the fp8 host at the four host GEMMs of a llama2-7b block at B=2, S=2048,
# each with the training plane; "gate_up" hosts the ffn_up main path
FP8_SHAPES = (("qkv", QKV_SHAPE), ("out_proj", (4096, 4096, 4096)),
              ("gate_up", (4096, 22016, 4096)),
              ("down", (4096, 4096, 11008)))
FP8_MAIN = "gate_up"
# scale-tile shapes: a 192-row logical block (taller than the kernel's
# 128-row CTA tile, so its scale rows cut across CTAs), bk = 344 (K =
# 11008 = 32 x 344) and K = bk = 344, not a multiple of 16 (rows
# zero-padded to the tensor maps' 16-byte stride): (m, k, n), (bm, bn,
# bk), plane, mask columns
FP8_SCALE_TILES = (((192, 64, 256), (192, 256, 64), (1, 2, 64, 128), 128),
                   ((64, 11008, 64), (64, 64, 344), (1, 1, 32, 64), 64),
                   ((256, 344, 512), (256, 256, 344), (1, 2, 64, 128), 128))


def gemm_rng_fp8_bound(m, n, k, blocks, mask_words, rounds, ops_rate,
                       groups=1, c_bytes=4):
    """(bound_ms, bound_by) of ``groups`` products: e4m3 operands, f32
    scales, the results (``c_bytes`` an element: f32, or 2 for bf16) and
    the plane each read / written once against HBM; the products at the
    dense e4m3 tensor-core rate plus the plane's Philox instructions at the
    issue rate."""
    bm, bn, bk = blocks
    scales = groups * ((m // bm) * (k // bk) + (k // bk) * (n // bn))
    t_bytes = (groups * (m * k + k * n + c_bytes * m * n)
               + 4 * (scales + mask_words)) / HBM_BYTES_PER_S
    t_ops = (2 * groups * m * n * k / FP8_FLOPS_PER_S
             + mask_words * philox_word_ops(rounds) / ops_rate)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _fp8_call(m, n, k, blocks, plane, cols, gen):
    """Random operands, their quantization (JAX's layout) and the emission
    of one fp8 host call: (a, w, (a_q, a_s, w_q, w_s), emission, keyword
    args)."""
    from repro_torch.kernels import quant
    mb, mh, sq, sk = plane
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk, p=0.1,
              seed=torch.tensor(77), salt=5, block_m=blocks[0],
              block_n=blocks[1], block_k=blocks[2], mask_block_cols=cols)
    a = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    _, em = gemm_rng._emission(
        a, w, mb, mh, sq, sk, kw["p"], kw["seed"], kw["salt"], 7, *blocks,
        cols, 256, 0, 0)
    ops = (*quant.quantize_tiled(a, blocks[0], blocks[2]),
           *quant.quantize_tiled(w, blocks[2], blocks[1]))
    return a, w, ops, em, kw


def _check_fp8(label, a, w, ops, em, kw, blocks, state, plane=None):
    """The kernel against its plain version on the same e4m3 operands: C
    within GEMM_TOL, the plane bitwise (against ``plane`` when given, the
    plain version's otherwise), and C under 0.06 Frobenius-relative of the
    f32 product. Returns (C max abs err, relative error, plane)."""
    from repro_torch.kernels import quant
    c, mask = gemm_rng.gemm_with_rng_fp8(a, w, **kw)
    want_c = gemm_rng.gemm_fp8_plain(*ops, blocks)
    if plane is None:
        plane = gemm_rng._plain_plane(em, "cuda").reshape(mask.shape)
    torch.cuda.synchronize()
    if not torch.equal(mask, plane):
        raise AssertionError(f"gemm_rng_fp8 {label}: plane != plain")
    err = _close(f"gemm_rng_fp8 {label} C", c, want_c, GEMM_TOL, state,
                 "gemm_rng_fp8")
    ref = a @ w
    rel = float((c - ref).norm() / ref.norm())
    if not rel < quant.quantize_error_bound():
        raise AssertionError(f"gemm_rng_fp8 {label}: {rel} of f32")
    return err, rel, plane


def phase_kernels_fp8(state) -> None:
    """The e4m3 GEMM+RNG kernel (and its emission-off variant) against its
    plain version, then timed at the host shapes of the training path."""
    from repro_torch.core.producer import pick_gemm_blocks
    from repro_torch.kernels import quant
    gen = torch.Generator(device="cuda").manual_seed(1)
    ops_rate = issue_ops_per_s()
    mb, mh, sq = QKV_MASK
    plane_shape = (mb, mh, sq, sq)
    words = mb * mh * (sq // 32) * sq
    fp8_key = gemm_rng.KERNEL_FP8
    rows, plane = {}, None
    for label, (m, n, k) in FP8_SHAPES:
        blocks = pick_gemm_blocks(m, n, k)
        a, w, ops, em, kw = _fp8_call(m, n, k, blocks, plane_shape, 2048,
                                      gen)
        if plane is None:
            # the f32 host (kernel 2) emits the same plane
            _, plane32 = gemm_rng.gemm_with_rng(a, w, **kw)
            err, rel, plane = _check_fp8(label, a, w, ops, em, kw, blocks,
                                         state)
            if not torch.equal(plane, plane32):
                raise AssertionError("fp8 plane != the f32 host's plane")
            del plane32
        else:
            err, rel, _ = _check_fp8(label, a, w, ops, em, kw, blocks,
                                     state, plane)
        # the kernel on the K-major operands it takes: JAX's weight bytes
        # and scales transposed, bitwise what quantizing the transposed
        # weight gives
        kmajor = (ops[0], ops[1], ops[2].T.contiguous(), ops[3].T.contiguous())
        bt_q, bt_s = quant.quantize_tiled(w.T, blocks[1], blocks[2])
        if not (torch.equal(bt_q.view(torch.uint8),
                            ops[2].T.view(torch.uint8))
                and torch.equal(bt_s, ops[3].T)):
            raise AssertionError(f"gemm_rng_fp8 {label}: quantize_tiled(b.T)"
                                 f" is not b_q.T, b_s.T")
        del bt_q, bt_s
        launch = lambda: gemm_rng.gemm_rng_fp8_kmajor(  # noqa: E731
            *kmajor, blocks, em)
        launch_off = lambda: gemm_rng.gemm_rng_fp8_kmajor(  # noqa: E731
            *kmajor, blocks, None)
        runs = {"rng": [], "plain": []}
        for variant in ("rng", "plain", "plain", "rng"):   # in turns
            runs[variant].append(cuda_time_ms(
                launch if variant == "rng" else launch_off, 5))
        ms, off_ms = (float(np.mean(runs[v])) for v in ("rng", "plain"))
        # the wrapper on JAX's (K, N) operands: the bytes transposed first
        wrapper_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_rng_fp8_quantized(*ops, blocks, em), 3)
        plain_ms = cuda_time_ms(
            lambda: gemm_rng._plain_fp8(*ops, blocks, em), 1, warmup=1)
        plain_gemm_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_fp8_plain(*ops, blocks), 1, warmup=1)
        a_d = quant.dequantize_tiled(ops[0], ops[1], blocks[0], blocks[2])
        w_d = quant.dequantize_tiled(ops[2], ops[3], blocks[2], blocks[1])
        dequant_ms = cuda_time_ms(lambda: a_d @ w_d, 5)
        # per-tensor scales on the same e4m3 bytes: another function
        one = torch.ones((), device="cuda")
        w_cm = ops[2].t().contiguous().t()
        scaled_ms = cuda_time_ms(lambda: torch._scaled_mm(
            ops[0], w_cm, scale_a=one, scale_b=one,
            out_dtype=torch.float32), 5)
        bound_ms, bound_by = gemm_rng_fp8_bound(m, n, k, blocks, words, 7,
                                                ops_rate)
        off_bound, off_by = gemm_rng_fp8_bound(m, n, k, blocks, 0, 7,
                                               ops_rate)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None,
                           scaled_mm_ms=scaled_ms,
                           dequant_matmul_ms=dequant_ms,
                           emission_off_ms=off_ms, wrapper_ms=wrapper_ms,
                           plain_variant_ms=off_ms,
                           plain_variant_bound_ms=off_bound,
                           plain_variant_bound_by=off_by,
                           plain_variant_plain_ms=plain_gemm_ms,
                           shape=[m, n, k], blocks=list(blocks))
        flops = 2 * m * n * k
        log(f"[kernels] gemm_rng_fp8 {label} {m}x{n}x{k} blocks {blocks} + "
            f"plane {mb}x{mh}x{sq // 32}x{sq}: plane == plain and == the "
            f"f32 host's bitwise, C max abs err {err:.3g} (tol {GEMM_TOL} x "
            f"(1+|C|)), {rel:.4f} of f32 (bound "
            f"{quant.quantize_error_bound()}); "
            f"{ms:.4f} ms a launch (CUDA events, in turns {runs['rng']}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s; emission off "
            f"{off_ms:.4f} ms (in turns {runs['plain']}, "
            f"{flops / off_ms / 1e9:.1f} TFLOP/s), the plane "
            f"{(ms - off_ms) / off_ms * 100:+.2f}% of the product; wrapper "
            f"on (K, N) operands {wrapper_ms:.4f} ms; plain version "
            f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
            f"(f16 tensor-core rate: {flops / F16_FLOPS_PER_S * 1e3:.4f} "
            f"ms), kernel at {bound_ms / ms * 100:.2f}% of bound; no "
            f"PyTorch call computes per-tile-scaled e4m3; torch._scaled_mm "
            f"(per-tensor scales) {scaled_ms:.4f} ms, torch.matmul f32 on "
            f"the dequantized operands {dequant_ms:.4f} ms (kernel faster: "
            f"{ms < dequant_ms}) | {state['smi']}")
        del a, w, ops, kmajor, a_d, w_d, w_cm
        gc.collect()
        torch.cuda.empty_cache()
    for (m, k, n), blocks, shape, cols in FP8_SCALE_TILES:
        a, w, ops, em, kw = _fp8_call(m, n, k, blocks, shape, cols, gen)
        err, rel, _ = _check_fp8(f"{m}x{n}x{k}", a, w, ops, em, kw, blocks,
                                 state)
        log(f"[kernels] gemm_rng_fp8 scale tiles {blocks} on {m}x{n}x{k}: "
            f"plane == plain bitwise, C max abs err {err:.3g}, {rel:.4f} "
            "of f32")
    # Region 3: a one-tile grid cannot host 4096 packed rows, so the
    # emission is off
    m3, n3, k3, (b3, h3, s3) = REGION3
    a, w, ops, em, kw = _fp8_call(m3, n3, k3, (256, 256, 64),
                                  (b3, h3, s3, s3), 256, gen)
    before = gemm_rng.variant_counts(fp8_key)["plain"]
    c3, none = gemm_rng.gemm_with_rng_fp8(a, w, **kw)
    if em is not None or none is not None or \
            gemm_rng.variant_counts(fp8_key)["plain"] != before + 1:
        raise AssertionError("the Region-3 fp8 call emitted a plane")
    err3 = _close("gemm_rng_fp8 Region 3", c3,
                  gemm_rng.gemm_fp8_plain(*ops, (256, 256, 64)), GEMM_TOL,
                  state, "gemm_rng_fp8")
    log(f"[kernels] gemm_rng_fp8 Region 3 {m3}x{n3}x{k3}: plane None, "
        f"emission-off launch counted, C max abs err {err3:.3g}")
    state.setdefault("timing", {})[fp8_key] = dict(rows[FP8_MAIN],
                                                   rows=rows)


# the grouped hosts: moonshot-v1-16b-a3b's expert gate and down einsums at
# B=2, S=2048 (64 experts, capacity 480) with its (2, 16, 2048) plane, and
# rwkv6-7b's channel-mix key GEMM (E=1, 4096 tokens x 4096 x 14336) with
# the (2, 32, 2048) plane of phase 2's dense host; "gate" hosts the
# ffn_up main path of phase 7
GROUPED_SHAPES = (("gate", (64, 480, 2048, 1408), (2, 16, 2048)),
                  ("down", (64, 480, 1408, 2048), (2, 16, 2048)),
                  ("channel_mix", (1, 4096, 4096, 14336), QKV_MASK))
GROUPED_MAIN = "gate"
# a Region-3 grouped grid: 2 expert tiles cannot host 1 x 32 x 1024 x 1024
GROUPED_REGION3 = ((2, 128, 64, 8), (128, 8, 64), (1, 32, 1024))
# K = bk = 344, not a multiple of 16: the e4m3 kernel's rows zero-padded
GROUPED_K344 = ((4, 480, 344, 256), (240, 256, 344), (1, 2, 64))


def _grouped_kw(blocks, plane):
    mb, mh, sq = plane
    return dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sq, p=0.1,
                seed=torch.tensor(77), salt=5, block_m=blocks[0],
                block_n=blocks[1], block_k=blocks[2])


def _dense_plane(plane, gen):
    """The f32 dense host's (kernel 2) plane for the same counters, under a
    1024 x 256 x 1024 product whose 16-tile grid hosts it."""
    a = torch.randn((1024, 256), generator=gen, device="cuda")
    w = torch.randn((256, 1024), generator=gen, device="cuda")
    _, mask = gemm_rng.gemm_with_rng(a, w, **_grouped_kw((256, 256, 256),
                                                          plane))
    return mask


def phase_kernels_grouped(state) -> None:
    """The grouped GEMM+RNG kernels -- f32 (TPU kernel 9), its emission-off
    variant (10) and e4m3 (11) -- against their plain versions at the
    grouped host shapes, then timed there."""
    from repro_torch.core.producer import pick_gemm_blocks
    from repro_torch.kernels import quant
    gen = torch.Generator(device="cuda").manual_seed(2)
    ops_rate = issue_ops_per_s()
    g32, g8 = gemm_rng.KERNEL_GROUPED, gemm_rng.KERNEL_GROUPED_FP8
    rows = {g32: {}, g8: {}}
    dense_planes = {}
    for label, (e, m, k, n), plane in GROUPED_SHAPES:
        blocks = pick_gemm_blocks(m, n, k)
        kw = _grouped_kw(blocks, plane)
        a = torch.randn((e, m, k), generator=gen, device="cuda")
        w = torch.randn((e, k, n), generator=gen, device="cuda")
        c, mask = gemm_rng.gemm_with_rng_grouped(a, w, **kw)
        c8, mask8 = gemm_rng.gemm_with_rng_grouped_fp8(a, w, **kw)
        want_c, want = gemm_rng.gemm_with_rng_grouped_plain(a, w, **kw)
        ops8 = gemm_rng.quantize_grouped(a, w, blocks)
        want_c8 = gemm_rng.gemm_grouped_fp8_plain(*ops8, blocks)
        # the kernel's K-major weight: JAX's bytes and scales transposed,
        # bitwise what quantizing the transposed weight gives
        kmajor8 = (*ops8[:2], *gemm_rng.kmajor_grouped(*ops8[2:], blocks))
        bm, bn, bk = blocks
        bt_q, bt_s = quant.quantize_tiled(
            w.transpose(1, 2).reshape(e * n, k), bn, bk)
        if not (torch.equal(kmajor8[2].reshape(e * n, k).view(torch.uint8),
                            bt_q.view(torch.uint8))
                and torch.equal(kmajor8[3], bt_s)):
            raise AssertionError(f"{g8} {label}: the K-major weight is not "
                                 f"the quantized transposed weight")
        del bt_q, bt_s
        if plane not in dense_planes:
            dense_planes[plane] = _dense_plane(plane, gen)
        torch.cuda.synchronize()
        if not (torch.equal(mask, want) and torch.equal(mask8, want)
                and torch.equal(mask, dense_planes[plane])):
            raise AssertionError(f"grouped {label}: planes differ (f32 "
                                 f"kernel, e4m3 kernel, plain, dense host)")
        err = _close(f"{g32} {label} C", c, want_c, F32_GEMM_TOL, state,
                     g32)
        _gemm_precision_control(f"{g32} {label}", a, w, c, want_c, state,
                                g32)
        err8 = _close(f"{g8} {label} C", c8, want_c8, GEMM_TOL, state, g8)
        ref = torch.bmm(a, w)
        rel8 = float((c8 - ref).norm() / ref.norm())
        if not rel8 < quant.quantize_error_bound():
            raise AssertionError(f"{g8} {label}: {rel8} of f32")
        bmm_err = float((c - ref).abs().max())
        del c, c8, mask, mask8, want_c, want_c8, want, ref
        # timing: each kernel in turns with its emission-off variant
        _, em = gemm_rng._emission(a, w, plane[0], plane[1], plane[2],
                                   plane[2], 0.1, kw["seed"], kw["salt"], 7,
                                   *blocks, 2048, 256, 0, 0, grouped=True)
        launches = {
            "rng": lambda: gemm_rng.gemm_with_rng_grouped(a, w, **kw),
            "plain": lambda: gemm_rng._forward_grouped(a, w, None),
            "rng8": lambda: gemm_rng.gemm_rng_grouped_fp8_kmajor(
                *kmajor8, blocks, em),
            "off8": lambda: gemm_rng.gemm_rng_grouped_fp8_kmajor(
                *kmajor8, blocks, None)}
        runs = {v: [] for v in launches}
        for v in ("rng", "plain", "plain", "rng", "rng8", "off8", "off8",
                  "rng8"):
            runs[v].append(cuda_time_ms(launches[v], 5 if "8" in v else 3))
        wrapper8_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_rng_grouped_fp8_quantized(*ops8, blocks,
                                                            em), 3)
        ms = {v: float(np.mean(t)) for v, t in runs.items()}
        plain_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_with_rng_grouped_plain(a, w, **kw), 1,
            warmup=1)
        plain_off_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_grouped_plain(a, w), 2, warmup=1)
        plain8_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_with_rng_grouped_fp8_plain(a, w, **kw), 1,
            warmup=1)
        bmm_ms = cuda_time_ms(lambda: torch.bmm(a, w), 5)
        a_d = quant.dequantize_tiled(ops8[0].reshape(e * m, k), ops8[1], bm,
                                     bk).reshape(e, m, k)
        w_d = quant.dequantize_tiled(ops8[2].reshape(e * k, n), ops8[3], bk,
                                     bn).reshape(e, k, n)
        dequant_ms = cuda_time_ms(lambda: torch.bmm(a_d, w_d), 5)
        # per-tensor scales on the same e4m3 bytes, one call an expert:
        # another function
        one = torch.ones((), device="cuda")
        w_cm = [ops8[2][i].t().contiguous().t() for i in range(e)]

        def scaled_mm():
            for i in range(e):
                torch._scaled_mm(ops8[0][i], w_cm[i], scale_a=one,
                                 scale_b=one, out_dtype=torch.float32)

        scaled_ms = cuda_time_ms(scaled_mm, 3)
        words = plane[0] * plane[1] * (plane[2] // 32) * plane[2]
        b32, by32 = gemm_rng_bound(m, n, k, words, 7, ops_rate, groups=e)
        boff, boff_by = gemm_rng_bound(m, n, k, 0, 7, ops_rate, groups=e)
        s32, soff = (gemm_rng_bound(m, n, k, wd, 7, ops_rate, groups=e,
                                    simt=True)[0] for wd in (words, 0))
        b8, by8 = gemm_rng_fp8_bound(m, n, k, blocks, words, 7, ops_rate,
                                     groups=e)
        shape = [e, m, n, k]
        rows[g32][label] = dict(
            ms=ms["rng"], plain_ms=plain_ms, bound_ms=b32, bound_by=by32,
            library_ms=bmm_ms, plain_variant_ms=ms["plain"],
            plain_variant_bound_ms=boff, plain_variant_bound_by=boff_by,
            plain_variant_plain_ms=plain_off_ms,
            shape=shape, blocks=list(blocks))
        rows[g8][label] = dict(
            ms=ms["rng8"], plain_ms=plain8_ms, bound_ms=b8, bound_by=by8,
            library_ms=None, scaled_mm_ms=scaled_ms,
            dequant_matmul_ms=dequant_ms, emission_off_ms=ms["off8"],
            wrapper_ms=wrapper8_ms, shape=shape, blocks=list(blocks))
        flops = 2 * e * m * n * k
        log(f"[kernels] grouped {label} {e}x({m}x{k})x({k}x{n}) blocks "
            f"{blocks} + plane {plane[0]}x{plane[1]}x{plane[2] // 32}x"
            f"{plane[2]}: planes of the f32 and e4m3 kernels == plain == the "
            f"dense host's bitwise; C max abs err {err:.3g} (f32; "
            f"{bmm_err:.3g} from torch.bmm; tol {F32_GEMM_TOL} x (1+|C|)) "
            f"and {err8:.3g} (e4m3; tol {GEMM_TOL} x (1+|C|)) against the "
            f"plain versions, e4m3 "
            f"{rel8:.4f} of f32 (bound {quant.quantize_error_bound()})")
        log(f"[kernels] {g32} {label}: {ms['rng']:.4f} ms a launch (CUDA "
            f"events, in turns {runs['rng']}), {flops / ms['rng'] / 1e9:.1f} "
            f"TFLOP/s; emission-off variant {ms['plain']:.4f} ms (in turns "
            f"{runs['plain']}, bound {boff:.4f} ms, "
            f"{boff / ms['plain'] * 100:.1f}%; {soff:.4f} at the f32 SIMT "
            f"rate); torch.bmm {bmm_ms:.4f} ms (the kernel "
            f"{ms['rng'] / bmm_ms:.3f}x of it); plain version "
            f"{plain_ms:.2f} ms (GEMM only {plain_off_ms:.2f} ms); bound "
            f"{b32:.4f} ms by {by32} at {F32_SPLIT_PRODUCTS} bf16 products "
            f"an f32 product ({s32:.4f} at the f32 SIMT rate), kernel at "
            f"{b32 / ms['rng'] * 100:.1f}% of bound | {state['smi']}")
        log(f"[kernels] {g8} {label}: {ms['rng8']:.4f} ms a launch (in "
            f"turns {runs['rng8']}), {flops / ms['rng8'] / 1e9:.1f} "
            f"TFLOP/s; emission off {ms['off8']:.4f} ms (in turns "
            f"{runs['off8']}, {flops / ms['off8'] / 1e9:.1f} TFLOP/s), the "
            f"plane {(ms['rng8'] - ms['off8']) / ms['off8'] * 100:+.2f}% of "
            f"the product; wrapper on (E, K, N) operands {wrapper8_ms:.4f} "
            f"ms; plain version {plain8_ms:.2f} ms; bound {b8:.4f} ms by "
            f"{by8} (f16 tensor-core rate: "
            f"{flops / F16_FLOPS_PER_S * 1e3:.4f} ms), kernel at "
            f"{b8 / ms['rng8'] * 100:.2f}% of bound; no PyTorch call "
            f"computes per-tile-scaled e4m3; torch._scaled_mm a expert "
            f"(per-tensor scales) {scaled_ms:.4f} ms, torch.bmm f32 on the "
            f"dequantized operands {dequant_ms:.4f} ms (kernel faster: "
            f"{ms['rng8'] < dequant_ms}) | {state['smi']}")
        del a, w, ops8, kmajor8, a_d, w_d, w_cm
        gc.collect()
        torch.cuda.empty_cache()
    # Region 3: both hosts run the f32 grouped kernel with the emission
    # off and return no plane
    (e, m, k, n), blocks, plane = GROUPED_REGION3
    a = torch.randn((e, m, k), generator=gen, device="cuda")
    w = torch.randn((e, k, n), generator=gen, device="cuda")
    kw = _grouped_kw(blocks, plane)
    for fn in (gemm_rng.gemm_with_rng_grouped,
               gemm_rng.gemm_with_rng_grouped_fp8):
        before = {g: gemm_rng.variant_counts(g) for g in (g32, g8)}
        c3, none = fn(a, w, **kw)
        after = {g: gemm_rng.variant_counts(g) for g in (g32, g8)}
        if none is not None or after[g32]["plain"] != \
                before[g32]["plain"] + 1 or after[g8] != before[g8]:
            raise AssertionError(f"{fn.__name__} Region 3 did not run the "
                                 f"emission-off f32 grouped kernel alone")
        err3 = _close(f"{fn.__name__} Region 3", c3,
                      gemm_rng.gemm_grouped_plain(a, w), F32_GEMM_TOL,
                      state, g32)
        log(f"[kernels] {fn.__name__} Region 3 {e}x({m}x{k})x({k}x{n}) "
            f"with a {plane[0]}x{plane[1]}x{plane[2]} plane: no plane, the "
            f"f32 grouped kernel with the emission off, C max abs err "
            f"{err3:.3g}")
    (e, m, k, n), blocks, plane = GROUPED_K344
    a = torch.randn((e, m, k), generator=gen, device="cuda")
    w = torch.randn((e, k, n), generator=gen, device="cuda")
    kw = _grouped_kw(blocks, plane)
    c8, mask8 = gemm_rng.gemm_with_rng_grouped_fp8(a, w, **kw)
    want_c8, want8 = gemm_rng.gemm_with_rng_grouped_fp8_plain(a, w, **kw)
    c, mask = gemm_rng.gemm_with_rng_grouped(a, w, **kw)
    want_c, want = gemm_rng.gemm_with_rng_grouped_plain(a, w, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(mask8, want8) and torch.equal(mask, want8)
            and torch.equal(want, want8)):
        raise AssertionError(f"{g8}, {g32} K={k}: plane != plain")
    err8 = _close(f"{g8} K={k} C", c8, want_c8, GEMM_TOL, state, g8)
    err = _close(f"{g32} K={k} C", c, want_c, F32_GEMM_TOL, state, g32)
    _gemm_precision_control(f"{g32} K={k}", a, w, c, want_c, state, g32)
    log(f"[kernels] {g8} {e}x({m}x{k})x({k}x{n}) blocks {blocks}, K not a "
        f"multiple of 16 (rows padded to {-(-k // 16) * 16} bytes): plane "
        f"== plain bitwise, C max abs err {err8:.3g} (tol {GEMM_TOL} x "
        f"(1+|C|)); {g32} there (K not a multiple of its 32-k stage: the "
        f"tensor maps' zeros past K): plane == plain bitwise, C max abs err "
        f"{err:.3g} (tol {F32_GEMM_TOL} x (1+|C|))")
    timing = state.setdefault("timing", {})
    for name in (g32, g8):
        timing[name] = dict(rows[name][GROUPED_MAIN], rows=rows[name])


# the bf16 host at the four host GEMMs of a llama2-7b block at B=2, S=2048
# (the fp8 phase's shapes), each with the training plane; "qkv" hosts the
# qkv/bf16 main path
BF16_SHAPES = FP8_SHAPES
BF16_MAIN = "qkv"
# ragged bf16 host calls, dense and grouped: M not a multiple of the
# 128-row tile (an odd count of tile rows, so the last cluster's second CTA
# has none), N not one of the 256-column tile, K not one of the 64-k
# stage, and an odd tile count (253, 135) that is no multiple of 132, so
# the persistent grid of clusters wraps unevenly; each with a plane whose
# rows (SK = 200) end inside a 32-word unit: (E or None, M, K, N), logical
# blocks, plane (B, H, SQ)
BF16_RAGGED = (((None, 2904, 1000, 2776), (264, 2776, 1000), (1, 3, 96)),
               ((9, 300, 520, 1144), (150, 1144, 520), (1, 3, 96)))
BF16_RAGGED_SK = 200


def gemm_rng_bf16_bound(m, n, k, mask_words, rounds, ops_rate, groups=1):
    """(bound_ms, bound_by) of ``groups`` bf16 products and one plane: bf16
    operands and results (2 bytes an element) and the plane read / written
    once against HBM; the products at the dense bf16 tensor-core rate and
    the plane's Philox instructions at the issue rate, which run side by
    side (the larger time)."""
    t_bytes = (2 * groups * (m * k + k * n + m * n) + 4 * mask_words) \
        / HBM_BYTES_PER_S
    t_ops = max(2 * groups * m * n * k / BF16_FLOPS_PER_S,
                mask_words * philox_word_ops(rounds) / ops_rate)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sequential_yardstick(a, w, em, plane):
    """The paper's sequential implementation of one bf16 host call: the
    product by one PyTorch call (``torch.matmul``, ``torch.bmm`` for 3-d
    operands), then the standalone Philox kernel (``philox_mask.cu``) for
    the same plane, on the same stream. ``plane`` is (B, H, SQ); returns
    (the callable, the plane it fills)."""
    mb, mh, sq = plane
    out = torch.empty((mb, mh, sq // 32, em.layout.sk), dtype=torch.int32,
                      device=a.device)
    product = torch.bmm if a.dim() == 3 else torch.matmul

    def run():
        product(a, w)
        philox.philox_mask_into(
            out, key_lo=em.key_lo, key_hi=em.key_hi, salt=em.salt,
            threshold=em.threshold, rounds=em.rounds,
            heads_global=em.heads_global, bh_offset=em.bh_offset)
    return run, out


def _bf16_ragged(state, rnd, grouped: bool) -> None:
    """The ragged bf16 host call (BF16_RAGGED, dense or grouped): the plane
    bitwise the plain one and the f32 host's, C within BF16_GEMM_TOL of the
    plain version, emission on and off. Where a persistent walk drops or
    repeats a tile (one CTA takes two tiles here, another one), C fails."""
    (e, m, k, n), blocks, (mb, mh, sq) = BF16_RAGGED[int(grouped)]
    key = gemm_rng.KERNEL_GROUPED_BF16 if grouped else gemm_rng.KERNEL_BF16
    lead = (e,) if grouped else ()
    a, w = rnd(*lead, m, k), rnd(*lead, k, n)
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq,
              mask_sk=BF16_RAGGED_SK, p=0.1, seed=torch.tensor(77), salt=5,
              block_m=blocks[0], block_n=blocks[1], block_k=blocks[2])
    fn, plain = ((gemm_rng.gemm_with_rng_grouped,
                  gemm_rng.gemm_with_rng_grouped_plain) if grouped else
                 (gemm_rng.gemm_with_rng, gemm_rng.gemm_with_rng_plain))
    c, mask = fn(a, w, **kw)
    _, mask32 = fn(a.float(), w.float(), **kw)
    want_c, want = plain(a, w, **kw)
    c_off, none = (gemm_rng._forward_grouped if grouped else
                   gemm_rng._forward)(a, w, None)
    torch.cuda.synchronize()
    if none is not None or not (torch.equal(mask, want)
                                and torch.equal(mask, mask32)):
        raise AssertionError(f"{key} ragged: plane != plain / the f32 "
                             f"host's")
    err = _close(f"{key} ragged C", c.float(), want_c.float(),
                 BF16_GEMM_TOL, state, key)
    err_off = _close(f"{key} ragged emission off C", c_off.float(),
                     want_c.float(), BF16_GEMM_TOL, state, key)
    tiles = (e or 1) * -(-m // 128) * -(-n // 256)
    clusters = build.load(
        gemm_rng.KERNEL_BF16).repro_gemm_rng_bf16_clusters()
    log(f"[kernels] {key} ragged {'x'.join(map(str, (*lead, m, k)))} @ "
        f"{'x'.join(map(str, (*lead, k, n)))}: {tiles} tiles of 128x256 on "
        f"a persistent grid of at most {clusters} clusters of two CTAs, "
        f"plane "
        f"{mb}x{mh}x{sq // 32}x{BF16_RAGGED_SK} == plain and == the f32 "
        f"host's bitwise; C max abs err {err:.3g}, emission off "
        f"{err_off:.3g} (tol {BF16_GEMM_TOL} x (1+|C|))")


def phase_kernels_bf16(state) -> None:
    """The bf16 GEMM+RNG kernel (emission on and off) and the bf16 flash
    kernels against their plain versions at the training path's shapes,
    then timed there beside their bounds and the library calls."""
    from repro_torch.core.producer import pick_gemm_blocks
    from repro_torch.kernels.ref import gemm_ref
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s: torch.randn(  # noqa: E731
        s, generator=gen, device="cuda").to(bf16)
    ops_rate = issue_ops_per_s()
    mb, mh, sq = QKV_MASK
    words = mb * mh * (sq // 32) * sq
    key = gemm_rng.KERNEL_BF16
    timing = state.setdefault("timing", {})
    rows, plane32 = {}, None
    for label, (m, n, k) in BF16_SHAPES:
        blocks = pick_gemm_blocks(m, n, k)
        kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sq,
                  p=0.1, seed=torch.tensor(77), salt=5, block_m=blocks[0],
                  block_n=blocks[1], block_k=blocks[2])
        a, w = rnd(m, k), rnd(k, n)
        c, mask = gemm_rng.gemm_with_rng(a, w, **kw)
        want_c, want = gemm_rng.gemm_with_rng_plain(a, w, **kw)
        if plane32 is None:
            # the f32 host (kernel 2) on the same values emits the same plane
            _, plane32 = gemm_rng.gemm_with_rng(a.float(), w.float(), **kw)
        torch.cuda.synchronize()
        if not (torch.equal(mask, want) and torch.equal(mask, plane32)):
            raise AssertionError(f"{key} {label}: plane != plain / the f32 "
                                 f"host's")
        if c.dtype != bf16:
            raise AssertionError(f"{key} {label}: C is {c.dtype}")
        err = _close(f"{key} {label} C", c.float(), want_c.float(),
                     BF16_GEMM_TOL, state, key)
        del c, mask, want, want_c
        launch = lambda: gemm_rng.gemm_with_rng(a, w, **kw)  # noqa: E731
        # the Region-3 variant at the same product: a one-tile logical grid
        # cannot host the plane, so the emission is off
        launch_off = lambda: gemm_rng.gemm_with_rng(  # noqa: E731
            a, w, **dict(kw, block_m=m, block_n=n))
        before = gemm_rng.variant_counts(key)["plain"]
        if launch_off()[1] is not None or \
                gemm_rng.variant_counts(key)["plain"] != before + 1:
            raise AssertionError(f"{key}: the emission-off call emitted")
        # the sequential yardstick: torch.matmul, then the Philox kernel
        _, em = gemm_rng._emission(a, w, mb, mh, sq, sq, 0.1, kw["seed"],
                                   kw["salt"], 7, *blocks, 2048, 256, 0, 0)
        seq, seq_plane = sequential_yardstick(a, w, em, QKV_MASK)
        fns = {"rng": launch, "plain": launch_off, "seq": seq}
        runs = {v: [] for v in fns}
        for variant in ("rng", "plain", "seq", "seq", "plain", "rng"):
            runs[variant].append(cuda_time_ms(fns[variant], 10))  # in turns
        ms, off_ms, seq_ms = (float(np.mean(runs[v]))
                              for v in ("rng", "plain", "seq"))
        if not torch.equal(seq_plane, plane32):
            raise AssertionError(f"{key} {label}: the Philox kernel's plane "
                                 f"!= the hosts'")
        del seq, seq_plane
        plain_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_with_rng_plain(a, w, **kw), 2, warmup=1)
        plain_gemm_ms = cuda_time_ms(lambda: gemm_ref(a, w), 2, warmup=1)
        lib_ms = cuda_time_ms(lambda: a @ w, 10)
        bound_ms, bound_by = gemm_rng_bf16_bound(m, n, k, words, 7,
                                                 ops_rate)
        off_bound, off_by = gemm_rng_bf16_bound(m, n, k, 0, 7, ops_rate)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib_ms,
                           emission_off_ms=off_ms, plain_variant_ms=off_ms,
                           plain_variant_bound_ms=off_bound,
                           plain_variant_bound_by=off_by,
                           plain_variant_plain_ms=plain_gemm_ms,
                           sequential_ms=seq_ms, shape=[m, n, k])
        flops = 2 * m * n * k
        log(f"[kernels] {key} {label} {m}x{n}x{k} + plane {mb}x{mh}x"
            f"{sq // 32}x{sq}: plane == plain and == the f32 host's "
            f"bitwise, C (bf16) max abs err {err:.3g} (tol {BF16_GEMM_TOL} x "
            f"(1+|C|)); {ms:.4f} ms a launch (CUDA events, in turns "
            f"{runs['rng']}), {flops / ms / 1e9:.1f} TFLOP/s; emission off "
            f"{off_ms:.4f} ms (in turns {runs['plain']}, "
            f"{flops / off_ms / 1e9:.1f} TFLOP/s), the plane "
            f"{(ms - off_ms) / off_ms * 100:+.2f}% of the product; "
            f"torch.matmul bf16 {lib_ms:.4f} ms; the sequential yardstick "
            f"(torch.matmul, then the Philox kernel) {seq_ms:.4f} ms (in "
            f"turns {runs['seq']}; kernel / yardstick {ms / seq_ms:.3f}); "
            f"plain version "
            f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
            f"(emission off {off_bound:.4f}), kernel at "
            f"{bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
        del a, w
        gc.collect()
        torch.cuda.empty_cache()
    del plane32
    _bf16_ragged(state, rnd, grouped=False)
    # Region 3 at a small shape: no plane, the emission-off variant
    m3, n3, k3, (b3, h3, s3) = REGION3
    a3, w3 = rnd(m3, k3), rnd(k3, n3)
    kw3 = dict(mask_batch=b3, mask_heads=h3, mask_sq=s3, mask_sk=s3, p=0.1,
               seed=1, block_m=256, block_n=256, block_k=64)
    before = gemm_rng.variant_counts(key)["plain"]
    c3, none = gemm_rng.gemm_with_rng(a3, w3, **kw3)
    if none is not None or gemm_rng.variant_counts(key)["plain"] != \
            before + 1:
        raise AssertionError(f"{key}: the Region-3 call emitted a plane")
    err3 = _close(f"{key} Region 3", c3.float(),
                  gemm_rng.gemm_with_rng_plain(a3, w3, **kw3)[0].float(),
                  BF16_GEMM_TOL, state, key)
    log(f"[kernels] {key} Region 3 {m3}x{n3}x{k3}: plane None, emission-off "
        f"launch counted, C max abs err {err3:.3g}")
    timing[key] = dict(rows[BF16_MAIN], rows=rows)

    # ---- flash forward, dq, dkv at bf16
    _flash_kernels(state, rnd, bf16, ops_rate)
    _flash_kernels_wide(state, rnd, ops_rate, bf16)


# the e4m3 kernels on bf16 operands (bf16 C): the dense host at llama2's
# gate+up and the grouped host at moonshot's expert gate, each with the
# plane of its main path (phase 8's and phase 9's fp8 steps)
FP8_BF16_DENSE = ("gate_up", (4096, 22016, 4096), QKV_MASK)
FP8_BF16_GROUPED = ("gate", (64, 480, 2048, 1408), (2, 16, 2048))


def _shift_expert_rows(c: torch.Tensor) -> torch.Tensor:
    """The planted fault of the grouped bf16 checks: one expert's C rows
    moved down by one row (expert 1; expert 0 when E = 1), as a C store or
    an A load one row off an expert's start would give."""
    bad = c.clone()
    i = min(1, c.shape[0] - 1)
    bad[i] = c[i].roll(1, dims=0)
    return bad


def _fp8_bf16_check(label, name, c16, c32, want16, mask, want, state):
    """An e4m3 kernel on bf16 operands: bf16 C, the plane bitwise the plain
    one; C within BF16_GEMM_TOL of the plain version and bitwise the f32
    instance's C (the same f32 sums on the same e4m3 operands, exactly
    upcast from bf16) rounded once to bf16. Returns the max abs error."""
    if c16.dtype != torch.bfloat16:
        raise AssertionError(f"{name} {label}: C is {c16.dtype}")
    if not torch.equal(mask, want):
        raise AssertionError(f"{name} {label}: plane != plain")
    if not torch.equal(c16, c32.to(torch.bfloat16)):
        raise AssertionError(f"{name} {label}: C is not the f32 instance's "
                             f"C rounded once")
    return _close(f"{name} {label} C", c16.float(), want16.float(),
                  BF16_GEMM_TOL, state, name)


def phase_kernels_grouped_bf16(state) -> None:
    """The grouped bf16 GEMM+RNG kernel (TPU kernels 9 and 10 at bf16,
    emission on and off) at the grouped host shapes, with a Region-3 call
    and a planted fault its check must fail, and the e4m3 kernels on bf16
    operands (TPU kernels 7, 8 and 11 writing bf16 C), against their plain
    versions, then timed beside their bounds, torch.bmm and the plain
    versions."""
    from repro_torch.core.producer import pick_gemm_blocks
    from repro_torch.kernels import quant
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda *s: torch.randn(  # noqa: E731
        s, generator=gen, device="cuda").to(bf16)
    ops_rate = issue_ops_per_s()
    key = gemm_rng.KERNEL_GROUPED_BF16
    timing = state.setdefault("timing", {})
    rows = {}
    for label, (e, m, k, n), plane in GROUPED_SHAPES:
        blocks = pick_gemm_blocks(m, n, k)
        kw = _grouped_kw(blocks, plane)
        a, w = rnd(e, m, k), rnd(e, k, n)
        c, mask = gemm_rng.gemm_with_rng_grouped(a, w, **kw)
        want_c, want = gemm_rng.gemm_with_rng_grouped_plain(a, w, **kw)
        _, mask32 = gemm_rng.gemm_with_rng_grouped(a.float(), w.float(),
                                                   **kw)
        torch.cuda.synchronize()
        if not (torch.equal(mask, want) and torch.equal(mask, mask32)):
            raise AssertionError(f"{key} {label}: plane != plain / the f32 "
                                 f"grouped host's")
        if c.dtype != bf16:
            raise AssertionError(f"{key} {label}: C is {c.dtype}")
        err = _close(f"{key} {label} C", c.float(), want_c.float(),
                     BF16_GEMM_TOL, state, key)
        _, fault, fault_ok = _within(_shift_expert_rows(c).float(),
                                     want_c.float(), BF16_GEMM_TOL)
        if fault_ok:
            raise AssertionError(f"{key} {label}: the planted fault (one "
                                 f"expert's rows shifted) passed the check")
        plane_want = want
        del c, mask, mask32, want, want_c
        launch = lambda: gemm_rng.gemm_with_rng_grouped(  # noqa: E731
            a, w, **kw)
        launch_off = lambda: gemm_rng._forward_grouped(  # noqa: E731
            a, w, None)
        before = gemm_rng.variant_counts(key)["plain"]
        c_off, none = launch_off()
        if none is not None or \
                gemm_rng.variant_counts(key)["plain"] != before + 1:
            raise AssertionError(f"{key}: the emission-off call emitted")
        err_off = _close(f"{key} {label} emission off C", c_off.float(),
                         gemm_rng.gemm_grouped_plain(a, w).float(),
                         BF16_GEMM_TOL, state, key)
        del c_off
        # the sequential yardstick: torch.bmm, then the Philox kernel
        _, em = gemm_rng._emission(a, w, *plane, plane[2], 0.1, kw["seed"],
                                   kw["salt"], 7, *blocks, 2048, 256, 0, 0,
                                   grouped=True)
        seq, seq_plane = sequential_yardstick(a, w, em, plane)
        fns = {"rng": launch, "plain": launch_off, "seq": seq}
        runs = {v: [] for v in fns}
        for variant in ("rng", "plain", "seq", "seq", "plain", "rng"):
            runs[variant].append(cuda_time_ms(fns[variant], 10))  # in turns
        ms, off_ms, seq_ms = (float(np.mean(runs[v]))
                              for v in ("rng", "plain", "seq"))
        if not torch.equal(seq_plane.reshape(-1), plane_want.reshape(-1)):
            raise AssertionError(f"{key} {label}: the Philox kernel's plane "
                                 f"!= the host's")
        del seq, seq_plane, plane_want
        plain_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_with_rng_grouped_plain(a, w, **kw), 1,
            warmup=1)
        plain_off_ms = cuda_time_ms(
            lambda: gemm_rng.gemm_grouped_plain(a, w), 2, warmup=1)
        bmm_ms = cuda_time_ms(lambda: torch.bmm(a, w), 10)
        words = plane[0] * plane[1] * (plane[2] // 32) * plane[2]
        bound_ms, bound_by = gemm_rng_bf16_bound(m, n, k, words, 7,
                                                 ops_rate, groups=e)
        off_bound, off_by = gemm_rng_bf16_bound(m, n, k, 0, 7, ops_rate,
                                                groups=e)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=bmm_ms,
                           emission_off_ms=off_ms, plain_variant_ms=off_ms,
                           plain_variant_bound_ms=off_bound,
                           plain_variant_bound_by=off_by,
                           plain_variant_plain_ms=plain_off_ms,
                           sequential_ms=seq_ms, shape=[e, m, n, k],
                           blocks=list(blocks))
        flops = 2 * e * m * n * k
        log(f"[kernels] {key} {label} {e}x({m}x{k})x({k}x{n}) blocks "
            f"{blocks} + plane {plane[0]}x{plane[1]}x{plane[2] // 32}x"
            f"{plane[2]}: plane == plain and == the f32 grouped host's "
            f"bitwise, C (bf16) max abs err {err:.3g} (emission off "
            f"{err_off:.3g}; tol {BF16_GEMM_TOL} x (1+|C|)); the planted "
            f"fault (one expert's rows shifted by one) reads {fault:.3g}x "
            f"the limit and fails; {ms:.4f} ms a launch (CUDA events, in "
            f"turns {runs['rng']}), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"emission off {off_ms:.4f} ms (in turns {runs['plain']}, "
            f"{flops / off_ms / 1e9:.1f} TFLOP/s), the plane "
            f"{(ms - off_ms) / off_ms * 100:+.2f}% of the product; "
            f"torch.bmm bf16 {bmm_ms:.4f} ms; the sequential yardstick "
            f"(torch.bmm, then the Philox kernel) {seq_ms:.4f} ms (in turns "
            f"{runs['seq']}; kernel / yardstick {ms / seq_ms:.3f}); plain "
            f"version {plain_ms:.2f} "
            f"ms (GEMM only {plain_off_ms:.2f}); bound {bound_ms:.4f} ms by "
            f"{bound_by} (emission off {off_bound:.4f}), kernel at "
            f"{bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
        del a, w
        gc.collect()
        torch.cuda.empty_cache()
    _bf16_ragged(state, rnd, grouped=True)
    # Region 3: both grouped hosts run the bf16 grouped kernel with the
    # emission off (the fp8 host unquantized, as JAX's) and return no plane
    (e, m, k, n), blocks, plane = GROUPED_REGION3
    a, w = rnd(e, m, k), rnd(e, k, n)
    kw = _grouped_kw(blocks, plane)
    g8 = gemm_rng.KERNEL_GROUPED_FP8_BF16
    for fn in (gemm_rng.gemm_with_rng_grouped,
               gemm_rng.gemm_with_rng_grouped_fp8):
        before = {g: gemm_rng.variant_counts(g) for g in (key, g8)}
        c3, none = fn(a, w, **kw)
        after = {g: gemm_rng.variant_counts(g) for g in (key, g8)}
        if none is not None or after[key]["plain"] != \
                before[key]["plain"] + 1 or after[g8] != before[g8]:
            raise AssertionError(f"{fn.__name__} Region 3 on bf16 did not "
                                 f"run the emission-off {key} kernel alone")
        err3 = _close(f"{fn.__name__} bf16 Region 3", c3.float(),
                      gemm_rng.gemm_grouped_plain(a, w).float(),
                      BF16_GEMM_TOL, state, key)
        log(f"[kernels] {fn.__name__} on bf16 Region 3 {e}x({m}x{k})x({k}x"
            f"{n}) with a {plane[0]}x{plane[1]}x{plane[2]} plane: no plane, "
            f"{key} with the emission off, C max abs err {err3:.3g}")
    timing[key] = dict(rows[GROUPED_MAIN], rows=rows)

    # ---- the e4m3 kernels on bf16 operands: bf16 C
    k8, g8 = gemm_rng.KERNEL_FP8_BF16, gemm_rng.KERNEL_GROUPED_FP8_BF16
    for name, (label, dims, plane) in ((k8, FP8_BF16_DENSE),
                                       (g8, FP8_BF16_GROUPED)):
        grouped = name == g8
        if grouped:
            e, m, k, n = dims
            blocks = pick_gemm_blocks(m, n, k)
            a, w = rnd(e, m, k), rnd(e, k, n)
            kw = _grouped_kw(blocks, plane)
            fn = gemm_rng.gemm_with_rng_grouped_fp8
            plain = gemm_rng.gemm_with_rng_grouped_fp8_plain
            ops = gemm_rng.quantize_grouped(a, w, blocks)
            kmajor = (*ops[:2], *gemm_rng.kmajor_grouped(*ops[2:], blocks))
            kernel = gemm_rng.gemm_rng_grouped_fp8_kmajor
            plain_fn = lambda em: gemm_rng.gemm_grouped_fp8_plain(  # noqa
                *ops, blocks, bf16)
        else:
            m, n, k = dims
            e = 1
            blocks = pick_gemm_blocks(m, n, k)
            a, w = rnd(m, k), rnd(k, n)
            kw = _grouped_kw(blocks, plane)
            fn, plain = gemm_rng.gemm_with_rng_fp8, \
                gemm_rng.gemm_with_rng_fp8_plain
            ops = (*quant.quantize_tiled(a, blocks[0], blocks[2]),
                   *quant.quantize_tiled(w, blocks[2], blocks[1]))
            kmajor = (ops[0], ops[1], ops[2].T.contiguous(),
                      ops[3].T.contiguous())
            kernel = gemm_rng.gemm_rng_fp8_kmajor
            plain_fn = lambda em: gemm_rng._plain_fp8(  # noqa: E731
                *ops, blocks, em, bf16)
        c16, mask = fn(a, w, **kw)
        c32, _ = fn(a.float(), w.float(), **kw)
        want16, want = plain(a, w, **kw)
        torch.cuda.synchronize()
        err = _fp8_bf16_check(label, name, c16, c32, want16, mask, want,
                              state)
        del c16, c32, want16, mask, want
        _, em = gemm_rng._emission(a, w, plane[0], plane[1], plane[2],
                                   plane[2], 0.1, kw["seed"], kw["salt"], 7,
                                   *blocks, 2048, 256, 0, 0, grouped=grouped)
        launches = {v: (lambda v=v: kernel(*kmajor, blocks,
                                           em if "rng" in v else None,
                                           bf16 if "16" in v else
                                           torch.float32))
                    for v in ("rng16", "off16", "rng32")}
        runs = {v: [] for v in launches}
        for v in ("rng16", "off16", "rng32", "rng32", "off16", "rng16"):
            runs[v].append(cuda_time_ms(launches[v], 5))
        ms = {v: float(np.mean(t)) for v, t in runs.items()}
        plain_ms = cuda_time_ms(lambda: plain(a, w, **kw), 1, warmup=1)
        plain_off_ms = cuda_time_ms(lambda: plain_fn(None), 1, warmup=1)
        words = plane[0] * plane[1] * (plane[2] // 32) * plane[2]
        bound_ms, bound_by = gemm_rng_fp8_bound(m, n, k, blocks, words, 7,
                                                ops_rate, groups=e,
                                                c_bytes=2)
        off_bound, off_by = gemm_rng_fp8_bound(m, n, k, blocks, 0, 7,
                                               ops_rate, groups=e, c_bytes=2)
        timing[name] = dict(ms=ms["rng16"], plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None, emission_off_ms=ms["off16"],
                            f32_c_ms=ms["rng32"],
                            plain_variant_ms=ms["off16"],
                            plain_variant_bound_ms=off_bound,
                            plain_variant_bound_by=off_by,
                            plain_variant_plain_ms=plain_off_ms,
                            shape=[e, m, n, k] if grouped else [m, n, k],
                            blocks=list(blocks))
        flops = 2 * e * m * n * k
        log(f"[kernels] {name} {label} {dims} blocks {blocks} on bf16 "
            f"operands + plane {plane[0]}x{plane[1]}x{plane[2] // 32}x"
            f"{plane[2]}: plane == plain bitwise, C bf16 == the f32 "
            f"instance's C rounded once bitwise, max abs err {err:.3g} "
            f"against the plain version (tol {BF16_GEMM_TOL} x (1+|C|)); "
            f"{ms['rng16']:.4f} ms a launch (in turns {runs['rng16']}), "
            f"{flops / ms['rng16'] / 1e9:.1f} TFLOP/s; emission off "
            f"{ms['off16']:.4f} ms (in turns {runs['off16']}), the plane "
            f"{(ms['rng16'] - ms['off16']) / ms['off16'] * 100:+.2f}% of the "
            f"product; f32 C on the same operands {ms['rng32']:.4f} ms; "
            f"plain version {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by "
            f"{bound_by} (f16 tensor-core rate: "
            f"{flops / F16_FLOPS_PER_S * 1e3:.4f} ms), kernel at "
            f"{bound_ms / ms['rng16'] * 100:.2f}% of bound; no PyTorch call "
            f"computes per-tile-scaled e4m3 | {state['smi']}")
        del a, w, ops, kmajor
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 3
def _run_engine(cfg, serve, params, device, plens, max_new, seed):
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(cfg, serve=serve, params=params, device=device)
    rng = np.random.default_rng(seed)
    reqs = [engine.make_request(
        rng.integers(0, cfg.vocab_size, int(n)).tolist(), max_new)
        for n in plens]
    report = engine.run(reqs)
    return engine, reqs, report


def phase_serve_reference(state) -> None:
    """The reduced llama2 through the engine on the card and on the CPU."""
    from repro_torch.config import get_arch
    from repro_torch.models import Runtime, model_init, prefill
    from repro_torch.serve import ServeConfig
    cfg = get_arch("llama2-7b", reduced=True)
    params = model_init(cfg, seed=1, device="cpu")
    toks = torch.arange(40, dtype=torch.int64).reshape(1, 40) % cfg.vocab_size
    rt = Runtime(plan=None)
    ref, _ = prefill(params, cfg, rt, toks)
    got, _ = prefill(to_device(params, "cuda"), cfg, rt, toks.cuda())
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
    serve = ServeConfig(max_slots=2, page_size=16, num_pages=16,
                        max_model_len=96, prompt_bucket=8)
    runs = {dev: _run_engine(cfg, serve, to_device(params, dev), dev,
                             (10, 23, 17), 6, 3) for dev in ("cpu", "cuda")}
    (e_cpu, r_cpu, _), (e_gpu, r_gpu, _) = runs["cpu"], runs["cuda"]
    assert [r.output for r in r_cpu] == [r.output for r in r_gpu], \
        "reduced engine: card tokens != CPU tokens"
    assert e_cpu.mask_cache.stats() == e_gpu.mask_cache.stats()
    cpu_planes = dict(e_cpu.mask_cache.items())
    for key, plane in e_gpu.mask_cache.items():
        if not torch.equal(plane.cpu(), cpu_planes[key]):
            raise AssertionError(f"reduced engine plane {key} differs")
    log(f"[serve-ref] {cfg.name}: card == CPU (prefill logits allclose "
        f"1e-4; tokens, mask-cache stats {e_gpu.mask_cache.stats()} and "
        f"{len(cpu_planes)} planes equal)")


def phase_serve(state) -> None:
    from repro_torch.config import get_arch
    from repro_torch.models import model_init
    from repro_torch.serve import ServeConfig
    cfg = get_arch("llama2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (32, 4096, 32, 128, 11008, 32000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(t.shape)) for t in leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.2f}B f32 params on the card "
        f"in {(time.perf_counter() - t0) * 1e3:.0f} ms")
    serve = ServeConfig(max_slots=4, page_size=16, num_pages=4 * 32 + 4,
                        max_model_len=512, mask_decode=True)
    plens = np.random.default_rng(0).integers(256, 449, size=8)
    reset_launch_counts()
    engine, reqs, report = _run_engine(cfg, serve, params, "cuda", plens,
                                       64, 1)
    torch.cuda.synchronize()
    counts = launch_counts()
    state["philox_launches"] = counts[philox.KERNEL]
    d = report.to_dict()
    assert engine.masked and engine.plan.p == cfg.attn_dropout == 0.1
    assert report.n_requests == 8 and all(len(r.output) == 64
                                          for r in reqs), "unfinished"
    assert engine.nonfinite_logits == 0, "non-finite logits"
    misses = d["mask_cache"]["misses"]
    assert counts[philox.KERNEL] == misses == 8 * cfg.n_layers, (
        counts, d["mask_cache"])
    n = 0
    for key, plane in engine.mask_cache.items():
        seed, salt, _layer, _step, thr, rounds, bits = key
        assert bits == 32 and thr == threshold_from_p(engine.plan.p)
        _, h, sq32, sk = plane.shape
        want = philox.philox_dropout_mask_plain(
            1, h, sq32 * 32, sk, engine.plan.p, torch.tensor(seed), salt,
            rounds, device="cuda")
        state["philox_err"] = max(state["philox_err"],
                                  max_abs_err(plane, want))
        if not torch.equal(plane, want):
            raise AssertionError(f"cached plane {key} != plain version")
        n += 1
    assert n == misses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ft, ct = d["latency_first_token_s"], d["latency_completion_s"]
    log(f"[serve] prompts {plens.tolist()}; {d['total_new_tokens']} new "
        f"tokens in {d['wall_s']:.3f}s = {d['tokens_per_s']:.2f} tok/s")
    log(f"[serve] first token p50 {ft['p50'] * 1e3:.1f} ms p99 "
        f"{ft['p99'] * 1e3:.1f} ms; completion p50 {ct['p50'] * 1e3:.1f} "
        f"ms p99 {ct['p99'] * 1e3:.1f} ms; peak memory {peak:.2f} GiB")
    log(f"[serve] mask cache {d['mask_cache']}; philox launches "
        f"{counts[philox.KERNEL]}; {n} cached planes == plain bitwise "
        f"| {state['smi']}")
    _profile_serve(engine, cfg, state)


def _profile_serve(engine, cfg, state) -> None:
    """Where the serve time goes: a torch.profiler trace of the device
    over 4 more requests (prompt 256, 16 new tokens) on the same engine;
    device busy share = summed kernel and copy time over the wall time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    reqs = [engine.make_request(
        rng.integers(0, cfg.vocab_size, 256).tolist(), 16) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[serve-profile] 4 requests x 16 tokens: wall {wall:.3f}s, "
        f"{report.tokens_per_s:.2f} tok/s, device busy {busy:.3f}s "
        f"({busy / wall * 100:.1f}%) | {state['smi']}")
    for us, count, key in rows[:8]:
        log(f"[serve-profile]   {us / 1e3:10.2f} ms {count:7d}x "
            f"{key[:90]}")


# ------------------------------------------------------------------ phase 4
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 4, 2, 2048


def rwkv_hybrid():
    """A reduced RWKV hybrid: (WKV, FULL) blocks with RWKV channel-mix FFNs
    at the reduced widths (d_model 64, two heads of 32), the grouped hosts'
    E=1 case."""
    from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig
    return ModelConfig(name="rwkv-hybrid-reduced", family="hybrid",
                       n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                       d_ff=128, vocab_size=64, head_dim=32,
                       rwkv_head_dim=32, attn_dropout=0.1,
                       block_pattern=(AttentionKind.WKV, AttentionKind.FULL),
                       ffn=FFNKind.RWKV_CHANNEL)


def _train_run(cfg, replay, batch, seq, remat="block", opt=None,
               site="qkv", gemm_dtype="f32", mode="overlap", impl="pallas"):
    """A training RunConfig, on the flash kernels unless ``impl`` says
    "xla". ``opt`` None is the repo's default OptimizerConfig (lr 3e-4
    after a 100-step warm-up)."""
    from repro_torch.config.base import (
        DropoutPlanConfig,
        OptimizerConfig,
        RunConfig,
        ShapeConfig,
        ShardingConfig,
        StepKind,
        TrainConfig,
    )
    return RunConfig(
        model=cfg, shape=ShapeConfig("smoke", seq, batch, StepKind.TRAIN),
        sharding=ShardingConfig(attn_impl=impl, remat=remat),
        dropout=DropoutPlanConfig(mode=mode, site=site, p=0.1,
                                  gemm_dtype=gemm_dtype, attn_replay=replay,
                                  seed=0),
        train=TrainConfig(optimizer=opt or OptimizerConfig()))


def _batches(cfg, run, device, n):
    from repro_torch.data import batch_for_step
    return [tuple(torch.from_numpy(t).to(device)
                  for t in batch_for_step(cfg, run.shape, i, seed=0))
            for i in range(n)]


# reduced-model runs at the full rate from step 1, so the weights move
# measurably
REF_OPT = dict(lr=1e-3, warmup_steps=1)
# phase 4's batch and sequence: the CPU's half of each run takes most of
# the phase; 128 still plans replay and exceeds the reduced
# recurrentgemma's window of 32. The runs with bf16 MoE or RWKV-hybrid
# steps (the grouped hosts', moonshot's fused mode) keep 256: their
# card-against-CPU spread sits near its limits, and at 128 moonshot's
# ffn_down/fp8 step 2 at bf16 compute read its grad norm 1.0 % off
# (limit 0.5 %)
REF_B, REF_S, REF_S_GROUPED_BF16 = 2, 128, 256
# fp8 after the first update: an activation that differs in its last f32
# bit between the card and the CPU now and then rounds to the other e4m3
# neighbour, and Adam turns a flipped near-zero gradient into a weight
# difference of up to lr a step (tests/test_torch_sites.py measures the
# same against JAX); step 0, from equal weights, stays at 1e-4
FP8_REF_TOL = 1e-3
# ... and in a MoE model a weight that differs by about lr also moves the
# router's choices and the gradients it routes: the reduced moonshot's
# grad norm after two fp8 updates moved by up to 3.4e-3 relative against
# JAX on the CPU (tests/test_torch_moe.py)
MOE_FP8_GRAD_NORM_TOL = 1e-2
# bf16 compute, card against CPU: the card's kernels and cuBLAS sum in
# another order than the CPU's plain versions, and a bf16 rounding near a
# boundary then flips by one ulp (2^-8 relative) -- in the activations,
# the gradients and, through AdamW, in the direction of a near-zero
# gradient's update (up to 2 lr a weight over the two full-rate steps).
# tests/test_torch_bf16.py measured the CPU against JAX at bf16: losses
# 1.9e-5 and grad norms 7.9e-4 relative, weights 2.6 lr apart; the card
# against the CPU (H100 80GB HBM3): 1.8e-5, 1.16e-3, 2.6 lr
BF16_REF_LOSS_REL = 1e-4
BF16_REF_GRAD_NORM_REL = 5e-3
BF16_REF_WEIGHT_ATOL = 4 * REF_OPT["lr"]
# (step-0 loss, later losses, grad norm) relative limits at bf16 compute
BF16_REF_TOLS = (BF16_REF_LOSS_REL, BF16_REF_LOSS_REL, BF16_REF_GRAD_NORM_REL)
# A weight's own limit at fp8 and bf16 cannot see a master that did not
# move (AdamW moves a weight by at most about 2 lr here), so at every
# dtype each leaf's change over the 3 steps is held too: |change on the
# card - change on the CPU| / |change on the CPU| (Frobenius). Measured on
# the H100: 4e-6 at f32 compute, 0.046 at fp8 hosts, 0.049 at bf16
# compute; the CPU against JAX at bf16 0.097 (the embedding, whose rows of
# unseen tokens move by weight decay and sign flips alone). A master left
# unchanged reads 1, one moved the wrong way 2.
REF_CHANGE_REL = 0.25
# ... except the RWKV hybrid at bf16 compute, whose gradients move with
# every bf16 rounding: the JAX package against itself on it (its flash
# kernels against its tensor-op attention, both bf16, the same bits, on
# the CPU) differs by 2.8e-2 in the step-0 grad norm, 5.4e-2 at step 2,
# and by up to 0.27 in a leaf's change over 3 steps
# (tests/test_torch_bf16_grouped.py); the card against the CPU read 2.4e-2
# on the step-0 grad norm and 1.5e-4 on the step-2 loss (H100 80GB HBM3)
HYBRID_BF16_TOLS = (BF16_REF_LOSS_REL, 1e-3, 5e-2)
HYBRID_BF16_CHANGE_REL = 0.5
# ... and a MoE at bf16 compute through the tensor-op attention (fused
# mode, attn_impl "xla"), which rounds P to bf16 before P V: after the
# first update the router carries a weight moved by a flipped bf16 ulp
# into the tokens' experts, as tests/test_torch_bf16_grouped.py holds the
# MoE's later steps (LATER_LOSS_REL, LATER_GRAD_NORM_REL; the port's
# fused xla step against JAX's on the CPU: grad norm 8.3e-3 apart at step
# 1, tests/test_torch_fused.py). The card against the CPU on the reduced
# moonshot (H100 80GB HBM3): step-2 grad norm 1.16e-2 relative apart, the
# loss 9.9e-5; step 0 stays at the bf16 limits. (step-0 loss, later
# losses, step-0 grad norm, later grad norms)
MOE_XLA_BF16_TOLS = (BF16_REF_LOSS_REL, 1e-3, BF16_REF_GRAD_NORM_REL, 1e-2)


def _card_vs_cpu(cfg, run, master, label, gn_tol=FP8_REF_TOL,
                 compute_dtype=torch.float32, bf16_tols=BF16_REF_TOLS,
                 change_rel=REF_CHANGE_REL) -> None:
    """3 make_train_step steps on the card and on the CPU from the same
    weights: loss and grad norm of every step within 1e-4 (fp8: 1e-3 and
    ``gn_tol`` after step 0; bf16 compute: ``bf16_tols``, the step-0 and
    later losses' and the grad norm's, or with a fourth entry the step-0
    and later grad norms') and the final weights within 1e-4
    (fp8: 3 x lr; bf16: 4 x lr) and each leaf's change within
    ``change_rel`` of the CPU's."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    fp8 = run.dropout.gemm_dtype == "fp8"
    bf16 = compute_dtype == torch.bfloat16
    step_fn = make_train_step(cfg, run, compute_dtype=compute_dtype)
    runs = {}
    for dev in ("cpu", "cuda"):
        st = {"master": to_device(master, dev), "step": 0}
        st["opt"] = adamw_init(st["master"])
        ms = []
        for x, y in _batches(cfg, run, dev, 3):
            st, m = step_fn(st, x, y)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (st, ms)
    worst = [0.0, 0.0]
    ratio = [0.0, 0.0]  # of each step's own limit, loss and grad norm
    for i, ((lc, gc_), (lg, gg)) in enumerate(zip(runs["cpu"][1],
                                                  runs["cuda"][1])):
        tol, gtol = (FP8_REF_TOL, gn_tol) if fp8 and i > 0 else (1e-4, 1e-4)
        if bf16:
            tol = bf16_tols[0 if i == 0 else 1]
            gtol = bf16_tols[2 if i == 0 else len(bf16_tols) - 1]
        worst = [max(worst[0], abs(lc - lg) / abs(lc)),
                 max(worst[1], abs(gc_ - gg) / abs(gc_))]
        ratio = [max(ratio[0], abs(lc - lg) / (tol * (1 + abs(lc)))),
                 max(ratio[1], abs(gc_ - gg) / (gtol * (1 + abs(gc_))))]
        if abs(lc - lg) > tol * (1 + abs(lc)) or \
                abs(gc_ - gg) > gtol * (1 + abs(gc_)):
            raise AssertionError(f"{label} step {i}: card {(lg, gg)} != "
                                 f"CPU {(lc, gc_)}")
    wtol = dict(atol=3 * REF_OPT["lr"], rtol=0) if fp8 else \
        dict(atol=1e-4, rtol=1e-4)
    if bf16:
        wtol = dict(atol=BF16_REF_WEIGHT_ATOL, rtol=0)
    wdiff = change = 0.0
    for w0, a, b in zip(leaves(master), leaves(runs["cpu"][0]["master"]),
                        leaves(runs["cuda"][0]["master"])):
        b = b.cpu()
        torch.testing.assert_close(b, a, **wtol)
        wdiff = max(wdiff, float((b - a).abs().max()))
        d_cpu, d_card = (a - w0).double(), (b - w0).double()
        rel = float((d_card - d_cpu).norm() / d_cpu.norm().clamp_min(1e-30))
        if rel > change_rel:
            raise AssertionError(f"{label}: a leaf's change over 3 steps on "
                                 f"the card is {rel:.3g} (relative) from "
                                 f"the CPU's")
        change = max(change, rel)
    card_losses = [round(loss, 6) for loss, _ in runs["cuda"][1]]
    later_gn = (f", then {bf16_tols[3]}" if len(bf16_tols) > 3 else "")
    tols = (f"bf16 tolerances (loss {bf16_tols[0]}, then "
            f"{bf16_tols[1]}, grad norm {bf16_tols[2]}{later_gn} relative, "
            f"weights "
            f"{BF16_REF_WEIGHT_ATOL})" if bf16 else
            '1e-4 at step 0, then fp8 tolerances' if fp8 else 'within 1e-4')
    log(f"[train-ref] {cfg.name} B={run.shape.global_batch} "
        f"S={run.shape.seq_len} {label}: 3 steps card == CPU "
        f"(losses {card_losses}; grad norms and weights {tols}; each "
        f"leaf's change within {change_rel} relative); measured "
        f"largest differences: loss {worst[0]:.3g}, grad norm "
        f"{worst[1]:.3g} relative, weights {wdiff:.3g}, a leaf's change "
        f"{change:.3g} relative; loss and grad norm at {ratio[0]:.3g} and "
        f"{ratio[1]:.3g} of their limits")


def phase_train_reference(state) -> None:
    """Reduced llama2 and yi through make_train_step on the card and on
    the CPU: 3 steps at site qkv, replay and premask, allclose at 1e-4;
    the reduced llama2 also at prev_gemm/f32 and ffn_up/fp8, the reduced
    moonshot and arctic (MoE) at ffn_up/f32 and ffn_down/fp8 (premask, so
    the carried planes feed attention), and at compute_dtype=bf16 the
    reduced llama2 and yi at qkv/bf16 and the reduced moonshot, arctic and
    an RWKV hybrid at ffn_up/bf16 and ffn_down/fp8 (the bf16 limits; the
    hybrid's losses after step 0, grad norm and leaf changes at
    HYBRID_BF16_*); then fused-mode dropout on the reduced llama2 and
    moonshot under both attention impls at f32 and bf16 compute, and the
    reduced recurrentgemma (Griffin: RG-LRU blocks and LOCAL attention,
    head_dim 16, window 32, MQA) on the flash kernels at ffn_up/f32,
    prev_gemm/f32 and ffn_up/bf16 under bf16 compute, and at head_dim 256
    at ffn_up/f32 (the f32 D = 256 instances)."""
    from repro_torch.config import get_arch
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.core import producer
    from repro_torch.train import compile_run_schedule, init_train_state
    opt = OptimizerConfig(**REF_OPT)
    for arch in ("llama2-7b", "yi-6b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for replay in ("auto", "off"):
            _card_vs_cpu(cfg, _train_run(cfg, replay, REF_B, REF_S, opt=opt),
                         master, f"qkv/f32 attn_replay={replay}")
        if arch == "llama2-7b":
            for site, dtype in (("prev_gemm", "f32"), ("ffn_up", "fp8")):
                run = _train_run(cfg, "off", REF_B, REF_S, opt=opt, site=site,
                                 gemm_dtype=dtype)
                _card_vs_cpu(cfg, run, master,
                             f"{site}/{dtype} attn_replay=off")
        # bf16 compute: the bf16 GEMM+RNG and flash kernels
        _card_vs_cpu(cfg, _train_run(cfg, "auto", REF_B, REF_S, opt=opt,
                                     gemm_dtype="bf16"),
                     master, "qkv/bf16 compute_dtype=bf16 attn_replay=auto",
                     compute_dtype=torch.bfloat16)
    # the MoE stacks: the dense host at the first-dense layer and the
    # grouped hosts at the expert einsums, premask so the carried planes
    # feed attention
    for arch in ("moonshot-v1-16b-a3b", "arctic-480b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for site, dtype in (("ffn_up", "f32"), ("ffn_down", "fp8")):
            run = _train_run(cfg, "off", REF_B, REF_S, opt=opt, site=site,
                             gemm_dtype=dtype)
            sched = compile_run_schedule(cfg, run)
            if producer.HOW_GEMM_GROUPED not in {a.emit_how for a in
                                                 sched.assignments}:
                raise AssertionError(f"no grouped host:\n{sched.explain()}")
            _card_vs_cpu(cfg, run, master, f"{site}/{dtype} attn_replay=off",
                         gn_tol=MOE_FP8_GRAD_NORM_TOL)
    # bf16 compute over the grouped hosts: the MoE stacks (the dense bf16
    # host at the first-dense layer, the grouped bf16 kernel at the expert
    # einsums; the e4m3 kernels' bf16-C instances under ffn_down/fp8) and
    # an RWKV hybrid (the grouped kernel at its channel-mix GEMMs, E=1)
    for cfg in (get_arch("moonshot-v1-16b-a3b", reduced=True),
                get_arch("arctic-480b", reduced=True), rwkv_hybrid()):
        hybrid = cfg.moe is None
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for site, dtype in (("ffn_up", "bf16"), ("ffn_down", "fp8")):
            run = _train_run(cfg, "off", REF_B, REF_S_GROUPED_BF16, opt=opt,
                             site=site, gemm_dtype=dtype)
            sched = compile_run_schedule(cfg, run)
            if producer.HOW_GEMM_GROUPED not in {a.emit_how for a in
                                                 sched.assignments}:
                raise AssertionError(f"no grouped host:\n{sched.explain()}")
            _card_vs_cpu(cfg, run, master, f"{site}/{dtype} "
                         f"compute_dtype=bf16 attn_replay=off",
                         compute_dtype=torch.bfloat16,
                         bf16_tols=(HYBRID_BF16_TOLS if hybrid
                                    else BF16_REF_TOLS),
                         change_rel=(HYBRID_BF16_CHANGE_REL if hybrid
                                     else REF_CHANGE_REL))
    # fused mode: the keep bits drawn inside attention -- the flash
    # kernels' mode "fused", or each q-chunk of the tensor-op attention
    for arch in ("llama2-7b", "moonshot-v1-16b-a3b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for impl in ("pallas", "xla"):
            seq = REF_S if cfg.moe is None else REF_S_GROUPED_BF16
            run = _train_run(cfg, "auto", REF_B, seq, opt=opt, site="xla",
                             mode="fused", impl=impl)
            for dt in (torch.float32, torch.bfloat16):
                moe_xla = cfg.moe is not None and impl == "xla"
                _card_vs_cpu(cfg, run, master, f"fused attn_impl={impl} "
                             f"compute_dtype={str(dt)[6:]}",
                             compute_dtype=dt,
                             bf16_tols=(MOE_XLA_BF16_TOLS if moe_xla
                                        else BF16_REF_TOLS))
    # the Griffin hybrid: LOCAL layers through the flash kernels with the
    # window, the carried plane past the recurrent blocks
    cfg = get_arch("recurrentgemma-9b", reduced=True)
    master = init_train_state(cfg, seed=1, device="cpu")["master"]
    for site, dtype, dt in (("ffn_up", "f32", torch.float32),
                            ("prev_gemm", "f32", torch.float32),
                            ("ffn_up", "bf16", torch.bfloat16)):
        run = _train_run(cfg, "off", REF_B, REF_S, opt=opt, site=site,
                         gemm_dtype=dtype)
        _card_vs_cpu(cfg, run, master, f"{site}/{dtype} compute_dtype="
                     f"{str(dt)[6:]} attn_replay=off", compute_dtype=dt)
    # ... and at head_dim 256 at f32 compute: the f32 flash kernels' D = 256
    # instances
    wide = dataclasses.replace(cfg, head_dim=256)
    master = init_train_state(wide, seed=1, device="cpu")["master"]
    run = _train_run(wide, "off", REF_B, REF_S, opt=opt, site="ffn_up")
    reset_launch_counts()
    _card_vs_cpu(wide, run, master, "head_dim=256 ffn_up/f32 compute_dtype="
                 "float32 attn_replay=off")
    if launch_counts()[flash.instance(flash.KERNEL, 256)] == 0:
        raise AssertionError("the reduced recurrentgemma at head_dim 256 did "
                             "not launch the f32 D = 256 forward")


# ------------------------------------------------------------------ phase 5
def _host_kernels(gemm_dtype: str, compute_dtype=torch.float32):
    """(dense, grouped) GEMM+RNG kernel instances a plan's hosts launch:
    the e4m3 kernels for "fp8" (their bf16-C instances under bf16
    compute), the bf16 kernels for "bf16" and for "f32" under bf16 compute
    (whose operands are bf16), the f32 kernels otherwise."""
    bf16 = compute_dtype == torch.bfloat16
    if gemm_dtype == "fp8":
        return ((gemm_rng.KERNEL_FP8_BF16, gemm_rng.KERNEL_GROUPED_FP8_BF16)
                if bf16 else
                (gemm_rng.KERNEL_FP8, gemm_rng.KERNEL_GROUPED_FP8))
    if bf16 or gemm_dtype == "bf16":
        return gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_GROUPED_BF16
    return gemm_rng.KERNEL, gemm_rng.KERNEL_GROUPED


def _flash_names(compute_dtype, cfg=None):
    """The flash forward, dq and dkv instances a model's attention layers
    launch: the kernels of the compute dtype, at ``cfg``'s head dim (the
    D = 256 instances count apart)."""
    d = cfg.head_dim if cfg is not None else 0
    return tuple(flash.instance(n, d) for n in (
        flash.KERNELS[compute_dtype], *flash_bwd.KERNELS[compute_dtype]))


def _expected_fused_launches(cfg, remat: str, steps: int,
                             compute_dtype=torch.float32):
    """Kernel launches of ``steps`` fused-mode steps: the schedule is inert
    (no producer, no plane), so each attention layer launches the flash
    forward (twice under remat="block") and dq and dkv once, and nothing
    else runs a kernel."""
    from repro_torch.config.base import AttentionKind
    f = 2 if remat == "block" else 1
    fwd, dq, dkv = _flash_names(compute_dtype, cfg)
    n_attn = sum(k in (AttentionKind.FULL, AttentionKind.LOCAL)
                 for k in cfg.layer_kinds())
    n = {k: 0 for k in launch_counts()}
    n[fwd], n[dq], n[dkv] = f * n_attn, n_attn, n_attn
    return {k: v * steps for k, v in n.items()}


def _expected_launches(sched, remat: str, steps: int, cfg=None,
                       compute_dtype=torch.float32):
    """Kernel launches of ``steps`` training steps under the compiled
    schedule ``sched`` (one attention layer a stack unit). Each layer's
    forward runs flash_fwd and its host GEMM -- the in-layer QKV host
    (kept as the host under replay) or the carried emission for the next
    layer -- and remat="block" runs both again when the backward
    recomputes the unit; the backward runs dq and dkv once a layer. A
    dense GEMM host launches the kernel of the plan's gemm_dtype (the bf16
    kernel for "bf16", and for "f32" under bf16 compute, whose operands are
    bf16; for "fp8" under bf16 compute the e4m3 kernel's bf16-C instance),
    a standalone (Region-3) dense host its emission-off variant and the
    Philox kernel; under bf16 compute the flash kernels are the bf16
    instances. A grouped host (the MoE expert einsum, ``cfg``'s MoE
    layers) launches the grouped kernel of the plan's dtype, chosen the
    same way; a grouped
    block planned standalone runs its einsum as a tensor op and the Philox
    kernel. A carried schedule under premask makes the first layer's plane
    with the Philox kernel once a forward (outside the recomputed
    units)."""
    from repro_torch.core import producer
    f = 2 if remat == "block" else 1
    host, grouped = _host_kernels(sched.plan.gemm_dtype, compute_dtype)
    fwd, dq, dkv = _flash_names(compute_dtype, cfg)
    first_dense = (cfg.moe.first_dense_layers
                   if cfg is not None and cfg.moe is not None else None)
    n = {k: 0 for k in launch_counts()}
    for a in sched.assignments:
        if not a.consumes:
            continue
        n[fwd] += f
        n[dq] += 1
        n[dkv] += 1
        # (producer how, whether its GEMM is a grouped block's)
        hows = []
        if a.emit_site:
            hows.append((a.emit_how, a.emit_site in ("ffn_up", "ffn_down")
                         and first_dense is not None
                         and a.layer >= first_dense))
        if a.site == "qkv":
            hows.append((a.host_how if a.how == producer.HOW_REPLAY
                         else a.how, False))
        for how, grouped_block in hows:
            if how == producer.HOW_GEMM_GROUPED:
                n[grouped] += f
            elif how in (producer.HOW_GEMM, producer.HOW_STANDALONE) \
                    and not grouped_block:
                n[host] += f
            if how == producer.HOW_STANDALONE:
                n[philox.KERNEL] += f
    if sched.carried and not sched.replay and sched.for_layer(
            sched.first_consumer).how == producer.HOW_STANDALONE:
        n[philox.KERNEL] += 1
    return {k: v * steps for k, v in n.items()}


def _add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _bitwise_equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _train_main_path(state, cfg, tag, compute_dtype=torch.float32,
                     gemm_dtype="f32"):
    """The llama2 main path at ``compute_dtype``, site "qkv" with the
    ``gemm_dtype`` host: both plans checked (replay host=gemm_rng, and
    gemm_rng, i.e. premask), the state made from seed 0, step-0 gradients
    under both plans bitwise equal and finite f32, the plane the host
    kernel emits for layer 0 bitwise the plain one, then 3 replay steps
    and step 0 again under premask, bitwise equal (loss, grad norm,
    updated master), with every kernel launched as often as the
    schedule's formula says. Returns the run: the states, batches, replay
    step function, (loss, ce, grad norm) a step, step times, launches and
    peak memory."""
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.models import Runtime
    from repro_torch.models.attention import _project_qkv_fused
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.transformer import _index, embed_inputs
    from repro_torch.train import (
        compile_run_schedule,
        init_train_state,
        make_grad_fn,
        make_train_step,
    )
    gc.collect()
    torch.cuda.empty_cache()
    run_r = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, gemm_dtype=gemm_dtype)
    run_p = _train_run(cfg, "off", TRAIN_B, TRAIN_S, gemm_dtype=gemm_dtype)
    scheds = {}
    for run, how, host in ((run_r, "replay", "gemm_rng"),
                           (run_p, "gemm_rng", "")):
        sched = scheds[how] = compile_run_schedule(cfg, run)
        if any((a.how, a.host_how) != (how, host)
               for a in sched.assignments):
            raise AssertionError(f"schedule not {how}/{host}:\n"
                                 f"{sched.explain()}")
        log(f"{tag} {sched.explain()}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state0 = init_train_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state0["master"]))
    log(f"{tag} {cfg.name} x{cfg.n_layers} layers: {n_params / 1e9:.3f}B "
        f"f32 params + AdamW moments on the card in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    batches = _batches(cfg, run_r, "cuda", 3)
    x0, y0 = batches[0]

    # step 0 gradients under both plans: bitwise equal, f32 on the master
    loss_r, _, grads_r = make_grad_fn(cfg, run_r, compute_dtype=compute_dtype)(
        state0["master"], x0, y0, 0)
    loss_p, _, grads_p = make_grad_fn(cfg, run_p, compute_dtype=compute_dtype)(
        state0["master"], x0, y0, 0)
    torch.cuda.synchronize()
    if not (torch.equal(loss_r, loss_p)
            and _bitwise_equal_trees(grads_r, grads_p)):
        raise AssertionError(f"{tag} replay and premask step-0 loss / "
                             f"gradients differ")
    if not all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in leaves(grads_r)):
        raise AssertionError(f"{tag} step-0 gradients not finite f32")
    log(f"{tag} step 0: replay and premask loss {float(loss_r):.7f} and all "
        f"{len(leaves(grads_r))} gradient tensors (f32) bitwise equal, "
        f"finite")
    del grads_r, grads_p

    # the plane the host kernel emits for layer 0, on layer 0's input
    plan = DropoutPlan(run_p.dropout)
    params = tree_map(lambda t: t.to(compute_dtype), state0["master"])
    lp = _index(params["stacks"][0]["l0"], 0)
    host = (gemm_rng.KERNEL_BF16 if torch.bfloat16 in (
        compute_dtype, {"bf16": torch.bfloat16}.get(gemm_dtype))
        else gemm_rng.KERNEL)
    before = launch_counts()[host]
    with torch.no_grad():
        h = norm_apply(lp["norm_mix"],
                       embed_inputs(params, cfg, x0,
                                    Runtime(compute_dtype=compute_dtype)),
                       cfg)
        pos = torch.arange(TRAIN_S, dtype=torch.int32, device="cuda")
        *_, plane = _project_qkv_fused(lp["mix"], h, cfg, pos, plan, 0, 0,
                                       how=producer.HOW_GEMM)
    want = philox.philox_dropout_mask_plain(
        TRAIN_B, cfg.n_heads, TRAIN_S, TRAIN_S, plan.cfg.p,
        plan.step_seed(0), plan.salt(0), plan.cfg.philox_rounds,
        device="cuda")
    if not (torch.equal(plane, want)
            and launch_counts()[host] == before + 1):
        raise AssertionError(f"{tag} layer-0 plane of {host} != plain")
    log(f"{tag} layer 0: {host}'s plane {tuple(plane.shape)} == "
        f"philox_dropout_mask_plain bitwise")
    del plane, want, h, params, lp

    # the main path: 3 replay steps and step 0 again under premask
    step_r = make_train_step(cfg, run_r, compute_dtype=compute_dtype)
    step_p = make_train_step(cfg, run_p, compute_dtype=compute_dtype)
    reset_launch_counts()
    torch.cuda.synchronize()
    times, losses = [], []
    st = state0
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        new, m = step_r(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["ce"]),
                       float(m["grad_norm"])))
        if i == 0:
            new_p, m_p = step_p(state0, x, y)
            torch.cuda.synchronize()
            if not (torch.equal(m["loss"], m_p["loss"])
                    and torch.equal(m["grad_norm"], m_p["grad_norm"])
                    and _bitwise_equal_trees(new["master"],
                                             new_p["master"])):
                raise AssertionError(f"{tag} replay and premask step 0 "
                                     f"differ")
            del new_p
        st = new
    counts = launch_counts()
    remat = run_r.sharding.remat
    want_counts = _add_counts(
        _expected_launches(scheds["replay"], remat, 3,
                           compute_dtype=compute_dtype),
        _expected_launches(scheds["gemm_rng"], remat, 1,
                           compute_dtype=compute_dtype))
    if counts != want_counts:
        raise AssertionError(f"{tag} launches {counts} != {want_counts}")
    if not all(np.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"{tag} non-finite metrics {losses}")
    if not all(t.dtype == torch.float32 for t in leaves(st["master"])):
        raise AssertionError(f"{tag} the master is no longer f32")
    log(f"{tag} 3 steps (replay) + step 0 (premask): (loss, ce, grad norm) "
        f"{losses}; replay and premask step 0 bitwise equal (loss, grad "
        f"norm, updated weights)")
    log(f"{tag} launches {counts} == the schedule's formula: 4 steps x (per "
        f"layer: {host} and {flash.KERNELS[compute_dtype]} x2 for "
        f"remat='block', {' and '.join(flash_bwd.KERNELS[compute_dtype])} "
        f"x1) x {cfg.n_layers} layers")
    return dict(state0=state0, st=st, batches=batches, step_r=step_r,
                losses=losses, times=times, counts=counts,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                run_r=run_r)


def phase_train(state) -> None:
    from repro_torch.config import get_arch
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=TRAIN_LAYERS)
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (4096, 32, 128, 11008, 32000)
    r = _train_main_path(state, cfg, "[train]")
    losses, times = r["losses"], r["times"]
    state["gemm_variants"] = gemm_rng.variant_counts()
    state["train_launches"] = r["counts"]
    # the same step 0 without the GEMM+RNG and flash kernels: site "xla" bits
    # (the same counters) into the tensor-op attention (attn_impl "xla")
    run_r = r["run_r"]
    run_x = dataclasses.replace(
        run_r, sharding=dataclasses.replace(run_r.sharding, attn_impl="xla"),
        dropout=dataclasses.replace(run_r.dropout, site="xla"))
    _, m_x = make_train_step(cfg, run_x)(r["state0"], *r["batches"][0])
    loss_x, gn_x = float(m_x["loss"]), float(m_x["grad_norm"])
    if abs(loss_x - losses[0][0]) > 1e-4 * abs(loss_x) or \
            abs(gn_x - losses[0][2]) > 1e-3 * abs(gn_x):
        raise AssertionError(f"step 0 on the kernels {losses[0]} != on "
                             f"tensor ops {(loss_x, gn_x)}")
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    state["train"] = dict(step_s=step_s, tokens_per_s=tokens / step_s,
                          peak_gib=r["peak_gib"])
    state["loss0"] = {"qkv/f32": losses[0][0]}
    state["grad_norm0"] = {"qkv/f32": losses[0][2]}
    log(f"[train] step 0 through tensor ops (site xla, attn_impl xla): "
        f"loss {loss_x:.7f}, grad norm {gn_x:.6f}; the kernels' step 0 "
        f"within 1e-4 (loss) and 1e-3 (grad norm) relative")
    log(f"[train] step times {[round(t, 4) for t in times]} s (host clock "
        f"to a synchronize; step 0 includes first-call set-up); steady "
        f"step {step_s:.4f} s = {tokens / step_s:.1f} tokens/s; peak "
        f"memory {r['peak_gib']:.2f} GiB | {state['smi']}")
    _profile_train(r["step_r"], r["st"], r["batches"][0], state["train"],
                   state["smi"])


def _profile_train(step_fn, st, batch, record, smi) -> None:
    """Where a training step's time goes: a torch.profiler trace of one
    more step; device busy share = summed kernel and copy time over the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    x, y = batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(st, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    record["busy_share"] = busy / wall
    record["wall_s"] = wall
    record["kernels_ms"] = {key: us / 1e3 for us, _, key in rows if us > 0}
    log(f"[train-profile] one step: wall {wall:.3f}s, device busy "
        f"{busy:.3f}s ({busy / wall * 100:.1f}%) | {smi}")
    for us, count, key in rows[:12]:
        log(f"[train-profile]   {us / 1e3:10.2f} ms {count:7d}x {key[:90]}")


# ------------------------------------------------------------------ phase 6
# one step each of the other carried sites and dtypes, after the main run
SITE_STEPS = (("prev_gemm", "fp8"), ("ffn_down", "fp8"), ("qkv", "fp8"),
              ("ffn_up", "f32"))
# step-0 losses of sites of one gemm_dtype see the same keep bits: in f32
# they differ by GEMM accumulation order only (1e-4 relative, as the
# kernels against tensor ops in phase 5); an fp8 host quantizes one GEMM a
# layer (within 0.06 of that GEMM's f32 product), which moved the reduced
# llama2's step-0 loss by 2.5e-4 relative on the CPU: 1e-2 relative
F32_LOSS_REL = 1e-4
FP8_LOSS_REL = 1e-2


def phase_train_sites(state) -> None:
    """The fp8 host and the carried sites at llama2-7b width: the ffn_up /
    fp8 main path (3 replay steps, step 0 again under premask, bitwise
    equal), then one step of each SITE_STEPS plan."""
    from repro_torch.config import get_arch
    from repro_torch.core import producer
    from repro_torch.train import (
        compile_run_schedule,
        init_train_state,
        make_grad_fn,
        make_train_step,
    )
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=TRAIN_LAYERS)
    run_r = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, site="ffn_up",
                       gemm_dtype="fp8")
    run_p = _train_run(cfg, "off", TRAIN_B, TRAIN_S, site="ffn_up",
                       gemm_dtype="fp8")
    sched_r = compile_run_schedule(cfg, run_r)
    sched_p = compile_run_schedule(cfg, run_p)
    for sched, first, rest in (
            (sched_r, ("replay", ""), ("replay", producer.HOW_GEMM)),
            (sched_p, (producer.HOW_STANDALONE, ""),
             (producer.HOW_GEMM, ""))):
        hows = [(a.how, a.host_how) for a in sched.assignments]
        emits = {(a.emit_site, a.emit_how) for a in sched.assignments}
        if not sched.carried or hows != [first] + [rest] * (
                TRAIN_LAYERS - 1) or emits != {("ffn_up", producer.HOW_GEMM)}:
            raise AssertionError(f"unexpected schedule:\n{sched.explain()}")
        log(f"[train-fp8] {sched.explain()}")
    state0 = init_train_state(cfg, seed=0, device="cuda")
    batches = _batches(cfg, run_r, "cuda", 3)
    x0, y0 = batches[0]

    # step 0 gradients under both plans: bitwise equal
    loss_r, _, grads_r = make_grad_fn(cfg, run_r)(state0["master"], x0, y0,
                                                  0)
    loss_p, _, grads_p = make_grad_fn(cfg, run_p)(state0["master"], x0, y0,
                                                  0)
    torch.cuda.synchronize()
    if not (torch.equal(loss_r, loss_p)
            and _bitwise_equal_trees(grads_r, grads_p)):
        raise AssertionError("ffn_up/fp8: replay and premask step-0 loss / "
                             "gradients differ")
    if not all(bool(torch.isfinite(g).all()) for g in leaves(grads_r)):
        raise AssertionError("ffn_up/fp8: non-finite step-0 gradients")
    log(f"[train-fp8] step 0: replay and premask loss {float(loss_r):.7f} "
        f"and all {len(leaves(grads_r))} gradient tensors bitwise equal, "
        "finite")
    del grads_r, grads_p

    # the main path: 3 replay steps and step 0 again under premask
    step_r = make_train_step(cfg, run_r)
    step_p = make_train_step(cfg, run_p)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    times, losses = [], []
    st = state0
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        new, m = step_r(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["ce"]),
                       float(m["grad_norm"])))
        if i == 0:
            new_p, m_p = step_p(state0, x, y)
            torch.cuda.synchronize()
            if not (torch.equal(m["loss"], m_p["loss"])
                    and torch.equal(m["grad_norm"], m_p["grad_norm"])
                    and _bitwise_equal_trees(new["master"],
                                             new_p["master"])):
                raise AssertionError("ffn_up/fp8: replay and premask step 0 "
                                     "differ")
            del new_p
        st = new
    counts = launch_counts()
    remat = run_r.sharding.remat
    want = _add_counts(_expected_launches(sched_r, remat, 3),
                       _expected_launches(sched_p, remat, 1))
    if counts != want:
        raise AssertionError(f"ffn_up/fp8 launches {counts} != {want}")
    if not all(np.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"non-finite metrics {losses}")
    state["fp8_launches"] = counts
    state["fp8_variants"] = gemm_rng.variant_counts(gemm_rng.KERNEL_FP8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    rec = state["train_fp8"] = dict(step_s=step_s,
                                    tokens_per_s=tokens / step_s,
                                    peak_gib=peak)
    loss0 = dict(state["loss0"], **{"ffn_up/fp8": losses[0][0]})
    log(f"[train-fp8] ffn_up/fp8: 3 steps (replay) + step 0 (premask): "
        f"(loss, ce, grad norm) {losses}; replay and premask step 0 "
        f"bitwise equal (loss, grad norm, updated weights)")
    log(f"[train-fp8] launches {counts} == the schedule's formula (per "
        f"step and layer: gemm_rng_fp8 under the gate+up GEMM and flash_fwd "
        f"x2 for remat='block', dq and dkv x1; the premask step's "
        f"bootstrap plane from philox_mask)")
    log(f"[train-fp8] step times {[round(t, 4) for t in times]} s; steady "
        f"step {step_s:.4f} s = {tokens / step_s:.1f} tokens/s; peak "
        f"memory {peak:.2f} GiB | {state['smi']}")
    _profile_train(step_r, st, batches[0], rec, state["smi"])
    del st, new

    for site, dtype in SITE_STEPS:
        run = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, site=site,
                         gemm_dtype=dtype)
        sched = compile_run_schedule(cfg, run)
        step_fn = make_train_step(cfg, run)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = step_fn(state0, x0, y0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want = _expected_launches(sched, run.sharding.remat, 1)
        if counts != want:
            raise AssertionError(f"{site}/{dtype} launches {counts} != "
                                 f"{want}\n{sched.explain()}")
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{site}/{dtype}: loss {loss}")
        loss0[f"{site}/{dtype}"] = loss
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state.setdefault("site_steps", {})[f"{site}/{dtype}"] = dict(
            step_s=dt, tokens_per_s=tokens / dt, peak_gib=peak, loss=loss)
        log(f"[train-sites] {site}/{dtype} ({sched.for_layer(1).how}, "
            f"emission {sched.for_layer(0).emit_how or '-'}): one step "
            f"{dt:.4f} s = {tokens / dt:.1f} tokens/s, peak {peak:.2f} GiB, "
            f"loss {loss:.7f}, launches {counts} == the schedule's formula "
            f"| {state['smi']}")
        del new

    ref = loss0["qkv/f32"]
    for key, loss in loss0.items():
        rel = abs(loss - ref) / abs(ref)
        bound = F32_LOSS_REL if key.endswith("f32") else FP8_LOSS_REL
        if rel > bound:
            raise AssertionError(f"step-0 loss {key} {loss} vs qkv/f32 "
                                 f"{ref}: {rel} > {bound}")
    log(f"[train-sites] step-0 losses {loss0}: f32 sites within "
        f"{F32_LOSS_REL} relative of qkv/f32, fp8 within {FP8_LOSS_REL}")
    state["loss0"] = loss0


# ------------------------------------------------------------------ phase 7
MOE_LAYERS = 4
# one step each of the other sites and dtypes on moonshot, after the main
# run; ffn_up/f32 runs the grouped f32 kernel (TPU kernel 9) at every MoE
# layer
MOE_SITE_STEPS = (("ffn_down", "fp8"), ("ffn_up", "f32"), ("ffn_down", "f32"),
                  ("qkv", "f32"))


def _moe_state(cfg):
    """moonshot's training state from seed 0 on the card: the same bits at
    every call (a seeded generator on the card)."""
    from repro_torch.train import init_train_state
    gc.collect()
    torch.cuda.empty_cache()
    return init_train_state(cfg, seed=0, device="cuda")


def _moonshot():
    """moonshot-v1-16b-a3b at full width and MOE_LAYERS of its layers."""
    from repro_torch.config import get_arch
    from repro_torch.core.producer import grouped_host_shapes
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"),
                              n_layers=MOE_LAYERS)
    m = cfg.moe
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.vocab_size,
            m.n_experts, m.top_k, m.d_ff_expert, m.n_shared_experts,
            m.first_dense_layers, m.capacity_factor) == (
        2048, 16, 128, 163840, 64, 6, 1408, 2, 1, 1.25)
    assert grouped_host_shapes(cfg, TRAIN_B, TRAIN_S) == {
        "ffn_up": (64, 480, 2048, 1408), "ffn_down": (64, 480, 1408, 2048)}
    return cfg


def _moe_main_path(state, cfg, tag, gemm_dtype,
                   compute_dtype=torch.float32):
    """moonshot's ffn_up main path with the ``gemm_dtype`` hosts at
    ``compute_dtype``: the next layer's plane made under L0's dense gate+up
    GEMM and L1-L3's grouped expert gate einsum; step-0 gradients under the
    replay and premask plans bitwise equal; the plane L1's grouped host
    emits (for L2) bitwise the plain one; then step 0 under premask (its
    updated weights kept on the host) and 3 replay steps from the same
    state, step 0 bitwise equal (loss, grad norm, every updated weight),
    every kernel launched as often as the schedule's formula says. The
    state is donated to every step (updated in place, bitwise the
    functional update): two copies of 2.46 B parameters, their gradients
    and moments would not fit on the card. Returns the run: (loss, ce,
    aux, grad norm) a step, step times, launches, peak memory, the replay
    step function, its state and the batches."""
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.core.producer import grouped_host_shapes
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import _index
    from repro_torch.train import (
        compile_run_schedule,
        make_grad_fn,
        make_train_step,
    )
    m = cfg.moe
    run_r = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, site="ffn_up",
                       gemm_dtype=gemm_dtype)
    run_p = _train_run(cfg, "off", TRAIN_B, TRAIN_S, site="ffn_up",
                       gemm_dtype=gemm_dtype)
    sched_r = compile_run_schedule(cfg, run_r)
    sched_p = compile_run_schedule(cfg, run_p)
    emits = [(a.emit_site, a.emit_how) for a in sched_r.assignments]
    if emits != [("ffn_up", producer.HOW_GEMM)] + [
            ("ffn_up", producer.HOW_GEMM_GROUPED)] * (MOE_LAYERS - 1) or \
            [(a.emit_site, a.emit_how) for a in sched_p.assignments] != \
            emits or not (sched_r.replay and sched_p.carried
                          and not sched_p.replay):
        raise AssertionError(f"unexpected schedules:\n{sched_r.explain()}"
                             f"\n{sched_p.explain()}")
    for sched in (sched_r, sched_p):
        log(f"{tag} {sched.explain()}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = _moe_state(cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(st["master"]))
    log(f"{tag} {cfg.name} x{cfg.n_layers} layers (L0 dense, L1-L3 "
        f"MoE {m.n_experts} experts top-{m.top_k}, capacity "
        f"{grouped_host_shapes(cfg, TRAIN_B, TRAIN_S)['ffn_up'][1]}): "
        f"{n_params / 1e9:.3f}B f32 params + AdamW moments on the card in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    batches = _batches(cfg, run_r, "cuda", 3)
    x0, y0 = batches[0]
    label = f"moonshot ffn_up/{gemm_dtype}"

    # step 0 gradients under both plans: bitwise equal
    loss_r, _, grads_r = make_grad_fn(cfg, run_r, compute_dtype=compute_dtype)(
        st["master"], x0, y0, 0)
    loss_p, _, grads_p = make_grad_fn(cfg, run_p, compute_dtype=compute_dtype)(
        st["master"], x0, y0, 0)
    torch.cuda.synchronize()
    if not (torch.equal(loss_r, loss_p)
            and _bitwise_equal_trees(grads_r, grads_p)):
        raise AssertionError(f"{label}: replay and premask step-0 loss / "
                             f"gradients differ")
    if not all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in leaves(grads_r)):
        raise AssertionError(f"{label}: step-0 gradients not finite f32")
    log(f"{tag} step 0: replay and premask loss {float(loss_r):.7f} "
        f"and all {len(leaves(grads_r))} gradient tensors (f32) bitwise "
        f"equal, finite")
    del grads_r, grads_p

    # the plane L1's grouped host emits for L2, on a random layer input
    plan = DropoutPlan(run_p.dropout)
    host, grouped = _host_kernels(gemm_dtype, compute_dtype)
    shape = (TRAIN_B, cfg.n_heads, TRAIN_S, TRAIN_S)
    with torch.no_grad():
        lp = tree_map(lambda t: t.to(compute_dtype),
                      _index(st["master"]["stacks"][1]["l0"], 0))
        x = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(9)).to(compute_dtype)
        before = launch_counts()[grouped]
        *_, plane = moe_apply(lp["moe"], x, cfg, host=producer.FFNHost(
            plan=plan, site="ffn_up", mask_shape=shape, layer_idx=2, step=0,
            how=producer.HOW_GEMM_GROUPED))
    want = philox.philox_dropout_mask_plain(
        *shape, plan.cfg.p, plan.step_seed(0), plan.salt(2),
        plan.cfg.philox_rounds, device="cuda")
    if not (torch.equal(plane, want)
            and launch_counts()[grouped] == before + 1):
        raise AssertionError(f"{label}: L1's plane of {grouped} != plain")
    log(f"{tag} L1's {grouped} plane for L2 {tuple(plane.shape)} == "
        f"philox_dropout_mask_plain bitwise")
    del lp, x, plane, want

    # the main path: step 0 under premask (its updated weights kept on the
    # host), then 3 replay steps from the same state
    step_r = make_train_step(cfg, run_r, donate=True,
                             compute_dtype=compute_dtype)
    step_p = make_train_step(cfg, run_p, donate=True,
                             compute_dtype=compute_dtype)
    reset_launch_counts()
    torch.cuda.synchronize()
    st, m_p = step_p(st, x0, y0)
    updated_p = [t.cpu() for t in leaves(st["master"])]
    counts_p = launch_counts()
    del st
    st = _moe_state(cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    times, losses = [], []
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        st, mt = step_r(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(mt["loss"]), float(mt["ce"]), float(mt["aux"]),
                       float(mt["grad_norm"])))
        if i == 0:
            if not (torch.equal(mt["loss"], m_p["loss"])
                    and torch.equal(mt["grad_norm"], m_p["grad_norm"])
                    and all(torch.equal(t.cpu(), u) for t, u in zip(
                        leaves(st["master"]), updated_p))):
                raise AssertionError(f"{label}: replay and premask step 0 "
                                     f"differ")
            del updated_p
    counts = _add_counts(launch_counts(), counts_p)
    remat = run_r.sharding.remat
    want = _add_counts(
        _expected_launches(sched_r, remat, 3, cfg,
                           compute_dtype=compute_dtype),
        _expected_launches(sched_p, remat, 1, cfg,
                           compute_dtype=compute_dtype))
    if counts != want:
        raise AssertionError(f"{label} launches {counts} != {want}")
    if not all(np.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"{label}: non-finite metrics {losses}")
    if not all(t.dtype == torch.float32 for t in leaves(st["master"])):
        raise AssertionError(f"{label}: the master is no longer f32")
    log(f"{tag} ffn_up/{gemm_dtype}: step 0 (premask) + 3 steps (replay): "
        f"(loss, ce, aux, grad norm) {losses}; replay and premask step 0 "
        f"bitwise equal (loss, grad norm, all updated weights)")
    log(f"{tag} launches {counts} == the schedule's formula (per step and "
        f"layer: {flash.KERNELS[compute_dtype]} x2 for remat='block', "
        f"{' and '.join(flash_bwd.KERNELS[compute_dtype])} x1; {host} x2 "
        f"under L0's gate+up GEMM, {grouped} x2 under each MoE layer's "
        f"expert gate einsum; the premask step's bootstrap plane from "
        f"philox_mask)")
    return dict(losses=losses, times=times, counts=counts, step_r=step_r,
                st=st, batches=batches,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _moe_site_steps(state, cfg, tag, steps, key, x0, y0,
                    compute_dtype=torch.float32):
    """One donated step of each (site, gemm_dtype) of ``steps`` on a fresh
    moonshot state at ``compute_dtype``, its launches against the
    schedule's formula; records them under ``state[key]``. Returns the
    step-0 losses by "site/dtype"."""
    from repro_torch.train import compile_run_schedule, make_train_step
    loss0 = {}
    tokens = TRAIN_B * TRAIN_S
    for site, dtype in steps:
        run = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, site=site,
                         gemm_dtype=dtype)
        sched = compile_run_schedule(cfg, run)
        step_fn = make_train_step(cfg, run, donate=True,
                                  compute_dtype=compute_dtype)
        st = _moe_state(cfg)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, mt = step_fn(st, x0, y0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want = _expected_launches(sched, run.sharding.remat, 1, cfg,
                                  compute_dtype=compute_dtype)
        if counts != want:
            raise AssertionError(f"moonshot {site}/{dtype} launches {counts}"
                                 f" != {want}\n{sched.explain()}")
        loss = float(mt["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"moonshot {site}/{dtype}: loss {loss}")
        loss0[f"{site}/{dtype}"] = loss
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state.setdefault(key, {})[f"{site}/{dtype}"] = dict(
            step_s=dt, tokens_per_s=tokens / dt, peak_gib=peak, loss=loss,
            launches=counts, plain_launches={
                k: gemm_rng.variant_counts(k)["plain"]
                for k in gemm_rng.launch_counts()})
        log(f"{tag} {site}/{dtype} (emissions "
            f"{[a.emit_how for a in sched.assignments]}): one step "
            f"{dt:.4f} s = {tokens / dt:.1f} tokens/s, peak {peak:.2f} GiB, "
            f"loss {loss:.7f}, launches {counts} == the schedule's formula "
            f"| {state['smi']}")
        del st
    return loss0


def phase_train_moe(state) -> None:
    """moonshot-v1-16b-a3b at full width, 4 layers: the ffn_up / fp8 main
    path (``_moe_main_path``: the e4m3 kernel under L0's dense gate+up
    GEMM, the grouped e4m3 kernel under L1-L3's expert gate einsum), then
    one step of each MOE_SITE_STEPS plan."""
    cfg = _moonshot()
    r = _moe_main_path(state, cfg, "[train-moe]", "fp8")
    losses, times = r["losses"], r["times"]
    state["moe_launches"] = r["counts"]
    state["moe_variants"] = gemm_rng.variant_counts(gemm_rng.KERNEL_GROUPED)
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    rec = state["train_moe"] = dict(step_s=step_s,
                                    tokens_per_s=tokens / step_s,
                                    peak_gib=r["peak_gib"])
    log(f"[train-moe] step times {[round(t, 4) for t in times]} s (step 0 "
        f"includes first-call set-up); steady step {step_s:.4f} s = "
        f"{tokens / step_s:.1f} tokens/s; peak memory {r['peak_gib']:.2f} "
        f"GiB | {state['smi']}")
    _profile_train(r["step_r"], r["st"], r["batches"][0], rec,
                   state["smi"])
    x0, y0 = r["batches"][0]
    del r

    loss0 = {"ffn_up/fp8": losses[0][0]}
    loss0.update(_moe_site_steps(state, cfg, "[train-moe-sites]",
                                 MOE_SITE_STEPS, "moe_site_steps", x0, y0))
    ref = loss0["ffn_up/f32"]
    for key, loss in loss0.items():
        rel = abs(loss - ref) / abs(ref)
        bound = F32_LOSS_REL if key.endswith("f32") else FP8_LOSS_REL
        if rel > bound:
            raise AssertionError(f"moonshot step-0 loss {key} {loss} vs "
                                 f"ffn_up/f32 {ref}: {rel} > {bound}")
    log(f"[train-moe-sites] step-0 losses {loss0}: f32 sites within "
        f"{F32_LOSS_REL} relative of ffn_up/f32, fp8 within {FP8_LOSS_REL}")
    state["moe_loss0"] = loss0
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8
# one step each after the bf16 main run: the carried gate+up host at bf16,
# gemm_dtype "f32" under bf16 compute (the same bf16 kernel, as JAX), the
# bf16 host cast from f32 activations (f32 flash), and the carried gate+up
# host on e4m3 under bf16 compute (the e4m3 kernel's bf16-C instance):
# (site, gemm_dtype, compute dtype)
BF16_SITE_STEPS = (("ffn_up", "bf16", torch.bfloat16),
                   ("qkv", "f32", torch.bfloat16),
                   ("qkv", "bf16", torch.float32),
                   ("ffn_up", "fp8", torch.bfloat16))
# step-0 losses on the same keep bits: bf16 compute with another host
# GEMM rounds other sums to bf16 (tests/test_torch_bf16.py: 1.9e-5
# relative between the CPU and JAX); a bf16 host under f32 compute rounds
# one GEMM a layer to bf16 (2^-9 relative an element), against qkv/f32's
# step 0: loss and grad norm (the loss of a random init is about
# ln(32000) whatever the GEMM does; the grad norm sees the cast host).
# Measured on the H100: loss 3.0e-5, grad norm 5.4e-5 relative
BF16_LOSS_REL = 1e-3
BF16_HOST_LOSS_REL = 3e-4
BF16_HOST_GRAD_NORM_REL = 5e-4


def phase_train_bf16(state) -> None:
    """llama2-7b at full width x 4 layers at compute_dtype=bf16, site qkv,
    gemm_dtype bf16 (the bf16 GEMM+RNG and flash kernels): the main path
    of phase 5 (replay == premask bitwise, launches against the formula),
    then one step of each BF16_SITE_STEPS plan."""
    from repro_torch.config import get_arch
    from repro_torch.train import compile_run_schedule, make_train_step
    bf16 = torch.bfloat16
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=TRAIN_LAYERS)
    r = _train_main_path(state, cfg, "[train-bf16]", bf16, "bf16")
    losses, times = r["losses"], r["times"]
    state["bf16_launches"] = r["counts"]
    state["bf16_variants"] = gemm_rng.variant_counts(gemm_rng.KERNEL_BF16)
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    rec = state["train_bf16"] = dict(step_s=step_s,
                                     tokens_per_s=tokens / step_s,
                                     peak_gib=r["peak_gib"])
    loss0 = {"qkv/bf16@bf16": losses[0][0]}
    f32_step = state["train"]["step_s"]
    log(f"[train-bf16] step times {[round(t, 4) for t in times]} s; steady "
        f"step {step_s:.4f} s = {tokens / step_s:.1f} tokens/s "
        f"({f32_step / step_s:.2f}x qkv/f32's {f32_step:.4f} s in phase "
        f"5); peak memory {r['peak_gib']:.2f} GiB | {state['smi']}")
    _profile_train(r["step_r"], r["st"], r["batches"][0], rec, state["smi"])
    state0, (x0, y0) = r["state0"], r["batches"][0]
    del r

    for site, dtype, cdt in BF16_SITE_STEPS:
        run = _train_run(cfg, "auto", TRAIN_B, TRAIN_S, site=site,
                         gemm_dtype=dtype)
        sched = compile_run_schedule(cfg, run)
        step_fn = make_train_step(cfg, run, compute_dtype=cdt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = step_fn(state0, x0, y0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want = _expected_launches(sched, run.sharding.remat, 1,
                                  compute_dtype=cdt)
        if counts != want:
            raise AssertionError(f"{site}/{dtype}@{cdt} launches {counts} "
                                 f"!= {want}\n{sched.explain()}")
        loss = float(m["loss"])
        key = f"{site}/{dtype}@{'bf16' if cdt == bf16 else 'f32'}"
        if cdt == bf16 and dtype == "f32":
            # the same bf16 kernel on the same operands as the main path
            if loss != losses[0][0]:
                raise AssertionError(f"{key}: loss {loss} != qkv/bf16@bf16 "
                                     f"{losses[0][0]}")
        elif cdt == bf16:
            bound = FP8_LOSS_REL if dtype == "fp8" else BF16_LOSS_REL
            if abs(loss - losses[0][0]) > bound * abs(losses[0][0]):
                raise AssertionError(f"{key}: loss {loss} vs "
                                     f"{losses[0][0]}")
        else:
            ref = state["loss0"]["qkv/f32"]
            gn, gn_ref = float(m["grad_norm"]), state["grad_norm0"]["qkv/f32"]
            host_rel = (abs(loss - ref) / abs(ref),
                        abs(gn - gn_ref) / abs(gn_ref))
            if host_rel[0] > BF16_HOST_LOSS_REL or \
                    host_rel[1] > BF16_HOST_GRAD_NORM_REL:
                raise AssertionError(f"{key}: (loss, grad norm) "
                                     f"{(loss, gn)} vs qkv/f32's "
                                     f"{(ref, gn_ref)}")
        loss0[key] = loss
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state.setdefault("bf16_site_steps", {})[key] = dict(
            step_s=dt, tokens_per_s=tokens / dt, peak_gib=peak, loss=loss,
            launches=counts)
        log(f"[train-bf16-sites] {key} ({sched.for_layer(1).how}, emission "
            f"{sched.for_layer(0).emit_how or '-'}): one step {dt:.4f} s = "
            f"{tokens / dt:.1f} tokens/s, peak {peak:.2f} GiB, loss "
            f"{loss:.7f}, launches {counts} == the schedule's formula | "
            f"{state['smi']}")
        del new
    log(f"[train-bf16-sites] step-0 losses {loss0}: qkv/f32@bf16 bitwise "
        f"qkv/bf16@bf16's, ffn_up/bf16@bf16 within {BF16_LOSS_REL} and "
        f"ffn_up/fp8@bf16 within {FP8_LOSS_REL} relative of it; "
        f"qkv/bf16@f32 against qkv/f32's step 0 (loss "
        f"{state['loss0']['qkv/f32']:.7f}, grad norm "
        f"{state['grad_norm0']['qkv/f32']:.6f}): loss {host_rel[0]:.3g} "
        f"(limit {BF16_HOST_LOSS_REL}), grad norm {host_rel[1]:.3g} (limit "
        f"{BF16_HOST_GRAD_NORM_REL}) relative")
    state["loss0"] = dict(state["loss0"], **loss0)
    del state0
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
# one step each after moonshot's bf16 main run: the grouped bf16 host under
# the expert down einsum, gemm_dtype "f32" under bf16 compute (the same
# bf16 kernels on the same operands, as JAX: its loss is bitwise the main
# run's step 0) and the e4m3 hosts under bf16 compute (the bf16-C
# instances of the dense and the grouped e4m3 kernel)
MOE_BF16_SITE_STEPS = (("ffn_down", "bf16"), ("ffn_up", "f32"),
                       ("ffn_up", "fp8"))


def phase_train_moe_bf16(state) -> None:
    """moonshot-v1-16b-a3b at full width, 4 layers, at compute_dtype=bf16:
    the ffn_up / bf16 main path (``_moe_main_path``: the bf16 GEMM+RNG
    kernel under L0's dense gate+up GEMM, the grouped bf16 kernel under
    L1-L3's expert gate einsum, the bf16 flash kernels), its step time,
    tokens/s, peak memory and a profiler trace beside phase 7's, then one
    step of each MOE_BF16_SITE_STEPS plan."""
    bf16 = torch.bfloat16
    cfg = _moonshot()
    r = _moe_main_path(state, cfg, "[train-moe-bf16]", "bf16", bf16)
    losses, times = r["losses"], r["times"]
    state["moe_bf16_launches"] = r["counts"]
    state["moe_bf16_variants"] = gemm_rng.variant_counts(
        gemm_rng.KERNEL_GROUPED_BF16)
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    rec = state["train_moe_bf16"] = dict(step_s=step_s,
                                         tokens_per_s=tokens / step_s,
                                         peak_gib=r["peak_gib"])
    fp8_step = state["train_moe"]["step_s"]
    f32_step = state["moe_site_steps"]["ffn_up/f32"]["step_s"]
    log(f"[train-moe-bf16] step times {[round(t, 4) for t in times]} s "
        f"(step 0 includes first-call set-up); steady step {step_s:.4f} s = "
        f"{tokens / step_s:.1f} tokens/s, against phase 7's ffn_up/fp8 "
        f"steady step {fp8_step:.4f} s ({fp8_step / step_s:.2f}x) and its "
        f"one ffn_up/f32 step {f32_step:.4f} s ({f32_step / step_s:.2f}x); "
        f"peak memory {r['peak_gib']:.2f} GiB | {state['smi']}")
    _profile_train(r["step_r"], r["st"], r["batches"][0], rec,
                   state["smi"])
    x0, y0 = r["batches"][0]
    del r

    loss0 = {"ffn_up/bf16": losses[0][0]}
    loss0.update(_moe_site_steps(state, cfg, "[train-moe-bf16-sites]",
                                 MOE_BF16_SITE_STEPS, "moe_bf16_site_steps",
                                 x0, y0, compute_dtype=bf16))
    ref = loss0["ffn_up/bf16"]
    if loss0["ffn_up/f32"] != ref:
        raise AssertionError(f"moonshot ffn_up/f32@bf16 loss "
                             f"{loss0['ffn_up/f32']} != ffn_up/bf16's {ref}")
    for key, loss in loss0.items():
        rel = abs(loss - ref) / abs(ref)
        bound = FP8_LOSS_REL if key.endswith("fp8") else BF16_LOSS_REL
        if rel > bound:
            raise AssertionError(f"moonshot@bf16 step-0 loss {key} {loss} "
                                 f"vs ffn_up/bf16 {ref}: {rel} > {bound}")
    log(f"[train-moe-bf16-sites] step-0 losses {loss0}: ffn_up/f32@bf16 "
        f"bitwise ffn_up/bf16's, ffn_down/bf16 within {BF16_LOSS_REL} and "
        f"ffn_up/fp8 within {FP8_LOSS_REL} relative of it")
    state["moe_bf16_loss0"] = loss0
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 10
# the dropout modes at llama2-7b width x 4, one step plan each: (label,
# mode, site, attn_replay); "overlap/xla" makes the plane with tensor ops
# beside the plain QKV GEMM and the flash kernels read it (premask), so its
# step is the fused step but for where the bits are drawn
# phase 10's llama2-7b depth: its host-bound tensor-op steps take most of
# the phase
FUSED_LAYERS = 2
FUSED_MODES = (("none", "none", "xla", "off"),
               ("fused", "fused", "xla", "off"),
               ("overlap/xla", "overlap", "xla", "off"),
               ("qkv/replay", "overlap", "qkv", "auto"),
               ("qkv/premask", "overlap", "qkv", "off"))


def _timed_steps(step_fn, st, batch, n=2):
    """Step times (host clock to a synchronize) of ``n`` steps from ``st``
    after one warm-up step, and the warm-up's metrics."""
    x, y = batch
    _, m = step_fn(st, x, y)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step_fn(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return m, times


def _kernel_groups(kernels_ms: dict) -> dict:
    """A profile's device time grouped by kernel: each flash kernel, the
    GEMM+RNG hosts (``gemm_rng_*_kernel``, the bf16 ``gemm_bf16_kernel``),
    the Philox kernel, the GEMM libraries (cuBLAS's gemm and nvjet
    kernels, CUTLASS's) and everything else."""
    out = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
           "gemm_rng": 0.0, "philox_mask": 0.0, "cublas_gemm": 0.0,
           "other": 0.0}
    for key, ms in kernels_ms.items():
        k = key.lower()
        group = next((g for g in ("flash_fwd", "flash_dq", "flash_dkv",
                                  "gemm_rng", "philox_mask") if g in k),
                     "gemm_rng" if "gemm_bf16_kernel" in k else None)
        if group is None and ("gemm" in k or "nvjet" in k
                              or "cutlass" in k):
            group = "cublas_gemm"
        out[group or "other"] += ms
    return {k: round(v, 4) for k, v in out.items()}


def phase_train_fused(state) -> None:
    """Fused-mode dropout, the paper's baseline, at llama2-7b width x
    FUSED_LAYERS (B=2, S=2048, p=0.1, remat="block"), at f32 and bf16
    compute: one step
    plan each of FUSED_MODES from the same state and batch -- its step-0
    loss, step time, peak memory, busy share and the profiler's device
    time by kernel. The fused and overlap/xla steps draw the same bits,
    one inside the flash kernels, one with tensor ops ahead of them:
    their losses and grad norms are bitwise equal. A fused step launches
    the flash kernels as the inert schedule implies and no GEMM+RNG host
    and no Philox kernel. Then one fused step of moonshot-v1-16b-a3b x 4
    at bf16 compute."""
    from repro_torch.config import get_arch
    from repro_torch.train import (
        compile_run_schedule,
        init_train_state,
        make_train_step,
    )
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=FUSED_LAYERS)
    rec = state.setdefault("train_fused", {})
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        gc.collect()
        torch.cuda.empty_cache()
        st = init_train_state(cfg, seed=0, device="cuda")
        batch = _batches(cfg, _train_run(cfg, "off", TRAIN_B, TRAIN_S),
                         "cuda", 1)[0]
        out = {}
        for label, mode, site, replay in FUSED_MODES:
            run = _train_run(cfg, replay, TRAIN_B, TRAIN_S, site=site,
                             mode=mode, gemm_dtype=("bf16" if dt ==
                                                    torch.bfloat16
                                                    else "f32"))
            sched = compile_run_schedule(cfg, run)
            step = make_train_step(cfg, run, compute_dtype=dt)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            _, m0 = step(st, *batch)
            torch.cuda.synchronize()
            counts = launch_counts()
            if mode == "fused":
                want = _expected_fused_launches(cfg, "block", 1, dt)
                if sched.active or counts != want:
                    raise AssertionError(f"fused {dname}: launches {counts} "
                                         f"!= {want} (schedule active: "
                                         f"{sched.active})")
            m, times = _timed_steps(step, st, batch)
            r = dict(loss0=float(m0["loss"]), grad_norm0=float(
                m0["grad_norm"]), step_s=float(np.mean(times)),
                times=[round(t, 4) for t in times],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches={k: v for k, v in counts.items() if v})
            if not all(np.isfinite(v) for v in (r["loss0"],
                                                 r["grad_norm0"])):
                raise AssertionError(f"{label} {dname}: non-finite {r}")
            prof = {}
            _profile_train(step, st, batch, prof, state["smi"])
            r.update(busy_share=prof["busy_share"],
                     kernels=_kernel_groups(prof["kernels_ms"]))
            out[label] = (m0, r)
            log(f"[train-fused] llama2-7b x{FUSED_LAYERS} {dname} {label}: "
                f"loss {r['loss0']:.7f}, grad norm {r['grad_norm0']:.6f}, "
                f"step {r['step_s']:.4f} s ({r['times']}), peak "
                f"{r['peak_gib']:.2f} GiB, busy {r['busy_share'] * 100:.1f}%"
                f", device ms by kernel {r['kernels']} | {state['smi']}")
        mf, mo = out["fused"][0], out["overlap/xla"][0]
        if not (torch.equal(mf["loss"], mo["loss"])
                and torch.equal(mf["grad_norm"], mo["grad_norm"])):
            raise AssertionError(f"fused {dname}: loss / grad norm != "
                                 f"overlap/xla's")
        if torch.equal(mf["loss"], out["none"][0]["loss"]):
            raise AssertionError(f"fused {dname}: loss == no dropout's")
        log(f"[train-fused] {dname}: fused and overlap/xla step-0 loss and "
            f"grad norm bitwise equal ({float(mf['loss']):.7f}); fused "
            f"launched the flash kernels only, as the inert schedule "
            f"implies")
        rec[dname] = {label: r for label, (_, r) in out.items()}
        del st, out, mf, mo
    # moonshot x 4, one fused step at bf16 compute (the state donated)
    bf16 = torch.bfloat16
    cfg = _moonshot()
    run = _train_run(cfg, "off", TRAIN_B, TRAIN_S, site="xla", mode="fused")
    st = _moe_state(cfg)
    batches = _batches(cfg, run, "cuda", 2)
    step = make_train_step(cfg, run, donate=True, compute_dtype=bf16)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        st, m = step(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    counts, want = launch_counts(), _expected_fused_launches(
        cfg, "block", 2, bf16)
    if counts != want or not all(np.isfinite(v) for row in losses
                                 for v in row):
        raise AssertionError(f"moonshot fused bf16: launches {counts} != "
                             f"{want} or metrics {losses}")
    rec["moonshot_bf16"] = dict(step_s=times[-1], losses=losses,
                                peak_gib=torch.cuda.max_memory_allocated()
                                / 2 ** 30)
    log(f"[train-fused] moonshot-v1-16b-a3b x{MOE_LAYERS} bf16 fused: 2 "
        f"steps (loss, grad norm) {losses}, step times "
        f"{[round(t, 4) for t in times]} s (the first includes set-up), "
        f"peak {rec['moonshot_bf16']['peak_gib']:.2f} GiB; launches == the "
        f"fused formula | {state['smi']}")
    del st, step, batches
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
GRIFFIN_LAYERS, GRIFFIN_B, GRIFFIN_S = 6, 1, 4096
# phase 12, at f32 compute: the depth (6 if the f32 state of two (R, R, A)
# super-blocks fits the card's 80 GB, as phase 11's bf16 run of them does
# at 58.7 GiB) and the depth of its step on the CPU (one super-block)
GRIFFIN_F32_LAYERS, GRIFFIN_CPU_LAYERS = 6, 3
# ... and the sequence of that step: the CPU's half takes most of the
# phase; 2304 is still past the LOCAL window of 2048 (2560 before phase
# 16 was added)
GRIFFIN_CPU_S = 2304


# the flash kernels' device time a step in phases 11 and 12 (one profiled
# replay step) before the bf16 dq and dkv at head_dim 256 were redesigned
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 5)
GRIFFIN_FLASH_MS_BEFORE = {torch.bfloat16: 8.02, torch.float32: 23.30}


def _griffin_main_path(state, key, compute_dtype, n_layers) -> dict:
    """recurrentgemma-9b at full width and ``n_layers`` of its 38 layers
    -- (R, R, A) super-blocks: RG-LRU blocks and LOCAL attention layers
    (window 2048, 16 query heads over one kv head, head_dim 256) -- at
    B=1, S=4096 (the window binds), ``compute_dtype``, the flash kernels'
    D = 256 instances of that dtype, p=0.1, remat="block", site "ffn_up"
    with the GEMM+RNG host of the compute dtype (bf16 under bf16 compute,
    f32 at f32): L2's gate+up GEMM makes L5's plane, carried past L3 and
    L4 (emit stride 3). Step 0 under premask (its updated weights kept on
    the host) and 3 replay steps from the same state, step 0 bitwise
    equal; launches against the schedule's formula; then one fused step.
    The state is donated to each step. Records (under state[key]) step
    time, peak memory, busy share and the device time by kernel, and the
    shares of the RG-LRU scan and the f32 unembedding (each timed alone
    on the step's shapes)."""
    from repro_torch.config import get_arch
    from repro_torch.config.base import AttentionKind
    from repro_torch.models.rglru import _scan_recurrence
    from repro_torch.train import (
        compile_run_schedule,
        init_train_state,
        make_train_step,
    )
    dt = compute_dtype
    gemm_dtype = "bf16" if dt == torch.bfloat16 else "f32"
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"),
                              n_layers=n_layers)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.local_window) == (
        4096, 16, 1, 256, 12288, 256000, 2048)
    assert cfg.layer_kinds() == (AttentionKind.RECURRENT,
                                 AttentionKind.RECURRENT,
                                 AttentionKind.LOCAL) * (n_layers // 3)
    tag = f"[{key.replace('_', '-')}]"
    b, s = GRIFFIN_B, GRIFFIN_S
    run_r = _train_run(cfg, "auto", b, s, site="ffn_up",
                       gemm_dtype=gemm_dtype)
    run_p = _train_run(cfg, "off", b, s, site="ffn_up",
                       gemm_dtype=gemm_dtype)
    sched_r = compile_run_schedule(cfg, run_r)
    sched_p = compile_run_schedule(cfg, run_p)
    for sched in (sched_r, sched_p):
        log(f"{tag} {sched.explain()}")
    if [a.emit_stride for a in sched_r.assignments if a.consumes] != \
            [3] * (n_layers // 3) or not (sched_r.replay and sched_p.carried):
        raise AssertionError(f"unexpected schedule:\n{sched_r.explain()}")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return init_train_state(cfg, seed=0, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    st = fresh()
    n_params = sum(t.numel() for t in leaves(st["master"]))
    log(f"{tag} {cfg.name} x{cfg.n_layers} layers at compute_dtype="
        f"{str(dt)[6:]}: {n_params / 1e9:.3f}B f32 params + AdamW moments "
        f"on the card")
    batches = _batches(cfg, run_r, "cuda", 3)
    step_r = make_train_step(cfg, run_r, donate=True, compute_dtype=dt)
    step_p = make_train_step(cfg, run_p, donate=True, compute_dtype=dt)
    reset_launch_counts()
    st, m_p = step_p(st, *batches[0])
    updated_p = [t.cpu() for t in leaves(st["master"])]
    counts_p = launch_counts()
    del st
    st = fresh()
    reset_launch_counts()
    times, losses = [], []
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        st, m = step_r(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0 and not (torch.equal(m["loss"], m_p["loss"])
                           and torch.equal(m["grad_norm"], m_p["grad_norm"])
                           and all(torch.equal(t.cpu(), u) for t, u in zip(
                               leaves(st["master"]), updated_p))):
            raise AssertionError(f"{tag} replay and premask step 0 differ")
    del updated_p
    counts = _add_counts(launch_counts(), counts_p)
    want = _add_counts(
        _expected_launches(sched_r, "block", 3, cfg, compute_dtype=dt),
        _expected_launches(sched_p, "block", 1, cfg, compute_dtype=dt))
    if counts != want or not all(np.isfinite(v) for row in losses
                                 for v in row):
        raise AssertionError(f"{tag} launches {counts} != {want} or "
                             f"metrics {losses}")
    fwd = flash.instance(flash.KERNELS[dt], cfg.head_dim)
    if counts[fwd] == 0:
        raise AssertionError(f"{tag} {fwd} never launched")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.mean(times[1:]))
    rec = state[key] = dict(step_s=step_s, peak_gib=peak, layers=n_layers,
                            tokens_per_s=b * s / step_s, losses=losses,
                            launches=counts)
    log(f"{tag} ffn_up/{gemm_dtype}: step 0 (premask) + 3 steps (replay): "
        f"(loss, grad norm) {losses}; replay and premask step 0 bitwise "
        f"equal (loss, grad norm, all updated weights); launches {counts} "
        f"== the schedule's formula; step times "
        f"{[round(t, 4) for t in times]} s, steady {step_s:.4f} s = "
        f"{b * s / step_s:.1f} tokens/s, peak {peak:.2f} GiB | "
        f"{state['smi']}")
    _profile_train(step_r, st, batches[0], rec, state["smi"])
    rec["kernels"] = _kernel_groups(rec.pop("kernels_ms"))
    rec["flash_ms"] = sum(rec["kernels"][g] for g in
                          ("flash_fwd", "flash_dq", "flash_dkv"))
    log(f"{tag} the flash kernels: {rec['flash_ms']:.3f} ms of device time "
        f"a step (before the bf16 backward at head_dim 256 was redesigned: "
        f"{GRIFFIN_FLASH_MS_BEFORE[dt]} ms) | {state['smi']}")
    # the RG-LRU scan and the f32 unembedding, each timed alone at the
    # step's shapes: the scan forward and backward a recurrent layer (the
    # forward twice under remat), the logits GEMM and its two dgrads
    gen = torch.Generator(device="cuda").manual_seed(5)
    la = -torch.rand((b, s, cfg.d_model), generator=gen, device="cuda")
    ga = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    la.requires_grad_()
    ga.requires_grad_()
    ct = torch.randn_like(ga)

    def scan_fb():
        h = _scan_recurrence(la, ga)
        torch.autograd.grad(h, (la, ga), ct)

    scan_ms = cuda_time_ms(scan_fb, 3) + cuda_time_ms(
        lambda: _scan_recurrence(la.detach(), ga.detach()), 3)
    n_rec = sum(k == AttentionKind.RECURRENT for k in cfg.layer_kinds())
    xs = torch.randn((b * s, cfg.d_model), generator=gen, device="cuda")
    w = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                    device="cuda")
    g = torch.randn((b * s, cfg.vocab_size), generator=gen, device="cuda")
    unembed_ms = (cuda_time_ms(lambda: xs @ w, 3)
                  + cuda_time_ms(lambda: g @ w.T, 3)
                  + cuda_time_ms(lambda: xs.T @ g, 3))
    del la, ga, ct, xs, w, g
    rec["scan_share"] = n_rec * scan_ms / 1e3 / step_s
    rec["unembed_share"] = unembed_ms / 1e3 / step_s
    log(f"{tag} the RG-LRU scan (forward twice, backward once a layer, "
        f"timed alone): {scan_ms:.3f} ms a layer x {n_rec} = "
        f"{rec['scan_share'] * 100:.1f}% of the step; the f32 unembedding "
        f"and its two dgrads (timed alone): {unembed_ms:.3f} ms = "
        f"{rec['unembed_share'] * 100:.1f}%; device ms by kernel "
        f"{rec['kernels']} | {state['smi']}")
    # one fused step from the replay state
    run_f = _train_run(cfg, "off", b, s, site="xla", mode="fused")
    step_f = make_train_step(cfg, run_f, donate=True, compute_dtype=dt)
    reset_launch_counts()
    t0 = time.perf_counter()
    st, m = step_f(st, *batches[0])
    torch.cuda.synchronize()
    rec["fused_step_s"] = time.perf_counter() - t0
    counts, want = launch_counts(), _expected_fused_launches(
        cfg, "block", 1, dt)
    if counts != want or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"{tag} fused: launches {counts} != {want} "
                             f"or loss {float(m['loss'])}")
    log(f"{tag} one fused step: loss {float(m['loss']):.6f}, "
        f"{rec['fused_step_s']:.4f} s (its first call), launches == the "
        f"fused formula | {state['smi']}")
    del st, step_r, step_p, step_f, batches
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_griffin(state) -> None:
    """recurrentgemma-9b x GRIFFIN_LAYERS at bf16 compute, ffn_up/bf16, on
    the bf16 flash kernels' D = 256 instances (``_griffin_main_path``)."""
    _griffin_main_path(state, "train_griffin", torch.bfloat16,
                       GRIFFIN_LAYERS)


def phase_train_griffin_f32(state) -> None:
    """recurrentgemma-9b x GRIFFIN_F32_LAYERS at f32 compute, ffn_up/f32,
    on the f32 flash kernels' D = 256 instances (``_griffin_main_path``);
    then the premask step 0 of its first GRIFFIN_CPU_LAYERS layers (one
    super-block, the same width and batch, GRIFFIN_CPU_S tokens) on the
    card and on the CPU from the same weights: loss and grad norm within
    the limits of the bf16 phases' card-against-CPU runs (BF16_REF_TOLS:
    1e-4 and 5e-3 relative)."""
    from repro_torch.config import get_arch
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.optim import adamw_init
    rec = _griffin_main_path(state, "train_griffin_f32", torch.float32,
                             GRIFFIN_F32_LAYERS)
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"),
                              n_layers=GRIFFIN_CPU_LAYERS)
    run = _train_run(cfg, "off", GRIFFIN_B, GRIFFIN_CPU_S, site="ffn_up")
    step = make_train_step(cfg, run)
    master = init_train_state(cfg, seed=0, device="cpu")["master"]
    x, y = _batches(cfg, run, "cpu", 1)[0]
    got = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m0 = to_device(master, dev)
        _, m = step({"master": m0, "opt": adamw_init(m0), "step": 0},
                    x.to(dev), y.to(dev))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    time.perf_counter() - t0)
        del m0, m
        gc.collect()
        torch.cuda.empty_cache()
    (lg, gg, tg), (lc, gc_, tc) = got["cuda"], got["cpu"]
    loss_tol, _, gn_tol = BF16_REF_TOLS
    loss_rel, gn_rel = abs(lg - lc) / abs(lc), abs(gg - gc_) / abs(gc_)
    rec["cpu_step0"] = dict(layers=GRIFFIN_CPU_LAYERS, card=(lg, gg),
                            cpu=(lc, gc_), loss_rel=loss_rel, gn_rel=gn_rel)
    if loss_rel > loss_tol or gn_rel > gn_tol or not np.isfinite(lg + gg):
        raise AssertionError(f"griffin f32 x{GRIFFIN_CPU_LAYERS} step 0: "
                             f"card {(lg, gg)} != CPU {(lc, gc_)}")
    log(f"[train-griffin-f32] x{GRIFFIN_CPU_LAYERS} layers (one super-block) "
        f"at full width, B={GRIFFIN_B} S={GRIFFIN_CPU_S}, ffn_up/f32 premask "
        f"step 0: card (loss, grad norm) {(lg, gg)} in {tg:.1f} s, CPU "
        f"{(lc, gc_)} in {tc:.1f} s: {loss_rel:.3g} and {gn_rel:.3g} "
        f"relative apart (limits {loss_tol}, {gn_tol}) | {state['smi']}")


# ------------------------------------------------------------------ phase 13
SERVE_NEW, SERVE_INT8_NEW = 64, 16
# decode against the teacher-forced forward: the JAX package's own limit
# (tests/test_models_smoke.py::test_prefill_decode_matches_forward, 2e-3
# absolute on logits of rms about 1), scaled by the forward logits' rms
# where that exceeds 1
SERVE_FWD_TOL = 2e-3
# the int8 cache's logits against the 16-bit cache's, in units of their
# rms: 8-bit keys and values carry up to 1/254 of their row's largest
# magnitude, which moves the attention outputs by a few parts in a
# thousand; the argmax tokens are printed, not held
SERVE_INT8_TOL = 0.1
# (key, arch, layers, batch, prompt): the depth cut to a few layers, the
# widths the published ones
SERVE_RUNS = (("griffin", "recurrentgemma-9b", 6, 2, 2560),
              ("moe", "moonshot-v1-16b-a3b", 4, 4, 512),
              ("rwkv", "rwkv6-7b", 4, 2, 500))


def _serve_cfg(arch: str, layers: int):
    """``arch`` at full width and ``layers`` of its layers. moonshot's
    routing is made dropless (capacity_factor = E / k, so an expert holds
    every token of a call): at its training factor of 1.25 a decode step
    of 4 tokens gives each expert one slot and drops the tokens that
    collide there, so no decode step could equal the forward, whose
    capacity counts 2,304 tokens; Moonlight serves without drops."""
    from repro_torch.config import get_arch
    from repro_torch.config.base import AttentionKind
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    if arch == "recurrentgemma-9b":
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.d_ff, cfg.vocab_size, cfg.local_window) == (
            4096, 16, 1, 256, 12288, 256000, 2048)
        assert cfg.layer_kinds() == (AttentionKind.RECURRENT,
                                     AttentionKind.RECURRENT,
                                     AttentionKind.LOCAL) * (layers // 3)
    elif arch == "moonshot-v1-16b-a3b":
        m = cfg.moe
        assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.vocab_size,
                m.n_experts, m.top_k, m.d_ff_expert, m.n_shared_experts,
                m.first_dense_layers) == (2048, 16, 128, 163840, 64, 6,
                                          1408, 2, 1)
        cf = -(-100 * m.n_experts // m.top_k) / 100       # 10.67
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=cf))
    else:
        assert (cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim, cfg.d_ff,
                cfg.vocab_size) == (4096, 64, 64, 14336, 65536)
        assert cfg.layer_kinds() == (AttentionKind.WKV,) * layers
    return cfg


def _teacher_forced(serve_step, params, caches, fed):
    """Decode ``fed`` (B, n) one column a step from ``caches``; returns the
    logits of every step (B, n, V)."""
    outs = []
    for i in range(fed.shape[1]):
        lg, caches = serve_step(params, fed[:, i:i + 1], caches)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def _profile_decode(serve_step, params, caches, fed, tag, smi) -> dict:
    """Where a decode step's time goes: a torch.profiler trace of the
    device over ``fed.shape[1]`` teacher-forced steps; device busy share =
    summed kernel and copy time over the wall time (the profiler on)."""
    from torch.profiler import ProfilerActivity, profile
    n = fed.shape[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _teacher_forced(serve_step, params, caches, fed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"{tag} profile, {n} decode steps: wall {wall * 1e3 / n:.3f} ms a "
        f"step, device busy {busy * 1e3 / n:.3f} ms a step "
        f"({busy / wall * 100:.1f}%), {sum(r[1] for r in rows) / n:.0f} "
        f"device activities a step | {smi}")
    for us, count, key in rows[:6]:
        log(f"{tag}   {us / 1e3 / n:9.4f} ms a step {count // n:5d}x "
            f"{key[:90]}")
    return dict(busy_share=busy / wall, device_ms_step=busy * 1e3 / n,
                wall_ms_step=wall * 1e3 / n,
                top=[(key[:60], us / 1e3 / n) for us, _, key in rows[:6]])


def _serve_control(key, cfg, prompt, caches, prefill_step, params):
    """Caches that hold a wrong prompt state, for the control: the LOCAL
    rings unrolled (slot i holds key s - w + i, not the ring's position
    % w, so each decode step masks and overwrites the wrong slot); the
    attention caches' ``len`` one too many; the RWKV state one token too
    many (whose decode reads no length: the prompt's last token fed
    twice)."""
    from repro_torch.config.base import AttentionKind
    from repro_torch.models import build_stacks
    if key == "rwkv":
        return prefill_step(params, torch.cat([prompt, prompt[:, -1:]],
                                              dim=1))[1]
    caches = tree_map(torch.clone, caches)
    s = prompt.shape[1]
    for spec, stack in zip(build_stacks(cfg), caches):
        for j, (kind, _) in enumerate(spec.unit):
            c = stack[f"l{j}"]
            if key == "griffin" and kind == AttentionKind.LOCAL:
                w = c["k"].shape[3]
                for f in ("k", "v"):
                    c[f] = torch.roll(c[f], -(s % w), dims=3)
            elif key == "moe" and kind == AttentionKind.FULL:
                c["len"] = c["len"] + 1
    return caches


def _int8_caches(cfg, caches):
    """The prefill's 16-bit attention caches quantized as the int8 cache
    stores them (``quantize_kv``: int8 values, f32 scales per token and
    head); the JAX package's prefill writes 16-bit caches and fills an
    int8 cache only by decode."""
    from repro_torch.models import build_stacks
    from repro_torch.models.attention import quantize_kv
    out = []
    for spec, stack in zip(build_stacks(cfg), caches):
        new = {}
        for key, c in stack.items():
            if "k" in c:
                kq, ks = quantize_kv(c["k"])
                vq, vs = quantize_kv(c["v"])
                new[key] = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
                            "len": c["len"].clone()}
            else:
                new[key] = tree_map(torch.clone, c)
        out.append(new)
    return out


def _serve_run(state, key, arch, layers, b, plen) -> dict:
    from repro_torch.models import Runtime, forward, model_init
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = _serve_cfg(arch, layers)
    tag = f"[serve-layers {key}]"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model_init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           device="cuda", dtype=torch.int32)
    prefill_step = make_prefill_step(cfg, capacity=plen + SERVE_NEW)
    serve_step = make_serve_step(cfg)
    prefill_s = []                   # the first call, then the same again
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill_step(params, prompt)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    # decode updates the attention caches in place: keep the prompt's
    kept = tree_map(torch.clone, caches)
    outs, fed = [logits[:, 0]], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_NEW):
        fed.append(tok)
        lg, caches = serve_step(params, tok, caches)
        outs.append(lg[:, 0])
        tok = lg[:, 0].argmax(dim=-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fed = torch.cat(fed, dim=1)                        # (B, SERVE_NEW)
    got = torch.stack(outs, dim=1)                     # (B, SERVE_NEW+1, V)
    del caches, outs
    with torch.no_grad():
        full, _ = forward(params, cfg, Runtime(),
                          torch.cat([prompt, fed], dim=1))
    want = full[:, plen - 1:].clone()
    del full
    rms = float(want.pow(2).mean().sqrt())
    limit = SERVE_FWD_TOL * max(1.0, rms)
    err = float((got - want).abs().max())
    # the control decodes one token fewer: with ``len`` one too many the
    # last would write past the FULL caches' capacity
    ctrl = _serve_control(key, cfg, prompt, kept, prefill_step, params)
    ctrl_err = float((_teacher_forced(serve_step, params, ctrl, fed[:, :-1])
                      - want[:, 1:-1]).abs().max())
    del ctrl
    rec = dict(batch=b, prompt=plen, new=SERVE_NEW, layers=layers,
               prefill_ms=prefill_s[1] * 1e3,
               prefill_first_call_ms=prefill_s[0] * 1e3,
               decode_tok_s=b * SERVE_NEW / decode_s,
               decode_step_ms=decode_s * 1e3 / SERVE_NEW, peak_gib=peak_gib,
               rms=rms, limit=limit, err=err, ctrl_err=ctrl_err)
    log(f"{tag} {arch} x{layers} at full width, B={b}, prompt {plen}, "
        f"{SERVE_NEW} new tokens: first token (prefill) "
        f"{prefill_s[1] * 1e3:.2f} ms (the first call "
        f"{prefill_s[0] * 1e3:.2f}), decode {rec['decode_step_ms']:.3f} ms "
        f"a step = {rec['decode_tok_s']:.1f} tokens/s, peak memory "
        f"{peak_gib:.2f} GiB | decode against the teacher-forced forward: "
        f"max |err| {err:.3g} (limit {limit:.3g} = {SERVE_FWD_TOL} x "
        f"max(1, rms {rms:.4g})); control {ctrl_err:.3g} | {state['smi']}")
    if not np.isfinite(err) or err > limit:
        raise AssertionError(f"{tag} decode off the forward: {err} > {limit}")
    if not ctrl_err > limit:
        raise AssertionError(f"{tag} the control passed: {ctrl_err} <= "
                             f"{limit}")
    rec["profile"] = _profile_decode(serve_step, params,
                                     tree_map(torch.clone, kept),
                                     fed[:, :8], tag, state["smi"])
    if key == "griffin":
        caches8 = _int8_caches(cfg, kept)
        n = SERVE_INT8_NEW
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got8 = _teacher_forced(serve_step, params, caches8, fed[:, :n])
        torch.cuda.synchronize()
        dec8_s = time.perf_counter() - t0
        ref = got[:, 1:n + 1]
        rms16 = float(ref.pow(2).mean().sqrt())
        err8 = float((got8 - ref).abs().max())
        same = float((got8.argmax(-1) == ref.argmax(-1)).float().mean())
        rec["int8"] = dict(new=n, err=err8, rms=rms16,
                           limit=SERVE_INT8_TOL * rms16,
                           decode_tok_s=b * n / dec8_s, argmax_same=same)
        log(f"{tag} kv_bits=8 (the prefill's caches quantized by "
            f"quantize_kv), {n} new tokens teacher-forced: logits against "
            f"the 16-bit cache's max |err| {err8:.4g} (limit "
            f"{SERVE_INT8_TOL} x rms {rms16:.4g}), argmax tokens equal "
            f"{same:.4f} of {b * n}, decode {b * n / dec8_s:.1f} tokens/s "
            f"| {state['smi']}")
        if not np.isfinite(err8) or err8 > SERVE_INT8_TOL * rms16:
            raise AssertionError(f"{tag} int8 off the 16-bit cache: {err8}")
        del caches8, got8
    del params, kept, got, want, prompt, fed
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_serve_layers(state) -> None:
    """Serving every layer kind at width through the contiguous caches
    (SERVE_RUNS): each run's prefill, decode, teacher-forced check and
    control (``_serve_run``); recorded under state["serve_layers"]."""
    state["serve_layers"] = {
        key: _serve_run(state, key, arch, layers, b, plen)
        for key, arch, layers, b, plen in SERVE_RUNS}


# ----------------------------------------------------------------- phase 14
# the training launcher (launch/train.py) at llama2-7b's full width, cut in
# depth: 8 steps, a checkpoint every 3, run B killed mid-forward at step 4
# and mid-backward at step 7 with its step-6 write killed before publishing
LAUNCHER_STEPS = 8
LAUNCHER_CKPT_EVERY = 3
LAUNCHER_FAULTS = ((4, "forward"), (7, "backward"))
LAUNCHER_KILL = 6
LAUNCHER_LAYERS = (4, 2)           # the deepest whose checkpoints fit
# checkpoints on disk at once in run B: the latest, the killed write's
# temporary file and the retried write's
LAUNCHER_CKPTS_ON_DISK = 3
CKPT_BYTES_PER_PARAM = 12          # the f32 master and two moments


class _StepClock:
    """When each step of a run finished (host clock after the step's
    synchronize) and when each injected fault fired: the recovery time of
    a fault at step s is the time from the fault to the end of step s's
    re-run."""

    def __init__(self):
        self.done = []                 # (step, t)
        self.faults = []               # (step, t)

    def wrap_done(self, step_fn):
        def timed(st, x, y):
            step = int(st["step"])
            out = step_fn(st, x, y)
            torch.cuda.synchronize()
            self.done.append((step, time.perf_counter()))
            return out
        return timed

    def wrap_faults(self, step_fn):
        def watched(st, x, y):
            try:
                return step_fn(st, x, y)
            except ChaosError:
                self.faults.append((int(st["step"]), time.perf_counter()))
                raise
        return watched

    def recoveries(self):
        return [next(t - tf for st, t in self.done if st == s and t > tf)
                for s, tf in self.faults]


class _TimedCheckpointer(ChaosCheckpointer):
    """A ChaosCheckpointer that times each save's wait for the previous
    write, its host gather, each file write and each restore."""

    def __init__(self, directory, kill_steps=()):
        super().__init__(directory, kill_steps=kill_steps, async_save=True)
        self.saves, self.writes, self.restores = [], [], []

    def save(self, step, st, contract=None):
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        super().save(step, st, contract=contract)
        self.saves.append((step, t1 - t0, time.perf_counter() - t1))

    def _write(self, step, host_state):
        t0 = time.perf_counter()
        super()._write(step, host_state)
        self.writes.append((step, time.perf_counter() - t0))

    def restore(self, step, template):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().restore(step, template)
        torch.cuda.synchronize()
        self.restores.append((step, time.perf_counter() - t0))
        return out


def _loss(bits: int) -> float:
    return float(np.uint32(bits).view(np.float32))


class _CountingRecorder(TrajectoryRecorder):
    """A TrajectoryRecorder on the card that counts its records (one
    standalone Philox launch each)."""

    def __init__(self, plan, batch, heads, seq):
        super().__init__(plan, batch, heads, seq, seq, device="cuda")
        self.records = 0

    def record(self, step, loss):
        self.records += 1
        super().record(step, loss)


def _bitwise(what, want, got) -> None:
    """Fail phase 14, naming the step, unless ``got`` visited ``want``'s
    steps with the same loss bits and mask digests."""
    try:
        want.assert_identical(got)
    except TrajectoryMismatch as e:
        raise AssertionError(f"[launcher] {what}: {e}") from e


def _launcher_run(cfg, ckpt_every, ckpt_dir):
    run = _train_run(cfg, "auto", TRAIN_B, TRAIN_S)
    return dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_every=ckpt_every, checkpoint_dir=ckpt_dir))


def _launcher_layers(root):
    """The deepest LAUNCHER_LAYERS cut whose run-B checkpoints fit on the
    disk under ``root``, its parameter count and the bytes it needs."""
    from repro_torch.config import get_arch
    free = shutil.disk_usage(root).free
    for layers in LAUNCHER_LAYERS:
        cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=layers)
        assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff) == \
            (4096, 32, 128, 11008)
        n = cfg.param_count()
        need = LAUNCHER_CKPTS_ON_DISK * CKPT_BYTES_PER_PARAM * n + 2 ** 31
        if free >= need:
            return cfg, n, need, free
    raise AssertionError(f"[launcher] {free / 2 ** 30:.1f} GiB free under "
                         f"{root}: no cut of {LAUNCHER_LAYERS} layers fits "
                         f"{LAUNCHER_CKPTS_ON_DISK} checkpoints")


def phase_train_launcher(state) -> None:
    """Phase 14: ``launch.train.train`` at llama2-7b's full width (the cut
    depth that fits on the disk), B=2, S=2048, site "qkv", f32, the flash
    kernels, replay: runs A twice uninterrupted under a TrajectoryRecorder
    (they must agree bitwise), run B
    under a ChaosMonkey (mid-forward and mid-backward kills) with its
    step-6 checkpoint write killed; B's loss bits and mask digests against
    A's; then the launcher resumes from B's checkpoint with the same plan
    ("verified", steps 6 and 7 against A's), with site "ffn_up"
    ("recompiled", proven by the counter layer) and with p = 0.2 (must
    raise ContractMismatchError). Every kernel of the path launched in
    the runs; the checkpoint directory is deleted at the end."""
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "launcher_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        _launcher_main_path(state, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _launcher_main_path(state, root) -> None:
    from repro_torch.checkpoint import Checkpointer, ContractMismatchError
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.distributed.chaos import ChaosMonkey, Fault
    from repro_torch.launch import train as launcher
    t_phase = time.perf_counter()
    cfg, n_params, need, free = _launcher_layers(root)
    log(f"[launcher] llama2-7b width x {cfg.n_layers} layers "
        f"({n_params / 1e9:.3f}B params by the config, {CKPT_BYTES_PER_PARAM}"
        f" B a param: {CKPT_BYTES_PER_PARAM * n_params / 1e9:.2f} GB a "
        f"checkpoint): {free / 2 ** 30:.1f} GiB free under build/, run B "
        f"needs "
        f"{need / 2 ** 30:.1f} GiB ({LAUNCHER_CKPTS_ON_DISK} checkpoints); "
        f"tried {LAUNCHER_LAYERS} layers, deepest first")
    steps = LAUNCHER_STEPS
    run = _launcher_run(cfg, steps + 1, os.path.join(root, "a"))
    plan = DropoutPlan(run.dropout)
    h, s = cfg.n_heads, TRAIN_S

    def uninterrupted(tag):
        rec = _CountingRecorder(plan, TRAIN_B, h, s)
        clock = _StepClock()
        ckpt = _TimedCheckpointer(os.path.join(root, tag))
        out = launcher.train(
            dataclasses.replace(run, train=dataclasses.replace(
                run.train, checkpoint_dir=ckpt.directory)), steps,
            device="cuda", checkpointer=ckpt,
            wrap_step=lambda f: clock.wrap_done(rec.wrap_step(f)))
        if out.report.steps_completed != steps or out.report.restarts:
            raise AssertionError(f"[launcher] run {tag}: {out.report}")
        n = sum(t.numel() for t in leaves(out.state["master"]))
        del out
        gc.collect()
        torch.cuda.empty_cache()
        return rec, clock, n

    reset_launch_counts()
    rec_a, clock_a, n_params = uninterrupted("a")
    rec_a2, _, _ = uninterrupted("a2")
    steps_a = [float(t) for t in
               np.diff([0.0] + [t for _, t in clock_a.done])[1:]]
    _bitwise("two uninterrupted runs A", rec_a, rec_a2)
    if not all(np.isfinite(_loss(v)) for v in rec_a.loss_bits.values()):
        raise AssertionError("[launcher] run A: non-finite loss")
    log(f"[launcher] runs A twice, uninterrupted: losses "
        f"{[_loss(rec_a.loss_bits[i]) for i in range(steps)]}; loss bits "
        f"and mask digests bitwise equal; step times "
        f"{[round(t, 4) for t in steps_a]} s | {state['smi']}")

    # run B: the same under faults, one checkpoint write killed
    ckpt_dir_b = os.path.join(root, "b")
    rec_b = _CountingRecorder(plan, TRAIN_B, h, s)
    clock_b = _StepClock()
    monkey = ChaosMonkey([Fault(st, ph) for st, ph in LAUNCHER_FAULTS])
    ckpt_b = _TimedCheckpointer(ckpt_dir_b, kill_steps={LAUNCHER_KILL})
    run_b = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_every=LAUNCHER_CKPT_EVERY,
        checkpoint_dir=ckpt_dir_b))
    t0 = time.perf_counter()
    out_b = launcher.train(
        run_b, steps, device="cuda", checkpointer=ckpt_b,
        wrap_step=lambda f: clock_b.wrap_faults(monkey.wrap_step(
            clock_b.wrap_done(rec_b.wrap_step(f)))))
    wall_b = time.perf_counter() - t0
    rep = out_b.report
    del out_b
    gc.collect()
    torch.cuda.empty_cache()
    if (rep.steps_completed, rep.restarts, rep.failed_saves) != \
            (steps, len(LAUNCHER_FAULTS), 1) or \
            ckpt_b.killed_writes != [LAUNCHER_KILL] or monkey.pending:
        raise AssertionError(f"[launcher] run B: {rep}, killed writes "
                             f"{ckpt_b.killed_writes}, pending faults "
                             f"{monkey.pending}")
    _bitwise("run B against run A", rec_a, rec_b)
    recov = clock_b.recoveries()
    gathers = [round(g, 3) for _, _, g in ckpt_b.saves]
    waits = [round(w, 3) for _, w, _ in ckpt_b.saves]
    log(f"[launcher] run B: {rep.steps_completed} steps, faults "
        f"{monkey.injected}, restarts {rep.restarts}, failed saves "
        f"{rep.failed_saves} (write of step {LAUNCHER_KILL} killed), "
        f"{rec_b.replays} replayed steps, {rec_b.records} step runs of a "
        f"{n_params / 1e9:.3f}B-parameter model in "
        f"{wall_b:.1f} s; loss bits and mask digests bitwise run A's")
    log(f"[launcher] checkpoints ({CKPT_BYTES_PER_PARAM * n_params / 1e9:.2f}"
        f" GB each): host gather {gathers} s, file write "
        f"{[(st, round(w, 3)) for st, w in ckpt_b.writes]} s, a save's wait "
        f"for the previous write {waits} s, so the stall a save adds to its "
        f"step {[round(w + g, 3) for w, g in zip(waits, gathers)]} s; "
        f"restore {[(st, round(r, 3)) for st, r in ckpt_b.restores]} s; time "
        f"to recover (fault to the end of the failed step's re-run) "
        f"{[(st, round(r, 3)) for (st, _), r in zip(clock_b.faults, recov)]}"
        f" s | {state['smi']}")

    # resume through the launcher from B's checkpoint: the same plan
    rec_r = _CountingRecorder(plan, TRAIN_B, h, s)
    ckpt_r = _TimedCheckpointer(ckpt_dir_b)
    out = launcher.train(run_b, steps, device="cuda", checkpointer=ckpt_r,
                         wrap_step=rec_r.wrap_step)
    latest = out.resumed_from
    if out.contract_status != "verified" or latest != 2 * \
            LAUNCHER_CKPT_EVERY or out.report.steps_completed != steps:
        raise AssertionError(f"[launcher] same-plan resume: "
                             f"{out.contract_status} from {latest}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    if sorted(rec_r.loss_bits) != list(range(latest, steps)):
        raise AssertionError(f"[launcher] the resume ran steps "
                             f"{sorted(rec_r.loss_bits)}")
    for i in range(latest, steps):
        if rec_r.loss_bits[i] != rec_a.loss_bits[i] or \
                rec_r.mask_digest[i] != rec_a.mask_digest[i]:
            raise AssertionError(
                f"[launcher] resumed step {i} differs from run A's: loss "
                f"bits {rec_r.loss_bits[i]:#010x} vs "
                f"{rec_a.loss_bits[i]:#010x}, mask digests "
                f"{rec_r.mask_digest[i][:12]} vs {rec_a.mask_digest[i][:12]}")
    counts = launch_counts()
    sched = launcher.compile_run_schedule(cfg, run)
    n_runs = rec_a.records + rec_a2.records + rec_b.records + rec_r.records
    want = _expected_launches(sched, run.sharding.remat, n_runs)
    want[philox.KERNEL] += n_runs            # one digest plane a step run
    if counts != want:
        raise AssertionError(f"[launcher] launches {counts} != {want}")
    state["launcher_launches"] = counts
    log(f"[launcher] resume, same plan: dropout contract verified, from "
        f"step {latest}, steps {latest}..{steps - 1} bitwise run A's; "
        f"restore {[(st, round(r, 3)) for st, r in ckpt_r.restores]} s; "
        f"launches over the {n_runs} step runs "
        f"of A, A, B and the resume {counts} == the schedule's formula (+1 "
        f"Philox plane a step for the recorder's digest)")

    # a changed realization: re-proven by the counter layer
    moved = dataclasses.replace(run_b, dropout=dataclasses.replace(
        run_b.dropout, site="ffn_up"))
    out = launcher.train(moved, latest, device="cuda",
                         checkpointer=Checkpointer(ckpt_dir_b))
    if out.contract_status != "recompiled" or out.report.steps_completed \
            != latest:
        raise AssertionError(f"[launcher] site ffn_up resume: "
                             f"{out.contract_status}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    # the control: a changed p changes the bits and must be refused
    drifted = dataclasses.replace(run_b, dropout=dataclasses.replace(
        run_b.dropout, p=0.2))
    try:
        launcher.train(drifted, latest, device="cuda",
                       checkpointer=Checkpointer(ckpt_dir_b))
    except ContractMismatchError as e:
        refused = str(e).splitlines()[1].strip()
    else:
        raise AssertionError("[launcher] a resume with p=0.2 was not "
                             "refused")
    log(f"[launcher] resume with site ffn_up: recompiled (the counter layer "
        f"proved the new schedule); with p=0.2: ContractMismatchError "
        f"({refused}); phase {time.perf_counter() - t_phase:.1f} s")
    state["train_launcher"] = dict(
        layers=cfg.n_layers, params=n_params,
        step_s=float(np.mean(steps_a[1:])), gather_s=gathers,
        write_s=[w for _, w in ckpt_b.writes],
        restore_s=[r for _, r in ckpt_b.restores], recover_s=recov)


# ------------------------------------------------------------------ phase 15
# the search's cell: llama2-7b's QKV host at bf16 on the training plane
AUTO_SEARCH_DTYPE = "bf16"
AUTO_STEPS = 3
AUTO_DEVICE = "cuda"


def _flash_operand_digests(log_to: list):
    """A wrapper of ``models.attention.flash_attention_mosaic`` that
    appends, a call, the digest of the dropout operands the flash kernels
    get: the plane's bytes under premask, the seed-salt words under replay
    (``log_to``). Returns (install, restore)."""
    import hashlib

    from repro_torch.models import attention
    orig = attention.flash_attention_mosaic

    def wrapped(q, k, v, mask_packed=None, causal=True, local_window=0,
                dropout_p=0.0, mode="none", seed=0, salt=0, rounds=7,
                heads_global=0):
        if mode == "premask":
            data = mask_packed.contiguous().cpu().numpy().tobytes()
        else:
            data = repr((mode, philox_common.seed_salt_words(seed, salt),
                         float(dropout_p))).encode()
        log_to.append((mode, hashlib.sha256(data).hexdigest()[:16]))
        return orig(q, k, v, mask_packed, causal, local_window, dropout_p,
                    mode, seed, salt, rounds, heads_global)

    def install():
        attention.flash_attention_mosaic = wrapped

    def restore():
        attention.flash_attention_mosaic = orig
    return install, restore


def _auto_trajectory(cfg, site, st0, batches):
    """AUTO_STEPS replay steps from ``st0`` and step 0 again under premask
    at ``site``: each step's loss bits, the digests of the flash kernels'
    dropout operands, the resolved site and the step times."""
    from repro_torch.train import compile_run_schedule, make_train_step
    out = {"loss_bits": [], "digests": [], "times": []}
    digests = []
    install, restore = _flash_operand_digests(digests)
    install()
    try:
        for replay, steps in (("auto", AUTO_STEPS), ("off", 1)):
            run = _train_run(cfg, replay, TRAIN_B, TRAIN_S, site=site)
            sched = compile_run_schedule(cfg, run)
            out.setdefault("resolved", []).append(sched.resolved_site)
            step = make_train_step(cfg, run)
            st = st0
            for i in range(steps):
                digests.clear()
                t0 = time.perf_counter()
                st, m = step(st, *batches[i])
                torch.cuda.synchronize()
                out["times"].append(time.perf_counter() - t0)
                out["loss_bits"].append(int(np.float32(float(
                    m["loss"])).view(np.uint32)))
                out["digests"].append(tuple(digests))
            del st
    finally:
        restore()
    return out


def phase_train_auto(state) -> None:
    """site="auto" on the card, with the perf model calibrated there:
    (a) every host cell's (plain GEMM, standalone Philox, fused GEMM+RNG)
    triple timed in turns (``tune/calibrate.py``: llama2-7b's four host
    GEMMs and moonshot's grouped gate at B=2, S=2048, f32 and bf16) and
    the model fitted to them, one fit a host dtype, each of which must
    beat the closed-form GH100 constants; per cell the closed-form and
    calibrated predictions beside the measured time; (b) the gated search on llama2-7b's QKV host at
    bf16: philox_bits=8 must die at the mask-bit gate and a candidate must
    pass all four gates; (c) site="auto" at llama2-7b width x 4 resolved
    under the closed-form GH100 and under the calibrated table (the
    search's blocks in it): for each resolved site, 3 replay steps and
    step 0 again under premask, their loss bits and the flash kernels'
    dropout operands (plane digests, seed-salt words) bitwise those of the
    same steps with the site fixed; (d) the Layer-2 walk of that step at
    full width, on fake tensors, under replay and premask: clean, no
    kernel launched, and the leaky mutant flagged MS-D1. No kernel is
    added: every kernel here is held against its plain version in phase
    2."""
    from repro_torch.analysis import dataflow, rules
    from repro_torch.config import get_arch
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.train import init_train_state
    from repro_torch.tune import calibrate, search
    from repro_torch.tune.tables import TunedTable, overlay
    t_phase = time.perf_counter()
    rec = state.setdefault("train_auto", {})
    smi = state["smi"]
    # (a) calibration: one fit a host dtype
    t0 = time.perf_counter()
    ms = calibrate.measure_cells(("f32", "bf16"), repeats=5)
    cals = calibrate.fit_by_dtype(ms, calibrate.card_source(len(ms)))
    rows = calibrate.residual_rows_by_dtype(ms, cals)
    for r in rows:
        m = r["measurement"]
        log(f"[auto] calibration {r['arch']} {r['site']}/{r['dtype']}: "
            f"measured fused {r['measured_s'] * 1e3:.4f} ms (plain GEMM "
            f"{m['t_dot'] * 1e3:.4f}, Philox {m['t_rng'] * 1e3:.4f}), "
            f"GH100 closed form {r['pred_closed_form_s'] * 1e3:.4f} ms, "
            f"calibrated {r['pred_calibrated_s'] * 1e3:.4f} ms | {smi}")
    for dtype, cal in sorted(cals.items()):
        log(f"[auto] {dtype} fit: mean relative error "
            f"{cal.residual_closed_form:.4f} (GH100) -> "
            f"{cal.residual_calibrated:.4f} (calibrated) over "
            f"{cal.n_cells} cells; mma {cal.mma_flops:.4g} flop/s, hbm "
            f"{cal.hbm_bw:.4g} B/s, non-mma {cal.nonmma_ops:.4g} op/s, "
            f"rng interference {cal.rng_interference:.4g}, gemm "
            f"interference {cal.gemm_interference:.4g}, step "
            f"{cal.step_overhead:.4g} s")
        if not cal.residual_calibrated < cal.residual_closed_form:
            raise AssertionError(f"[auto] the {dtype} calibration does not "
                                 "beat the closed-form GH100 model")
    log(f"[auto] calibration {time.perf_counter() - t0:.1f} s")
    rec["calibration"] = dict(
        {d: c.to_json() for d, c in cals.items()},
        rows=[{k: v for k, v in r.items() if k != "measurement"}
              for r in rows])
    # (b) the gated search on one cell
    t0 = time.perf_counter()
    full = get_arch("llama2-7b")
    mask = (TRAIN_B, full.n_heads, TRAIN_S, TRAIN_S)
    gemm = producer.block_gemm_shapes(full, TRAIN_B, TRAIN_S)["qkv"]
    tuning = search.tune_cell("llama2-7b", "qkv", gemm, mask,
                              cals[AUTO_SEARCH_DTYPE].hardware(),
                              dtype=AUTO_SEARCH_DTYPE, device=AUTO_DEVICE,
                              max_gate_runs=8)
    log(f"[auto] search llama2-7b qkv/{AUTO_SEARCH_DTYPE} {gemm} on "
        f"{mask}: default {tuning.default} (score "
        f"{tuning.score_default:.6g} s) -> {tuning.tuned} (score "
        f"{tuning.score_tuned:.6g} s); taken {tuning.accepted}, admitted "
        f"{tuning.admitted}, gate-rejected {tuning.rejected} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not any(".pb8" in c and g == "mask_bits" for c, g in tuning.rejected):
        raise AssertionError("[auto] philox_bits=8 did not die at the "
                             "mask-bit gate")
    if not tuning.admitted:
        raise AssertionError("[auto] no candidate passed the four gates")
    table = TunedTable(calibrations=cals, gemm_blocks=(
        {gemm: tuning.tuned.blocks} if tuning.tuned != tuning.default
        else {}), mask_cols=({(TRAIN_S, TRAIN_S): tuning.tuned.mask_cols}
                             if tuning.tuned != tuning.default else {}))
    os.makedirs("build", exist_ok=True)
    table.save(os.path.join("build", "chip_smoke_TUNED_torch.json"))
    rec["search"] = dict(accepted=tuning.accepted, admitted=tuning.admitted,
                         rejected=tuning.rejected)
    # (c) site="auto" at width, under each model, against the fixed site
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    plan = DropoutPlanConfig(mode="overlap", p=0.1, site="auto")
    picks = {}
    for label, tbl in (("GH100", None), ("calibrated", table)):
        with overlay(tbl):
            ranked = producer.rank_host_sites(cfg, DropoutPlan(plan),
                                              TRAIN_B, TRAIN_S)
        picks[label] = ranked[0][0]
        log(f"[auto] llama2-7b x{TRAIN_LAYERS} B={TRAIN_B} S={TRAIN_S} "
            f"site=auto under {label}: {picks[label]} (ranking "
            f"{[(s_, f'{v * 1e6:+.2f}us') for s_, v in ranked]})")
    measured = calibrate.measured_site_costs(
        [m for m in ms if m.arch == "llama2-7b"], "f32")
    best = min(measured, key=measured.get)[1]
    costs = [(s_, round(v * 1e3, 4)) for (_, s_), v in measured.items()]
    verdict = "agrees" if best == picks["calibrated"] else "disagrees"
    log(f"[auto] measured added cost of hosting at f32 (fused - plain "
        f"GEMM): {costs} ms: cheapest {best}; the calibrated model picks "
        f"{picks['calibrated']} ({verdict})")
    rec["picks"] = dict(picks, measured=best)
    st0 = init_train_state(cfg, seed=0, device=AUTO_DEVICE)
    batches = _batches(cfg, _train_run(cfg, "auto", TRAIN_B, TRAIN_S),
                       AUTO_DEVICE, AUTO_STEPS)
    for label, tbl in (("GH100", None), ("calibrated", table)):
        site = picks[label]
        with overlay(tbl):
            auto = _auto_trajectory(cfg, "auto", st0, batches)
            fixed = _auto_trajectory(cfg, site, st0, batches)
        if auto["resolved"] != [site, site]:
            raise AssertionError(f"[auto] {label}: resolved "
                                 f"{auto['resolved']}, ranked {site}")
        if (auto["loss_bits"], auto["digests"]) != (fixed["loss_bits"],
                                                    fixed["digests"]):
            raise AssertionError(f"[auto] {label}: site=auto's steps differ "
                                 f"from {site}'s: {auto['loss_bits']} vs "
                                 f"{fixed['loss_bits']}")
        if auto["loss_bits"][0] != auto["loss_bits"][AUTO_STEPS]:
            raise AssertionError(f"[auto] {label}: replay and premask step "
                                 f"0 differ")
        rec[f"steps_{label}"] = dict(site=site, auto_s=auto["times"],
                                     fixed_s=fixed["times"])
        log(f"[auto] {label} -> {site}: {AUTO_STEPS} replay steps and "
            f"premask step 0, loss bits {[hex(b) for b in auto['loss_bits']]}"
            f" and {sum(len(d) for d in auto['digests'])} flash operand "
            f"digests bitwise the fixed site's; step s auto "
            f"{[round(t, 4) for t in auto['times']]}, fixed "
            f"{[round(t, 4) for t in fixed['times']]} | {smi}")
    del st0, batches
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the Layer-2 walk of that step at full width, fake tensors
    reset_launch_counts()
    with overlay(table):
        for replay in ("auto", "off"):
            tm = {}
            rep = dataflow.analyze_model(
                cfg, dataclasses.replace(plan, attn_replay=replay), TRAIN_B,
                TRAIN_S, device=AUTO_DEVICE, timings=tm,
                cell=f"llama2-7b x{TRAIN_LAYERS} site=auto replay={replay}")
            if not rep.ok:
                raise AssertionError(rep.render())
            log(f"[auto] Layer 2 at full width, {rep.cell}: clean; forward "
                f"{tm['fwd_nodes']} nodes traced in {tm['fwd_trace_s']:.2f} "
                f"s, walked in {tm['fwd_walk_s']:.3f} s; grad "
                f"{tm['grad_nodes']} nodes in {tm['grad_trace_s']:.2f} s, "
                f"walked in {tm['grad_walk_s']:.3f} s")
            rec[f"layer2_{replay}"] = tm
        leak = dataflow.analyze_leaky_model(cfg, plan, TRAIN_B, TRAIN_S,
                                            device=AUTO_DEVICE)
    if [f.rule for f in leak.findings] != [rules.MASK_RESIDUAL_LEAK]:
        raise AssertionError(f"[auto] the leaky mutant: {leak.render()}")
    if any(launch_counts().values()):
        raise AssertionError(f"[auto] a kernel launched during the walk: "
                             f"{launch_counts()}")
    log(f"[auto] the leaky mutant at full width flagged "
        f"{leak.findings[0].rule}; no kernel launched during the walks; "
        f"phase {time.perf_counter() - t_phase:.1f} s")


MULTIRANK_BASE = dict(arch="llama2-7b", layers=2, batch=2, seq=2048, p=0.1,
                      seed=3, device="cuda", steps=2)
MULTIRANK_RUNS = (
    ("tp/f32", ((2,), ("model",)), dict(site="qkv", replay="auto",
                                        compute="f32", gemm_dtype="f32")),
    ("tp/bf16", ((2,), ("model",)), dict(site="qkv", replay="auto",
                                         compute="bf16", gemm_dtype="bf16")),
    ("dp/f32", ((2,), ("data",)), dict(site="prev_gemm", replay="off",
                                       compute="f32", gemm_dtype="f32")),
)
MULTIRANK_MOE = dict(arch="moonshot-v1-16b-a3b", layers=2, batch=2,
                     seq=2048, p=0.1, seed=3, device="cuda", site="ffn_up",
                     replay="off", gemm_dtype="f32", steps=1,
                     mesh=((2,), ("data",)))
# loss, grad norm (relative); the bf16 limit between the clean run's gap
# (1.75e-5) and the smallest a planted dropout fault gives (1.6e-4;
# scripts/probe_multirank_faults.py)
MULTIRANK_TOL = {"f32": 2e-5, "bf16": 5e-5}
MOE_Y_TOL, MOE_AUX_TOL = 2e-4, 0.1
MULTIRANK_DEADLINE_S = 150


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _merge(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + counts.get(k, 0)
            for k in set(total) | set(counts)}


def _check_operands(tag, r, ref=None) -> None:
    """Every flash call's dropout operand the one its place in the run's
    order names (``multirank.check_operands``), and, given the
    single-device run ``ref``, the same dropout modes in the same order."""
    consumed, expected, bad = r["operands"]
    if bad or consumed == 0:
        raise AssertionError(f"{tag} rank {r['rank']}: {consumed} dropout "
                             f"operands read, {expected} expected, at the "
                             f"wrong place (index, (step, layer, pass), "
                             f"mode, digest): {bad[:3]}")
    if ref is not None and r["modes"] != ref["modes"]:
        raise AssertionError(f"{tag} rank {r['rank']}: dropout modes "
                             f"{r['modes']}, one device {ref['modes']}")


def phase_multirank(state) -> None:
    """Phase 16: sharded training and the MoE dispatch on two gloo ranks
    sharing the card, then one NCCL rank (module docstring)."""
    from repro_torch.launch import multirank
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    smi = state["smi"]
    refs = {}
    for tag, _mesh, kw in MULTIRANK_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        refs[tag] = multirank.train_job(
            0, 1, dict(MULTIRANK_BASE, **kw, mesh=None))
        _check_operands(f"[multirank] {tag} one device", refs[tag])
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[multirank] single-device references in "
        f"{time.perf_counter() - t0:.1f}s")
    items = [("train", dict(MULTIRANK_BASE, **kw, mesh=mesh))
             for _tag, mesh, kw in MULTIRANK_RUNS]
    items += [("train", MULTIRANK_MOE), ("moe", MULTIRANK_MOE)]
    # (d) one NCCL rank on a (model=1) mesh, beside the gloo ranks' first
    # (smallest) runs: the process group and the DeviceMesh on NCCL
    nccl = {}

    def _nccl():
        job = dict(MULTIRANK_BASE, **MULTIRANK_RUNS[0][2], steps=1,
                   mesh=((1,), ("model",)))
        try:
            nccl["res"] = run_ranks(multirank.train_job, 1, (job,),
                                    backend="nccl", deadline_s=90,
                                    timeout_s=60)
        except BaseException as e:          # raised after the join
            nccl["err"] = e

    thread = threading.Thread(target=_nccl)
    thread.start()
    res = run_ranks(multirank.jobs, 2, (items,), backend="gloo",
                    deadline_s=MULTIRANK_DEADLINE_S, timeout_s=60)
    thread.join()
    if "err" in nccl:
        raise nccl["err"]
    log(f"[multirank] two gloo ranks and the NCCL rank done at "
        f"{time.perf_counter() - t0:.1f}s")
    launches = {}
    note = ("two ranks sharing one card through gloo on the host (not "
            "NCCL; not a scaling measurement)")
    for i, (tag, mesh, kw) in enumerate(MULTIRANK_RUNS):
        tol = MULTIRANK_TOL[kw["compute"]]
        ref = refs[tag]
        for rank_res in res:
            r = rank_res[i]
            _check_operands(f"[multirank] {tag}", r, ref)
            for key in ("losses", "grad_norms"):
                errs = [_rel(a, b) for a, b in zip(r[key], ref[key])]
                if max(errs) > tol:
                    raise AssertionError(
                        f"[multirank] {tag} rank {r['rank']} {key} "
                        f"{r[key]} vs one device {ref[key]}: {errs} > {tol}")
            launches = _merge(launches, r["launches"])
        r0 = res[0][i]
        log(f"[multirank] {tag} mesh {dict(zip(mesh[1], mesh[0]))} site "
            f"{kw['site']} ({'replay' if kw['replay'] == 'auto' else 'premask'}"
            f"): losses {r0['losses']} (one device {ref['losses']}), grad "
            f"norms {r0['grad_norms']} (one device {ref['grad_norms']}), "
            f"within {tol} relative; {r0['operands'][0]} dropout operands a "
            f"rank, each in turn its (step, layer)'s window "
            f"{[x[i]['window'] for x in res]} tile / word bitwise, the modes "
            f"one device's")
        log(f"[multirank] {tag} step times {[round(t, 4) for t in r0['step_s']]}"
            f" s (rank 0; {note}); one device "
            f"{[round(t, 4) for t in ref['step_s']]} s; the run with its "
            f"set-up {r0['job_s']:.1f} s | {smi}")
    n = len(MULTIRANK_RUNS)
    for rank_res in res:
        mt, mo = rank_res[n], rank_res[n + 1]
        if not all(np.isfinite(v) for v in mt["losses"] + mt["grad_norms"]):
            raise AssertionError(f"[multirank] moe step not finite: {mt}")
        if (MULTIRANK_MOE["device"] == "cuda"
                and mt["launches"][gemm_rng.KERNEL_GROUPED] == 0):
            raise AssertionError("[multirank] moe step launched no grouped "
                                 "host")
        _check_operands("[multirank] moe", mt)
        launches = _merge(launches, mt["launches"])
        if not (mo["y_err"] <= MOE_Y_TOL and mo["gx_err"] <= MOE_Y_TOL
                and max(mo["gw_err"].values()) <= MOE_Y_TOL
                and abs(mo["aux"] - mo["aux_ref"]) <= MOE_AUX_TOL
                and mo["tile_ok"]):
            raise AssertionError(f"[multirank] moe layer rank {mo['rank']}:"
                                 f" {mo}")
    mt, mo = res[0][n], res[0][n + 1]
    log(f"[multirank] moe {MULTIRANK_MOE['arch']} x{MULTIRANK_MOE['layers']}"
        f" (data=2) ffn_up/f32: loss {mt['losses']}, grad norm "
        f"{mt['grad_norms']}, step {[round(t, 4) for t in mt['step_s']]} s "
        f"({note}); {mt['operands'][0]} dropout operands a rank, each the "
        f"one its place names; its MoE layer through {mo['how']}: y "
        f"{mo['y_err']:.3g}, the x gradient {mo['gx_err']:.3g} and the "
        f"weight gradients "
        f"{ {k: float(f'{v:.3g}') for k, v in mo['gw_err'].items()} } "
        f"(over their largest entry) from the single-device layer on each "
        f"source's tokens, within {MOE_Y_TOL}; aux {mo['aux']:.6f} vs "
        f"{mo['aux_ref']:.6f}, the hosted tile bitwise; forward + backward "
        f"{mo['step_s']:.4f} s | {smi}")
    (nr,) = nccl["res"]
    _check_operands("[multirank] nccl", nr)
    if _rel(nr["losses"][0], refs["tp/f32"]["losses"][0]) > 2e-5:
        raise AssertionError(f"[multirank] nccl loss {nr['losses']} vs "
                             f"{refs['tp/f32']['losses']}")
    launches = _merge(launches, nr["launches"])
    state["multirank_launches"] = launches
    log(f"[multirank] one NCCL rank on (model=1): loss {nr['losses'][0]} "
        f"== one device's within 2e-5, step {nr['step_s'][0]:.4f} s (its "
        f"first, beside the gloo ranks) | {smi}")
    log(f"[multirank] launches over every rank and run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[multirank] phase 16 in {time.perf_counter() - t0:.1f}s")


def kernel_records(state):
    """One record a TPU kernel instance (each function that reaches
    pl.pallas_call, at each operand dtype the port runs), in the order of
    their table in PERF.md. ``launches`` counts the run of the path that
    drives the kernel: serving (1), the qkv/f32 main run (2-6), the
    ffn_up/fp8 main run (7, 8), the moonshot ffn_up/f32 step (9), the
    moonshot ffn_up/fp8 main run (10, 11), the qkv/bf16 main run at
    compute_dtype=bf16 (the bf16 instances of 2-6), recurrentgemma's main
    runs at bf16 and f32 compute (the D = 256 instances of 4-6 at each
    dtype), the moonshot
    ffn_up/bf16 main run at compute_dtype=bf16 (the bf16 instances of 9
    and 10) and its ffn_up/fp8 step (the bf16-C instances of 7, 8 and 11).
    The emission-off variants (3, 8, 10 and their bf16 instances) run only
    in Region 3, which none of these paths plans: their launches are 0
    there, and phase 2 launches and checks them directly. Rows 1, 2, 4, 5
    and 6 also carry ``launches_launcher``: their launches in phase 14's
    runs of the training launcher; rows 1, 2, 4-6, 9 and the bf16 2, 4-6
    carry ``launches_multirank``: phase 16's, over every rank."""
    t, errs = state["timing"], state["errs"]
    g = "src/repro/kernels/gemm_rng.py"
    k32, k8 = gemm_rng.KERNEL, gemm_rng.KERNEL_FP8
    g32, g8 = gemm_rng.KERNEL_GROUPED, gemm_rng.KERNEL_GROUPED_FP8
    k16 = gemm_rng.KERNEL_BF16
    g16 = gemm_rng.KERNEL_GROUPED_BF16
    k8b, g8b = gemm_rng.KERNEL_FP8_BF16, gemm_rng.KERNEL_GROUPED_FP8_BF16
    moe_f32 = state["moe_site_steps"]["ffn_up/f32"]["launches"]
    l16 = state["bf16_launches"]
    moe_fp8b = state["moe_bf16_site_steps"]["ffn_up/fp8"]

    def variant(row):
        return dict(ms=row["plain_variant_ms"],
                    plain_ms=row["plain_variant_plain_ms"],
                    bound_ms=row["plain_variant_bound_ms"],
                    bound_by=row["plain_variant_bound_by"],
                    library_ms=row["library_ms"])

    fused = state["train_fused"]

    def modes(name):
        # the launches of a fused step of llama2 x 4 at the kernel's dtype
        dname = "bfloat16" if name.endswith("bf16") else "float32"
        return {"modes_ms": t[name]["modes_ms"], "fused_step_launches":
                fused[dname]["fused"]["launches"].get(name, 0)}

    def f32_extras(row):
        # rows 2, 3, 9, 10: the tensor-core body they instantiate
        out = {"body": "src/repro_torch/kernels/csrc/gemm_tc.cuh (F32Ops)"}
        if "shape" in row:
            out["shape"] = row["shape"]
        return out

    def bf16_extras(row):
        # rows 2b, 9b: the persistent body and the paper's sequential
        # yardstick (the library call, then the standalone Philox kernel
        # for the same plane)
        return dict(shape=row["shape"], sequential_ms=row["sequential_ms"],
                    body="src/repro_torch/kernels/csrc/gemm_bf16.cuh")

    def fp8_extras(row):
        return dict(shape=row["shape"], scaled_mm_ms=row["scaled_mm_ms"],
                    dequant_matmul_ms=row["dequant_matmul_ms"])

    rows = [
        (philox.KERNEL, "philox_mask.cu", "src/repro/kernels/philox.py:40",
         "serve", state["philox_launches"], state["philox_err"],
         dict(state["philox_timing"]["serve"], library_ms=None),
         {"planes_ms": {label: row["ms"] for label, row
                        in state["philox_timing"].items()}}),
        (k32, "gemm_rng.cu", f"{g}:143", "train",
         state["train_launches"][k32], errs[k32], t[k32],
         f32_extras(t[k32])),
        (f"{k32}_plain", "gemm_rng.cu", f"{g}:304", "train",
         state["gemm_variants"]["plain"], errs[k32], variant(t[k32]),
         f32_extras(t[k32])),
        (flash.KERNEL, "flash_fwd_f32.cu",
         "src/repro/kernels/flash_attention.py:58", "train",
         state["train_launches"][flash.KERNEL], errs[flash.KERNEL],
         t[flash.KERNEL], modes(flash.KERNEL)),
        (flash_bwd.KERNEL_DQ, "flash_dq_f32.cu",
         "src/repro/kernels/flash_attention_bwd.py:77", "train",
         state["train_launches"][flash_bwd.KERNEL_DQ],
         errs[flash_bwd.KERNEL_DQ], t[flash_bwd.KERNEL_DQ],
         modes(flash_bwd.KERNEL_DQ)),
        (flash_bwd.KERNEL_DKV, "flash_dkv_f32.cu",
         "src/repro/kernels/flash_attention_bwd.py:137", "train",
         state["train_launches"][flash_bwd.KERNEL_DKV],
         errs[flash_bwd.KERNEL_DKV], t[flash_bwd.KERNEL_DKV],
         modes(flash_bwd.KERNEL_DKV)),
        (k8, "gemm_rng_fp8.cu", f"{g}:373", "train_fp8",
         state["fp8_launches"][k8], errs[k8], t[k8], fp8_extras(t[k8])),
        (f"{k8}_plain", "gemm_rng_fp8.cu", f"{g}:933", "train_fp8",
         state["fp8_variants"]["plain"], errs[k8],
         dict(variant(t[k8]), library_ms=None), fp8_extras(t[k8])),
        (g32, "gemm_rng_grouped.cu", f"{g}:551", "train_moe_f32",
         moe_f32[g32], errs[g32], t[g32], f32_extras(t[g32])),
        (f"{g32}_plain", "gemm_rng_grouped.cu", f"{g}:711", "train_moe",
         state["moe_variants"]["plain"], errs[g32], variant(t[g32]),
         f32_extras(t[g32])),
        (g8, "gemm_rng_grouped_fp8.cu", f"{g}:764", "train_moe",
         state["moe_launches"][g8], errs[g8], t[g8], fp8_extras(t[g8])),
        (k16, "gemm_rng_bf16.cu", f"{g}:143", "train_bf16", l16[k16],
         errs[k16], t[k16], bf16_extras(t[k16])),
        (f"{k16}_plain", "gemm_rng_bf16.cu", f"{g}:304", "train_bf16",
         state["bf16_variants"]["plain"], errs[k16], variant(t[k16]),
         {"shape": t[k16]["shape"]}),
        (flash.KERNEL_BF16, "flash_fwd_bf16.cu",
         "src/repro/kernels/flash_attention.py:58", "train_bf16",
         l16[flash.KERNEL_BF16], errs[flash.KERNEL_BF16],
         t[flash.KERNEL_BF16], modes(flash.KERNEL_BF16)),
        (flash_bwd.KERNEL_DQ_BF16, "flash_dq_bf16.cu",
         "src/repro/kernels/flash_attention_bwd.py:77", "train_bf16",
         l16[flash_bwd.KERNEL_DQ_BF16], errs[flash_bwd.KERNEL_DQ_BF16],
         t[flash_bwd.KERNEL_DQ_BF16], modes(flash_bwd.KERNEL_DQ_BF16)),
        (flash_bwd.KERNEL_DKV_BF16, "flash_dkv_bf16.cu",
         "src/repro/kernels/flash_attention_bwd.py:137", "train_bf16",
         l16[flash_bwd.KERNEL_DKV_BF16], errs[flash_bwd.KERNEL_DKV_BF16],
         t[flash_bwd.KERNEL_DKV_BF16], modes(flash_bwd.KERNEL_DKV_BF16)),
        *((flash.instance(n, 256),
           f"{flash.SOURCES.get(n) or flash_bwd.SOURCES[n]}.cu",
           replaces, path,
           state[path]["launches"][flash.instance(n, 256)],
           errs[flash.instance(n, 256)], t[flash.instance(n, 256)],
           {"modes_ms": t[flash.instance(n, 256)]["modes_ms"],
            "shape": list(WIDE_SHAPE), "local_window": WIDE_CASES[-1][1]})
          for dtype, path in ((torch.bfloat16, "train_griffin"),
                              (torch.float32, "train_griffin_f32"))
          for n, replaces in zip(
              (flash.KERNELS[dtype], *flash_bwd.KERNELS[dtype]),
              ("src/repro/kernels/flash_attention.py:58",
               "src/repro/kernels/flash_attention_bwd.py:77",
               "src/repro/kernels/flash_attention_bwd.py:137"))),
        (g16, "gemm_rng_grouped_bf16.cu", f"{g}:551", "train_moe_bf16",
         state["moe_bf16_launches"][g16], errs[g16], t[g16],
         bf16_extras(t[g16])),
        (f"{g16}_plain", "gemm_rng_grouped_bf16.cu", f"{g}:711",
         "train_moe_bf16", state["moe_bf16_variants"]["plain"], errs[g16],
         variant(t[g16]), {"shape": t[g16]["shape"]}),
        (k8b, "gemm_rng_fp8.cu", f"{g}:373", "train_moe_bf16_fp8",
         moe_fp8b["launches"][k8b], errs[k8b], t[k8b],
         {"shape": t[k8b]["shape"]}),
        (f"{k8b}_plain", "gemm_rng_fp8.cu", f"{g}:933", "train_moe_bf16_fp8",
         moe_fp8b["plain_launches"][k8b], errs[k8b],
         dict(variant(t[k8b]), library_ms=None),
         {"shape": t[k8b]["shape"]}),
        (g8b, "gemm_rng_grouped_fp8.cu", f"{g}:764", "train_moe_bf16_fp8",
         moe_fp8b["launches"][g8b], errs[g8b], t[g8b],
         {"shape": t[g8b]["shape"]}),
    ]
    # phase 14 drives rows 1, 2, 4, 5 and 6 again, through the launcher
    for i, row in enumerate(rows):
        if row[0] in state["launcher_launches"] and row[0] in (
                philox.KERNEL, k32, flash.KERNEL, flash_bwd.KERNEL_DQ,
                flash_bwd.KERNEL_DKV):
            rows[i] = row[:7] + ({**row[7], "launches_launcher":
                                  state["launcher_launches"][row[0]]},)
    # phase 16 drives rows 1, 2, 4-6 and 9 (and 2b, 4b-6b) shard-local
    for i, row in enumerate(rows):
        if row[0] in state["multirank_launches"] and row[0] in (
                philox.KERNEL, k32, flash.KERNEL, flash_bwd.KERNEL_DQ,
                flash_bwd.KERNEL_DKV, g32, k16, flash.KERNEL_BF16,
                flash_bwd.KERNEL_DQ_BF16, flash_bwd.KERNEL_DKV_BF16):
            rows[i] = row[:7] + ({**row[7], "launches_multirank":
                                  state["multirank_launches"][row[0]]},)
    recs = []
    for name, src, replaces, path, launches, err, tm, extra in rows:
        recs.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": tm["ms"],
                     "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                     "bound_by": tm["bound_by"],
                     "library_ms": tm["library_ms"], "path": path, **extra})
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    state = {"philox_err": 0}
    t0 = time.perf_counter()
    for phase in (phase_card, phase_build, phase_kernels,
                  phase_kernels_train, phase_kernels_fp8,
                  phase_kernels_grouped, phase_kernels_bf16,
                  phase_kernels_grouped_bf16, phase_serve_reference,
                  phase_serve, phase_train_reference, phase_train,
                  phase_train_sites, phase_train_moe, phase_train_bf16,
                  phase_train_moe_bf16, phase_train_fused,
                  phase_train_griffin, phase_train_griffin_f32,
                  phase_serve_layers, phase_train_launcher,
                  phase_train_auto, phase_multirank):
        phase(state)
        log(f"[time] {phase.__name__} done at "
            f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernel_records(state)}))
    print(state["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
