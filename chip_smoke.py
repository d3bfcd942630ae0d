#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line); each prints its seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the hand-written CUDA kernels from ``horovod_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together); none of the 76 Hopper
   instances (the bf16 and float16 forward, dQ, dK/dV, single-tile
   forward and fused backward at D=16, 32, 64, 128, the forward, dQ and
   dK/dV at D=256, the wide-head forward, dQ and dK/dV, and the bf16 and
   float16 filter gradient on wgmma; in 3xTF32 on mma.sync the float32
   forward, dQ and dK/dV at D=32 to 256, the single-tile forward and
   fused backward at D=32 to 128, the wide-head forward, dQ and dK/dV and
   the filter gradient) may spill or have its wgmma serialized;
3. kernel phase: every kernel against its plain PyTorch version on the same
   inputs, with times beside the bound and the library yardstick:
   - the multi-tile forward, dQ and dK/dV flash-attention kernels
     (BERT-Large S=512 shape in bf16 and in float16; a causal, ragged,
     offset case with fully masked rows and a nonzero lse cotangent at
     D=64 in bf16 and float16, and in bf16 at D=128, D=16 and D=96, which
     is zero-padded to the D=128 instance; a causal D=32 case with a query
     offset; float32 cases at D=64 and D=128; B*H = 65,600 at S=129, past
     the grid's 65,535 (the persistent kernels walk the work tiles; float32
     D=16 zero-padded to 32), in float32 and bf16);
   - the single-tile forward and fused backward (BERT-Large phase-1 shape,
     S=128, in bf16 and in float16; causal 96 x 128 with offsets, masked
     rows and a nonzero lse cotangent; float32 causal with an offset at
     D=64 and D=128; bf16 at D=128; causal bf16 at D=16 and D=32; a causal
     ragged 77 x 100 case with a key offset at D=64 and at D=48, padded to
     the D=64 instance; B*H = 65,600 at S=16 in float32 and bf16; the
     float32 fused backward (3xTF32) causal and ragged with an lse
     cotangent at D=64 and D=128, each output's error against float64,
     over ``F64_DRAWS`` draws of the inputs, held to ``F64_ERR_RATIO``
     times the float32 plain version's);
   - the multi-tile kernels at head dim 256: a Gemma-like layer (B*H =
     128, S=512) in bf16 (timed beside SDPA), float16 and float32; S=128
     with B*H = 1024 (the multi-tile route: no single-tile kernel has a
     D=256 instance); D=200, zero-padded to 256, causal and ragged; the
     Gemma-like layer in full float32, non-causal, timed beside the float32
     SDPA forward and backward with both bounds of the 3xTF32 forward, dQ
     and dK/dV (FMA and TF32), and each kernel's largest error against a
     float64 version of the function (O and lse; dQ, dK, dV) beside the
     float32 plain version's and SDPA's (at most ``F64_ERR_RATIO`` times the
     plain version's); the same for the 3xTF32 forward, dQ and dK/dV at
     BERT-Large's S=512 shape (B*H = 128, D=64) and the single-tile forward
     at its S=128 shape (B*H = 1024), in full float32, where the fused
     backward, timed beside SDPA's float32 backward, also has its float64
     check and flash_dq + flash_dkv are timed on the same inputs;
   - the calls with nothing to compute: no key (Sk=0) and no query (Sq=0)
     on each route (single-tile, multi-tile, wide) in bf16, float16 and
     float32, each output equal to its plain version's (O = 0 and lse =
     ``LSE_MASKED`` with no key, dQ = 0; dK = dV = 0 with no query);
   - the 1x1-conv filter gradient (ResNet-50 stage-1 bottleneck 64 -> 256
     in bf16 and float16; the stride-2 projection shortcut 256 -> 512,
     timed beside its own cuBLAS call; bf16 with a ragged K and ragged
     channel tiles; bf16 on a stride-2 view with an odd H; bf16 with
     3 -> 12 channels, zero-padded to whole 16-byte rows; a stride-2 view
     whose rows are 300 wide, past a TMA box; float32 with a ragged K; the
     two ResNet-50 shapes in full float32 (3xTF32), timed beside cuBLAS's
     float32 x^T dy with TF32 off, with both bounds (TF32 and FMA) and the
     error against float64 held to ``F64_ERR_RATIO`` times the float32
     plain version's); two calls on the same inputs must agree bit for bit;
4. wide-heads phase: causal bf16 attention layers at D=256 (S=512 and
   S=128) through ``flash_attention_lse``, forward and backward: the
   launch counters show the D=256 forward, dQ and dK/dV ran once per layer
   and no other kernel did; the same for float32 layers at the Gemma-like
   shape and at BERT-Large's S=512 shape (the 3xTF32 forward, dQ and dK/dV)
   and at its S=128 shape (the 3xTF32 single-tile forward and fused
   backward), each with a profile that names the 3xTF32 kernels it ran;
   then the ``wide`` phase:
   the three wide-head kernels (head dims above 256) against their plain
   versions in bf16, float16 and float32 at D=512 (B*H=32, S=512; bf16
   timed beside its bound and the first SDPA backend that takes D=512,
   named; the float32 forward, dQ and dK/dV, 3xTF32, timed beside their
   bound and SDPA's float32 forward and backward, and their errors against
   float64 held as the other 3xTF32 kernels'), D=320 causal and ragged
   (200 rows over 300 keys, 40 of them seeing none) and D=1024; 4 causal
   bf16 layers at D=512 through ``flash_attention_lse``, each launching
   each wide kernel once and no other kernel; and 2 causal float32 layers
   at D=512, the same, with a profile that names the 3xTF32 wide forward,
   dQ and dK/dV;
5. training phase: synchronous data-parallel BERT-Large training through
   ``init`` / ``DistributedOptimizer`` / ``broadcast_parameters`` with the
   1-rank NCCL bucketed allreduce forced on, on two paths: sequence 512
   (multi-tile kernels) and sequence 128, the phase-1 pretraining length
   (single-tile kernels). Launch counters show that every attention call of
   a path went through its own kernels and none through the other route's;
   each path is profiled; then, at S=512, three steps with ``num_groups=4``
   and ``HOROVOD_NONFINITE_ACTION=skip``, the second with a NaN gradient,
   which must leave every parameter and AdamW state tensor bit for bit as
   it was;
6. ResNet-50 phase: bench.py's headline configuration (ResNet-50, 1000
   classes, batch 128 at 224x224, bf16 compute in ``channels_last``, SGD
   0.1 with momentum 0.9 under ``DistributedOptimizer`` with the bf16
   wire), 2 warm-up and 5 timed steps, then a profile; the loss must be
   finite and fall on the repeated batch, and none of the six kernels may
   launch (no Pallas counterpart is on this path);
7. LeNet phase: 5 steps at 28x28x1, batch 64; the loss must fall;
8. ``conv1x1`` phase: forward and backward of ``conv1x1`` through autograd
   at the two ResNet-50 shapes, in bf16 and then in float32 (the 3xTF32
   filter gradient), with one filter-gradient launch per backward, dx and
   dw held against the plain counterpart;
9. collectives phase: at world size 1 over NCCL, on BERT-Large's gradient
   leaves (335M float32 values), reducescatter, alltoall with and without
   splits, the grouped forms, every async form with poll and synchronize,
   allgather_object and masked_average, each held to the one-rank result
   and timed; ``add_process_set([0])`` must raise (the global set's ranks);
10. sync modes: BERT-Large S=512 x 8 (full width, 24 layers, 5 steps
   from the same weights and batch) under sharded and fsdp (4 segments),
   each held to the allreduce run that computes the same function: with
   SGD and momentum its parameters (within ``MODE_GAP_BOUND`` of the
   reference's update) and losses (within ``MODE_LOSS_RTOL``), on the
   float32 wire against the allreduce
   run, beside a control (a sharded run that drops one bucket's gradients)
   that must fail the check, and on the bf16 wire against the allreduce
   run rounded to bf16 after each step (sharded) or with its forward on
   the parameters rounded to bf16 (fsdp); with AdamW on the bf16 wire,
   timed and profiled, its losses; fsdp with 1 segment for its peak memory
   beside 4; the optimizer-state bytes per rank (the whole at world size
   1) and fsdp's resident parameter bytes; after every run,
   ``memory.footprint_of``'s resident parameters and optimizer state equal
   to what the run holds (``_hold_footprint``);
   the int8 wire in allreduce mode (losses fall; one step's gradients
   round-trip within a quantum of each block; ``_sround`` equal on card
   and CPU); a 2-layer BERT-Large saved under sharded and resumed under
   allreduce, and the other way round, equal to an uninterrupted run;
   each with its step time and its peak memory above what was held before;
11. ``adasum``: ``ops.adasum.adasum_tree`` on the card on stacks of 2, 3,
   4, 5 and 8 members of BERT-Large leaf shapes (1024 x 4096 and the
   30522 x 1024 embedding, one member zero) in float32 and bf16 against a
   float64 numpy tree; BERT-Large S=512 x 8 with
   ``DistributedOptimizer(op=Adasum)`` on the forced wire, 3 steps: the
   loss falls, K1, K3 and K4 launch once per layer and step, and the
   parameters equal bit for bit those of the same steps with op=Average
   (a one-member Adasum is the identity); the device ms of both wires'
   collectives in a profiled step;
12. ``syncbn``: ResNet-50 with every BatchNorm synchronized over the
   global process set (forced wire): float32 train-mode logits and
   running statistics against cuDNN's BatchNorm on the same batch and
   weights; then 3 bf16 training steps, profiled beside the plain run;
13. ``launcher``: ``python -m horovod_tpu_torch.runner.launch -np 1``
   (``hvdrun-torch``) runs a worker on the card that calls ``init()``,
   prints its world facts, runs one Adasum allreduce and one flash
   attention layer forward and backward, and checks them; its exit code,
   prefixed output and facts are held, and the seconds from the launch to
   its import, ``init()``, first collective and check are printed;
13b. ``observability``: BERT-Large S=512 x 8 (24 layers, bf16, forced
   NCCL wire) from seed 0, 10 AdamW steps with every observability plane
   off, then from the same weights with all of them on (timeline with
   cycle marks, event journal, ``HOROVOD_TRACE_SAMPLE=4``,
   ``HOROVOD_STALL_CHECK_STEPS=4``, the model's FLOPs declared, two steps
   under ``hvd.profiler.trace``): parameters and AdamW state equal bit for
   bit, K1, K3 and K4 launched 24 times a step, the trace naming the flash
   kernels and the ``hvd.*`` bucket ranges, the timeline loadable with
   step, phase, collective and cycle events, the scrape valid with its
   dispatch, grad-sync and phase families non-zero, ``hvd_mfu_ratio`` in
   (0, 1), and the device busy of an unsampled step within
   ``OBS_BUSY_TOL`` of the planes-off run's. Between the two runs
   ``hvd.run_comms_microprobe`` sweeps ``OBS_PROBE_SIZES`` (4 KB to 256
   MB) over the one-rank world; the planes-on run then holds every op of
   the sweep fitted, a predicted exposed comm, ``footprint_of`` equal to
   the resident bytes the optimizer noted, the allocator read live, and
   the ``forward_backward`` and ``optimizer_update`` watermarks above the
   noted resident total and at most ``max_memory_allocated``, and
   prints the fits, the predicted and observed exposed comm, the
   footprint by kind and the watermarks (``_hold_comms_and_memory``);
   then a stall inspector with a
   1 s warning names an ``allreduce[...]`` queued behind a ~3 s spin after
   the host has returned from the call, and an ``hvd.fetch`` behind the
   same spin; each spin is timed by CUDA events (``utils.spin.Spin``) and
   a short one fails the check;
13c. ``autotune``: BERT-Large S=512 x 8 (24 layers, bf16, forced NCCL wire)
   from seed 0, 14 AdamW steps through ``make_train_step`` untuned, then
   14 from the same weights under ``HOROVOD_AUTOTUNE=1`` and
   ``HOROVOD_AUTOTUNE_LOG``: three windows of 1 + 3 calls sweep 256 KiB,
   4 MiB and 64 MiB, the fastest is pinned, rank 0 writes one JSON line,
   the optimizer re-buckets; the losses equal the untuned run's bit for
   bit (deterministic algorithms), K1, K3 and K4 launch 24 times a step;
   prints each window's seconds, the pin, the log line and the bucket
   counts. Then the Bayesian optimizer (``csrc/bayes_opt.cc``, built with
   g++) runs ``tune_fusion_threshold`` for 4 rounds on the same step, and
   model-guided pruning (``HOROVOD_AUTOTUNE_MODEL_GUIDED=1``) prices the
   grid with the fits the ``observability`` phase's microprobe left and
   prints the kept and pruned candidates;
13d. ``negotiation``: BERT-Large S=512 x 8 (24 layers, bf16, AdamW, seed
   0, deterministic algorithms) for 6 steps through the negotiated runtime
   (``horovod_tpu_torch.runtime.NativeWorld`` built at size 1 on the
   card, its control plane built with g++): a
   ``register_post_accumulate_grad_hook`` on each parameter enqueues its
   gradient as the named ``allreduce_async_`` ``grad.<name>`` (Average)
   in backward order, and every handle is synchronized before AdamW. The
   parameters equal bit for bit those of the same 6 steps under the
   ``DistributedOptimizer`` on the float32 wire (forced NCCL); K1, K3 and
   K4 launch 24 times a step in both; from step 2 on every leaf is a
   cache hit. Prints the fused responses, cycles and executor host ms a
   step, and step ms and device busy beside the direct path's. Then 20
   steps with ``HOROVOD_AUTOTUNE=1`` (the ParameterManager on the loop):
   the knobs move, and ``autotune_state()`` is printed;
14. agreement: the flash model against dense attention on small float32
   inputs, on each attention route; and ResNet-50 in float32 on the card
   against the CPU on the same weights (2 images at 64x64): logits in both
   modes, and the running statistics after one training-mode forward.

The second-last lines are the ``kernels`` JSON line and the card line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and float16 tensor cores,
# float32 on the FMA units (the bound printed beside the 3xTF32 kernels'
# own), memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# The TF32 tensor-core peak. Every float32 kernel does every product as
# three TF32 products (3xTF32): its bound is three times the products'
# operations at this rate (``_bounds_3xtf32``, ``_dw_bounds``).
PEAK_TF32 = 495e12
# The float32 kernels that run in 3xTF32: (kernel, head dim of the instance).
TF32X3 = {(k, d) for k in ("flash_fwd", "flash_dq", "flash_dkv")
          for d in (32, 64, 128, 256)} | {
    (k, d) for k in ("flash_fwd_single", "flash_dqkv") for d in (32, 64, 128)}
# The wide-head kernels (head dims above 256) whose float32 runs in 3xTF32,
# one instance at every D: all three.
TF32X3_WIDE = ("flash_fwd", "flash_dq", "flash_dkv")
# A 3xTF32 kernel's largest error against a float64 version of the function,
# on full-float32 inputs, may be at most this many times the float32 plain
# version's (one TF32 product, 10 mantissa bits, is about 500 times it).
F64_ERR_RATIO = 4.0
# The ratio is one of two largest errors, and on a few small heads the plain
# version's swings with the draw: a case that checks nothing else draws its
# inputs this many times (the first as one draw would be) and is held over
# the heads of all of them at once.
F64_DRAWS = 3
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# Kernel vs plain version on the same inputs: max |kernel - plain| must
# stay within TOL[dtype] * max |plain| (lse: absolute TOL_LSE). bf16 outputs
# are rounded to 8 mantissa bits and P/dS round to bf16 at points that can
# differ by one ulp between the two summation orders; float16 keeps 11
# significant bits against bf16's 8; float32 differs only by summation
# order.
TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}
TOL_LSE = 1e-3

# Kernel vs plain version of the 1x1-conv filter gradient: both sum exact
# bf16 products (or float32 FMAs) in fp32, in another order, over up to
# 401,408 rows: max |kernel - plain| <= TOL_DW[dtype] * max |plain|.
TOL_DW = {"bfloat16": 1e-3, "float16": 1e-3, "float32": 1e-4}

WARMUP_STEPS = 2
TIMED_STEPS = 5

ATTENTION_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_single",
                     "flash_dqkv")
# BERT-Large training paths: name, sequences per step, sequence length,
# masked positions per sequence, the attention kernels the path must run
# (24 launches per step each; every other kernel launches 0 times).
BERT_PATHS = (
    # The S=512 fine-tuning/benchmark length (bench.py): B*H = 128.
    ("bert_large_s512", 8, 512, 76, ("flash_fwd", "flash_dq", "flash_dkv")),
    # Phase-1 pretraining (max_seq_length=128, max_predictions_per_seq=20,
    # google-research/bert): B*H = 1024, 8192 tokens per step.
    ("bert_large_s128", 64, 128, 20, ("flash_fwd_single", "flash_dqkv")),
)
# ResNet-50 training as bench.py's headline runs it (bench.py:561-619):
# batch 128 per card at 224x224, 1000 classes, SGD 0.1 with momentum 0.9,
# bf16 wire; its analytic cost, 3 x 2 x 4.089 GMAC per image (bench.py:378).
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 128, 224, 1000
RESNET50_TRAIN_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
# ResNet-50's 1x1 convolutions for the filter-gradient kernel: name, N, H, W
# (input), Cin, Cout, strides.
CONV_SHAPES = (
    ("resnet50_stage1_64to256", 128, 56, 56, 64, 256, (1, 1)),
    ("resnet50_shortcut_s2_256to512", 128, 56, 56, 256, 512, (2, 2)),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# Cycles the card spins before each timed call (about 2 ms at the H100's
# 1.98 GHz boost clock): time for the host to queue the L2 flush, the two
# events and the call before the device reaches them.
SLEEP_CYCLES = 4_000_000


def time_ms(fn, reps=20, warmup=3, sleep_cycles=SLEEP_CYCLES):
    """Median over ``reps`` of one call's CUDA-event time, with the 50 MB
    L2 flushed before each call (the backward finds its saved activations
    cold; the forward's operands were just written, but one setting for
    all three keeps them comparable). The device sleeps ``sleep_cycles``
    first, so the events time the device's work and not the host's launch
    overhead, which for a call of tens of microseconds would otherwise
    dominate; ``sleep_cycles=0`` times without the sleep."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The Hopper instances: on wgmma, the bf16 and float16 kernels of both
# attention routes at head dims 16 to 128, the multi-tile ones also at 256,
# the wide-head forward, dQ and dK/dV (any D above 256), and the bf16 and
# float16 1x1-conv filter gradient; on mma.sync in 3xTF32, the float32
# forwards, dQ, dK/dV and fused single-tile backward (*_3xtf32_kernel,
# templated on the head dim alone; the wide-head forward, dQ and dK/dV,
# *_wide_3xtf32_kernel, not templated) and the float32 filter gradient
# (dw_1x1_3xtf32_kernel). nvcc's mangled names carry the element type:
# 13__nv_bfloat16 or 6__half. The filter gradient's reduction and the
# forwards' fill of lse with no key are no Hopper instances.
HOPPER_TYPES = {"__nv_bfloat16": "bf16", "__half": "f16"}
MULTI_TILE_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel",
                      "flash_dkv_kernel")
HOPPER_INSTANCES = tuple(
    f"{k}<{t}, {d}>"
    for k in MULTI_TILE_KERNELS + ("flash_fwd_single_kernel",
                                   "flash_dqkv_kernel")
    for t in HOPPER_TYPES.values() for d in (16, 32, 64, 128)) + tuple(
        f"{k}<{t}, 256>" for k in MULTI_TILE_KERNELS
        for t in HOPPER_TYPES.values()) + tuple(
        f"{k}<{t}>" for k in ("flash_fwd_wide_kernel", "flash_dq_wide_kernel",
                              "flash_dkv_wide_kernel", "dw_1x1_kernel")
        for t in HOPPER_TYPES.values()) + tuple(
        f"{k}_3xtf32_kernel<{d}>" for k, d in sorted(TF32X3)) + tuple(
        f"{k}_wide_3xtf32_kernel" for k in TF32X3_WIDE) + (
        "dw_1x1_3xtf32_kernel",)
_HOPPER_NAME = re.compile(
    r"(flash_(?:fwd_single|fwd|dqkv|dq|dkv)_kernel)I\d+(__nv_bfloat16|__half)"
    r"Li(\d+)E|\d(dw_1x1_kernel|flash_(?:fwd|dq|dkv)_wide_kernel)"
    r"I\d+(__nv_bfloat16|__half)E"
    r"|\d(flash_(?:fwd_single|fwd|dqkv|dq|dkv)_3xtf32_kernel)ILi(\d+)E"
    r"|\d(flash_(?:fwd|dq|dkv)_wide_3xtf32_kernel|dw_1x1_3xtf32_kernel)E")


def _hopper_instance(line):
    """The Hopper instance a line of ptxas output names, or None."""
    found = _HOPPER_NAME.search(line)
    if not found:
        return None
    if found.group(8):
        return found.group(8)
    if found.group(6):
        return f"{found.group(6)}<{found.group(7)}>"
    if found.group(4):
        return f"{found.group(4)}<{HOPPER_TYPES[found.group(5)]}>"
    return (f"{found.group(1)}<{HOPPER_TYPES[found.group(2)]}, "
            f"{found.group(3)}>")


def hopper_build_report(log):
    """From nvcc's ``-Xptxas -v`` output: the registers per thread at entry
    of each Hopper instance, and the instances' faults: spills, or ptxas's
    note that their wgmma are serialized. Either means the consumers lost
    the register budget that setmaxnreg gives them."""
    regs, faults, entry = {}, [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _hopper_instance(line)
        elif entry and "Used" in line and "registers" in line:
            regs[entry] = int(line.split("Used ")[1].split()[0])
        elif entry and "spill" in line and not line.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            faults.append(f"{entry}: {line.strip()}")
        if "Potential Performance Loss" in line and "wgmma" in line:
            culprit = _hopper_instance(line)
            if culprit:
                faults.append(f"{culprit}: "
                              f"{line.split('Loss:', 1)[1].strip()}")
    return regs, faults


def build_phase():
    from horovod_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path = _kernels.build()
    seconds = time.perf_counter() - t0
    print(f"build: {os.path.relpath(path)} in {seconds:.1f} s")
    log = _kernels.build_log()
    lines = log.splitlines()
    regs = [int(w.split()[0]) for line in lines if "Used" in line
            for w in line.split("Used ")[1:] if "registers" in w]
    spills = [line.strip() for line in lines
              if "spill" in line and not line.strip().endswith(
                  "0 bytes spill stores, 0 bytes spill loads")]
    print(f"build: {len(regs)} kernel instances, registers per thread "
          f"{min(regs)}-{max(regs)}, spills: {spills or 'none'}")
    hopper, faults = hopper_build_report(log)
    if sorted(hopper) != sorted(HOPPER_INSTANCES) or faults:
        raise AssertionError(
            f"build: Hopper instances {sorted(hopper)} (expected "
            f"{list(HOPPER_INSTANCES)}); spills or serialized wgmma: {faults}")
    print(f"build: Hopper instances, registers per thread at entry: {hopper}; "
          "no spills, no serialized wgmma")
    return seconds


def _visible_pairs(Sq, Sk, causal, q_offset, k_offset):
    if not causal:
        return Sq * Sk
    return sum(max(0, min(Sk, q_offset + i - k_offset + 1))
               for i in range(Sq))


def _bounds(name, BH, Sq, Sk, D, dtype_name, causal, q_offset, k_offset):
    """Least time for the work: bytes once in and out over the memory rate,
    products' operations over the dtype's peak; the larger of the two."""
    pairs = BH * _visible_pairs(Sq, Sk, causal, q_offset, k_offset)
    item = ITEM_BYTES[dtype_name]
    q_bytes = BH * Sq * D * item
    k_bytes = BH * Sk * D * item
    rows = BH * Sq * 4
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4,
                "flash_fwd_single": 2, "flash_dqkv": 5}[name]
    moved = {
        "flash_fwd": 2 * q_bytes + 2 * k_bytes + rows,            # q,k,v,o,lse
        "flash_dq": 3 * q_bytes + 2 * k_bytes + 3 * rows,         # q,do,dq,k,v
        "flash_dkv": 2 * q_bytes + 4 * k_bytes + 3 * rows,        # q,do,k,v,dk,dv
        "flash_fwd_single": 2 * q_bytes + 2 * k_bytes + rows,     # q,k,v,o,lse
        # q,do,dq; k,v,dk,dv; lse,delta,g_lse
        "flash_dqkv": 3 * q_bytes + 4 * k_bytes + 3 * rows,
    }[name]
    return _bound(2.0 * products * pairs * D, moved, dtype_name)


def _bounds_3xtf32(name, BH, Sq, Sk, D, causal, q_offset, k_offset):
    """The least time of a 3xTF32 kernel (``TF32X3``, ``TF32X3_WIDE``): its
    bytes as
    ``_bounds`` counts them, its operations three TF32 products for each
    float32 product at ``PEAK_TF32``. Returns what ``_bounds`` returns, the
    operations tripled."""
    _, _, flops, moved = _bounds(name, BH, Sq, Sk, D, "float32", causal,
                                 q_offset, k_offset)
    t_ops, t_bytes = 3 * flops / PEAK_TF32, moved / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", 3 * flops, moved
    return t_bytes * 1e3, "bytes", 3 * flops, moved


def _runs_3xtf32(name, D):
    """Whether the float32 kernel ``name`` at head dim ``D`` runs a 3xTF32
    instance (``TF32X3``): the instance's head dim is the next of its
    route's float32 instances; above 256, the wide-head forward, dQ and
    dK/dV (``TF32X3_WIDE``)."""
    import torch

    from horovod_tpu_torch.ops import attention as A

    if A.wide_route(D):
        return name in TF32X3_WIDE
    single = name in ("flash_fwd_single", "flash_dqkv")
    dims = A.instance_head_dims(
        torch.float32, A.SINGLE_TILE_HEAD_DIMS if single else A.KERNEL_HEAD_DIMS)
    return (name, A.kernel_head_dim(D, dims)) in TF32X3


def _kernel_bounds(name, BH, Sq, Sk, D, dname, causal, q_offset, k_offset):
    """``_bounds`` of a kernel, or for a 3xTF32 kernel ``_bounds_3xtf32``
    with its bound at the float32 FMA peak beside it: ``(bounds,
    fma_bound_ms or None)``."""
    bounds = _bounds(name, BH, Sq, Sk, D, dname, causal, q_offset, k_offset)
    if dname == "float32" and _runs_3xtf32(name, D):
        return (_bounds_3xtf32(name, BH, Sq, Sk, D, causal, q_offset,
                               k_offset), bounds[0])
    return bounds, None


def _f64_check(case, q, k, v, do, got, plain, causal, q_offset, k_offset,
               glse=None):
    """Each float32 output's largest error against a float64 version of the
    function on the same float32 inputs, beside the float32 plain version's
    and SDPA's (causal: top-left, so only with both offsets 0; and no lse
    cotangent). The forward (``do`` None): ``got`` and ``plain`` are
    (o, lse), rows that see no key left out (SDPA returns no lse). The
    backward: (dq, dk, dv) on fp32 lse and delta (lse and delta in float64
    for the reference) and the lse cotangent ``glse`` (None: zero); rows
    that see no key have P = 0. A kernel's error may be at most
    ``F64_ERR_RATIO`` times the plain version's."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    BH, Sq, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    s = q64 @ k64.transpose(-1, -2) * scale
    mask = A._visible(Sq, k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    seen = torch.isfinite(s.amax(-1))  # rows that see a key
    p = torch.softmax(torch.where(seen[..., None], s, 0.0), dim=-1)
    p = torch.where(torch.isfinite(s), p, 0.0)
    g4 = [t.view(1, BH, -1, D).detach().requires_grad_() for t in (q, k, v)]
    with_sdpa = not (causal and (q_offset or k_offset)) and glse is None
    out = (F.scaled_dot_product_attention(*g4, is_causal=causal)
           if with_sdpa else None)
    if do is None:
        want = (p @ v64, torch.logsumexp(s, dim=-1))
        sdpa = (out.detach().view(BH, Sq, D) if with_sdpa else None, None)
        names = ("o", "lse")
    else:
        do64 = do.double()
        delta = ((p @ v64) * do64).sum(-1, keepdim=True)
        g = 0.0 if glse is None else glse.double()[..., None]
        ds = p * (do64 @ v64.transpose(-1, -2) - delta + g)
        want = (scale * ds @ k64, scale * ds.transpose(-1, -2) @ q64,
                p.transpose(-1, -2) @ do64)
        sdpa = (torch.autograd.grad(out, g4, do.view(1, BH, Sq, D))
                if with_sdpa else (None,) * 3)
        seen = None
        names = ("dq", "dk", "dv")
    lines = []
    for i, name in enumerate(names):
        errs = []
        for t in (got, plain, sdpa):
            if t[i] is None:
                errs.append(None)
                continue
            e = (t[i].reshape(want[i].shape).double() - want[i]).abs()
            errs.append((e[seen] if seen is not None else e).max().item())
        lines.append(f"{name} kernel {errs[0]:.3e}, float32 plain "
                     f"{errs[1]:.3e}, sdpa "
                     + ("n/a" if errs[2] is None else f"{errs[2]:.3e}"))
        if not errs[0] <= F64_ERR_RATIO * errs[1]:
            raise AssertionError(
                f"{case} {name}: error against float64 {errs[0]:.3e} > "
                f"{F64_ERR_RATIO} x the float32 plain version's "
                f"{errs[1]:.3e}")
    print(f"float64 {case}: largest error against float64 on full-float32 "
          f"inputs: {'; '.join(lines)} (at most {F64_ERR_RATIO} x the plain "
          "version's)")


def _dw_bounds(K, ci, co, dtype_name):
    """The filter gradient reads x [K, Cin] and dy [K, Cout] once and writes
    dw [Cin, Cout] in fp32: 2 K Cin Cout operations. Returns ``(bounds,
    fma_bound_ms or None)`` as ``_kernel_bounds``: in float32 (3xTF32) the
    operations tripled at ``PEAK_TF32``, with the bound at the FMA peak
    beside it."""
    item = ITEM_BYTES[dtype_name]
    flops, moved = 2.0 * K * ci * co, K * (ci + co) * item + ci * co * 4
    bounds = _bound(flops, moved, dtype_name)
    if dtype_name != "float32":
        return bounds, None
    t_ops, t_bytes = 3 * flops / PEAK_TF32, moved / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return (max(t_ops, t_bytes) * 1e3, by, 3 * flops, moved), bounds[0]


def _dw_f64_check(case, x2d, dy, got, plain):
    """The float32 filter gradient's largest error against ``x2d^T dy`` in
    float64 on the same float32 inputs, at most ``F64_ERR_RATIO`` times the
    float32 plain version's."""
    want = x2d.double().transpose(0, 1) @ dy.double()
    err, perr = ((t.double() - want).abs().max().item() for t in (got, plain))
    if not err <= F64_ERR_RATIO * perr:
        raise AssertionError(
            f"{case} dw: error against float64 {err:.3e} > {F64_ERR_RATIO} x "
            f"the float32 plain version's {perr:.3e}")
    return (f" (float64: kernel {err:.3e}, float32 plain {perr:.3e}; at most "
            f"{F64_ERR_RATIO} x the plain version's)")


def _bound(flops, moved, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = moved / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", flops, moved
    return t_bytes * 1e3, "bytes", flops, moved


def _hold(case, name, got, want, tolerance, lse_index=None):
    """Each output of a kernel within ``tolerance`` (a fraction of the
    largest plain value; lse absolute) of its plain version; return the
    largest error and the per-output line."""
    err, checks = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        e = (g.float() - w.float()).abs().max().item()
        if i == lse_index:  # lse, fp32 both sides
            limit = TOL_LSE
        else:
            limit = tolerance * max(w.float().abs().max().item(), 1e-30)
        if not e <= limit:
            raise AssertionError(
                f"{case} {name} output {i}: max abs err {e:.3e} > "
                f"{limit:.3e}")
        err = max(err, e)
        checks.append(f"{e:.2e} <= {limit:.2e}")
    return err, (f"kernel {case} {name}: max_abs_err {err:.3e} (per output: "
                 f"{', '.join(checks)})")


def _timing(kern, plain, bounds, library_ms, fma_bound=None):
    """Time the kernel and its plain version; ``fma_bound``: a 3xTF32
    kernel's bound at the float32 FMA peak, printed beside its own."""
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    bound_ms, bound_by, flops, moved = bounds
    fma = (f" (at the FMA peak {fma_bound:.4f})" if fma_bound is not None
           else "")
    return (dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms),
            f" ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB)"
            f"{fma} {flops / ms / 1e9:.1f} TFLOP/s {moved / ms / 1e6:.1f} "
            f"GB/s library_ms {library_ms}")


def kernel_phase():
    """Hold each flash-attention kernel against its plain version; return
    the timed cases' measurements keyed by kernel name (``flash_*_d256``
    for the D = 256 instances)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    (_, b512, s512, _, _), (_, b128, s128, _, _) = BERT_PATHS
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # name, B, H, Sq, Sk, D, dtype, causal, q_offset, k_offset, g_lse,
        # timing ("json": timed, with the library yardstick, into the
        # kernels line; "d256": the same as flash_*_d256; "f32": the 3xTF32
        # kernels the same as flash_*_float32 (flash_*_d256_float32 at
        # D = 256), with the float64 check of the forward and of the
        # backward (dQ and dK/dV, or the fused backward); "f64": those
        # float64 checks alone, over F64_DRAWS draws; "sdpa": timed beside the library, printed;
        # "ms": time printed; "": not timed).
        # A.single_tile_route picks the route: Sq, Sk <=
        # A.SINGLE_TILE_MAX and D <= 128 take the single-tile kernels.
        ("bert_large_bf16", b512, 16, s512, s512, 64, bf16, False, 0, 0,
         False, "json"),
        ("causal_ragged_bf16", 2, 3, 200, 264, 64, bf16, True, 0, 40, True,
         ""),
        # The Hopper kernels at the other head dims: D = 128 (two 64-column
        # TMA boxes, 32-row dK/dV stages), D = 32 (64-byte swizzle) and
        # D = 16 (32-byte swizzle, n16 wgmma for P V, P^T dO and dS^T Q).
        ("d128_causal_ragged_bf16", 2, 3, 200, 264, 128, bf16, True, 0, 40,
         True, ""),
        ("d32_causal_bf16", 2, 3, 320, 384, 32, bf16, True, 64, 0, True,
         ""),
        ("d16_causal_ragged_bf16", 2, 3, 200, 264, 16, bf16, True, 0, 40,
         True, ""),
        # D = 96 has no instance: zero-padded to D = 128.
        ("d96_causal_ragged_bf16", 2, 3, 200, 264, 96, bf16, True, 0, 40,
         True, "ms"),
        # The float16 instances (wgmma's .f16 kind).
        ("bert_large_f16", b512, 16, s512, s512, 64, f16, False, 0, 0,
         False, "ms"),
        ("causal_ragged_f16", 2, 3, 200, 264, 64, f16, True, 0, 40, True,
         ""),
        ("float32", 2, 4, 200, 136, 64, f32, True, 70, 0, True, ""),
        ("d128_float32", 2, 4, 200, 136, 128, f32, True, 70, 0, True, "ms"),
        # B*H past the 65,535 blocks of grid.y: the persistent kernels walk
        # the work tiles (float32 D = 16 zero-padded to the 3xTF32 D = 32).
        ("bh65600_float32", 65600, 1, 129, 129, 16, f32, False, 0, 0, True,
         "ms"),
        ("bh65600_bf16", 65600, 1, 129, 129, 16, bf16, False, 0, 0, True,
         "ms"),
        ("bert_large_s128_bf16", b128, 16, s128, s128, 64, bf16, False, 0, 0,
         False, "json"),
        ("bert_large_s128_f16", b128, 16, s128, s128, 64, f16, False, 0, 0,
         False, "ms"),
        ("causal_single_bf16", 2, 3, 96, 128, 64, bf16, True, 0, 40, True,
         ""),
        ("float32_single", 2, 4, 128, 128, 64, f32, True, 16, 0, True, ""),
        ("d128_float32_single", 2, 4, 128, 128, 128, f32, True, 16, 0, True,
         "ms"),
        ("d128_single_bf16", 2, 4, 128, 128, 128, bf16, False, 0, 0, True,
         ""),
        # The single-tile Hopper forward at the other head dims, and on
        # lengths that are no multiple of 16 (rows 0..22 see no key).
        ("d16_single_causal_bf16", 2, 3, 128, 128, 16, bf16, True, 0, 0,
         True, ""),
        ("d32_single_causal_bf16", 2, 3, 112, 128, 32, bf16, True, 16, 0,
         True, ""),
        ("ragged_single_bf16", 2, 3, 77, 100, 64, bf16, True, 0, 23, True,
         ""),
        ("ragged_single_f16", 2, 3, 77, 100, 64, f16, True, 0, 23, True, ""),
        # D = 48: zero-padded to D = 64.
        ("d48_ragged_single_bf16", 2, 3, 77, 100, 48, bf16, True, 0, 23,
         True, "ms"),
        ("bh65600_single_float32", 65600, 1, 16, 16, 16, f32, False, 0, 0,
         True, "ms"),
        ("bh65600_single_bf16", 65600, 1, 16, 16, 16, bf16, False, 0, 0,
         True, "ms"),
        # Head dim 256 (instances for D = 129 to 256, multi-tile route
        # only): a Gemma-like attention layer (8 sequences of 512, 16 heads
        # of 256; B*H = 128), timed beside SDPA ("d256": into the kernels
        # line as flash_*_d256); S = 128 with B*H = 1024, which takes the
        # multi-tile kernels too; D = 200 zero-padded to 256, causal and
        # ragged; each in bf16, float16 and float32.
        ("gemma_d256_bf16", 8, 16, 512, 512, 256, bf16, False, 0, 0, False,
         "d256"),
        ("gemma_d256_f16", 8, 16, 512, 512, 256, f16, False, 0, 0, False,
         "ms"),
        ("gemma_d256_float32", 8, 16, 512, 512, 256, f32, True, 0, 0, True,
         ""),
        ("d256_s128_bf16", 64, 16, 128, 128, 256, bf16, False, 0, 0, False,
         "sdpa"),
        ("d256_s128_f16", 64, 16, 128, 128, 256, f16, True, 0, 0, True, ""),
        ("d256_s128_float32", 8, 16, 128, 128, 256, f32, False, 0, 0, True,
         ""),
        ("d200_causal_ragged_bf16", 2, 3, 200, 264, 200, bf16, True, 0, 40,
         True, "ms"),
        ("d200_causal_ragged_f16", 2, 3, 200, 264, 200, f16, True, 0, 40,
         True, ""),
        ("d200_causal_ragged_float32", 2, 3, 200, 264, 200, f32, True, 0, 40,
         True, ""),
        # The Gemma-like layer and BERT-Large's S = 512 shape in full float32
        # (the 3xTF32 forward, dQ and dK/dV), and its S = 128 shape (the
        # 3xTF32 single-tile forward).
        ("gemma_d256_float32_full", 8, 16, 512, 512, 256, f32, False, 0, 0,
         False, "f32"),
        ("bert_large_float32_full", b512, 16, s512, s512, 64, f32, False, 0,
         0, False, "f32"),
        ("bert_large_s128_float32_full", b128, 16, s128, s128, 64, f32, False,
         0, 0, False, "f32"),
        # The fused backward (3xTF32) causal and ragged with a key offset
        # (rows 0..22 see no key) and an lse cotangent, at D = 64 and
        # D = 128 ("f64": the float64 checks alone, not timed, on
        # F64_DRAWS draws of the inputs).
        ("float32_single_causal_ragged", 2, 4, 77, 100, 64, f32, True, 0, 23,
         True, "f64"),
        ("d128_float32_single_causal_ragged", 2, 4, 77, 100, 128, f32, True, 0,
         23, True, "f64"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = {}
    for (case, B, H, Sq, Sk, D, dtype, causal, qo, ko, with_glse,
         timing) in cases:
        timed = timing in ("json", "d256", "sdpa", "f32")
        BH = B * H
        dname = str(dtype).split(".")[-1]

        def rnd(*shape, dt=dtype):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dt)

        draws = []
        for _ in range(F64_DRAWS if timing == "f64" else 1):
            q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
            do = rnd(BH, Sq, D)
            glse = (rnd(BH, Sq, dt=torch.float32) if with_glse
                    else torch.zeros(BH, Sq, device="cuda"))
            draws.append((q, k, v, do, glse))
        if len(draws) > 1:
            q, k, v, do, glse = (torch.cat(t) for t in zip(*draws))
            BH = q.shape[0]
        o_ref, lse_ref = A.flash_fwd_plain(q, k, v, causal, qo, ko)
        delta = (do.float() * o_ref.float()).sum(-1)
        bwd_args = (q, k, v, do, lse_ref, delta, glse, causal, qo, ko)
        fwd_args = (q, k, v, causal, qo, ko)
        if A.single_tile_route(Sq, Sk, D):
            runs = {
                "flash_fwd_single": (
                    lambda: A.flash_fwd_single(*fwd_args),
                    lambda: A.flash_fwd_single_plain(*fwd_args)),
                "flash_dqkv": (lambda: A.flash_dqkv(*bwd_args),
                               lambda: A.flash_dqkv_plain(*bwd_args)),
            }
        else:
            runs = {
                "flash_fwd": (lambda: A.flash_fwd(*fwd_args),
                              lambda: A.flash_fwd_plain(*fwd_args)),
                "flash_dq": (lambda: (A.flash_dq(*bwd_args),),
                             lambda: (A.flash_dq_plain(*bwd_args),)),
                "flash_dkv": (lambda: A.flash_dkv(*bwd_args),
                              lambda: A.flash_dkv_plain(*bwd_args)),
            }
        library = {}
        if timed:
            # The library's forward, and its backward: one call computing
            # dQ, dK and dV, the fused kernel's function and a yardstick
            # for the dQ + dK/dV pair (not for either alone).
            q4, k4, v4 = (t.view(B, H, -1, D).detach().requires_grad_()
                          for t in (q, k, v))
            fwd_ms = time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4))
            out4 = F.scaled_dot_product_attention(q4, k4, v4)
            do4 = do.view(B, H, -1, D)
            bwd_ms = time_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
            print(f"library {case}: sdpa forward {fwd_ms:.4f} ms, sdpa "
                  f"backward (dQ+dK+dV in one call) {bwd_ms:.4f} ms")
            library = {"flash_fwd": fwd_ms, "flash_fwd_single": fwd_ms,
                       "flash_dqkv": bwd_ms}
        for name, (kern, plain) in runs.items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            fwd = name in ("flash_fwd", "flash_fwd_single")
            err, line = _hold(case, name, got, want, TOL[dname],
                              lse_index=1 if fwd else None)
            if fwd:
                empty = int((want[1] == A.LSE_MASKED).sum().item())
                if empty != int((got[1] == A.LSE_MASKED).sum().item()):
                    raise AssertionError(f"{case}: masked-row sentinels differ")
                line += f" (fully masked rows: {empty})"
            if timed:
                bounds, fma = _kernel_bounds(name, BH, Sq, Sk, D, dname,
                                             causal, qo, ko)
                numbers, text = _timing(kern, plain, bounds,
                                        library.get(name), fma)
                if timing == "f32" and fma is not None:
                    key = f"{name}{'_d256' if D == 256 else ''}_float32"
                    measured[key] = dict(max_abs_err=err, **numbers)
                elif timing in ("json", "d256"):
                    key = name if timing == "json" else f"{name}_d256"
                    measured[key] = dict(max_abs_err=err, **numbers)
                line += text
            elif timing == "ms":
                bounds, _ = _kernel_bounds(name, BH, Sq, Sk, D, dname, causal,
                                           qo, ko)
                line += (f" ms {time_ms(kern):.4f} bound_ms {bounds[0]:.4f} "
                         f"({bounds[1]}; {bounds[2] / 1e9:.2f} GFLOP, "
                         f"{bounds[3] / 1e6:.1f} MB)")
            print(line)
        if timing in ("f32", "f64"):
            fwd_name = next(n for n in runs if n.startswith("flash_fwd"))
            kern, plain = runs[fwd_name]
            _f64_check(f"{case} {fwd_name}", q, k, v, None, kern(), plain(),
                       causal, qo, ko)
            bwd_names = [n for n in runs if not n.startswith("flash_fwd")]
            if all(_runs_3xtf32(n, D) for n in bwd_names):
                got = tuple(t for n in bwd_names for t in runs[n][0]())
                plain = tuple(t for n in bwd_names for t in runs[n][1]())
                _f64_check(f"{case} {' + '.join(bwd_names)}", q, k, v, do, got,
                           plain, causal, qo, ko,
                           glse if with_glse else None)
        if timing in ("json", "f32") and "flash_dqkv" in runs:
            # The other route on the same inputs: what the single-tile
            # kernels save over the multi-tile ones at this shape.
            fwd_ms = time_ms(lambda: A.flash_fwd(*fwd_args))
            bwd_ms = time_ms(lambda: (A.flash_dq(*bwd_args),
                                      A.flash_dkv(*bwd_args)))
            print(f"route {case}: multi-tile flash_fwd {fwd_ms:.4f} ms, "
                  f"flash_dq + flash_dkv {bwd_ms:.4f} ms on the same inputs")
    return measured


def empty_phase():
    """The calls with nothing to compute, on each route (single-tile,
    multi-tile, wide) in bf16, float16 and float32: no key (Sk = 0) and no
    query (Sq = 0). Each output of each kernel wrapper must equal its plain
    version's (O = 0 and lse = ``LSE_MASKED`` with no key, dQ = 0; dK =
    dV = 0 with no query; the rest empty), in memory that held NaN just
    before (freed tensors of the outputs' sizes, which the allocator hands
    out again)."""
    import torch

    from horovod_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    checked = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for route, D, S in (("single-tile", 64, 40), ("multi-tile", 64, 200),
                            ("wide", 320, 200)):
            for Sq, Sk in ((S, 0), (0, S)):
                BH = 3

                def rnd(n, dt=dtype):
                    return torch.randn(BH, n, D, generator=gen, device="cuda",
                                       dtype=torch.float32).to(dt)

                q, do, k, v = rnd(Sq), rnd(Sq), rnd(Sk), rnd(Sk)
                lse = torch.full((BH, Sq), A.LSE_MASKED, device="cuda")
                delta = torch.randn(BH, Sq, generator=gen, device="cuda")
                glse = torch.randn(BH, Sq, generator=gen, device="cuda")
                fwd, bwd = (q, k, v), (q, k, v, do, lse, delta, glse)
                if route == "single-tile":
                    runs = (("flash_fwd_single", A.flash_fwd_single,
                             A.flash_fwd_single_plain, fwd),
                            ("flash_dqkv", A.flash_dqkv, A.flash_dqkv_plain,
                             bwd))
                else:
                    runs = (("flash_fwd", A.flash_fwd, A.flash_fwd_plain, fwd),
                            ("flash_dq", A.flash_dq, A.flash_dq_plain, bwd),
                            ("flash_dkv", A.flash_dkv, A.flash_dkv_plain,
                             bwd))
                for name, kern, plain, args in runs:
                    want = plain(*args)
                    want = want if isinstance(want, tuple) else (want,)
                    for t in [torch.full_like(w, math.nan) for w in want]:
                        del t
                    got = kern(*args)
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    if not all(g.shape == w.shape and g.dtype == w.dtype
                               and torch.equal(g, w)
                               for g, w in zip(got, want)):
                        raise AssertionError(
                            f"empty {route} {name} {dtype} Sq={Sq} Sk={Sk}: "
                            f"{[tuple(g.shape) for g in got]} differ from the "
                            "plain version's")
                    checked.append(name)
    print(f"empty: {len(checked)} calls with no key (Sk = 0) or no query "
          "(Sq = 0), each route in bf16, float16 and float32, equal to their "
          "plain versions")


def dw_kernel_phase():
    """Hold the 1x1-conv filter-gradient kernel against its plain version;
    return the stage-1 cases' measurements (``dw_1x1`` in bf16,
    ``dw_1x1_float32``)."""
    import torch

    from horovod_tpu_torch.ops import conv_backward as C

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # name, N, H, W, Cin, Cout, strides, dtype, timed (the first timed case
    # of each dtype is the kernel's line of the JSON).
    cases = [(*shape, bf16, True) for shape in CONV_SHAPES]
    cases += [
        # K = 5 * 37 * 41 = 7585 rows: no multiple of any tile; Cin = 72
        # and Cout = 40 leave ragged channel tiles too.
        ("bf16_ragged", 5, 37, 41, 72, 40, (1, 1), bf16, False),
        # Odd H: the stride-2 view's images do not follow each other
        # evenly (a 4-D row grid), and W' = 15 needs padded boxes.
        ("bf16_stride2_odd_h", 4, 37, 30, 64, 128, (2, 2), bf16, False),
        # 3 -> 12 channels: no whole 16-byte row; x and dy go into
        # zero-padded 8- and 16-channel copies.
        ("bf16_cin3_cout12", 8, 32, 32, 3, 12, (1, 1), bf16, False),
        # W' = 300 rows: wider than a TMA box, so the view is copied.
        ("bf16_stride2_w300", 2, 16, 600, 64, 128, (2, 2), bf16, False),
        ("float16_stage1", *CONV_SHAPES[0][1:], f16, False),
        ("float32_ragged", 5, 37, 41, 72, 40, (1, 1), f32, False),
        # float32 W' = 150: grid rows wider than a float32 box, read in
        # three pieces each.
        ("float32_stride2_h_w150", 2, 8, 150, 64, 96, (2, 1), f32, False),
    ]
    # Both ResNet-50 shapes in full float32 (3xTF32), timed.
    cases += [(f"float32_{name}", *rest, f32, True)
              for name, *rest in CONV_SHAPES]
    gen = torch.Generator(device="cuda").manual_seed(1)
    measured = {}
    for case, N, H, W, ci, co, strides, dtype, timed in cases:
        dname = str(dtype).split(".")[-1]
        x = torch.randn(N, H, W, ci, generator=gen, device="cuda").to(dtype)
        xs = x[:, ::strides[0], ::strides[1], :]  # read in place, no copy
        K = xs.shape[:3].numel()
        dy = torch.randn(K, co, generator=gen, device="cuda").to(dtype)
        kern = lambda: (C.dw_1x1(xs, dy),)  # noqa: E731
        plain = lambda: (C.dw_1x1_plain(xs, dy),)  # noqa: E731
        got, want = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        err, line = _hold(case, "dw_1x1", got, want, TOL_DW[dname])
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"{case} dw_1x1: two calls on the same "
                                 "inputs differ")
        line += (f" (K {K}, {ci} -> {co}, strides {strides}; a second call "
                 "equal bit for bit)")
        bounds, fma = _dw_bounds(K, ci, co, dname)
        if timed:
            # One library call for the same function: cuBLAS, in the
            # operands' dtype in and out (the kernel returns fp32; float32
            # with TF32 off). A strided view would make matmul copy it
            # inside the timing, so the library reads a contiguous copy of
            # x made before.
            x2d = xs.reshape(K, ci) if xs.is_contiguous() else (
                xs.contiguous().reshape(K, ci))
            library_ms = time_ms(lambda: torch.matmul(x2d.T, dy))
            numbers, text = _timing(kern, plain, bounds, library_ms, fma)
            key = "dw_1x1" if dtype == bf16 else "dw_1x1_float32"
            if key not in measured:
                measured[key] = dict(max_abs_err=err, **numbers)
            line += text + f" (library output {dname}" + (
                "" if xs.is_contiguous() else
                "; library reads a contiguous copy of x, the copy untimed") + ")"
            if dtype == f32:
                line += _dw_f64_check(case, x2d, dy, got[0], want[0])
        else:
            ms = time_ms(kern)
            line += (f" ms {ms:.4f} bound_ms {bounds[0]:.4f} ({bounds[1]}; "
                     f"{bounds[3] / 1e6:.1f} MB)")
        print(line)
    return measured


def _bert_batch(cfg, B, S, P, seed, device):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(B, S))
    labels = rng.randint(0, cfg.vocab_size, size=(B, S))
    positions = np.stack([rng.choice(S, P, replace=False) for _ in range(B)])
    plabels = np.take_along_axis(labels, positions, axis=1)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (ids, positions, plabels, np.ones((B, P), np.int64)))


def _bert_loss(model, batch):
    from horovod_tpu_torch.models.bert import mlm_loss

    ids, positions, plabels, lmask = batch
    _, logits = model(ids, masked_positions=positions)
    return mlm_loss(logits, plabels, lmask)


def _train(name, step, batch, steps):
    """``steps`` steps on the repeated ``batch``: (losses, host ms of the
    steps after the warm-up ones), each step ended by a synchronize."""
    import torch

    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(
            f"{name}: loss did not fall on a repeated batch: {losses}")
    return losses, times


def training_phase(card, path):
    """BERT-Large data-parallel training on one path of ``BERT_PATHS``
    through the port's entry points (``init`` has run); returns the kernels'
    launch counts from this run."""
    import dataclasses
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops import _kernels

    name, batch_size, seq, predictions, kernels = path
    dev = hvd.device()
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, _bert_loss, opt)
    batch = _bert_batch(cfg, batch_size, seq, predictions, 0, dev)

    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = WARMUP_STEPS + TIMED_STEPS
    losses, times = _train(name, step, batch, steps)
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for kname, n in launches.items():
        want = cfg.num_layers * steps if kname in kernels else 0
        if n != want:
            raise AssertionError(
                f"{name}: {kname} launched {n} times in {steps} steps; "
                f"expected {want} (this path runs {', '.join(kernels)} once "
                "per layer per step and no other kernel)")
    step_ms = statistics.median(times)
    tokens = batch_size * seq
    print(f"train {name}: BERT-Large {n_params / 1e6:.1f}M params, batch "
          f"{batch_size}x{seq}, {predictions} predictions per sequence, "
          f"{len(opt._buckets)} allreduce buckets (bf16 wire), losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"train {name}: step_ms median {step_ms:.2f} (steps "
          f"{[round(t, 2) for t in times]}), tokens/s "
          f"{tokens / step_ms * 1e3:.0f}, max_memory_allocated "
          f"{peak_gib:.2f} GiB on {card}")
    print(f"train {name}: launches per kernel {launches} over {steps} steps")
    profile_steps(name, step, batch, card, step_ms)
    opt.remove_hooks()
    del model, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def resnet_phase(card, name="resnet50", process_set=None,
                 steps=WARMUP_STEPS + TIMED_STEPS):
    """ResNet-50 data-parallel training at bench.py's headline
    configuration through the port's entry points (``init`` has run); no
    kernel of the library may launch. ``process_set``: every BatchNorm
    synchronized over it. Returns the device busy ms per profiled step."""
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.lenet import cross_entropy_loss
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import _kernels

    torch.backends.cudnn.benchmark = True
    print(f"resnet50: torch.backends.cudnn.benchmark = "
          f"{torch.backends.cudnn.benchmark}")
    dev = hvd.device()
    torch.manual_seed(0)
    model = ResNet50(num_classes=RESNET_CLASSES, dtype=torch.bfloat16,
                     device=dev, process_set=process_set)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    def loss_fn(model, batch):
        x, y = batch
        return cross_entropy_loss(model(x), y, RESNET_CLASSES)

    step = hvd.make_train_step(model, loss_fn, opt)
    batch = _resnet_batch(dev)

    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = _train(name, step, batch, steps)
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    if any(launches.values()):
        raise AssertionError(
            f"{name}: kernels launched {launches}; this path runs no "
            "kernel of the library")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(times)
    images_s = RESNET_BATCH / step_ms * 1e3
    mfu = images_s * RESNET50_TRAIN_FLOPS_PER_IMAGE / PEAK_FLOPS["bfloat16"]
    sync = ("" if process_set is None else
            f", every BatchNorm synchronized over ranks {process_set.ranks}")
    print(f"train {name}: ResNet-50 {n_params / 1e6:.1f}M params, batch "
          f"{RESNET_BATCH}x{RESNET_IMAGE}x{RESNET_IMAGE}x3, bf16 compute, "
          f"channels_last, SGD 0.1 momentum 0.9, {len(opt._buckets)} "
          f"allreduce buckets (bf16 wire){sync}, losses "
          f"{[round(v, 4) for v in losses]}")
    print(f"train {name}: step_ms median {step_ms:.2f} (steps "
          f"{[round(t, 2) for t in times]}), images/s {images_s:.1f}, MFU "
          f"{mfu:.4f} (24.53 GFLOP per image over 989 TFLOP/s), "
          f"max_memory_allocated {peak_gib:.2f} GiB on {card}")
    print(f"train {name}: launches per kernel {launches} over {steps} "
          "steps")
    busy_ms = profile_steps(name, step, batch, card, step_ms)
    opt.remove_hooks()
    del model, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return busy_ms


def _resnet_batch(dev):
    """bench.py's synthetic ResNet-50 batch (bench.py:570-572): images and
    labels from seed 0, on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    x = rng.rand(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3).astype(
        np.float32)
    y = rng.randint(0, RESNET_CLASSES, size=(RESNET_BATCH,)).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def lenet_phase(card):
    """LeNet data-parallel training on MNIST-sized inputs; the loss must
    fall."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.lenet import LeNet, cross_entropy_loss

    dev = hvd.device()
    torch.manual_seed(0)
    model = LeNet(device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    def loss_fn(model, batch):
        x, y = batch
        return cross_entropy_loss(model(x), y)

    step = hvd.make_train_step(model, loss_fn, opt)
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.rand(64, 28, 28, 1).astype(np.float32)).to(
        dev), torch.from_numpy(rng.randint(0, 10, size=64)).to(dev))
    losses, _ = _train("lenet", step, batch, 5)
    print(f"train lenet: 5 steps at 64x28x28x1, losses "
          f"{[round(v, 4) for v in losses]} on {card}")
    opt.remove_hooks()


def conv_phase(card):
    """``conv1x1`` forward and backward through autograd at the ResNet-50
    shapes, in bf16 and then in float32 (the counters set to 0 before each):
    one filter-gradient launch per backward; dx and dw against the plain
    counterpart (plain products and ``dw_1x1_plain``). Returns the launch
    counts (``dw_1x1``, ``dw_1x1_float32``)."""
    import torch

    from horovod_tpu_torch.ops import _kernels
    from horovod_tpu_torch.ops import conv_backward as C

    gen = torch.Generator(device="cuda").manual_seed(2)
    counts = {}
    for dtype, key in ((torch.bfloat16, "dw_1x1"),
                       (torch.float32, "dw_1x1_float32")):
        dname = str(dtype).split(".")[-1]
        _kernels.DW_1X1.launches = 0
        results = []
        for case, N, H, W, ci, co, strides in CONV_SHAPES:
            x = torch.randn(N, H, W, ci, generator=gen, device="cuda").to(
                dtype).requires_grad_()
            w = (torch.randn(1, 1, ci, co, generator=gen, device="cuda")
                 / math.sqrt(ci)).to(dtype).requires_grad_()
            out = C.conv1x1(x, w, strides)
            dy = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            out.backward(dy)
            results.append((case, N, H, W, co, x, w, dy, strides, out))
        torch.cuda.synchronize()
        launches = _kernels.DW_1X1.launches
        if launches != len(CONV_SHAPES):
            raise AssertionError(
                f"conv1x1 {dname}: dw_1x1 launched {launches} times in "
                f"{len(CONV_SHAPES)} backward passes; expected one per "
                "backward")
        for case, N, H, W, co, x, w, dy, strides, out in results:
            want_out = C._conv1x1_forward(x.detach(), w.detach(), strides)
            dx, dw = C.conv1x1_backward(x.detach(), w.detach(), dy, strides,
                                        C.dw_1x1_plain)
            if not (torch.equal(out, want_out) and torch.equal(x.grad, dx)):
                raise AssertionError(f"conv1x1 {case} {dname}: output or dx "
                                     "differs from the plain products")
            want_shape = (N, -(-H // strides[0]), -(-W // strides[1]), co)
            if tuple(out.shape) != want_shape:
                raise AssertionError(f"conv1x1 {case}: output shape "
                                     f"{tuple(out.shape)}, expected "
                                     f"{want_shape}")
            if not (torch.isfinite(w.grad).all() and w.grad.dtype == w.dtype
                    and w.grad.shape == w.shape):
                raise AssertionError(f"conv1x1 {case}: dw {w.grad.dtype} "
                                     f"{tuple(w.grad.shape)} not finite")
            # dw in w's dtype: bf16 rounds it (TOL), float32 keeps the
            # kernel's sums (TOL_DW).
            err, line = _hold(f"conv1x1 {case} {dname}", "dw", (w.grad,),
                              (dw,), TOL_DW[dname] if dtype == torch.float32
                              else TOL[dname])
            print(f"{line}; output and dx equal to the plain products; "
                  f"output {tuple(out.shape)} on {card}")
        print(f"conv1x1 {dname}: dw_1x1 launched {launches} times in "
              f"{len(CONV_SHAPES)} backward passes")
        counts[key] = launches
        del results
    return counts


_CATEGORIES = (  # first match wins; by lower-cased kernel name
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_3xtf32_kernel",
                   "flash_fwd_no_key_kernel")),
    ("flash_dq", ("flash_dq_kernel", "flash_dq_3xtf32_kernel")),
    ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_3xtf32_kernel")),
    ("flash_fwd_single", ("flash_fwd_single_kernel",
                          "flash_fwd_single_3xtf32_kernel")),
    ("flash_dqkv", ("flash_dqkv_kernel", "flash_dqkv_3xtf32_kernel")),
    ("flash_fwd_wide", ("flash_fwd_wide_kernel",
                        "flash_fwd_wide_3xtf32_kernel")),
    ("flash_dq_wide", ("flash_dq_wide_kernel", "flash_dq_wide_3xtf32_kernel")),
    ("flash_dkv_wide", ("flash_dkv_wide_kernel",
                        "flash_dkv_wide_3xtf32_kernel")),
    ("dw_1x1", ("dw_1x1_kernel", "dw_1x1_3xtf32_kernel",
                "dw_1x1_reduce_kernel")),
    # cuDNN's convolutions (implicit-GEMM xmma/cutlass kernels named for
    # fprop, dgrad and wgrad), ahead of matmul, whose keys they would match.
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit_gemm",
              "implicit_convolve")),
    ("batchnorm", ("bn_fw", "bn_bw", "batch_norm")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
    ("nccl", ("nccl",)),
    ("optimizer", ("multi_tensor_apply",)),
)


def _busy_us(spans):
    """µs in which at least one of the (start, end) spans runs."""
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy_us + (cur_end - cur_start if spans else 0.0)


def profile_steps(path, step, batch, card, step_ms, n=2):
    """Device time per step by kernel category over ``n`` profiled steps;
    the device's idle share of the unprofiled step (``step_ms``). Returns
    the device busy ms per step (None if the profiler recorded nothing)."""
    import torch

    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_cat: dict[str, float] = {}
    other: dict[str, float] = {}
    spans = []
    for name, start, end in device_events(prof):
        spans.append((start, end))
        lower = name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in lower for k in keys)), "other")
        per_cat[cat] = per_cat.get(cat, 0.0) + (end - start) / 1e3
        if cat == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + (end - start) / 1e3
    if not spans:
        print(f"profile {path}: the profiler recorded no device events; "
              "device breakdown not measured")
        return None
    busy_ms = _busy_us(spans) / 1e3
    cats = ", ".join(f"{c} {t / n:.2f}" for c, t in
                     sorted(per_cat.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{name} {t / n:.2f}" for name, t in
                    sorted(other.items(), key=lambda kv: -kv[1])[:8])
    print(f"profile {path}: per step device ms by category: {cats}")
    print(f"profile {path}: largest 'other' kernels, ms per step: {top}")
    print(f"profile {path}: device busy {busy_ms / n:.2f} ms per step; idle share "
          f"of the unprofiled {step_ms:.2f} ms step "
          f"{max(0.0, 1 - busy_ms / n / step_ms):.3f} (under the profiler "
          f"the step took {wall_ms / n:.2f} ms) on {card}")
    return busy_ms / n


# The head-dim-256 path: a Gemma-like stack of attention layers (8
# sequences of 512, 16 heads of 256) through flash_attention_lse, forward
# and backward, then the same at S = 128 (64 sequences), which takes the
# multi-tile kernels too.
WIDE_LAYERS = 4
WIDE_SHAPES = ((8, 16, 512, 256), (64, 16, 128, 256))
# Then float32 layers (the 3xTF32 forwards, dQ and dK/dV): the Gemma-like
# shape, and BERT-Large's at S = 512 (multi-tile) and S = 128 (single-tile):
# (B, H, S, D), the kernels each layer runs once, and the kernels line's
# names for their counts.
F32_LAYERS = 2
F32_PATHS = (
    ((8, 16, 512, 256), ("flash_fwd", "flash_dq", "flash_dkv"),
     "_d256_float32", ("flash_fwd", "flash_dq", "flash_dkv")),
    ((8, 16, 512, 64), ("flash_fwd", "flash_dq", "flash_dkv"), "_float32",
     ("flash_fwd", "flash_dq", "flash_dkv")),
    ((64, 16, 128, 64), ("flash_fwd_single", "flash_dqkv"), "_float32",
     ("flash_fwd_single", "flash_dqkv")),
)


# Spin kernels launched at the start of every profile session
# (``device_profile``) before the work it profiles: on the H100 with torch
# 2.11 a session often misses its first kernels, so a profile of the float32
# dQ and dK/dV alone may hold no device event; with a few launches of its own
# first it holds the work's kernels. ``device_events`` leaves them out.
PROFILE_WARMUP_KERNELS = 4
_WARMUP_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


@contextlib.contextmanager
def device_profile():
    """A torch.profiler session of the host and the card, opened with
    ``PROFILE_WARMUP_KERNELS`` spin kernels; the work in its body ends
    synchronized."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def device_events(prof):
    """(name, start µs, end µs) of every device kernel or copy that a
    ``device_profile`` session recorded, its spin kernels and the device-side
    copies of host annotations (Optimizer.step, ..., which span kernels
    counted on their own) left out."""
    import torch

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and _WARMUP_KERNEL not in e.name]


# A session that recorded no device event at all, not even its warm-up
# spins, is the profiler's miss (ROADMAP C8): ``_attention_kernels_ms`` runs
# it again, at most this many times. A session that recorded other kernels
# is never retried.
PROFILE_RETRIES = 2


def _recorded_nothing(prof):
    """Whether a ``device_profile`` session holds no device event at all,
    its warm-up spins included."""
    import torch

    return not any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())


def _attention_kernels_ms(run):
    """Device ms of the port's flash-attention kernels in one profiled
    ``run()``, by kernel name (with its template arguments). A session
    that recorded no device event at all runs ``run()`` again in a new
    one, at most ``PROFILE_RETRIES`` times, and says so."""
    for attempt in range(PROFILE_RETRIES + 1):
        with device_profile() as prof:
            run()
        if not _recorded_nothing(prof) or attempt == PROFILE_RETRIES:
            break
        print(f"profile: the session recorded no device event, not even its "
              f"{PROFILE_WARMUP_KERNELS} warm-up spins; running it again "
              f"({attempt + 1} of {PROFILE_RETRIES})", flush=True)
    ms = {}
    for name, start, end in device_events(prof):
        found = re.search(r"flash_\w+(<[^>]*>)?", name)
        if found:
            ms[found.group(0)] = ms.get(found.group(0), 0.0) + (end - start) / 1e3
    return ms


def wide_heads_phase():
    """Head dims above 128 through the entry point: each layer launches the
    D = 256 forward, dQ and dK/dV once and no other kernel, in bf16; then
    float32 layers at ``F32_PATHS``' shapes, each layer launching its
    route's kernels once (the 3xTF32 forward, dQ and dK/dV on the
    multi-tile route) and no other, with a profile of the flash kernels they
    ran, which must be the 3xTF32 ones where they exist (the counters set
    to 0 before each shape); the outputs are finite. Returns the launch
    counts of this path (``flash_*_d256`` for bf16,
    ``flash_*_d256_float32``, ``flash_*_float32`` at S = 512 and
    ``flash_fwd_single_float32``)."""
    import torch

    from horovod_tpu_torch.ops import _kernels
    from horovod_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(5)
    layers = [[torch.randn(B, H, S, D, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3)]
              for B, H, S, D in WIDE_SHAPES for _ in range(WIDE_LAYERS)]
    for k in _kernels.KERNELS:
        k.launches = 0
    for q, k, v in layers:
        out, lse = A.flash_attention_lse(q, k, v, causal=True)
        (out.float().square().sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    want = len(layers)
    expected = {k.name: 0 for k in _kernels.KERNELS}
    expected.update(flash_fwd=want, flash_dq=want, flash_dkv=want)
    if launches != expected:
        raise AssertionError(f"wide heads: launches {launches}; expected "
                             f"{want} of each multi-tile kernel and no other")
    for q, k, v in layers:
        if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
            raise AssertionError("wide heads: non-finite gradients")
    print(f"wide heads: {len(layers)} causal bf16 attention layers at "
          f"{WIDE_SHAPES} (B, H, S, D) through flash_attention_lse, forward "
          f"and backward: launches {launches}")
    counts = {f"{k}_d256": n for k, n in launches.items()
              if k in ("flash_fwd", "flash_dq", "flash_dkv")}
    for (B, H, S, D), kernels, suffix, named in F32_PATHS:
        layers = [[torch.randn(B, H, S, D, generator=gen, device="cuda")
                   .requires_grad_() for _ in range(3)]
                  for _ in range(F32_LAYERS)]

        def run():
            for q, k, v in layers:
                out, lse = A.flash_attention_lse(q, k, v, causal=True)
                (out.square().sum() + lse.sum()).backward()

        for k in _kernels.KERNELS:
            k.launches = 0
        run()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _kernels.KERNELS}
        expected = {k.name: 0 for k in _kernels.KERNELS}
        expected.update({k: F32_LAYERS for k in kernels})
        if launches != expected:
            raise AssertionError(f"float32 layers {(B, H, S, D)}: launches "
                                 f"{launches}; expected {F32_LAYERS} of each "
                                 f"of {kernels} and no other")
        for q, k, v in layers:
            if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
                raise AssertionError(f"float32 layers {(B, H, S, D)}: "
                                     "non-finite gradients")
        for q, k, v in layers:
            for t in (q, k, v):
                t.grad = None
        kernel_ms = _attention_kernels_ms(run)
        # Every kernel of the route must have run its 3xTF32 instance.
        ran = {n.split("<")[0] for n in kernel_ms}
        if ran != {f"{k}_3xtf32_kernel" for k in kernels}:
            raise AssertionError(f"float32 layers {(B, H, S, D)}: profiled "
                                 f"kernels {sorted(kernel_ms)}; expected the "
                                 f"3xTF32 instances of {kernels}")
        print(f"wide heads: {F32_LAYERS} causal float32 attention layers at "
              f"{(B, H, S, D)} (B, H, S, D), forward and backward (the 3xTF32 "
              f"{', '.join(kernels)}): "
              f"launches {launches}; profiled device ms of the flash kernels: "
              + ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(
                  kernel_ms.items(), key=lambda kv: -kv[1])))
        counts.update({f"{k}{suffix}": launches[k] for k in named})
    return counts


# Head dims above 256 (the wide-head kernels): name, B*H, Sq, Sk, D, causal,
# q_offset, k_offset, timed. D = 512 at B*H = 32, S = 512 is timed into the
# kernels line; D = 320 is causal and ragged (200 rows over 300 keys, rows
# 0..39 seeing none), D = 1024 a launch at 4 x 128 and the long causal case
# has 35 Q tiles (two chunks of the float32 dK/dV, whose chunk is at most
# 32), each in bf16, float16 and float32.
WIDE_CASES = (
    ("wide_d512", 32, 512, 512, 512, False, 0, 0, True),
    ("wide_d320_causal_ragged", 6, 200, 300, 320, True, 0, 40, False),
    ("wide_d1024", 4, 128, 128, 1024, True, 0, 0, False),
    ("wide_d320_causal_long", 2, 2200, 300, 320, True, 0, 0, False),
)
# The wide-head path: a stack of causal bf16 attention layers at D = 512
# through flash_attention_lse (B, H, S, D), then F32_LAYERS float32 layers
# at the same shape (the 3xTF32 forward, dQ and dK/dV).
WIDE_PATH_LAYERS = 4
WIDE_PATH_SHAPE = (2, 16, 512, 512)
WIDE_KERNELS = ("flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide")


def _sdpa_backend(q4, k4, v4, do4):
    """The first of SDPA's backends that takes these inputs, with its
    forward and backward ms: ``(name, fwd_ms, bwd_ms, refusals)``; name
    None when none does."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    refusals = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(q4, k4, v4)
                torch.cuda.synchronize()
        except RuntimeError as e:
            refusals.append(f"{backend.name}: {str(e).splitlines()[0][:80]}")
            continue
        with sdpa_kernel(backend):
            fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4))
            out4 = F.scaled_dot_product_attention(q4, k4, v4)
            bwd_ms = time_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
        return backend.name, fwd_ms, bwd_ms, refusals
    return None, None, None, refusals


def wide_phase():
    """The three wide-head kernels against their plain versions in bf16,
    float16 and float32 (``WIDE_CASES``), the D = 512 bf16 case timed
    beside its bound and SDPA, the float32 forward, dQ and dK/dV (3xTF32)
    beside their bound and SDPA's float32 forward and backward, with their
    errors against float64; then the wide-head paths, bf16 and float32, with
    the counters set to 0 just before each: every layer launches each wide
    kernel once and no other kernel, and the float32 layers' profile names
    the 3xTF32 forward, dQ and dK/dV. Returns (measurements, launches)."""
    import torch

    from horovod_tpu_torch.ops import _kernels
    from horovod_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    measured = {}
    for (case, BH, Sq, Sk, D, causal, qo, ko, timed) in WIDE_CASES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            dname = str(dtype).split(".")[-1]

            def rnd(*shape, dt=dtype):
                return torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dt)

            q, k, v, do = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D), \
                rnd(BH, Sq, D)
            o_ref, lse_ref = A.flash_fwd_plain(q, k, v, causal, qo, ko)
            delta = (do.float() * o_ref.float()).sum(-1)
            glse = rnd(BH, Sq, dt=torch.float32)
            bwd_args = (q, k, v, do, lse_ref, delta, glse, causal, qo, ko)
            fwd_args = (q, k, v, causal, qo, ko)
            runs = {
                "flash_fwd_wide": (lambda: A.flash_fwd(*fwd_args),
                                   lambda: A.flash_fwd_plain(*fwd_args)),
                "flash_dq_wide": (lambda: (A.flash_dq(*bwd_args),),
                                  lambda: (A.flash_dq_plain(*bwd_args),)),
                "flash_dkv_wide": (lambda: A.flash_dkv(*bwd_args),
                                   lambda: A.flash_dkv_plain(*bwd_args)),
            }
            library = {}
            if timed and dtype != torch.float16:
                B, H = 1, BH
                q4, k4, v4 = (t.view(B, H, -1, D).detach().requires_grad_()
                              for t in (q, k, v))
                backend, fwd_ms, bwd_ms, refusals = _sdpa_backend(
                    q4, k4, v4, do.view(B, H, -1, D))
                print(f"library {case} {dname}: SDPA backend {backend} "
                      f"(forward {fwd_ms} ms, backward dQ+dK+dV {bwd_ms} "
                      f"ms); refused by: {refusals or 'none'}")
                library = {"flash_fwd_wide": fwd_ms}
            for name, (kern, plain) in runs.items():
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                fwd = name == "flash_fwd_wide"
                err, line = _hold(f"{case}_{dname}", name, got, want,
                                  TOL[dname], lse_index=1 if fwd else None)
                if fwd:
                    empty = int((want[1] == A.LSE_MASKED).sum().item())
                    if empty != int((got[1] == A.LSE_MASKED).sum().item()):
                        raise AssertionError(
                            f"{case}: masked-row sentinels differ")
                    line += f" (fully masked rows: {empty})"
                    if timed and dtype == torch.float32:
                        fwd_pair = (got, want)
                bounds, fma = _kernel_bounds(name[:-len("_wide")], BH, Sq,
                                             Sk, D, dname, causal, qo, ko)
                if timed and (dtype == torch.bfloat16 or fma is not None):
                    numbers, text = _timing(kern, plain, bounds,
                                            library.get(name), fma)
                    key = name if fma is None else f"{name}_float32"
                    measured[key] = dict(max_abs_err=err, **numbers)
                    line += text
                elif timed:
                    line += (f" ms {time_ms(kern):.4f} bound_ms "
                             f"{bounds[0]:.4f} ({bounds[1]})")
                print(line)
            if timed and dtype == torch.float32:
                _f64_check(f"{case}_float32", q, k, v, None, *fwd_pair,
                           causal, qo, ko)
                # The 3xTF32 dQ and dK/dV against float64 (no lse
                # cotangent, as _f64_check's reference).
                rows = (lse_ref, delta, torch.zeros_like(glse), causal, qo,
                        ko)
                got = (A.flash_dq(q, k, v, do, *rows),
                       *A.flash_dkv(q, k, v, do, *rows))
                plain = (A.flash_dq_plain(q, k, v, do, *rows),
                         *A.flash_dkv_plain(q, k, v, do, *rows))
                _f64_check(f"{case}_float32", q, k, v, do, got, plain,
                           causal, qo, ko)
    launches = {}
    B, H, S, D = WIDE_PATH_SHAPE
    for dtype, n_layers in ((torch.bfloat16, WIDE_PATH_LAYERS),
                            (torch.float32, F32_LAYERS)):
        layers = [[torch.randn(B, H, S, D, generator=gen, device="cuda",
                               dtype=dtype).requires_grad_()
                   for _ in range(3)] for _ in range(n_layers)]

        def run():
            for q, k, v in layers:
                out, lse = A.flash_attention_lse(q, k, v, causal=True)
                (out.float().square().sum() + lse.sum()).backward()

        for kern in _kernels.KERNELS:
            kern.launches = 0
        run()
        torch.cuda.synchronize()
        counts = {kern.name: kern.launches for kern in _kernels.KERNELS}
        expected = {kern.name: 0 for kern in _kernels.KERNELS}
        expected.update({name: n_layers for name in WIDE_KERNELS})
        if counts != expected:
            raise AssertionError(f"wide {dtype}: launches {counts}; expected "
                                 f"{n_layers} of each wide kernel and no "
                                 "other")
        for q, k, v in layers:
            if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
                raise AssertionError(f"wide {dtype}: non-finite gradients")
        line = (f"wide: {n_layers} causal {dtype} attention layers at "
                f"{WIDE_PATH_SHAPE} (B, H, S, D) through flash_attention_lse, "
                f"forward and backward: launches {counts}")
        if dtype == torch.bfloat16:
            launches.update({name: counts[name] for name in WIDE_KERNELS})
        else:
            for q, k, v in layers:
                for t in (q, k, v):
                    t.grad = None
            kernel_ms = _attention_kernels_ms(run)
            want = {f"{name}_3xtf32_kernel" for name in WIDE_KERNELS}
            if {n.split("<")[0] for n in kernel_ms} != want:
                raise AssertionError(f"wide float32: profiled kernels "
                                     f"{sorted(kernel_ms)}; expected "
                                     f"{sorted(want)}")
            line += ("; profiled device ms of the flash kernels: "
                     + ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(
                         kernel_ms.items(), key=lambda kv: -kv[1])))
            launches.update({f"{name}_float32": counts[name]
                             for name in WIDE_KERNELS})
        print(line)
    return measured, launches


def collectives_phase(card):
    """Every eager collective, async form and helper at world size 1 over
    NCCL, on BERT-Large's gradient leaves (full width, float32), each held
    to what a one-rank world returns, each timed."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    with torch.device("meta"):
        shapes = [p.shape for p in
                  bert_mod.Bert(bert_mod.BERT_LARGE).parameters()]
    gen = torch.Generator(device="cuda").manual_seed(6)
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    numel = sum(g.numel() for g in grads)
    big = max(grads, key=lambda g: g.numel())

    def same(name, got, want):
        got, want = list(got), list(want)
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"collectives {name}: differs from the "
                                 "one-rank result")

    def timed(name, fn):
        print(f"collective {name}: {time_ms(fn, reps=5, warmup=1):.3f} ms "
              f"on {card}")

    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product):
        same(f"reducescatter {op}",
             hvd.grouped_reducescatter(grads, op=op, prescale_factor=2.0,
                                       postscale_factor=0.5), grads)
    timed(f"grouped_reducescatter of {len(grads)} leaves ({numel} values)",
          lambda: hvd.grouped_reducescatter(grads))
    same("alltoall", [hvd.alltoall(g) for g in grads], grads)
    timed("alltoall of each leaf", lambda: [hvd.alltoall(g) for g in grads])
    pairs = [hvd.alltoall(g, splits=[g.shape[0]]) for g in grads]
    same("alltoall with splits", [o for o, _ in pairs], grads)
    if any(r.tolist() != [g.shape[0]] for (_, r), g in zip(pairs, grads)):
        raise AssertionError("collectives alltoall: received splits")
    timed("alltoall with splits of each leaf",
          lambda: [hvd.alltoall(g, splits=[g.shape[0]]) for g in grads])
    same("grouped_allgather", hvd.grouped_allgather(grads), grads)
    timed("grouped_allgather", lambda: hvd.grouped_allgather(grads))
    timed("grouped_allreduce", lambda: hvd.grouped_allreduce(grads))

    inplace = big.clone()
    handles = {
        "allreduce_async_": (hvd.allreduce_async_(inplace, op=hvd.Sum),
                             inplace),
        "allreduce_async": (hvd.allreduce_async(big), big),
        "allgather_async": (hvd.allgather_async(big), big),
        "broadcast_async": (hvd.broadcast_async(big, root_rank=0), big),
        "broadcast_async_": (hvd.broadcast_async_(big.clone(), 0), big),
        "alltoall_async": (hvd.alltoall_async(big), big),
        "reducescatter_async": (hvd.reducescatter_async(big), big),
        "grouped_allreduce_async": (hvd.grouped_allreduce_async(grads),
                                    grads),
        "grouped_allgather_async": (hvd.grouped_allgather_async(grads),
                                    grads),
        "grouped_reducescatter_async": (
            hvd.grouped_reducescatter_async(grads), grads),
    }
    splits_handle = hvd.alltoall_async(big, splits=[big.shape[0]])
    deadline = time.monotonic() + 60
    while not all(hvd.poll(h) for h in [splits_handle, *(
            h for h, _ in handles.values())]):
        if time.monotonic() > deadline:
            raise AssertionError("collectives: poll never saw the async "
                                 "ops complete")
    for name, (h, want) in handles.items():
        got = hvd.synchronize(h)
        if name == "allreduce_async_" and got is not inplace:
            raise AssertionError("collectives allreduce_async_: not in place")
        same(name, got if isinstance(got, list) else [got],
             want if isinstance(want, list) else [want])
    out, received = hvd.synchronize(splits_handle)
    same("alltoall_async with splits", [out], [big])
    if received.tolist() != [big.shape[0]]:
        raise AssertionError("collectives alltoall_async: received splits")
    try:
        hvd.synchronize(handles["allreduce_async"][0])
    except ValueError:
        pass
    else:
        raise AssertionError("collectives: a synchronized handle was known")
    timed("allreduce_async + synchronize of the largest leaf",
          lambda: hvd.synchronize(hvd.allreduce_async(big)))
    timed("grouped_allreduce_async + poll + synchronize",
          lambda: (lambda h: (hvd.poll(h), hvd.synchronize(h)))(
              hvd.grouped_allreduce_async(grads)))

    obj = {"rank": hvd.rank(), "shapes": [tuple(s) for s in shapes[:3]]}
    if hvd.allgather_object(obj) != [obj]:
        raise AssertionError("collectives allgather_object")
    timed("allgather_object", lambda: hvd.allgather_object(obj))
    same("masked_average", [hvd.masked_average(big, 1.0),
                            hvd.masked_average(big, 0.0)],
         [big, torch.zeros_like(big)])
    timed("masked_average of every leaf",
          lambda: hvd.masked_average(grads, 1.0))
    try:
        hvd.add_process_set([0])
    except ValueError as e:
        dup = str(e)
    else:
        raise AssertionError("add_process_set([0]) did not raise on a "
                             "one-rank world")
    print(f"collectives: world size {hvd.size()} over NCCL, "
          f"{len(grads)} BERT-Large gradient leaves ({numel} float32 "
          "values): reducescatter (5 ops, scaled), alltoall with and "
          "without splits, grouped forms, 11 async forms with poll and "
          "synchronize, allgather_object and masked_average equal to the "
          f"one-rank results; add_process_set([0]) raised: {dup}")


# The sync modes' BERT-Large runs: steps per run (the first WARMUP_STEPS
# untimed), the profiled steps the timed runs take after them, and the
# learning rates of the two optimizers the phase runs.
MODE_STEPS = 5
MODE_PROFILED_STEPS = 2
MODE_LR = 1e-4
MODE_SGD_LR, MODE_SGD_MOMENTUM = 1e-2, 0.9
# Each sync mode is held to a reference run that computes the same function
# from the same weights and batch: its parameters' gap ||p - p_ref|| /
# ||p_ref - p0|| over all parameters (p0 the initial weights; the
# denominator is what the reference's updates moved) within MODE_GAP_BOUND,
# and every loss within MODE_LOSS_RTOL of the reference's. The references
# are allreduce runs: on the float32 wire as they are; on the bf16 wire
# with the parameters rounded to bf16 after every step for the sharded mode
# (which gathers its updated parameters through the wire), and with the
# forward reading them rounded to bf16 for fsdp (which gathers them through
# the wire for the forward, and keeps float32 shards). A control run
# (sharded, float32 wire, one bucket's reduced gradients dropped) must fail
# the check.
#
# The parameters are held on SGD with momentum. Correct runs measured gaps
# of 0.0068 to 0.0076 (0 for sharded on the bf16 wire), the control 0.197,
# on one H100 80GB HBM3 at 700 W; the bound sits 4x above the first and
# 6.6x below the second. No single parameter is held: the
# attention key biases, whose gradient is zero but for rounding, move by
# their rounding alone, and differ by more than their own move between any
# two runs (1.2 to 1.3 of it). AdamW divides each gradient by its own
# magnitude, so it turns such differences into moves of up to lr wherever
# a gradient is near zero: correct AdamW runs measured gaps of 0.048 to
# 0.222 against the control's 0.276, so the AdamW runs (the timed ones) are
# held on their losses.
MODE_GAP_BOUND = 0.03
MODE_LOSS_RTOL = 1e-3
FSDP_SEGMENTS = 4
# The checkpoint phase: BERT-Large at full width cut to 2 layers, the plain
# float32 wire. What a load restores (parameters, AdamW state) must equal
# what was saved bit for bit; the resumed run's parameters after step 4
# must lie within 1e-5 of the uninterrupted run's plus 2 lr per step (its
# embedding gradients are summed with atomics, in an order that changes
# from run to run, and AdamW turns a near-zero gradient's rounding into a
# move of up to lr), and its losses within 1e-3.
CKPT_LAYERS = 2
CKPT_STEPS = 4


def _bert_mode_run(card, name, mode, compression, steps=MODE_STEPS,
                   num_layers=None, profile=False, prepare=None, sgd=False):
    """BERT-Large S = 512 x 8 (``BERT_PATHS[0]``) from seed 0, AdamW (with
    ``sgd``: SGD with momentum), under ``sync_mode=mode`` and
    ``compression``: ``steps`` steps on one batch,
    the counters set to 0 just before them. The multi-tile attention
    kernels must launch once per layer per step and no other kernel.
    With ``profile``, two more steps are profiled (``profile_steps``).
    ``prepare(model, opt, step)`` may return a step to run in its place.
    Returns (model, optimizer, losses, step ms, peak GiB); the peak is
    what the run allocated above what was allocated before it was built.
    With ``steps=0``: the model and optimizer as built."""
    import dataclasses

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops import _kernels

    _, batch_size, seq, predictions, kernels = BERT_PATHS[0]
    dev = hvd.device()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0,
                              num_layers=num_layers
                              or bert_mod.BERT_LARGE.num_layers)
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    inner = (torch.optim.SGD(model.parameters(), lr=MODE_SGD_LR,
                             momentum=MODE_SGD_MOMENTUM) if sgd
             else torch.optim.AdamW(model.parameters(), lr=MODE_LR,
                                    weight_decay=1e-4))
    opt = hvd.DistributedOptimizer(inner, compression=compression,
                                   sync_mode=mode)
    step = hvd.make_train_step(model, _bert_loss, opt)
    if prepare is not None:
        step = prepare(model, opt, step) or step
    batch = _bert_batch(cfg, batch_size, seq, predictions, 0, dev)
    if not steps:
        return model, opt, [], None, None
    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = _train(name, step, batch, steps)
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    for kname, n in launches.items():
        want = cfg.num_layers * steps if kname in kernels else 0
        if n != want:
            raise AssertionError(f"{name}: {kname} launched {n} times in "
                                 f"{steps} steps; expected {want}")
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    step_ms = statistics.median(times) if times else float("nan")
    print(f"{name}: BERT-Large ({cfg.num_layers} layers) S={seq} x "
          f"{batch_size}, sync_mode={mode}, {compression.__name__}, "
          f"losses {[round(x, 5) for x in losses]}, step_ms median "
          f"{step_ms:.2f} (steps {[round(t, 2) for t in times]}), "
          f"max_memory_allocated {peak:.2f} GiB on {card}; launches per "
          f"kernel {launches}")
    if profile:
        profile_steps(name, step, batch, card, step_ms,
                      n=MODE_PROFILED_STEPS)
    return model, opt, losses, step_ms, peak


def _state_bytes(opt) -> int:
    """Bytes of the optimizer state this rank holds (per-parameter
    tensors)."""
    import torch

    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


def _hold_footprint(name, mode, model, opt):
    """``memory.footprint_of(opt)``'s resident parameters and optimizer
    state against what the run holds on the card: the parameters (sharded:
    and the shard copies its inner optimizer steps; fsdp: the shards) and
    ``_state_bytes``. Returns the two byte counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import memory

    fp = memory.footprint_of(opt, model.parameters())
    tensors = (list(model.parameters())
               + (list(opt._shards) if mode == "sharded" else []))
    held = (hvd.resident_param_bytes(opt) if mode == "fsdp" else
            sum(t.numel() * t.element_size() for t in tensors))
    state = _state_bytes(opt)
    if (fp["resident"]["params"], fp["resident"]["opt_state"]) != (held,
                                                                   state):
        raise AssertionError(f"{name}: footprint_of priced {fp['resident']}, "
                             f"the run holds parameters {held} bytes and "
                             f"optimizer state {state} bytes")
    return held, state


def _gap(params, ref, initial):
    """||params - ref|| / ||ref - initial|| over all parameters, the
    parameter whose own such ratio is the largest (index, ratio), and the
    largest difference of any one value."""
    num = den = largest = 0.0
    worst = (0, 0.0)
    for i, (p, r, q) in enumerate(zip(params, ref, initial)):
        diff = p.float() - r.float()
        d = diff.square().sum().item()
        u = (r.float() - q.float()).square().sum().item()
        num, den = num + d, den + u
        largest = max(largest, diff.abs().max().item())
        if u > 0 and (d / u) ** 0.5 > worst[1]:
            worst = (i, (d / u) ** 0.5)
    return (num / den) ** 0.5, worst, largest


def _hold_mode(name, params, losses, ref_params, ref_losses, initial,
          parameters=True):
    """The sync-mode check (``MODE_GAP_BOUND``, ``MODE_LOSS_RTOL``; the
    losses of the run's timed steps against the reference's first ones;
    with ``parameters=False`` the losses alone); returns ``_gap``'s three
    numbers."""
    gap, worst, largest = _gap(params, ref_params, initial)
    ref_losses = ref_losses[:len(losses)]
    far = [(a, b) for a, b in zip(losses, ref_losses)
           if not abs(a - b) <= MODE_LOSS_RTOL * abs(b)]
    if (parameters and not gap <= MODE_GAP_BOUND or far
            or len(losses) != len(ref_losses)):
        raise AssertionError(
            f"{name}: parameters {gap:.4g} of the reference's update away "
            f"(bound {MODE_GAP_BOUND}), losses {losses} against "
            f"{ref_losses}")
    return gap, worst, largest


def _rounded_to_bf16(model, opt, step):
    """The allreduce step with the parameters rounded to bf16 after each
    update: what the sharded mode's bf16-wire allgather does to them."""
    import torch

    def rounded(batch):
        loss = step(batch)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
        return loss

    return rounded


def _forward_on_bf16(model, opt, step):
    """The allreduce step with the forward and backward on the parameters
    rounded to bf16 and the update on their float32 values: what the fsdp
    mode's bf16-wire gather does."""
    import torch

    params = list(model.parameters())
    masters = []

    def rounded(batch):
        with torch.no_grad():
            masters[:] = [p.detach().clone() for p in params]
            for p in params:
                p.copy_(p.to(torch.bfloat16))
        return step(batch)

    update = opt.step

    def on_masters(closure=None):
        with torch.no_grad():
            for p, m in zip(params, masters):
                p.copy_(m)
        return update(closure)

    opt.step = on_masters
    return rounded


def _drop_a_bucket(model, opt, step):
    """The control: a sharded optimizer that loses one bucket's reduced
    gradients (a middle bucket, of encoder weights) every step."""
    import torch

    bucket = opt._buckets[len(opt._buckets) // 2]
    lost = {opt._index[id(p)] for p in bucket}
    reduced = opt._grad_shards

    def without_bucket():
        return [torch.zeros_like(g) if i in lost else g
                for i, g in enumerate(reduced())]

    opt._grad_shards = without_bucket
    return None


def sync_modes_phase(card):
    """BERT-Large at full width under the sharded and fsdp
    (``FSDP_SEGMENTS`` segments) modes, each held to the allreduce run that
    computes the same function from the same weights and batch
    (``_hold_mode``; on the bf16 wire with its parameters rounded as each
    mode's wire rounds them, ``_rounded_to_bf16`` and ``_forward_on_bf16``).
    With SGD and momentum, on the float32 and the bf16 wire, parameters and
    losses, beside a control that must fail the check; with AdamW on the
    bf16 wire, timed and profiled, the losses (the gaps are printed). fsdp
    with one segment runs for its peak memory beside four. Returns the
    AdamW runs' step ms, peak GiB and optimizer-state bytes."""
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optimizer import sync_mode_of

    def free(model, opt):
        opt.remove_hooks()
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()

    def params_of(model, opt):
        return (opt.full_parameters() if sync_mode_of(opt) == "fsdp"
                else [p.detach().clone() for p in model.parameters()])

    def run(name, mode, comp, **kw):
        model, opt, losses, ms, peak = _bert_mode_run(card, name, mode, comp,
                                                      **kw)
        priced[name] = _hold_footprint(name, mode, model, opt)
        out = (params_of(model, opt), losses, ms, peak, _state_bytes(opt),
               hvd.resident_param_bytes(opt) if mode == "fsdp" else None)
        free(model, opt)
        return out

    none, bf16 = hvd.Compression.none, hvd.Compression.bf16
    initial, names, priced = [], [], {}

    def keep_initial(model, opt, step):
        initial.extend(p.detach().clone() for p in model.parameters())
        names.extend(n for n, _ in model.named_parameters())

    os.environ["HOROVOD_FSDP_SEGMENTS"] = str(FSDP_SEGMENTS)
    held, shown, stats = {}, {}, {}
    try:
        ref, ref_losses, *_ = run("sync allreduce sgd f32", "allreduce", none,
                                  sgd=True, prepare=keep_initial)
        for mode in ("sharded", "fsdp"):
            params, losses, *_ = run(f"sync {mode} sgd f32", mode, none,
                                     sgd=True)
            held[f"{mode} sgd f32"] = _hold_mode(
                f"sync {mode} sgd f32", params, losses, ref, ref_losses,
                initial)
        params, losses, *_ = run("sync control sgd f32", "sharded", none,
                                 sgd=True, prepare=_drop_a_bucket)
        try:
            _hold_mode("sync control", params, losses, ref, ref_losses,
                       initial)
        except AssertionError as e:
            control = str(e)
        else:
            raise AssertionError("sync control: a sharded run that drops a "
                                 "bucket's gradients passed the check")
        del ref, params
        for mode, prepare in (("sharded", _rounded_to_bf16),
                              ("fsdp", _forward_on_bf16)):
            ref, ref_losses, *_ = run(f"sync allreduce as {mode} sgd",
                                      "allreduce", bf16, sgd=True,
                                      prepare=prepare)
            params, losses, *_ = run(f"sync {mode} sgd", mode, bf16, sgd=True)
            held[f"{mode} sgd bf16"] = _hold_mode(
                f"sync {mode} sgd bf16", params, losses, ref, ref_losses,
                initial)
            del ref, params

        # AdamW, bf16 wire: the timed runs.
        _, _, ms, peak, state, _ = run("sync allreduce", "allreduce", bf16,
                                       profile=True)
        stats["allreduce"] = (ms, peak, state)
        steps = MODE_STEPS + MODE_PROFILED_STEPS
        for mode, prepare in (("sharded", _rounded_to_bf16),
                              ("fsdp", _forward_on_bf16)):
            ref, ref_losses, *_ = run(f"sync allreduce as {mode}",
                                      "allreduce", bf16, steps=steps,
                                      prepare=prepare)
            params, losses, ms, peak, state, resident = run(
                f"sync {mode}", mode, bf16, profile=True)
            shown[mode] = _hold_mode(f"sync {mode}", params, losses, ref,
                                     ref_losses, initial, parameters=False)
            stats[mode] = (ms, peak, state)
            extra = (f", resident_param_bytes {resident}" if resident
                     else "")
            print(f"sync {mode}: optimizer state {state} bytes on this rank "
                  f"against {stats['allreduce'][2]} in allreduce mode{extra}"
                  ": at world size 1 the shard is the whole, so no memory "
                  "is saved here (chip_diag.py collectives measures it "
                  "across cards)")
            del ref, params
        os.environ["HOROVOD_FSDP_SEGMENTS"] = "1"
        *_, peak1, _, _ = run("sync fsdp 1 segment", "fsdp", bf16)
    finally:
        del os.environ["HOROVOD_FSDP_SEGMENTS"]
    for run_name, (gap, (i, worst), largest) in held.items():
        print(f"sync {run_name}: held to its reference, gap {gap:.6g} (bound "
              f"{MODE_GAP_BOUND}); largest single parameter {names[i]} at "
              f"{worst:.6g}, largest difference of one value {largest:.6g}")
    print(f"sync control (one bucket's gradients dropped) failed the check "
          f"as it must: {control}")
    for mode, (gap, (i, worst), largest) in shown.items():
        print(f"sync {mode} (AdamW): losses held to its reference; "
              f"parameters not held (AdamW scales last-bit differences up "
              f"to lr): gap {gap:.6g}, largest single parameter {names[i]} "
              f"at {worst:.6g}, largest difference of one value "
              f"{largest:.6g}")
    for run_name, (params, state) in priced.items():
        print(f"{run_name}: memory.footprint_of priced the resident "
              f"parameters at {params} bytes and the optimizer state at "
              f"{state} bytes, equal to what the run holds")
    print(f"sync fsdp peak above what the phase held: {stats['fsdp'][1]:.3f} "
          f"GiB with {FSDP_SEGMENTS} segments, {peak1:.3f} GiB with 1, "
          f"allreduce {stats['allreduce'][1]:.3f}, sharded "
          f"{stats['sharded'][1]:.3f} on {card}")
    return stats


def int8_phase(card):
    """BERT-Large in allreduce mode with ``Compression.int8``: losses finite
    and falling on the repeated batch; on one step's gradients the wire's
    round trip (one rank: quantize, dequantize) stays within one quantum of
    each block's scale; ``_sround`` on the card equals the CPU's bit for
    bit."""
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import quantization as Q

    model, opt, losses, ms, peak = _bert_mode_run(
        card, "int8 allreduce", "allreduce", hvd.Compression.int8,
        profile=True)
    _, batch_size, seq, predictions, _ = BERT_PATHS[0]
    batch = _bert_batch(model.config, batch_size, seq, predictions, 0,
                        hvd.device())
    opt.zero_grad(set_to_none=True)
    _bert_loss(model, batch).backward()
    flat = torch.cat([p.grad.reshape(-1).float()
                      for p in model.parameters()])
    opt.zero_grad(set_to_none=True)
    got = Q.int8_allreduce_flat(flat, hvd.global_process_set, "average",
                                salt=opt._updates)
    pad = (-flat.numel()) % Q.BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).view(-1, Q.BLOCK)
    err = torch.nn.functional.pad((got - flat).abs(), (0, pad)).view(
        -1, Q.BLOCK).amax(dim=1)
    scale = blocks.abs().amax(dim=1) / 127.0
    ratio = (err / torch.where(scale > 0, scale,
                               torch.ones_like(scale))).max().item()
    if not (ratio <= 1.0 and torch.isfinite(got).all()):
        raise AssertionError(f"int8: round trip error {ratio:.3f} of a "
                             "block's quantum")
    n = min(1 << 22, flat.numel() // Q.BLOCK * Q.BLOCK)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    sample = flat[:n] / safe[:n // Q.BLOCK].repeat_interleave(Q.BLOCK)
    card_q = Q._sround(sample, 12345)
    cpu_q = Q._sround(sample.cpu(), 12345)
    if not torch.equal(card_q.cpu(), cpu_q):
        raise AssertionError("int8: _sround on the card differs from the CPU")
    print(f"int8: {flat.numel()} gradient values of one step in "
          f"{blocks.shape[0]} blocks of {Q.BLOCK}: round trip within "
          f"{ratio:.4f} of each block's quantum; _sround on {sample.numel()} "
          "scaled values equal on the card and the CPU, bit for bit")
    opt.remove_hooks()
    del model, opt, flat, blocks, got
    gc.collect()
    torch.cuda.empty_cache()
    return ms, peak


def _full_state(opt):
    """The optimizer's state in the monolithic layout, on the CPU (a
    collective in the sharded modes)."""
    import torch

    from horovod_tpu_torch.optimizer import (init_sharded_state,
                                             sync_mode_of, unshard_opt_state)

    if sync_mode_of(opt) == "allreduce":
        state = opt.state_dict()
    else:
        state = unshard_opt_state(opt, init_sharded_state(opt))
    return {i: {k: v.detach().cpu() for k, v in st.items()
                if torch.is_tensor(v)} for i, st in state["state"].items()}


def checkpoint_phase(card):
    """BERT-Large at full width cut to ``CKPT_LAYERS`` layers, float32
    wire: saved after 2 of ``CKPT_STEPS`` steps under sharded and resumed
    under allreduce, and the other way round. The load restores the saved
    parameters and AdamW state bit for bit, and the resumed run ends as
    the uninterrupted allreduce run does (``CKPT_STEPS``' bound)."""
    import gc
    import shutil

    import torch

    import horovod_tpu_torch as hvd

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.join(here, "build", "chip_smoke_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    none = hvd.Compression.none
    try:
        model, opt, ref_losses, _, _ = _bert_mode_run(
            card, "ckpt uninterrupted allreduce", "allreduce", none,
            CKPT_STEPS, CKPT_LAYERS)
        ref = [p.detach().clone() for p in model.parameters()]
        opt.remove_hooks()
        results = []
        for first, second in (("sharded", "allreduce"),
                              ("allreduce", "sharded")):
            path = os.path.join(ckpt_dir, f"{first}.ckpt")
            model, opt, _, _, _ = _bert_mode_run(
                card, f"ckpt {first} to step 2", first, none, 2, CKPT_LAYERS)
            hvd.save_state_on_rank_0(path, opt, model, step=2)
            saved = ([p.detach().cpu().clone() for p in model.parameters()],
                     _full_state(opt))
            opt.remove_hooks()
            model, opt, _, _, _ = _bert_mode_run(
                card, f"ckpt {second} (state replaced below)", second, none,
                0, CKPT_LAYERS)
            obj = hvd.load_state_and_broadcast(path, opt, model)
            state = _full_state(opt)
            exact = all(torch.equal(p.detach().cpu(), q) for p, q in zip(
                model.parameters(), saved[0])) and state.keys() == saved[
                    1].keys() and all(
                torch.equal(state[i][k], v) for i, st in saved[1].items()
                for k, v in st.items())
            if not exact:
                raise AssertionError(f"ckpt {first} -> {second}: the load did "
                                     "not restore the saved parameters and "
                                     "optimizer state bit for bit")
            step = hvd.make_train_step(model, _bert_loss, opt)
            _, batch_size, seq, predictions, _ = BERT_PATHS[0]
            batch = _bert_batch(model.config, batch_size, seq, predictions,
                                0, hvd.device())
            losses = [float(step(batch)) for _ in range(CKPT_STEPS - 2)]
            torch.cuda.synchronize()
            ratio = max(((p - r).abs() / (1e-5 * r.abs() + 2 * MODE_LR
                                          * CKPT_STEPS)).max().item()
                        for p, r in zip(model.parameters(), ref))
            if not (ratio <= 1.0 and all(
                    abs(a - b) <= 1e-3 * abs(b)
                    for a, b in zip(losses, ref_losses[2:]))):
                raise AssertionError(
                    f"ckpt {first} -> {second}: losses {losses} against "
                    f"{ref_losses[2:]}, parameters at {ratio:.3f} of their "
                    "bound")
            results.append(
                f"{first} -> {second} (saved at step {obj['step']}, "
                f"{os.path.getsize(path)} bytes): restored bit for bit, "
                f"losses {[round(x, 5) for x in losses]} against "
                f"{[round(x, 5) for x in ref_losses[2:]]}, parameters at "
                f"{ratio:.3f} of their bound")
            opt.remove_hooks()
            del model, opt
            gc.collect()
            torch.cuda.empty_cache()
        print(f"checkpoint: BERT-Large {CKPT_LAYERS} layers, saved after 2 "
              f"of {CKPT_STEPS} steps and resumed in the other mode: "
              f"{'; '.join(results)}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def guarded_phase(card):
    """BERT-Large S = 512 with num_groups=4 and HOROVOD_NONFINITE_ACTION=
    skip: three steps, the second with a NaN gradient; after it every
    parameter and AdamW state tensor equals its value before, bit for bit,
    and the third (clean) step moves them."""
    import dataclasses
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    name, batch_size, seq, predictions, _ = BERT_PATHS[0]
    dev = hvd.device()
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    params = list(model.parameters())
    os.environ["HOROVOD_NONFINITE_ACTION"] = "skip"
    try:
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
            compression=hvd.Compression.bf16, num_groups=4)
    finally:
        del os.environ["HOROVOD_NONFINITE_ACTION"]
    poison = {"on": False}
    hook = params[5].register_hook(
        lambda g: torch.full_like(g, float("nan")) if poison["on"] else g)
    step = hvd.make_train_step(model, _bert_loss, opt)
    batch = _bert_batch(cfg, batch_size, seq, predictions, 0, dev)

    def snapshot():
        state = [v for p in params for v in opt.state[p].values()
                 if torch.is_tensor(v)]
        return [t.detach().clone() for t in params + state]

    losses = [float(step(batch))]
    before = snapshot()
    poison["on"] = True
    losses.append(float(step(batch)))
    poison["on"] = False
    held = snapshot()
    losses.append(float(step(batch)))
    torch.cuda.synchronize()
    after = snapshot()
    if not all(torch.equal(a, b) for a, b in zip(before, held)):
        raise AssertionError("guarded: the skipped step changed a parameter "
                             "or an AdamW state tensor")
    if all(torch.equal(a, b) for a, b in zip(held, after)):
        raise AssertionError("guarded: the clean step after the skip moved "
                             "nothing")
    if opt.nonfinite_steps != 1 or not math.isfinite(losses[2]):
        raise AssertionError(f"guarded: {opt.nonfinite_steps} detections, "
                             f"losses {losses}")
    print(f"guarded {name}: num_groups=4 gives {len(opt._buckets)} "
          f"allreduce buckets per step (bf16 wire; "
          f"{sum(len(b) for b in opt._buckets)} leaves); "
          f"HOROVOD_NONFINITE_ACTION=skip with a NaN gradient on step 2: "
          f"{len(before)} parameter and AdamW state tensors equal bit for bit "
          f"after it, moved by step 3; losses {[round(x, 4) for x in losses]} "
          f"on {card}")
    hook.remove()
    opt.remove_hooks()
    del model, opt, step, batch, before, held, after
    gc.collect()
    torch.cuda.empty_cache()


def agreement_phase(seq, kernels):
    """The flash model against the same weights with dense attention on a
    small float32 input of ``seq`` tokens: logits, loss and every parameter
    gradient; ``kernels`` (the route of that length) must have run."""
    import copy
    import dataclasses

    import torch

    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops import _kernels

    cfg = dataclasses.replace(bert_mod.BERT_TINY, dropout_rate=0.0,
                              dtype=torch.float32,
                              max_position_embeddings=256)
    torch.manual_seed(1)
    with torch.device("cuda"):
        flash = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    dense = copy.deepcopy(flash)
    for layer in dense.layers:
        layer.attention.attention_fn = bert_mod.default_attention
    batch = _bert_batch(cfg, 2, seq, 12, 1, "cuda")
    for k in _kernels.KERNELS:
        k.launches = 0
    results = []
    for model in (flash, dense):
        loss = _bert_loss(model, batch)
        loss.backward()
        _, logits = model(batch[0], masked_positions=batch[1])
        results.append((loss.detach(), logits.detach(),
                        [p.grad for p in model.parameters()]))
    (l1, z1, g1), (l2, z2, g2) = results
    ran = sorted(k.name for k in _kernels.KERNELS if k.launches)
    if ran != sorted(kernels):
        raise AssertionError(f"agree S={seq}: kernels {ran} ran; expected "
                             f"{sorted(kernels)}")
    # Each tensor: max |flash - dense| <= 1e-4 * max |dense| + 1e-6 (the
    # absolute floor covers gradients that are zero in exact arithmetic,
    # such as the key projection's bias); worst is the largest err/limit.
    worst = max(((a - b).abs().max() / (1e-4 * b.abs().max() + 1e-6)).item()
                for a, b in zip([z1, *g1], [z2, *g2]))
    if not (torch.isfinite(z1).all() and worst <= 1.0
            and abs(l1.item() - l2.item()) <= 1e-5 * abs(l2.item())):
        raise AssertionError(
            f"flash vs dense attention model: worst err/limit {worst:.3e}, "
            f"loss {l1.item()} vs {l2.item()}")
    print(f"agree S={seq} ({', '.join(kernels)}): BERT_TINY float32 flash "
          f"vs dense attention: loss {l1.item():.6f} vs {l2.item():.6f}; "
          f"logits and {len(g1)} grads within 1e-4 relative + 1e-6, worst "
          f"err/limit {worst:.3f}")


def resnet_agreement_phase():
    """ResNet-50 in float32 on the card (TF32 off) against the CPU on the
    same weights, 2 images at 64x64: logits in evaluation and training mode
    within 2e-3 of the largest logit, and the running statistics after the
    training-mode forward within 1e-4. BN scales and biases are drawn at
    random so that every block's branch counts."""
    import copy

    import numpy as np
    import torch

    from horovod_tpu_torch.models import resnet as R

    gen = torch.Generator().manual_seed(3)
    cpu = R.ResNet50(num_classes=RESNET_CLASSES)
    cpu.reset_parameters(gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, R.BatchNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                     generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    card = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 64, 3).astype(
        np.float32))
    worst = {}
    for mode in ("eval", "train"):
        outs = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            getattr(model, mode)()
            with torch.no_grad():
                outs.append(model(x.to(dev)).cpu())
        want, got = outs
        err = (got - want).abs().max().item()
        limit = 2e-3 * want.abs().max().item()
        if not err <= limit:
            raise AssertionError(f"resnet50 card vs cpu {mode} logits: max "
                                 f"abs err {err:.3e} > {limit:.3e}")
        worst[f"{mode} logits"] = err / limit
    stats = [(k, v, card.state_dict()[k].cpu())
             for k, v in cpu.state_dict().items() if "running" in k]
    err = max((b - a).abs().max().item() for _, a, b in stats)
    if not err <= 1e-4:
        raise AssertionError(f"resnet50 card vs cpu: running statistics "
                             f"differ by {err:.3e} > 1e-4")
    print(f"agree resnet50: float32 card (TF32 off, channels_last, cuDNN) vs "
          f"CPU, 2 images at 64x64: logits within 2e-3 of the largest "
          f"(err/limit {worst}); {len(stats)} running statistics after one "
          f"training-mode forward within 1e-4 (max abs err {err:.3e})")

# Adasum on the card: the tree over stacks of N "ranks" of two BERT-Large
# leaf shapes (an FFN kernel and the token embedding), member 1 of each
# stack zero, held to a float64 numpy tree (each output within ADASUM_TOL
# of the largest float64 value: float32 differs by summation order, bf16
# also rounds each pair's result to 8 bits, as the JAX package's does).
ADASUM_RANKS = (2, 3, 4, 5, 8)
ADASUM_SHAPES = ((1024, 4096), (30522, 1024))
ADASUM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ADASUM_STEPS = 3


def adasum_pair_np(a, b):
    """The Adasum rule in float64 numpy: a copy of
    ``horovod_tpu/process_world.py:274 adasum_pair_np``."""
    import numpy as np

    af = a.ravel().astype(np.float64)
    bf = b.ravel().astype(np.float64)
    dot = float(af @ bf)
    asq = float(af @ af)
    bsq = float(bf @ bf)
    a_scale = 1.0 - dot / (2.0 * asq) if asq > 0 else 0.0
    b_scale = 1.0 - dot / (2.0 * bsq) if bsq > 0 else 0.0
    return (a_scale * af + b_scale * bf).reshape(a.shape).astype(a.dtype)


def adasum_tree_np(parts, pair=adasum_pair_np):
    """The pairwise tree of ``horovod_tpu/process_world.py:290``, odd
    leftovers carried to the next round."""
    parts = list(parts)
    while len(parts) > 1:
        nxt = [pair(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _adasum_stack(N, shape, seed):
    """N members, correlated and of different scales (Adasum's case), the
    second all zero; values exactly representable in bf16, so that the
    float32 and bf16 runs share one float64 reference."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shared = torch.randn(shape, generator=gen, device="cuda")
    stack = torch.stack([(r + 1) * (0.7 * shared + torch.randn(
        shape, generator=gen, device="cuda")) for r in range(N)])
    stack[1] = 0.0
    return stack.bfloat16()


def _collective_device_ms(prof):
    """Device ms run under the profiled session's collectives: the device
    time of each outermost host op whose name names NCCL or c10d (at one
    rank, NCCL's all_gather is a device copy and its all_reduce may launch
    nothing), and the ops' names."""
    import torch

    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and ("nccl" in e.name.lower() or "c10d" in e.name.lower())]
    ids = {id(e) for e in ops}

    def outermost(e):
        parent = e.cpu_parent
        while parent is not None:
            if id(parent) in ids:
                return False
            parent = parent.cpu_parent
        return True

    top = [e for e in ops if outermost(e)]
    return (sum(e.device_time_total for e in top) / 1e3,
            sorted({e.name for e in top}))


def _bert_adasum_runs(card, ops):
    """BERT-Large S = 512 x 8 (``BERT_PATHS[0]``) built once from seed 0;
    for each of ``ops``, from those weights, ``ADASUM_STEPS`` AdamW steps
    under ``DistributedOptimizer(op=...)`` on the bf16 wire, the last one
    profiled: {op: (losses, parameters, launch counts, the collectives'
    device ms and op names, device busy ms of the last step)}."""
    import dataclasses
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops import _kernels

    _, batch_size, seq, predictions, _ = BERT_PATHS[0]
    dev = hvd.device()
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(cfg, batch_size, seq, predictions, 0, dev)
    runs = {}
    for op in ops:
        model.load_state_dict(initial)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.bf16, op=op)
        step = hvd.make_train_step(model, _bert_loss, opt)
        for k in _kernels.KERNELS:
            k.launches = 0
        losses = [float(step(batch)) for _ in range(ADASUM_STEPS - 1)]
        with device_profile() as prof:
            losses.append(float(step(batch)))
        launches = {k.name: k.launches for k in _kernels.KERNELS}
        busy = _busy_us([(a, b) for _, a, b in device_events(prof)]) / 1e3
        runs[op] = (losses, [p.detach().clone() for p in model.parameters()],
                    launches, _collective_device_ms(prof), busy)
        opt.remove_hooks()
        model.zero_grad(set_to_none=True)
        del opt, step, prof
    del model, initial, batch
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def adasum_phase(card):
    """(a) ``ops.adasum.adasum_tree`` on the card against the float64 tree
    (``ADASUM_RANKS`` x ``ADASUM_SHAPES``, float32 and bf16); (b) BERT-Large
    S = 512 x 8 with ``DistributedOptimizer(op=Adasum)`` on the forced wire
    (one all_gather per bucket, then the tree: the identity at one rank):
    the loss falls, K1, K3 and K4 launch once per layer and step, and the
    parameters equal bit for bit those of the same steps with
    ``op=Average``. Returns the launch counts of the Adasum run."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.adasum import adasum_tree

    worst = {}
    t0 = time.perf_counter()
    for shape in ADASUM_SHAPES:
        full = _adasum_stack(max(ADASUM_RANKS), shape, seed=shape[0])
        host = list(full.double().cpu().numpy())
        # The trees over the first N members share their subtrees: each
        # float64 pair is computed once.
        memo = {}

        def pair(a, b):
            if (id(a), id(b)) not in memo:
                memo[id(a), id(b)] = adasum_pair_np(a, b)
            return memo[id(a), id(b)]

        for N in ADASUM_RANKS:
            want = adasum_tree_np(host[:N], pair)
            scale = np.abs(want).max()
            want = torch.from_numpy(want).to("cuda")
            for dtype in (torch.float32, torch.bfloat16):
                got = adasum_tree(full[:N].to(dtype))
                name = str(dtype).split(".")[1]
                err = (got.double() - want).abs().max().item()
                if not (got.dtype == dtype and got.shape == shape
                        and err <= ADASUM_TOL[name] * scale):
                    raise AssertionError(
                        f"adasum tree N={N} {shape} {name}: max abs err "
                        f"{err:.3e} > {ADASUM_TOL[name]} x {scale:.3e}")
                worst[name] = max(worst.get(name, 0.0), err / scale)
    print(f"adasum: adasum_tree on the card, N = {ADASUM_RANKS} members of "
          f"{ADASUM_SHAPES} (member 1 zero) against the float64 tree: "
          f"worst max|err| / max|want| {worst} (limits {ADASUM_TOL}), "
          f"{time.perf_counter() - t0:.1f} s")

    _, _, seq, _, kernels = BERT_PATHS[0]
    t0 = time.perf_counter()
    runs = _bert_adasum_runs(card, (hvd.Average, hvd.Adasum))
    losses, params, launches, (wire_ms, wire_ops), busy = runs[hvd.Adasum]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"adasum BERT-Large: loss did not fall: {losses}")
    for kname, n in launches.items():
        want = 24 * ADASUM_STEPS if kname in kernels else 0
        if n != want:
            raise AssertionError(f"adasum BERT-Large: {kname} launched {n} "
                                 f"times; expected {want}")
    ref_losses, ref_params, _, (ref_ms, ref_ops), ref_busy = runs[
        hvd.Average]
    if losses != ref_losses or not all(
            torch.equal(p, q) for p, q in zip(params, ref_params)):
        raise AssertionError(
            "adasum BERT-Large at one rank: the parameters are not those of "
            f"op=Average bit for bit (losses {losses} vs {ref_losses})")
    print(f"adasum BERT-Large S={seq}: {ADASUM_STEPS} AdamW steps with "
          f"op=Adasum on the forced bf16 wire, losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}; "
          f"{len(params)} parameters equal bit for bit to op=Average's, "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"adasum BERT-Large S={seq}: wire device ms of the profiled step "
          f"(its collectives): Adasum {wire_ms:.3f} ({wire_ops}), Average "
          f"{ref_ms:.3f} ({ref_ops}); device busy {busy:.2f} ms against "
          f"{ref_busy:.2f} on {card}")
    return launches


def syncbn_phase(card, plain_busy_ms):
    """ResNet-50 with every BatchNorm synchronized over the global process
    set (the forced wire: one allreduce per layer forward and backward).
    First float32 (TF32 off), train-mode forward on ``_resnet_batch``: the
    logits within 2e-3 of the largest plain logit and the running
    statistics within 1e-4 of the plain model's (cuDNN's BatchNorm); then
    ``resnet_phase``'s bf16 training, 3 steps with the loss falling,
    profiled beside the plain run's device busy ``plain_busy_ms``."""
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as R

    dev = hvd.device()
    gen = torch.Generator().manual_seed(3)
    plain = R.ResNet50(num_classes=RESNET_CLASSES)
    plain.reset_parameters(gen)
    with torch.no_grad():
        for m in plain.modules():
            if isinstance(m, R.BatchNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                     generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    synced = R.ResNet50(num_classes=RESNET_CLASSES, device=dev,
                        process_set=hvd.global_process_set)
    synced.load_state_dict(plain.state_dict())
    plain.to(dev)
    x, _ = _resnet_batch(dev)
    with torch.no_grad():
        want, got = plain(x), synced(x)
    err = (got - want).abs().max().item()
    limit = 2e-3 * want.abs().max().item()
    stats = [(a, b) for (k, a), b in zip(plain.state_dict().items(),
                                         synced.state_dict().values())
             if "running" in k]
    stat_err = max((a - b).abs().max().item() for a, b in stats)
    if not (err <= limit and stat_err <= 1e-4):
        raise AssertionError(
            f"syncbn: float32 logits max abs err {err:.3e} (limit "
            f"{limit:.3e}), running statistics {stat_err:.3e} (limit 1e-4)")
    print(f"syncbn: ResNet-50 float32 (TF32 off), {RESNET_BATCH} images at "
          f"{RESNET_IMAGE}x{RESNET_IMAGE}, train mode, every BatchNorm "
          f"synchronized vs cuDNN's: logits max abs err {err:.3e} (limit "
          f"{limit:.3e}), {len(stats)} running statistics max abs err "
          f"{stat_err:.3e} (limit 1e-4)")
    del plain, synced, x
    gc.collect()
    torch.cuda.empty_cache()
    busy = resnet_phase(card, "resnet50_syncbn", hvd.global_process_set,
                        steps=3)
    # profile_steps gives None when the profiler recorded no device event.
    def per_step(ms):
        return "not measured" if ms is None else f"{ms:.2f} ms"

    print(f"syncbn: ResNet-50 bf16 device busy per step {per_step(busy)} "
          f"with every BatchNorm synchronized (ATen's sync-BatchNorm "
          f"kernels and a 1-rank NCCL allreduce per layer), "
          f"{per_step(plain_busy_ms)} with cuDNN's BatchNorm, in this run "
          f"on {card}")


# The launcher phase's worker: init() on the card, its world facts, one
# Adasum allreduce (the forced wire: gather and tree) and one BERT-Large
# attention layer (S = 512, bf16) forward and backward through the flash
# kernels, held to float32 math within 2e-2 of the largest value.
LAUNCHER_CHILD = r"""
import json, math, time
started = time.time()
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import _kernels, attention

imported = time.time()
hvd.init()
initialized = time.time()
dev = hvd.device()
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn(1024, 4096, generator=gen, device=dev)
y = hvd.allreduce(x, op=hvd.Adasum)
torch.cuda.synchronize()
first_collective = time.time()
assert torch.equal(y, x), "one-member Adasum is not the identity"
q, k, v, g = (torch.randn(8, 16, 512, 64, generator=gen, device=dev)
              for _ in range(4))
leaves = [t.bfloat16().requires_grad_() for t in (q, k, v)]
for kern in _kernels.KERNELS:
    kern.launches = 0
out = attention.flash_attention(*leaves)
out.backward(g.bfloat16())
ran = {kern.name: kern.launches for kern in _kernels.KERNELS if kern.launches}
assert ran == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}, ran
ref = [t.detach().float().requires_grad_() for t in leaves]
p = torch.softmax(ref[0] @ ref[1].transpose(-1, -2) / math.sqrt(64), -1)
o = p @ ref[2]
o.backward(g.bfloat16().float())
for a, b in [(out, o)] + [(t.grad, r.grad) for t, r in zip(leaves, ref)]:
    err = (a.float() - b).abs().max().item()
    assert err <= 2e-2 * b.abs().max().item(), err
checked = time.time()
print("HVD_CHILD " + json.dumps(dict(
    rank=hvd.rank(), size=hvd.size(), local_rank=hvd.local_rank(),
    local_size=hvd.local_size(), cross_rank=hvd.cross_rank(),
    cross_size=hvd.cross_size(), device=str(dev), started=started,
    imported=imported, initialized=initialized,
    first_collective=first_collective, checked=checked, launches=ran)),
    flush=True)
hvd.shutdown()
"""


def launcher_phase(card):
    """``python -m horovod_tpu_torch.runner.launch -np 1 python CHILD``
    without ``--cpu-mode`` (``hvdrun-torch``): the worker runs
    ``LAUNCHER_CHILD`` on the card. Holds its exit code (0), the rank
    prefix on every line of its output and its world facts; prints the
    seconds from the launch to the end of its first collective."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "chip_smoke_launcher")
    os.makedirs(tmp, exist_ok=True)
    child = os.path.join(tmp, "child.py")
    with open(child, "w") as f:
        f.write(LAUNCHER_CHILD)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
             "1", sys.executable, child], cwd=here, env=env,
            capture_output=True, text=True, timeout=300)
        seconds = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = out.stdout.splitlines()
    facts = [json.loads(line.split("HVD_CHILD ", 1)[1]) for line in lines
             if "HVD_CHILD " in line]
    want = dict(rank=0, size=1, local_rank=0, local_size=1, cross_rank=0,
                cross_size=1, device="cuda:0")
    if not (out.returncode == 0 and lines and len(facts) == 1
            and all(line.startswith("[0] ") for line in lines)
            and {k: facts[0][k] for k in want} == want):
        raise AssertionError(
            f"launcher: exit code {out.returncode}, facts {facts}; stdout "
            f"{out.stdout[-2000:]!r}; stderr {out.stderr[-2000:]!r}")
    marks = {k: round(facts[0][k] - t0, 2) for k in (
        "started", "imported", "initialized", "first_collective",
        "checked")}
    print(f"launcher: hvdrun-torch -np 1 ran the worker on the card: exit "
          f"code 0, {len(lines)} lines all prefixed '[0] ', facts "
          f"{ {k: facts[0][k] for k in want} }, launches "
          f"{facts[0]['launches']}; seconds from the launch: worker "
          f"{marks}, launcher's exit {seconds:.2f} on {card}")


# The elastic phase's worker, run by ``hvdrun-torch
# --host-discovery-script`` (one host, localhost:1) in one of two modes:
#   abort: BERT-Large S = 512 x 8 (ELASTIC_LAYERS layers), bf16 wire,
#     AdamW: two uninterrupted ELASTIC_STEPS-step runs from the seed-0
#     weights, then the same steps under @hvd.elastic.run with a TorchState;
#     after step 2's commit in the first world it posts the coordinated
#     abort for its generation, its next collective raises
#     HorovodInternalError, and the loop restores, tears the NCCL group
#     down, forms a new one, syncs and runs steps 3-4.
#   relaunch: the same at ELASTIC_LAYERS layers; the first process runs one
#     uninterrupted run and saves its final parameters beside the
#     checkpoints, then saves each commit through the Checkpointer and exits
#     with 1 after step 2's save. The driver relaunches it after the
#     blacklist cooldown; the new process resumes from disk and runs steps
#     3-4, and only then runs the second uninterrupted run and reads the
#     first's parameters, so that nothing but the relaunch lies between the
#     exit and its first resumed step.
# Either prints "HVD_ELASTIC <json>": its final parameters against the
# uninterrupted run's, the flash kernels' launches per step and world, and
# the times of the recovery's stages.
ELASTIC_CHILD = r"""
import dataclasses, json, os, sys, time
t_start = time.time()
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.models import bert as bert_mod
from horovod_tpu_torch.ops import _kernels
import chip_smoke as smoke
t_imported = time.time()

MODE = os.environ["ELASTIC_SMOKE_MODE"]
STEPS = smoke.ELASTIC_STEPS
# Runs that repeat bit for bit where torch has a deterministic form of an
# op (the embeddings' and the gathers' backward add with atomics
# otherwise); an op without one warns.
torch.use_deterministic_algorithms(True, warn_only=True)
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
marks, worlds = {}, [1]
hvd.init()
t_init = time.time()
dev = hvd.device()
cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0,
                          num_layers=int(os.environ["ELASTIC_SMOKE_LAYERS"]))
torch.manual_seed(0)
with torch.device(dev):
    model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
initial = {k: v.clone() for k, v in model.state_dict().items()}
_, B, S, P, _ = smoke.BERT_PATHS[0]
batches = [smoke._bert_batch(cfg, B, S, P, seed, dev) for seed in range(STEPS)]
t_model = time.time()


def optimizer():
    return hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)


def params():
    return [p.detach().clone() for p in model.parameters()]


def uninterrupted(keep=None):
    model.load_state_dict(initial)
    opt = optimizer()
    step = hvd.make_train_step(model, smoke._bert_loss, opt)
    for b in batches:
        step(b)
        if keep is not None:
            keep.append(params())
    torch.cuda.synchronize()
    opt.remove_hooks()
    return params()


def scrape():
    # The driver's six observability routes, once this rank's heartbeat
    # since the commit and its shipped trace have reached them.
    from urllib.request import urlopen
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.runner.elastic import worker

    base = (f"http://{os.environ['HOROVOD_RENDEZVOUS_ADDR']}:"
            f"{os.environ['HOROVOD_RENDEZVOUS_PORT']}")
    deadline = time.time() + 20
    while True:
        worker.get_worker_context().send_heartbeat()
        text = urlopen(base + "/metrics").read().decode()
        timeline = json.loads(urlopen(base + "/timeline").read())
        tracks = sorted({e["pid"] for e in timeline["traceEvents"]
                         if e["ph"] == "X"})
        parsed = metrics.validate_prometheus_text(text)
        flushes = parsed["hvd_grad_sync_flushes_total"]["samples"]
        if (tracks and flushes) or time.time() > deadline:
            break
        time.sleep(0.2)
    cp = json.loads(urlopen(base + "/criticalpath").read())
    merged = {}
    for route in ("comms", "memory"):
        with urlopen(base + "/" + route) as r:
            body = json.loads(r.read())
            merged[route] = dict(http=r.status, status=body["status"],
                                 ranks=sorted(body["ranks"]),
                                 generation=body["generation"])
        if route == "memory":
            merged[route]["resident"] = body["cluster"]["resident_bytes"]
    return dict(tracks=tracks, families=len(parsed),
                ranks=sorted({lb.get("rank") for lb, _ in flushes}),
                criticalpath=cp["status"], groups=len(cp["groups"]),
                stragglers=json.loads(urlopen(base + "/stragglers").read()),
                **merged)


ckpt = hvd.Checkpointer(os.environ["ELASTIC_SMOKE_CKPT"], max_to_keep=2,
                        async_save=False)
REF_PATH = os.environ["ELASTIC_SMOKE_CKPT"] + ".ref.pt"
resumed = MODE == "relaunch" and ckpt.latest_step() is not None
ref = ref2 = None
ref_steps = []
if MODE == "abort":
    ref, ref2 = uninterrupted(ref_steps), uninterrupted()
elif not resumed:
    torch.save([p.cpu() for p in uninterrupted()], REF_PATH)
model.load_state_dict(initial)
opt = optimizer()
start = 0
if resumed:
    saved = ckpt.restore()
    model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["opt"])
    start = saved["step"]
t_restored = time.time()


def timed(name, fn):
    def call(*a, **k):
        marks.setdefault(name, []).append(time.perf_counter())
        out = fn(*a, **k)
        marks.setdefault(name + "_end", []).append(time.perf_counter())
        return out
    return call


real_init = basics.init
def init(*a, **k):
    real_init(*a, **k)
    worlds[0] += 1
basics.init = timed("init", init)
basics.shutdown = timed("shutdown", basics.shutdown)
hooks = hvd.abort._hooks
hooks[hooks.index(basics._abort_groups)] = timed("comm_abort",
                                                  basics._abort_groups)


def restore(self):
    hvd.elastic.TorchState.restore(self)
    if ref_steps:
        gaps.append(("restored", max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(params(), ref_steps[self.step - 1]))))


class State(hvd.elastic.TorchState):
    restore = timed("restore", restore)
    sync = timed("sync", hvd.elastic.TorchState.sync)


state = State(model=model, optimizer=opt, step=start)
step_fn = hvd.make_elastic_train_step(model, smoke._bert_loss, opt)
launches, losses, errors, gaps, walls = [], [], [], [], []
posted, probe, scraped = [], [], {}


@hvd.elastic.run
def train(state):
    while state.step < STEPS:
        if probe:
            probe.pop()
            try:
                hvd.allreduce(torch.zeros(1, device=dev))
            except hvd.HorovodInternalError as e:
                errors.append(str(e))
                raise
        for k in _kernels.KERNELS:
            k.launches = 0
        loss = float(step_fn(batches[state.step]))
        torch.cuda.synchronize()
        launches.append(dict(world=worlds[0], step=state.step + 1, **{
            k.name: k.launches for k in _kernels.KERNELS if k.name in FLASH}))
        if ref_steps:
            gaps.append(max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(params(), ref_steps[state.step])))
        if len(launches) == 1 or launches[-1]["world"] != launches[-2]["world"]:
            marks.setdefault("first_step", []).append(time.perf_counter())
            walls.append(time.time())
        state.step += 1
        state.commit()
        losses.append(loss)
        if MODE == "relaunch":
            ckpt.save(state.step, {"model": model.state_dict(),
                                   "opt": opt.state_dict(),
                                   "step": state.step}, wait=True)
            if state.step == 2 and not resumed:
                print(f"HVD_ELASTIC_EXIT after step 2 at {time.time()}",
                      flush=True)
                os._exit(1)
        if MODE == "abort" and state.step == 2 and not posted:
            scraped.update(scrape())
            posted.append(time.perf_counter())
            probe.append(True)
            hvd.abort.post("chip_smoke: abort after step 2's commit")


train(state)
got = params()
if MODE == "relaunch":
    opt.remove_hooks()
    ref = [p.to(dev) for p in torch.load(REF_PATH)]
    ref2 = uninterrupted()
bitwise = all(torch.equal(a, b) for a, b in zip(ref, ref2))
spread = max((a.float() - b.float()).abs().max().item()
             for a, b in zip(ref, ref2))
diff = max((a.float() - b.float()).abs().max().item()
           for a, b in zip(got, ref))
equal = all(torch.equal(a, b) for a, b in zip(got, ref))
t0 = posted[0] if posted else None
rel = {k: [round(t - t0, 4) for t in v] for k, v in marks.items()} if t0 else {}
print("HVD_ELASTIC " + json.dumps(dict(
    mode=MODE, generation=os.environ["HOROVOD_WORLD_VERSION"], start=start,
    worlds=worlds[0], launches=launches, losses=losses, errors=errors,
    bitwise_runs=bitwise, spread=spread, diff=diff, equal=equal, marks=rel,
    gaps=gaps, t_start=t_start, t_first_step=walls[0], scrape=scraped,
    t_stages=dict(start=t_start, imports=t_imported, init=t_init,
                  model=t_model, restore=t_restored, first_step=walls[0]),
    params=sum(p.numel() for p in got))), flush=True)
"""


def _elastic_run(tmp, mode, layers, env, limit_s):
    """One ``hvdrun-torch --host-discovery-script`` launch of
    ``ELASTIC_CHILD``, every step traced and shipped, the lifecycle journal
    in ``<tmp>/events_<mode>.jsonl``: (exit code, stdout, the child's
    reports, seconds)."""
    env = dict(env, ELASTIC_SMOKE_MODE=mode, ELASTIC_SMOKE_LAYERS=str(layers),
               ELASTIC_SMOKE_CKPT=os.path.join(tmp, f"ckpt_{mode}"),
               HOROVOD_TRACE_SAMPLE="1",
               HOROVOD_EVENT_LOG=os.path.join(tmp, f"events_{mode}.jsonl"))
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--host-discovery-script", os.path.join(tmp, "discover.sh"),
         "--min-np", "1", "--max-np", "1", sys.executable,
         os.path.join(tmp, "child.py")],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=limit_s)
    reports = [json.loads(line.split("HVD_ELASTIC ", 1)[1])
               for line in out.stdout.splitlines() if "HVD_ELASTIC {" in line]
    return out.returncode, out.stdout + out.stderr, reports, time.time() - t0


ELASTIC_STEPS = 4
ELASTIC_LAYERS = {"abort": 24, "relaunch": 2}
# Seconds each launch may take, and the whole phase.
ELASTIC_LIMIT_S = {"abort": 120, "relaunch": 90}
ELASTIC_PHASE_LIMIT_S = 180


def _hold_elastic(mode, rc, text, reports):
    """The child's report: exit code 0, one report, final parameters equal
    to the uninterrupted run's (bit for bit if its two uninterrupted runs
    agree bit for bit, else within their spread), and the three multi-tile
    flash kernels launched once per layer in every step of every world."""
    if rc != 0 or len(reports) != 1:
        raise AssertionError(f"elastic {mode}: exit code {rc}, "
                             f"{len(reports)} report(s):\n{text[-4000:]}")
    r = reports[0]
    ok = r["equal"] if r["bitwise_runs"] else r["diff"] <= r["spread"]
    want = ELASTIC_LAYERS[mode]
    bad = [row for row in r["launches"]
           if any(row[k] != want for k in ("flash_fwd", "flash_dq",
                                           "flash_dkv"))]
    if not ok or bad:
        raise AssertionError(f"elastic {mode}: final parameters equal "
                             f"{r['equal']} (max diff {r['diff']}, spread "
                             f"{r['spread']}), launches off {bad}:\n"
                             f"{text[-4000:]}")
    return r


def _hold_observed(tmp, r, text):
    """The abort run's scrape of the driver's routes (valid Prometheus text
    with this rank's label, one timeline track, an attributed step, the
    skew, ``/comms`` and ``/memory`` answering 200 with rank 0, the memory
    view measured) and its journal: ``abort_posted``, then ``abort_consumed``, then
    ``world_synced``, generations not falling, and the consumed abort's
    flight record."""
    sc = r["scrape"]
    with open(os.path.join(tmp, "events_abort.jsonl")) as f:
        events = [json.loads(line) for line in f]
    names = [e["event"] for e in events]
    chain = []
    if "abort_posted" in names:
        chain.append(names.index("abort_posted"))
        if "abort_consumed" in names[chain[0]:]:
            chain.append(names.index("abort_consumed", chain[0]))
            if "world_synced" in names[chain[1]:]:
                chain.append(names.index("world_synced", chain[1]))
    gens = [events[i]["generation"] for i in chain]
    flight = [e for e in events if e["event"] == "flight_record"
              and e.get("reason") == "abort_consumed"]
    merged = [sc.get(route, {}) for route in ("comms", "memory")]
    if not (sc.get("tracks") == [0] and sc.get("ranks") == ["0"]
            and sc.get("criticalpath") == "ok" and sc.get("groups")
            and "matched" in sc.get("stragglers", {})
            and all(m.get("http") == 200 and m.get("ranks") == ["0"]
                    for m in merged)
            and merged[1].get("status") == "ok"
            and len(chain) == 3 and gens == sorted(gens) and flight):
        raise AssertionError(f"elastic abort: scrape {sc}, journal "
                             f"{[(e['event'], e['generation']) for e in events]}"
                             f":\n{text[-4000:]}")
    return sc, [(names[i], gens[k]) for k, i in enumerate(chain)]


def elastic_phase(card):
    """``hvdrun-torch --host-discovery-script <prints localhost:1> --min-np 1
    --max-np 1 python ELASTIC_CHILD`` on the card, twice (see
    ``ELASTIC_CHILD``): the BERT-Large worker that recovers in-process from
    a coordinated abort (new NCCL group), and the 2-layer worker the driver
    relaunches after it exits, which resumes from the ``Checkpointer``. Holds
    both to the uninterrupted run's final parameters, the launches of
    flash_fwd, flash_dq and flash_dkv in every step of both worlds, and the
    limits ``ELASTIC_LIMIT_S`` and ``ELASTIC_PHASE_LIMIT_S``; prints the
    seconds from the abort post to the first step of the new world, by
    stage."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "chip_smoke_elastic")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "child.py"), "w") as f:
        f.write(ELASTIC_CHILD)
    disc = os.path.join(tmp, "discover.sh")
    with open(disc, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(disc, 0o755)
    env = dict(os.environ, HOROVOD_FORCE_WIRE_MACHINERY="1",
               HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="30",
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_phase = time.time()
    try:
        rc, text, reports, secs = _elastic_run(
            tmp, "abort", ELASTIC_LAYERS["abort"], env,
            ELASTIC_LIMIT_S["abort"])
        r = _hold_elastic("abort", rc, text, reports)
        worlds = sorted({row["world"] for row in r["launches"]})
        m = r["marks"]
        if not (r["errors"] and "coordinated abort" in r["errors"][0]
                and worlds == [1, 2] and r["worlds"] == 2):
            raise AssertionError(f"elastic abort: errors {r['errors']}, "
                                 f"worlds {worlds}:\n{text[-4000:]}")
        scraped, chain = _hold_observed(tmp, r, text)
        stages = {
            "communicator_abort": m["comm_abort_end"][0] - m["comm_abort"][0],
            "detection": m["restore"][0] - m["comm_abort_end"][0],
            "restore": m["restore_end"][0] - m["restore"][0],
            "backoff": m["shutdown"][0] - m["restore_end"][0],
            "teardown": m["shutdown_end"][0] - m["shutdown"][0],
            "new_group": m["init_end"][0] - m["init"][0],
            "sync": m["sync_end"][-1] - m["sync"][-1],
            "first_step": m["first_step"][1] - m["sync_end"][-1],
            "total": m["first_step"][1]}
        print(f"elastic abort: BERT-Large {r['params'] / 1e6:.1f}M params, "
              f"S=512 x 8, bf16 wire, AdamW: {ELASTIC_STEPS} steps in 2 "
              f"worlds of generation {r['generation']}; the step after the "
              f"post raised {r['errors'][0]!r}; final parameters "
              f"{'bit for bit equal to' if r['equal'] else 'within the spread of'}"
              f" the uninterrupted run's (two uninterrupted runs "
              f"{'agree bit for bit' if r['bitwise_runs'] else 'differ by ' + str(r['spread'])}"
              f", max diff {r['diff']}); launches per step "
              f"{r['launches']}; seconds from the abort post "
              f"{ {k: round(v, 4) for k, v in stages.items()} }; "
              f"launch to exit {secs:.1f} s on {card}")
        print(f"elastic abort: the driver's routes while the world ran: "
              f"/metrics {scraped['families']} families valid with rank "
              f"labels {scraped['ranks']}, /timeline tracks "
              f"{scraped['tracks']}, /criticalpath {scraped['criticalpath']} "
              f"over {scraped['groups']} steps, /stragglers "
              f"{scraped['stragglers']}, /comms {scraped['comms']} (status "
              f"insufficient_samples when the worker's only eager "
              f"collective, the loss average, has one payload size), "
              f"/memory {scraped['memory']}; journal {chain}")
        rc, text, reports, secs = _elastic_run(
            tmp, "relaunch", ELASTIC_LAYERS["relaunch"],
            dict(env, HOROVOD_BLACKLIST_COOLDOWN="1"),
            ELASTIC_LIMIT_S["relaunch"])
        r = _hold_elastic("relaunch", rc, text, reports)
        exits = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                 if "HVD_ELASTIC_EXIT after step 2 at " in line]
        if not (len(exits) == 1 and r["start"] == 2
                and [row["step"] for row in r["launches"]] == [3, 4]
                and int(r["generation"]) >= 2):
            raise AssertionError(f"elastic relaunch: start {r['start']}, "
                                 f"launches {r['launches']}:\n{text[-4000:]}")
        print(f"elastic relaunch: BERT-Large width, {ELASTIC_LAYERS['relaunch']}"
              f" layers: the process exited after step 2's save, the driver "
              f"relaunched it as generation {r['generation']}, which resumed "
              f"from the Checkpointer at step {r['start']}; seconds from the "
              f"exit to the new process's start {r['t_start'] - exits[0]:.2f},"
              f" to its first resumed step {r['t_first_step'] - exits[0]:.2f}"
              f" (to the end of each stage: "
              f"{ {k: round(t - exits[0], 2) for k, t in r['t_stages'].items()} }"
              f"); final parameters "
              f"{'bit for bit equal to' if r['equal'] else 'within the spread of'}"
              f" the uninterrupted run's (two uninterrupted runs, one in each "
              f"process, "
              f"{'agree bit for bit' if r['bitwise_runs'] else 'differ by ' + str(r['spread'])}"
              f", max diff {r['diff']}); launches "
              f"{r['launches']}; launch to exit {secs:.1f} s on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.time() - t_phase
    if took > ELASTIC_PHASE_LIMIT_S:
        raise AssertionError(f"elastic: the phase took {took:.1f} s, past its "
                             f"limit of {ELASTIC_PHASE_LIMIT_S} s")


# The elastic_peer phase's worker, run by ``hvdrun-torch
# --host-discovery-script`` (one host, localhost:1) with
# HOROVOD_DRIVER_STATE_DIR set. BERT-Large S = 512 x 8 at full width cut to
# ELASTIC_PEER_LAYERS layers, bf16 wire, AdamW, sync_mode="fsdp": two
# uninterrupted ELASTIC_PEER_STEPS-step runs from the seed-0 weights, then
# the same steps with make_train_step under @hvd.elastic.run and a
# PeerShardedState that commits after every step (a Checkpointer holds the
# initial state for the durable rung, which must never read it). After
# step 2's commit it posts the coordinated abort: the ladder takes restore
# (pending), then peer, and the state the peer rung rebuilt, then the state
# installed, must equal bit for bit what the worker gathered at that
# commit (gathered for the check only). After step 4's commit it writes
# ``step4`` and waits: the phase SIGKILLs the driver and starts a
# successor, whose abort ends the wait; the worker follows the endpoint
# record, joins generation g+1 and recovers on the peer rung from its own
# pool, held to step 4's gathered state the same way. Its output goes to a
# file (its launcher's pipe dies with the driver), ending with
# "HVD_PEER <json>": the final parameters against the uninterrupted run's,
# the flash kernels' launches per step and world, the rungs taken, the
# record bytes, the seconds of each commit and replication, of each
# recovery's stages, and the wall times of the repoint and of each world's
# first step.
ELASTIC_PEER_CHILD = r"""
import dataclasses, json, os, sys, time
t_start = time.time()
_fd = os.open(os.environ["ELASTIC_PEER_LOG"],
              os.O_WRONLY | os.O_CREAT | os.O_APPEND)
os.dup2(_fd, 1)
os.dup2(_fd, 2)
sys.stdout = os.fdopen(1, "w", buffering=1)
sys.stderr = os.fdopen(2, "w", buffering=1)
print(f"pid={os.getpid()}", flush=True)
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.models import bert as bert_mod
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.optimizer import unshard_opt_state
from horovod_tpu_torch.runner.elastic import worker as elastic_worker
import chip_smoke as smoke

STEPS, LAYERS = smoke.ELASTIC_PEER_STEPS, smoke.ELASTIC_PEER_LAYERS
TMP = os.environ["ELASTIC_PEER_TMP"]
torch.use_deterministic_algorithms(True, warn_only=True)
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
marks, worlds, rungs = {}, [0], []


def mark(name):
    marks.setdefault(name, []).append(time.time())


def timed(name, fn):
    def call(*a, **k):
        mark(name)
        try:
            return fn(*a, **k)
        finally:
            mark(name + "_end")
    return call


hvd.init()
dev = hvd.device()
cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0,
                          num_layers=LAYERS)
_, B, S, P, _ = smoke.BERT_PATHS[0]
batches = [smoke._bert_batch(cfg, B, S, P, seed, dev) for seed in range(STEPS)]


def build():
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        compression=hvd.Compression.bf16, sync_mode="fsdp")
    return model, opt


def gathered(opt):
    # Every parameter and the AdamW state in full, on the host: the check's
    # own gather, which the program never does.
    flat = [t.cpu() for t in opt.full_parameters()]
    return flat, unshard_opt_state(opt, hvd.gather_sharded_state(opt))


def same(full_flat, full_opt, want):
    flat, opt_state = want
    return (len(full_flat) == len(flat)
            and all(torch.equal(a.cpu(), b) for a, b in zip(full_flat, flat))
            and opt_state["state"].keys() == full_opt["state"].keys()
            and all(torch.equal(full_opt["state"][i][k].cpu(), v)
                    for i, st in opt_state["state"].items()
                    for k, v in st.items())
            and full_opt.get("salt_counter") == opt_state.get("salt_counter"))


def uninterrupted():
    model, opt = build()
    step = hvd.make_train_step(model, smoke._bert_loss, opt)
    for b in batches:
        step(b)
    torch.cuda.synchronize()
    return [t.cpu() for t in opt.full_parameters()]


ref, ref2 = uninterrupted(), uninterrupted()
t_refs = time.time()
model, opt = build()
step_fn = hvd.make_train_step(model, smoke._bert_loss, opt)
names = {id(p): n for n, p in model.named_parameters()}
ckpt = hvd.Checkpointer(os.path.join(TMP, "ckpt"), max_to_keep=1,
                        async_save=True)
initial = gathered(opt)
ckpt.save(0, {"params": {names[id(p)]: t
                         for p, t in zip(opt._params, initial[0])},
              "opt_state": initial[1]})
durable_reads = [0]
ckpt_restore = ckpt.restore


def counted_restore(*a, **k):
    durable_reads[0] += 1
    return ckpt_restore(*a, **k)


ckpt.restore = counted_restore
real_init = basics.init


def init(*a, **k):
    real_init(*a, **k)
    worlds[0] += 1


basics.init = timed("init", init)
basics.shutdown = timed("shutdown", basics.shutdown)
hooks = hvd.abort._hooks
hooks[hooks.index(basics._abort_groups)] = timed("comm_abort",
                                                  basics._abort_groups)
ctx_cls = elastic_worker.ElasticWorkerContext
ctx_cls._repoint = timed("repoint", ctx_cls._repoint)
worlds[0] = 1
state = hvd.elastic.PeerShardedState(model=model, optimizer=opt, step=0)
rep = state._replicator
replicate_s = []
real_replicate = rep.replicate


def replicate(*a, **k):
    t0 = time.perf_counter()
    out = real_replicate(*a, **k)
    replicate_s.append(time.perf_counter() - t0)
    return out


rep.replicate = replicate
snaps, checks = {}, []
real_restore, real_peer = state.restore, state._restore_from_peers


def restore():
    rungs.append("restore")
    real_restore()


def peer():
    rungs.append("peer")
    kv = rep.client()
    on_server = len(kv.keys("peerstate")) if kv is not None else 0
    real_peer()
    full = state._full
    checks.append(dict(what="peer", step=state.step, kv_records=on_server,
                       equal=same(full["flat"], full["opt"],
                                  snaps[state.step])))


def durable():
    rungs.append("durable")
    saved = ckpt.restore()
    state.install_full(saved["params"], saved["opt_state"], step=0)


# Instance attributes, past ExtrasState's tracking of public names.
object.__setattr__(state, "restore", timed("restore", restore))
object.__setattr__(state, "sync", timed("sync", state.sync))
state._install = timed("install", state._install)
state.register_peer_restore(timed("peer", peer))
state.register_durable_restore(durable)
launches, losses, commit_s, gens, posted = [], [], [], [], []


@hvd.elastic.run
def train(state):
    while state.step < STEPS:
        if state.step == 4 and os.path.exists(os.path.join(TMP, "step4")):
            # Wait for the successor driver: its abort of this generation
            # ends the wait.
            deadline = time.time() + smoke.ELASTIC_PEER_LIMIT_S
            while os.environ["HOROVOD_WORLD_VERSION"] == gens[-1]:
                hvd.abort.raise_if_aborted()
                if time.time() > deadline:
                    raise SystemExit("the successor driver never came")
                time.sleep(0.02)
        if launches and launches[-1]["world"] != worlds[0] and (
                state.step in snaps):
            flat, opt_state = gathered(opt)
            checks.append(dict(what="installed", step=state.step,
                               equal=same(flat, opt_state,
                                          snaps[state.step])))
        for k in _kernels.KERNELS:
            k.launches = 0
        loss = float(step_fn(batches[state.step]))
        torch.cuda.synchronize()
        if not launches or launches[-1]["world"] != worlds[0]:
            mark("first_step")
        launches.append(dict(world=worlds[0], step=state.step + 1, **{
            k.name: k.launches for k in _kernels.KERNELS if k.name in FLASH}))
        state.step += 1
        if state.step in (2, 4):
            snaps[state.step] = gathered(opt)
        t0 = time.perf_counter()
        state.commit()
        commit_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gens.append(os.environ["HOROVOD_WORLD_VERSION"])
        if state.step == 2 and not posted:
            posted.append(time.time())
            hvd.abort.post("chip_smoke: abort after step 2's commit")
        if state.step == 4 and not os.path.exists(os.path.join(TMP, "step4")):
            with open(os.path.join(TMP, "step4"), "w") as f:
                f.write(str(time.time()))


train(state)
got = [t.cpu() for t in opt.full_parameters()]
record = rep.pool.get(0)
ckpt.wait_until_finished()
print("HVD_PEER " + json.dumps(dict(
    pid=os.getpid(), launches=launches, losses=losses, rungs=rungs,
    checks=checks, durable_reads=durable_reads[0], generations=gens,
    bitwise_runs=all(torch.equal(a, b) for a, b in zip(ref, ref2)),
    spread=max((a - b).abs().max().item() for a, b in zip(ref, ref2)),
    diff=max((a - b).abs().max().item() for a, b in zip(got, ref)),
    equal=all(torch.equal(a, b) for a, b in zip(got, ref)),
    record_bytes=len(record.payload), commit_s=commit_s,
    replicate_s=replicate_s, marks=marks, posted=posted[0],
    t_start=t_start, t_refs=t_refs,
    params=sum(t.numel() for t in got))), flush=True)
"""

ELASTIC_PEER_STEPS = 6
ELASTIC_PEER_LAYERS = 4
ELASTIC_PEER_LIMIT_S = 150
# A record of this worker (one rank: its parameter shards and both AdamW
# moments of BERT-Large cut to 4 layers, ~85M float32 values each) is
# about 1.0 GB: the defaults, a 256 MiB bound on a record and a 5 s
# client timeout, would turn every commit away (413) or time it out, and
# the peer rung would quietly fall through to durable. The phase sets both
# above the record's size and time.
ELASTIC_PEER_MAX_BYTES = 4 << 30
ELASTIC_PEER_TIMEOUT_S = 120


def _stages(m, t0, i):
    """The seconds from ``t0`` to the end of each stage of recovery ``i``
    (0: the abort, 1: the failover): the communicator abort, the rollback
    (rung restore), the first new group, the peer rung's rebuild, the
    second new group (after the refused sync), the install, the installing
    sync (with its commit), and the first step of the new world."""
    ends = (("communicator_abort", "comm_abort_end", i),
            ("restore", "restore_end", i), ("new_group", "init_end", 2 * i),
            ("peer_restore", "peer_end", i),
            ("new_group_again", "init_end", 2 * i + 1),
            ("install", "install_end", i), ("sync", "sync_end", 2 + 2 * i),
            ("first_step", "first_step", i + 1))
    return {name: round(m[key][k] - t0, 3) for name, key, k in ends}


def elastic_peer_phase(card):
    """``hvdrun-torch --host-discovery-script <prints localhost:1> --min-np 1
    --max-np 1 python ELASTIC_PEER_CHILD`` with a driver-state directory
    (see ``ELASTIC_PEER_CHILD``): the peer rung after a coordinated abort,
    then the driver SIGKILLed after step 4's commit and a successor started
    with the same command, which adopts the worker. Holds the run to the
    rungs restore then peer (twice), no read of the Checkpointer's
    directory, the rebuilt and installed states equal to the gathered ones
    bit for bit, generation g+1 after the failover, the successor's epoch
    and adoption of the worker's pid, the final parameters equal to the
    uninterrupted run's, the flash kernels' launches per layer in every
    step of every world, and ELASTIC_PEER_LIMIT_S; prints the record's
    bytes, the seconds of each commit and replication, each recovery's
    stages, and the seconds from the driver's kill to the successor
    serving, to the worker's repoint and to its first step."""
    import shutil
    import signal

    from urllib.error import HTTPError

    from horovod_tpu_torch import faults
    from horovod_tpu_torch.runner.elastic import driver_state
    from horovod_tpu_torch.runner.http.kv_server import KVClient

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "chip_smoke_elastic_peer")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    child, disc = os.path.join(tmp, "child.py"), os.path.join(tmp, "disc.sh")
    log, sdir = os.path.join(tmp, "worker.log"), os.path.join(tmp, "state")
    with open(child, "w") as f:
        f.write(ELASTIC_PEER_CHILD)
    with open(disc, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(disc, 0o755)
    env = dict(os.environ, HOROVOD_FORCE_WIRE_MACHINERY="1",
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               HOROVOD_DRIVER_STATE_DIR=sdir,
               HOROVOD_DRIVER_STATE_REFRESH="0.5",
               HOROVOD_DRIVER_REJOIN_TIMEOUT="60",
               HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL="0.1",
               HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT="10",
               HOROVOD_ABORT_POLL_INTERVAL="0.1",
               HOROVOD_RECOVERY_BACKOFF_MAX="0.1",
               HOROVOD_PEERCHECK_MAX_BYTES=str(ELASTIC_PEER_MAX_BYTES),
               HOROVOD_PEERCHECK_TIMEOUT=str(ELASTIC_PEER_TIMEOUT_S),
               ELASTIC_PEER_TMP=tmp, ELASTIC_PEER_LOG=log,
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    argv = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
            "--host-discovery-script", disc, "--min-np", "1", "--max-np",
            "1", sys.executable, child]

    def start(name):
        return subprocess.Popen(
            argv, cwd=here, env=env, start_new_session=True,
            stdout=open(os.path.join(tmp, name), "w"),
            stderr=subprocess.STDOUT)

    def text():
        out = []
        for name in ("driver1.txt", "driver2.txt", "worker.log"):
            path = os.path.join(tmp, name)
            if os.path.exists(path):
                with open(path) as f:
                    out.append(f"--- {name}\n" + f.read()[-4000:])
        return "\n".join(out)

    t_phase = time.time()
    deadline = t_phase + ELASTIC_PEER_LIMIT_S
    first = start("driver1.txt")
    second = None
    try:
        marker = os.path.join(tmp, "step4")
        while not os.path.exists(marker):
            if first.poll() is not None or time.time() > deadline:
                raise AssertionError(f"elastic_peer: step 4 never committed "
                                     f"(driver rc {first.poll()}):\n{text()}")
            time.sleep(0.02)
        t_kill = time.time()
        faults.kill_driver(first.pid)
        first.wait(timeout=30)
        second = start("driver2.txt")
        t_serving = None
        while t_serving is None and time.time() < deadline:
            rec = driver_state.read_endpoint(sdir)
            if rec is not None and rec["driver_epoch"] >= 2:
                try:
                    KVClient(rec["addr"], rec["port"], timeout=1.0,
                             retries=1).world_version()
                    t_serving = time.time()
                except HTTPError:  # answered (403: this probe has no key)
                    t_serving = time.time()
                except OSError:  # not serving yet
                    pass
            if t_serving is None:
                time.sleep(0.02)
        rc = second.wait(timeout=max(1.0, deadline - time.time()))
        with open(log) as f:
            reports = [json.loads(line.split("HVD_PEER ", 1)[1])
                       for line in f if line.startswith("HVD_PEER {")]
        if rc != 0 or len(reports) != 1 or t_serving is None:
            raise AssertionError(f"elastic_peer: successor rc {rc}, "
                                 f"{len(reports)} report(s), serving at "
                                 f"{t_serving}:\n{text()}")
        r = reports[0]
        store = driver_state.DriverStateStore(sdir, epoch=2)
        snap = store.load()
        adopted = list((snap or {}).get("workers", {}).values())
        ok = r["equal"] if r["bitwise_runs"] else r["diff"] <= r["spread"]
        bad = [row for row in r["launches"]
               if any(row[k] != ELASTIC_PEER_LAYERS for k in
                      ("flash_fwd", "flash_dq", "flash_dkv"))]
        gens = [int(g) for g in r["generations"]]
        want_checks = [("peer", 2, True), ("installed", 2, True),
                       ("peer", 4, True), ("installed", 4, True)]
        got_checks = [(c["what"], c["step"], c["equal"]) for c in r["checks"]]
        if not (ok and not bad and r["rungs"] == ["restore", "peer"] * 2
                and r["durable_reads"] == 0 and got_checks == want_checks
                and r["checks"][2]["kv_records"] == 0
                and [row["step"] for row in r["launches"]]
                == list(range(1, ELASTIC_PEER_STEPS + 1))
                and gens[4:] == [gens[3] + 1] * 2
                and snap is not None and snap["driver_epoch"] == 2
                and [w.get("pid") for w in adopted] == [r["pid"]]):
            raise AssertionError(
                f"elastic_peer: final parameters equal {r['equal']} (max "
                f"diff {r['diff']}, spread {r['spread']}), launches off "
                f"{bad}, rungs {r['rungs']}, durable reads "
                f"{r['durable_reads']}, checks {r['checks']}, generations "
                f"{gens}, snapshot epoch {(snap or {}).get('driver_epoch')} "
                f"workers {adopted} vs pid {r['pid']}:\n{text()}")
        m = r["marks"]
        print(f"elastic_peer: BERT-Large {r['params'] / 1e6:.1f}M params "
              f"({ELASTIC_PEER_LAYERS} layers), S=512 x 8, bf16 wire, AdamW, "
              f"sync_mode=fsdp, PeerShardedState committing every step: "
              f"rungs {r['rungs']}, Checkpointer reads {r['durable_reads']};"
              f" the peer rung's state and the installed state equal the "
              f"gathered commit bit for bit at steps 2 and 4 (the second "
              f"from the worker's own pool, the successor's server holding "
              f"{r['checks'][2]['kv_records']} records); generations "
              f"{gens}; final parameters "
              f"{'bit for bit equal to' if r['equal'] else 'within the spread of'}"
              f" the uninterrupted run's (two uninterrupted runs "
              f"{'agree bit for bit' if r['bitwise_runs'] else 'differ by ' + str(r['spread'])}"
              f", max diff {r['diff']}); launches per step {r['launches']} "
              f"on {card}")
        print(f"elastic_peer: record bytes {r['record_bytes']} (one rank, "
              f"HOROVOD_PEERCHECK_MAX_BYTES={ELASTIC_PEER_MAX_BYTES}, "
              f"HOROVOD_PEERCHECK_TIMEOUT={ELASTIC_PEER_TIMEOUT_S}); seconds "
              f"of each replication {[round(t, 3) for t in r['replicate_s']]}"
              f", of each commit {[round(t, 3) for t in r['commit_s']]} on "
              f"{card}")
        peer_s = [round(b - a, 3) for a, b in zip(m["peer"], m["peer_end"])]
        install_s = [round(b - a, 3)
                     for a, b in zip(m["install"], m["install_end"])]
        print(f"elastic_peer: seconds to assemble (peer rung) {peer_s}, to "
              f"install (sync) {install_s}; from the abort post to the end "
              f"of each stage {_stages(m, r['posted'], 0)} on {card}")
        repoint = m["repoint"][0]
        print(f"elastic_peer: seconds from the driver's SIGKILL to the "
              f"successor serving {t_serving - t_kill:.3f}, to the worker's "
              f"repoint {repoint - t_kill:.3f}, to its first step at "
              f"generation {gens[-1]} {m['first_step'][2] - t_kill:.3f} "
              f"(to the end of each stage "
              f"{_stages(m, t_kill, 1)}); worker start to the first step "
              f"{m['first_step'][0] - r['t_start']:.1f} s, of it the two "
              f"uninterrupted runs {r['t_refs'] - r['t_start']:.1f} s, on "
              f"{card}")
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        if os.path.exists(log):
            with open(log) as f:
                pids = [int(line.split("=", 1)[1]) for line in f
                        if line.startswith("pid=")]
            for pid in pids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.time() - t_phase
    if took > ELASTIC_PEER_LIMIT_S:
        raise AssertionError(f"elastic_peer: the phase took {took:.1f} s, "
                             f"past its limit of {ELASTIC_PEER_LIMIT_S} s")


# The observability phase (see the module docstring): steps per run, the
# sampling and watch cadence of the planes-on run, the steps it profiles
# for the device busy (unsampled ones) and traces with hvd.profiler, and
# the largest relative difference of the busy with the planes on.
OBS_STEPS = 10
OBS_EVERY = 4
OBS_BUSY_STEPS = (5, 6, 7)
OBS_TRACED_STEPS = (9, 10)
OBS_BUSY_TOL = 0.01
# The stall check: seconds of device spin ahead of the collective, and the
# inspector's warning time.
OBS_SPIN_S = 3.0
OBS_WARN_S = 1.0
OBS_PLANE_ENV = ("HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
                 "HOROVOD_EVENT_LOG", "HOROVOD_TRACE_SAMPLE",
                 "HOROVOD_STALL_CHECK_STEPS", "HOROVOD_STALL_CHECK_TIME")
# The comms microprobe before the planes-on run: payloads from 4 KB to
# 256 MB, by fours, three timed calls of each op at each.
OBS_PROBE_SIZES = tuple(4 ** k for k in range(6, 15))
# The first spin of this process, timed by CUDA events and printed by
# main() (C9: checks behind a spin once saw no wait; the spin held, and the
# host's first launch of a kernel behind it waited for it).
FIRST_SPIN_CYCLES = 20_000_000


def bert_flops_per_token(cfg, seq_len, num_predictions):
    """BERT's analytic training FLOPs per token (``bench.py:393``): the
    layers' matmuls, attention's two S x S products and the masked-position
    head, times 3 for the backward."""
    H, I, L, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.vocab_size)
    layer_matmuls = 2.0 * L * (4 * H * H + 2 * H * I)
    attention = 4.0 * L * seq_len * H
    head = 2.0 * (H * H + V * H) * (num_predictions / seq_len)
    return 3.0 * (layer_matmuls + attention + head)


class _LogLines:
    """A handler that keeps the port's log messages (the stall warnings)."""

    def __init__(self):
        import logging

        from horovod_tpu_torch.utils.logging import get_logger

        class Keep(logging.Handler):
            def emit(inner, record):
                self.lines.append(record.getMessage())

        self.lines = []
        self._handler = Keep()
        self._logger = get_logger()

    def __enter__(self):
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        return False


def _timeline_events(path):
    """The timeline file as it is on disk once the events emitted so far
    are written (``Timeline.drain``; a read racing a write can see the old
    length with the new event's first bytes): it must load."""
    from horovod_tpu_torch import timeline

    tl = timeline.get_timeline()
    if tl is not None:
        tl.drain()
    with open(path) as f:
        return json.load(f)


def _obs_run(cfg, model, initial, batch, tmp, planes):
    """One run of ``OBS_STEPS`` steps from ``initial``: the parameters, the
    AdamW state, the kernels' launches, the device busy ms per unsampled
    step, host ms of each step call, and (planes on) what the planes
    recorded."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import (attribution, comms_model, memory, metrics,
                                   stall, tracing)
    from horovod_tpu_torch.ops import _kernels

    for key in OBS_PLANE_ENV:
        os.environ.pop(key, None)
    attribution.reset_for_testing()
    tracing.reset_for_testing()
    stall.reset_for_testing()
    metrics.reset_for_testing()
    memory.reset_for_testing()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    if planes:
        os.environ.update(HOROVOD_EVENT_LOG=os.path.join(tmp, "events.jsonl"),
                          HOROVOD_TRACE_SAMPLE=str(OBS_EVERY),
                          HOROVOD_STALL_CHECK_STEPS=str(OBS_EVERY))
        hvd.start_timeline(os.path.join(tmp, "timeline.json"),
                           mark_cycles=True)
        _, B, S, P, _ = BERT_PATHS[0]
        hvd.set_model_flops_per_step(bert_flops_per_token(cfg, S, P) * B * S)
    model.load_state_dict(initial)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    step = hvd.make_train_step(model, _bert_loss, opt)
    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    # Host ms of each step call outside the profilers, by step.
    host_ms, busy, losses, loads = {}, None, [], []
    for i in range(1, OBS_STEPS + 1):
        if i == OBS_BUSY_STEPS[0]:
            torch.cuda.synchronize()
            with device_profile() as prof:
                for _ in OBS_BUSY_STEPS:
                    losses.append(step(batch))
            spans = [(a, b) for _, a, b in device_events(prof)]
            busy = _busy_us(spans) / 1e3 / len(OBS_BUSY_STEPS)
            continue
        if OBS_BUSY_STEPS[0] < i <= OBS_BUSY_STEPS[-1]:
            continue
        if planes and i == OBS_TRACED_STEPS[0]:
            with hvd.profiler.trace(os.path.join(tmp, "prof")) as traced:
                for _ in OBS_TRACED_STEPS:
                    losses.append(step(batch))
                torch.cuda.synchronize()
            out["trace"] = traced.path
            continue
        if OBS_TRACED_STEPS[0] < i <= OBS_TRACED_STEPS[-1] and planes:
            continue
        t0 = time.perf_counter()
        losses.append(step(batch))
        host_ms[i] = round((time.perf_counter() - t0) * 1e3, 2)
        if planes and i in (3, 4):
            loads.append(len(_timeline_events(
                os.path.join(tmp, "timeline.json"))))
    torch.cuda.synchronize()
    out.update(
        params=[p.detach().clone() for p in model.parameters()],
        state=opt.state_dict()["state"], busy=busy, host_ms=host_ms,
        losses=[float(x) for x in losses],
        launches={k.name: k.launches for k in _kernels.KERNELS})
    if planes:
        # The comms and memory planes: the fitted model and its price of
        # the step's wire beside the synced step's exposed comm; the
        # footprint model beside what the optimizer noted, the watermarks
        # and the allocator's peak.
        footprint = memory.footprint_of(opt, model.parameters())
        memory.get_observatory().note_predicted(footprint)
        summary = attribution.summary()
        out.update(footprint=footprint, memory=memory.summary(),
                   comms=comms_model.summary(), summary=summary,
                   leaves=len(comms_model.get_model().leaf_sizes()),
                   device_stats=memory.device_memory_stats(),
                   max_allocated=torch.cuda.max_memory_allocated())
    opt.remove_hooks()
    if planes:
        out["loads"] = loads
        out["text"] = metrics.render()
        out["mfu"] = metrics.MFU_RATIO.labels().get()
        out["attribution"] = summary["last_step"]
        hvd.stop_timeline()
        out["timeline"] = _timeline_events(os.path.join(tmp, "timeline.json"))
        hvd.set_model_flops_per_step(None)
    for key in OBS_PLANE_ENV:
        os.environ.pop(key, None)
    return out


def _hold_comms_and_memory(on, probe, probe_s, card):
    """The comms and memory planes of the planes-on run: every op of the
    microprobe fitted, a predicted exposed comm, the footprint model equal
    to what the optimizer noted, the allocator read live
    (``device_memory_stats``), and the forward_backward and
    optimizer_update watermarks above the noted resident total (the
    gradients and activations that only the allocator's bytes in use
    hold) and at most the allocator's peak; each printed."""
    comms, mem, fp = on["comms"], on["memory"], on["footprint"]
    summary = on["summary"]
    fits = {key: fit for key, fit in comms["fits"].items()
            if key.endswith("|flat|intra_host")}
    unfitted = [op for op in probe if not fits.get(
        f"{op}|flat|intra_host", {}).get("ready")]
    predicted = summary["exposed_comm_predicted_s"]
    resident = mem["resident_total"]
    marks = mem["watermarks"]
    stats = on["device_stats"]
    bad_marks = {phase: marks.get(phase) for phase in
                 ("forward_backward", "optimizer_update")
                 if not resident < marks.get(phase, -1)
                 <= on["max_allocated"]}
    if (unfitted or predicted is None or mem["residual_bytes"] != 0
            or bad_marks or not resident or stats is None):
        raise AssertionError(
            f"observability: comms and memory planes: unfitted ops "
            f"{unfitted}, exposed_comm_predicted_s {predicted}, noted "
            f"resident {mem['resident']} against the footprint's "
            f"{fp['resident']} (residual {mem['residual_bytes']}), "
            f"device_memory_stats {stats}, watermarks {marks} outside "
            f"({resident}, {on['max_allocated']}]: {bad_marks}")
    print(f"observability: comms microprobe over the one-rank world, "
          f"{len(OBS_PROBE_SIZES)} payloads from {OBS_PROBE_SIZES[0]} to "
          f"{OBS_PROBE_SIZES[-1]} bytes, 3 timed calls each, {probe_s:.2f} "
          f"s; fitted alpha-beta per op (flat, intra_host): "
          + "; ".join(f"{key.split('|')[0]} alpha {fit['alpha_s'] * 1e6:.3f}"
                      f" us, beta {fit['beta_s_per_byte']:.4e} s/B "
                      f"({(fit['bandwidth_bytes_per_second'] or 0) / 1e9:.1f}"
                      f" GB/s), r2 {fit.get('r2')}, {fit['samples']} samples"
                      for key, fit in sorted(fits.items()))
          + f"; {comms['samples_total']} samples in all on {card}")
    print(f"observability: attribution of synced step "
          f"{summary['last_step']['step']}: exposed comm observed "
          f"{(summary['last_step']['phases']['exposed_comm'] + summary['last_step']['phases']['straggler_wait']) * 1e3:.3f}"
          f" ms, exposed_comm_predicted_s {predicted:.6f}, "
          f"exposed_comm_residual_s {summary['exposed_comm_residual_s']} "
          f"(the alpha-beta price of the step's bf16 wire, "
          f"{on['leaves']} leaves, at the fitted allreduce) "
          f"on {card}")
    print(f"observability: memory: footprint_of (per rank, allreduce, "
          f"AdamW, bf16 wire) resident {fp['resident']}, transient "
          f"{fp['transient']}, opt_state_host {fp['opt_state_host']}, "
          f"peak_total {fp['peak_total']} bytes; noted resident "
          f"{mem['resident']} (residual {mem['residual_bytes']}); "
          f"watermarks by phase {marks}; device_memory_stats {stats}; "
          f"max_memory_allocated "
          f"{on['max_allocated']} bytes; capacity {mem['capacity_bytes']}, "
          f"headroom {mem['headroom_ratio']} on {card}")


def _equal_runs(a, b):
    """Parameters and AdamW state of two runs equal bit for bit."""
    import torch

    def same(x, y):
        return torch.equal(x, y) if torch.is_tensor(x) else x == y

    return (all(same(x, y) for x, y in zip(a["params"], b["params"]))
            and all(same(x, b["state"][i][k])
                    for i in a["state"] for k, x in a["state"][i].items()))


def _stall_check(card):
    """An allreduce queued behind ``OBS_SPIN_S`` of device spin, then an
    ``hvd.fetch`` behind another: with a warning time of ``OBS_WARN_S`` the
    inspector must warn by name while the host waits (after the allreduce
    call returned; inside the fetch)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, stall
    from horovod_tpu_torch.utils.spin import MAX_SM_HZ, Spin

    cycles = int(OBS_SPIN_S * MAX_SM_HZ)
    os.environ["HOROVOD_STALL_CHECK_TIME"] = str(OBS_WARN_S)
    stall.reset_for_testing()
    x = torch.ones(1 << 20, device=hvd.device())
    try:
        with _LogLines() as log:
            # Load the kernels of the work queued behind the spins first:
            # under CUDA's lazy loading the first launch of a kernel waits
            # until the card is idle, so behind a spin its call would return
            # only after the spin (C9). Each spin is timed.
            hvd.allreduce(x, op=hvd.Sum)
            x * 2
            torch.cuda.synchronize()
            warned = metrics.STALL_WARNINGS.labels().get()
            spins = [Spin(cycles)]
            t0 = time.perf_counter()
            y = hvd.allreduce(x, op=hvd.Sum)
            returned_s = time.perf_counter() - t0
            time.sleep(OBS_WARN_S * 2.5)
            allreduce_warned = [line for line in log.lines
                                if "allreduce[" in line]
            torch.cuda.synchronize()
            warned_after_allreduce = metrics.STALL_WARNINGS.labels().get()
            spins.append(Spin(cycles))
            z = x * 2
            t0 = time.perf_counter()
            hvd.fetch(z, name="spin")
            fetch_s = time.perf_counter() - t0
            fetch_warned = [line for line in log.lines if "fetch[spin]" in line]
        stall.get_inspector().reap()
        left = len(stall.get_inspector()._outstanding)
    finally:
        os.environ.pop("HOROVOD_STALL_CHECK_TIME", None)
        stall.reset_for_testing()
    spin_ms = [round(sp.ms(), 3) for sp in spins]
    if any(sp.short() for sp in spins):
        raise AssertionError(
            f"observability: stall check: a spin ended early: "
            f"{spin_ms} ms, each at least {spins[0].least_ms():.1f}")
    if not (returned_s < OBS_SPIN_S / 3 and allreduce_warned
            and warned_after_allreduce > warned and fetch_warned
            and fetch_s > OBS_WARN_S and left == 0
            and torch.equal(y, x)):
        raise AssertionError(
            f"observability: stall check: allreduce returned after "
            f"{returned_s:.3f} s, warnings {allreduce_warned} (count "
            f"{warned} -> {warned_after_allreduce}), fetch waited "
            f"{fetch_s:.3f} s, warnings {fetch_warned}, {left} tickets left")
    print(f"observability: stall inspector (warning at {OBS_WARN_S} s): an "
          f"allreduce queued behind a {OBS_SPIN_S} s spin returned to the "
          f"host after {returned_s * 1e3:.2f} ms and its ticket stayed open: "
          f"{allreduce_warned[0]!r}; hvd.fetch behind the same spin waited "
          f"{fetch_s:.3f} s: {fetch_warned[0]!r}; the two spins took "
          f"{spin_ms} ms by CUDA events (at least "
          f"{spins[0].least_ms():.1f} each) on {card}")


def observability_phase(card):
    """BERT-Large S=512 x 8 with the observability planes off and on (see
    the module docstring, 13b)."""
    import dataclasses
    import gc
    import shutil

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import comms_model, metrics
    from horovod_tpu_torch.models import bert as bert_mod

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "chip_smoke_observability")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    name, B, S, P, kernels = BERT_PATHS[0]
    dev = hvd.device()
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(cfg, B, S, P, 0, dev)
    # The embeddings' backward adds with atomics otherwise: runs that
    # repeat bit for bit need torch's deterministic forms.
    torch.use_deterministic_algorithms(True, warn_only=True)
    t_phase = time.perf_counter()
    try:
        off = _obs_run(cfg, model, initial, batch, tmp, False)
        # The comms model's seed: a flat sweep over the one-rank world
        # (HOROVOD_FORCE_WIRE_MACHINERY=1: NCCL runs every collective).
        comms_model.reset_for_testing()
        t_probe = time.perf_counter()
        probe = hvd.run_comms_microprobe(sizes=OBS_PROBE_SIZES, repeats=3)
        probe_s = time.perf_counter() - t_probe
        on = _obs_run(cfg, model, initial, batch, tmp, True)
        if not _equal_runs(off, on):
            again = _obs_run(cfg, model, initial, batch, tmp, False)
            raise AssertionError(
                f"observability: parameters or AdamW state differ with the "
                f"planes on (losses off {off['losses']}, on {on['losses']}; "
                f"a second planes-off run "
                f"{'equals' if _equal_runs(off, again) else 'differs from'}"
                f" the first)")
        for run, which in ((off, "off"), (on, "on")):
            for kname, n in run["launches"].items():
                want = cfg.num_layers * OBS_STEPS if kname in kernels else 0
                if n != want:
                    raise AssertionError(
                        f"observability: planes {which}: {kname} launched "
                        f"{n} times in {OBS_STEPS} steps, expected {want}")
        with open(on["trace"]) as f:
            traced = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        flash = {k: any(f"{k}_kernel" in n for n in traced)
                 for k in ("flash_fwd", "flash_dq", "flash_dkv")}
        buckets = sorted(n for n in traced if n.startswith("hvd.allreduce."))
        if not all(flash.values()) or not buckets:
            raise AssertionError(f"observability: the profiler trace names "
                                 f"flash kernels {flash}, hvd ranges "
                                 f"{buckets[:4]}")
        cats = {}
        for e in on["timeline"]:
            cats.setdefault(e.get("cat"), set()).add(e["name"])
        if not (len(on["loads"]) == 2 and all(on["loads"])
                and "train_step" in cats.get("step", ())
                and {"forward_backward", "optimizer_update"}
                <= cats.get("phase", set())
                and {"collective", "allreduce"} <= cats.get("collective",
                                                            set())
                and cats.get("cycle")):
            raise AssertionError(f"observability: timeline loads "
                                 f"{on['loads']}, events by category "
                                 f"{ {k: sorted(v)[:6] for k, v in cats.items()} }")
        parsed = metrics.validate_prometheus_text(on["text"])

        def total(fam):
            return sum(v for _, v in parsed[fam]["samples"])

        fams = {f: total(f) for f in ("hvd_collective_dispatch_total",
                                      "hvd_grad_sync_flushes_total",
                                      "hvd_step_phase_seconds")}
        if not all(fams.values()):
            raise AssertionError(f"observability: families {fams}")
        if not 0 < on["mfu"] < 1:
            raise AssertionError(f"observability: hvd_mfu_ratio {on['mfu']}")
        rel = abs(on["busy"] - off["busy"]) / off["busy"]
        if rel > OBS_BUSY_TOL:
            raise AssertionError(
                f"observability: device busy per unsampled step "
                f"{off['busy']:.3f} ms with the planes off, {on['busy']:.3f} "
                f"ms on: {rel:.4f} apart, above {OBS_BUSY_TOL}")
        a = on["attribution"]
        print(f"observability: BERT-Large S=512 x 8, {OBS_STEPS} AdamW steps "
              f"from seed 0, planes off and on: parameters and AdamW state "
              f"equal bit for bit; K1, K3, K4 launched {cfg.num_layers} "
              f"times a step in both; losses {on['losses']}")
        print(f"observability: device busy per unsampled step (profiler, "
              f"steps {OBS_BUSY_STEPS}) {off['busy']:.3f} ms planes off, "
              f"{on['busy']:.3f} ms planes on ({rel * 100:.3f}% apart); host "
              f"ms of each step call outside the profilers, by step (planes "
              f"on: steps {list(range(OBS_EVERY, OBS_STEPS + 1, OBS_EVERY))}"
              f" synced), off "
              f"{off['host_ms']}, on {on['host_ms']} on {card}")
        print(f"observability: attribution of synced step {a['step']}: wall "
              f"{a['wall_s'] * 1e3:.3f} ms, phases (ms) "
              f"{ {k: round(v * 1e3, 3) for k, v in a['phases'].items()} }, "
              f"collectives {len(a['collectives'])}, overlap hidden ratio "
              f"{a['overlap_hidden_ratio']}; hvd_mfu_ratio {on['mfu']:.4f} "
              f"(model FLOPs {bert_flops_per_token(cfg, S, P) * B * S:.4g} "
              f"a step over 989 TFLOP/s) on {card}")
        _hold_comms_and_memory(on, probe, probe_s, card)
        print(f"observability: scrape families {fams}; timeline "
              f"{len(on['timeline'])} events ({ {k: len(v) for k, v in cats.items()} }"
              f" names by category); profiler trace "
              f"{os.path.getsize(on['trace']) / 2**20:.1f} MiB with "
              f"{len(buckets)} hvd.* bucket range names")
        _stall_check(card)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
        del model, initial
        gc.collect()
        torch.cuda.empty_cache()
    print(f"observability: the phase took {time.perf_counter() - t_phase:.1f}"
          f" s on {card}")



# The autotune phase: untuned and tuned runs of AUTOTUNE_STEPS steps (three
# windows of 1 + 3 calls, then two tuned steps), and the Bayesian
# optimizer's rounds, each one settle call and AUTOTUNE_BO_ITERS timed.
AUTOTUNE_STEPS = 14
AUTOTUNE_BO_ROUNDS = 4
AUTOTUNE_BO_ITERS = 3


def _autotune_run(cfg, model, initial, batch, tmp, tuned):
    """``AUTOTUNE_STEPS`` AdamW steps from ``initial`` through
    ``make_train_step``, under ``HOROVOD_AUTOTUNE=1`` when ``tuned``: the
    losses, the launches, the bucket counts before and after, and the
    model, optimizer and step (for the Bayesian rounds)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.ops import _kernels

    autotune.reset_for_testing()
    log = os.path.join(tmp, "autotune.jsonl")
    if tuned:
        os.environ.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=log)
    model.load_state_dict(initial)
    try:
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.bf16)
        buckets_before = len(opt._buckets)
        step = hvd.make_train_step(model, _bert_loss, opt)
        for k in _kernels.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        losses = [float(step(batch)) for _ in range(AUTOTUNE_STEPS)]
    finally:
        os.environ.pop("HOROVOD_AUTOTUNE", None)
        os.environ.pop("HOROVOD_AUTOTUNE_LOG", None)
    torch.cuda.synchronize()
    out = dict(losses=losses, buckets=(buckets_before, len(opt._buckets)),
               launches={k.name: k.launches for k in _kernels.KERNELS},
               state=autotune.autotune_state(), opt=opt, step=step)
    if tuned:
        with open(log) as f:
            out["log"] = f.read().splitlines()
    return out


def _bo_rounds(step, batch):
    """``tune_fusion_threshold`` for ``AUTOTUNE_BO_ROUNDS`` rounds on the
    tuned step: each round pins the suggested threshold, re-buckets, runs
    one settle call and times ``AUTOTUNE_BO_ITERS`` calls ended by one
    read of the loss. Returns (best threshold, [(threshold, s), ...],
    seconds to build the optimizer)."""
    from horovod_tpu_torch import autotune

    rounds = []

    def build(threshold):
        autotune.set_tuned_threshold(threshold)
        step.rebucket()
        return step

    def time_step(s):
        float(s(batch))
        t0 = time.perf_counter()
        for _ in range(AUTOTUNE_BO_ITERS):
            loss = s(batch)
        float(loss)
        seconds = (time.perf_counter() - t0) / AUTOTUNE_BO_ITERS
        rounds.append((autotune.tuned_threshold(), round(seconds, 5)))
        return seconds

    t0 = time.perf_counter()
    autotune.build_bayes_library()
    build_s = time.perf_counter() - t0
    best = autotune.tune_fusion_threshold(build, time_step,
                                          rounds=AUTOTUNE_BO_ROUNDS)
    return best, rounds, build_s


def _model_guided(step):
    """Model-guided pruning of the default grid with this process's fits
    (the observability phase's microprobe) and the noted leaf layout:
    the tuner's own ``_maybe_prune``, outside a sweep. Returns (kept,
    pruned, prices of the tail)."""
    from horovod_tpu_torch import autotune, comms_model
    from horovod_tpu_torch.ops.collective_ops import _link_class
    from horovod_tpu_torch.process_sets import global_process_set

    os.environ["HOROVOD_AUTOTUNE_MODEL_GUIDED"] = "1"
    try:
        autotune.reset_for_testing()
        tuner = autotune.AutotuneStep(step)
        tuner._maybe_prune()
    finally:
        os.environ.pop("HOROVOD_AUTOTUNE_MODEL_GUIDED", None)
    model = comms_model.get_model()
    prices = comms_model.prune_candidates(
        list(autotune.DEFAULT_THRESHOLDS[1:]), model.leaf_sizes(),
        _link_class(global_process_set))["costs"]
    pruned = autotune.autotune_state()["pruned"]
    autotune.reset_for_testing()
    return tuner._cands, pruned, prices, model.ready()


def autotune_phase(card):
    """BERT-Large S=512 x 8 untuned and under ``HOROVOD_AUTOTUNE=1`` (see
    the module docstring, 13c)."""
    import dataclasses
    import gc
    import shutil

    import torch

    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops.fusion import bucket_leaves

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "chip_smoke_autotune")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _, B, S, P, kernels = BERT_PATHS[0]
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    import horovod_tpu_torch as hvd

    dev = hvd.device()
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(cfg, B, S, P, 0, dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t_phase = time.perf_counter()
    runs = []
    try:
        plain = _autotune_run(cfg, model, initial, batch, tmp, False)
        runs.append(plain)
        plain["opt"].remove_hooks()
        tuned = _autotune_run(cfg, model, initial, batch, tmp, True)
        runs.append(tuned)
        state, pin = tuned["state"], autotune.tuned_threshold()
        samples = state["history"]
        layout = [(p.numel(), torch.bfloat16) for p in model.parameters()]
        want_buckets = len(bucket_leaves(layout, pin))
        if not (pin in autotune.DEFAULT_THRESHOLDS and len(samples) == 3
                and len(tuned["log"]) == 1
                and json.loads(tuned["log"][0])["decision"] == pin
                and tuned["buckets"][1] == want_buckets):
            raise AssertionError(
                f"autotune: pin {pin}, samples {samples}, log "
                f"{tuned.get('log')}, buckets {tuned['buckets']} (want "
                f"{want_buckets} after)")
        if tuned["losses"] != plain["losses"]:
            raise AssertionError(
                f"autotune: tuned losses {tuned['losses']} differ from the "
                f"untuned run's {plain['losses']}")
        for run, which in ((plain, "untuned"), (tuned, "tuned")):
            for kname, n in run["launches"].items():
                want = (cfg.num_layers * AUTOTUNE_STEPS if kname in kernels
                        else 0)
                if n != want:
                    raise AssertionError(
                        f"autotune: {which}: {kname} launched {n} times in "
                        f"{AUTOTUNE_STEPS} steps, expected {want}")
        print(f"autotune: BERT-Large S=512 x {B}, bf16 wire, "
              f"{AUTOTUNE_STEPS} AdamW steps from seed 0 under "
              f"HOROVOD_AUTOTUNE=1: windows (threshold, s a step over 3 "
              f"calls ended by one read of the loss) {samples}; pinned "
              f"{pin} bytes; buckets {tuned['buckets'][0]} before, "
              f"{tuned['buckets'][1]} after; losses equal the untuned "
              f"run's bit for bit ({tuned['losses'][-1]:.6f} last); K1, "
              f"K3, K4 launched {cfg.num_layers} times a step in both "
              f"({ {k: tuned['launches'][k] for k in kernels} }) on {card}")
        print(f"autotune: HOROVOD_AUTOTUNE_LOG: {tuned['log'][0]}")
        best, rounds, build_s = _bo_rounds(tuned["step"], batch)
        print(f"autotune: Bayesian optimizer built with g++ in "
              f"{build_s:.2f} s; tune_fusion_threshold, "
              f"{AUTOTUNE_BO_ROUNDS} rounds (threshold, s a step): "
              f"{rounds}; best {best} bytes on {card}")
        kept, pruned, prices, ready = _model_guided(tuned["step"])
        if not ready:
            raise AssertionError("autotune: the comms model has no ready "
                                 "fit for model-guided pruning")
        print(f"autotune: model-guided pruning of "
              f"{list(autotune.DEFAULT_THRESHOLDS)} with the microprobe's "
              f"fits: kept {kept}, pruned {pruned}; predicted wire s of "
              f"{list(autotune.DEFAULT_THRESHOLDS[1:])}: {prices}")
    finally:
        torch.use_deterministic_algorithms(False)
        autotune.reset_for_testing()
        for run in runs:
            run["opt"].remove_hooks()
        shutil.rmtree(tmp, ignore_errors=True)
        del model, initial, runs
        gc.collect()
        torch.cuda.empty_cache()
    print(f"autotune: the phase took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}")


NEG_STEPS = 6
NEG_AUTOTUNE_STEPS = 20
NEG_PROFILED_STEPS = 2


class _NegotiatedStep:
    """A training step whose gradients are averaged by the negotiated
    runtime: each parameter's post-accumulate hook enqueues its gradient
    as the named in-place ``allreduce_async_`` ``grad.<name>`` in backward
    order; the step synchronizes every handle, then runs the plain
    optimizer."""

    def __init__(self, world, model, opt):
        self.world, self.model, self.opt = world, model, opt
        self.handles = []
        names = {p: n for n, p in model.named_parameters()}
        self.leaves = len(names)
        self.hooks = [p.register_post_accumulate_grad_hook(
            lambda p, name=names[p]: self.handles.append(
                self.world.allreduce_async_(p.grad, name=f"grad.{name}",
                                            op="average")))
            for p in model.parameters()]

    def __call__(self, batch):
        loss = _bert_loss(self.model, batch)
        loss.backward()
        for h in self.handles:
            self.world.synchronize(h)
        self.handles.clear()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return loss.detach()

    def remove(self):
        for h in self.hooks:
            h.remove()


def _neg_run(model, initial, batch, steps, world=None):
    """``steps`` AdamW steps from ``initial``: through the negotiated
    ``world``, or (None) through the ``DistributedOptimizer`` on the
    float32 wire and ``make_train_step``. Returns the losses, each step's
    host ms (ended by a synchronize), the launches, the negotiation's
    counters after each step and the device busy ms a step of
    ``NEG_PROFILED_STEPS`` more profiled steps."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _kernels

    model.load_state_dict(initial)
    adamw = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    if world is None:
        opt = hvd.DistributedOptimizer(
            adamw, named_parameters=model.named_parameters(),
            compression=hvd.Compression.none)
        step = hvd.make_train_step(model, _bert_loss, opt)
    else:
        opt, step = adamw, _NegotiatedStep(world, model, adamw)
    for k in _kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    losses, times, counters = [], [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if world is not None:
                counters.append(dict(
                    hits=world.cache_hits, misses=world.cache_misses,
                    cycles=world.cycles, responses=world.responses,
                    host_s=world.executor_seconds))
        launches = {k.name: k.launches for k in _kernels.KERNELS}
        params = [p.detach().clone() for p in model.parameters()]
        busy = None
        with device_profile() as prof:
            for _ in range(NEG_PROFILED_STEPS):
                step(batch)
        spans = [(a, b) for _, a, b in device_events(prof)]
        if spans:
            busy = _busy_us(spans) / 1e3 / NEG_PROFILED_STEPS
    finally:
        if world is None:
            opt.remove_hooks()
        else:
            step.remove()
    return dict(losses=losses, times=times, launches=launches, params=params,
                counters=counters, busy=busy,
                leaves=getattr(step, "leaves", None))


def _neg_world(dev):
    from horovod_tpu_torch.runner.network import free_port
    from horovod_tpu_torch.runtime import NativeWorld

    return NativeWorld(0, 1, "127.0.0.1", free_port(), device=dev)


def negotiation_phase(card):
    """BERT-Large S=512 x 8 through the negotiated runtime (see the module
    docstring, 13d)."""
    import dataclasses
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.models import bert as bert_mod

    _, B, S, P, kernels = BERT_PATHS[0]
    cfg = dataclasses.replace(bert_mod.BERT_LARGE, dropout_rate=0.0)
    dev = hvd.device()
    t0 = time.perf_counter()
    runtime.load_library()
    build_s = time.perf_counter() - t0
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(cfg, B, S, P, 0, dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    world = tuned = None
    try:
        direct = _neg_run(model, initial, batch, NEG_STEPS)
        world = _neg_world(dev)
        neg = _neg_run(model, initial, batch, NEG_STEPS, world)
        for run, which in ((direct, "direct"), (neg, "negotiated")):
            for kname, n in run["launches"].items():
                want = cfg.num_layers * NEG_STEPS if kname in kernels else 0
                if n != want:
                    raise AssertionError(
                        f"negotiation: {which}: {kname} launched {n} times "
                        f"in {NEG_STEPS} steps, expected {want}")
        unequal = sum(not torch.equal(a, b)
                      for a, b in zip(neg["params"], direct["params"]))
        if unequal or neg["losses"] != direct["losses"]:
            raise AssertionError(
                f"negotiation: {unequal} of {len(neg['params'])} parameters "
                f"differ from the direct path's after {NEG_STEPS} steps "
                f"(losses {neg['losses']} against {direct['losses']})")
        c = neg["counters"]
        leaves = neg["leaves"]
        if not (c[0]["misses"] == leaves
                and all(x["misses"] == leaves for x in c)
                and all(c[i]["hits"] - c[i - 1]["hits"] == leaves
                        for i in range(1, len(c)))):
            raise AssertionError(
                f"negotiation: {leaves} leaves, cache counters per step "
                f"{[(x['hits'], x['misses']) for x in c]}: every leaf must "
                "miss in step 1 and hit from step 2 on")
        per = [{k: c[i][k] - (c[i - 1][k] if i else 0)
                for k in ("responses", "cycles", "host_s")}
               for i in range(len(c))]
        late = per[1:]
        mean = {k: statistics.mean(x[k] for x in late) for k in late[0]}
        print(f"negotiation: BERT-Large S=512 x {B}, {leaves} gradient "
              f"leaves as named allreduce_async_ from post-accumulate "
              f"hooks, {NEG_STEPS} AdamW steps from seed 0: parameters "
              f"equal the DistributedOptimizer's (float32 wire) bit for "
              f"bit, losses {[round(x, 6) for x in neg['losses']]}; K1, "
              f"K3, K4 launched {cfg.num_layers} times a step in both; "
              f"control plane built with g++ in {build_s:.2f} s")
        print(f"negotiation: cache hits/misses after each step "
              f"{[(x['hits'], x['misses']) for x in c]}; per step "
              f"(responses, cycles, executor host ms) "
              f"{[(x['responses'], x['cycles'], round(x['host_s'] * 1e3, 3)) for x in per]}; "
              f"steps 2-{NEG_STEPS} mean: {mean['responses']:.1f} fused "
              f"responses, {mean['cycles']:.1f} cycles, "
              f"{mean['host_s'] * 1e3:.3f} executor host ms on {card}")
        d_ms = statistics.median(direct["times"][WARMUP_STEPS:])
        n_ms = statistics.median(neg["times"][WARMUP_STEPS:])
        busy = {k: (f"{r['busy']:.2f}" if r["busy"] is not None
                    else "not measured")
                for k, r in (("direct", direct), ("negotiated", neg))}
        print(f"negotiation: step ms median (steps {WARMUP_STEPS + 1}-"
              f"{NEG_STEPS}) negotiated {n_ms:.2f}, direct {d_ms:.2f}; "
              f"device busy ms a step (profiled) negotiated "
              f"{busy['negotiated']}, direct {busy['direct']} on {card}")
        world.shutdown()
        world = None
        os.environ["HOROVOD_AUTOTUNE"] = "1"
        try:
            tuned = _neg_world(dev)
        finally:
            os.environ.pop("HOROVOD_AUTOTUNE", None)
        before = tuned.autotune_state()
        run = _neg_run(model, initial, batch, NEG_AUTOTUNE_STEPS, tuned)
        after = tuned.autotune_state()
        if not (before["active"] and after["samples"] > 0 and (
                after["fusion_threshold"] != before["fusion_threshold"]
                or after["cycle_time_ms"] != before["cycle_time_ms"])):
            raise AssertionError(
                f"negotiation: HOROVOD_AUTOTUNE=1 did not move the knobs in "
                f"{NEG_AUTOTUNE_STEPS} steps: {before} -> {after}")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"negotiation: autotuned losses "
                                 f"{run['losses']}")
        print(f"negotiation: HOROVOD_AUTOTUNE=1, {NEG_AUTOTUNE_STEPS} "
              f"steps: autotune_state() {before} -> {after}; cycles "
              f"{tuned.cycles}, responses {tuned.responses} on {card}")
    finally:
        torch.use_deterministic_algorithms(False)
        for w in (world, tuned):
            if w is not None:
                w.shutdown()
        del model, initial
        gc.collect()
        torch.cuda.empty_cache()


def kernel_rows():
    """The kernels line's rows, (name, Kernel, source file under csrc/):
    each kernel, then the D = 256 instances of the multi-tile three, then
    the 3xTF32 float32 kernels (their own source): the forward, dQ and
    dK/dV at D = 256 and at D = 64, the single-tile forward and fused
    backward at D = 64, the wide-head forward, dQ and dK/dV at D = 512, and
    the filter gradient at ResNet-50's stage 1."""
    from horovod_tpu_torch.ops import _kernels

    return [(k.name, k, k.source) for k in _kernels.KERNELS] + [
        (f"{k.name}_d256", k, k.source)
        for k in (_kernels.FLASH_FWD, _kernels.FLASH_DQ, _kernels.FLASH_DKV)
    ] + [(name, k, "flash_attention_3xtf32.cu") for name, k in (
        ("flash_fwd_d256_float32", _kernels.FLASH_FWD),
        ("flash_dq_d256_float32", _kernels.FLASH_DQ),
        ("flash_dkv_d256_float32", _kernels.FLASH_DKV),
        ("flash_fwd_float32", _kernels.FLASH_FWD),
        ("flash_dq_float32", _kernels.FLASH_DQ),
        ("flash_dkv_float32", _kernels.FLASH_DKV),
        ("flash_fwd_single_float32", _kernels.FLASH_FWD_SINGLE),
        ("flash_dqkv_float32", _kernels.FLASH_DQKV),
        ("flash_fwd_wide_float32", _kernels.FLASH_FWD_WIDE),
        ("flash_dq_wide_float32", _kernels.FLASH_DQ_WIDE),
        ("flash_dkv_wide_float32", _kernels.FLASH_DKV_WIDE))] + [
        ("dw_1x1_float32", _kernels.DW_1X1, "conv1x1_dw.cu")]


def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "horovod_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "horovod_tpu_torch package beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    # The first spin of this process, timed (C9).
    from horovod_tpu_torch.utils.spin import Spin

    first = Spin(FIRST_SPIN_CYCLES)
    print(f"first spin: {first.ms():.3f} ms by CUDA events, at least "
          f"{first.least_ms():.3f}: {'SHORT' if first.short() else 'held'}")
    _phase("build", build_phase)
    measured = _phase("kernels", kernel_phase)
    _phase("empty", empty_phase)
    measured.update(_phase("dw_kernels", dw_kernel_phase))
    launches = _phase("wide_heads", wide_heads_phase)
    wide_measured, wide_launches = _phase("wide", wide_phase)
    measured.update(wide_measured)
    launches.update(wide_launches)
    # A one-rank world would short-circuit the wire; force the bf16 casts,
    # the bucket packing and the NCCL allreduce to run.
    os.environ["HOROVOD_FORCE_WIRE_MACHINERY"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _kernels

    hvd.init()
    for path in BERT_PATHS:
        counts = _phase(path[0], training_phase, card, path)
        launches.update({k: counts[k] for k in path[4]})
    _phase("guarded", guarded_phase, card)
    plain_busy = _phase("resnet50", resnet_phase, card)
    _phase("lenet", lenet_phase, card)
    launches.update(_phase("conv1x1", conv_phase, card))
    _phase("collectives", collectives_phase, card)
    modes = _phase("sync_modes", sync_modes_phase, card)
    modes["int8"] = (*_phase("int8", int8_phase, card), None)
    _phase("checkpoint", checkpoint_phase, card)
    _phase("adasum", adasum_phase, card)
    _phase("syncbn", syncbn_phase, card, plain_busy)
    _phase("launcher", launcher_phase, card)
    _phase("elastic", elastic_phase, card)
    _phase("elastic_peer", elastic_peer_phase, card)
    _phase("observability", observability_phase, card)
    _phase("autotune", autotune_phase, card)
    _phase("negotiation", negotiation_phase, card)
    print("sync modes, BERT-Large S=512 x 8 at world size 1 (step ms median, "
          "max_memory_allocated GiB, optimizer-state bytes on this rank): "
          + "; ".join(f"{m} {ms:.2f} ms, {peak:.2f} GiB, {state}"
                      for m, (ms, peak, state) in modes.items())
          + f" on {card}")
    _phase("agree", agreement_phase, 96, ("flash_fwd_single", "flash_dqkv"))
    _phase("agree", agreement_phase, 160,
           ("flash_fwd", "flash_dq", "flash_dkv"))
    _phase("agree_resnet50", resnet_agreement_phase)
    print(f"phase all: {time.perf_counter() - t_start:.1f} s")

    rows = kernel_rows()
    kernels = [dict(name=name, route="cuda",
                    source=f"horovod_tpu_torch/ops/csrc/{source}",
                    replaces=k.replaces, launches=launches[name],
                    **measured[name]) for name, k, source in rows]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    hvd.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
