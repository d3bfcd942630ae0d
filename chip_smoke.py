#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build of the hand-written CUDA kernels from ``horovod_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together); no Hopper (wgmma)
   instance (the bf16 forward, dQ, dK/dV, single-tile forward and fused
   backward at D=16, 32, 64, 128, and the bf16 filter gradient) may spill
   or have its wgmma serialized;
3. kernel phase: every kernel against its plain PyTorch version on the same
   inputs, with times beside the bound and the library yardstick:
   - the multi-tile forward, dQ and dK/dV flash-attention kernels
     (BERT-Large S=512 shape in bf16; a causal, ragged, offset case with
     fully masked rows and a nonzero lse cotangent at D=64, D=128 and
     D=16; a causal D=32 case with a query offset; a float32 case);
   - the single-tile forward and fused backward (BERT-Large phase-1 shape,
     S=128, in bf16; causal 96 x 128 with offsets, masked rows and a
     nonzero lse cotangent; float32 causal with an offset; bf16 at D=128;
     causal bf16 at D=16 and D=32; a causal ragged 77 x 100 case with a key
     offset);
   - the 1x1-conv filter gradient (ResNet-50 stage-1 bottleneck 64 -> 256;
     the stride-2 projection shortcut 256 -> 512, timed beside its own
     cuBLAS call; bf16 with a ragged K and ragged channel tiles; bf16 on a
     stride-2 view with an odd H; float32 with a ragged K); two bf16 calls
     on the same inputs must agree bit for bit;
4. training phase: synchronous data-parallel BERT-Large training through
   ``init`` / ``DistributedOptimizer`` / ``broadcast_parameters`` with the
   1-rank NCCL bucketed allreduce forced on, on two paths: sequence 512
   (multi-tile kernels) and sequence 128, the phase-1 pretraining length
   (single-tile kernels). Launch counters show that every attention call of
   a path went through its own kernels and none through the other route's;
   each path is profiled;
5. ``conv1x1`` phase: forward and backward of ``conv1x1`` through autograd
   at the two ResNet-50 shapes, with one filter-gradient launch per
   backward, dx and dw held against the plain counterpart;
6. agreement: the flash model against dense attention on small float32
   inputs, on each attention route.

The second-last lines are the ``kernels`` JSON line and the card line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32 on
# the FMA units (the float32 kernel path does not use TF32), memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version on the same inputs: max |kernel - plain| must
# stay within TOL[dtype] * max |plain| (lse: absolute TOL_LSE). bf16 outputs
# are rounded to 8 mantissa bits and P/dS round to bf16 at points that can
# differ by one ulp between the two summation orders; float32 differs only
# by summation order.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3

# Kernel vs plain version of the 1x1-conv filter gradient: both sum exact
# bf16 products (or float32 FMAs) in fp32, in another order, over up to
# 401,408 rows: max |kernel - plain| <= TOL_DW[dtype] * max |plain|.
TOL_DW = {"bfloat16": 1e-3, "float32": 1e-4}

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


# The Hopper (wgmma) instances: the bf16 kernels of both attention routes at
# every head dim, and the bf16 1x1-conv filter gradient (the float32
# kernels are named *_f32_kernel).
HOPPER_INSTANCES = tuple(f"{k}<{d}>" for k in ("flash_fwd_kernel",
                                               "flash_dq_kernel",
                                               "flash_dkv_kernel",
                                               "flash_fwd_single_kernel",
                                               "flash_dqkv_kernel")
                         for d in (16, 32, 64, 128)) + ("dw_1x1_kernel",)
_HOPPER_NAME = re.compile(
    r"(flash_(?:fwd_single|fwd|dqkv|dq|dkv)_kernel)ILi(\d+)E"
    r"|\d(dw_1x1_kernel)E")


def _hopper_instance(line):
    """The Hopper instance a line of ptxas output names, or None."""
    found = _HOPPER_NAME.search(line)
    if not found:
        return None
    if found.group(3):
        return found.group(3)
    return f"{found.group(1)}<{found.group(2)}>"


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
    item = 2 if dtype_name == "bfloat16" else 4
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


def _dw_bounds(K, ci, co, dtype_name):
    """The filter gradient reads x [K, Cin] and dy [K, Cout] once and writes
    dw [Cin, Cout] in fp32: 2 K Cin Cout operations."""
    item = 2 if dtype_name == "bfloat16" else 4
    return _bound(2.0 * K * ci * co, K * (ci + co) * item + ci * co * 4,
                  dtype_name)


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


def _timing(kern, plain, bounds, library_ms):
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    bound_ms, bound_by, flops, moved = bounds
    return (dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms),
            f" ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB) "
            f"{flops / ms / 1e9:.1f} TFLOP/s {moved / ms / 1e6:.1f} GB/s "
            f"library_ms {library_ms}")


def kernel_phase():
    """Hold each flash-attention kernel against its plain version; return
    the timed cases' measurements keyed by kernel name."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    (_, b512, s512, _, _), (_, b128, s128, _, _) = BERT_PATHS
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, H, Sq, Sk, D, dtype, causal, q_offset, k_offset, g_lse,
        # timed. Sq, Sk <= A.SINGLE_TILE_MAX take the single-tile kernels.
        ("bert_large_bf16", b512, 16, s512, s512, 64, bf16, False, 0, 0,
         False, True),
        ("causal_ragged_bf16", 2, 3, 200, 264, 64, bf16, True, 0, 40, True,
         False),
        # The Hopper kernels at the other head dims: D = 128 (two 64-column
        # TMA boxes, 32-row dK/dV stages), D = 32 (64-byte swizzle) and
        # D = 16 (32-byte swizzle, n16 wgmma for P V, P^T dO and dS^T Q).
        ("d128_causal_ragged_bf16", 2, 3, 200, 264, 128, bf16, True, 0, 40,
         True, False),
        ("d32_causal_bf16", 2, 3, 320, 384, 32, bf16, True, 64, 0, True,
         False),
        ("d16_causal_ragged_bf16", 2, 3, 200, 264, 16, bf16, True, 0, 40,
         True, False),
        ("float32", 2, 4, 200, 136, 64, f32, True, 70, 0, True, False),
        ("bert_large_s128_bf16", b128, 16, s128, s128, 64, bf16, False, 0, 0,
         False, True),
        ("causal_single_bf16", 2, 3, 96, 128, 64, bf16, True, 0, 40, True,
         False),
        ("float32_single", 2, 4, 128, 128, 64, f32, True, 16, 0, True,
         False),
        ("d128_single_bf16", 2, 4, 128, 128, 128, bf16, False, 0, 0, True,
         False),
        # The single-tile Hopper forward at the other head dims, and on
        # lengths that are no multiple of 16 (rows 0..22 see no key).
        ("d16_single_causal_bf16", 2, 3, 128, 128, 16, bf16, True, 0, 0,
         True, False),
        ("d32_single_causal_bf16", 2, 3, 112, 128, 32, bf16, True, 16, 0,
         True, False),
        ("ragged_single_bf16", 2, 3, 77, 100, 64, bf16, True, 0, 23, True,
         False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = {}
    for (case, B, H, Sq, Sk, D, dtype, causal, qo, ko, with_glse,
         timed) in cases:
        BH = B * H
        dname = str(dtype).split(".")[-1]

        def rnd(*shape, dt=dtype):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dt)

        q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
        do = rnd(BH, Sq, D)
        o_ref, lse_ref = A.flash_fwd_plain(q, k, v, causal, qo, ko)
        delta = (do.float() * o_ref.float()).sum(-1)
        glse = (rnd(BH, Sq, dt=torch.float32) if with_glse
                else torch.zeros(BH, Sq, device="cuda"))
        bwd_args = (q, k, v, do, lse_ref, delta, glse, causal, qo, ko)
        fwd_args = (q, k, v, causal, qo, ko)
        if Sq <= A.SINGLE_TILE_MAX and Sk <= A.SINGLE_TILE_MAX:
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
                numbers, text = _timing(
                    kern, plain,
                    _bounds(name, BH, Sq, Sk, D, dname, causal, qo, ko),
                    library.get(name))
                measured[name] = dict(max_abs_err=err, **numbers)
                line += text
            print(line)
        if timed and "flash_dqkv" in runs:
            # The other route on the same inputs: what the single-tile
            # kernels save over the multi-tile ones at this shape.
            fwd_ms = time_ms(lambda: A.flash_fwd(*fwd_args))
            bwd_ms = time_ms(lambda: (A.flash_dq(*bwd_args),
                                      A.flash_dkv(*bwd_args)))
            print(f"route {case}: multi-tile flash_fwd {fwd_ms:.4f} ms, "
                  f"flash_dq + flash_dkv {bwd_ms:.4f} ms on the same inputs")
    return measured


def dw_kernel_phase():
    """Hold the 1x1-conv filter-gradient kernel against its plain version;
    return the stage-1 case's measurements."""
    import torch

    from horovod_tpu_torch.ops import conv_backward as C

    bf16, f32 = torch.bfloat16, torch.float32
    # name, N, H, W, Cin, Cout, strides, dtype, timed (the first case's
    # numbers are the kernel's line of the JSON).
    cases = [(*shape, bf16, True) for shape in CONV_SHAPES]
    cases += [
        # K = 5 * 37 * 41 = 7585 rows: no multiple of any tile; Cin = 72
        # and Cout = 40 leave ragged channel tiles too.
        ("bf16_ragged", 5, 37, 41, 72, 40, (1, 1), bf16, False),
        # Odd H: the stride-2 view's images do not follow each other
        # evenly (a 4-D row grid), and W' = 15 needs padded boxes.
        ("bf16_stride2_odd_h", 4, 37, 30, 64, 128, (2, 2), bf16, False),
        ("float32_ragged", 5, 37, 41, 72, 40, (1, 1), f32, False),
    ]
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
        bounds = _dw_bounds(K, ci, co, dname)
        if timed:
            # One library call for the same function: cuBLAS, bf16 in and
            # out (the kernel returns fp32). A strided view would make
            # matmul copy it inside the timing, so the library reads a
            # contiguous copy of x made before.
            x2d = xs.reshape(K, ci) if xs.is_contiguous() else (
                xs.contiguous().reshape(K, ci))
            library_ms = time_ms(lambda: torch.matmul(x2d.T, dy))
            numbers, text = _timing(kern, plain, bounds, library_ms)
            if not measured:
                measured["dw_1x1"] = dict(max_abs_err=err, **numbers)
            line += text + " (library output bf16" + (
                "" if xs.is_contiguous() else
                "; library reads a contiguous copy of x, the copy untimed") + ")"
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
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    steps = WARMUP_STEPS + TIMED_STEPS
    for kname, n in launches.items():
        want = cfg.num_layers * steps if kname in kernels else 0
        if n != want:
            raise AssertionError(
                f"{name}: {kname} launched {n} times in {steps} steps; "
                f"expected {want} (this path runs {', '.join(kernels)} once "
                "per layer per step and no other kernel)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(
            f"{name}: loss did not fall on a repeated batch: {losses}")
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


def conv_phase(card):
    """``conv1x1`` forward and backward through autograd at the ResNet-50
    shapes: one filter-gradient launch per backward; dx and dw against the
    plain counterpart (plain products and ``dw_1x1_plain``). Returns the
    launch count."""
    import torch

    from horovod_tpu_torch.ops import _kernels
    from horovod_tpu_torch.ops import conv_backward as C

    gen = torch.Generator(device="cuda").manual_seed(2)
    _kernels.DW_1X1.launches = 0
    results = []
    for case, N, H, W, ci, co, strides in CONV_SHAPES:
        x = torch.randn(N, H, W, ci, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
        w = (torch.randn(1, 1, ci, co, generator=gen, device="cuda")
             / math.sqrt(ci)).to(torch.bfloat16).requires_grad_()
        out = C.conv1x1(x, w, strides)
        dy = torch.randn(out.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        out.backward(dy)
        results.append((case, N, H, W, co, x, w, dy, strides, out))
    torch.cuda.synchronize()
    launches = _kernels.DW_1X1.launches
    if launches != len(CONV_SHAPES):
        raise AssertionError(
            f"conv1x1: dw_1x1 launched {launches} times in "
            f"{len(CONV_SHAPES)} backward passes; expected one per backward")
    for case, N, H, W, co, x, w, dy, strides, out in results:
        want_out = C._conv1x1_forward(x.detach(), w.detach(), strides)
        dx, dw = C.conv1x1_backward(x.detach(), w.detach(), dy, strides,
                                    C.dw_1x1_plain)
        if not (torch.equal(out, want_out) and torch.equal(x.grad, dx)):
            raise AssertionError(f"conv1x1 {case}: output or dx differs "
                                 "from the plain products")
        want_shape = (N, -(-H // strides[0]), -(-W // strides[1]), co)
        if tuple(out.shape) != want_shape:
            raise AssertionError(f"conv1x1 {case}: output shape "
                                 f"{tuple(out.shape)}, expected {want_shape}")
        if not (torch.isfinite(w.grad).all() and w.grad.dtype == w.dtype
                and w.grad.shape == w.shape):
            raise AssertionError(f"conv1x1 {case}: dw {w.grad.dtype} "
                                 f"{tuple(w.grad.shape)} not finite")
        err, line = _hold(f"conv1x1 {case}", "dw", (w.grad,), (dw,),
                          TOL["bfloat16"])
        print(f"{line}; output and dx equal to the plain products; output "
              f"{tuple(out.shape)} on {card}")
    print(f"conv1x1: dw_1x1 launched {launches} times in "
          f"{len(CONV_SHAPES)} backward passes")
    return launches


_CATEGORIES = (  # first match wins; by lower-cased kernel name
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_f32_kernel")),
    ("flash_dq", ("flash_dq_kernel", "flash_dq_f32_kernel")),
    ("flash_dkv", ("flash_dkv_kernel", "flash_dkv_f32_kernel")),
    ("flash_fwd_single", ("flash_fwd_single_kernel",
                          "flash_fwd_single_f32_kernel")),
    ("flash_dqkv", ("flash_dqkv_kernel", "flash_dqkv_f32_kernel")),
    ("dw_1x1", ("dw_1x1_kernel", "dw_1x1_partial_f32_kernel",
                "dw_1x1_reduce_kernel")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
    ("nccl", ("nccl",)),
    ("optimizer", ("multi_tensor_apply",)),
)


def profile_steps(path, step, batch, card, step_ms, n=2):
    """Device time per step by kernel category over ``n`` profiled steps;
    the device's idle share of the unprofiled step (``step_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_cat: dict[str, float] = {}
    other: dict[str, float] = {}
    spans = []
    for e in prof.events():
        # Device-side copies of host annotations (Optimizer.step, ...) span
        # kernels counted on their own: skip them.
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        per_cat[cat] = per_cat.get(cat, 0.0) + (end - start) / 1e3
        if cat == "other":
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + (end - start) / 1e3
    if not spans:
        print(f"profile {path}: the profiler recorded no device events; "
              "device breakdown not measured")
        return
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    busy_ms = busy_us / 1e3
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

    card = card_line()
    print(f"card: {card}")
    build_phase()
    measured = kernel_phase()
    measured.update(dw_kernel_phase())
    # A one-rank world would short-circuit the wire; force the bf16 casts,
    # the bucket packing and the NCCL allreduce to run.
    os.environ["HOROVOD_FORCE_WIRE_MACHINERY"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _kernels

    hvd.init()
    launches = {}
    for path in BERT_PATHS:
        counts = training_phase(card, path)
        launches.update({k: counts[k] for k in path[4]})
    launches["dw_1x1"] = conv_phase(card)
    agreement_phase(96, ("flash_fwd_single", "flash_dqkv"))
    agreement_phase(160, ("flash_fwd", "flash_dq", "flash_dkv"))

    kernels = [dict(name=k.name, route="cuda",
                    source=f"horovod_tpu_torch/ops/csrc/{k.source}",
                    replaces=k.replaces, launches=launches[k.name],
                    **measured[k.name]) for k in _kernels.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    hvd.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
