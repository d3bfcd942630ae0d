#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on one NVIDIA GPU, beyond
``chip_smoke.py``. Run from the root of a checkout, with one card visible:

    python3 chip_diag.py ab OTHER_CHECKOUT
    python3 chip_diag.py watchdog
    python3 chip_diag.py collectives [--cpu]
    python3 chip_diag.py comms [--cpu]
    python3 chip_diag.py planner [--cpu]
    python3 chip_diag.py spins
    python3 chip_diag.py fsdp_gathers
    python3 chip_diag.py elastic [--fsdp | --straggler] [--cpu] [--log PATH]
    python3 chip_diag.py ab_steps OTHER_CHECKOUT

``ab`` times the kernels of OTHER_CHECKOUT and of this checkout at
chip_smoke.py's shapes: at its BERT-Large path shapes (D = 64, bf16,
non-causal) the multi-tile attention kernels (flash_fwd, flash_dq,
flash_dkv) and the SDPA forward and backward at S=512 (B*H = 128); the
single-tile forward and fused backward (flash_fwd_single, flash_dqkv), the
SDPA forward and backward, and flash_dq + flash_dkv on flash_dqkv's inputs
at S=128 (B*H = 1024); the float16 instances of those five kernels at the
same two shapes (``*_f16``; printed only, for a checkout that has them);
and the 1x1-conv filter gradient (dw_1x1) beside cuBLAS's x^T dy at both
ResNet-50 shapes of chip_smoke.py (the shortcut's cuBLAS call reads a
contiguous copy of its strided x), and at both shapes in float32
(``dw_1x1_stage1_f32`` beside ``cublas_stage1_f32``,
``dw_1x1_shortcut_f32`` beside ``cublas_shortcut_f32``, full float32 with
TF32 off); the multi-tile kernels at D = 256
(``*_d256``: B*H = 128, S = 512) and the wide-head route at D = 512
(``*_wide``: B*H = 32, S = 512), each in bf16 and float32 (``*_f32``)
beside the SDPA forward and backward at that shape in the same dtype
(``sdpa_*_d256``, ``sdpa_*_d512``, ``*_f32``; the float32 rows on full
float32 values, the bf16 rows on the same values rounded to bf16); and
the float32 instances at D = 64 (``flash_fwd_f32``, ``flash_dq_f32``,
``flash_dkv_f32`` at S = 512; ``flash_fwd_single_f32``,
``flash_dqkv_f32`` at S = 128, with the 3xTF32 dQ + dK/dV on the fused
backward's inputs, ``flash_dq_dkv_s128_f32``) beside SDPA in float32
(``sdpa_*_f32``, ``sdpa_*_s128_f32``), the fused backward at D = 128
(``flash_dqkv_d128_f32``, B*H = 1024, S = 128; its plain version
``plain_dqkv_d128_f32``) beside SDPA's float32
backward there (``sdpa_bwd_s128_d128_f32``), the float32 dQ and dK/dV at
D = 32 and 128
(``flash_dq_d32_f32``, ..., B*H = 128, S = 512; at 128 the plain dQ and
dK/dV, ``plain_dq_dkv_d128_f32``) beside SDPA's float32
backward at D = 32 and 128 (``sdpa_bwd_d32_f32``, ``sdpa_bwd_d128_f32``),
on full float32 values, and the float32 wide dQ and dK/dV at B*H = 2,
S = 8192, D = 512 (``*_wide_long_f32``) beside SDPA's float32 backward
there (``sdpa_bwd_d512_long_f32``), with the peak memory of the float32
wide calls (``PEAK_CALLS``). After the times it prints each float32 row's
bound at the float32 FMA peak and at the TF32 peak (every float32 kernel
runs in 3xTF32; chip_smoke.py's ``_runs_3xtf32``; a row of two kernels
the sum of theirs), the float32 filter gradient's two bounds at both
shapes, then the kernels of SDPA's
float32 backward at D = 256 and of its float32 forward at D = 256 and
D = 64 (``SDPA_KERNELS``). Each checkout runs in a process of its own,
in the order other, this, this, other. Each process times every call by
three methods, all with the L2 flushed before each call:

- ``spin_ms``: ``chip_smoke.time_ms`` of this checkout, with the card spun
  before each call, so the CUDA events time device work;
- ``no_spin_ms``: the same without the spin, so a short call's time holds
  the host's launch overhead;
- ``device_ms``: the device time per call that ``torch.profiler`` records
  for the call's own kernels.

It prints one JSON line per process, then for each kernel and method the
mean of each checkout's two processes and the ratio other / this.

``watchdog`` builds a kernel whose warp waits, with ``sm90.cuh``'s
``mbar_wait``, on an mbarrier phase that never completes, and checks that
the kernel ends with an error once the wait's timeout has passed instead of
hanging. The kernel faults on purpose, so it runs in a process of its own.

``fsdp_gathers`` times chip_smoke.py's BERT-Large S = 512 x 8 under
``sync_mode="fsdp"`` (AdamW, bf16 wire, one card with the wire forced on)
with four placements of the parameter gathers, in the order A B C D D C B
A, twice: A every segment gathered before the forward (``opt.gather()``)
and the model run through ``torch.func.functional_call``, as the port ran
fsdp before its gathers were placed just in time; B ``make_train_step``
with ``HOROVOD_FSDP_RESHARD_AFTER_FORWARD=0`` (one gather up front, no
saved-tensor hook); C and D ``make_train_step`` just in time with 1 and 4
segments. Each run takes 13 steps (3 untimed); it prints each placement's
step medians, peak memory above what was held before the run, and its
last loss.

``collectives`` runs the eager surface across ranks, one process per card
(every visible card, at least two) over NCCL, or with ``--cpu`` four
processes over gloo, each started by the port's launcher (``python -m
horovod_tpu_torch.runner.launch -np N``, ``hvdrun-torch``; ``--cpu-mode``
with ``--cpu``): allreduce and reducescatter with every reduce op,
alltoall with equal chunks and with a split table (empty chunks
included), ragged allgather, broadcast, the grouped forms, async forms
with poll and synchronize, subsets {0, 1} and {1, ..., n-1} (members'
collectives, a non-member's refusal, removal), allgather_object and
masked_average; Adasum over the world and over the set {1, ..., n-1} (an
odd count at n = 4) held to the float64 tree of chip_smoke.py, every
rank's result the same bit for bit; SyncBatchNorm over ranks holding 32,
..., 32 and 31 images, held to one card's BatchNorm over the concatenated
batch (y, dx, dweight and dbias summed over the ranks, the running
statistics, which are the same bit for bit on every rank). Every rank
holds each result to a numpy reference made from the same seeded inputs
(float32 sums against float64, 1e-5). Then BERT-Large (``--cpu``:
BERT_TINY) takes 3 AdamW steps under ``DistributedOptimizer(op=Adasum)`` on
the bf16 wire, each rank on its own batch: every reduced gradient held to
the float64 tree over the ranks' bf16-wire gradients, the parameters the
same bit for bit on every rank, and (on the cards) the step's wire device
ms beside the tree's. Then
BERT-Large (``--cpu``: BERT_TINY) trains 3 AdamW steps from the same weights
under each sync mode, each rank on its own batch: sharded and fsdp over the
float32 wire with SGD and momentum, held to the allreduce run by
chip_smoke.py's check (the parameters' gap to the allreduce run within
``MODE_GAP_BOUND`` of the allreduce run's update, losses within
``MODE_LOSS_RTOL``), with a control (sharded, one bucket's gradients
dropped) that must fail it; then with AdamW sharded and fsdp over the
float32 wire and allreduce, sharded and fsdp over the int8 wire, whose
quantizations differ by mode, held to the float32 AdamW allreduce run on
their losses (``MODE_LOSS_RTOL``; int8 2e-2 relative). Each rank prints
its
optimizer-state bytes (about 1/n of the allreduce run's in the sharded
modes, or the check fails), fsdp's resident parameter bytes, step time and
peak memory per mode.

``comms`` seeds the comms model (``horovod_tpu_torch/comms_model.py``)
across ranks, one process per visible card over NCCL (``--cpu``: four gloo
processes), each started by ``hvdrun-torch`` as ``collectives`` starts
them: ``hvd.run_comms_microprobe`` over the world at ``COMMS_PROBE_SIZES``
(4 KB to 256 MB a rank, by fours; 3 timed calls each) of allreduce,
reducescatter, allgather and alltoall. Each rank prints every timed
call's microseconds (``comms samples``) and its alpha-beta fit
of each op under its world's link class (``intra_host`` on one host) as a
``comms rank`` JSON line; rank 0 then prints ``comms_model.merge_payloads``
of the ranks' payloads (gathered with ``allgather_object``) as a
``comms merged`` JSON line, and the cards' name and power limit. The bytes
of a sample are the world's total payload (a rank's tensor times the world
size), as every eager collective counts them.

``elastic`` (four cards; ``--cpu``: four gloo processes and BERT_TINY)
launches ``hvdrun-torch --min-np 2 --max-np 4 --host-discovery-script``
over the hosts 127.0.0.1-4, one slot and one card each (the worker sets
``CUDA_VISIBLE_DEVICES`` from its host before it imports torch), training
BERT-Large S = 512 x 8 under ``@hvd.elastic.run``. The fourth worker
SIGKILLs itself during step 3's backward; the survivors, waiting on it in
the NCCL allreduce, unblock on the driver's coordinated abort, re-form at
3 and go on; after ``ELASTIC_COOLDOWN_S`` the host returns and the world
re-forms at 4. It holds the losses equal across ranks at every step, the
parameters the same bit for bit on every rank at the end, and the run
within ``ELASTIC_WALL_S``, and prints the seconds from the kill to the
first step at 3 ranks and from the host's return to the first step at 4.

``elastic --fsdp`` (four cards; ``--cpu``: four gloo processes and
BERT_TINY) launches ``hvdrun-torch -np 4 --min-np 2 --max-np 4`` over the
same hosts with BERT-Large (24 layers) S = 512 x 8 under
``sync_mode="fsdp"``, AdamW, bf16 wire, ``make_train_step`` and an
``hvd.elastic.PeerShardedState`` committed after each step. The fourth
worker SIGKILLs itself during step 3's backward, in the reduce-scatters;
its host stays blacklisted (``ELASTIC_FSDP_COOLDOWN_S``). The three
survivors must recover on the ``peer`` rung with no durable read: the
state each rebuilds from the replicas and the state installed at 3 ranks
must have the sha256 of the full state gathered at step 2's commit
(gathered by the check at the commits before the kill, never by the
program). It holds the losses equal across ranks at every step, the
parameters bit-identical at the end and the run within
``ELASTIC_FSDP_WALL_S``, and prints the record bytes, the seconds of each
commit and the seconds from the kill to the first step at 3 ranks.

``elastic --straggler`` (four cards; ``--cpu``: four gloo processes and
BERT_TINY) launches ``hvdrun-torch -np 4`` over the same hosts with
BERT-Large S = 512 x 8, AdamW, bf16 wire, every step traced and shipped
(``HOROVOD_TRACE_SAMPLE=1``) and watched (``HOROVOD_STALL_CHECK_STEPS=1``),
and ``worker.step=delay:1.5@1x999999`` armed on the worker of
``STRAGGLER_HOST`` only, so that it enters every step 1.5 s late. After
``STRAGGLER_STEPS`` steps rank 0 reads the driver's ``/stragglers``,
``/criticalpath`` and ``/timeline``: it holds that both name the delayed
rank as the gating one (the worst skew's last rank, the critical path's
suspect in every step after the first, whose first-call work swamps the
delay) and that the timeline has 4 tracks, and prints
the skew, the critical path of the last step and each rank's phases.

``ab_steps`` trains chip_smoke.py's two BERT-Large paths (S = 512 x 8 and
S = 128 x 64, AdamW, bf16 wire, one card with the wire forced on: its
``training_phase``) through OTHER_CHECKOUT's package and this one's, each
checkout in a process of its own, in the order other, this, this, other,
and prints each path's median step ms and device busy ms per step for
each checkout (the mean of its two processes) and the ratio.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = ("flash_fwd", "flash_dq", "flash_dkv", "sdpa_fwd", "sdpa_bwd",
         "flash_fwd_single", "sdpa_fwd_s128", "flash_dqkv", "sdpa_bwd_s128",
         "flash_dq_dkv_s128", "dw_1x1_stage1", "cublas_stage1",
         "dw_1x1_shortcut", "cublas_shortcut", "flash_fwd_f16", "flash_dq_f16",
         "flash_dkv_f16", "flash_fwd_single_f16", "flash_dqkv_f16",
         "flash_fwd_d256", "flash_dq_d256", "flash_dkv_d256",
         "flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide", "sdpa_fwd_d512",
         "sdpa_bwd_d512", "flash_fwd_wide_f32", "flash_dq_wide_f32",
         "flash_dkv_wide_f32", "sdpa_fwd_d256", "sdpa_bwd_d256",
         "flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32", "sdpa_fwd_f32",
         "sdpa_bwd_f32", "flash_fwd_single_f32", "flash_dqkv_f32",
         "sdpa_fwd_s128_f32", "sdpa_bwd_s128_f32", "flash_fwd_d256_f32",
         "flash_dq_d256_f32", "flash_dkv_d256_f32", "sdpa_fwd_d256_f32",
         "sdpa_bwd_d256_f32", "sdpa_fwd_d512_f32", "sdpa_bwd_d512_f32",
         "flash_dq_d32_f32", "flash_dkv_d32_f32", "flash_dq_d128_f32",
         "flash_dkv_d128_f32", "sdpa_bwd_d128_f32", "sdpa_bwd_d32_f32",
         "dw_1x1_stage1_f32", "cublas_stage1_f32", "dw_1x1_shortcut_f32",
         "cublas_shortcut_f32", "flash_dq_wide_long_f32",
         "flash_dkv_wide_long_f32", "sdpa_bwd_d512_long_f32",
         "flash_dq_dkv_s128_f32", "flash_dqkv_d128_f32",
         "sdpa_bwd_s128_d128_f32", "plain_dqkv_d128_f32",
         "plain_dq_dkv_d128_f32")
# The float32 rows' shapes (name: kernel, or the kernels a row runs one
# after the other, B*H, S, D) for their bounds, printed by ab beside the
# times.
F32_BOUNDS = {
    "flash_fwd_f32": ("flash_fwd", 128, 512, 64),
    "flash_dq_f32": ("flash_dq", 128, 512, 64),
    "flash_dkv_f32": ("flash_dkv", 128, 512, 64),
    "flash_dq_d32_f32": ("flash_dq", 128, 512, 32),
    "flash_dkv_d32_f32": ("flash_dkv", 128, 512, 32),
    "flash_dq_d128_f32": ("flash_dq", 128, 512, 128),
    "flash_dkv_d128_f32": ("flash_dkv", 128, 512, 128),
    "flash_fwd_single_f32": ("flash_fwd_single", 1024, 128, 64),
    "flash_dqkv_f32": ("flash_dqkv", 1024, 128, 64),
    "flash_dq_dkv_s128_f32": (("flash_dq", "flash_dkv"), 1024, 128, 64),
    "flash_dqkv_d128_f32": ("flash_dqkv", 1024, 128, 128),
    "flash_fwd_d256_f32": ("flash_fwd", 128, 512, 256),
    "flash_dq_d256_f32": ("flash_dq", 128, 512, 256),
    "flash_dkv_d256_f32": ("flash_dkv", 128, 512, 256),
    "flash_fwd_wide_f32": ("flash_fwd", 32, 512, 512),
    "flash_dq_wide_f32": ("flash_dq", 32, 512, 512),
    "flash_dkv_wide_f32": ("flash_dkv", 32, 512, 512),
    "flash_dq_wide_long_f32": ("flash_dq", 2, 8192, 512),
    "flash_dkv_wide_long_f32": ("flash_dkv", 2, 8192, 512),
}
# The calls whose peak memory ab prints (MB above what was held before the
# call, its outputs included): the float32 wide dQ and dK/dV at S = 512
# and S = 8192.
PEAK_CALLS = ("flash_dq_wide_f32", "flash_dkv_wide_f32",
              "flash_dq_wide_long_f32", "flash_dkv_wide_long_f32")
# The float32 filter gradient's rows (dw_1x1_stage1_f32,
# dw_1x1_shortcut_f32) are at chip_smoke.py's CONV_SHAPES: ResNet-50's
# stage 1 and its stride-2 shortcut (x read in place as a strided view,
# cuBLAS reading a contiguous copy).
METHODS = ("spin_ms", "no_spin_ms", "device_ms")
# The SDPA calls whose kernels ab prints by device time: the float32
# backward at D = 256 and the float32 forward at D = 256 and D = 64.
SDPA_KERNELS = ("sdpa_bwd_d256_f32", "sdpa_fwd_d256_f32", "sdpa_fwd_f32")


@functools.cache
def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _device_events(body, reps):
    """(name, µs) of every device kernel that ``reps`` calls of ``body``
    ran, from a ``chip_smoke.device_profile`` session."""
    smoke = _smoke()
    with smoke.device_profile() as prof:
        for _ in range(reps):
            body()
    return [(name, end - start)
            for name, start, end in smoke.device_events(prof)]


def _device_ms(fn, reps=20):
    """Device ms per call of ``fn``, the L2 flushed before each call; the
    flush's own kernels are left out."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flush_kernels = {n for n, _ in _device_events(flush.zero_, 2)}
    events = _device_events(lambda: (flush.zero_(), fn()), reps)
    return sum(t for n, t in events if n not in flush_kernels) / reps / 1e3


def _worker(tree, label):
    """Time one checkout's kernels; print one JSON line."""
    import torch
    import torch.nn.functional as F

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from horovod_tpu_torch.ops import _kernels
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import conv_backward as C

    if not A.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {A.__file__}, not the checkout {tree}")
    smoke = _smoke()
    _kernels.build()
    (_, B, S, _, _), (_, B1, S1, _, _) = smoke.BERT_PATHS
    H, D = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B * H, S, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q1, k1, v1 = (torch.randn(B1 * H, S1, D, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    q14, k14, v14 = (t.view(B1, H, S1, D) for t in (q1, k1, v1))
    q14g, k14g, v14g = (t.detach().requires_grad_() for t in (q14, k14, v14))
    do1 = torch.randn(B1 * H, S1, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    o1, lse1 = A.flash_fwd_single_plain(q1, k1, v1)
    delta1 = (do1.float() * o1.float()).sum(-1)
    bwd1 = (q1, k1, v1, do1, lse1, delta1, torch.zeros_like(delta1), False,
            0, 0)
    out14 = F.scaled_dot_product_attention(q14g, k14g, v14g)
    do14 = do1.view(B1, H, S1, D)
    conv = {}
    for name, N, Hc, Wc, ci, co, strides in smoke.CONV_SHAPES:
        x = torch.randn(N, Hc, Wc, ci, generator=gen, device="cuda").to(
            torch.bfloat16)
        xs = x[:, ::strides[0], ::strides[1], :]
        K = xs.shape[:3].numel()
        dy = torch.randn(K, co, generator=gen, device="cuda").to(
            torch.bfloat16)
        conv[name] = (xs, xs.contiguous().reshape(K, ci), dy)
    (xs1, x2d1, dy1), (xs2, x2d2, dy2) = (conv[c[0]]
                                          for c in smoke.CONV_SHAPES)
    # Both shapes in full float32 (cuBLAS with TF32 off).
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_f32 = []
    for _, N, Hc, Wc, ci, co, strides in smoke.CONV_SHAPES:
        xf = torch.randn(N, Hc, Wc, ci, generator=gen, device="cuda")
        xsf = xf[:, ::strides[0], ::strides[1], :]
        K = xsf.shape[:3].numel()
        conv_f32.append((xsf, xsf.contiguous().reshape(K, ci),
                         torch.randn(K, co, generator=gen, device="cuda")))
    (xf, x2df, dyf), (xsf2, x2df2, dyf2) = conv_f32
    o, lse = A.flash_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, torch.zeros_like(delta), False, 0, 0)
    q4, k4, v4 = (t.view(B, H, S, D).detach().requires_grad_()
                  for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(B, H, S, D)
    calls = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, False, 0, 0),
        "flash_dq": lambda: A.flash_dq(*bwd),
        "flash_dkv": lambda: A.flash_dkv(*bwd),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4),
        "sdpa_bwd": lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                retain_graph=True),
        "flash_fwd_single": lambda: A.flash_fwd_single(q1, k1, v1, False, 0,
                                                       0),
        "sdpa_fwd_s128": lambda: F.scaled_dot_product_attention(q14, k14,
                                                                v14),
        "flash_dqkv": lambda: A.flash_dqkv(*bwd1),
        "sdpa_bwd_s128": lambda: torch.autograd.grad(
            out14, (q14g, k14g, v14g), do14, retain_graph=True),
        "flash_dq_dkv_s128": lambda: (A.flash_dq(*bwd1), A.flash_dkv(*bwd1)),
        "dw_1x1_stage1": lambda: C.dw_1x1(xs1, dy1),
        "cublas_stage1": lambda: torch.matmul(x2d1.T, dy1),
        "dw_1x1_shortcut": lambda: C.dw_1x1(xs2, dy2),
        "cublas_shortcut": lambda: torch.matmul(x2d2.T, dy2),
        "dw_1x1_stage1_f32": lambda: C.dw_1x1(xf, dyf),
        "cublas_stage1_f32": lambda: torch.matmul(x2df.T, dyf),
        "dw_1x1_shortcut_f32": lambda: C.dw_1x1(xsf2, dyf2),
        "cublas_shortcut_f32": lambda: torch.matmul(x2df2.T, dyf2),
    }
    if torch.float16 in A._KERNEL_DTYPES:  # the float16 instances
        # q, k, v, dO in float16; lse, delta and g_lse stay float32.
        h, h1 = ([*(t.half() for t in args[:4]), *args[4:7]]
                 for args in (bwd, bwd1))
        calls.update({
            "flash_fwd_f16": lambda: A.flash_fwd(*h[:3]),
            "flash_dq_f16": lambda: A.flash_dq(*h),
            "flash_dkv_f16": lambda: A.flash_dkv(*h),
            "flash_fwd_single_f16": lambda: A.flash_fwd_single(*h1[:3]),
            "flash_dqkv_f16": lambda: A.flash_dqkv(*h1),
        })
    # D = 256 (B*H = 128, S = 512) and the wide-head route at D = 512 (B*H
    # = 32, S = 512), each in bf16 and float32 beside SDPA in the same dtype.
    def sdpa_calls(name, args4, do4):
        g4 = [t.detach().requires_grad_() for t in args4]
        out = F.scaled_dot_product_attention(*g4)
        return {f"sdpa_fwd_{name}": lambda: F.scaled_dot_product_attention(
                    *args4),
                f"sdpa_bwd_{name}": lambda: torch.autograd.grad(
                    out, g4, do4, retain_graph=True)}

    # The float32 rows take full float32 values, which TF32 does not hold
    # exactly, and the bf16 rows those values rounded to bf16.
    for tag, BHw, Dw in (("d256", 128, 256), ("wide", 32, 512)):
        full = [torch.randn(BHw, S, Dw, generator=gen, device="cuda")
                for _ in range(4)]
        for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            a = [t.to(dt) for t in full]
            ow, lsew = A.flash_fwd_plain(*a[:3])
            deltaw = (a[3].float() * ow.float()).sum(-1)
            bw = (*a, lsew, deltaw, torch.zeros_like(deltaw), False, 0, 0)
            calls.update({
                f"flash_fwd_{tag}{sfx}": (lambda a=a: A.flash_fwd(*a[:3])),
                f"flash_dq_{tag}{sfx}": (lambda bw=bw: A.flash_dq(*bw)),
                f"flash_dkv_{tag}{sfx}": (lambda bw=bw: A.flash_dkv(*bw))})
            calls.update(sdpa_calls(
                f"d{Dw}{sfx}", [t.view(1, BHw, S, Dw) for t in a[:3]],
                a[3].view(1, BHw, S, Dw)))
    # The float32 instances at D = 64 (BERT-Large S = 512 and S = 128
    # shapes) beside SDPA in float32, on full float32 values.
    def full_f32(BHs, Ss, Ds=D):
        a = [torch.randn(BHs, Ss, Ds, generator=gen, device="cuda")
             for _ in range(4)]
        o_a, lse_a = A.flash_fwd_plain(*a[:3])
        return a, (*a, lse_a, (a[3] * o_a).sum(-1), torch.zeros_like(lse_a),
                   False, 0, 0)

    f32, b32 = full_f32(B * H, S)
    f32_1, b32_1 = full_f32(B1 * H, S1)
    calls.update({
        "flash_fwd_f32": lambda: A.flash_fwd(*f32[:3]),
        "flash_dq_f32": lambda: A.flash_dq(*b32),
        "flash_dkv_f32": lambda: A.flash_dkv(*b32),
        "flash_fwd_single_f32": lambda: A.flash_fwd_single(*f32_1[:3]),
        "flash_dqkv_f32": lambda: A.flash_dqkv(*b32_1),
        "flash_dq_dkv_s128_f32": lambda: (A.flash_dq(*b32_1),
                                          A.flash_dkv(*b32_1))})
    calls.update(sdpa_calls("f32", [t.view(B, H, S, D) for t in f32[:3]],
                            f32[3].view(B, H, S, D)))
    calls.update(sdpa_calls(
        "s128_f32", [t.view(B1, H, S1, D) for t in f32_1[:3]],
        f32_1[3].view(B1, H, S1, D)))
    # The fused backward at D = 128 (S = 128) beside SDPA's float32
    # backward there.
    f1d, b1d = full_f32(B1 * H, S1, 128)
    calls["flash_dqkv_d128_f32"] = lambda: A.flash_dqkv(*b1d)
    calls["plain_dqkv_d128_f32"] = lambda: A.flash_dqkv_plain(*b1d)
    calls["sdpa_bwd_s128_d128_f32"] = sdpa_calls(
        "s128_d128_f32", [t.view(B1, H, S1, 128) for t in f1d[:3]],
        f1d[3].view(B1, H, S1, 128))["sdpa_bwd_s128_d128_f32"]
    # The float32 dQ and dK/dV at D = 32 and 128, each beside SDPA's
    # float32 backward.
    for Dd in (32, 128):
        fd, bd = full_f32(B * H, S, Dd)
        calls.update({
            f"flash_dq_d{Dd}_f32": (lambda bd=bd: A.flash_dq(*bd)),
            f"flash_dkv_d{Dd}_f32": (lambda bd=bd: A.flash_dkv(*bd))})
        if Dd == 128:
            calls["plain_dq_dkv_d128_f32"] = lambda bd=bd: (
                A.flash_dq_plain(*bd), A.flash_dkv_plain(*bd))
        calls[f"sdpa_bwd_d{Dd}_f32"] = sdpa_calls(
            f"d{Dd}_f32", [t.view(B, H, S, Dd) for t in fd[:3]],
            fd[3].view(B, H, S, Dd))[f"sdpa_bwd_d{Dd}_f32"]
    # The float32 wide dQ and dK/dV at a long sequence (B*H = 2, S = 8192,
    # D = 512) beside SDPA's float32 backward.
    fl, bl = full_f32(2, 8192, 512)
    calls.update({
        "flash_dq_wide_long_f32": lambda: A.flash_dq(*bl),
        "flash_dkv_wide_long_f32": lambda: A.flash_dkv(*bl),
        "sdpa_bwd_d512_long_f32": sdpa_calls(
            "d512_long_f32", [t.view(1, 2, 8192, 512) for t in fl[:3]],
            fl[3].view(1, 2, 8192, 512))["sdpa_bwd_d512_long_f32"]})
    result = {name: {"spin_ms": smoke.time_ms(fn),
                     "no_spin_ms": smoke.time_ms(fn, sleep_cycles=0),
                     "device_ms": _device_ms(fn)}
              for name, fn in calls.items()}
    for name in PEAK_CALLS:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls[name]()
        torch.cuda.synchronize()
        result[name]["peak_mb"] = (torch.cuda.max_memory_allocated()
                                   - held) / 1e6
    # The kernels of SDPA's float32 backward at D = 256 and of its float32
    # forward at D = 256 and D = 64, by device time.
    sdpa_kernels = {}
    for call in SDPA_KERNELS:
        sdpa_kernels[call] = {}
        for n, us in _device_events(calls[call], 1):
            sdpa_kernels[call][n] = sdpa_kernels[call].get(n, 0.0) + us / 1e3
    print(json.dumps({"checkout": label, "path": tree,
                      "card": smoke.card_line(),
                      "sdpa_kernels": sdpa_kernels, **result}))


def ab(other):
    order = (("other", other), ("this", HERE), ("this", HERE),
             ("other", other))
    runs = {"other": [], "this": []}
    for label, tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_worker", tree,
             label],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"ab: the {label} checkout ({tree}) failed with exit code "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs[label].append(json.loads(line))
    for name in CALLS:
        for method in METHODS:
            o, t = (sum(r[name][method] for r in runs[label]) / 2
                    if all(name in r for r in runs[label]) else None
                    for label in ("other", "this"))
            if o is None or t is None:
                print(f"ab {name} {method}: other "
                      f"{'n/a' if o is None else f'{o:.4f} ms'}, this "
                      f"{'n/a' if t is None else f'{t:.4f} ms'}")
                continue
            print(f"ab {name} {method}: other {o:.4f} ms, this {t:.4f} ms, "
                  f"other / this {o / t:.2f}")
    for name in PEAK_CALLS:
        o, t = (sum(r[name]["peak_mb"] for r in runs[label]) / 2
                for label in ("other", "this"))
        print(f"ab {name} peak_mb: other {o:.1f} MB, this {t:.1f} MB")
    smoke = _smoke()
    def summed(bounds):  # kernels run one after the other
        return (sum(b[0] for b in bounds), "/".join(b[1] for b in bounds),
                sum(b[2] for b in bounds), sum(b[3] for b in bounds))

    for name, (kernels, BH, S, D) in F32_BOUNDS.items():
        kernels = kernels if isinstance(kernels, tuple) else (kernels,)
        ms, by, flops, moved = summed([smoke._bounds(
            k, BH, S, S, D, "float32", False, 0, 0) for k in kernels])
        line = (f"bound {name}: {ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
                f"{moved / 1e6:.1f} MB) at the FMA peak")
        if all(smoke._runs_3xtf32(k, D) for k in kernels):
            ms3, by3, flops3, _ = summed([smoke._bounds_3xtf32(
                k, BH, S, S, D, False, 0, 0) for k in kernels])
            line += (f"; {ms3:.4f} ms ({by3}: {flops3 / 1e9:.2f} GFLOP of "
                     "TF32) in 3xTF32, the bound the kernel is held to")
        print(line)
    for row, (_, N, Hc, Wc, ci, co, st) in zip(
            ("dw_1x1_stage1_f32", "dw_1x1_shortcut_f32"), smoke.CONV_SHAPES):
        K = N * -(-Hc // st[0]) * -(-Wc // st[1])
        (ms, by, flops, moved), fma = smoke._dw_bounds(K, ci, co, "float32")
        print(f"bound {row}: {ms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP of "
              f"TF32, {moved / 1e6:.1f} MB) in 3xTF32, the bound the kernel "
              f"is held to; {fma:.4f} ms at the FMA peak")
    for call, kernels in runs["this"][0]["sdpa_kernels"].items():
        print(f"{call} kernels (device ms of one call): "
              + "; ".join(f"{n} {ms:.4f}" for n, ms in
                          sorted(kernels.items(), key=lambda kv: -kv[1])))
    print(f"card: {runs['this'][0]['card']}")
    return 0


_PROBE = r"""
#include <stdio.h>

#include "sm90.cuh"

// One warp waits on phase 0 of an mbarrier that no thread arrives at.
__global__ void stuck_kernel() {
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) mbar_init(smem_u32(&bar), 1);
  __syncthreads();
  mbar_wait(smem_u32(&bar), 0);
}

int main() {
  stuck_kernel<<<1, 32>>>();
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaErrorIllegalAddress ? 0 : 1;
}
"""


def watchdog():
    sys.path.insert(0, HERE)
    from horovod_tpu_torch.ops import _kernels

    with open(os.path.join(_kernels.CSRC_DIR, "sm90.cuh")) as f:
        timeout_s = int(re.search(r"MBAR_TIMEOUT_NS = (\d+)",
                                  f.read()).group(1)) / 1e9
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(_kernels.BUILD_DIR, "mbar_watchdog_probe.cu")
    exe = src[: -len(".cu")]
    with open(src, "w") as f:
        f.write(_PROBE)
    subprocess.run([_kernels._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", _kernels.CSRC_DIR, "-o", exe, src],
                   check=True, timeout=300)
    t0 = time.perf_counter()
    proc = subprocess.run([exe], capture_output=True, text=True,
                          timeout=timeout_s + 60)
    seconds = time.perf_counter() - t0
    said = proc.stdout.strip()
    print(f"watchdog: a kernel waiting on an mbarrier phase that never "
          f"completes ended after {seconds:.2f} s (timeout {timeout_s} s) "
          f"with: {said}")
    if proc.returncode != 0 or seconds < timeout_s:
        print("watchdog: expected an illegal-address error after the "
              "timeout", file=sys.stderr)
        return 1
    return 0


def _collectives_rank(device):
    """One rank of ``collectives``, started by the launcher (its world
    facts and rendezvous in the env): raises AssertionError on a result
    that differs from the numpy reference; prints how many it held."""
    import faulthandler

    import numpy as np
    import torch

    # A rank stuck in a collective prints its stack and exits, so a hang
    # ends the check with the culprit named instead of at the call's limit.
    faulthandler.dump_traceback_later(240, exit=True)
    sys.path.insert(0, HERE)
    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(7)
    x = rng.randn(n, 4 * n, 3)
    p = 1.0 + 0.1 * rng.randn(n, 4 * n, 3)
    y = rng.randn(n, 2 * (n - 1), 2)  # dim 0 divisible by 2 and n - 1
    ragged = [rng.randn(r + 1, 5) for r in range(n)]
    table = rng.randint(0, 4, size=(n, n))
    table[0, 1] = 0  # an empty chunk, whatever the draw
    v = [rng.randn(int(table[r].sum()), 2) for r in range(n)]
    held = []

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def hold(name, got, want):
        got = got.detach().cpu().double().numpy()
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=1e-5,
                                                      atol=1e-5):
            raise AssertionError(f"rank {rank} {name}: got {got.shape} "
                                 f"{got.ravel()[:4]}, want {want.shape} "
                                 f"{want.ravel()[:4]}")
        held.append(name)

    def refused(name, call, needle):
        try:
            call()
        except ValueError as e:
            if needle not in str(e):
                raise
            held.append(name)
        else:
            raise AssertionError(f"rank {rank} {name}: no ValueError")

    reduced = {"sum": x.sum(0), "average": x.mean(0), "min": x.min(0),
               "max": x.max(0), "product": p.prod(0)}
    mine = slice(4 * rank, 4 * rank + 4)
    for op, want in reduced.items():
        src = p if op == "product" else x
        hold(f"allreduce {op}", hvd.allreduce(t(src[rank]), op=op), want)
        hold(f"reducescatter {op}", hvd.reducescatter(t(src[rank]), op=op),
             want[mine])
    hold("alltoall", hvd.alltoall(t(x[rank])),
         np.concatenate([x[j][mine] for j in range(n)]))
    offsets = np.concatenate([np.zeros((n, 1), int), table.cumsum(1)], 1)
    sent_to_me = np.concatenate([v[j][offsets[j, rank]:offsets[j, rank + 1]]
                                 for j in range(n)])
    out, received = hvd.alltoall(t(v[rank]), splits=table)
    hold("alltoall splits", out, sent_to_me)
    hold("alltoall received splits", received, table[:, rank])
    hold("allgather ragged", hvd.allgather(t(ragged[rank])),
         np.concatenate(ragged))
    hold("broadcast", hvd.broadcast(t(x[rank]), root_rank=n - 1), x[n - 1])
    for i, got in enumerate(hvd.grouped_reducescatter(
            [t(x[rank]), t(p[rank])], op=hvd.Sum)):
        hold(f"grouped_reducescatter {i}", got, (x, p)[i].sum(0)[mine])

    inplace = t(x[rank])
    handles = [hvd.allreduce_async_(inplace, op=hvd.Sum),
               hvd.alltoall_async(t(v[rank]), splits=table),
               hvd.reducescatter_async(t(x[rank])),
               hvd.grouped_allgather_async([t(ragged[rank]), t(y[rank])])]
    deadline = time.monotonic() + 120
    while not all(hvd.poll(h) for h in handles):
        if time.monotonic() > deadline:
            raise AssertionError(f"rank {rank}: poll never saw the async "
                                 "ops complete")
    got = [hvd.synchronize(h) for h in handles]
    if got[0] is not inplace:
        raise AssertionError(f"rank {rank}: allreduce_async_ not in place")
    hold("allreduce_async_", got[0], reduced["sum"])
    hold("alltoall_async splits", got[1][0], sent_to_me)
    hold("reducescatter_async", got[2], reduced["average"][mine])
    hold("grouped_allgather_async 0", got[3][0], np.concatenate(ragged))
    hold("grouped_allgather_async 1", got[3][1], np.concatenate(list(y)))

    subsets = ([0, 1], list(range(1, n)))
    sets = [hvd.add_process_set(s) for s in subsets]
    for s, ps in zip(subsets, sets):
        if rank not in s:
            refused(f"non-member {s}", lambda: hvd.allreduce(
                t(y[rank]), process_set=ps), "is not a member")
            continue
        i, k = s.index(rank), len(s)
        part = slice(i * y.shape[1] // k, (i + 1) * y.shape[1] // k)
        hold(f"allreduce {s}", hvd.allreduce(t(y[rank]), op=hvd.Sum,
                                             process_set=ps), y[s].sum(0))
        hold(f"reducescatter {s}", hvd.reducescatter(
            t(y[rank]), op=hvd.Sum, process_set=ps), y[s].sum(0)[part])
        hold(f"alltoall {s}", hvd.alltoall(t(y[rank]), process_set=ps),
             np.concatenate([y[j][part] for j in s]))
        hold(f"broadcast {s}", hvd.broadcast(t(y[rank]), root_rank=s[-1],
                                             process_set=ps), y[s[-1]])
        if hvd.allgather_object({"r": rank}, process_set=ps) != [
                {"r": j} for j in s]:
            raise AssertionError(f"rank {rank}: allgather_object on {s}")
    _adasum_and_syncbn(hvd, rank, n, sets[1], hold)
    if not hvd.remove_process_set(sets[0]):
        raise AssertionError(f"rank {rank}: remove_process_set")
    mask = np.array([float(r != 1) for r in range(n)])
    hold("masked_average", hvd.masked_average(t(y[rank]), mask[rank]),
         (y * mask[:, None, None]).sum(0) / mask.sum())
    if hvd.allgather_object(rank) != list(range(n)):
        raise AssertionError(f"rank {rank}: allgather_object")
    hvd.barrier()
    print(f"rank {rank}: {len(held)} results held to the numpy reference "
          f"over {dist_backend(device)}", flush=True)
    _adasum_trajectory(hvd, rank, n, device)
    _sync_mode_trajectories(hvd, rank, n, device)
    hvd.shutdown()


# SyncBatchNorm across ranks: images per rank (the last rank one fewer), and
# channels and spatial size of each image.
SYNCBN_IMAGES, SYNCBN_SHAPE = 32, (16, 8, 8)


def _same_on_every_rank(hvd, name, t, process_set=None):
    """``t`` (one member's copy of a replicated result) equals every other
    member's bit for bit."""
    import torch

    rows = hvd.allgather(t.detach().reshape(1, -1), process_set=process_set)
    if not all(torch.equal(row, rows[0]) for row in rows):
        raise AssertionError(f"rank {hvd.rank()} {name}: the ranks' results "
                             "differ")


def _adasum_and_syncbn(hvd, rank, n, tail, hold):
    """Adasum over the world and over ``tail`` (the set {1, ..., n-1}) held
    to the float64 tree; SyncBatchNorm over uneven batches held to one
    card's BatchNorm over the whole batch."""
    import numpy as np
    import torch

    dev = hvd.device()
    rng = np.random.RandomState(11)
    shared = rng.randn(257, 33)
    members = [(r + 1) * (0.7 * shared + rng.randn(257, 33))
               for r in range(n)]
    members[1][:] = 0.0
    members = [m.astype(np.float32) for m in members]
    for name, ps, ranks in (("world", None, list(range(n))),
                            (f"set {tail.ranks}", tail, tail.ranks)):
        if rank not in ranks:
            continue
        want = _smoke().adasum_tree_np([members[r].astype(np.float64)
                                        for r in ranks])
        got = hvd.allreduce(torch.from_numpy(members[rank]).to(dev),
                            op=hvd.Adasum, process_set=ps)
        hold(f"adasum {name}", got, want)
        _same_on_every_rank(hvd, f"adasum {name}", got, ps)

    sizes = [SYNCBN_IMAGES] * (n - 1) + [SYNCBN_IMAGES - 1]
    first = sum(sizes[:rank])
    mine = slice(first, first + sizes[rank])
    x = torch.from_numpy(rng.randn(sum(sizes), *SYNCBN_SHAPE).astype(
        np.float32) * 2 + 0.5).to(dev)
    g = torch.from_numpy(rng.randn(sum(sizes), *SYNCBN_SHAPE).astype(
        np.float32)).to(dev)
    c = SYNCBN_SHAPE[0]
    results = []
    for bn in (hvd.SyncBatchNorm(c), torch.nn.BatchNorm2d(c)):
        bn.to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-0.5, 0.5, c))
        xi = (x[mine] if isinstance(bn, hvd.SyncBatchNorm) else x).clone()
        xi.requires_grad_()
        y = bn(xi)
        y.backward(g[mine] if isinstance(bn, hvd.SyncBatchNorm) else g)
        results.append((y, xi.grad, bn.weight.grad, bn.bias.grad,
                        bn.running_mean, bn.running_var))
    (y, dx, dw, db, mean, var), (y1, dx1, dw1, db1, mean1, var1) = results
    hold("syncbn y", y, y1[mine].detach().cpu().numpy())
    hold("syncbn dx", dx, dx1[mine].cpu().numpy())
    for name, local, whole in (("dweight", dw, dw1), ("dbias", db, db1)):
        total = hvd.allreduce(local, op=hvd.Sum)
        if not torch.allclose(total, whole, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"rank {rank} syncbn {name}: "
                                 f"{(total - whole).abs().max().item()}")
    hold("syncbn running mean", mean, mean1.cpu().numpy())
    hold("syncbn running var", var, var1.cpu().numpy())
    for name, t in (("running mean", mean), ("running var", var)):
        _same_on_every_rank(hvd, f"syncbn {name}", t)


def _rank_bert(hvd, rank, device):
    """BERT-Large's configuration (``--cpu``: BERT_TINY), dropout off, and
    this rank's own masked-LM batch: 8 sequences of 128 tokens, 20
    predictions each."""
    import dataclasses

    import numpy as np
    import torch

    from horovod_tpu_torch.models import bert as bert_mod

    base = bert_mod.BERT_LARGE if device == "cuda" else bert_mod.BERT_TINY
    cfg = dataclasses.replace(base, dropout_rate=0.0)
    dev = hvd.device()
    rng = np.random.RandomState(100 + rank)
    B, S, P = 8, 128, 20
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    pos = torch.from_numpy(np.stack([rng.choice(S, P, replace=False)
                                     for _ in range(B)])).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, P))).to(dev)
    mask = torch.ones(B, P, dtype=torch.int64, device=dev)
    return cfg, (ids, pos, labels, mask)


def _mlm_loss(model, batch):
    from horovod_tpu_torch.models import bert as bert_mod

    _, logits = model(batch[0], masked_positions=batch[1])
    return bert_mod.mlm_loss(logits, batch[2], batch[3])


def _adasum_pair64(a, b):
    """The Adasum rule on two flat float64 tensors (``adasum_pair_np`` of
    chip_smoke.py, on the device)."""
    dot, asq, bsq = float(a @ b), float(a @ a), float(b @ b)
    a_scale = 1.0 - dot / (2.0 * asq) if asq > 0 else 0.0
    b_scale = 1.0 - dot / (2.0 * bsq) if bsq > 0 else 0.0
    return a_scale * a + b_scale * b


# The Adasum optimizer's run: its AdamW steps.
ADASUM_OPT_STEPS = 3


def _adasum_trajectory(hvd, rank, n, device):
    """BERT-Large (``--cpu``: BERT_TINY) at S = 128, each rank on its own
    batch, ``ADASUM_OPT_STEPS`` AdamW steps under
    ``DistributedOptimizer(op=Adasum)`` on the bf16 wire (its per-bucket
    all_gather, then the tree per leaf). At each step every reduced
    gradient is held to the float64 tree over the ranks' bf16-wire
    gradients (gathered here on their own), within chip_smoke.py's bf16
    ``ADASUM_TOL`` of the leaf's largest value; each rank's loss falls; the
    parameters end the same bit for bit on every rank. On the card, rank 0
    prints the last step's wire device ms (its collectives) and the device
    busy ms of the tree over the same gathered gradients."""
    import torch

    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops.adasum import adasum_tree

    smoke = _smoke()
    cuda = device == "cuda"
    cfg, batch = _rank_bert(hvd, rank, device)
    torch.manual_seed(0)
    with torch.device(hvd.device()):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=MODE_LR, weight_decay=1e-4),
        compression=hvd.Compression.bf16, op=hvd.Adasum)
    tol = smoke.ADASUM_TOL["bfloat16"]
    losses, worst, wire_ms, wire_ops = [], 0.0, None, None
    for i in range(ADASUM_OPT_STEPS):
        last = cuda and i == ADASUM_OPT_STEPS - 1
        with (smoke.device_profile() if last
              else contextlib.nullcontext()) as prof:
            opt.zero_grad(set_to_none=True)
            loss = _mlm_loss(model, batch)
            loss.backward()
            # The bf16 wire's values of this rank's gradients, as the hooks
            # gathered them (the optimizer leaves .grad alone until step()).
            wire = torch.cat([p.grad.reshape(-1).to(torch.bfloat16)
                              for p in params])
            opt.step()
        if last:
            wire_ms, wire_ops = smoke._collective_device_ms(prof)
        losses.append(loss.item())
        rows = hvd.allgather(wire.reshape(1, -1))
        offset, leaves = 0, []
        for p in params:
            views = rows[:, offset:offset + p.numel()]
            offset += p.numel()
            leaves.append(views.unbind(0))
            want = smoke.adasum_tree_np([v.double() for v in views],
                                        _adasum_pair64)
            err = (p.grad.reshape(-1).double() - want).abs().max().item()
            scale = want.abs().max().item()
            if not err <= tol * scale:
                raise AssertionError(
                    f"rank {rank} adasum optimizer step {i}: a {tuple(p.shape)}"
                    f" gradient is {err:.3e} from the float64 tree (limit "
                    f"{tol} x {scale:.3e})")
            worst = max(worst, err / scale if scale else 0.0)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rank {rank} adasum optimizer: losses {losses}")
    _same_on_every_rank(hvd, "adasum optimizer parameters",
                        torch.cat([p.detach().reshape(-1) for p in params]))
    print(f"rank {rank}: DistributedOptimizer(op=Adasum) over {n} ranks, "
          f"{cfg.num_layers} layers x {cfg.hidden_size}, S=128 x 8 per rank, "
          f"bf16 wire, {len(params)} leaves: {ADASUM_OPT_STEPS} AdamW steps, "
          f"losses {[round(x, 4) for x in losses]}, every reduced gradient "
          f"within {worst:.3e} x its largest value of the float64 tree "
          f"(limit {tol}), parameters the same bit for bit on every rank",
          flush=True)
    if cuda and rank == 0:
        with smoke.device_profile() as prof:
            for views in leaves:
                adasum_tree(views)
        tree = smoke._busy_us([(a, b) for _, a, b in
                               smoke.device_events(prof)]) / 1e3
        print(f"rank 0: Adasum optimizer step over {n} ranks: wire device "
              f"ms {wire_ms:.3f} ({wire_ops}); the tree over the "
              f"{len(leaves)} leaves' gathered rows, device busy {tree:.3f} "
              f"ms, on {smoke.card_line()}", flush=True)
    opt.remove_hooks()
    del model, opt, rows, leaves
    if cuda:
        torch.cuda.empty_cache()


# The sync modes across ranks: steps per run, AdamW's learning rate, and
# the int8 runs' bound on a loss (the float32-wire runs take chip_smoke.py's
# MODE_GAP_BOUND and MODE_LOSS_RTOL).
MODE_STEPS, MODE_LR = 3, 1e-4
INT8_LOSS_RTOL = 2e-2


def _sync_mode_trajectories(hvd, rank, n, device):
    """BERT-Large (BERT_TINY with --cpu) at S = 128, 8 sequences per rank,
    from the same weights under allreduce, sharded and fsdp: with SGD and
    momentum on the float32 wire, each mode's parameters and losses held to
    the allreduce run's by ``chip_smoke._hold_mode``, beside the control
    that must fail it; with AdamW on the float32 and the int8 wire, the
    losses, and per rank the optimizer-state bytes, the fsdp resident
    parameter bytes, the step time and the peak memory over the steps
    (above what the rank held before the run)."""
    import statistics

    import numpy as np
    import torch

    from horovod_tpu_torch.models import bert as bert_mod

    cuda = device == "cuda"
    cfg, (ids, pos, labels, mask) = _rank_bert(hvd, rank, device)
    dev = hvd.device()
    loss_fn = _mlm_loss
    S, B = ids.shape[1], ids.shape[0]

    smoke = _smoke()
    initial = []

    def run(mode, comp, prepare=None, sgd=False):
        held = torch.cuda.memory_allocated() if cuda else 0
        torch.manual_seed(0)
        with torch.device(dev):
            model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
        if not initial:
            initial.extend(p.detach().clone() for p in model.parameters())
        total = sum(p.numel() * p.element_size() for p in model.parameters())
        inner = (torch.optim.SGD(model.parameters(), lr=smoke.MODE_SGD_LR,
                                 momentum=smoke.MODE_SGD_MOMENTUM) if sgd
                 else torch.optim.AdamW(model.parameters(), lr=MODE_LR,
                                        weight_decay=1e-4))
        opt = hvd.DistributedOptimizer(
            inner, compression=getattr(hvd.Compression, comp),
            sync_mode=mode)
        step = hvd.make_train_step(model, loss_fn, opt)
        if prepare is not None:
            prepare(model, opt, step)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(MODE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step((ids, pos, labels, mask))))
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = ((torch.cuda.max_memory_allocated() - held) / 2**30 if cuda
                else None)
        params = (opt.full_parameters() if mode == "fsdp"
                  else [p.detach().clone() for p in model.parameters()])
        state = sum(v.numel() * v.element_size() for st in opt.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.dim())
        facts = dict(
            step_ms=statistics.median(times[1:]), state_bytes=state,
            total_param_bytes=total,
            peak_gib=peak,
            resident_param_bytes=(hvd.resident_param_bytes(opt)
                                  if mode == "fsdp" else total))
        opt.remove_hooks()
        del model, opt, step
        if cuda:
            torch.cuda.empty_cache()
        return losses, params, facts

    ref_losses, ref, _ = run("allreduce", "none", sgd=True)
    report = {}
    for mode in ("sharded", "fsdp"):
        losses, params, _ = run(mode, "none", sgd=True)
        gap, _, largest = smoke._hold_mode(f"rank {rank} {mode} sgd", params,
                                           losses, ref, ref_losses, initial)
        report[f"{mode}/sgd"] = dict(gap=gap, largest_difference=largest)
    losses, params, _ = run("sharded", "none", sgd=True,
                            prepare=smoke._drop_a_bucket)
    try:
        smoke._hold_mode(f"rank {rank} control", params, losses, ref,
                         ref_losses, initial)
    except AssertionError as e:
        report["control"] = str(e)
    else:
        raise AssertionError(f"rank {rank}: a sharded run that drops a "
                             "bucket's gradients passed the check")
    del params, ref
    ref_losses, params, report["allreduce/none"] = run("allreduce", "none")
    del params
    for mode, comp in (("sharded", "none"), ("fsdp", "none"),
                       ("allreduce", "int8"), ("sharded", "int8"),
                       ("fsdp", "int8")):
        losses, params, facts = run(mode, comp)
        report[f"{mode}/{comp}"] = facts
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"rank {rank} {mode}/{comp}: losses "
                                 f"{losses}")
        rtol = INT8_LOSS_RTOL if comp == "int8" else smoke.MODE_LOSS_RTOL
        if not all(abs(a - b) <= rtol * abs(b)
                   for a, b in zip(losses, ref_losses)):
            raise AssertionError(f"rank {rank} {mode}/{comp}: losses "
                                 f"{losses} vs allreduce {ref_losses}")
        if mode != "allreduce" and comp == "none" and not (
                facts["state_bytes"] <= report["allreduce/none"]
                ["state_bytes"] / n + 8 * 1024 * 1024):
            raise AssertionError(f"rank {rank} {mode}: optimizer state "
                                 f"{facts['state_bytes']} bytes is not about "
                                 f"1/{n} of the whole")
        del params
    print(f"rank {rank}: sync modes over {n} ranks, {cfg.num_layers} layers "
          f"x {cfg.hidden_size}, S={S} x {B} per rank, {MODE_STEPS} steps "
          "a run: the SGD runs' parameters and losses and the AdamW runs' "
          "losses held to the allreduce run's; "
          f"per rank {json.dumps(report)}", flush=True)


# The comms microprobe's payloads a rank: 4 KB to 256 MB, by fours.
COMMS_PROBE_SIZES = tuple(4 ** k for k in range(6, 15))


def _comms_rank(device):
    """One rank of ``comms``, started by the launcher: the microprobe, this
    rank's fits, and on rank 0 the merge of every rank's payload."""
    import faulthandler

    faulthandler.dump_traceback_later(600, exit=True)
    sys.path.insert(0, HERE)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, comms_model

    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    link = basics._state.topology.set_link_class(range(n))
    t0 = time.perf_counter()
    probe = hvd.run_comms_microprobe(sizes=COMMS_PROBE_SIZES, repeats=3)
    seconds = time.perf_counter() - t0
    # Each timed call's microseconds, by op and the world's payload.
    print("comms samples " + json.dumps(dict(rank=rank, us={
        op: {nbytes: [round(x * 1e6, 1) for x in xs]
             for nbytes, xs in per_op.items()}
        for op, per_op in probe.items()})), flush=True)
    payload = comms_model.get_model().payload()
    fits = {key.split("|")[0]: {k: fit.get(k) for k in (
        "alpha_s", "beta_s_per_byte", "bandwidth_bytes_per_second",
        "alpha_ci95_s", "beta_ci95", "r2", "samples", "ready")}
        for key, fit in payload["fits"].items()
        if key.endswith(f"|flat|{link}")}
    unfitted = [op for op in ("allreduce", "reducescatter", "allgather",
                              "alltoall") if not fits.get(op, {}).get("ready")]
    print("comms rank " + json.dumps(dict(
        rank=rank, world=n, link_class=link, probe_s=round(seconds, 3),
        fits=fits)), flush=True)
    payloads = hvd.allgather_object(payload)
    if rank == 0:
        # What the memory plane's span-close hook costs on the host.
        from horovod_tpu_torch import memory

        costs = {}
        for name, fn in (("device_memory_stats", memory.device_memory_stats),
                         ("note_phase", lambda: memory.note_phase("other"))):
            fn()
            t1 = time.perf_counter()
            for _ in range(1000):
                fn()
            costs[name] = round((time.perf_counter() - t1) * 1e3, 3)
        print(f"comms: host us per call {costs}", flush=True)
        merged = comms_model.merge_payloads(
            {f"rank{r}": p for r, p in enumerate(payloads)})
        print("comms merged " + json.dumps(merged), flush=True)
        if device == "cuda":
            print(f"comms: cards {_smoke().card_line()}", flush=True)
    hvd.shutdown()
    if unfitted:
        raise AssertionError(f"rank {rank}: no ready fit of {unfitted}")


def comms(cpu):
    import torch

    n = 4 if cpu else torch.cuda.device_count()
    device = "cpu" if cpu else "cuda"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), *(["--cpu-mode"] if cpu else []), sys.executable,
         os.path.abspath(__file__), "_comms_rank", device],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), timeout=900)
    print(f"comms: {n} ranks over {dist_backend(device)} started by "
          f"hvdrun-torch, exit code {out.returncode}, "
          f"{time.perf_counter() - t0:.1f} s")
    return out.returncode


# The planner diagnostic's fabric: two islands of two ranks each, declared
# on one host of four cards (their "cross" leg is NVLink, fitted under the
# inter_host name).
PLANNER_MAP = "0-1;2-3"
PLANNER_ALGORITHMS = ("flat", "rhd", "two_level")
# Steps of each run of the int8 wire, and of the busy profile of each
# autotune candidate (after one settle call).
PLANNER_INT8_STEPS = 3
PLANNER_BUSY_STEPS = 2


def _planner_batch(hvd, rank, device):
    """BERT-Large (``--cpu``: BERT_TINY) and this rank's S = 512 (128)
    masked-LM batch of 8 (4) sequences, 20 predictions each."""
    import dataclasses

    import numpy as np
    import torch

    from horovod_tpu_torch.models import bert as bert_mod

    cuda = device == "cuda"
    base = bert_mod.BERT_LARGE if cuda else bert_mod.BERT_TINY
    cfg = dataclasses.replace(base, dropout_rate=0.0)
    B, S, P = (8, 512, 20) if cuda else (4, 128, 20)
    dev = hvd.device()
    rng = np.random.RandomState(200 + rank)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    pos = torch.from_numpy(np.stack([rng.choice(S, P, replace=False)
                                     for _ in range(B)])).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, P))).to(dev)
    mask = torch.ones(B, P, dtype=torch.int64, device=dev)
    return cfg, (ids, pos, labels, mask)


def _planner_schedules(hvd, rank, n, device):
    """Each op under each eligible schedule on integer-valued float32
    payloads (exact) and on random ones: every result equal to flat's
    bit for bit on integers, and the largest relative gap on randoms."""
    import torch

    from horovod_tpu_torch.ops import comms_planner as cp

    g = torch.Generator().manual_seed(300 + rank)
    dev = hvd.device()
    payloads = {
        "int": torch.randint(-8, 9, (n * 4099,), generator=g).float().to(
            dev),
        "rnd": torch.randn(n * 4099, generator=g).to(dev)}
    ops = {
        "allreduce": lambda x: hvd.allreduce(x, op=hvd.Sum),
        "reducescatter": lambda x: hvd.reducescatter(x, op=hvd.Sum),
        "allgather": lambda x: hvd.allgather(x),
        "alltoall": lambda x: hvd.alltoall(x),
    }
    out = {}
    islands = cp._islands_for(n)
    for op, run in ops.items():
        for kind, x in payloads.items():
            with cp.forced("flat"):
                flat = run(x)
            for algo in cp.eligible_algorithms(op, n, islands):
                with cp.forced(algo):
                    got = run(x)
                if kind == "int":
                    if not torch.equal(got, flat):
                        raise AssertionError(
                            f"rank {rank}: {op} under {algo} differs from "
                            f"flat on integer-valued payloads")
                    out[f"{op}|{algo}|int"] = "equal"
                else:
                    gap = ((got - flat).abs().max()
                           / flat.abs().max()).item()
                    out[f"{op}|{algo}|rnd"] = float(f"{gap:.3g}")
    return out


def _busy_ms(smoke, hvd, step, batch):
    """Device busy per step over ``PLANNER_BUSY_STEPS`` steps (one settle
    call first), from the profiler. The ranks line up inside the session
    first (an allreduce and a stream sync), and only device work that
    starts after that counts: a rank's first NCCL kernel would otherwise
    count the time the others took to open their sessions."""
    import torch

    float(step(batch))
    with smoke.device_profile() as prof:
        hvd.allreduce(torch.zeros(1, device=hvd.device()), op=hvd.Sum)
        torch.cuda.synchronize()
        with torch.profiler.record_function("planner_busy_window"):
            for _ in range(PLANNER_BUSY_STEPS):
                step(batch)
    start = min(e.time_range.start for e in prof.events()
                if e.name == "planner_busy_window")
    spans = [(a, b) for _, a, b in smoke.device_events(prof) if a >= start]
    return round(smoke._busy_us(spans) / 1e3 / PLANNER_BUSY_STEPS, 3)


def _planner_rank(device):
    """One rank of ``planner``, started by the launcher under
    ``HOROVOD_COMMS_PLANNER=auto`` and ``HOROVOD_LINK_CLASS_MAP``."""
    import faulthandler

    faulthandler.dump_traceback_later(1200, exit=True)
    sys.path.insert(0, HERE)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import autotune, basics, comms_model
    from horovod_tpu_torch.ops import collective_ops
    from horovod_tpu_torch.ops import comms_planner as cp

    cuda = device == "cuda"
    if cuda:
        from horovod_tpu_torch.utils.spin import Spin

        torch.cuda.set_device(int(os.environ.get("HOROVOD_LOCAL_RANK", 0)))
        first = Spin(20_000_000)
        first_spin = [round(first.ms(), 3), round(first.least_ms(), 3),
                      first.short()]
    else:
        first_spin = None
    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    smoke = _smoke()

    def say(tag, obj):
        print(f"planner {tag} " + json.dumps(dict(rank=rank, **obj)),
              flush=True)

    islands = cp._islands_for(n)
    link = basics._state.topology.set_link_class(range(n))
    say("world", dict(world=n, islands=islands, link_class=link,
                      first_spin_ms=first_spin))
    # 1. The per-algorithm microprobe, each sample the model takes, and the
    # fits.
    samples = {}
    observe = comms_model.observe

    def keep(op, algorithm, link_class, nbytes, seconds):
        samples.setdefault(f"{op}|{algorithm}", {}).setdefault(
            int(nbytes), []).append(round(seconds * 1e6, 1))
        return observe(op, algorithm, link_class, nbytes, seconds)

    comms_model.observe = keep
    t0 = time.perf_counter()
    hvd.run_comms_microprobe(
        sizes=COMMS_PROBE_SIZES if cuda else COMMS_PROBE_SIZES[:4],
        repeats=3)
    fits = {key: {k: fit.get(k) for k in (
        "alpha_s", "beta_s_per_byte", "bandwidth_bytes_per_second", "r2",
        "samples", "ready")}
        for key, fit in comms_model.get_model().payload()["fits"].items()
        if key.split("|")[1] in PLANNER_ALGORITHMS}
    comms_model.observe = observe
    say("fits", dict(probe_s=round(time.perf_counter() - t0, 2), fits=fits,
                     short_spins=collective_ops.probe_short_spins))
    if rank == 0:
        say("samples_us", dict(samples=samples))
    # 2. Each schedule's result beside flat's.
    say("schedules", dict(results=_planner_schedules(hvd, rank, n, device)))
    # 3. The plans of BERT-Large's buckets (the bf16 wire, 64 MiB).
    cfg, batch = _planner_batch(hvd, rank, device)
    from horovod_tpu_torch.models import bert as bert_mod

    torch.manual_seed(0)
    with torch.device(hvd.device()):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    def optimizer(**kw):
        return hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(), **kw)

    opt = optimizer(compression=hvd.Compression.bf16)
    plans = [(sum(p.numel() * 2 for p in b), cp.plan_bucket(
        "allreduce", sum(p.numel() * 2 for p in b), n)) for b in opt._buckets]
    plans = [(nb, p.algorithm, p.provenance) for nb, p in plans]
    opt.remove_hooks()
    every = hvd.allgather_object(plans)
    if any(p != plans for p in every):
        raise AssertionError(f"ranks planned differently: {every}")
    say("plans", dict(buckets=len(plans), plans=plans,
                      describe=basics._state.topology.describe()))
    # 4. The joint (threshold x algorithm) warmup under HOROVOD_AUTOTUNE=1.
    os.environ["HOROVOD_AUTOTUNE"] = "1"
    autotune.reset_for_testing()
    model.load_state_dict(initial)
    opt = optimizer(compression=hvd.Compression.bf16)
    step = hvd.make_train_step(model, _mlm_loss, opt)
    grid = list(step._fn._cands)
    t0 = time.perf_counter()
    losses = [float(step(batch)) for _ in range(len(grid) * 4 + 2)]
    os.environ.pop("HOROVOD_AUTOTUNE")
    state = autotune.autotune_state()
    decision = (autotune.tuned_threshold(), autotune.tuned_algorithm())
    every = hvd.allgather_object(decision)
    if any(d != decision for d in every):
        raise AssertionError(f"ranks pinned differently: {every}")
    say("autotune", dict(grid=grid, samples=state["history"],
                         decision=decision, losses=losses[-3:],
                         seconds=round(time.perf_counter() - t0, 2)))
    busy = {}
    if cuda:
        for threshold, algorithm in grid:
            autotune.set_tuned_threshold(threshold)
            autotune.set_tuned_algorithm(algorithm)
            step.rebucket()
            busy[f"{threshold}|{algorithm}"] = _busy_ms(smoke, hvd, step,
                                                        batch)
        autotune.set_tuned_threshold(decision[0])
        autotune.set_tuned_algorithm(decision[1])
        step.rebucket()
    say("busy", dict(busy_ms_per_step=busy))
    opt.remove_hooks()
    autotune.reset_for_testing()
    # 5. The int8 wire, flat and two-level, from the same weights.
    int8 = {}
    for algo in ("flat", "two_level"):
        model.load_state_dict(initial)
        opt = optimizer(compression=hvd.Compression.int8)
        step = hvd.make_train_step(model, _mlm_loss, opt)
        with cp.forced(algo):
            t0 = time.perf_counter()
            losses = [float(step(batch)) for _ in range(PLANNER_INT8_STEPS)]
            ms = (time.perf_counter() - t0) / PLANNER_INT8_STEPS * 1e3
            int8[algo] = dict(losses=losses, host_ms=round(ms, 2),
                              busy_ms=_busy_ms(smoke, hvd, step, batch)
                              if cuda else None)
        opt.remove_hooks()
    gap = max(abs(a - b) for a, b in zip(int8["flat"]["losses"],
                                         int8["two_level"]["losses"]))
    say("int8", dict(runs=int8, loss_gap=gap))
    # 6. The sync-mode sweep: each mode's optimizer and step built anew.
    made = []

    def build(mode):
        for o in made:
            o.remove_hooks()
        made.clear()
        torch.manual_seed(0)
        with torch.device(hvd.device()):
            m = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
        o = hvd.DistributedOptimizer(
            torch.optim.AdamW(m.parameters(), lr=1e-4),
            compression=hvd.Compression.bf16, sync_mode=mode)
        made.append(o)
        s = hvd.make_train_step(m, _mlm_loss, o)
        return lambda: s(batch)

    del model, initial
    t0 = time.perf_counter()
    mode = autotune.tune_step_sync_mode(build)
    every = hvd.allgather_object(mode)
    if any(m != mode for m in every):
        raise AssertionError(f"ranks pinned sync modes {every}")
    say("sync_mode", dict(pinned=mode,
                          seconds=round(time.perf_counter() - t0, 2)))
    for o in made:
        o.remove_hooks()
    if rank == 0 and cuda:
        print(f"planner: cards {smoke.card_line()}", flush=True)
    hvd.shutdown()


def planner(cpu):
    import torch

    n = 4 if cpu else torch.cuda.device_count()
    if n != 4:
        print("planner: needs four cards (or --cpu)", file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), *(["--cpu-mode"] if cpu else []), sys.executable,
         os.path.abspath(__file__), "_planner_rank", device],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE,
                           HOROVOD_COMMS_PLANNER="auto",
                           HOROVOD_LINK_CLASS_MAP=PLANNER_MAP),
        timeout=1500)
    print(f"planner: {n} ranks over {dist_backend(device)} started by "
          f"hvdrun-torch under HOROVOD_COMMS_PLANNER=auto, "
          f"HOROVOD_LINK_CLASS_MAP={PLANNER_MAP}, exit code "
          f"{out.returncode}, {time.perf_counter() - t0:.1f} s")
    return out.returncode


# The negotiation diagnostic: BERT-Large's gradient leaves (--cpu:
# BERT_TINY's) through the negotiated runtime on four ranks.
NEG_STALL_CHECK_S = 2.0
# How long rank 2 holds back the leaf it skipped, and its stall watch.
NEG_STALL_HOLD_S = 3 * NEG_STALL_CHECK_S
NEG_CACHE_CAPACITY = 64
NEG_JOIN_STEPS = 3


def _neg_payload(rank, i, n=8):
    """An integer payload: rank- and leaf-dependent, exact under Sum."""
    import torch

    return (torch.arange(n, dtype=torch.int64) * 1000003 + 7919 * i
            + 104729 * rank)


def _neg_allreduce_leaves(world, grads, ints, prefix, reverse=False,
                          skip=None, hold_s=0.0):
    """Every leaf's gradient (Average, in place on a copy) and integer
    payload (Sum) as named async allreduces, in leaf order or reversed;
    ``skip`` (a leaf index) is enqueued ``hold_s`` after the others.
    Returns the results in leaf order."""
    names = list(grads)
    order = list(range(len(names)))
    if reverse:
        order.reverse()
    handles = {}

    def enqueue(i):
        name = names[i]
        handles[i] = (
            world.allreduce_async_(grads[name].clone(),
                                   name=f"{prefix}.{name}", op="average"),
            world.allreduce_async_(ints[i].clone(),
                                   name=f"{prefix}.int.{i}", op="sum"))

    for i in order:
        if i != skip:
            enqueue(i)
    if skip is not None:
        time.sleep(hold_s)
        enqueue(skip)
    return [(world.synchronize(handles[i][0]),
             world.synchronize(handles[i][1])) for i in range(len(names))]


def _neg_reform(hvd, env):
    """A new negotiated world over this world's ranks under ``env`` (read
    at its formation); the old one is shut down first."""
    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.runner.network import free_port
    from horovod_tpu_torch.runtime import NativeWorld

    basics._state.negotiated.shutdown()
    box = [f"127.0.0.1:{free_port()}" if hvd.rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    host, port = box[0].rsplit(":", 1)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        world = NativeWorld(hvd.rank(), hvd.size(), host, int(port))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    basics._state.negotiated = world
    return world


def _negotiation_rank(device):
    """One rank of ``negotiation``, started by the launcher."""
    import faulthandler

    faulthandler.dump_traceback_later(900, exit=True)
    sys.path.insert(0, HERE)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    world = hvd.basics.negotiated_world()
    cfg, batch = _planner_batch(hvd, rank, device)
    torch.manual_seed(0)
    with torch.device(hvd.device()):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    _mlm_loss(model, batch).backward()
    grads = {name: p.grad.detach().clone()
             for name, p in model.named_parameters()}
    ints = [_neg_payload(rank, i).to(hvd.device()) for i in range(len(grads))]
    # The bound of two float32 summation orders of n gradients: a few
    # roundings of the largest sum of magnitudes.
    mag = {name: hvd.allreduce(g.abs(), op=hvd.Sum, name=f"mag.{name}")
           for name, g in grads.items()}
    want_ints = [sum(_neg_payload(r, i) for r in range(n)).to(hvd.device())
                 for i in range(len(grads))]
    report = dict(rank=rank, leaves=len(grads))

    def hold(label, got, ref):
        worst = 0.0
        for (g, iv), (rg, riv), name, wi in zip(got, ref, grads, want_ints):
            if not torch.equal(iv, wi):
                raise AssertionError(f"{label}: integer payload of {name} "
                                     f"differs: {iv} against {wi}")
            err = ((g - rg).abs() / (mag[name] / n).clamp_min(1e-30)).max()
            worst = max(worst, float(err))
        if worst > 8 * n * 2.0 ** -24:
            raise AssertionError(f"{label}: gradients differ from the "
                                 f"in-order run by {worst:.3g} of their "
                                 "mean magnitude")
        return worst

    t0 = time.perf_counter()
    in_order = _neg_allreduce_leaves(world, grads, ints, "io")
    report["in_order_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    ooo = _neg_allreduce_leaves(world, grads, ints, "ooo",
                                reverse=rank % 2 == 1)
    report["out_of_order_s"] = round(time.perf_counter() - t0, 3)
    report["out_of_order_worst"] = hold("out of order", ooo, in_order)
    report["cycles"], report["hits"], report["misses"] = (
        world.cycles, world.cache_hits, world.cache_misses)

    # Stall: rank 2 holds one leaf back; then a stall watch it enters late.
    skip = len(grads) // 2 if rank == 2 else None
    held = _neg_allreduce_leaves(world, grads, ints, "st", skip=skip,
                                 hold_s=NEG_STALL_HOLD_S)
    report["stall_leaf"] = f"st.{list(grads)[len(grads) // 2]}"
    report["stall_worst"] = hold("stall", held, in_order)
    if rank == 2:
        time.sleep(NEG_STALL_HOLD_S)
    with hvd.stall.watch("diag.late"):
        pass
    print(f"[rank {rank}] negotiation: stall released", flush=True)

    # The cache at 64 entries: two rounds of every leaf evict and give the
    # in-order run's results.
    world = _neg_reform(hvd, {"HOROVOD_CACHE_CAPACITY":
                              str(NEG_CACHE_CAPACITY)})
    counts = []
    for k in range(2):
        evicted = _neg_allreduce_leaves(world, grads, ints, "ev")
        report[f"evict_worst_{k}"] = hold("eviction", evicted, in_order)
        counts.append((world.cache_hits, world.cache_misses))
    # A name still cached hits at every announcement: a miss in the
    # second round is a name the LRU evicted.
    report["evict_hits"], report["evict_misses"] = (
        [counts[0][0], counts[1][0] - counts[0][0]],
        [counts[0][1], counts[1][1] - counts[0][1]])
    if report["evict_misses"][1] == 0:
        raise AssertionError(f"eviction: no miss in the second round of "
                             f"{2 * len(grads)} names at capacity "
                             f"{NEG_CACHE_CAPACITY}")

    # Join: rank r runs NEG_JOIN_STEPS + r steps, each a negotiated
    # average of every leaf and of an integer payload, then joins.
    for i in range(NEG_JOIN_STEPS + rank):
        _neg_allreduce_leaves(world, grads, ints, f"join{i}")
        got = world.synchronize(world.allreduce_async_(
            torch.tensor([7 * rank + i, -3 * rank, 1000], dtype=torch.int64,
                         device=hvd.device()), name=f"join.int{i}",
            op="average"))
        rows = torch.tensor([[7 * q + i, -3 * q, 1000] for q in range(n)
                             if NEG_JOIN_STEPS + q > i], dtype=torch.float64)
        s = rows.sum(0) / len(rows)
        want = (s.sign() * (s.abs() + 0.5).floor()).to(torch.int64)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"join step {i}: {got.tolist()} against "
                                 f"the {len(rows)} contributors' mean "
                                 f"{want.tolist()}")
    report["join"] = hvd.join()
    if report["join"] != n - 1:
        raise AssertionError(f"join returned {report['join']}, expected "
                             f"{n - 1}")
    report["join_steps"] = NEG_JOIN_STEPS + rank
    print("negotiation rank " + json.dumps(report), flush=True)
    if rank == 0 and device == "cuda":
        print(f"negotiation: cards {_smoke().card_line()}", flush=True)
    hvd.shutdown()


def negotiation(cpu):
    import torch

    n = 4 if cpu else torch.cuda.device_count()
    if n != 4:
        print("negotiation: needs four cards (or --cpu)", file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), *(["--cpu-mode"] if cpu else []), sys.executable,
         os.path.abspath(__file__), "_negotiation_rank", device],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE,
                           HOROVOD_STALL_CHECK_TIME=str(NEG_STALL_CHECK_S)),
        timeout=1500, capture_output=True, text=True)
    text = out.stdout
    sys.stdout.write(text)
    sys.stderr.write(out.stderr[-8000:])
    print(f"negotiation: {n} ranks over {dist_backend(device)} started by "
          f"hvdrun-torch, exit code {out.returncode}, "
          f"{time.perf_counter() - t0:.1f} s")
    if out.returncode != 0:
        return out.returncode
    reports = [json.loads(ln.split("negotiation rank ", 1)[1])
               for ln in text.splitlines() if "negotiation rank " in ln]
    rank0 = [ln for ln in text.splitlines() if ln.startswith("[0]")]
    released = next(i for i, ln in enumerate(rank0)
                    if "negotiation: stall released" in ln)
    leaf = reports[0]["stall_leaf"]
    warned = [ln for ln in rank0[:released] if "stall detected" in ln]
    named = {
        "leaf": any(f"tensor {leaf} " in ln and "rank(s) [2]" in ln
                    for ln in warned),
        "watch": any("tensor stallwatch/diag.late " in ln
                     and "rank(s) [2]" in ln for ln in warned),
    }
    print(f"negotiation: rank 0's stall warnings before the release: "
          f"{warned}")
    if len(reports) != n or not all(named.values()):
        print(f"negotiation: FAILED: {len(reports)} rank reports; named "
              f"{named}", file=sys.stderr)
        return 1
    print(f"negotiation: ok: out of order equal (integers exact, gradients "
          f"within {max(r['out_of_order_worst'] for r in reports):.3g} of "
          f"their mean magnitude), join() = "
          f"{sorted({r['join'] for r in reports})} on every rank after "
          f"{[r['join_steps'] for r in reports]} steps, the held leaf "
          f"{leaf} and stallwatch/diag.late named with rank 2 within "
          f"{NEG_STALL_HOLD_S} s (check time {NEG_STALL_CHECK_S} s), "
          f"capacity {NEG_CACHE_CAPACITY}: (first, second) round misses "
          f"{[r['evict_misses'] for r in reports]}, hits "
          f"{[r['evict_hits'] for r in reports]}, results equal")
    return 0


SPINS_CHILD = r"""
import sys, time, torch
x = torch.randn(8192, 8192, device="cuda")
torch.cuda.synchronize()
print("ready", flush=True)
t0 = time.time()
while time.time() - t0 < 60:
    if sys.argv[1] == "busy":
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    else:
        time.sleep(0.05)
"""

LAZY_CHILD = r"""
import sys, time, torch
sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch.utils.spin import Spin
x = torch.ones(4, device="cuda")
torch.cuda.synchronize()
rows = []
for which in ("first launch", "loaded"):
    spin = Spin(int(2 * 1.98e9))
    t0 = time.perf_counter()
    y = x * 2
    t1 = time.perf_counter()
    torch.cuda.current_stream().synchronize()
    t2 = time.perf_counter()
    rows.append(dict(case=which, launch_s=round(t1 - t0, 4),
                     sync_s=round(t2 - t1, 4), spin_ms=round(spin.ms(), 1)))
print(rows, flush=True)
"""


def spins():
    """C9: ``torch.cuda._sleep`` spins timed by CUDA events (30 of ~10 ms
    and 3 of ~1 s) with this process alone on the card, beside a process
    holding an idle CUDA context, and beside one running matmuls; then,
    in fresh processes under each ``CUDA_MODULE_LOADING``, the host
    seconds of a kernel's first launch behind a 2 s spin and of the sync
    after it, beside a launch of the loaded kernel."""
    import torch

    sys.path.insert(0, HERE)
    from horovod_tpu_torch.utils.spin import Spin

    first = Spin(20_000_000)
    print(f"spins: first spin of this process {first.ms():.3f} ms, at "
          f"least {first.least_ms():.3f}, short {first.short()}", flush=True)
    short_total = 0
    for setting in ("alone", "idle", "busy"):
        child = None
        if setting != "alone":
            child = subprocess.Popen([sys.executable, "-c", SPINS_CHILD,
                                      setting], stdout=subprocess.PIPE,
                                     text=True)
            if child.stdout.readline().strip() != "ready":
                raise RuntimeError("spins: the second process did not start")
        ms, short = [], 0
        for cycles in [20_000_000] * 30 + [2_000_000_000] * 3:
            s = Spin(cycles)
            torch.cuda.synchronize()
            ms.append(round(s.ms(), 3))
            short += s.short()
        if child is not None:
            child.kill()
            child.wait()
        short_total += short
        print(f"spins: {setting}: {short} short of {len(ms)}; ms {ms}",
              flush=True)
    for loading in ("LAZY", "EAGER"):
        out = subprocess.run(
            [sys.executable, "-c", LAZY_CHILD, HERE], capture_output=True,
            text=True, timeout=120, check=True,
            env=dict(os.environ, CUDA_MODULE_LOADING=loading))
        print(f"spins: CUDA_MODULE_LOADING={loading}: {out.stdout.strip()}",
              flush=True)
    print(f"spins: cards {_smoke().card_line()}, torch {torch.__version__}")
    return 1 if short_total else 0


def dist_backend(device):
    return "nccl" if device == "cuda" else "gloo"


def collectives(cpu):
    import torch

    n = 4 if cpu else torch.cuda.device_count()
    if n < 2:
        print("collectives: needs at least two cards (or --cpu)",
              file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    t0 = time.perf_counter()
    # hvdrun-torch: one process per card, the first failing rank's exit
    # code, the others terminated.
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), *(["--cpu-mode"] if cpu else []), sys.executable,
         os.path.abspath(__file__), "_collectives_rank", device],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), timeout=900)
    print(f"collectives: {n} ranks over {dist_backend(device)} started by "
          f"hvdrun-torch, exit code {out.returncode}, "
          f"{time.perf_counter() - t0:.1f} s"
          + ("" if cpu else f", cards: {_smoke().card_line()}"))
    return out.returncode


ELASTIC_HOSTS = ("127.0.0.1", "127.0.0.2", "127.0.0.3", "127.0.0.4")
# The killed host's blacklist cooldown, the steps at 4 ranks after it
# returns, and the wall limit of the whole run, in seconds. The cooldown
# outlasts the survivors' re-formation and a few steps at 3 ranks: their
# sync broadcasts BERT-Large's AdamW state (2.7 GB) by pickle, and with 15 s
# the host returned before any step at 3 (4 x H100 80GB HBM3, 700 W).
ELASTIC_COOLDOWN_S = 60
ELASTIC_STEPS_BACK = 2
ELASTIC_WALL_S = 480


def _elastic_rank(device):
    """One worker of ``elastic``: its card is the one its host names
    (127.0.0.k: card k-1), set before torch is imported. BERT-Large
    S = 512 x 8 (``--cpu``: BERT_TINY, S = 32 x 2), AdamW, bf16 wire on
    the card, every rank on the same batch of each step so that their
    losses can be compared; a ``TorchState`` committed after each step.
    The first worker on 127.0.0.4 SIGKILLs itself during step 3's backward;
    the rest train on until they have run ``ELASTIC_STEPS_BACK`` steps at
    4 ranks after a step at 3, then print their parameters' digest."""
    host = os.environ["HOROVOD_HOSTNAME"]
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(ELASTIC_HOSTS.index(host))
    import dataclasses
    import hashlib
    import json
    import signal

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    smoke = _smoke()
    hvd.init(device=device)
    gen0 = os.environ["HOROVOD_WORLD_VERSION"]
    base = bert_mod.BERT_LARGE if device == "cuda" else bert_mod.BERT_TINY
    cfg = dataclasses.replace(base, dropout_rate=0.0)
    B, S, P = (8, 512, 76) if device == "cuda" else (2, 32, 4)
    dev = hvd.device()
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=(hvd.Compression.bf16 if device == "cuda"
                     else hvd.Compression.none))
    step = hvd.make_elastic_train_step(model, smoke._bert_loss, opt,
                                       loss_is_averaged=False)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0,
                                   shrunk=False, back=0)
    victim = host == ELASTIC_HOSTS[-1] and gen0 == "1"
    if victim:
        middle = model.layers[len(model.layers) // 2] if hasattr(
            model, "layers") else None
        param = next((middle or model).parameters())

        def kill(_):
            if state.step == 2:
                print("HVD_ELASTIC_KILL " + json.dumps({"t": time.time()}),
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

        param.register_post_accumulate_grad_hook(kill)

    @hvd.elastic.run
    def train(state):
        while not state.back >= ELASTIC_STEPS_BACK:
            if state.step >= 400:
                raise AssertionError("elastic: 400 steps without the world "
                                     "returning to 4 ranks")
            batch = smoke._bert_batch(cfg, B, S, P, state.step, dev)
            loss = float(step(batch))
            n = hvd.size()
            state.step += 1
            state.back += int(n == 4 and state.shrunk)
            state.shrunk = state.shrunk or n == 3
            state.commit()
            print("HVD_ELASTIC_STEP " + json.dumps(dict(
                host=host, gen=os.environ["HOROVOD_WORLD_VERSION"],
                rank=hvd.rank(), size=n, step=state.step, loss=loss,
                t=time.time())), flush=True)
        # Every rank prints before any returns: the driver ends the job
        # at the first worker's exit.
        hvd.allreduce(torch.zeros(1, device=dev))
        digest = hashlib.sha256(b"".join(
            p.detach().float().cpu().numpy().tobytes()
            for p in model.parameters())).hexdigest()
        print("HVD_ELASTIC_DONE " + json.dumps(dict(
            host=host, rank=hvd.rank(), size=hvd.size(), step=state.step,
            digest=digest)), flush=True)
        hvd.allreduce(torch.zeros(1, device=dev))

    train(state)


def elastic(cpu, log=None):
    """Four hosts 127.0.0.1-4, one slot and one card each, through
    ``hvdrun-torch --min-np 2 --max-np 4 --host-discovery-script``: the
    fourth worker SIGKILLs itself during step 3's backward while its peers
    wait in the NCCL allreduce; the driver reaps it, blacklists the host
    for ``ELASTIC_COOLDOWN_S`` and posts the coordinated abort; the
    survivors unblock, re-form at 3, sync and go on; after the cooldown
    the host returns and the world re-forms at 4 through
    ``HostsUpdatedInterrupt``. Holds the losses equal across ranks at every
    step, the parameters bit-identical on every rank at the end, and the
    run within ``ELASTIC_WALL_S``; prints the seconds from the kill to the
    first step at 3 ranks and from the host's return to the first step at
    4. ``--cpu``: 4 gloo ranks and BERT_TINY; ``--log PATH`` writes every
    line of the run there."""
    import json

    import torch

    if not cpu and torch.cuda.device_count() < 4:
        print("elastic: needs four cards (or --cpu)", file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    rc, lines, wall = _launch_elastic(
        device, cpu, "_elastic_rank",
        {"HOROVOD_BLACKLIST_COOLDOWN": str(ELASTIC_COOLDOWN_S),
         "HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT": "30"}, ELASTIC_WALL_S, log)
    text = "\n".join(line for _, line in lines)

    def records(tag):
        return [(t, json.loads(line.split(tag + " ", 1)[1]))
                for t, line in lines if tag + " {" in line]

    steps = [r for _, r in records("HVD_ELASTIC_STEP")]
    kills = [r["t"] for _, r in records("HVD_ELASTIC_KILL")]
    done = [r for _, r in records("HVD_ELASTIC_DONE")]
    returned = [t for t, line in lines if "host set changed" in line]
    by_step = {}
    for r in steps:
        by_step.setdefault((r["gen"], r["step"]), []).append(r)
    # Every rank prints every step it committed, except that a rank whose
    # commit raised HostsUpdatedInterrupt (after its snapshot) does not
    # print it: the last step of a world that a host update ended.
    last = {}
    for g, n in by_step:
        last[g] = max(last.get(g, n), n)
    unequal = {k: [r["loss"] for r in v] for k, v in by_step.items()
               if len({r["loss"] for r in v}) != 1
               or (len(v) != v[0]["size"] and k[1] != last[k[0]])}
    sizes = [v[0]["size"] for _, v in sorted(
        by_step.items(), key=lambda kv: kv[1][0]["t"])]
    shape = [n for i, n in enumerate(sizes) if i == 0 or n != sizes[i - 1]]
    ok = (rc == 0 and len(kills) == 1 and shape == [4, 3, 4] and returned
          and not unequal and len(done) == 4
          and len({d["digest"] for d in done}) == 1)
    at3 = [r["t"] for r in steps if r["size"] == 3]
    first3 = min(at3) if at3 else None
    back = [r["t"] for r in steps if r["size"] == 4 and at3
            and r["t"] > first3]
    print(f"elastic: {4} hosts over {dist_backend(device)}, exit code {rc}, "
          f"wall {wall:.1f} s (limit {ELASTIC_WALL_S}), world sizes by step "
          f"{sizes}, steps {len(by_step)}, losses equal across ranks at "
          f"every step: {not unequal}, final digests "
          f"{sorted({d['digest'][:16] for d in done})} on "
          f"{len(done)} ranks")
    if kills and first3:
        print(f"elastic: seconds from the kill to the first step at 3 ranks "
              f"{first3 - kills[0]:.2f}; from the host's return (the "
              f"driver's reconfiguration) to the first step at 4 "
              f"{(min(back) - returned[-1]) if back and returned else 'n/a'}"
              + ("" if cpu else f"; cards: {_smoke().card_line()}"))
    if not ok:
        print(f"elastic: FAILED (unequal {unequal}):\n{text[-6000:]}",
              file=sys.stderr)
        return 1
    return 0


ELASTIC_FSDP_COOLDOWN_S = 3600
ELASTIC_FSDP_STEPS_AT_3 = 2
ELASTIC_FSDP_WALL_S = 900


# The straggler diagnostic: the delayed worker's host, its delay per
# watched step, the steps run, and the run's wall limit in seconds.
STRAGGLER_HOST = ELASTIC_HOSTS[2]
STRAGGLER_DELAY_S = 1.5
STRAGGLER_STEPS = 6
STRAGGLER_WALL_S = 420


def _straggler_rank(device):
    """One worker of ``elastic --straggler`` (see the module docstring)."""
    host = os.environ["HOROVOD_HOSTNAME"]
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(ELASTIC_HOSTS.index(host))
    if host == STRAGGLER_HOST:
        os.environ["HOROVOD_FAULTS"] = (
            f"worker.step=delay:{STRAGGLER_DELAY_S}@1x999999")
    import dataclasses
    import json
    from urllib.request import urlopen

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    smoke = _smoke()
    hvd.init(device=device)
    base = bert_mod.BERT_LARGE if device == "cuda" else bert_mod.BERT_TINY
    cfg = dataclasses.replace(base, dropout_rate=0.0)
    B, S, P = (8, 512, 76) if device == "cuda" else (2, 32, 4)
    dev = hvd.device()
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=(hvd.Compression.bf16 if device == "cuda"
                     else hvd.Compression.none))
    step = hvd.make_elastic_train_step(model, smoke._bert_loss, opt)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
    kv = (f"http://{os.environ['HOROVOD_RENDEZVOUS_ADDR']}:"
          f"{os.environ['HOROVOD_RENDEZVOUS_PORT']}")

    def read(route):
        return json.loads(urlopen(kv + route).read())

    @hvd.elastic.run
    def train(state):
        while state.step < STRAGGLER_STEPS:
            batch = smoke._bert_batch(cfg, B, S, P, state.step, dev)
            t0 = time.time()
            loss = float(step(batch))
            state.step += 1
            state.commit()
            print("HVD_STRAGGLER_STEP " + json.dumps(dict(
                host=host, rank=hvd.rank(), step=state.step, loss=loss,
                s=time.time() - t0)), flush=True)
        if hvd.rank() == 0:
            # Every rank's traces of the last steps, shipped.
            deadline = time.time() + 60
            while True:
                cp = read("/criticalpath")
                full = [g for g in cp["groups"] if len(g["ranks"]) == 4]
                if len(full) >= 2 or time.time() > deadline:
                    break
                time.sleep(0.5)
            timeline = read("/timeline?steps=4")
            print("HVD_STRAGGLER " + json.dumps(dict(
                stragglers=read("/stragglers"), groups=full,
                tracks=sorted({e["pid"] for e in timeline["traceEvents"]
                               if e["ph"] == "X"}),
                hosts=timeline["metadata"]["ranks"])), flush=True)
        # Every rank waits for rank 0's read: the driver ends the job at
        # the first worker's exit.
        hvd.allreduce(torch.zeros(1, device=dev))

    train(state)


def elastic_straggler(cpu, log=None):
    """``elastic --straggler``: see the module docstring."""
    import json

    import torch

    if not cpu and torch.cuda.device_count() < 4:
        print("elastic --straggler: needs four cards (or --cpu)",
              file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    rc, lines, wall = _launch_elastic(
        device, cpu, "_straggler_rank",
        {"HOROVOD_TRACE_SAMPLE": "1", "HOROVOD_STALL_CHECK_STEPS": "1",
         "HOROVOD_ELASTIC_HEARTBEAT_INTERVAL": "0.5",
         "HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT": "30"}, STRAGGLER_WALL_S, log)
    text = "\n".join(line for _, line in lines)
    steps = [json.loads(line.split("HVD_STRAGGLER_STEP ", 1)[1])
             for _, line in lines if "HVD_STRAGGLER_STEP {" in line]
    reports = [json.loads(line.split("HVD_STRAGGLER ", 1)[1])
               for _, line in lines if "HVD_STRAGGLER {" in line]
    slow = {s["rank"] for s in steps if s["host"] == STRAGGLER_HOST}
    r = reports[0] if reports else {}
    worst = (r.get("stragglers") or {}).get("worst") or {}
    suspects = {g["step"]: g["suspect_rank"] for g in r.get("groups", ())}
    # The first step's first-call work (about 30 s on the card) swamps the
    # delay: the steps after it must name the delayed rank.
    held = [x for step, x in suspects.items() if step > 1]
    ok = (rc == 0 and len(slow) == 1 and r.get("tracks") == [0, 1, 2, 3]
          and str(worst.get("last_rank")) in {str(x) for x in slow}
          and len(held) >= 2 and all(x in {str(y) for y in slow}
                                     for x in held))
    late = {k: v["mean_lateness_s"]
            for k, v in (r.get("stragglers") or {}).get("ranks", {}).items()}
    print(f"elastic --straggler: 4 hosts over {dist_backend(device)}, exit "
          f"code {rc}, wall {wall:.1f} s; {STRAGGLER_HOST} (rank "
          f"{sorted(slow)}) delayed {STRAGGLER_DELAY_S} s per watched step; "
          f"/stragglers worst {worst}, mean lateness by rank {late}; "
          f"/criticalpath suspects by step {suspects}; /timeline tracks "
          f"{r.get('tracks')}"
          + ("" if cpu else f"; cards: {_smoke().card_line()}"))
    if r.get("groups"):
        g = r["groups"][-1]
        print(f"elastic --straggler: step {g['step']}: critical path "
              f"{[(n['kind'], n.get('name'), n.get('gating_rank', n.get('rank')), n['dur_s']) for n in g['critical_path']]}"
              f"; phases by rank (s) "
              f"{ {k: d['phases'] for k, d in g['ranks'].items()} }")
    if not ok:
        print(f"elastic --straggler: FAILED:\n{text[-6000:]}",
              file=sys.stderr)
        return 1
    return 0


def _full_digest(hvd, opt):
    """sha256 of an fsdp optimizer's full parameters and monolithic AdamW
    state, on the set's first rank (None elsewhere): the check's own
    gather. Collective."""
    import hashlib

    from horovod_tpu_torch.optimizer import unshard_opt_state

    flat = opt.full_parameters()
    stacked = hvd.gather_sharded_state(opt)
    if stacked is None:
        return None
    return _digest(flat, unshard_opt_state(opt, stacked), hashlib)


def _digest(flat, opt_state, hashlib):
    h = hashlib.sha256()
    for t in flat:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    for i in sorted(opt_state["state"]):
        for k in sorted(opt_state["state"][i]):
            h.update(opt_state["state"][i][k].detach().float().cpu()
                     .contiguous().numpy().tobytes())
    return h.hexdigest()


def _elastic_fsdp_rank(device):
    """One worker of ``elastic --fsdp`` (see the module docstring): prints
    HVD_ELASTIC_STEP after each step, HVD_COMMIT (record bytes, seconds of
    the replication and of the commit), HVD_GATHERED (rank 0, the full
    state's digest at the commits before the kill), HVD_PEER (the digest of
    the state the peer rung rebuilt), HVD_INSTALLED (the digest at the
    first step at 3 ranks) and HVD_ELASTIC_DONE."""
    host = os.environ["HOROVOD_HOSTNAME"]
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(ELASTIC_HOSTS.index(host))
    import dataclasses
    import hashlib
    import json
    import signal

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod

    smoke = _smoke()
    hvd.init(device=device)
    gen0 = os.environ["HOROVOD_WORLD_VERSION"]
    base = bert_mod.BERT_LARGE if device == "cuda" else bert_mod.BERT_TINY
    cfg = dataclasses.replace(base, dropout_rate=0.0)
    B, S, P = (8, 512, 76) if device == "cuda" else (2, 32, 4)
    dev = hvd.device()
    torch.manual_seed(0)
    with torch.device(dev):
        model = bert_mod.Bert(cfg, attention_fn=bert_mod.flash_attention_fn)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        compression=(hvd.Compression.bf16 if device == "cuda"
                     else hvd.Compression.none), sync_mode="fsdp")
    step = hvd.make_train_step(model, smoke._bert_loss, opt,
                               loss_is_averaged=False)
    state = hvd.elastic.PeerShardedState(model=model, optimizer=opt, step=0,
                                         at3=0)

    def emit(tag, **fields):
        print(f"{tag} " + json.dumps(dict(host=host, t=time.time(),
                                          **fields)), flush=True)

    def durable():
        emit("HVD_DURABLE")
        raise RuntimeError("elastic --fsdp: the durable rung must not run")

    state.register_durable_restore(durable)
    peer_restore = state._restore_from_peers

    def peer():
        t0 = time.perf_counter()
        peer_restore()
        full = state._full
        emit("HVD_PEER", step=state.step, seconds=time.perf_counter() - t0,
             digest=_digest(full["flat"], full["opt"], hashlib))

    state.register_peer_restore(peer)
    rep = state._replicator
    replicate = rep.replicate
    spent = []

    def timed_replicate(*a, **k):
        t0 = time.perf_counter()
        try:
            return replicate(*a, **k)
        finally:
            spent.append(time.perf_counter() - t0)

    rep.replicate = timed_replicate
    if host == ELASTIC_HOSTS[-1] and gen0 == "1":
        def kill(_):
            if state.step == 2:
                print("HVD_ELASTIC_KILL " + json.dumps({"t": time.time()}),
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

        opt.shards[len(opt.shards) // 2].register_post_accumulate_grad_hook(
            kill)
    sizes = []

    @hvd.elastic.run
    def train(state):
        while state.at3 < ELASTIC_FSDP_STEPS_AT_3:
            n = hvd.size()
            if sizes and sizes[-1] != n:
                digest = _full_digest(hvd, opt)
                if digest is not None:
                    emit("HVD_INSTALLED", step=state.step, digest=digest)
            sizes.append(n)
            batch = smoke._bert_batch(cfg, B, S, P, state.step, dev)
            loss = float(step(batch))
            state.step += 1
            state.at3 += int(n == 3)
            if n == 4:
                digest = _full_digest(hvd, opt)
                if digest is not None:
                    emit("HVD_GATHERED", step=state.step, digest=digest)
            t0 = time.perf_counter()
            state.commit()
            emit("HVD_COMMIT", step=state.step, seconds=time.perf_counter()
                 - t0, replicate=spent[-1],
                 bytes=len(rep.pool.get(hvd.rank()).payload))
            emit("HVD_ELASTIC_STEP", gen=os.environ["HOROVOD_WORLD_VERSION"],
                 rank=hvd.rank(), size=n, step=state.step, loss=loss)
        hvd.allreduce(torch.zeros(1, device=dev))
        digest = hashlib.sha256(b"".join(
            t.detach().float().cpu().numpy().tobytes()
            for t in opt.full_parameters())).hexdigest()
        print("HVD_ELASTIC_DONE " + json.dumps(dict(
            host=host, rank=hvd.rank(), size=hvd.size(), step=state.step,
            digest=digest)), flush=True)
        hvd.allreduce(torch.zeros(1, device=dev))

    train(state)


def elastic_fsdp(cpu, log=None):
    """``elastic --fsdp``: see the module docstring."""
    import json

    import torch

    if not cpu and torch.cuda.device_count() < 4:
        print("elastic --fsdp: needs four cards (or --cpu)", file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    env = {"HOROVOD_BLACKLIST_COOLDOWN": str(ELASTIC_FSDP_COOLDOWN_S),
           # A record is ~1.0 GB at 4 ranks (a rank's parameter shards and
           # both moments): past the 256 MiB and 5 s defaults.
           "HOROVOD_PEERCHECK_MAX_BYTES": str(4 << 30),
           "HOROVOD_PEERCHECK_TIMEOUT": "300",
           "HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT": "600"}
    rc, lines, wall = _launch_elastic(device, cpu, "_elastic_fsdp_rank",
                                      env, ELASTIC_FSDP_WALL_S, log)

    def records(tag):
        return [json.loads(line.split(tag + " ", 1)[1])
                for _, line in lines if tag + " {" in line]

    steps = records("HVD_ELASTIC_STEP")
    kills = [r["t"] for r in records("HVD_ELASTIC_KILL")]
    done = records("HVD_ELASTIC_DONE")
    gathered = {r["step"]: r["digest"] for r in records("HVD_GATHERED")}
    peers = records("HVD_PEER")
    installed = records("HVD_INSTALLED")
    commits = records("HVD_COMMIT")
    by_step = {}
    for r in steps:
        by_step.setdefault((r["gen"], r["step"]), []).append(r)
    unequal = {k: [r["loss"] for r in v] for k, v in by_step.items()
               if len({r["loss"] for r in v}) != 1}
    sizes = [v[0]["size"] for _, v in sorted(
        by_step.items(), key=lambda kv: kv[1][0]["t"])]
    shape = [n for i, n in enumerate(sizes) if i == 0 or n != sizes[i - 1]]
    peer_ok = (len({p["host"] for p in peers}) == 3 and all(
        p["digest"] == gathered.get(p["step"]) for p in peers))
    installed_ok = len(installed) == 1 and (
        installed[0]["digest"] == gathered.get(installed[0]["step"]))
    ok = (rc == 0 and len(kills) == 1 and shape == [4, 3] and not unequal
          and peer_ok and installed_ok and not records("HVD_DURABLE")
          and len(done) == 3 and len({d["digest"] for d in done}) == 1)
    at3 = [r["t"] for r in steps if r["size"] == 3]
    card = "" if cpu else f" on {_smoke().card_line()}"
    print(f"elastic --fsdp: 4 hosts over {dist_backend(device)}, exit code "
          f"{rc}, wall {wall:.1f} s (limit {ELASTIC_FSDP_WALL_S}), world "
          f"sizes by step {sizes}, losses equal across ranks at every step: "
          f"{not unequal}, peer rung on {sorted(p['host'] for p in peers)} "
          f"at steps {sorted({p['step'] for p in peers})}, rebuilt state = "
          f"gathered commit: {peer_ok}, installed state = gathered commit: "
          f"{installed_ok}, durable reads {len(records('HVD_DURABLE'))}, "
          f"final digests {sorted({d['digest'][:16] for d in done})} on "
          f"{len(done)} ranks")
    if commits:
        print(f"elastic --fsdp: record bytes per rank "
              f"{sorted({c['bytes'] for c in commits})}; seconds of each "
              f"commit {[round(c['seconds'], 2) for c in commits]}, of its "
              f"replication {[round(c['replicate'], 2) for c in commits]}; "
              f"peer rung seconds {[round(p['seconds'], 2) for p in peers]}"
              + card)
    if kills and at3:
        print(f"elastic --fsdp: seconds from the kill to the first step at 3 "
              f"ranks {min(at3) - kills[0]:.2f}" + card)
    if not ok:
        print(f"elastic --fsdp: FAILED (unequal {unequal}, shape {shape}):\n"
              + "\n".join(line for _, line in lines)[-6000:],
              file=sys.stderr)
        return 1
    return 0


def _launch_elastic(device, cpu, entry, env, wall_s, log):
    """``hvdrun-torch -np 4 --min-np 2 --max-np 4`` over ``ELASTIC_HOSTS``
    (one slot each), each worker ``chip_diag.py <entry> <device>``, with
    ``env`` added: (exit code or None past ``wall_s``, the timed lines of
    its output, the wall seconds). ``log`` gets every line."""
    import shutil
    import threading

    tmp = os.path.join(HERE, "build", "chip_diag_elastic")
    os.makedirs(tmp, exist_ok=True)
    hosts = os.path.join(tmp, "hosts.txt")
    with open(hosts, "w") as f:
        f.write("\n".join(ELASTIC_HOSTS) + "\n")
    disc = os.path.join(tmp, "discover.sh")
    with open(disc, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts}\n")
    os.chmod(disc, 0o755)
    env = dict(os.environ, PYTHONPATH=HERE, HOROVOD_LOG_LEVEL="info", **env)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "4", "--min-np", "2", "--max-np", "4", "--host-discovery-script",
         disc, *(["--cpu-mode"] if cpu else []), sys.executable,
         os.path.abspath(__file__), entry, device],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append((time.time(), line.rstrip("\n")))

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=wall_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = None
    reader.join(timeout=10)
    shutil.rmtree(tmp, ignore_errors=True)
    wall = time.time() - t0
    if log:
        with open(log, "w") as f:
            f.write("\n".join(f"{t - t0:9.3f} {line}" for t, line in lines))
    return rc, lines, wall


def fsdp_gathers():
    import gc
    import statistics

    import torch

    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    smoke.build_phase()
    os.environ["HOROVOD_FORCE_WIRE_MACHINERY"] = "1"
    sys.path.insert(0, HERE)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.collective_ops import Average, allreduce

    hvd.init()
    smoke.WARMUP_STEPS = 3

    class Loss(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, batch):
            return smoke._bert_loss(self.model, batch)

    def all_at_once(model, opt, step):
        names_of = {id(p): n for n, p in model.named_parameters()}
        names = [f"model.{names_of[id(p)]}" for p in opt._params]
        module = Loss(model)

        def run(batch):
            full = opt.gather()
            loss = torch.func.functional_call(module, dict(zip(names, full)),
                                              (batch,))
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return allreduce(loss.detach(), op=Average)

        return run

    placements = {"A all at once": ("1", "4", all_at_once),
                  "B up front": ("0", "4", None),
                  "C just in time, 1 segment": ("1", "1", None),
                  "D just in time, 4 segments": ("1", "4", None)}
    names = list(placements)
    results = {}
    for name in (names + names[::-1]) * 2:
        reshard, segments, prepare = placements[name]
        os.environ["HOROVOD_FSDP_RESHARD_AFTER_FORWARD"] = reshard
        os.environ["HOROVOD_FSDP_SEGMENTS"] = segments
        model, opt, losses, ms, peak = smoke._bert_mode_run(
            card, f"fsdp {name}", "fsdp", hvd.Compression.bf16, steps=13,
            prepare=prepare)
        results.setdefault(name, []).append((ms, peak, losses[-1]))
        opt.remove_hooks()
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    for name, runs in results.items():
        print(f"fsdp_gathers {name}: step medians "
              f"{[round(r[0], 2) for r in runs]} ms (median "
              f"{statistics.median(r[0] for r in runs):.2f}), peak "
              f"{[round(r[1], 3) for r in runs]} GiB, last loss "
              f"{[round(r[2], 5) for r in runs]} on {card}")
    hvd.shutdown()
    return 0


def _steps_worker(tree, label):
    """Train both BERT-Large paths of ``tree``'s chip_smoke.py through
    ``tree``'s package (its ``training_phase``: one rank, the NCCL wire
    forced on) and print one JSON line: each path's median step ms and
    device busy ms per step."""
    import io

    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _kernels

    if not hvd.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {hvd.__file__}, not the checkout {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    os.environ["HOROVOD_FORCE_WIRE_MACHINERY"] = "1"
    card = smoke.card_line()
    hvd.init()
    out = dict(label=label, tree=tree, card=card)
    for path in smoke.BERT_PATHS:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            smoke.training_phase(card, path)
        text = text.getvalue()
        out[path[0]] = dict(
            step_ms=float(re.search(r"step_ms median ([0-9.]+)", text)[1]),
            busy_ms=float(re.search(r"device busy ([0-9.]+) ms per step",
                                    text)[1]))
    hvd.shutdown()
    print(json.dumps(out))


def ab_steps(other):
    """BERT-Large's training step at both chip_smoke.py paths through
    OTHER_CHECKOUT's package and this one's, each in a process of its own
    in the order other, this, this, other; prints each process's JSON line,
    then each path's mean step ms and busy ms per checkout."""
    order = (("other", other), ("this", HERE), ("this", HERE),
             ("other", other))
    runs = {"other": [], "this": []}
    for label, tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_steps_worker",
             tree, label], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"ab_steps: the {label} checkout ({tree}) failed with exit "
                  f"code {proc.returncode}", file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs[label].append(json.loads(line))
    for path in [k for k in runs["this"][0] if k.startswith("bert_")]:
        for metric in ("step_ms", "busy_ms"):
            o, t = (sum(r[path][metric] for r in runs[label]) / 2
                    for label in ("other", "this"))
            print(f"ab_steps {path} {metric}: other {o:.2f}, this {t:.2f}, "
                  f"this / other {t / o:.4f} (runs: other "
                  f"{[r[path][metric] for r in runs['other']]}, this "
                  f"{[r[path][metric] for r in runs['this']]})")
    print(f"card: {runs['this'][0]['card']}")
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["_worker"] and len(args) == 3:
        _worker(args[1], args[2])
        return 0
    if args in (["collectives"], ["collectives", "--cpu"]):
        return collectives(args[1:] == ["--cpu"])
    if args[:1] == ["_collectives_rank"] and len(args) == 2:
        _collectives_rank(args[1])
        return 0
    if args in (["comms"], ["comms", "--cpu"]):
        return comms(args[1:] == ["--cpu"])
    if args[:1] == ["_comms_rank"] and len(args) == 2:
        _comms_rank(args[1])
        return 0
    if args in (["negotiation"], ["negotiation", "--cpu"]):
        return negotiation(args[1:] == ["--cpu"])
    if args[:1] == ["_negotiation_rank"] and len(args) == 2:
        _negotiation_rank(args[1])
        return 0
    if args in (["planner"], ["planner", "--cpu"]):
        return planner(args[1:] == ["--cpu"])
    if args[:1] == ["_planner_rank"] and len(args) == 2:
        _planner_rank(args[1])
        return 0
    if args[:1] == ["elastic"] and set(args[1:]) - {
            "--cpu", "--fsdp", "--straggler"} <= (
            {"--log", args[args.index("--log") + 1]} if "--log" in args
            else set()):
        cpu = "--cpu" in args
        log = args[args.index("--log") + 1] if "--log" in args else None
        run = (elastic_fsdp if "--fsdp" in args else elastic_straggler
               if "--straggler" in args else elastic)
        return run(cpu, log)
    if args[:1] == ["_straggler_rank"] and len(args) == 2:
        _straggler_rank(args[1])
        return 0
    if args[:1] == ["_elastic_rank"] and len(args) == 2:
        _elastic_rank(args[1])
        return 0
    if args[:1] == ["_elastic_fsdp_rank"] and len(args) == 2:
        _elastic_fsdp_rank(args[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device visible", file=sys.stderr)
        return 1
    if args[:1] == ["ab"] and len(args) == 2:
        return ab(args[1])
    if args[:1] == ["_steps_worker"] and len(args) == 3:
        _steps_worker(args[1], args[2])
        return 0
    if args[:1] == ["ab_steps"] and len(args) == 2:
        return ab_steps(args[1])
    if args == ["watchdog"]:
        return watchdog()
    if args == ["fsdp_gathers"]:
        return fsdp_gathers()
    if args == ["spins"]:
        return spins()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
