#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on one NVIDIA GPU, beyond
``chip_smoke.py``. Run from the root of a checkout, with one card visible:

    python3 chip_diag.py ab OTHER_CHECKOUT
    python3 chip_diag.py watchdog

``ab`` times the kernels of OTHER_CHECKOUT and of this checkout at
chip_smoke.py's shapes: at its BERT-Large path shapes (D = 64, bf16,
non-causal) the multi-tile attention kernels (flash_fwd, flash_dq,
flash_dkv) and the SDPA forward and backward at S=512 (B*H = 128); the
single-tile forward and fused backward (flash_fwd_single, flash_dqkv), the
SDPA forward and backward, and flash_dq + flash_dkv on flash_dqkv's inputs
at S=128 (B*H = 1024); and the 1x1-conv filter gradient (dw_1x1) beside
cuBLAS's x^T dy at both ResNet-50 shapes of chip_smoke.py (the shortcut's
cuBLAS call reads a contiguous copy of its strided x). Each
checkout runs in a process of its own, in the order other, this, this,
other. Each process times every call by three methods, all with the L2
flushed before each call:

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
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = ("flash_fwd", "flash_dq", "flash_dkv", "sdpa_fwd", "sdpa_bwd",
         "flash_fwd_single", "sdpa_fwd_s128", "flash_dqkv", "sdpa_bwd_s128",
         "flash_dq_dkv_s128", "dw_1x1_stage1", "cublas_stage1",
         "dw_1x1_shortcut", "cublas_shortcut")
METHODS = ("spin_ms", "no_spin_ms", "device_ms")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _device_events(body, reps):
    """(name, µs) of every device kernel that ``reps`` calls of ``body``
    ran, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            body()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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
    }
    result = {name: {"spin_ms": smoke.time_ms(fn),
                     "no_spin_ms": smoke.time_ms(fn, sleep_cycles=0),
                     "device_ms": _device_ms(fn)}
              for name, fn in calls.items()}
    print(json.dumps({"checkout": label, "path": tree,
                      "card": smoke.card_line(), **result}))


def ab(other):
    order = (("other", other), ("this", HERE), ("this", HERE),
             ("other", other))
    runs = {"other": [], "this": []}
    for label, tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_worker", tree,
             label], capture_output=True, text=True, timeout=900)
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
                    for label in ("other", "this"))
            print(f"ab {name} {method}: other {o:.4f} ms, this {t:.4f} ms, "
                  f"other / this {o / t:.2f}")
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


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["_worker"] and len(args) == 3:
        _worker(args[1], args[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device visible", file=sys.stderr)
        return 1
    if args[:1] == ["ab"] and len(args) == 2:
        return ab(args[1])
    if args == ["watchdog"]:
        return watchdog()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
