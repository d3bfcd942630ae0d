"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, once per content of the sources, headers and
flags, into ``build/`` beside this file (git ignores it); a file lock makes
concurrent ranks wait for one build. Nothing here runs at import
time: the CPU tests import this module on machines without ``nvcc``.

Each :class:`Kernel` counts its own launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("flash_attention.cu", "flash_attention_single.cu",
           "conv1x1_dw.cu")
HEADERS = ("flash_common.cuh", "flash_hopper.cuh", "sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of the C interface (csrc/flash_common.cuh).
DTYPE_F32 = 0
DTYPE_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


@dataclasses.dataclass
class Kernel:
    """One C entry point of the library, with its launch count."""

    name: str
    symbol: str
    argtypes: tuple
    source: str  # the file under csrc/ that holds it
    replaces: str  # the Pallas kernel it ports, as file:line
    launches: int = 0


FLASH_FWD = Kernel(
    "flash_fwd", "hvd_flash_fwd", (_P,) * 5 + (_I,) * 8 + (_F, _P),
    "flash_attention.cu", "horovod_tpu/ops/attention.py:138")
FLASH_DQ = Kernel(
    "flash_dq", "hvd_flash_dq", (_P,) * 8 + (_I,) * 8 + (_F, _P),
    "flash_attention.cu", "horovod_tpu/ops/attention.py:198")
FLASH_DKV = Kernel(
    "flash_dkv", "hvd_flash_dkv", (_P,) * 9 + (_I,) * 8 + (_F, _P),
    "flash_attention.cu", "horovod_tpu/ops/attention.py:252")
FLASH_FWD_SINGLE = Kernel(
    "flash_fwd_single", "hvd_flash_fwd_single",
    (_P,) * 5 + (_I,) * 8 + (_F, _P),
    "flash_attention_single.cu", "horovod_tpu/ops/attention.py:310")
FLASH_DQKV = Kernel(
    "flash_dqkv", "hvd_flash_dqkv", (_P,) * 10 + (_I,) * 8 + (_F, _P),
    "flash_attention_single.cu", "horovod_tpu/ops/attention.py:343")
DW_1X1 = Kernel(
    "dw_1x1", "hvd_dw_1x1", (_P,) * 4 + (_I,) * 10 + (_L,) * 3 + (_I, _P),
    "conv1x1_dw.cu", "horovod_tpu/ops/conv_backward.py:43")
KERNELS = (FLASH_FWD, FLASH_DQ, FLASH_DKV, FLASH_FWD_SINGLE, FLASH_DQKV,
           DW_1X1)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the CUDA kernels build only where the CUDA "
        "toolkit is installed")


def build() -> str:
    """Compile the sources (once per content) and return the library path.

    The compiler's output, including ``-Xptxas -v``'s registers, shared
    memory and spills per kernel, is kept in a ``.log`` file beside it.
    """
    sources = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + [os.path.join(CSRC_DIR, s) for s in HEADERS]:
        with open(p, "rb") as f:
            h.update(f.read())
    stem = os.path.join(BUILD_DIR, f"libhvd_kernels_{h.hexdigest()[:16]}")
    lib_path = stem + ".so"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        objs = [f"{stem}_{os.path.basename(p)}.{os.getpid()}.o"
                for p in sources]
        compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p]
                    for p, o in zip(sources, objs)]
        link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-shared", "-o", tmp, *objs]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        steps = [(cmd, p.communicate()[0], p.returncode)
                 for cmd, p in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in steps):
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            steps.append((link, proc.stdout, proc.returncode))
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        with open(stem + ".log", "w") as f:
            for cmd, out, _ in steps:
                f.write(" ".join(cmd) + "\n" + out)
        failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
        if failed:
            cmd, out, rc = failed[0]
            raise RuntimeError(
                f"nvcc failed with exit code {rc} ({os.path.basename(cmd[-1])}"
                f"):\n{out[-6000:]}")
        os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """The compiler output of the current build ('' before the build)."""
    path = build()[: -len(".so")] + ".log"
    with open(path) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for k in KERNELS:
                fn = getattr(lib, k.symbol)
                fn.argtypes = list(k.argtypes)
                fn.restype = ctypes.c_int
            lib.hvd_error_string.argtypes = [ctypes.c_int]
            lib.hvd_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: Kernel, *args) -> None:
    """Launch ``kernel`` with C arguments; raise if CUDA refused it."""
    lib = library()
    err = getattr(lib, kernel.symbol)(*args)
    if err != 0:
        msg = lib.hvd_error_string(err).decode()
        raise RuntimeError(
            f"{kernel.name} launch failed: {msg} (cudaError {err})")
    kernel.launches += 1
