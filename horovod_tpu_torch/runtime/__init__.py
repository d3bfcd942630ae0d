"""The negotiated runtime: named collectives that ranks may enqueue in any
order, put in one order by a rank-0 controller, and performed over NCCL
(gloo on the CPU).

Port of the JAX package's native runtime (``horovod_tpu/runtime``): the
counterpart of its ``NativeWorld`` (``runtime/__init__.py:225-734``), with
its names and contract, on torch tensors.

The control plane is the JAX package's C++, copied under
``horovod_tpu_torch/csrc/runtime/`` and built with ``g++`` at first use
(one ``g++`` per source, started together) into the git-ignored
``ops/build/``, once per content of the sources and flags, under the
kernels' file lock; it is loaded with ``ctypes``. A build that fails
raises. Its parts: the star to rank 0 (``transport.cc``), the controller
(``controller.cc``: the response cache with its mirrored LRU and the
bitvector fast path, the stall inspector, fusion up to
``HOROVOD_FUSION_THRESHOLD``, the process-set table, the JoinOp
bookkeeping) and the ``ParameterManager`` (``HOROVOD_AUTOTUNE=1``: it
tunes the cycle time and the fusion threshold from each window's bytes
over its seconds) on the one copy of the Gaussian process
(``csrc/bayes_opt.cc``).

A C++ background thread runs the negotiation cycles, as the JAX
package's loop does: back to back while tensors are in flight, every
``HOROVOD_CYCLE_TIME`` ms while idle, with no Python and no GIL, so the
star keeps cycling whatever the training thread does. It queues each
cycle's fused ``ResponseList``, with the local handle of each tensor, for
the executor: a Python thread of this module that takes them with
``hvdtorch_rt_next`` (blocking with the GIL released) and performs the
responses in broadcast order, each on the group of its process set: the
world's own process group over the same ranks for the global set, and a
group made for each set at its registration, so its collectives never
interleave with the direct launches of the default group, and a rank
outside a set takes no part in its responses:

- On the card the work runs on a dedicated CUDA stream, which first waits
  on an event recorded on the enqueuing stream at enqueue; a handle's
  result is ready for the caller once its stream has waited on the
  response's done event (:meth:`NativeWorld.synchronize` makes the current
  stream wait on it, the host does not). A fused response packs its
  tensors into one device fusion buffer, launches one collective and
  unpacks. A CUDA tensor never goes through the host, and the executor
  never waits for the card.
- Prescale, the Average divisor and postscale scale as the JAX package's
  ``ScaleBuffer`` (``transport.cc:147``): an integer tensor in float64,
  rounded half away from zero (``collective_ops._scale_``).
- A joined rank contributes zeros to an allreduce, and Average divides by
  the contributing ranks (``controller.cc:286-288``;
  ``HOROVOD_JOIN_FULL_DIVISOR=1`` divides by the set's size). Where the
  JAX package's ring has a rank outside a set contribute the reduction's
  identity, here it takes no part: the set's group gives its members the
  same results.
- With the comms planner on (``ops/comms_planner.py``), a response on the
  global set runs the schedule it plans, on this world's group and its
  own two-level subgroups.
- Each response's data-plane time is one latency sample of the metrics and
  of the comms model (``collective_ops._observe_latency``): the
  collective's own time, never its negotiation. Each tensor's wait from
  enqueue to its response is a ``NEGOTIATE`` span on the timeline
  (``timeline.py``), and ``HOROVOD_TIMELINE_MARK_CYCLES=1`` marks every
  cycle that carried a response.

A failed control plane (a peer died) fails every pending handle with
``HorovodInternalError``, what ``@hvd.elastic.run`` recovers from.
``basics.init()`` forms one such world over every multi-rank world
(``basics.negotiated_world()``) and ``basics.shutdown()`` tears it down.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
SOURCES = ("runtime/logging.cc", "runtime/socketio.cc", "runtime/message.cc",
           "runtime/transport.cc", "runtime/controller.cc",
           "runtime/autotune.cc", "runtime/runtime.cc", "bayes_opt.cc")
HEADERS = ("runtime/common.h", "runtime/logging.h", "runtime/socketio.h",
           "runtime/message.h", "runtime/transport.h",
           "runtime/controller.h", "runtime/autotune.h", "bayes_opt.h")
GXX = "g++"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")

# Enum contracts with csrc/runtime/common.h.
OP_ALLREDUCE, OP_ALLGATHER, OP_BROADCAST, OP_ALLTOALL, OP_REDUCESCATTER, \
    OP_BARRIER, OP_JOIN = range(7)
_REDUCE_MAP = {"sum": 0, "average": 1, "min": 2, "max": 3, "product": 4}
_DTYPE_MAP = {
    torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3,
    torch.uint8: 4, torch.float16: 5, torch.bfloat16: 6, torch.int8: 7,
    torch.int16: 8, torch.bool: 9,
}
_DTYPES = {code: dt for dt, code in _DTYPE_MAP.items()}
_KINDS = {OP_ALLREDUCE: "allreduce", OP_ALLGATHER: "allgather",
          OP_BROADCAST: "broadcast", OP_ALLTOALL: "alltoall",
          OP_REDUCESCATTER: "reducescatter", OP_BARRIER: "barrier"}

# How long a teardown waits for the executor to see the shutdown before it
# ends the star's sockets under it.
SHUTDOWN_WAIT_S = 10.0
# How often the executor reads the CUDA events of the responses it timed.
REAP_EVERY_S = 0.01

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


class NativeRuntimeError(RuntimeError):
    pass


# -- ragged-chunk helpers (the JAX package's runtime/__init__.py:67-103) ------


def pad_chunks(x: torch.Tensor, splits, max_c: int) -> torch.Tensor:
    """Lay out ``x``'s variable-size dim-0 chunks (``splits[j]`` rows each)
    into equal ``max_c``-row slots: slot j = chunk j zero-padded."""
    n = len(splits)
    padded = x.new_zeros((n * max_c,) + tuple(x.shape[1:]))
    off = 0
    for j in range(n):
        c = int(splits[j])
        padded[j * max_c: j * max_c + c] = x[off: off + c]
        off += c
    return padded


def compact_chunks(exchanged: torch.Tensor, received,
                   max_c: int) -> torch.Tensor:
    """Inverse of :func:`pad_chunks`: take the first ``received[j]`` rows
    of each ``max_c``-row slot and concatenate."""
    return torch.cat([exchanged[j * max_c: j * max_c + int(received[j])]
                      for j in range(len(received))], dim=0)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad ``x`` along dim 0 to exactly ``rows`` (no copy when the
    size already matches)."""
    if x.shape[0] == rows:
        return x
    buf = x.new_zeros((rows,) + tuple(x.shape[1:]))
    buf[: x.shape[0]] = x
    return buf


def compact_ranks(gathered: torch.Tensor, sizes) -> torch.Tensor:
    """From a rank-stacked padded gather ``(n, max_rows, ...)``, keep each
    rank's first ``sizes[r]`` rows and concatenate in rank order."""
    return torch.cat([gathered[r, : int(sizes[r])]
                      for r in range(len(sizes))], dim=0)


# -- The library ----------------------------------------------------------------


def build_runtime_library() -> str:
    """Compile the control plane with ``g++`` (once per content of the
    sources, headers and flags) into ``ops/build/`` and return the
    library's path: one ``g++ -c`` per source, all started together, then
    one link. Raises ``RuntimeError`` with the compiler's output if a step
    fails."""
    from ..ops._kernels import BUILD_DIR

    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for rel in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + f.read())
    tag = digest.hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libhvd_runtime_{tag}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        obj_dir = os.path.join(BUILD_DIR, f"runtime_{tag}.{os.getpid()}")
        os.makedirs(obj_dir, exist_ok=True)
        try:
            _compile_and_link(obj_dir, lib_path)
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def _compile_and_link(obj_dir: str, lib_path: str) -> None:
    objs, procs = [], []
    try:
        for rel in SOURCES:
            obj = os.path.join(obj_dir,
                               rel.replace("/", "_").replace(".cc", ".o"))
            objs.append(obj)
            procs.append((rel, subprocess.Popen(
                [GXX, *GXX_FLAGS, "-c", "-o", obj,
                 os.path.join(CSRC_DIR, rel)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    except FileNotFoundError as e:
        for _, proc in procs:
            proc.kill()
            proc.wait()
        raise RuntimeError(
            f"the negotiated runtime needs a C++ compiler: {e}") from e
    failed = []
    for rel, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{rel} (exit code {proc.returncode}):\n"
                          f"{out[-4000:]}")
    if failed:
        raise RuntimeError("g++ failed building the negotiated runtime: "
                           + "\n".join(failed))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([GXX, "-shared", "-pthread", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed linking the negotiated runtime (exit code "
            f"{proc.returncode}):\n{proc.stdout[-6000:]}")
    os.replace(tmp, lib_path)


def load_library() -> ctypes.PyDLL:
    """Load (building at first use) the control plane. The calls that
    return at once (enqueue, counters, ...) keep the GIL (``PyDLL``): a
    hook that enqueues does not hand the GIL to another thread and wait
    to get it back. The calls that block, ``hvdtorch_rt_init`` (the
    bootstrap), ``hvdtorch_rt_next`` (the executor's wait for a cycle's
    responses) and ``hvdtorch_rt_finalize`` (joins the loop), release it:
    they are called through ``lib.blocking`` (a ``CDLL`` of the same
    library)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build_runtime_library()
        lib = ctypes.PyDLL(path)
        lib.blocking = ctypes.CDLL(path)
        I, D, LL = ctypes.c_int, ctypes.c_double, ctypes.c_longlong
        sig = {
            "hvdtorch_rt_init": ([I, I, ctypes.c_char_p, I, D], I),
            "hvdtorch_rt_next": ([D, ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(LL), D], I),
            "hvdtorch_rt_loop_done": ([], I),
            "hvdtorch_rt_request_shutdown": ([], I),
            "hvdtorch_rt_abort": ([], I),
            "hvdtorch_rt_finalize": ([], I),
            "hvdtorch_rt_is_alive": ([], I),
            "hvdtorch_rt_enqueue": ([ctypes.c_char_p, I, I, I, LL, I, D, D,
                                     I], I),
            "hvdtorch_rt_enqueue_group": ([I, ctypes.POINTER(ctypes.c_char_p),
                                           I, I, I, ctypes.POINTER(LL), I, D,
                                           D, ctypes.POINTER(I)], I),
            "hvdtorch_rt_join": ([], I),
            "hvdtorch_rt_join_result": ([], I),
            "hvdtorch_rt_register_process_set": ([ctypes.POINTER(I), I], I),
            "hvdtorch_rt_process_set_members": ([I, ctypes.POINTER(I), I], I),
            "hvdtorch_rt_autotune_state": ([ctypes.POINTER(LL),
                                            ctypes.POINTER(D),
                                            ctypes.POINTER(I)], I),
            "hvdtorch_rt_cache_hits": ([], LL),
            "hvdtorch_rt_cache_misses": ([], LL),
            "hvdtorch_rt_cycles": ([], LL),
            "hvdtorch_rt_last_error": ([], ctypes.c_char_p),
        }
        for name, (argtypes, restype) in sig.items():
            for handle in (lib, lib.blocking):
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
        _lib = lib
        return lib


def _error(lib, what: str) -> Exception:
    """The runtime's last error as the JAX package's binding raises it: a
    failed control plane or a dead runtime is ``HorovodInternalError`` (the
    elastic ladder recovers from it), anything else
    ``NativeRuntimeError``."""
    from ..exceptions import HorovodInternalError

    msg = lib.hvdtorch_rt_last_error().decode(errors="replace")
    if "peer closed" in msg or "control plane" in msg or "dead" in msg:
        return HorovodInternalError(f"{what}: {msg}")
    return NativeRuntimeError(f"{what}: {msg}")


# -- The ResponseList frame (csrc/runtime/message.cc) ---------------------------


class _Response:
    __slots__ = ("op", "reduce_op", "dtype", "active_ranks", "process_set_id",
                 "grouped", "root_rank", "prescale", "postscale", "error",
                 "names", "counts", "handles")


def _parse_frame(frame: bytes) -> tuple[list[_Response], bool]:
    """The responses of one cycle, each with its tensors' local handles,
    and the shutdown flag."""
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, frame, off)
        off += struct.calcsize(fmt)
        return vals

    def string():
        nonlocal off
        (n,) = take("<I")
        s = frame[off:off + n].decode()
        off += n
        return s

    shutdown, n = take("<BI")
    out = []
    for _ in range(n):
        r = _Response()
        (r.op, r.reduce_op, r.dtype, r.active_ranks, r.process_set_id,
         grouped, r.root_rank, r.prescale, r.postscale) = take("<BBBiiBidd")
        r.grouped = bool(grouped)
        r.error = string()
        (k,) = take("<I")
        r.names, r.counts = [], []
        for _ in range(k):
            r.names.append(string())
            r.counts.append(take("<q")[0])
        out.append(r)
    for r in out:
        if r.op == OP_JOIN:
            r.handles = []
            continue
        r.handles = list(take(f"<{len(r.names)}i"))
    return out, bool(shutdown)


# -- The world --------------------------------------------------------------------


class _Entry:
    """One enqueued tensor, from its enqueue to its synchronize."""

    __slots__ = ("name", "input", "output", "stream", "ready", "done",
                 "done_event", "error", "enqueued_us", "planner")

    def __init__(self, name, inp, out):
        self.name = name
        self.input = inp
        self.output = out
        self.stream = None  # the enqueuing CUDA stream
        self.ready = None  # CUDA event on it at the enqueue
        self.done = False  # performed (under the world's condition)
        self.done_event = None  # CUDA event after the response's work
        self.error: Exception | None = None
        self.enqueued_us = None
        self.planner = None  # comms_planner.planner_mode() at the enqueue


class _PlaneSet:
    """The world's group as a process set of the comms planner's schedules:
    every rank, ``group`` the world's own group."""

    process_set_id = 0

    def __init__(self, size: int, rank: int, group):
        self.ranks = list(range(size))
        self._rank = rank
        self.group = group

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        return self._rank


class NativeWorld:
    """One process's membership in the negotiated runtime's world.

    ``NativeWorld(rank, size, coord_addr, coord_port)`` forms the star
    (rank 0 listens on ``coord_port``; ``timeout_s`` bounds the bootstrap)
    and starts the executor. Its data plane is ``group`` (default: a new
    group over every rank of the default one, made by every rank at this
    point) on ``device`` (default: the world's, ``basics.device()``).
    """

    def __init__(self, rank: int, size: int, coord_addr: str,
                 coord_port: int, timeout_s: float = 30.0, device=None,
                 group=None):
        from .. import basics

        self._lib = load_library()
        self.device = torch.device(device) if device is not None \
            else basics.device()
        if group is None:
            group = dist.new_group(list(range(size)))
        self.group = group
        if self._lib.blocking.hvdtorch_rt_init(
                rank, size, coord_addr.encode(), int(coord_port),
                float(timeout_s)) != 0:
            raise _error(self._lib, "native init failed")
        self.rank = rank
        self.size = size
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._entries: dict[int, _Entry] = {}
        self._lock = threading.Lock()
        self._name_counters: dict[int, int] = {}
        self._name_lock = threading.Lock()
        self._members: dict[int, list[int]] = {0: list(range(size))}
        self._groups = {0: group}
        self._fusion: dict[torch.dtype, torch.Tensor] = {}
        self._join_done = threading.Event()
        # Notified whenever the executor finishes entries.
        self._done = threading.Condition()
        # The timeline (None when off), read once a cycle by the executor.
        from ..timeline import get_timeline

        self._tl = get_timeline()
        self._join_error: Exception | None = None
        self._timings: list = []
        self._reaped = 0.0
        # HOROVOD_JOIN_FULL_DIVISOR=1: Average over the set's size even
        # while ranks are joined (the reference reads it once, too).
        self._full_divisor = os.environ.get(
            "HOROVOD_JOIN_FULL_DIVISOR", "") not in ("", "0")
        self._plane = _PlaneSet(size, rank, group)
        self._planner_groups = None
        self._planner_snapshot: dict = {}
        self._plans: dict = {}
        from ..ops import comms_planner

        if size > 1 and comms_planner.enabled():
            # The planner's snapshot and this world's two-level subgroups,
            # made here, where every rank forms the world: the executor
            # never enters a collective of the default group.
            self._planner_snapshot = comms_planner.exchange_snapshot()
            self._planner_groups = comms_planner.plane_two_level_groups()
        self.executor_seconds = 0.0  # host time spent performing responses
        self.responses = 0
        self._executor = threading.Thread(target=self._run, daemon=True,
                                          name="hvd-negotiation")
        self._executor.start()

    # -- lifecycle ---------------------------------------------------------------

    def shutdown(self, wait_s: float | None = None) -> None:
        """Stop the world: every rank's loop sees the shutdown, the
        executor performs the last responses and stops, and handles still
        pending fail. A loop that has not stopped within ``wait_s``
        (default ``SHUTDOWN_WAIT_S``; 0 after a coordinated abort) has the
        star's sockets ended under it."""
        wait_s = SHUTDOWN_WAIT_S if wait_s is None else wait_s
        self._lib.hvdtorch_rt_request_shutdown()
        deadline = time.monotonic() + wait_s
        while not self._lib.hvdtorch_rt_loop_done() and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        if not self._lib.hvdtorch_rt_loop_done():
            self._lib.hvdtorch_rt_abort()
        self._executor.join(SHUTDOWN_WAIT_S)
        self._lib.blocking.hvdtorch_rt_finalize()
        self._fail_all(NativeRuntimeError("runtime shut down"))

    @property
    def alive(self) -> bool:
        """True while the control plane serves and the executor runs."""
        return bool(self._lib.hvdtorch_rt_is_alive()) and \
            self._executor.is_alive()

    @property
    def cache_hits(self) -> int:
        return int(self._lib.hvdtorch_rt_cache_hits())

    @property
    def cache_misses(self) -> int:
        return int(self._lib.hvdtorch_rt_cache_misses())

    @property
    def cycles(self) -> int:
        return int(self._lib.hvdtorch_rt_cycles())

    def autotune_state(self) -> dict:
        """The live knobs: {active, fusion_threshold, cycle_time_ms,
        samples}."""
        thr, cyc, n = ctypes.c_longlong(0), ctypes.c_double(0.0), \
            ctypes.c_int(0)
        rc = self._lib.hvdtorch_rt_autotune_state(
            ctypes.byref(thr), ctypes.byref(cyc), ctypes.byref(n))
        return {"active": rc == 1, "fusion_threshold": int(thr.value),
                "cycle_time_ms": float(cyc.value), "samples": int(n.value)}

    # -- names and sets ------------------------------------------------------------

    def _auto_name(self, prefix: str, process_set_id: int = 0) -> str:
        # Per-set counters: co-members of a set name their ops alike even
        # when their activity on other sets differs.
        with self._name_lock:
            n = self._name_counters.get(process_set_id, 0) + 1
            self._name_counters[process_set_id] = n
        return f"{prefix}.{n}"

    def reserve_name(self, prefix: str, process_set_id: int = 0) -> str:
        """The next auto-name, taken on the calling thread in program
        order (composite ops name their parts before they run)."""
        return self._auto_name(prefix, process_set_id)

    def register_process_set(self, ranks) -> int:
        """Register a subset of ranks; returns its id. Every rank registers
        the same sets in the same order; the same ranks give the same id."""
        ranks = sorted({int(r) for r in ranks})
        arr = (ctypes.c_int * len(ranks))(*ranks)
        set_id = self._lib.hvdtorch_rt_register_process_set(arr, len(ranks))
        if set_id < 0:
            raise _error(self._lib, "register_process_set failed")
        if set_id not in self._members:
            # The set's own group over its ranks: its responses run there,
            # and a rank outside it takes no part in them. Made by every
            # rank at its registration, in one order.
            self._members[set_id] = ranks
            self._groups[set_id] = dist.new_group(ranks)
        return set_id

    def process_set_size(self, process_set_id: int = 0) -> int:
        return len(self._set_members(process_set_id))

    def _set_members(self, process_set_id: int) -> list[int]:
        members = self._members.get(process_set_id)
        if members is None:
            raise NativeRuntimeError(f"unknown process set {process_set_id}")
        return members

    # -- enqueue -------------------------------------------------------------------

    def _prepare(self, x: torch.Tensor, kind: str, out, in_place: bool):
        if x.dtype not in _DTYPE_MAP:
            raise TypeError(
                f"unsupported dtype {x.dtype} for the negotiated runtime")
        if x.device.type != self.device.type:
            raise ValueError(
                f"the negotiated world runs on {self.device.type}; got a "
                f"tensor on {x.device}")
        if in_place:
            if not x.is_contiguous():
                raise ValueError(f"an in-place {kind} needs a contiguous "
                                 "tensor")
        else:
            x = x.contiguous()
        return _Entry(None, x, out)

    def _stamp(self, entry: _Entry) -> None:
        """The enqueue's marks: the enqueuing stream's event (the executor
        waits on it) and the timeline's clock (the NEGOTIATE span)."""
        if self._cuda:
            entry.stream = torch.cuda.current_stream(self.device)
            entry.ready = entry.stream.record_event()
        tl = self._tl
        if tl is not None:
            entry.enqueued_us = tl.now_us()
        if self.size > 1:
            # The planner's mode as the caller set it at this point in
            # its program, the same point on every rank.
            from ..ops.comms_planner import planner_mode

            entry.planner = planner_mode()

    def _enqueue(self, op: int, entry: _Entry, name: str | None,
                 reduce_op: str = "sum", root_rank: int = 0,
                 prescale: float = 1.0, postscale: float = 1.0,
                 process_set_id: int = 0) -> int:
        name = name or self._auto_name("op", process_set_id)
        if process_set_id:
            # One controller keys its state by name: a set's tensors are
            # namespaced, as the JAX package's binding does.
            name = f"ps{process_set_id}/{name}"
        entry.name = name
        x = entry.input
        self._stamp(entry)
        with self._lock:
            handle = self._lib.hvdtorch_rt_enqueue(
                name.encode(), op, _REDUCE_MAP[reduce_op],
                _DTYPE_MAP[x.dtype], x.numel(), root_rank, prescale,
                postscale, process_set_id)
            if handle < 0:
                raise _error(self._lib, "enqueue failed")
            self._entries[handle] = entry
        return handle

    def allreduce_async_(self, x: torch.Tensor, name: str | None = None,
                         op: str = "average", prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set_id: int = 0) -> int:
        """Allreduce ``x`` in place (contiguous); :meth:`synchronize`
        returns ``x``."""
        entry = self._prepare(x, "allreduce", x, in_place=True)
        return self._enqueue(OP_ALLREDUCE, entry, name, op, 0,
                             prescale_factor, postscale_factor,
                             process_set_id)

    def allreduce_async(self, x: torch.Tensor, name: str | None = None,
                        op: str = "average", prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set_id: int = 0) -> int:
        """Out-of-place allreduce: :meth:`synchronize` returns a new
        tensor."""
        entry = self._prepare(x, "allreduce", None, in_place=False)
        entry.output = torch.empty_like(entry.input)
        return self._enqueue(OP_ALLREDUCE, entry, name, op, 0,
                             prescale_factor, postscale_factor,
                             process_set_id)

    def allgather_async(self, x: torch.Tensor, name: str | None = None,
                        process_set_id: int = 0) -> int:
        """Uniform allgather along dim 0 (every member sends the same
        shape)."""
        n = self.process_set_size(process_set_id)
        entry = self._prepare(x, "allgather", None, in_place=False)
        x = entry.input
        entry.output = (x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
                        if x.dim() else x.new_empty((n,)))
        return self._enqueue(OP_ALLGATHER, entry, name,
                             process_set_id=process_set_id)

    def broadcast_async(self, x: torch.Tensor, root_rank: int,
                        name: str | None = None, process_set_id: int = 0,
                        in_place: bool = False) -> int:
        """Every member gets global rank ``root_rank``'s tensor (a new one,
        or ``x`` itself with ``in_place``)."""
        entry = self._prepare(x, "broadcast", None, in_place=in_place)
        entry.output = entry.input if in_place else entry.input.clone()
        return self._enqueue(OP_BROADCAST, entry, name, root_rank=root_rank,
                             process_set_id=process_set_id)

    def alltoall_async(self, x: torch.Tensor, name: str | None = None,
                       process_set_id: int = 0) -> int:
        """Equal-chunk alltoall along dim 0, in set-rank order."""
        n = self.process_set_size(process_set_id)
        entry = self._prepare(x, "alltoall", None, in_place=False)
        x = entry.input
        if x.dim() and x.shape[0] % n != 0:
            raise ValueError(
                f"alltoall dim0 ({x.shape[0]}) must divide by the process "
                f"set size ({n})")
        entry.output = torch.empty_like(x)
        return self._enqueue(OP_ALLTOALL, entry, name,
                             process_set_id=process_set_id)

    def reducescatter_async(self, x: torch.Tensor, name: str | None = None,
                            op: str = "sum", process_set_id: int = 0,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
        """Reduce over the set; member i keeps slice i of dim 0."""
        n = self.process_set_size(process_set_id)
        entry = self._prepare(x, "reducescatter", None, in_place=False)
        x = entry.input
        if x.dim() == 0 or x.shape[0] % n != 0:
            raise ValueError(
                f"reducescatter dim0 ({x.shape[0] if x.dim() else 0}) must "
                f"divide by the process set size ({n})")
        entry.output = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        return self._enqueue(OP_REDUCESCATTER, entry, name, op, 0,
                             prescale_factor, postscale_factor,
                             process_set_id)

    def barrier_async(self, process_set_id: int = 0) -> int:
        token = torch.zeros(1, dtype=torch.int32, device=self.device)
        entry = self._prepare(token, "barrier", token, in_place=True)
        return self._enqueue(OP_BARRIER, entry,
                             self._auto_name("barrier", process_set_id),
                             process_set_id=process_set_id)

    def _grouped_async(self, op_code: int, kind: str, tensors, outputs,
                       name=None, op: str = "average",
                       process_set_id: int = 0, prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> list[int]:
        """Enqueue a list atomically under one group key (GroupTable role):
        the controller schedules it all or nothing, never from the cache.
        One handle per tensor."""
        base = name or self._auto_name("group", process_set_id)
        if process_set_id:
            base = f"ps{process_set_id}/{base}"
        entries = [self._prepare(t, kind, None, in_place=False)
                   for t in tensors]
        for e in entries:
            if e.input.dtype != entries[0].input.dtype:
                raise TypeError(
                    "grouped collectives require a uniform dtype per group "
                    f"(got {e.input.dtype} and {entries[0].input.dtype}); "
                    "split the group")
        n = len(entries)
        names = [f"{base}.{i}" for i in range(n)]
        for e, nm, out in zip(entries, names, outputs(entries)):
            e.name, e.output = nm, out
            self._stamp(e)
        c_names = (ctypes.c_char_p * n)(*[nm.encode() for nm in names])
        c_counts = (ctypes.c_longlong * n)(*[e.input.numel()
                                             for e in entries])
        c_handles = (ctypes.c_int * n)()
        with self._lock:
            rc = self._lib.hvdtorch_rt_enqueue_group(
                n, c_names, op_code, _REDUCE_MAP[op],
                _DTYPE_MAP[entries[0].input.dtype], c_counts,
                process_set_id, prescale_factor, postscale_factor,
                c_handles)
            if rc != 0:
                raise _error(self._lib, "grouped enqueue failed")
            handles = list(c_handles)
            for h, e in zip(handles, entries):
                self._entries[h] = e
        return handles

    def grouped_allreduce_async(self, tensors, name=None, op="average",
                                process_set_id: int = 0,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0) -> list[int]:
        return self._grouped_async(
            OP_ALLREDUCE, "allreduce", tensors,
            lambda es: [torch.empty_like(e.input) for e in es], name, op,
            process_set_id, prescale_factor, postscale_factor)

    def grouped_allgather_async(self, tensors, name=None,
                                process_set_id: int = 0) -> list[int]:
        """Uniform-shape grouped allgather."""
        n = self.process_set_size(process_set_id)
        tensors = [t[None] if t.dim() == 0 else t for t in tensors]
        return self._grouped_async(
            OP_ALLGATHER, "allgather", tensors,
            lambda es: [e.input.new_empty((n * e.input.shape[0],)
                                          + tuple(e.input.shape[1:]))
                        for e in es], name, "sum", process_set_id)

    def grouped_reducescatter_async(self, tensors, name=None, op="average",
                                    process_set_id: int = 0,
                                    prescale_factor: float = 1.0,
                                    postscale_factor: float = 1.0
                                    ) -> list[int]:
        n = self.process_set_size(process_set_id)
        for t in tensors:
            if t.dim() == 0 or t.shape[0] % n != 0:
                raise ValueError(
                    f"reducescatter dim0 must divide by the process set "
                    f"size ({n}); got shape {tuple(t.shape)}")
        return self._grouped_async(
            OP_REDUCESCATTER, "reducescatter", tensors,
            lambda es: [e.input.new_empty((e.input.shape[0] // n,)
                                          + tuple(e.input.shape[1:]))
                        for e in es], name, op, process_set_id,
            prescale_factor, postscale_factor)

    # -- completion ----------------------------------------------------------------

    def poll(self, handle: int) -> bool:
        """Whether the handle's work is done (its result ready)."""
        with self._lock:
            entry = self._entries.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        if not entry.done:
            return False
        return entry.done_event is None or entry.done_event.query()

    def synchronize(self, handle: int, timeout_s: float = 600.0):
        """Wait until the handle's response was performed and return its
        output; on the card the current stream then waits for the work
        (the host does not). Polls the coordinated abort between bounded
        waits; ``timeout_s < 0`` waits without a deadline."""
        from .. import abort

        with self._lock:
            entry = self._entries.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        deadline = (time.monotonic() + timeout_s) if timeout_s >= 0 \
            else None
        chunk = max(0.05, abort.poll_interval())
        with self._done:
            while not self._done.wait_for(
                    lambda: entry.done, chunk if deadline is None else min(
                        chunk, max(deadline - time.monotonic(), 0.0))):
                abort.raise_if_aborted()
                if deadline is not None and time.monotonic() >= deadline:
                    raise NativeRuntimeError(
                        f"synchronize timed out after {timeout_s}s; "
                        f"tensor {entry.name!r} is still pending")
        with self._lock:
            self._entries.pop(handle, None)
        if entry.error is not None:
            raise entry.error
        if entry.done_event is not None:
            torch.cuda.current_stream(self.device).wait_event(
                entry.done_event)
        return entry.output

    def join(self, timeout_s: float = 600.0) -> int:
        """Uneven-data termination (JoinOp): block until every rank has
        joined, serving peers' allreduces with zeros meanwhile, and return
        the last rank to join. Outstanding collectives must be
        synchronized first. A join that timed out is resumed by calling
        again."""
        rc = self._lib.hvdtorch_rt_join()
        if rc < 0:
            raise _error(self._lib, "join failed")
        if rc == 0:
            self._join_error = None
            self._join_done.clear()
        if not self._join_done.wait(timeout_s):
            raise NativeRuntimeError(
                f"join timed out after {timeout_s}s (call join() again to "
                "keep waiting)")
        if self._join_error is not None:
            raise self._join_error
        return int(self._lib.hvdtorch_rt_join_result())

    # -- blocking forms ------------------------------------------------------------

    def allreduce(self, x, name=None, op="average", **kw):
        return self.synchronize(self.allreduce_async(x, name, op=op, **kw))

    def allgather(self, x, name=None, **kw):
        return self.synchronize(self.allgather_async(x, name, **kw))

    def broadcast(self, x, root_rank: int, name=None, **kw):
        return self.synchronize(self.broadcast_async(x, root_rank, name, **kw))

    def alltoall(self, x, name=None, **kw):
        return self.synchronize(self.alltoall_async(x, name, **kw))

    def reducescatter(self, x, name=None, op="sum", **kw):
        return self.synchronize(self.reducescatter_async(x, name, op=op,
                                                         **kw))

    def barrier(self, process_set_id: int = 0) -> None:
        self.synchronize(self.barrier_async(process_set_id))

    def grouped_allreduce(self, tensors, name=None, op="average", **kw):
        return [self.synchronize(h) for h in self.grouped_allreduce_async(
            tensors, name=name, op=op, **kw)]

    def alltoall_v(self, x, splits, name=None, process_set_id: int = 0):
        """Uneven alltoall: chunk j of ``x`` (``splits[j]`` rows) goes to
        member j. Returns ``(out, received_splits)``."""
        x = x[None] if x.dim() == 0 else x
        n = self.process_set_size(process_set_id)
        members = self._set_members(process_set_id)
        splits = [int(s) for s in splits]
        if len(splits) != n or sum(splits) != x.shape[0]:
            raise ValueError(
                f"splits must have {n} entries summing to dim0 "
                f"{x.shape[0]}; got {splits}")
        base = name or self._auto_name("atv", process_set_id)
        table = self.allgather(
            torch.tensor(splits, dtype=torch.int64, device=x.device),
            name=f"{base}.sp", process_set_id=process_set_id)
        table = table.view(n, n).cpu()
        max_c = max(1, int(table.max()))
        exchanged = self.alltoall(pad_chunks(x, splits, max_c),
                                  name=f"{base}.data",
                                  process_set_id=process_set_id)
        received = table[:, members.index(self.rank)]
        return compact_chunks(exchanged, received.tolist(), max_c), received

    # -- the executor ----------------------------------------------------------------

    def _fail_all(self, error: Exception) -> None:
        with self._lock:
            entries = [e for e in self._entries.values() if not e.done]
        self._finish(entries, error)
        if not self._join_done.is_set():
            # A join that completed keeps its result.
            self._join_error = error
            self._join_done.set()

    def _run(self) -> None:
        """The executor: one cycle at a time, each cycle's responses
        performed in broadcast order."""
        from ..exceptions import HorovodInternalError

        if self._cuda:
            torch.cuda.set_device(self.device)
            # This thread's current stream, once: every response's work
            # (and the collectives' waits) runs on it.
            torch.cuda.set_stream(self._stream)
        from ..timeline import get_timeline

        frame_ptr = ctypes.c_void_p()
        frame_len = ctypes.c_longlong()
        last_exec = 0.0
        while True:
            rc = self._lib.blocking.hvdtorch_rt_next(
                last_exec, ctypes.byref(frame_ptr), ctypes.byref(frame_len),
                REAP_EVERY_S)
            last_exec = 0.0
            if rc == 2:  # no response within the interval
                self._reap_timings()
                continue
            if rc < 0:
                err = _error(self._lib, "negotiation failed")
                if not isinstance(err, HorovodInternalError):
                    err = HorovodInternalError(str(err))
                self._fail_all(err)
                return
            responses, _ = _parse_frame(
                ctypes.string_at(frame_ptr, frame_len.value))
            self._tl = get_timeline()
            t0 = time.perf_counter()
            for resp in responses:
                self._perform(resp)
            last_exec = time.perf_counter() - t0
            self.executor_seconds += last_exec
            self.responses += len(responses)
            if responses:
                from ..timeline import mark_cycle

                mark_cycle("cycle")
            if time.perf_counter() - self._reaped > REAP_EVERY_S:
                self._reap_timings()
            if rc == 1:
                self._reap_timings(wait=True)
                self._fail_all(NativeRuntimeError("runtime shut down"))
                return

    def _perform(self, resp: _Response) -> None:
        if resp.op == OP_JOIN:
            self._join_done.set()
            return
        with self._lock:
            entries = [self._entries.get(h) if h >= 0 else None
                       for h in resp.handles]
        tl = self._tl
        if tl is not None:
            for e in entries:
                if e is not None and e.enqueued_us is not None:
                    tl.complete("NEGOTIATE", "negotiation", e.enqueued_us,
                                {"tensor": e.name})
        if resp.error:
            self._finish(entries, NativeRuntimeError(resp.error))
            return
        try:
            if self._cuda:
                # No record_stream: an entry holds its tensors until its
                # synchronize, which makes the caller's stream wait for
                # this work first, so the caller frees them after it.
                # Events on one stream complete in order: wait on the
                # latest enqueue's (the highest handle) of each stream.
                latest = {}
                for h, e in zip(resp.handles, entries):
                    if e is not None:
                        key = e.stream.cuda_stream
                        if key not in latest or h > latest[key][0]:
                            latest[key] = (h, e.ready)
                for _, ready in latest.values():
                    self._stream.wait_event(ready)
                self._timed(resp, entries)
                done = self._stream.record_event()
                for e in entries:
                    if e is not None:
                        e.done_event = done
            else:
                self._timed(resp, entries)
        except Exception as exc:  # noqa: BLE001 — the handles carry it
            from .. import basics
            from ..exceptions import HorovodInternalError

            if basics.elastic() and not isinstance(exc, HorovodInternalError):
                exc = HorovodInternalError(f"collective failed: {exc}")
            self._finish(entries, exc)
            return
        self._finish(entries, None)

    def _finish(self, entries, error) -> None:
        with self._done:
            for e in entries:
                if e is not None:
                    e.error = error
                    e.done = True
            self._done.notify_all()

    def _timed(self, resp: _Response, entries) -> None:
        """Perform one response, its data-plane time one latency sample
        (``collective_ops._observe_latency``; on the card two CUDA events
        around the work, read once the second has completed)."""
        kind = _KINDS[resp.op]
        nbytes = self.process_set_size(resp.process_set_id) * sum(
            c * _elem_size(resp.dtype) for c in resp.counts)
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            algorithm = self._dispatch(resp, entries)
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self._timings.append((start, end, kind, nbytes, algorithm,
                                  resp.process_set_id))
        else:
            t0 = time.perf_counter()
            algorithm = self._dispatch(resp, entries)
            self._observe(kind, time.perf_counter() - t0, nbytes, algorithm,
                          resp.process_set_id)

    def _observe(self, kind, seconds, nbytes, algorithm, process_set_id):
        from .. import basics
        from ..ops.collective_ops import _observe_latency

        topo = basics._state.topology
        link = (topo.set_link_class(self._set_members(process_set_id))
                if topo is not None else None)
        _observe_latency(kind, seconds, nbytes, link, algorithm)

    def _reap_timings(self, wait: bool = False) -> None:
        self._reaped = time.perf_counter()
        keep = []
        for item in self._timings:
            start, end = item[0], item[1]
            if wait:
                end.synchronize()
            if end.query():
                self._observe(item[2], start.elapsed_time(end) / 1e3,
                              *item[3:])
            else:
                keep.append(item)
        self._timings = keep

    def _dispatch(self, resp: _Response, entries) -> str:
        """Perform one response on the group of its set (the world's for
        set 0); a rank outside the set has nothing to do."""
        members = self._set_members(resp.process_set_id)
        if self.rank not in members:
            return "flat"
        group = self._groups[resp.process_set_id]
        op = resp.op
        if op == OP_ALLREDUCE:
            return self._allreduce(resp, entries, group)
        if op == OP_BARRIER:
            token = torch.zeros(1, dtype=torch.int32, device=self.device)
            self._wait(dist.all_reduce(token, group=group, async_op=True))
            return "flat"
        # Only an allreduce composes with joined ranks (the controller
        # fails the others), so the member has its tensor.
        e = entries[0]
        m = len(members)
        inp = e.input.view(-1)
        out = e.output.view(-1)
        if op == OP_ALLGATHER:
            plan = self._plan("allgather", resp, entries, m * inp.numel())
            if plan is not None:
                out.copy_(self._planned("apply_allgather_row", plan, inp))
                return plan.algorithm
            self._all_gather(out, inp, group)
        elif op == OP_BROADCAST:
            self._wait(dist.broadcast(out, src=resp.root_rank, group=group,
                                      async_op=True))
        elif op == OP_ALLTOALL:
            plan = self._plan("alltoall", resp, entries, m * inp.numel())
            if plan is not None:
                out.copy_(self._planned("apply_alltoall", plan, inp))
                return plan.algorithm
            self._wait(dist.all_to_all_single(out, inp, group=group,
                                              async_op=True))
        elif op == OP_REDUCESCATTER:
            return self._reducescatter(resp, e, members, group)
        return "flat"

    def _plan(self, op: str, resp: _Response, entries, elements: int):
        """The comms planner's plan of a response on the global set (the
        set's payload, as the eager ops price it), or None: flat. Its mode
        is the one its first tensor was enqueued under."""
        if resp.process_set_id != 0 or self.size < 2:
            return None
        from ..ops import comms_planner

        mode = next((e.planner for e in entries if e is not None),
                    comms_planner.planner_mode())
        op_name = _OP_NAMES[resp.reduce_op] if op in (
            "allreduce", "reducescatter") else None
        nbytes = elements * _elem_size(resp.dtype)
        key = (op, nbytes, op_name, mode)
        if key not in self._plans:
            self._plans[key] = comms_planner.plane_plan(
                op, nbytes, self._plane, op_name, self._planner_snapshot,
                mode)
        plan = self._plans[key]
        if plan is None:
            return None
        comms_planner.note_dispatch(op, plan.algorithm)
        return None if plan.algorithm == "flat" else plan

    def _planned(self, schedule: str, plan, x):
        """Run the plan's schedule (``comms_planner.<schedule>``) on this
        world's group."""
        from ..ops import comms_planner

        with comms_planner.on_plane(self.group, self._planner_groups):
            return getattr(comms_planner, schedule)(plan, x, self._plane)

    def _wait(self, work) -> None:
        from ..ops.collective_ops import wait

        wait(work)

    def _all_gather(self, out, inp, group) -> None:
        from ..ops.collective_ops import _all_gather

        self._wait(_all_gather(out, inp, group=group, async_op=True))

    def _reducescatter(self, resp, e, members, group) -> str:
        from ..ops.collective_ops import (_TORCH_OPS, _average_and_postscale_,
                                          _reduce_scatter, _scale_)

        op_name = _OP_NAMES[resp.reduce_op]
        torch_op = _TORCH_OPS["sum" if op_name == "average" else op_name]
        m = len(members)
        inp = e.input.view(-1).clone()
        _scale_(inp, resp.prescale)
        count = inp.numel()
        plan = self._plan("reducescatter", resp, [e], m * count) \
            if op_name in ("sum", "average") else None
        if plan is not None:
            out = self._planned("apply_reducescatter_sum", plan, inp)
        elif self._cuda:
            out = inp.new_empty(count // m)
            self._wait(_reduce_scatter(out, inp, op=torch_op, group=group,
                                       async_op=True))
        else:
            # gloo's reduce-scatter work never reports completion: an
            # allreduce of the whole tensor and this member's slice.
            self._wait(dist.all_reduce(inp, op=torch_op, group=group,
                                       async_op=True))
            out = inp.view(m, count // m)[members.index(self.rank)]
        _average_and_postscale_(out, op_name, resp.postscale, m)
        e.output.view(-1).copy_(out)
        return "flat" if plan is None else plan.algorithm

    def _fusion_buffer(self, dtype, count: int) -> torch.Tensor:
        buf = self._fusion.get(dtype)
        if buf is None or buf.numel() < count:
            buf = torch.empty(count, dtype=dtype, device=self.device)
            self._fusion[dtype] = buf
        return buf[:count]

    def _allreduce(self, resp: _Response, entries, group) -> str:
        from ..ops.collective_ops import _TORCH_OPS, _scale_

        op_name = _OP_NAMES[resp.reduce_op]
        dtype = _DTYPES[resp.dtype]
        total = sum(resp.counts)
        full = self.process_set_size(resp.process_set_id)
        active = resp.active_ranks if (resp.active_ranks > 0
                                       and not self._full_divisor) else full

        def contribution(e, count):
            # A member without the tensor has joined: zeros, even to Min
            # and Max (the reference's caveat).
            return e.input.view(-1) if e is not None else torch.zeros(
                count, dtype=dtype, device=self.device)

        single = len(entries) == 1
        if single:
            e = entries[0]
            buf = e.output.view(-1) if e is not None else \
                contribution(None, total)
            if e is not None and e.output is not e.input:
                buf.copy_(e.input.view(-1))
            _scale_(buf, resp.prescale)
        else:
            buf = self._fusion_buffer(dtype, total)
            torch.cat([contribution(e, c)
                       for e, c in zip(entries, resp.counts)], out=buf)
            if resp.prescale != 1.0:
                # The stand-ins of absent tensors are not scaled, as the
                # reference scales only the entries it packs.
                for e, part in zip(entries, buf.split(resp.counts)):
                    if e is not None:
                        _scale_(part, resp.prescale)
        algorithm = "flat"
        plan = self._plan("allreduce", resp, entries, self.size * total) \
            if op_name in ("sum", "average") else None
        if plan is not None:
            buf.copy_(self._planned("apply_allreduce_sum", plan, buf))
            algorithm = plan.algorithm
        else:
            torch_op = _TORCH_OPS["sum" if op_name == "average" else op_name]
            self._wait(dist.all_reduce(buf, op=torch_op, group=group,
                                       async_op=True))
        if op_name == "average":
            _scale_(buf, 1.0 / active)
        if single:
            e = entries[0]
            if e is not None:
                _scale_(e.output, resp.postscale)
        else:
            pairs = [(e.output.view(-1), part) for e, part in
                     zip(entries, buf.split(resp.counts)) if e is not None]
            if pairs:
                outs = [o for o, _ in pairs]
                torch._foreach_copy_(outs, [p for _, p in pairs])
                for out in outs:
                    _scale_(out, resp.postscale)
        return algorithm


_OP_NAMES = {v: k for k, v in _REDUCE_MAP.items()}


_ELEM_SIZE = {code: torch.empty((), dtype=dt).element_size()
              for code, dt in _DTYPES.items()}


def _elem_size(code: int) -> int:
    return _ELEM_SIZE[code]
