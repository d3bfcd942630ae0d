"""Autotuning of the gradient wire: the fusion threshold, the sync mode and
the comms planner's algorithm.

Port of ``horovod_tpu/autotune.py``: the pin state (:85-258), the
transparent warmup tuner :class:`AutotuneStep` and
:func:`maybe_autotune_step` (:270-695), :func:`tune_step_sync_mode`
(:698), :func:`tune_step_fusion` (:824), and the Bayesian optimizer's
wrapper :class:`BayesianTuner` with :func:`tune_fusion_threshold`
(:29-75, :914-952).

The Bayesian optimizer is host code: ``csrc/bayes_opt.cc``, a copy of the
JAX package's native one (``horovod_tpu/runtime/cpp/autotune.cc`` and its
``hvdrt_bo_*`` C interface), built with ``g++`` at first use into the
git-ignored ``ops/build/`` beside the CUDA kernels (under the same file
lock) and loaded with ``ctypes``. A build that fails raises.

Where the JAX package's tuner re-traces its jitted step
(``clear_cache()``), the port's re-buckets the step's
``DistributedOptimizer``: a step built by ``make_train_step`` carries the
optimizer's ``rebucket`` method, which re-derives the buckets from the
pinned threshold at the next step boundary (``optimizer.py``). A window's
time ends in one host read of the step's smallest output tensor (the
loss), so a window pays one synchronization, not one per call.

Left out: the 2-D mesh-shape pin (``tuned_mesh_shape``) waits for a port
of ``parallel/mesh.py``; the segments axis has its pin, which
``ops.fusion.overlap_segments`` reads, but no factory passes segment
candidates until the overlapped step is ported. The negotiated runtime's
online ``ParameterManager`` (its cycle time and fusion threshold) is C++
in ``csrc/runtime/autotune.cc``, armed by the same ``HOROVOD_AUTOTUNE=1``
(``runtime.NativeWorld.autotune_state()``), on this module's Gaussian
process: ``csrc/bayes_opt.h`` declares it for both libraries.

Stdlib at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Any, Callable, Sequence

from .utils.logging import get_logger

_HERE = os.path.dirname(os.path.abspath(__file__))
BAYES_SOURCE = os.path.join(_HERE, "csrc", "bayes_opt.cc")
BAYES_HEADER = os.path.join(_HERE, "csrc", "bayes_opt.h")
GXX = "g++"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_bayes_lock = threading.Lock()
_bayes_lib: ctypes.CDLL | None = None


def build_bayes_library() -> str:
    """Compile ``csrc/bayes_opt.cc`` with ``g++`` (once per content of the
    source and flags) into ``ops/build/`` and return the library's path.
    Raises ``RuntimeError`` with the compiler's output if the build
    fails."""
    from .ops._kernels import BUILD_DIR

    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in (BAYES_SOURCE, BAYES_HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR,
                            f"libhvd_bayes_{digest.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [GXX, *GXX_FLAGS, "-o", tmp, BAYES_SOURCE]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"the Bayesian optimizer needs a C++ compiler: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode} building "
                f"{BAYES_SOURCE}:\n{proc.stdout[-6000:]}")
        os.replace(tmp, lib_path)
    return lib_path


def _bayes_library() -> ctypes.CDLL:
    global _bayes_lib
    with _bayes_lock:
        if _bayes_lib is None:
            lib = ctypes.CDLL(build_bayes_library())
            dbl = ctypes.POINTER(ctypes.c_double)
            lib.hvd_bo_new.restype = ctypes.c_int
            lib.hvd_bo_new.argtypes = [ctypes.c_int, dbl, dbl,
                                       ctypes.c_longlong]
            lib.hvd_bo_add.restype = ctypes.c_int
            lib.hvd_bo_add.argtypes = [ctypes.c_int, dbl, ctypes.c_int,
                                       ctypes.c_double]
            lib.hvd_bo_suggest.restype = ctypes.c_int
            lib.hvd_bo_suggest.argtypes = [ctypes.c_int, dbl, ctypes.c_int]
            lib.hvd_bo_best.restype = ctypes.c_double
            lib.hvd_bo_best.argtypes = [ctypes.c_int, dbl, ctypes.c_int]
            lib.hvd_bo_free.restype = ctypes.c_int
            lib.hvd_bo_free.argtypes = [ctypes.c_int]
            _bayes_lib = lib
        return _bayes_lib


class BayesianTuner:
    """ctypes wrapper over the GP/EI optimizer (maximizes the score)."""

    def __init__(self, lows: Sequence[float], highs: Sequence[float],
                 seed: int = 42):
        self._lib = _bayes_library()
        self._dims = len(lows)
        arr = ctypes.c_double * self._dims
        self._id = self._lib.hvd_bo_new(self._dims, arr(*lows), arr(*highs),
                                        seed)

    def add_sample(self, params: Sequence[float], score: float) -> None:
        arr = (ctypes.c_double * self._dims)(*params)
        if self._lib.hvd_bo_add(self._id, arr, self._dims, score) != 0:
            raise RuntimeError("BO add_sample failed")

    def suggest(self) -> list[float]:
        out = (ctypes.c_double * self._dims)()
        if self._lib.hvd_bo_suggest(self._id, out, self._dims) != 0:
            raise RuntimeError("BO suggest failed")
        return list(out)

    def best(self) -> tuple[list[float], float]:
        out = (ctypes.c_double * self._dims)()
        score = self._lib.hvd_bo_best(self._id, out, self._dims)
        return list(out), score

    def close(self) -> None:
        self._lib.hvd_bo_free(self._id)


# -- The pins -----------------------------------------------------------------

_tuned: dict = {"threshold": None, "segments": None, "sync_mode": None,
                "algorithm": None, "aborted": False, "history": [],
                "pruned": []}


def reset_for_testing() -> None:
    """Clear every pin, the abort poison, the history and the live tuner."""
    _tuned.update(threshold=None, segments=None, sync_mode=None,
                  algorithm=None, aborted=False, history=[], pruned=[])
    _active_tuner.clear()


def _get_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def model_guided_enabled() -> bool:
    """Model-guided autotune (``HOROVOD_AUTOTUNE_MODEL_GUIDED=1``): after
    the first window the tuner prices every grid candidate with the
    fitted alpha-beta model (``comms_model.prune_candidates``) and drops
    the dominated ones. Off by default, and inert while the model has no
    ready fit or no noted leaf layout."""
    return _get_bool("HOROVOD_AUTOTUNE_MODEL_GUIDED", False)


def _record_trial(tunable: str, seconds: float) -> None:
    """One completed sampling window on the metrics plane
    (``hvd_autotune_trials_total``, ``hvd_autotune_trial_seconds``)."""
    try:
        from . import metrics

        metrics.AUTOTUNE_TRIALS.inc(tunable=tunable)
        metrics.AUTOTUNE_TRIAL_SECONDS.observe(seconds)
    except Exception:  # noqa: BLE001 — instrumentation is best-effort
        pass


def warmup_aborted() -> bool:
    """True after a mid-warmup abort in this process: peers may have
    pinned another (broadcast) decision, so every factory-built step here
    refuses to run (``parallel.data_parallel._StallWatchedStep``)."""
    return _tuned["aborted"]


def _poison_error():
    from .exceptions import HorovodInternalError

    return HorovodInternalError(
        "autotune warmup aborted on this rank; peers may have pinned a "
        "different (broadcast) decision, so this process's traced "
        "collective sequences can no longer be trusted to match theirs "
        "— treat the original mid-warmup exception as fatal and restart "
        "the job")


def tuned_threshold() -> int | None:
    """The pinned fusion threshold (None: untuned, the env rules)."""
    return _tuned["threshold"]


def set_tuned_threshold(threshold_bytes: int | None) -> None:
    """Pin (or clear, with None) the fusion threshold. Wins over
    ``HOROVOD_FUSION_THRESHOLD`` in ``ops.fusion.fusion_threshold_bytes``;
    an optimizer built without an explicit ``fusion_threshold_bytes``
    takes it when it re-buckets."""
    _tuned["threshold"] = (
        None if threshold_bytes is None else int(threshold_bytes))


def tuned_segments() -> int | None:
    """The pinned overlap segment count (None: untuned)."""
    return _tuned["segments"]


def set_tuned_segments(num_segments: int | None) -> None:
    """Pin (or clear, with None) the segment count. Wins over
    ``HOROVOD_OVERLAP_SEGMENTS`` in ``ops.fusion.overlap_segments``."""
    _tuned["segments"] = None if num_segments is None else int(num_segments)


def tuned_algorithm() -> str | None:
    """The pinned comms-planner algorithm (None: untuned, the planner
    prices per bucket). ``"auto"`` records that the sweep chose the
    per-bucket pricing; the planner treats it as no pin."""
    return _tuned["algorithm"]


def set_tuned_algorithm(algorithm: str | None) -> None:
    """Pin (or clear, with None) the planner's algorithm; wins over the
    per-bucket pricing in ``ops.comms_planner.plan_bucket``."""
    if algorithm is not None and algorithm != "auto":
        from .ops.comms_planner import PLANNER_ALGORITHMS

        if algorithm not in PLANNER_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; expected one of "
                f"{PLANNER_ALGORITHMS + ('auto',)}")
    _tuned["algorithm"] = algorithm


def tuned_sync_mode() -> str | None:
    """The pinned sync mode (None: untuned). Read by
    ``optimizer.resolve_sync_mode`` when a ``DistributedOptimizer`` is
    built: the mode fixes the state's layout, so a pin affects only
    optimizers built after it."""
    return _tuned["sync_mode"]


def set_tuned_sync_mode(sync_mode: str | None) -> None:
    """Pin (or clear, with None) the sync mode; wins over
    ``HOROVOD_SYNC_MODE`` in ``optimizer.resolve_sync_mode``."""
    if sync_mode is not None:
        from .optimizer import _VALID_SYNC_MODES

        if sync_mode not in _VALID_SYNC_MODES:
            raise ValueError(
                f"unknown sync_mode {sync_mode!r}; expected one of "
                f"{_VALID_SYNC_MODES}")
    _tuned["sync_mode"] = sync_mode


def autotune_state() -> dict:
    """The live threshold, the pins, and the measured (candidate,
    seconds a step) samples."""
    from .ops.fusion import fusion_threshold_bytes

    return {
        "active": _tuned["threshold"] is not None,
        "fusion_threshold": fusion_threshold_bytes(),
        "overlap_segments": _tuned["segments"],
        "sync_mode": _tuned["sync_mode"],
        "algorithm": _tuned["algorithm"],
        "samples": len(_tuned["history"]),
        "history": list(_tuned["history"]),
        "pruned": list(_tuned["pruned"]),
    }


DEFAULT_THRESHOLDS = (256 * 1024, 4 * 1024 * 1024, 64 * 1024 * 1024)

# Candidate segment counts of the joint (threshold, segments) grid.
DEFAULT_SEGMENT_CANDIDATES = (2, 4, 8)


def _world_size() -> int:
    from . import basics

    return basics.size() if basics.is_initialized() else 1


def _world_rank() -> int:
    from . import basics

    return basics.rank() if basics.is_initialized() else 0


def _broadcast(decision, name: str):
    """Rank 0's value everywhere; a one-process world passes through."""
    if _world_size() > 1:
        from .functions import broadcast_object

        return broadcast_object(decision, name=name)
    return decision


def _fetch_probe(out) -> None:
    """One host read of ``out``'s smallest tensor (the loss): the work
    queued before it has run. Without a tensor, wait for the stream."""
    import torch

    leaves = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(out)
    if not leaves:
        from . import basics

        basics.sync_stream()
        return
    probe = min(leaves, key=lambda t: t.numel())
    probe.detach().reshape(-1)[:1].cpu()


def _retrace(step) -> None:
    """The port's ``clear_cache()``: re-bucket the step's optimizer from
    the pins (``rebucket``, which ``make_train_step`` attaches to the
    steps it builds; a callable without one has nothing to re-derive)."""
    rebucket = getattr(step, "rebucket", None)
    if rebucket is not None:
        rebucket()


class AutotuneStep:
    """Transparent warmup tuning of a factory-built train step (the
    consumer of ``HOROVOD_AUTOTUNE=1``).

    The first ``len(candidates) * (1 + iters)`` real training calls are
    sampling windows: each window's first call pins its candidate,
    re-buckets the step's optimizer (:func:`_retrace`) and settles; the
    next ``iters`` calls are timed, ending in one host read of the loss.
    Every call returns its real result. After the last window the
    fastest candidate (rank 0's, broadcast) is pinned, logged (and
    appended to ``HOROVOD_AUTOTUNE_LOG`` as a JSON line by rank 0), and
    the wrapper becomes a passthrough. With ``sync_mode_candidates`` or
    ``algorithm_candidates`` (the comms planner's, when it runs ``auto``)
    the grid is the joint product, pinned together.

    Model-guided pruning (``HOROVOD_AUTOTUNE_MODEL_GUIDED=1``, and the
    memory guard ``HOROVOD_AUTOTUNE_MEMORY_GUARD=1``): after the first
    window, dominated candidates are dropped; the kept list is rank 0's,
    broadcast. A window that raises pins the first candidate on this
    rank and poisons the process (:func:`warmup_aborted`).
    """

    def __init__(self, fn, thresholds=None, iters: int = 3, clock=None,
                 segment_candidates=None, sync_mode_candidates=None,
                 algorithm_candidates=None):
        import time as _time

        self._fn = fn
        self._tune_segments = segment_candidates is not None
        self._tune_sync = sync_mode_candidates is not None
        self._tune_algorithm = algorithm_candidates is not None
        if self._tune_segments or self._tune_sync or self._tune_algorithm:
            self._cands = [
                (int(t),)
                + ((int(s),) if self._tune_segments else ())
                + ((str(m),) if self._tune_sync else ())
                + ((str(a),) if self._tune_algorithm else ())
                for a in (algorithm_candidates or (None,))
                for m in (sync_mode_candidates or (None,))
                for s in (segment_candidates or (None,))
                for t in (thresholds or DEFAULT_THRESHOLDS)
            ]
        else:
            self._cands = list(thresholds or DEFAULT_THRESHOLDS)
        self._poisoned = False
        self._prune_checked = False
        self._iters = max(1, int(iters))
        self._win = 1 + self._iters  # one settle call, then timed calls
        self._calls = 0
        self._samples: list[tuple[Any, float]] = []
        self._t0 = 0.0
        self._clock = clock or _time.perf_counter  # tests inject a clock
        self._co_steps: list = []  # steps built mid-warmup
        self._hvd_tuning = True  # the stall watch defers while tuning

    def _axes_name(self) -> str:
        axes = ["fusion_threshold_bytes"]
        if self._tune_segments:
            axes.append("overlap_segments")
        if self._tune_sync:
            axes.append("sync_mode")
        if self._tune_algorithm:
            axes.append("algorithm")
        return "+".join(axes)

    def _maybe_prune(self) -> None:
        """Model-guided pruning, once, after the first window (see the
        class docstring). Rank-local pricing may fail (then no pruning);
        the broadcast of rank 0's kept list may not: it raises."""
        if self._prune_checked:
            return
        self._prune_checked = True
        from . import memory as _memory

        if not model_guided_enabled() and not _memory.memory_guard_enabled():
            return
        kept_idx = None
        try:
            from . import comms_model

            model = comms_model.get_model()
            leaf_sizes = model.leaf_sizes()
            kept_list = list(self._cands[1:])
            did_filter = False
            if (model_guided_enabled() and model.ready() and leaf_sizes
                    and len(self._cands) > 1):
                from .ops.collective_ops import _link_class
                from .process_sets import global_process_set

                verdict = comms_model.prune_candidates(
                    kept_list, leaf_sizes, _link_class(global_process_set))
                kept_list = verdict["kept"]
                did_filter = True
            if _memory.memory_guard_enabled() and len(self._cands) > 1:
                mem_verdict = _memory.filter_candidates(kept_list)
                if mem_verdict["pruned"]:
                    get_logger().info(
                        "autotune: memory guard rejected %d candidate(s) "
                        "over HBM capacity: %s",
                        len(mem_verdict["pruned"]), mem_verdict["pruned"])
                    kept_list = mem_verdict["kept"]
                    did_filter = True
            if did_filter:
                # kept is an order-preserving subsequence of the tail.
                kept_idx = []
                ki = 0
                for i, c in enumerate(self._cands[1:]):
                    if ki < len(kept_list) and kept_list[ki] == c:
                        kept_idx.append(i)
                        ki += 1
        except Exception as e:  # noqa: BLE001 — pricing is an optimization
            get_logger().debug("autotune: model-guided pricing skipped: %s",
                               e)
            kept_idx = None
        kept_idx = _broadcast(kept_idx, "autotune/model-guided-prune")
        if kept_idx is None:
            return
        tail = list(self._cands[1:])
        pruned = [c for i, c in enumerate(tail) if i not in kept_idx]
        if not pruned:
            return
        self._cands = [self._cands[0]] + [
            tail[i] for i in kept_idx if 0 <= i < len(tail)]
        _tuned["pruned"].extend(pruned)
        get_logger().info(
            "autotune: model-guided pruning dropped %d dominated "
            "candidate(s) %s; sweeping %d of the original grid",
            len(pruned), pruned, len(self._cands))

    def _pin(self, cand) -> None:
        if not (self._tune_segments or self._tune_sync
                or self._tune_algorithm):
            set_tuned_threshold(cand)
            return
        cand = tuple(cand)
        set_tuned_threshold(cand[0])
        i = 1
        if self._tune_segments:
            set_tuned_segments(cand[i])
            i += 1
        if self._tune_sync:
            set_tuned_sync_mode(cand[i])
            i += 1
        if self._tune_algorithm:
            set_tuned_algorithm(cand[i])

    def _retrace_all(self, last=True) -> None:
        if last:
            _retrace(self._fn)
        for co in self._co_steps:
            _retrace(co)
        self._co_steps.clear()

    def _finish(self) -> None:
        import json

        best = min(self._samples, key=lambda s: s[1])
        decision = best[0]
        if isinstance(decision, tuple):
            decision = tuple(
                x if isinstance(x, str) else int(x) for x in decision)
        else:
            decision = int(decision)
        decision = _broadcast(decision, "autotune/step-decision")
        self._pin(decision)
        _tuned["history"].extend(self._samples)
        # The optimizer holds the last candidate's buckets; only another
        # winner needs a re-bucket.
        self._retrace_all(last=decision != self._cands[-1])
        self._hvd_tuning = False
        log = get_logger()
        log.info(
            "autotune: pinned %s=%s after %d warmup windows %s",
            self._axes_name(), decision, len(self._samples),
            [(t, round(s, 5)) for t, s in self._samples])
        path = os.environ.get("HOROVOD_AUTOTUNE_LOG", "")
        # One writer: the decision is rank 0's anyway.
        if path and _world_rank() == 0:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps({
                        "tunable": self._axes_name(),
                        "decision": decision,
                        "samples": self._samples,
                    }) + "\n")
            except OSError:
                log.warning("autotune: cannot write HOROVOD_AUTOTUNE_LOG=%s",
                            path)

    def _abort(self) -> None:
        """A window (or the finish exchange) raised: pin the first
        candidate (rank-identical with no exchange), stop tuning and
        poison the process; the original exception goes on up."""
        decision = self._cands[0]
        self._pin(decision)
        self._poisoned = True
        _tuned["aborted"] = True
        self._retrace_all()
        self._hvd_tuning = False
        get_logger().warning(
            "autotune: aborted mid-warmup after %d sample(s); pinned the "
            "rank-identical first candidate %s and poisoned the tuned "
            "step (further calls raise)", len(self._samples), decision)

    def __call__(self, *args, **kwargs):
        if self._poisoned or warmup_aborted():
            raise _poison_error()
        if not self._hvd_tuning:
            return self._fn(*args, **kwargs)
        idx, pos = divmod(self._calls, self._win)
        self._calls += 1
        try:
            if pos == 0:
                # Window start: pin the candidate and re-bucket; the call
                # settles, and the timing starts after its read.
                self._pin(self._cands[idx])
                _retrace(self._fn)
                out = self._fn(*args, **kwargs)
                _fetch_probe(out)
                self._t0 = self._clock()
                return out
            out = self._fn(*args, **kwargs)
            if pos == self._win - 1:
                _fetch_probe(out)
                dt = (self._clock() - self._t0) / self._iters
                self._samples.append((self._cands[idx], dt))
                _record_trial(self._axes_name(), dt)
                if idx == 0:
                    self._maybe_prune()
                if idx + 1 == len(self._cands):
                    self._finish()
            return out
        except Exception:
            self._abort()
            raise

    def __getattr__(self, item):
        if item == "_fn":  # lookup before __init__ must not recurse
            raise AttributeError(item)
        return getattr(self._fn, item)


_active_tuner: list = []  # at most one warmup tuner per process


def maybe_autotune_step(fn, segment_candidates=None,
                        sync_mode_candidates=None,
                        algorithm_candidates=None):
    """Wrap ``fn`` in :class:`AutotuneStep` when ``HOROVOD_AUTOTUNE=1``
    and nothing is pinned yet. One tuner per process: a step built while
    one tunes passes through bare and is re-bucketed when the winner is
    pinned."""
    if not _get_bool("HOROVOD_AUTOTUNE") or tuned_threshold() is not None:
        return fn
    if _active_tuner and _active_tuner[0]._hvd_tuning:
        _active_tuner[0]._co_steps.append(fn)
        return fn
    tuner = AutotuneStep(fn, segment_candidates=segment_candidates,
                         sync_mode_candidates=sync_mode_candidates,
                         algorithm_candidates=algorithm_candidates)
    _active_tuner[:] = [tuner]
    return tuner


def tune_step_sync_mode(
    build_step: Callable[[str], Callable[[], Any]],
    sync_modes: Sequence[str] = ("allreduce", "sharded", "fsdp"),
    iters: int = 3,
) -> str:
    """Explicit warmup tuning of the sync mode: ``build_step(mode)``
    builds the whole (optimizer, step) for a mode and returns a
    zero-argument callable that runs one step. Each mode runs one
    settle call and ``iters`` timed calls (ended by one host read of the
    output). A mode whose build or settle raises
    ``SyncModeIneligibleError`` (the guard tables, the memory guard) is
    skipped on every rank alike; another exception pins the first
    eligible mode and goes on up. The fastest mode on rank 0 is pinned
    on every rank (:func:`set_tuned_sync_mode`, after a broadcast) and
    returned. The JAX package pins each rank's own fastest, so ranks that
    time differently build optimizers of different modes and their
    collectives no longer match; the port pins rank 0's, as
    :class:`AutotuneStep` pins its winner."""
    import time as _time

    from . import memory as _memory
    from .exceptions import SyncModeIneligibleError

    log = get_logger()
    grid = list(sync_modes)
    results: list[tuple[str, float]] = []
    skipped: set[str] = set()
    try:
        for mode in grid:
            try:
                _memory.check_candidate(mode)
                run = build_step(mode)
                out = run()  # settle
            except SyncModeIneligibleError as e:
                log.warning(
                    "autotune sync_mode: %r ineligible for this job "
                    "(%s); skipped", mode, e)
                skipped.add(mode)
                continue
            _fetch_probe(out)
            t0 = _time.perf_counter()
            for _ in range(max(1, iters)):
                out = run()
            _fetch_probe(out)
            seconds = (_time.perf_counter() - t0) / max(1, iters)
            results.append((mode, seconds))
            _record_trial("sync_mode", seconds)
            log.info("autotune sync_mode: %r -> %.6fs/step", mode, seconds)
    except Exception:
        fallback = next((m for m in grid if m not in skipped), grid[0])
        set_tuned_sync_mode(fallback)
        log.warning(
            "autotune sync_mode: aborted mid-sweep; pinned the "
            "rank-identical first eligible candidate %r", fallback)
        raise
    if not results:
        raise ValueError(
            f"autotune sync_mode: every candidate in {tuple(grid)} "
            "was ineligible for this job (see the skip warnings above)")
    best = _broadcast(min(results, key=lambda p: p[1])[0],
                      "autotune/sync-mode-decision")
    set_tuned_sync_mode(best)
    log.info("autotune sync_mode: pinned %r", best)
    return best


def tune_step_fusion(step, args: tuple,
                     thresholds: Sequence[int] = DEFAULT_THRESHOLDS,
                     iters: int = 3,
                     measure: Callable[[int], float] | None = None) -> int:
    """Warmup tuning of the fusion threshold for a step built by
    ``make_train_step`` over a ``DistributedOptimizer`` built without an
    explicit ``fusion_threshold_bytes``: for each candidate, pin it,
    re-bucket the optimizer, run one settle call and ``iters`` timed
    calls of ``step(*args)`` (real training steps). The fastest
    candidate is pinned and returned. ``measure(threshold) -> seconds``
    replaces the timing loop (tests inject a cost model)."""
    import time as _time

    if measure is None:
        if not hasattr(step, "rebucket"):
            raise TypeError(
                "step must be built by make_train_step (it needs "
                ".rebucket() so that each candidate re-buckets its "
                f"optimizer); got {type(step).__name__}")
        # Time the bare callable: the stall watch's syncs would bias a
        # candidate's window.
        timed = getattr(step, "_hvd_unwatched", step)
        if hasattr(timed, "_hvd_tuning"):
            # A live transparent tuner would re-pin its own candidates
            # over each threshold: the explicit call wins.
            timed._hvd_tuning = False
            timed = timed._fn

        def measure(threshold: int) -> float:  # noqa: F811
            set_tuned_threshold(threshold)
            _retrace(timed)
            _fetch_probe(timed(*args))
            t0 = _time.perf_counter()
            out = None
            for _ in range(iters):
                out = timed(*args)
            _fetch_probe(out)
            return (_time.perf_counter() - t0) / max(1, iters)

    log = get_logger()
    results: list[tuple[int, float]] = []
    try:
        for threshold in thresholds:
            seconds = measure(int(threshold))
            results.append((int(threshold), seconds))
            _tuned["history"].append((int(threshold), seconds))
            _record_trial("fusion_threshold_bytes", seconds)
            log.info("autotune fusion: threshold=%d -> %.6fs/step",
                     int(threshold), seconds)
        best = min(results, key=lambda p: p[1])[0]
    finally:
        # A failure mid-sweep leaves the best so far (or None) pinned.
        best_sofar = (min(results, key=lambda p: p[1])[0]
                      if results else None)
        set_tuned_threshold(best_sofar)
        _retrace(step)
    log.info("autotune fusion: pinned threshold=%d", best)
    return best


def tune_fusion_threshold(
    build_step: Callable[[int], Callable],
    time_step: Callable[[Callable], float],
    rounds: int = 12,
    low_bytes: int = 64 * 1024,
    high_bytes: int = 128 * 1024 * 1024,
    log_path: str | None = None,
) -> int:
    """Search the fusion threshold with the Bayesian optimizer:
    ``build_step(threshold)`` returns a step, ``time_step(step)`` its
    steady seconds a step; the score is 1 / seconds. Returns the best
    threshold in bytes."""
    log = get_logger()
    tuner = BayesianTuner([float(low_bytes)], [float(high_bytes)])
    try:
        for r in range(rounds):
            (candidate,) = tuner.suggest()
            threshold = max(low_bytes, int(candidate))
            step = build_step(threshold)
            seconds = time_step(step)
            score = 1.0 / max(seconds, 1e-9)
            tuner.add_sample([float(threshold)], score)
            log.info("autotune round %d: threshold=%d -> %.4fs/step", r,
                     threshold, seconds)
            if log_path:
                with open(log_path, "a") as f:
                    f.write(f"{threshold},{seconds:.6f},{score:.3f}\n")
        (best_params, best_score) = tuner.best()
        log.info("autotune best: threshold=%d (score %.1f)",
                 int(best_params[0]), best_score)
        return int(best_params[0])
    finally:
        tuner.close()
