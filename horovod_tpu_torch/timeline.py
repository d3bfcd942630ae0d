"""Chrome-trace timeline of collective lifecycles.

A copy of ``horovod_tpu/timeline.py`` for the PyTorch port (parity:
``horovod/common/timeline.cc``), activated by ``HOROVOD_TIMELINE=/path.json``
(or :func:`start_timeline`) and viewable in ``chrome://tracing`` or
Perfetto: the writer (:39), :func:`start_timeline`, :func:`stop_timeline`,
:class:`activity` (:199) and :func:`mark_cycle` (:250, with
``HOROVOD_TIMELINE_MARK_CYCLES=1``). It records what happens on the host:
eager-collective dispatch, the training step's phases, cycle markers.

Events are written on a dedicated writer thread, so the hot path never
blocks on file IO, as Chrome trace-event JSON. The file **loads after
every write**: each event is one ``pwrite`` of the separator, the event
and the closing ``]`` over the previous ``]``, so a process that dies
without ``stop_timeline()``, SIGKILL included, leaves a valid JSON array,
and a reader during the run finds one once ``Timeline.drain()`` has
returned. An ``atexit`` hook drains and closes the writer on a normal
exit.

:class:`activity` emits into ``torch.profiler.record_function`` where the
JAX one uses ``jax.profiler.TraceAnnotation``, so the same names show in a
``torch.profiler`` trace above the card's kernels, and on a CUDA world
also as an NVTX range (the reference's ``nvtx_op_range`` role). This
module imports torch only inside :class:`activity`: the rendezvous server
imports the tracing plane on the driver, where torch is never imported.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import threading
import time
from typing import Any

_timeline: "Timeline | None" = None
_lock = threading.Lock()


class Timeline:
    #: Trailer kept at the tail after every write, so the file is a valid
    #: JSON array at ALL times (the crash-safety contract).
    _TRAILER = b"\n]\n"

    #: Serialized-event cap: caller-controlled ``args`` are dropped (with
    #: a marker) past this bound, so each write stays one small chunk.
    _MAX_EVENT_CHARS = 4096

    def __init__(self, path: str):
        self.path = path
        self._queue: "queue.Queue[dict[str, Any] | None]" = queue.Queue()
        self._start = time.perf_counter_ns()
        self._thread = threading.Thread(
            target=self._writer, name="hvd-timeline-writer", daemon=True
        )
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                           0o644)
        head = b"[\n"
        os.pwrite(self._fd, head + self._TRAILER, 0)  # loads as []
        self._tail = len(head)
        self._first = True
        self._dead = False
        # Events queued and events written, for drain().
        self._queued = 0
        self._written = 0
        self._written_cond = threading.Condition()
        self._thread.start()
        # A process that exits without stop_timeline() still drains and
        # closes the writer (the write protocol below covers the
        # no-atexit deaths — SIGKILL, os._exit — too).
        atexit.register(self.shutdown)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._start) / 1e3

    def _writer(self) -> None:
        while True:
            event = self._queue.get()
            if event is None:
                break
            # One pwrite of separator + event + a fresh trailer over the
            # old trailer: the file goes from one valid JSON array to the
            # next in a single write call, and a crash loses at most the
            # event in flight. The JAX package's writer tells the text
            # file its position between the event and the trailer, which
            # flushes the event alone; a reader between the two saw a
            # file that did not load (H100 run of chip_smoke.py's
            # observability phase). Every chunk is at least the
            # trailer's length, so the file only grows: no stale bytes.
            text = json.dumps(event)
            if len(text) > self._MAX_EVENT_CHARS:
                event = {**event, "args": {"dropped": "args exceeded "
                                           "timeline event size cap"}}
                text = json.dumps(event)
            body = (b"" if self._first else b",\n") + text.encode()
            self._first = False
            os.pwrite(self._fd, body + self._TRAILER, self._tail)
            self._tail += len(body)
            with self._written_cond:
                self._written += 1
                self._written_cond.notify_all()
        # The trailer is already on disk after the last write; just close.
        os.close(self._fd)

    def _emit(self, name: str, phase: str, category: str, ts_us: float, dur_us: float = None, args=None):
        if self._dead:
            return
        event = {
            "name": name,
            "ph": phase,
            "cat": category,
            "ts": ts_us,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000,
        }
        if dur_us is not None:
            event["dur"] = dur_us
        if args:
            event["args"] = args
        with self._written_cond:
            self._queued += 1
        self._queue.put(event)

    def complete(self, name: str, category: str, start_us: float, args=None) -> None:
        """Record a completed activity [start_us, now]."""
        self._emit(
            name, "X", category, start_us, self._now_us() - start_us, args
        )

    def instant(self, name: str, category: str = "marker", args=None) -> None:
        self._emit(name, "i", category, self._now_us(), args=args)

    def drain(self) -> None:
        """Return once every event emitted before the call is in the file.
        A reader racing a write can read the old length of the file with
        the new event's first bytes over its closing ``]``; between writes
        the file loads."""
        with self._written_cond:
            target = self._queued
            self._written_cond.wait_for(
                lambda: self._written >= target or self._dead)

    def now_us(self) -> float:
        return self._now_us()

    def shutdown(self) -> None:
        global _timeline
        if self._dead:
            return
        self._dead = True
        with self._written_cond:
            self._written_cond.notify_all()
        self._queue.put(None)
        self._thread.join(timeout=5)
        try:
            atexit.unregister(self.shutdown)
        except Exception:  # noqa: BLE001 — double-run is harmless anyway
            pass
        with _lock:
            if _timeline is self:
                _timeline = None


def get_timeline() -> Timeline | None:
    """The process timeline, or None when HOROVOD_TIMELINE is unset."""
    global _timeline
    with _lock:
        if _timeline is None:
            path = os.environ.get("HOROVOD_TIMELINE", "")
            if not path:
                return None
            _timeline = Timeline(path)
        return _timeline


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start (or re-target) timeline capture at runtime (parity:
    ``hvd.start_timeline`` — the reference's dynamic-activation API,
    equivalent to launching with ``HOROVOD_TIMELINE=<path>``).
    ``mark_cycles`` mirrors ``HOROVOD_TIMELINE_MARK_CYCLES``."""
    global _timeline, _mark_cycles
    # Swap env + globals + the new writer ATOMICALLY: a concurrent
    # collective's get_timeline() between the steps would otherwise
    # materialize a writer at the stale path (truncating a flushed
    # trace). The old writer shuts down outside the lock.
    with _lock:
        old = _timeline
        os.environ["HOROVOD_TIMELINE"] = file_path
        if mark_cycles:
            os.environ["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
        else:
            os.environ.pop("HOROVOD_TIMELINE_MARK_CYCLES", None)
        _mark_cycles = mark_cycles  # reset the first-use cache
        _timeline = Timeline(file_path)
    if old is not None:
        old.shutdown()


def stop_timeline() -> None:
    """Stop capture and flush the trace file (parity:
    ``hvd.stop_timeline``)."""
    global _timeline, _mark_cycles
    with _lock:
        tl = _timeline
        _timeline = None
        os.environ.pop("HOROVOD_TIMELINE", None)
        os.environ.pop("HOROVOD_TIMELINE_MARK_CYCLES", None)
        _mark_cycles = None
    if tl is not None:
        tl.shutdown()


class activity:
    """Context manager: ``with activity('allreduce.dense_1', 'collective')``.

    Emits a Chrome-trace event on the host timeline (when one is on), a
    ``torch.profiler.record_function`` range (what a ``torch.profiler``
    trace of the run shows above the kernels), and on a CUDA world an NVTX
    range. The world's device decides NVTX: a CPU build of torch has none.
    A failure of either range is an error, not a silent no-op.
    """

    def __init__(self, name: str, category: str = "collective", args=None):
        self.name = name
        self.category = category
        self.args = args
        self._tl = get_timeline()
        self._start = 0.0
        self._range = None
        self._nvtx = None

    def __enter__(self):
        import torch

        from . import basics

        if self._tl is not None:
            self._start = self._tl.now_us()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        device = basics._state.device
        if device is not None and device.type == "cuda":
            self._nvtx = torch.cuda.nvtx
            self._nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx is not None:
            self._nvtx.range_pop()
        self._range.__exit__(*exc)
        if self._tl is not None:
            self._tl.complete(self.name, self.category, self._start,
                              self.args)
        return False


_mark_cycles = None
_cycle_count = 0


def mark_cycles_enabled() -> bool:
    """HOROVOD_TIMELINE_MARK_CYCLES=1 (reference contract): emit an instant
    marker per background/step cycle on the timeline."""
    global _mark_cycles
    if _mark_cycles is None:
        _mark_cycles = os.environ.get(
            "HOROVOD_TIMELINE_MARK_CYCLES", "") == "1"
    return _mark_cycles


def mark_cycle(label: str = "cycle") -> None:
    """Emit a cycle marker if enabled. A "cycle" is a dispatched eager
    collective or training step: the port has no background negotiation
    loop to tick."""
    global _cycle_count
    if not mark_cycles_enabled():
        return
    tl = get_timeline()
    if tl is not None:
        _cycle_count += 1
        tl.instant(f"{label}.{_cycle_count}", category="cycle")
