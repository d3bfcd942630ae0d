"""Coordinated abort: turn a failure somewhere into recovery everywhere.

A copy of ``horovod_tpu/abort.py`` (``_AbortState``, ``consume``,
``trigger_local``, ``raise_if_aborted``, ``joined_generation``,
``poll_once``, ``post``, ``current_generation``). A survivor whose peer
died sits in a collective that will never complete. The rendezvous KV
carries a monotonic world generation and an ``abort/<generation>``
record: the elastic driver posts one when it reaps an unclean worker exit
or kills a hung one, and a worker may post one itself (:func:`post`).
Every worker's abort monitor (``runner/elastic/worker.py``) mirrors the
record into the process-local flag here, and every blocking site calls
:func:`raise_if_aborted`, which turns the flag into
``HorovodInternalError``: the exception ``@hvd.elastic.run`` recovers
from.

Abort records are keyed by generation and consumed once: the elastic loop
calls :func:`consume` when it eats the failure, and
:func:`joined_generation` when a worker (re-)joins a world, so a record
from the pre-recovery world never re-aborts the re-formed one.

The port's own step: when the flag is first armed, the hooks registered
with :func:`on_abort` run on the arming thread. ``basics`` registers one
that aborts the current process group's communicator, so a collective
already waiting on a dead peer (an NCCL kernel on the card does not
return on its own) ends with an error instead of hanging. The reference
needs no such step: its host plane is TCP, which fails when a peer dies.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable

from . import faults
from .utils.env import get_float
from .utils.logging import get_logger

ABORT_SCOPE = "abort"

_hooks: list[Callable[[str, int], None]] = []


def on_abort(hook: Callable[[str, int], None]) -> None:
    """Run ``hook(reason, generation)`` whenever the flag is newly armed
    (once per arming; failures are logged, never raised)."""
    if hook not in _hooks:
        _hooks.append(hook)


def poll_interval() -> float:
    """How often blocking sites and the monitor check the abort flag.

    Bounds the unblock latency of a wedged survivor: detection-to-recovery
    is at most the detector's deadline plus this interval."""
    return get_float("HOROVOD_ABORT_POLL_INTERVAL", 0.5)


def current_generation() -> int:
    """The generation of the world this process is actually IN: the
    elastic worker context's *joined* version (not the freshest version
    its poller has seen — a survivor wedged in world g's collectives is
    still in world g after g+1 was announced). The env contract is the
    fallback for processes that never built a context."""
    from .runner.elastic import worker as elastic_worker

    ctx = elastic_worker._context
    if ctx is not None:
        return ctx.joined_version
    try:
        return int(os.environ.get("HOROVOD_WORLD_VERSION", "0") or 0)
    except ValueError:
        return 0


class _AbortState:
    """Process-wide abort flag (thread-safe). One instance per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._reason = ""
        self._generation = -1
        self._record: bytes | None = None
        self._consumed: bytes | None = None

    def trigger(self, reason: str, generation: int,
                record: bytes | None = None) -> bool:
        """Locally arm the abort. Returns False when this exact record was
        already consumed (a survivor must not re-abort on the same record
        it just recovered from)."""
        with self._lock:
            if record is not None and record == self._consumed:
                return False
            if self._event.is_set():
                # Already armed; first reason wins, but track the LATEST
                # observed record so consume() marks what the monitor will
                # keep polling.
                if record is not None:
                    self._record = record
                return True
            self._reason = reason
            self._generation = generation
            self._record = record
            self._event.set()
        get_logger().error(
            "coordinated abort (world generation %d): %s — unblocking and "
            "entering elastic recovery", generation, reason,
        )
        for hook in list(_hooks):
            try:
                hook(reason, generation)
            except Exception as e:  # noqa: BLE001 — the flag is what counts
                get_logger().warning("abort hook failed: %s", e)
        return True

    def consume(self) -> None:
        """Eat the armed abort: clear the local flag and remember the
        record so the monitor does not re-trigger on it."""
        with self._lock:
            if self._record is not None:
                self._consumed = self._record
            self._record = None
            self._event.clear()

    def mark_stale(self, record: bytes) -> None:
        """Remember ``record`` as consumed without ever arming: used when
        (re-)joining a generation whose abort record predates the join."""
        with self._lock:
            self._consumed = record

    def is_aborted(self) -> bool:
        return self._event.is_set()

    def snapshot(self) -> tuple[str, int]:
        with self._lock:
            return self._reason, self._generation

    def reset(self) -> None:
        """Full reset (tests only): forget the flag AND the consumed
        record."""
        with self._lock:
            self._event.clear()
            self._reason = ""
            self._generation = -1
            self._record = None
            self._consumed = None


_state = _AbortState()

is_aborted = _state.is_aborted
reset = _state.reset


def consume() -> None:
    """Eat the armed abort (the elastic loop caught its
    HorovodInternalError). Counts (``hvd_abort_consumed_total``), journals
    ``abort_consumed`` and dumps the flight record only when something was
    armed: the elastic loop calls this on every internal failure."""
    armed = _state.is_aborted()
    reason, gen = _state.snapshot()
    _state.consume()
    if armed:
        from . import metrics, tracing

        metrics.ABORT_CONSUMES.inc()
        metrics.event("abort_consumed", generation=gen, reason=reason)
        # The postmortem of each recovery: this rank's last K steps, open
        # spans included, beside the abort_consumed event.
        tracing.dump_flight_record("abort_consumed", generation=gen,
                                   detail=reason)


def trigger_local(reason: str, generation: int | None = None) -> None:
    """Arm the abort from in-process detection, with no KV round trip."""
    gen = current_generation() if generation is None else generation
    _state.trigger(reason, gen)


def raise_if_aborted() -> None:
    """The hook every blocking site polls: converts an armed abort into
    the elastic recovery exception. Cheap (one Event check) when nothing
    is armed."""
    if _state.is_aborted():
        from .exceptions import HorovodInternalError

        reason, gen = _state.snapshot()
        raise HorovodInternalError(
            f"coordinated abort (world generation {gen}): {reason}"
        )


def joined_generation(generation: int,
                      stale_record: bytes | None = None) -> None:
    """A worker (re-)joined world epoch ``generation``: any abort armed
    for the pre-recovery world is moot, so consume it. ``stale_record``
    (the abort record already present for this generation at join time:
    a recovery that rejoins the SAME generation) is marked consumed so it
    cannot re-abort the worker that just recovered from it."""
    _state.consume()
    if stale_record is not None:
        _state.mark_stale(stale_record)


def poll_once(client, generation: int | None = None) -> bool:
    """One abort-flag poll against the rendezvous KV.

    ``client`` should be a dedicated lightweight KVClient (1 attempt,
    short timeout). Returns True when an abort was (already or newly)
    armed for this generation.
    """
    if faults.fire(faults.ABORT_POLL):
        return False  # injected drop: propagation delayed this round
    gen = current_generation() if generation is None else generation
    record = client.get(ABORT_SCOPE, str(gen))
    if record is None:
        return _state.is_aborted()
    try:
        reason = json.loads(record).get("reason", "unknown")
    except (ValueError, AttributeError):
        reason = record.decode(errors="replace")
    return _state.trigger(str(reason), gen, record=record)


def post(reason: str, generation: int | None = None) -> None:
    """Worker-side abort posting: publish ``abort/<generation>`` so every
    peer's monitor picks it up, then arm the local flag. Best-effort on the
    network side — a worker whose KV is unreachable still unblocks itself
    locally."""
    gen = current_generation() if generation is None else generation
    record = json.dumps({
        "reason": reason,
        "host": os.environ.get("HOROVOD_HOSTNAME", socket.gethostname()),
        "time": time.time(),
    }).encode()
    from . import metrics

    metrics.ABORT_POSTS.inc()
    metrics.event("abort_posted", generation=gen, reason=reason,
                  source="worker")
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR", "")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT", "")
    if addr and port:
        try:
            from .runner.http.kv_server import KVClient

            # Not generation-fenced: a survivor of world g must be able to
            # post abort/<g> even after the server moved to g+1 (the
            # record is generation-keyed, so it only reaches peers still
            # in g). Epoch-fenced: a worker still loyal to a superseded
            # driver plants nothing in its successor's store.
            try:
                epoch = int(os.environ.get("HOROVOD_DRIVER_EPOCH", "0") or 0)
            except ValueError:
                epoch = 0
            KVClient(addr, int(port), timeout=2.0, retries=1,
                     epoch_fn=(lambda: epoch) if epoch > 0 else None).put(
                ABORT_SCOPE, str(gen), record)
        except Exception as e:  # noqa: BLE001 — local unblock still happens
            get_logger().warning(
                "could not post coordinated abort to the rendezvous KV "
                "(%s); peers will rely on their own detection", e,
            )
    _state.trigger(reason, gen, record=record)
