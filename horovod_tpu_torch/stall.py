"""Stall inspector: the distributed-deadlock detector.

Port of ``horovod_tpu/stall.py`` (parity: ``horovod/common/
stall_inspector.cc``): ``StallInspector`` (:32) with its warning, its
shutdown (the flight record first, then the coordinated abort and a SIGINT
to the main thread) and its deadman exit (``EXIT_STALL_ABANDONED``),
:func:`watch` (:242) and :func:`fetch` (:338). The classic failure it
catches: a conditional diverged across ranks, so rank A entered a
collective rank B never will, and the job hangs with no error. Every eager
collective and every watched step opens a ticket; a watchdog thread
reports tickets outstanding past ``HOROVOD_STALL_CHECK_TIME`` (60 s) by
name, and past ``HOROVOD_STALL_SHUTDOWN_TIME`` (0, off) shuts down.

On the card a collective's host call returns before the collective runs:
NCCL's ``Work.wait()`` only orders the current stream after it. So a
ticket there closes when the device has finished, not when the host call
returns: the dispatch site hands the inspector a completion probe
(:meth:`StallInspector.end_when`, a CUDA event's ``query``), and the
watchdog and every new ticket reap the probes that report done. A
collective queued behind device work that never ends keeps its ticket
open, and is reported.

The shutdown posts the coordinated abort, whose hook aborts the group's
NCCL communicators (``basics._abort_groups``): that is what ends a main
thread waiting on the card for a collective that never completes, so the
SIGINT can surface as ``HorovodInternalError`` from :func:`watch`.

Across ranks (``horovod_tpu/stall.py:243-300``): in a world of more than
one rank a watched region first announces a one-scalar
``stallwatch/<name>`` allreduce on the negotiated runtime
(``runtime.NativeWorld``) and collects it when the body ends, so a rank
that never reaches the region is named by rank 0's controller
(``controller.cc``'s stall inspector: ``tensor stallwatch/<name> ...
still missing from rank(s) [r]``), and the body's ranks wait for each
other at its end, bounded by ``timeout_s``.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from typing import Callable

from . import abort, faults, metrics
from .utils.env import get_float
from .utils.logging import get_logger


class StallInspector:
    def __init__(
        self,
        warning_s: float | None = None,
        shutdown_s: float | None = None,
    ):
        self.warning_s = (
            get_float("HOROVOD_STALL_CHECK_TIME", 60.0)
            if warning_s is None
            else warning_s
        )
        self.shutdown_s = (
            get_float("HOROVOD_STALL_SHUTDOWN_TIME", 0.0)
            if shutdown_s is None
            else shutdown_s
        )
        self._outstanding: dict[int, tuple[str, float]] = {}
        # Tickets waiting for their device work: (ticket, done probe,
        # call once done).
        self._pending: list[tuple[int, Callable[[], bool],
                                  Callable[[], None] | None]] = []
        self._next_ticket = 0
        self._lock = threading.Lock()
        self._reap_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._last_warned: dict[int, float] = {}
        self.failed = False  # set when a stall passed the shutdown threshold
        self.failure_reason = ""
        self._failed_at: float | None = None

    # -- ticket API (called by dispatch sites) ------------------------------

    def begin(self, name: str) -> int:
        self.reap()
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._outstanding[ticket] = (name, time.monotonic())
            self._ensure_watchdog()
            outstanding = len(self._outstanding)
        metrics.STALL_TICKETS.inc()
        metrics.STALL_OUTSTANDING.set(outstanding)
        return ticket

    def end(self, ticket: int) -> None:
        with self._lock:
            self._outstanding.pop(ticket, None)
            self._last_warned.pop(ticket, None)
            outstanding = len(self._outstanding)
        metrics.STALL_OUTSTANDING.set(outstanding)

    def end_when(self, ticket: int, done: Callable[[], bool],
                 on_done: Callable[[], None] | None = None) -> None:
        """Close ``ticket`` once ``done()`` reports its device work
        finished (checked by :meth:`reap`), then call ``on_done()``."""
        with self._lock:
            self._pending.append((ticket, done, on_done))

    def reap(self) -> None:
        """Close the tickets whose device work has finished. Probes run
        outside the inspector's lock; one reaper at a time, so each
        ``on_done`` runs once."""
        with self._reap_lock:
            with self._lock:
                pending = list(self._pending)
            finished = [p for p in pending if p[1]()]
            if not finished:
                return
            with self._lock:
                self._pending = [p for p in self._pending
                                 if p not in finished]
            for ticket, _, on_done in finished:
                self.end(ticket)
                if on_done is not None:
                    on_done()

    # -- watchdog -----------------------------------------------------------

    def _ensure_watchdog(self) -> None:
        if self._thread is None and self.warning_s > 0:
            self._thread = threading.Thread(
                target=self._watch, name="hvd-stall-inspector", daemon=True
            )
            self._thread.start()

    def check_once(self, now: float | None = None) -> list[str]:
        """One inspection pass (after reaping finished device work);
        returns names of stalled operations.

        A stalled ticket is RE-warned every ``warning_s`` with its
        escalating age (not once-and-silent): a long hang must stay
        visible in logs, not vanish after the first report."""
        self.reap()
        now = time.monotonic() if now is None else now
        stalled = []
        with self._lock:
            for ticket, (name, start) in self._outstanding.items():
                age = now - start
                if age < self.warning_s:
                    continue
                last = self._last_warned.get(ticket)
                if last is not None and now - last < self.warning_s:
                    continue
                self._last_warned[ticket] = now
                stalled.append(f"{name} (outstanding {age:.0f}s)")
        if stalled:
            metrics.STALL_WARNINGS.inc(len(stalled))
            get_logger().warning(
                "Stall detected: one or more collectives have been "
                "outstanding for over %.0fs — this usually means a rank "
                "diverged (conditional collective) or a host hung "
                "(world generation %d): %s",
                self.warning_s,
                abort.current_generation(),
                "; ".join(stalled),
            )
        return stalled

    def _watch(self) -> None:
        interval = max(self.warning_s / 4.0, 0.25)
        while not self._stop.wait(interval):
            self.check_once()
            if self.failed:
                self._check_deadman()
            if self.shutdown_s > 0 and not self.failed:
                with self._lock:
                    oldest = min(
                        (start for _, start in self._outstanding.values()),
                        default=None,
                    )
                if oldest is not None and \
                        time.monotonic() - oldest >= self.shutdown_s:
                    self._shut_down(time.monotonic() - oldest)

    def _shut_down(self, age: float) -> None:
        reason = (
            f"stall exceeded HOROVOD_STALL_SHUTDOWN_TIME="
            f"{self.shutdown_s:.0f}s (oldest op outstanding {age:.0f}s)"
        )
        get_logger().error(
            "%s; posting the coordinated abort and interrupting the main "
            "thread (surfaces as HorovodInternalError → elastic recovery)",
            reason,
        )
        self.failure_reason = reason
        self.failed = True
        self._failed_at = time.monotonic()
        # Postmortem FIRST, while the wedge is still live: the flight
        # record shows this rank's last K steps with the wedged span still
        # OPEN (name + age).
        from . import tracing

        tracing.dump_flight_record("stall_shutdown", detail=reason)
        # Cluster-wide: publish abort/<generation> so every peer's monitor
        # unblocks too. Locally the abort hook aborts the NCCL
        # communicators, which ends a main thread waiting on the card.
        abort.post(reason)
        # A daemon thread cannot raise into the trainer: deliver SIGINT to
        # the main thread, and let watch() or the elastic loop turn the
        # KeyboardInterrupt into HorovodInternalError. A real signal (not
        # interrupt_main's flag) EINTRs a main thread blocked in a C call.
        signal.pthread_kill(threading.main_thread().ident, signal.SIGINT)

    def _check_deadman(self) -> None:
        """After the shutdown interrupt fired: if the wedged op is STILL
        outstanding past ``HOROVOD_STALL_EXIT_GRACE`` (30 s), the main
        thread never acted on the signal (it is blocked in a call no signal
        breaks) while the heartbeat thread keeps this worker looking alive.
        Exit with ``EXIT_STALL_ABANDONED`` so the driver re-forms the world
        without it."""
        grace = get_float("HOROVOD_STALL_EXIT_GRACE", 30.0)
        if grace <= 0 or self._failed_at is None:
            return
        if time.monotonic() - self._failed_at < grace:
            return
        self.reap()
        with self._lock:
            still_wedged = bool(self._outstanding)
        if not still_wedged:
            self._failed_at = None  # the interrupt landed; all clear
            return
        from . import tracing
        from .runner.elastic.constants import EXIT_STALL_ABANDONED

        get_logger().error(
            "stall shutdown fired %.0fs ago but the main thread never "
            "surfaced it (wedged in an uninterruptible call); exiting %d "
            "so the driver re-forms the world without this worker",
            grace, EXIT_STALL_ABANDONED,
        )
        # Last words before os._exit (which runs no atexit/finally): the
        # flight record, on a side thread with a bounded join, since a
        # hung disk or a lock held by the wedged thread must not stop the
        # exit.
        dumper = threading.Thread(
            target=lambda: tracing.dump_flight_record(
                "deadman_exit", detail=self.failure_reason),
            name="hvd-deadman-dump", daemon=True)
        dumper.start()
        dumper.join(timeout=5.0)
        os._exit(EXIT_STALL_ABANDONED)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


_inspector: StallInspector | None = None
_ins_lock = threading.Lock()


def get_inspector() -> StallInspector:
    global _inspector
    with _ins_lock:
        if _inspector is None:
            _inspector = StallInspector()
        return _inspector


def reset_for_testing() -> None:
    """Stop the inspector; the next use builds one from the env again."""
    global _inspector
    with _ins_lock:
        ins, _inspector = _inspector, None
    if ins is not None:
        ins.stop()


def _negotiated_world():
    """The negotiated runtime's world of an initialized multi-rank world,
    or None (this module imports no torch: a process that never formed a
    world, the elastic driver, has none)."""
    basics = sys.modules.get(f"{__package__}.basics")
    if basics is None or not basics.is_initialized():
        return None
    return basics._state.negotiated


@contextlib.contextmanager
def watch(name: str | None = None, timeout_s: float | None = None,
          label: str = "watch", cross_rank: bool = True):
    """Stall-inspect a region that must run in rank lockstep.

    On entry a local inspector ticket ``<label>[<name>]`` opens and, in a
    world of more than one rank (and ``cross_rank``), a one-scalar
    ``stallwatch/<name>`` allreduce is announced on the negotiated
    runtime; the announcement comes before the body, so a peer that never
    reaches the region is named by rank 0's controller either way. On exit
    the announcement is collected (the ranks wait for each other there)
    and the ticket closes. ``timeout_s=None`` waits for it without end
    (the controller reports the stall meanwhile) unless
    ``HOROVOD_STALL_SHUTDOWN_TIME`` is set, which then bounds the wait;
    ``cross_rank=False`` keeps the local ticket only.

    A pending coordinated abort raises ``HorovodInternalError`` before the
    body runs, and the ``worker.step`` fault point fires on entry. The
    inspector's shutdown interrupt (or one concurrent with an armed abort)
    surfaces as ``HorovodInternalError``, so ``@hvd.elastic.run``
    recovers; a user's own Ctrl-C passes through.

    The body must wait for its device work (as :func:`fetch` and
    ``make_train_step``'s watched steps do) for the ticket to cover it.
    """
    abort.raise_if_aborted()
    faults.fire(faults.WORKER_STEP)
    if timeout_s is None:
        shutdown_s = get_float("HOROVOD_STALL_SHUTDOWN_TIME", 0.0)
        timeout_s = shutdown_s if shutdown_s > 0 else 1e9
    inspector = get_inspector()
    world = _negotiated_world() if cross_rank else None
    handle = None
    if world is not None:
        import torch

        tag = name or world.reserve_name("step")
        handle = world.allreduce_async(
            torch.ones(1, dtype=torch.float32, device=world.device),
            name=f"stallwatch/{tag}", op="sum")
    else:
        tag = name or "step"
    ticket = inspector.begin(f"{label}[{tag}]")
    try:
        try:
            yield
            if handle is not None:
                world.synchronize(handle, timeout_s=timeout_s)
                handle = None
        except KeyboardInterrupt:
            if inspector.failed or abort.is_aborted():
                from .exceptions import HorovodInternalError

                raise HorovodInternalError(
                    "stall shutdown: "
                    + (inspector.failure_reason
                       or "stall exceeded the shutdown deadline")
                ) from None
            raise
    finally:
        inspector.end(ticket)
        if handle is not None:
            # The body raised with the announcement in flight: collect it
            # if it completed; otherwise the world's teardown fails it.
            try:
                if world.poll(handle):
                    world.synchronize(handle, timeout_s=1.0)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass


def _cuda_devices(tree, out: set) -> set:
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def fetch(tree, name: str | None = None, timeout_s: float = 600.0):
    """Wait for the tensors of ``tree`` under stall inspection.

    The port's ``jax.block_until_ready``: the host waits until every CUDA
    tensor in ``tree`` (nested lists, tuples and dicts) is computed, by
    waiting for the current stream of each device they are on (work a
    collective leaves on its own stream is ordered before it by the
    collective's wait). The wait runs inside a :func:`watch` ticket named
    ``fetch[<name>]``, so a step hung on the card is reported by name, and
    a rank that never fetches it is named by rank 0's controller.
    ``timeout_s`` bounds the cross-rank announcement.
    Returns ``tree``::

        loss = hvd.fetch(step(batch), name=f"step.{i}")
    """
    from .basics import sync_stream

    with watch(name=name, timeout_s=timeout_s, label="fetch"):
        for device in _cuda_devices(tree, set()):
            sync_stream(device)
    return tree
