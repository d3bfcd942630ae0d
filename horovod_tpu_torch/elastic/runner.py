"""The elastic retry loop: ``@hvd.elastic.run``.

Port of ``horovod_tpu/elastic/runner.py`` (``run`` :85,
``_NotificationManager`` :507), the reference's
``horovod/common/elastic.py — run_fn()``: the decorated training function
survives peer failure and addition by catching the two recovery
exceptions:

- ``HorovodInternalError`` (a collective failed — a peer died mid-step, or
  a coordinated abort was posted): roll back, tear down and re-form the
  world, then retry.
- ``HostsUpdatedInterrupt`` (the driver says the host set changed, nothing
  failed): keep in-memory state, re-rendezvous, sync, continue.

Each re-formation is a new process group (``basics.shutdown()`` aborts and
destroys the old one, ``basics.init()`` forms the next from the KV's
assignment).

The ladder's ``peer`` rung (``horovod_tpu/elastic/runner.py:380-440``)
restores a ``PeerShardedState`` from the peer replica plane; a failed peer
restore falls through to the durable rung in the same attempt.

Not ported yet: the loss-spike rewind (it needs the integrity plane), so a
``LossSpikeError`` takes the ordinary ladder; and the goodput, event
journal and stall-inspector hooks.
"""

from __future__ import annotations

import functools
import signal
import sys
import threading
import time

from .. import abort, basics
from ..exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
    RecoveryExhaustedError,
    RemovedFromWorldError,
)
from ..utils.env import get_float, get_int
from ..utils.logging import get_logger

# The escalation ladder's rung names, keyed by consecutive no-progress
# failures.
_RUNGS = {1: "restore", 2: "rendezvous", 3: "peer", 4: "durable"}

# Preemption drain: SIGTERM (the cloud's preemption notice, and the elastic
# driver's first termination signal) flips this event; the NEXT
# ``state.commit()`` raises ``RemovedFromWorldError`` so the worker exits
# cleanly with EXIT_REMOVED.
_drain = threading.Event()


def drain_requested() -> bool:
    return _drain.is_set()


def _install_drain_handler() -> None:
    """Arm the SIGTERM→drain contract (main thread only)."""
    if threading.current_thread() is not threading.main_thread():
        return
    log = get_logger()

    def _on_sigterm(signum, frame):
        if not _drain.is_set():
            _drain.set()
            log.info(
                "elastic: SIGTERM (preemption notice) — draining: final "
                "commit, then clean EXIT_REMOVED"
            )

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # exotic host environments: best-effort
        pass


def _leave_generation() -> None:
    """The port's own step before a healthy re-formation
    (``HostsUpdatedInterrupt``): post the coordinated abort for the
    generation being left. Peers see the version bump at different
    commits, and on the card a peer already inside its next step's NCCL
    collective would wait for this rank forever (an NCCL kernel does not
    notice a peer leaving; the reference's TCP host plane does). The abort
    unblocks it; it rolls back to the commit this rank left from."""
    from ..runner.elastic import worker

    if worker._context is None or not basics.is_initialized():
        return
    if basics.size() > 1:
        abort.post("a peer is leaving this generation to re-form the world",
                   generation=worker._context.joined_version)


def run(func):
    """Decorator: ``@hvd.elastic.run`` / ``hvd.elastic.run(train)(state, ...)``.

    The wrapped function receives a ``State`` first argument; it is retried
    until it returns, with restore/sync + world re-initialization between
    attempts.

    Recovery follows an **escalation ladder** keyed on consecutive
    ``HorovodInternalError`` failures with no progress (no commit landed
    in between):

    1. ``restore`` — in-memory ``state.restore()`` to the last commit;
    2. ``rendezvous`` — full re-rendezvous + ``state.sync()`` from rank
       0, *skipping* the local restore;
    3. ``peer`` — :meth:`State.restore_peer`, the peer replica plane
       (``PeerShardedState`` arms it); a state that reports
       ``peer_restore_pending()`` comes here from its second failure, an
       unarmed one goes on to durable, and a failed peer restore falls
       through to durable in the same attempt;
    4. ``durable`` — :meth:`State.restore_durable` when registered, else
       rung 1 again.

    A **storm breaker** caps the ladder: after
    ``HOROVOD_RECOVERY_MAX_ATTEMPTS`` consecutive no-progress failures
    (default 10; 0 disables) the loop raises
    :class:`RecoveryExhaustedError`, with exponential backoff (capped at
    ``HOROVOD_RECOVERY_BACKOFF_MAX`` seconds) between attempts. ``init()``
    failures are retried until ``HOROVOD_ELASTIC_TIMEOUT`` seconds have
    passed since the first.
    """

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        log = get_logger()
        notification_manager.init()
        _install_drain_handler()
        skip_sync = False
        needs_reset = False
        first_init_failure = None
        init_retry_limit_s = get_float("HOROVOD_ELASTIC_TIMEOUT", 600.0)
        max_recovery = get_int("HOROVOD_RECOVERY_MAX_ATTEMPTS", 10)
        recovery_backoff_max = get_float("HOROVOD_RECOVERY_BACKOFF_MAX", 5.0)
        consecutive_failures = 0
        commits_before_attempt = 0

        while True:
            # World (re-)formation runs INSIDE the retry scope: init() can
            # itself fail transiently during a reconfiguration (driver
            # mid-publish, KV briefly unreachable) and must retry.
            try:
                if not basics.is_initialized():
                    try:
                        basics.init()
                    except (HorovodInternalError, HostsUpdatedInterrupt,
                            RemovedFromWorldError):
                        raise
                    except Exception as e:
                        now = time.time()
                        if first_init_failure is None:
                            first_init_failure = now
                        if now - first_init_failure > init_retry_limit_s:
                            log.error(
                                "elastic: re-initialization failing for "
                                ">%ss; giving up", init_retry_limit_s,
                            )
                            raise
                        raise HorovodInternalError(
                            f"world re-initialization failed: {e}"
                        ) from e
                    if needs_reset:
                        state.on_reset()
                        needs_reset = False
                first_init_failure = None
                # A state whose layout is shaped by the world (sharded
                # rows) syncs even after a host update that skips it.
                if not skip_sync or state.needs_world_sync():
                    state.sync()
                from ..runner.elastic.worker import _counters

                # Snapshot taken AFTER sync (which commits internally):
                # only commits the training function itself lands count as
                # progress for the storm breaker.
                commits_before_attempt = _counters.commits
                result = func(state, *args, **kwargs)
                from ..runner.elastic.worker import announce_done

                announce_done()
                return result
            except HorovodInternalError as e:
                from ..runner.elastic.worker import _counters

                # Progress (a commit landed inside the attempt) resets the
                # storm breaker.
                if _counters.commits > commits_before_attempt:
                    consecutive_failures = 0
                consecutive_failures += 1
                commits_before_attempt = _counters.commits
                # This failure consumed any armed coordinated abort.
                abort.consume()
                if max_recovery > 0 and consecutive_failures >= max_recovery:
                    log.error(
                        "elastic: %d consecutive recovery attempts with no "
                        "progress (HOROVOD_RECOVERY_MAX_ATTEMPTS=%d); "
                        "giving up", consecutive_failures, max_recovery,
                    )
                    raise RecoveryExhaustedError(
                        f"{consecutive_failures} consecutive recovery "
                        f"attempts failed with no progress (last: {e})"
                    ) from e
                rung_n = min(consecutive_failures, 4)
                if rung_n == 2 and state.peer_restore_pending():
                    # The state's own snapshot cannot re-form the world (a
                    # shard-local commit): rank 0's sync cannot help either.
                    rung_n = 3
                if rung_n == 3 and not state.peer_restore_armed():
                    rung_n = 4  # no replica plane: durable is next
                rung = _RUNGS[rung_n]
                if rung == "restore":
                    log.warning(
                        "elastic: internal failure (%s); restoring last "
                        "commit (recovery rung 'restore')", e)
                    if basics.is_initialized():
                        state.restore()
                elif rung == "rendezvous":
                    log.warning(
                        "elastic: internal failure (%s); escalating to full "
                        "re-rendezvous + sync from rank 0, skipping local "
                        "restore (recovery rung 'rendezvous')", e)
                else:
                    restored = False
                    if rung == "peer":
                        log.warning(
                            "elastic: internal failure (%s); escalating to "
                            "peer-replica restore (recovery rung 'peer')", e)
                        try:
                            restored = state.restore_peer()
                        except Exception as pe:  # noqa: BLE001
                            log.error(
                                "elastic: peer-replica restore failed (%s); "
                                "falling through to the durable rung", pe)
                    if not restored:
                        log.warning(
                            "elastic: internal failure (%s); escalating to "
                            "durable checkpoint restore (recovery rung "
                            "'durable')", e)
                        try:
                            restored = state.restore_durable()
                        except Exception as ce:  # noqa: BLE001
                            log.error(
                                "elastic: durable restore failed (%s); "
                                "falling back to the in-memory commit", ce)
                    if not restored and basics.is_initialized():
                        state.restore()
                skip_sync = False
                time.sleep(min(
                    0.5 * (2 ** (consecutive_failures - 1)),
                    recovery_backoff_max,
                ))
            except HostsUpdatedInterrupt as e:
                log.info("elastic: hosts updated; re-syncing")
                skip_sync = e.skip_sync
                _leave_generation()
            except RemovedFromWorldError:
                # This worker left the world: exit with the driver's
                # sentinel code (not success, not a blacklisting failure).
                from ..runner.elastic.constants import EXIT_REMOVED

                log.info("elastic: removed from world; exiting")
                sys.exit(EXIT_REMOVED)
            # Tear down; the next iteration re-forms the world.
            try:
                basics.shutdown()
            except Exception as e:  # keep retrying even if teardown is dirty
                log.warning("elastic: shutdown during reset failed: %s", e)
            needs_reset = True

    return wrapper


class _NotificationManager:
    """Receives host-change notifications from the elastic driver: the
    worker's poll loop calls :meth:`handle_hosts_updated` on a version
    bump, and the next ``state.commit()`` raises ``HostsUpdatedInterrupt``
    (the reference's ``WorkerNotificationService`` push, as a poll)."""

    def __init__(self):
        self._pending = False
        self._initialized = False

    def init(self):
        self._initialized = True

    def handle_hosts_updated(self):
        self._pending = True

    def check_host_updates(self):
        if self._pending:
            self._pending = False
            raise HostsUpdatedInterrupt()

    def clear(self):
        """Drop a stale notification (the worker already joined the epoch
        the notification was about)."""
        self._pending = False


notification_manager = _NotificationManager()
