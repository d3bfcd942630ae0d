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

Observability (``horovod_tpu/elastic/runner.py:160-500``): the goodput
clock (``metrics.goodput()``: formation and sync as ``rendezvous``, the
restores, the backoff, a failed attempt's tail after its last commit as
``failed_attempt``), ``hvd_recoveries_total{rung}``, the journal's
``elastic_run_start``, ``world_synced``, ``recovery``, ``peer_fallback``,
``checkpoint_fallback``, ``hosts_updated``, ``removed_from_world`` and
``drain_requested``, and the flight records of a peer restore and a drain.

The storage-free rewind (``horovod_tpu/elastic/runner.py:296-360``): a
``LossSpikeError`` (``integrity.observe_loss``) is a voluntary rollback,
not a failure of the world: ``state.restore()`` to the last commit,
completed through the peer rung when the commit is shard-local, with no
step of the ladder, counted in ``hvd_rewinds_total{reason="loss_spike"}``
and journaled (``rewind``, a flight record). ``HOROVOD_REWIND_MAX``
consecutive rewinds without a landed commit trip the storm breaker
(``rewind_storm``): the spike then takes the ladder like any failure.
"""

from __future__ import annotations

import functools
import signal
import sys
import threading
import time

from .. import abort, basics, metrics, tracing
from ..exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
    LossSpikeError,
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
            metrics.event("drain_requested")
            # What this rank was doing when the notice landed.
            tracing.dump_flight_record("drain_requested")
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
        consecutive_rewinds = 0
        commits_before_attempt = 0
        goodput = metrics.goodput()
        metrics.event("elastic_run_start")

        while True:
            t_attempt = time.perf_counter()
            run_started = None
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
                metrics.event("world_synced",
                              generation=abort.current_generation(),
                              np=basics.size(), skip_sync=skip_sync)
                from ..runner.elastic.worker import _counters

                # Snapshot taken AFTER sync (which commits internally):
                # only commits the training function itself lands count as
                # progress for the storm breaker.
                commits_before_attempt = _counters.commits
                # Formation + sync is rendezvous loss; the attempt's own
                # time is booked by how it ends: up to the last commit is
                # productive, a failed attempt's tail after it (its work
                # replays) is lost to failed_attempt.
                goodput.add_lost("rendezvous",
                                 time.perf_counter() - t_attempt)
                run_started = time.perf_counter()
                try:
                    result = func(state, *args, **kwargs)
                except HorovodInternalError:
                    now = time.perf_counter()
                    last = _counters.last_commit_pc
                    if (_counters.commits > commits_before_attempt
                            and last is not None
                            and run_started <= last <= now):
                        goodput.add_productive(last - run_started)
                        goodput.add_lost("failed_attempt", now - last)
                    else:
                        goodput.add_lost("failed_attempt",
                                         now - run_started)
                    raise
                except BaseException:
                    # Host updates, drains and user errors end at a
                    # consistent point: their time is kept work.
                    goodput.add_productive(time.perf_counter() - run_started)
                    raise
                goodput.add_productive(time.perf_counter() - run_started)
                from ..runner.elastic.worker import announce_done

                announce_done()
                return result
            except HorovodInternalError as e:
                from .. import stall
                from ..runner.elastic.worker import _counters

                if run_started is None:
                    # Died in formation or sync: rendezvous loss.
                    goodput.add_lost("rendezvous",
                                     time.perf_counter() - t_attempt)

                # Progress (a commit landed inside the attempt) resets both
                # storm breakers.
                if _counters.commits > commits_before_attempt:
                    consecutive_failures = 0
                    consecutive_rewinds = 0
                consecutive_failures += 1
                commits_before_attempt = _counters.commits
                # This failure consumed any armed coordinated abort, and the
                # stall inspector's verdict with it.
                abort.consume()
                stall.get_inspector().failed = False
                if isinstance(e, LossSpikeError):
                    rewound, consecutive_rewinds = _rewind(
                        state, e, consecutive_rewinds, goodput, log)
                    if rewound:
                        # Voluntary: not a ladder step, not storm evidence.
                        # The world re-forms at the same generation (the
                        # abort the spike posted ended its communicators).
                        consecutive_failures -= 1
                        skip_sync = False
                        _backoff(consecutive_failures, recovery_backoff_max,
                                 goodput)
                        _teardown(log)
                        needs_reset = True
                        continue
                if max_recovery > 0 and consecutive_failures >= max_recovery:
                    log.error(
                        "elastic: %d consecutive recovery attempts with no "
                        "progress (HOROVOD_RECOVERY_MAX_ATTEMPTS=%d); "
                        "giving up", consecutive_failures, max_recovery,
                    )
                    metrics.event("recovery_exhausted",
                                  generation=abort.current_generation(),
                                  failures=consecutive_failures,
                                  error=str(e)[:300])
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
                metrics.RECOVERIES.inc(rung=rung)
                metrics.event("recovery",
                              generation=abort.current_generation(),
                              rung=rung, failures=consecutive_failures,
                              error=str(e)[:300])
                t_restore = time.perf_counter()
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
                        if restored:
                            tracing.dump_flight_record(
                                "peer_restore",
                                generation=abort.current_generation())
                        else:
                            metrics.event(
                                "peer_fallback",
                                generation=abort.current_generation())
                            metrics.RECOVERIES.inc(rung="durable")
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
                        metrics.event("checkpoint_fallback",
                                      generation=abort.current_generation(),
                                      durable_restored=bool(restored))
                    if not restored and basics.is_initialized():
                        state.restore()
                goodput.add_lost("restore", time.perf_counter() - t_restore)
                skip_sync = False
                _backoff(consecutive_failures, recovery_backoff_max, goodput)
            except HostsUpdatedInterrupt as e:
                log.info("elastic: hosts updated; re-syncing")
                if run_started is None:
                    goodput.add_lost("rendezvous",
                                     time.perf_counter() - t_attempt)
                metrics.event("hosts_updated",
                              generation=abort.current_generation(),
                              skip_sync=e.skip_sync)
                skip_sync = e.skip_sync
                _leave_generation()
            except RemovedFromWorldError:
                # This worker left the world: exit with the driver's
                # sentinel code (not success, not a blacklisting failure).
                from ..runner.elastic.constants import EXIT_REMOVED

                metrics.event("removed_from_world",
                              generation=abort.current_generation())
                log.info("elastic: removed from world; exiting")
                sys.exit(EXIT_REMOVED)
            # Tear down; the next iteration re-forms the world.
            _teardown(log)
            needs_reset = True

    return wrapper


def _backoff(failures: int, cap: float, goodput) -> None:
    """Sleep 0.5 s x 2^(failures - 1), at most ``cap``, booked as lost."""
    t0 = time.perf_counter()
    time.sleep(min(0.5 * (2 ** (failures - 1)), cap))
    goodput.add_lost("backoff", time.perf_counter() - t0)


def _teardown(log) -> None:
    try:
        basics.shutdown()
    except Exception as e:  # keep retrying even if teardown is dirty
        log.warning("elastic: shutdown during reset failed: %s", e)


def _rewind(state, e, consecutive: int, goodput, log) -> tuple[bool, int]:
    """The storage-free rewind of a ``LossSpikeError`` (the JAX package's
    ``runner.py:296-360``): ``state.restore()``, completed through the peer
    rung when the state's commit is shard-local, unless
    ``HOROVOD_REWIND_MAX`` consecutive rewinds found no commit in between
    (the storm breaker, journaled ``rewind_storm``). Returns (rewound, the
    consecutive count); not rewound, the spike takes the ladder."""
    from .. import integrity

    cap = integrity.rewind_max()
    if cap > 0 and consecutive >= cap:
        log.error(
            "elastic: loss-spike rewind storm breaker tripped (%d "
            "consecutive rewinds with no commit; HOROVOD_REWIND_MAX=%d) — "
            "escalating through the normal recovery ladder",
            consecutive, cap)
        metrics.event("rewind_storm",
                      generation=abort.current_generation(),
                      consecutive=consecutive)
        return False, consecutive
    consecutive += 1
    log.warning(
        "elastic: %s — storage-free rewind to the last commit (%d "
        "consecutive; HOROVOD_REWIND_MAX=%d)", e, consecutive, cap)
    t_restore = time.perf_counter()
    try:
        if basics.is_initialized():
            state.restore()
        rewound = True
        if state.peer_restore_pending():
            # A shard-local snapshot: the peer rung completes the rewind.
            rewound = bool(state.restore_peer())
    except Exception as pe:  # noqa: BLE001
        log.error("elastic: spike rewind could not restore (%s); falling "
                  "through to the recovery ladder", pe)
        rewound = False
    goodput.add_lost("restore", time.perf_counter() - t_restore)
    if rewound:
        integrity.record_rewind("loss_spike",
                                generation=abort.current_generation(),
                                consecutive=consecutive, detail=str(e))
        tracing.dump_flight_record("rewind",
                                   generation=abort.current_generation())
    return rewound, consecutive


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
