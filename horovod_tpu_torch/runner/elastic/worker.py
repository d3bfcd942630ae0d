"""Worker-side elastic plumbing: world-version polling, heartbeats,
the abort monitor, assignment fetch.

Port of ``horovod_tpu/runner/elastic/worker.py`` (``ElasticWorkerContext``
:96 with ``fetch_assignment``, ``apply_to_env``, ``check_for_update``,
``start_polling``, ``start_abort_monitor``, ``send_heartbeat`` /
``start_heartbeat``, ``stop_polling`` and ``_exit_driver_lost``;
``record_step``, ``record_commit``, ``announce_done``, ``elastic_enabled``,
``get_worker_context``), the analog of upstream's
``horovod/runner/elastic/worker.py`` inverted for KV polling: workers poll
the rendezvous KV's world version, and a bump arms
``notification_manager`` so the next ``state.commit()`` raises
``HostsUpdatedInterrupt``.

A worker is one process on one GPU slot of a host, named
``<host>:<slot>`` (``HOROVOD_ELASTIC_WORKER``, written by the driver):
its assignment, heartbeat and completion records are keyed by that name.

Liveness: each worker publishes a heartbeat to ``PUT /heartbeat/<worker>``
every ``HOROVOD_ELASTIC_HEARTBEAT_INTERVAL`` seconds, with its step and
commit counters; the driver declares it dead after
``HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT`` of silence. Driver loss: the poll
loop counts consecutive KV failures and, once they have lasted
``HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT`` seconds, exits the process with
``EXIT_DRIVER_LOST``.

Driver takeover (with ``HOROVOD_DRIVER_STATE_DIR`` set; the reference's
``driver_epoch`` :104-107, ``rejoin_timeout`` :324, ``_try_rejoin`` :337
and ``_repoint`` :362): once the rendezvous server stops answering, the
poll loop reads the state directory's endpoint record every
``HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL`` seconds (jittered) and follows a
record of a higher driver epoch whose server answers: it rebuilds its
clients, takes the new epoch (``HOROVOD_DRIVER_EPOCH``) and repoints the
peer replicator, and the successor's abort and generation bump bring the
worker into the new world. It exits with ``EXIT_DRIVER_LOST`` only after
the loss timeout and ``HOROVOD_DRIVER_REJOIN_TIMEOUT`` more seconds.
Without a state directory the driver-lost path is the one above.

Observability (``horovod_tpu/runner/elastic/worker.py:203``,
``:517-606``): each heartbeat carries this process's metrics snapshot
(``"metrics"``, unless ``HOROVOD_METRICS_PIGGYBACK=0``), which the
driver's ``GET /metrics`` renders with per-rank labels; its send and
receive stamps and the server's reply clock feed ``tracing.ClockSync``;
after a beat the tracer's window ships on the heartbeat cadence when
``HOROVOD_TRACE_SAMPLE`` is set. Joining a world rebases the tracer's step
counter, so every member of a generation counts steps from the same join
(the journal's generation stamp follows ``HOROVOD_WORLD_VERSION``, which
:meth:`ElasticWorkerContext.apply_to_env` sets). Following a successor
driver journals ``driver_rejoin``.

A warm spare (``HOROVOD_SPARE=1``, launched by the driver's spare tier;
:meth:`ElasticWorkerContext.wait_for_assignment`, the reference's :208)
starts its poll loop and heartbeat, registers at ``PUT /spare/<worker>``
after its first miss, and parks until a world assigns it: its card and
NCCL group form only then, in ``init()``. A parked spare's heartbeat
carries no comms, memory or integrity payload and it ships no trace (its
launch rank would shadow a real rank's). The heartbeat of a world member
carries its latest integrity fingerprint (``"integrity"``) when
``HOROVOD_INTEGRITY_INTERVAL`` is set.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from ... import (abort, comms_model, faults, integrity, memory, metrics,
                  tracing)
from ...elastic.runner import notification_manager
from ...utils.env import get_float
from ...utils.logging import get_logger
from ..http.kv_server import (ABORT_SCOPE, CLOSING_SCOPE, DONE_SCOPE,
                              HEARTBEAT_SCOPE, KVClient)
from .constants import (EXIT_DRIVER_LOST, POLL_FAILURE_WARN_AFTER,
                        WORKER_ENV, worker_name)


def elastic_enabled() -> bool:
    return os.environ.get("HOROVOD_ELASTIC", "") == "1"


def spare_mode() -> bool:
    """True in a worker the driver launched as a warm spare."""
    return os.environ.get("HOROVOD_SPARE", "") == "1"


class _HeartbeatCounters:
    """Process-wide progress counters piggybacked on every heartbeat."""

    __slots__ = ("steps", "commits", "last_commit_pc")

    def __init__(self):
        self.steps = 0
        self.commits = 0
        self.last_commit_pc: float | None = None


_counters = _HeartbeatCounters()


def record_step() -> None:
    _counters.steps += 1


def record_commit() -> None:
    _counters.commits += 1
    _counters.last_commit_pc = time.perf_counter()


class ElasticWorkerContext:
    """This worker's view of the elastic world, refreshed per epoch."""

    def __init__(self, on_driver_lost=None):
        self.hostname = os.environ.get("HOROVOD_HOSTNAME", "localhost")
        self.name = os.environ.get(WORKER_ENV) or worker_name(self.hostname, 0)
        # The serving driver's epoch, stamped on writes
        # (``X-Hvd-Driver-Epoch``); re-resolving the endpoint raises it,
        # never lowers it.
        self.driver_epoch = int(
            os.environ.get("HOROVOD_DRIVER_EPOCH", "0") or 0)
        self._build_clients(os.environ["HOROVOD_RENDEZVOUS_ADDR"],
                            int(os.environ["HOROVOD_RENDEZVOUS_PORT"]))
        self.version = int(os.environ.get("HOROVOD_WORLD_VERSION", "0"))
        # The generation this worker last JOINED (fetch_assignment): the
        # abort monitor polls it, not `version`, which the poll loop
        # advances the moment the driver bumps the epoch.
        self.joined_version = self.version
        self.consecutive_poll_failures = 0
        self._on_driver_lost = on_driver_lost or self._exit_driver_lost
        self._poller: threading.Thread | None = None
        self._heartbeater: threading.Thread | None = None
        self._abort_poller: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_rejoin_probe = 0.0
        # True while a warm spare is parked on the assignment wait.
        self.parked = False

    def _build_clients(self, addr: str, port: int) -> None:
        """The three KV clients. Every client stamps writes with this
        worker's live generation view, so the server's fence rejects a
        zombie's replays. The heartbeat and abort-poll clients are
        dedicated one-attempt / 2 s clients: the loop itself is the retry,
        and a beat or poll that inherited the full retry budget could
        outlast the deadline it serves."""
        gen_fn = lambda: self.version  # noqa: E731
        epoch_fn = lambda: (  # noqa: E731
            self.driver_epoch if self.driver_epoch > 0 else None)
        self.client = KVClient(addr, port, generation_fn=gen_fn,
                               epoch_fn=epoch_fn)
        self._hb_client = KVClient(addr, port, timeout=2.0, retries=1,
                                   generation_fn=gen_fn, epoch_fn=epoch_fn)
        self._abort_client = KVClient(addr, port, timeout=2.0, retries=1,
                                      generation_fn=gen_fn,
                                      epoch_fn=epoch_fn)

    def fetch_assignment(self, version: int | None = None) -> dict:
        """Read this worker's assignment for a world version (JSON dict with
        process_id / num_processes / local_rank / local_size / cross_rank /
        cross_size / coordinator / hosts).

        Raises ``RemovedFromWorldError`` when the epoch exists but this
        worker is not in it, and ``HorovodInternalError`` for transient KV
        failures (driver restarting / network blip) so the elastic loop
        retries.
        """
        from ...exceptions import HorovodInternalError, RemovedFromWorldError

        # Always read the *latest* world: a worker re-initializing after an
        # interrupt must join the current epoch, not the one it started in.
        try:
            v = self.client.world_version() if version is None else version
            if v < self.version:
                v = self.version
            if version is None:
                v = self._past_closing(v)
            raw = self.client.get(f"world/{v}", self.name)
        except RemovedFromWorldError:
            raise
        except Exception as e:
            raise HorovodInternalError(f"rendezvous KV unreachable: {e}") from e
        if raw is None:
            raise RemovedFromWorldError(
                f"worker {self.name!r} has no assignment in world v{v}"
            )
        self.version = v
        self.joined_version = v
        # Joining the latest epoch satisfies any pending hosts-updated
        # notification, and moots any abort armed for the pre-recovery
        # generation. An abort record ALREADY posted for this generation
        # (a recovery that rejoins the same generation) describes the
        # failure just recovered from, so it is pre-consumed.
        notification_manager.clear()
        try:
            stale = self.client.get(ABORT_SCOPE, str(v))
        except Exception:  # noqa: BLE001 — best-effort staleness marking
            stale = None
        abort.joined_generation(v, stale_record=stale)
        # Every member of this generation counts steps from its join:
        # skew and attribution match spans on (generation, step, name).
        tracing.get_tracer().rebase()
        return json.loads(raw)

    def _past_closing(self, v: int) -> int:
        """The generation to join: ``v``, unless the driver marked it
        closing (``closing/<v>``: it aborts that world or drains a host of
        it, and publishes the next one after); then the next one, once
        published (within ``HOROVOD_ELASTIC_TIMEOUT``). A worker that
        re-joined the closing generation would wait in its group's
        formation for peers that are leaving it. A drained worker leaves
        here (``RemovedFromWorldError``)."""
        from ...elastic.runner import drain_requested
        from ...exceptions import RemovedFromWorldError

        deadline = time.monotonic() + get_float("HOROVOD_ELASTIC_TIMEOUT",
                                                600.0)
        while (time.monotonic() < deadline
               and self.client.get(CLOSING_SCOPE, str(v)) is not None):
            if drain_requested():
                raise RemovedFromWorldError(
                    f"drained while world v{v} re-forms without "
                    f"{self.name!r}")
            time.sleep(0.1)
            v = max(v, self.client.world_version())
        return v

    def wait_for_assignment(self, poll_s: float | None = None) -> dict:
        """A warm spare's wait: register as a spare, then poll until the
        driver publishes a world that assigns this worker (every
        ``HOROVOD_SPARE_POLL_INTERVAL`` seconds, default 0.5). The caller
        starts the poll loop (which keeps the generation fence current)
        and the heartbeat first. A SIGTERM drain while parked raises
        ``RemovedFromWorldError`` (a clean ``EXIT_REMOVED``); a KV failure
        raises ``HorovodInternalError`` and the elastic loop waits again
        (registration is idempotent)."""
        if poll_s is None:
            poll_s = get_float("HOROVOD_SPARE_POLL_INTERVAL", 0.5)
        self.parked = True
        try:
            return self._wait_parked(poll_s)
        finally:
            self.parked = False

    def _wait_parked(self, poll_s: float) -> dict:
        from ...elastic.runner import drain_requested
        from ...exceptions import RemovedFromWorldError
        from ..http.kv_server import SPARE_SCOPE

        announced = registered = False
        while True:
            try:
                assignment = self.fetch_assignment()
            except RemovedFromWorldError:
                if drain_requested():
                    raise RemovedFromWorldError(
                        "spare drained (SIGTERM) while waiting for an "
                        "assignment") from None
                if not announced:
                    # Parked only after the first miss: a promoted spare
                    # re-entering init() after a recovery finds its
                    # assignment at once and must not register again.
                    announced = True
                    get_logger().info(
                        "elastic: warm spare %s — ready, waiting for a "
                        "world assignment", self.name)
                    metrics.event("spare_wait", generation=self.version,
                                  host=self.name)
                if not registered:
                    # Retried each poll until it lands (a KV blip, or a
                    # fence 409 while the world re-formed during the
                    # imports), so a warm spare never stays invisible.
                    try:
                        self.client.put(SPARE_SCOPE, self.name, json.dumps({
                            "host": self.hostname, "pid": os.getpid(),
                            "t": time.time()}).encode())
                        registered = True
                    except Exception as e:  # noqa: BLE001 — advisory
                        get_logger().debug(
                            "elastic: spare registration failed (will "
                            "retry): %s", e)
                time.sleep(poll_s)
                continue
            if announced:
                metrics.event("spare_joined", generation=self.version,
                              host=self.name,
                              rank=assignment.get("process_id"))
                get_logger().info(
                    "elastic: spare %s promoted into world v%d (rank %s)",
                    self.name, self.version, assignment.get("process_id"))
            return assignment

    def apply_to_env(self, assignment: dict) -> None:
        """Refresh the env contract so re-init picks up the new world."""
        # The version keys the coordinator-port KV scope; survivors and
        # newly spawned workers must agree on it.
        os.environ["HOROVOD_WORLD_VERSION"] = str(self.version)
        rank, size = assignment["process_id"], assignment["num_processes"]
        os.environ["HOROVOD_PROCESS_ID"] = str(rank)
        os.environ["HOROVOD_NUM_PROCESSES"] = str(size)
        os.environ["HOROVOD_COORDINATOR_ADDR"] = assignment["coordinator"]
        os.environ["HOROVOD_RANK"] = str(rank)
        os.environ["HOROVOD_SIZE"] = str(size)
        for key, name in (("local_rank", "HOROVOD_LOCAL_RANK"),
                          ("local_size", "HOROVOD_LOCAL_SIZE"),
                          ("cross_rank", "HOROVOD_CROSS_RANK"),
                          ("cross_size", "HOROVOD_CROSS_SIZE")):
            os.environ[name] = str(assignment[key])

    def check_for_update(self) -> bool:
        """One poll: True (and notification armed) if the world moved on."""
        current = self.client.world_version()
        if current != self.version:
            self.version = current
            notification_manager.handle_hosts_updated()
            return True
        return False

    # -- poll loop (with driver-loss escalation) -----------------------------

    def _exit_driver_lost(self, silent_s: float) -> None:
        get_logger().error(
            "elastic: rendezvous KV unreachable for %.0fs "
            "(%d consecutive poll failures) — driver lost; exiting %d",
            silent_s, self.consecutive_poll_failures, EXIT_DRIVER_LOST,
        )
        # os._exit, not sys.exit: this runs on the poller thread while the
        # main thread may be wedged in a collective whose peers died with
        # the driver.
        os._exit(EXIT_DRIVER_LOST)

    def rejoin_timeout(self) -> float:
        """How long past the driver-loss deadline an orphan keeps
        re-resolving the endpoint before it exits ``EXIT_DRIVER_LOST``
        (``HOROVOD_DRIVER_REJOIN_TIMEOUT``, default 600 s); 0, the orphan
        loop off, without a state directory."""
        from . import driver_state

        if driver_state.state_dir() is None:
            return 0.0
        return get_float("HOROVOD_DRIVER_REJOIN_TIMEOUT", 600.0)

    def _try_rejoin(self) -> bool:
        """One re-resolution, at most every
        ``HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL`` seconds (times 1 to 2,
        at random): follow the endpoint record to a successor, a strictly
        higher driver epoch whose server answers, and repoint at it. True
        when it repointed."""
        from . import driver_state

        now = time.monotonic()
        if now < self._next_rejoin_probe:
            return False
        base = get_float("HOROVOD_DRIVER_REJOIN_PROBE_INTERVAL", 1.0)
        self._next_rejoin_probe = now + base * (1.0 + random.random())
        record = driver_state.read_endpoint()
        if record is None or record["driver_epoch"] <= self.driver_epoch:
            return False  # the dead driver's own record, or none yet
        probe = KVClient(record["addr"], record["port"], timeout=2.0,
                         retries=1)
        try:
            probe.world_version()
        except Exception:  # noqa: BLE001 — the successor is not up yet
            return False
        self._repoint(record["addr"], record["port"],
                      record["driver_epoch"])
        return True

    def _repoint(self, addr: str, port: int, epoch: int) -> None:
        """Take a successor driver's endpoint and epoch: rebuild the
        clients, refresh the env (``abort.post`` and the peer replicator
        read the endpoint there) and drop the replicator's client, so the
        next commit puts this rank's record to the new server."""
        get_logger().warning(
            "elastic: rendezvous endpoint re-resolved to %s:%d (driver "
            "epoch %d > %d) — rejoining the restarted driver",
            addr, port, epoch, self.driver_epoch)
        self.driver_epoch = epoch
        os.environ["HOROVOD_RENDEZVOUS_ADDR"] = addr
        os.environ["HOROVOD_RENDEZVOUS_PORT"] = str(port)
        os.environ["HOROVOD_DRIVER_EPOCH"] = str(epoch)
        self._build_clients(addr, port)
        from ... import peercheck

        rep = peercheck.active_replicator()
        if rep is not None:
            rep.repoint()
        metrics.event("driver_rejoin", generation=self.version,
                      host=self.hostname, driver_epoch=epoch,
                      endpoint=f"{addr}:{port}")

    def start_polling(self, interval: float = 1.0) -> None:
        if self._poller is not None:
            return
        self._stop.clear()
        lost_timeout = get_float("HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT", 300.0)

        def loop():
            log = get_logger()
            first_failure: float | None = None
            orphaned = False
            while not self._stop.wait(interval):
                try:
                    self.check_for_update()
                except Exception as e:  # KV unreachable: driver died/restarting
                    now = time.monotonic()
                    if first_failure is None:
                        first_failure = now
                    self.consecutive_poll_failures += 1
                    n = self.consecutive_poll_failures
                    if n >= POLL_FAILURE_WARN_AFTER:
                        log.warning(
                            "elastic poll failed (%d consecutive, "
                            "driver silent %.0fs): %s",
                            n, now - first_failure, e,
                        )
                    else:
                        log.debug("elastic poll failed: %s", e)
                    budget = self.rejoin_timeout()
                    if budget <= 0:
                        if (lost_timeout > 0
                                and now - first_failure >= lost_timeout):
                            self._on_driver_lost(now - first_failure)
                        continue
                    # The orphan loop: a supervisor may be starting a
                    # successor; follow its endpoint record, and give up
                    # only at the loss timeout plus the rejoin budget.
                    try:
                        if self._try_rejoin():
                            first_failure = None
                            orphaned = False
                            self.consecutive_poll_failures = 0
                            continue
                    except Exception as re:  # noqa: BLE001
                        log.debug("elastic rejoin probe failed: %s", re)
                    if (lost_timeout > 0 and not orphaned
                            and now - first_failure >= lost_timeout):
                        orphaned = True
                        log.warning(
                            "elastic: driver lost for %.0fs — waiting "
                            "another %.0fs for a successor's endpoint "
                            "before exit %d", now - first_failure, budget,
                            EXIT_DRIVER_LOST)
                    if (lost_timeout > 0 and now - first_failure
                            >= lost_timeout + budget):
                        self._on_driver_lost(now - first_failure)
                else:
                    if self.consecutive_poll_failures >= \
                            POLL_FAILURE_WARN_AFTER:
                        log.info(
                            "elastic: rendezvous KV reachable again after "
                            "%d failed polls", self.consecutive_poll_failures,
                        )
                    self.consecutive_poll_failures = 0
                    first_failure = None
                    orphaned = False

        self._poller = threading.Thread(
            target=loop, name="hvd-elastic-poll", daemon=True
        )
        self._poller.start()
        self.start_abort_monitor()

    # -- coordinated-abort monitor -------------------------------------------

    def start_abort_monitor(self, interval: float | None = None) -> None:
        """Mirror the KV's ``abort/<generation>`` flag into process-local
        state (``horovod_tpu_torch.abort``), so that every blocking site
        turns a wedge into ``HorovodInternalError`` within one poll
        interval. Started with the poll loop."""
        if self._abort_poller is not None:
            return
        if interval is None:
            interval = abort.poll_interval()
        if interval <= 0:
            return  # explicitly disabled

        def loop():
            log = get_logger()
            while not self._stop.wait(interval):
                try:
                    abort.poll_once(self._abort_client,
                                    generation=self.joined_version)
                except Exception as e:  # KV unreachable: the poll loop
                    log.debug("abort poll failed: %s", e)  # owns escalation

        self._abort_poller = threading.Thread(
            target=loop, name="hvd-elastic-abort", daemon=True
        )
        self._abort_poller.start()

    # -- heartbeat sender ----------------------------------------------------

    def send_heartbeat(self) -> bool:
        """Publish one heartbeat; returns False when dropped/failed.
        Failures are swallowed: the poll loop owns driver-loss escalation,
        and a missed heartbeat only matters to the driver's deadline.

        The beat carries the metrics snapshot (the cluster scrape) and the
        comms-model and memory payloads (``GET /comms``, ``GET /memory``),
        and its round trip is a clock-offset sample (``tracing.ClockSync``:
        the server's reply carries its wall clock); after it the tracer's
        window ships, at most every ``HOROVOD_TRACE_SHIP_SECONDS``, when
        shipping is on."""
        if faults.fire(faults.HEARTBEAT_SEND):
            return False  # injected drop: silence, exactly like a hang
        clock = tracing.clock_sync()
        body = {
            "steps": _counters.steps,
            "commits": _counters.commits,
            "rank": os.environ.get("HOROVOD_RANK", "0"),
            "time": clock.now(),
        }
        if os.environ.get("HOROVOD_METRICS_PIGGYBACK", "1") != "0":
            body["metrics"] = metrics.snapshot()
            # The comms and memory observatories ride the same beat (a
            # handful of fits, a few ints), so the rendezvous server's
            # GET /comms and GET /memory serve cluster-merged views; a
            # parked spare has no world rank and sends neither.
            try:
                if not self.parked:
                    body["comms"] = comms_model.get_model().payload()
                    body["memory"] = memory.get_observatory().payload()
            except Exception:  # noqa: BLE001 — liveness beats observability
                pass
        # The integrity plane's latest fingerprint (one digest and a few
        # summaries) rides the beat, armed by its own knob: the driver's
        # vote sees every rank's record with no route of its own.
        rec = None if self.parked else integrity.heartbeat_payload()
        if rec is not None:
            body["integrity"] = rec
        try:
            t_send = clock.now()
            reply = self._hb_client.put(HEARTBEAT_SCOPE, self.name,
                                        json.dumps(body).encode())
            t_recv = clock.now()
        except Exception as e:
            get_logger().debug("elastic: heartbeat send failed: %s", e)
            return False
        t_server = json.loads(reply or b"{}").get("t_server")
        if t_server is not None:
            clock.observe(t_send, t_recv, float(t_server))
        if not self.parked:
            tracing.maybe_ship_heartbeat()
        return True

    def start_heartbeat(self, interval: float | None = None) -> None:
        if self._heartbeater is not None:
            return
        if interval is None:
            interval = get_float("HOROVOD_ELASTIC_HEARTBEAT_INTERVAL", 2.0)
        if interval <= 0:
            return  # explicitly disabled

        def loop():
            # First beat at once: the driver's never-heartbeated grace
            # window should cover process startup, not the first interval.
            self.send_heartbeat()
            while not self._stop.wait(interval):
                self.send_heartbeat()

        self._heartbeater = threading.Thread(
            target=loop, name="hvd-elastic-heartbeat", daemon=True
        )
        self._heartbeater.start()

    def stop_polling(self) -> None:
        self._stop.set()
        for attr in ("_poller", "_heartbeater", "_abort_poller"):
            t = getattr(self, attr)
            if t is not None:
                t.join(timeout=5)
                setattr(self, attr, None)


_context: ElasticWorkerContext | None = None


def get_worker_context() -> ElasticWorkerContext:
    global _context
    if _context is None:
        _context = ElasticWorkerContext()
    return _context


def announce_done() -> None:
    """Best-effort completion record (``PUT /done/<worker>``), published
    when the elastic training function returns. Not generation-fenced: a
    worker finishing while the driver is mid-reconfiguration must still
    land it. Failures are swallowed."""
    ctx = _context
    if ctx is None or not elastic_enabled():
        return
    try:
        client = KVClient(
            os.environ["HOROVOD_RENDEZVOUS_ADDR"],
            int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
            timeout=5.0, retries=3)
        client.put(DONE_SCOPE, ctx.name, json.dumps({
            "host": ctx.hostname,
            "rc": 0,
            "generation": ctx.joined_version,
            "t": time.time(),
        }).encode())
    except Exception as e:  # noqa: BLE001 — advisory record only
        get_logger().debug("elastic: completion announce failed: %s", e)
