"""The elastic driver: keeps min_np ≤ world ≤ max_np across host churn.

Port of ``horovod_tpu/runner/elastic/driver.py`` (``ElasticDriver`` :96:
``_wait_for_available_slots`` :337, ``_publish_world`` :360,
``_launch_missing_workers`` :399, ``_reconfigure`` :491, ``run`` :608,
``_dead_by_heartbeat`` :687, ``_post_abort`` :722, ``_blacklist`` :736,
``_install_sigterm_forwarder`` :934, ``_monitor`` :1247; ``run_elastic``
:1445), itself the analog of upstream's
``horovod/runner/elastic/driver.py``: it polls host discovery, launches
and monitors workers, blacklists failing hosts, re-forms the world on
change, and tells the survivors.

The process model is the port's: one worker per GPU slot, named
``<host>:<slot>``. The driver publishes each world epoch to its rendezvous
KV server:

- ``GET /_version``                         → the world version (bumped on
  every reconfiguration; workers poll it)
- ``GET /world/<version>/<host>:<slot>``    → that worker's assignment:
  ``{"process_id", "num_processes", "local_rank", "local_size",
  "cross_rank", "cross_size", "coordinator", "hosts"}``

A version bump surfaces in the workers as ``HostsUpdatedInterrupt`` at
their next commit; a worker absent from the new epoch exits with
``EXIT_REMOVED``. When a worker fails (any other non-zero exit) or stops
heartbeating, the driver posts the coordinated abort for the dying
generation FIRST, so that the survivors waiting on it in a collective
unblock, then blacklists its host and re-forms the world.

Crash-restart takeover (``HOROVOD_DRIVER_STATE_DIR`` set; ``_AdoptedPopen``
:60, the store :119-130, ``_save_state`` :240, ``_publish_endpoint`` :261,
``_state_env`` :280, ``_adopt_from_snapshot`` :293, ``_prepare_takeover``
:532 and ``run`` :600-660): the driver claims a new driver epoch, journals
its state (``driver_state.py``) at every change and every
``HOROVOD_DRIVER_STATE_REFRESH`` seconds, and publishes its endpoint with
every world. A driver started with the same command and state directory
after its predecessor died resumes the snapshot: the job's secret, the
generation (its server starts there, so its first world is g+1), the
blacklist, and the live workers, adopted by pid when their start ticks
still match. It posts the coordinated abort for the old generation, so
every adopted worker rolls back and joins the new world, having followed
the endpoint record to the new server (``worker.py``). A driver that finds
a higher epoch on disk stands down with ``EXIT_DRIVER_SUPERSEDED`` and
touches no worker. The snapshot holds the world, the blacklist, the
workers and spares, the driver-lost counts, the generation and the epoch,
the integrity strikes, the last voted group and outlier, the server's
quarantine map and the policy's state (``:204-233``, ``:538-577``).

Observability: the driver journals ``driver_start``, ``world_published``,
``driver_takeover``, ``driver_superseded``, ``abort_posted``,
``blacklist``, ``worker_exit``, ``driver_lost``, ``worker_hung`` and
``job_complete`` (``HOROVOD_EVENT_LOG``), sets ``hvd_driver_epoch`` and
counts ``hvd_driver_lost_total`` and ``hvd_driver_takeovers_total``, and
keeps its server's scrape gauges (world size, blacklisted hosts,
driver-lost counts) current.

The robustness plane (``:745-1240``):

- **Warm spares** (``HOROVOD_WARM_SPARES``): the host manager holds spare
  hosts out of the world; the driver keeps one worker per slot of each
  parked on the assignment wait (``HOROVOD_SPARE=1``; ``_launch_spare``,
  ``_retire_spare``, ``_ensure_spares``) and moves it into the next world
  that assigns its slot instead of a cold launch (``spare_promoted``; the
  ``spare.promote`` fault point forces the cold launch).
- **Drains** (``_drain_host``): SIGTERM every worker of a host (each ends
  with a final commit and ``EXIT_REMOVED``, within
  ``HOROVOD_POLICY_DRAIN_GRACE`` seconds), then the abort, the blacklist
  and a new world
  (``policy_drain``, a flight record with the host's last trace). An
  external ``PUT /preempt/<host>`` notice drains that host.
- **The integrity tick** (``HOROVOD_INTEGRITY_INTERVAL``): the newest
  complete group of the heartbeats' fingerprints is voted once; a named
  outlier is journaled (``integrity_divergence``), counted, quarantined on
  the server (back-dated to its previous fingerprint when that one already
  disagreed), struck, and under ``HOROVOD_INTEGRITY_ACTION=drain`` drained
  after ``HOROVOD_INTEGRITY_CONFIRMATIONS`` consecutive strikes, the abort
  posted first. With two voters, an ambiguous vote whose outlier's
  previous digest is the one the last vote condemned is that corruption
  persisting (``method="continuity"``).
- **The policy tick** (``elastic/policy.py``, ``HOROVOD_TARGET_GOODPUT``):
  the spares reconciled, the notices handled, and (armed) the skew,
  heartbeat, comms-residual and regression evidence folded, a decision
  taken and drained, its realized goodput journaled
  (``policy_decision``); the ``policy.decide`` fault point is the
  controller's.

The policy's and the vote's unit is the worker (``<host>:<slot>``, the key
of heartbeats, traces and integrity records); a drain takes the worker's
whole host out.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

from ... import faults, metrics
from ...elastic.policy import PolicyController
from ...exceptions import HostDiscoveryFailedError
from ...utils.env import get_float
from ...utils.logging import get_logger
from ..exec_utils import (
    WorkerProc,
    build_worker_env,
    drain_worker,
    launch_worker,
    terminate_worker,
    terminate_workers,
)
from ..hosts import HostInfo, ProcessAssignment, get_host_assignments
from ..http.kv_server import RendezvousServer
from ..network import coordinator_addr, driver_addr, free_port
from . import driver_state
from .constants import (EXIT_DRIVER_LOST, EXIT_DRIVER_SUPERSEDED,
                        EXIT_REMOVED, WORKER_ENV, worker_name)
from .discovery import FixedHostDiscovery, HostDiscoveryScript, HostManager

WORLD_SCOPE = "world"


def _slots(hosts: list[HostInfo]) -> int:
    return sum(h.slots for h in hosts)


def _host_of(name: str) -> str:
    return name.rsplit(":", 1)[0]


class _AdoptedPopen:
    """The liveness of a worker this driver did not start: a restarted
    driver adopts its predecessor's live workers by pid (they outlived the
    crash in sessions of their own). ``poll()`` answers through signal 0;
    the exit code of a process that is not a child cannot be read, so the
    monitor learns an adopted worker's completion from its done record."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: int | None = None

    def poll(self) -> int | None:
        if self.returncode is None and not _pid_alive(self.pid):
            self.returncode = 0  # a sentinel: the monitor checks the type
        return self.returncode


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    # An exited orphan that its new parent has not reaped yet is a zombie:
    # signal 0 still reaches it.
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b")", 1)[1].split()[0] != b"Z"
    except (OSError, IndexError):
        return True


class ElasticDriver:
    def __init__(
        self,
        settings,  # runner.launch.Settings
        discovery=None,
        sink=None,
        poll_interval: float = 1.0,
    ):
        self._settings = settings
        self._log = get_logger()
        self._sink = sink
        self._poll_interval = poll_interval
        if discovery is None:
            if settings.discovery_script:
                discovery = HostDiscoveryScript(settings.discovery_script)
            else:
                discovery = FixedHostDiscovery(settings.hosts)
        self._manager = HostManager(discovery)
        from .. import secret as _secret

        # The durable control-plane state first: the predecessor's snapshot
        # carries the job's HMAC secret, which the server below must serve
        # with (a fresh key would answer every orphaned worker 403).
        # Without HOROVOD_DRIVER_STATE_DIR: no store, epoch 0, no writes.
        self._store: driver_state.DriverStateStore | None = None
        self._snapshot: dict | None = None
        sdir = driver_state.state_dir()
        if sdir is not None:
            self._store, self._snapshot = driver_state.DriverStateStore.open(
                sdir)
            if self._snapshot is not None:
                prev_secret = self._snapshot.get("secret_key")
                if prev_secret:
                    os.environ[_secret.ENV_KEY] = str(prev_secret)
        # Secret before server construction: the server snapshots its HMAC
        # key at __init__.
        os.environ.setdefault(_secret.ENV_KEY, _secret.make_secret_key())
        self._server = RendezvousServer()
        self._workers: dict[str, WorkerProc] = {}
        self._launched_at: dict[str, float] = {}  # worker -> monotonic launch
        self._driver_lost_counts: dict[str, int] = {}  # consecutive rc=203
        self._world_hosts: list[HostInfo] = []
        self._coord_port: int = 0
        self._draining = False
        self._min_np = settings.min_np or 1
        self._max_np = settings.max_np
        # Liveness plane: a worker silent for hb_timeout seconds is
        # declared dead (hung, not crashed — popen.poll() cannot see it).
        # 0 disables enforcement. A worker that has NEVER heartbeated gets
        # hb_grace from its launch instead, covering interpreter and
        # framework startup.
        self._hb_timeout = get_float("HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", 0.0)
        self._hb_grace = get_float(
            "HOROVOD_ELASTIC_HEARTBEAT_GRACE",
            max(10.0 * self._hb_timeout, 60.0),
        )
        self._superseded = False
        self._last_state_save = 0.0
        self._state_refresh_s = get_float("HOROVOD_DRIVER_STATE_REFRESH",
                                          10.0)
        # The self-healing policy (inert without HOROVOD_TARGET_GOODPUT or
        # HOROVOD_POLICY_INTEGRITY_STRIKES) and the spare fleet (governed
        # by HOROVOD_WARM_SPARES through the host manager).
        self._policy = PolicyController(min_np=self._min_np)
        self._spare_procs: dict[str, WorkerProc] = {}
        self._rate_state: dict[str, tuple[float, float]] = {}
        self._last_policy_tick = 0.0
        # The integrity vote (armed by HOROVOD_INTEGRITY_INTERVAL): strikes
        # per worker, the last group acted on, and (rank, condemned digest)
        # of the last named outlier for the two-voter continuity rule.
        self._integrity_strikes: dict[str, int] = {}
        self._last_integrity_tick = 0.0
        self._last_integrity_hb_version = -1
        self._integrity_acted_group: tuple[int, int] = (-1, -1)
        self._last_outlier: tuple[int, str] | None = None

    # -- durable control-plane state -----------------------------------------

    @property
    def driver_epoch(self) -> int:
        return self._store.epoch if self._store is not None else 0

    @staticmethod
    def _proc_record(w: WorkerProc) -> dict:
        pid = int(w.popen.pid)
        # The start ticks guard adoption against a recycled pid.
        return {"pid": pid, "local": w.remote_host is None,
                "start_ticks": driver_state.proc_start_ticks(pid)}

    def _snapshot_record(self) -> dict:
        """What a successor needs to re-form the world at g+1: membership,
        the generation, the blacklist's ages, the live workers, the
        driver-lost counts and the job's secret (the state directory is
        the operator's only, 0700)."""
        return {
            "generation": self._server.generation,
            "min_np": self._min_np,
            "max_np": self._max_np,
            "world": [[h.hostname, h.slots] for h in self._world_hosts],
            "workers": {n: self._proc_record(w)
                        for n, w in self._workers.items()},
            "spares": {n: self._proc_record(w)
                       for n, w in self._spare_procs.items()},
            "blacklist": self._manager.export_blacklist(),
            "driver_lost_counts": dict(self._driver_lost_counts),
            "integrity_strikes": dict(self._integrity_strikes),
            # The last voted group: a successor re-voting the same staged
            # group must not strike twice.
            "integrity_acted_group": list(self._integrity_acted_group),
            "integrity_last_outlier": (list(self._last_outlier)
                                       if self._last_outlier else None),
            # A successor's fresh server must fence the same ranks.
            "integrity_quarantine": self._server.quarantine_export(),
            "policy": self._policy.export_state(),
            "secret_key": os.environ.get("HOROVOD_SECRET_KEY", ""),
        }

    def _save_state(self) -> None:
        """Journal the snapshot (at every change, and every
        HOROVOD_DRIVER_STATE_REFRESH seconds from the monitor). A fenced
        write means a successor owns the state: this driver stands down.
        Any other failure is logged and survived."""
        if self._store is None or self._superseded:
            return
        try:
            self._store.save(self._snapshot_record())
            self._last_state_save = time.monotonic()
        except driver_state.DriverFencedError as e:
            self._log.error("elastic: %s", e)
            self._superseded = True
        except Exception as e:  # noqa: BLE001 — the snapshot is best-effort
            self._log.warning(
                "elastic: control-plane snapshot failed (%s); takeover "
                "would resume from the previous snapshot", e)

    def _publish_endpoint(self) -> None:
        """Refresh the endpoint record orphaned workers re-resolve the
        rendezvous server from (fenced like the snapshot)."""
        if self._store is None or self._superseded:
            return
        addr = driver_addr([h.hostname for h in self._world_hosts]
                           or ["localhost"])
        try:
            self._store.publish_endpoint(addr, self._server.port,
                                         self._server.generation)
        except driver_state.DriverFencedError as e:
            self._log.error("elastic: %s", e)
            self._superseded = True
        except Exception as e:  # noqa: BLE001
            self._log.warning(
                "elastic: endpoint record publish failed (%s); orphaned "
                "workers cannot rejoin until it lands", e)

    def _state_env(self) -> dict[str, str]:
        """The workers' env for the control-plane state: its directory
        (orphans re-resolve the endpoint from it) and the driver epoch
        (the fence identity of their writes). Empty without a store."""
        if self._store is None:
            return {}
        return {
            driver_state.ENV_STATE_DIR: self._store.directory,
            driver_state.ENV_DRIVER_EPOCH: str(self._store.epoch),
        }

    def _adopt_from_snapshot(self, snap: dict) -> list[str]:
        """Adopt the predecessor's live local workers by pid, refusing a
        pid whose start ticks no longer match the snapshot's (a recycled
        pid names another process). Remote workers cannot be adopted (their
        ssh client died with the predecessor); the normal path launches
        them again."""
        adopted: list[str] = []
        for table, target in (("workers", self._workers),
                              ("spares", self._spare_procs)):
            for name, info in (snap.get(table) or {}).items():
                if not isinstance(info, dict) or not info.get("local"):
                    continue
                try:
                    pid = int(info.get("pid"))
                except (TypeError, ValueError):
                    continue
                if not _pid_alive(pid):
                    continue
                recorded = info.get("start_ticks")
                if recorded is not None:
                    ticks = driver_state.proc_start_ticks(pid)
                    if ticks is not None and ticks != recorded:
                        self._log.warning(
                            "elastic: pid %d of %s was recycled (start "
                            "ticks %s != recorded %s); not adopting", pid,
                            name, ticks, recorded)
                        continue
                assignment = ProcessAssignment(
                    hostname=_host_of(name), rank=0, size=1, local_rank=0,
                    local_size=1, cross_rank=0, cross_size=1)
                target[name] = WorkerProc(assignment, _AdoptedPopen(pid),
                                          None)
                self._launched_at[name] = time.monotonic()
                adopted.append(name)
                self._log.info("elastic: adopted orphaned %s %s (pid %d)",
                               table[:-1], name, pid)
        return adopted

    def _prepare_takeover(self) -> bool:
        """Resume the predecessor's state (the ``driver.takeover`` fault
        point): seed the fresh server with the snapshot's generation and
        this driver's epoch, and restore the blacklist, the driver-lost
        counts and the world. True when a snapshot was resumed."""
        snap = self._snapshot
        if self._store is None or snap is None:
            if self._store is not None:
                self._server.seed(driver_epoch=self._store.epoch)
                metrics.DRIVER_EPOCH.set(self._store.epoch)
            return False
        if faults.fire(faults.DRIVER_TAKEOVER):
            raise faults.InjectedFault("driver takeover dropped (injected)")
        try:
            generation = int(snap.get("generation", 0))
        except (TypeError, ValueError):
            generation = 0
        self._server.seed(generation=generation,
                          driver_epoch=self._store.epoch)
        metrics.DRIVER_EPOCH.set(self._store.epoch)
        self._manager.restore_blacklist(snap.get("blacklist"))
        self._policy.restore_state(snap.get("policy"))
        acted = snap.get("integrity_acted_group")
        if isinstance(acted, (list, tuple)) and len(acted) == 2:
            try:
                self._integrity_acted_group = (int(acted[0]), int(acted[1]))
            except (TypeError, ValueError):
                pass
        outlier = snap.get("integrity_last_outlier")
        if isinstance(outlier, (list, tuple)) and len(outlier) == 2:
            try:
                self._last_outlier = (int(outlier[0]), str(outlier[1]))
            except (TypeError, ValueError):
                pass
        self._server.restore_quarantine(snap.get("integrity_quarantine"))
        strikes = snap.get("integrity_strikes")
        if isinstance(strikes, dict):
            # A corrupting worker keeps its record across the flap.
            for name, n in strikes.items():
                try:
                    self._integrity_strikes[str(name)] = int(n)
                except (TypeError, ValueError):
                    continue
        counts = snap.get("driver_lost_counts")
        if isinstance(counts, dict):
            for name, n in counts.items():
                try:
                    self._driver_lost_counts[str(name)] = int(n)
                except (TypeError, ValueError):
                    continue
            # The scrape's counts resume with the cap's.
            self._server.seed_driver_lost(self._driver_lost_counts)
        # The snapshot's membership first, for stable ranks.
        world = []
        for entry in snap.get("world") or []:
            try:
                world.append(HostInfo(str(entry[0]), int(entry[1])))
            except (TypeError, ValueError, IndexError):
                continue
        self._world_hosts = world
        self._log.warning(
            "elastic: taking over from driver epoch %d at generation %d "
            "(world %s, %d blacklisted)", self._store.epoch - 1,
            generation, [h.hostname for h in world],
            self._manager.blacklist_count())
        metrics.DRIVER_TAKEOVERS.inc()
        return True

    # -- world formation -----------------------------------------------------

    def _pick(self) -> list[HostInfo]:
        """The next world's hosts: ``HostManager.pick_world`` (current
        hosts first), then at most ``max_np`` slots in all, the last host
        cut short where needed."""
        hosts = self._manager.pick_world(
            [h.hostname for h in self._world_hosts], self._max_np)
        if self._max_np is None:
            return hosts
        out, left = [], self._max_np
        for h in hosts:
            if left <= 0:
                break
            out.append(HostInfo(h.hostname, min(h.slots, left)))
            left -= out[-1].slots
        return out

    def _wait_for_available_slots(self, min_np: int,
                                  timeout: float) -> list[HostInfo]:
        """Block until discovery yields ≥ min_np usable slots (parity:
        ``ElasticDriver.wait_for_available_slots``)."""
        deadline = time.time() + timeout
        while True:
            try:
                self._manager.update_available_hosts()
            except HostDiscoveryFailedError:
                raise  # sustained streak: the driver is blind — fail loudly
            except Exception as e:  # discovery script hiccup: retry
                self._log.warning("elastic: discovery failed (%s); retrying", e)
            hosts = self._pick()
            if _slots(hosts) >= min_np:
                return hosts
            if time.time() >= deadline:
                raise TimeoutError(
                    f"elastic: {_slots(hosts)} slot(s) available after "
                    f"{timeout:.0f}s; need min_np={min_np}"
                )
            time.sleep(self._poll_interval)

    def _publish_world(self, hosts: list[HostInfo]) -> int:
        """Publish the new epoch's assignments, then bump the version (the
        scope is written before the bump so in-flight workers of the
        previous epoch never read a hole)."""
        assignments = get_host_assignments(hosts)
        coord = coordinator_addr([h.hostname for h in hosts])
        # Rank 0 picks the real port on its own host and publishes it under
        # coord/<version> (basics._exchange_coordinator_port); this one
        # serves a worker that has no rendezvous address.
        self._coord_port = free_port()
        data = {
            worker_name(a.hostname, a.local_rank): json.dumps(
                {
                    "process_id": a.rank,
                    "num_processes": a.size,
                    "local_rank": a.local_rank,
                    "local_size": a.local_size,
                    "cross_rank": a.cross_rank,
                    "cross_size": a.cross_size,
                    "coordinator": f"{coord}:{self._coord_port}",
                    "hosts": [[h.hostname, h.slots] for h in hosts],
                }
            ).encode()
            for a in assignments
        }
        version = self._server.publish_epoch(WORLD_SCOPE, data)
        self._world_hosts = hosts
        self._server.set_cluster_info(
            world_np=len(hosts), ranks=_slots(hosts),
            blacklisted=self._manager.blacklist_count())
        metrics.event(
            "world_published", generation=version, np=len(hosts),
            hosts=[h.hostname for h in hosts],
            driver_epoch=self.driver_epoch)
        # Every world refreshes the endpoint record and the snapshot.
        self._publish_endpoint()
        self._save_state()
        return version

    def _launch_missing_workers(self, version: int) -> None:
        assignments = get_host_assignments(self._world_hosts)
        hostnames = [h.hostname for h in self._world_hosts]
        kv_addr = driver_addr(hostnames)
        coord = coordinator_addr(hostnames)
        for a in assignments:
            name = worker_name(a.hostname, a.local_rank)
            w = self._workers.get(name)
            if w is not None and w.popen.poll() is None:
                continue  # alive: keep it
            if w is not None:
                if w.popen.returncode == 0:
                    # Completed job racing a reconfiguration: leave the
                    # corpse for the monitor, which surfaces rc=0 as job
                    # completion.
                    continue
                # Failed/removed but not yet reaped (a whole generation
                # crashing lands here): sweep it so the slot gets its
                # new-generation worker now.
                del self._workers[name]
            if self._promote_spare(name, a, version):
                continue
            env = build_worker_env(
                a,
                base_env=dict(os.environ),
                coordinator_addr=coord,
                coordinator_port=self._coord_port,
                cpu_mode=self._settings.cpu_mode,
                extra_env={
                    **self._settings.env,
                    "HOROVOD_ELASTIC": "1",
                    "HOROVOD_WORLD_VERSION": str(version),
                    "HOROVOD_HOSTNAME": a.hostname,
                    WORKER_ENV: name,
                    **self._state_env(),
                },
                rendezvous_addr=kv_addr,
                rendezvous_port=self._server.port,
            )
            self._log.info(
                "elastic: launching worker %s (process %d/%d, v%d)",
                name, a.rank, a.size, version,
            )
            # Fresh liveness record per launch: a relaunched worker must
            # neither inherit its predecessor's recent heartbeat nor its
            # silence.
            self._server.clear_heartbeat(name)
            self._launched_at[name] = time.monotonic()
            self._workers[name] = launch_worker(
                a, self._settings.command, env,
                ssh_port=self._settings.ssh_port, sink=self._sink,
            )
        # New pids reach the snapshot at once: a crash right after a launch
        # must let the successor adopt them, not launch their slots twice.
        self._save_state()

    def _promote_spare(self, name: str, a: ProcessAssignment,
                       version: int) -> bool:
        """Move the warm spare parked on slot ``name`` into the world (the
        ``spare.promote`` fault point): its wait sees the assignment and
        it joins with one re-rendezvous. Its heartbeat record stays (it is
        live). False when there is none, or when the promotion failed and
        the spare was retired (the slot then gets a cold launch)."""
        sp = self._spare_procs.pop(name, None)
        if sp is None or sp.popen.poll() is not None:
            return False
        try:
            if faults.fire(faults.SPARE_PROMOTE):
                raise faults.InjectedFault("spare promotion dropped")
            self._workers[name] = sp
            self._server.clear_spare(name)
            self._server.record_policy_action("promote")
            metrics.POLICY_DECISIONS.inc(action="promote")
            metrics.event("spare_promoted", generation=version, host=name,
                          rank=a.rank)
            self._log.info("elastic: promoting warm spare %s into the world "
                           "(process %d/%d, v%d)", name, a.rank, a.size,
                           version)
            return True
        except Exception as e:  # noqa: BLE001 — injected or real
            self._log.warning("elastic: spare promotion of %s failed (%s); "
                              "launching cold", name, e)
            terminate_worker(sp)
            self._server.clear_spare(name)
            return False

    def _reconfigure(self) -> None:
        t0 = time.monotonic()
        hosts = self._pick()
        if _slots(hosts) < self._min_np:
            hosts = self._wait_for_available_slots(
                self._min_np, self._settings.elastic_timeout
            )
        if (self._manager.warm_spares_target > 0
                and [(h.hostname, h.slots) for h in hosts]
                == [(h.hostname, h.slots) for h in self._world_hosts]
                and all(n in self._workers
                        and self._workers[n].popen.poll() is None
                        for n in self._world_names(hosts))):
            # Only the spare tier changed (a host back from its cooldown,
            # a surplus host): the world and every worker of it stand, so
            # refresh the fleet instead of churning the world.
            self._ensure_spares(self._server.version)
            return
        keep = set(self._world_names(hosts))
        # Kill workers on slots that left the world.
        leaving = [n for n in self._workers if n not in keep]
        for name in leaving:
            self._log.info("elastic: removing worker %s", name)
            self._server.clear_heartbeat(name)
            self._launched_at.pop(name, None)
        terminate_workers([self._workers.pop(n) for n in leaving])
        version = self._publish_world(hosts)
        self._launch_missing_workers(version)
        self._ensure_spares(version)
        # The policy weighs a voluntary drain against this measured price.
        self._policy.note_resize_cost(time.monotonic() - t0)

    @staticmethod
    def _world_names(hosts: list[HostInfo]) -> list[str]:
        return [worker_name(a.hostname, a.local_rank)
                for a in get_host_assignments(hosts)]

    # -- main loop -----------------------------------------------------------

    def run(self) -> int:
        takeover = self._prepare_takeover()
        metrics.event("driver_start", generation=self._server.generation,
                      min_np=self._min_np, max_np=self._max_np,
                      driver_epoch=self.driver_epoch, takeover=takeover)
        hosts = self._wait_for_available_slots(
            self._min_np, self._settings.elastic_timeout
        )
        self._server.start()
        if takeover:
            # Adopt before the first save: it writes this driver's worker
            # table, and an empty one would lose the predecessor's pids.
            self._adopt_from_snapshot(self._snapshot or {})
        # The claimed epoch on disk before anything else: from here on a
        # resumed predecessor's writes are fenced and it stands down.
        self._save_state()
        if takeover:
            metrics.event(
                "driver_takeover", generation=self._server.generation,
                driver_epoch=self.driver_epoch, adopted=sorted(self._workers),
                world=[h.hostname for h in self._world_hosts])
            # The old world's state is unknowable (a worker may wait in a
            # collective on a peer that died with the driver): abort the
            # restored generation, so every survivor rolls back and joins
            # the world at g+1 (on the peer rung when its state replicates).
            self._post_abort(
                f"driver takeover (epoch {self.driver_epoch}): re-forming "
                f"the world at generation {self._server.generation + 1}")
        version = self._publish_world(hosts)
        self._launch_missing_workers(version)
        self._ensure_spares(version)
        prev_sigterm = self._install_sigterm_forwarder()
        try:
            return self._monitor()
        finally:
            procs = (list(self._workers.values())
                     + list(self._spare_procs.values()))
            if self._superseded:
                # The successor adopted the workers: terminating them
                # would end its world.
                self._log.warning(
                    "elastic: superseded driver standing down without "
                    "touching %d worker(s)", len(self._workers))
            else:
                terminate_workers(procs)
            try:
                # A decision whose window the job outlived still gets its
                # policy_decision record (a partial window).
                self._policy.flush()
            except Exception:  # noqa: BLE001 — shutdown must finish
                pass
            for w in procs:
                if w.pump is not None:
                    w.pump.join(timeout=5)
            if prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_sigterm)
                except (ValueError, OSError):
                    pass
            self._server.stop()

    def _dead_by_heartbeat(self, procs: dict[str, WorkerProc] | None = None
                           ) -> list[tuple[str, str]]:
        """Workers the liveness plane has declared dead: (worker, why).

        A worker is dead when its last heartbeat is older than hb_timeout,
        or — if it has NEVER heartbeated — when hb_grace has elapsed since
        its launch. popen.poll() cannot see either case: a SIGSTOP'd
        process or a livelocked trainer is still "running" to the OS.
        ``procs`` defaults to the world's workers; the spare fleet is
        checked by the same rule.
        """
        if self._hb_timeout <= 0:
            return []
        dead: list[tuple[str, str]] = []
        now = time.monotonic()
        for name, w in (self._workers if procs is None else procs).items():
            if w.popen.poll() is not None:
                continue  # exited: the reap path owns it
            age = self._server.heartbeat_age(name)
            if age is None:
                launched = self._launched_at.get(name)
                if launched is not None and now - launched >= self._hb_grace:
                    dead.append((name, (
                        f"no heartbeat within {self._hb_grace:.0f}s "
                        "grace of launch")))
            elif age >= self._hb_timeout:
                dead.append((name, (
                    f"heartbeat silent for {age:.0f}s "
                    f"(timeout {self._hb_timeout:.0f}s)")))
        return dead

    def _post_abort(self, reason: str) -> None:
        """Post the coordinated-abort record for the CURRENT generation
        (the dying world) before ``_reconfigure`` bumps it: survivors
        wedged in a collective with the dead peer turn the wedge into
        HorovodInternalError instead of blocking forever."""
        self._server.close_generation(reason)
        gen = self._server.post_abort(reason)
        metrics.event("abort_posted", generation=gen, reason=reason,
                      source="driver")
        self._log.warning(
            "elastic: posting coordinated abort for world generation %d "
            "(%s)", gen, reason,
        )

    def _blacklist(self, name: str, why: str) -> None:
        host = _host_of(name)
        self._manager.blacklist(host)
        self._server.set_cluster_info(
            blacklisted=self._manager.blacklist_count())
        metrics.event("blacklist", generation=self._server.generation,
                      host=host, reason=why)
        self._log.warning("elastic: blacklisting host %s (%s)", host, why)
        self._save_state()

    # -- warm spares ---------------------------------------------------------

    def _launch_spare(self, host: HostInfo, version: int) -> None:
        """Launch a warm spare on each slot of ``host``: the same command
        and env, plus ``HOROVOD_SPARE=1``. Each imports its frameworks,
        heartbeats, registers at ``PUT /spare/<worker>`` and parks on the
        assignment wait until a world includes its slot."""
        names = [h.hostname for h in self._world_hosts]
        for slot in range(host.slots):
            name = worker_name(host.hostname, slot)
            if name in self._spare_procs:
                continue
            assignment = ProcessAssignment(
                hostname=host.hostname, rank=0, size=1, local_rank=slot,
                local_size=host.slots, cross_rank=0, cross_size=1)
            env = build_worker_env(
                assignment,
                base_env=dict(os.environ),
                coordinator_addr=coordinator_addr(names or [host.hostname]),
                coordinator_port=self._coord_port,
                cpu_mode=self._settings.cpu_mode,
                extra_env={
                    **self._settings.env,
                    "HOROVOD_ELASTIC": "1",
                    "HOROVOD_SPARE": "1",
                    "HOROVOD_WORLD_VERSION": str(version),
                    "HOROVOD_HOSTNAME": host.hostname,
                    WORKER_ENV: name,
                    **self._state_env(),
                },
                rendezvous_addr=driver_addr(names + [host.hostname]),
                rendezvous_port=self._server.port,
            )
            self._log.info("elastic: launching warm spare %s (v%d)", name,
                           version)
            self._server.clear_heartbeat(name)
            self._launched_at[name] = time.monotonic()
            self._spare_procs[name] = launch_worker(
                assignment, self._settings.command, env,
                ssh_port=self._settings.ssh_port, sink=self._sink)
            metrics.event("spare_launched", generation=version, host=name)

    def _retire_spare(self, name: str, why: str, version: int) -> None:
        w = self._spare_procs.pop(name, None)
        if w is None:
            return
        self._log.info("elastic: retiring spare %s (%s)", name, why)
        terminate_worker(w)
        self._launched_at.pop(name, None)
        self._server.clear_heartbeat(name)
        self._server.clear_spare(name)
        metrics.event("spare_retired", generation=version, host=name,
                      reason=why)

    def _ensure_spares(self, version: int) -> None:
        """Reconcile the spare fleet with the host manager's spare tier:
        reap exits, kill hung spares (the world's liveness rule, but no
        abort and no new world: a spare is in no collective), retire the
        slots of hosts that left the tier, launch the new ones."""
        if self._manager.warm_spares_target <= 0 and not self._spare_procs:
            return
        for name in [n for n, w in self._spare_procs.items()
                     if w.popen.poll() is not None]:
            w = self._spare_procs.pop(name)
            self._launched_at.pop(name, None)
            self._server.clear_heartbeat(name)
            self._server.clear_spare(name)
            metrics.event("spare_exit", generation=version, host=name,
                          rc=w.popen.returncode)
            self._log.warning("elastic: spare %s exited rc=%s; the tier "
                              "relaunches it while its host stays "
                              "discovered", name, w.popen.returncode)
        for name, why in self._dead_by_heartbeat(self._spare_procs):
            self._log.warning("elastic: spare %s is hung (%s); killing",
                              name, why)
            metrics.event("spare_hung", generation=version, host=name,
                          reason=why)
            self._retire_spare(name, f"hung: {why}", version)
        tier = {h.hostname: h for h in self._manager.spare_hosts()}
        for name in [n for n in self._spare_procs
                     if _host_of(n) not in tier]:
            self._retire_spare(name, "left the spare tier", version)
        world = {h.hostname for h in self._world_hosts}
        for host, h in tier.items():
            if host not in world:
                self._launch_spare(h, version)
        self._server.set_cluster_info(spares=len(self._spare_procs))
        metrics.POLICY_SPARES.set(len(self._spare_procs))

    def _warm_spare_count(self) -> int:
        """Spares launched, registered (their imports done) and fresh on
        the liveness plane: the replacements a drain can count on."""
        registered = self._server.spare_records()
        warm = 0
        for name, w in self._spare_procs.items():
            if w.popen.poll() is not None or name not in registered:
                continue
            age = self._server.heartbeat_age(name)
            if age is None or (self._hb_timeout > 0
                               and age >= self._hb_timeout):
                continue
            warm += 1
        return warm

    # -- drains: the policy, the integrity vote, preemption notices ----------

    def _drain_host(self, name: str, why: str, decision=None,
                    action: str = "drain",
                    abort_posted: bool = False) -> None:
        """Drain the host of worker (or host) ``name`` and re-form the
        world without it: SIGTERM to each of its workers, which finishes
        its step, commits at the still-current generation and exits
        ``EXIT_REMOVED``; after their exits (or
        ``HOROVOD_POLICY_DRAIN_GRACE`` seconds, then SIGKILL) the abort is
        posted (unless the caller posted it first), the host blacklisted
        and a world published, which a warm spare joins. The generation
        is marked closing first, so a survivor that fails on a drained
        peer's exit re-joins the next world."""
        host = _host_of(name)
        members = [n for n in self._workers if _host_of(n) == host]
        if not members:
            return
        gen = self._server.generation
        # The evidence of "why was this host replaced": its last shipped
        # trace window and what condemned it.
        payload = self._server.trace_payload(members[0]) or {}
        metrics.FLIGHT_DUMPS.inc(reason="policy_drain")
        metrics.event(
            "flight_record", generation=gen, reason="policy_drain",
            host=host, steps=(payload.get("steps") or [])[-2:],
            clock_offset_s=payload.get("clock_offset_s"),
            evidence=(decision.evidence if decision is not None else None))
        self._log.warning("elastic: draining host %s (%s)", host, why)
        self._server.close_generation(f"drain of {host}")
        for n in members:
            drain_worker(self._workers[n])
        grace = get_float("HOROVOD_POLICY_DRAIN_GRACE", 20.0)
        deadline = time.monotonic() + grace
        while (time.monotonic() < deadline
               and any(self._workers[n].popen.poll() is None
                       for n in members)):
            time.sleep(0.05)
        rcs = [self._workers[n].popen.poll() for n in members]
        if None in rcs:
            self._log.warning("elastic: a drained worker of %s is alive "
                              "after %.0f s; killing it", host, grace)
        metrics.event("policy_drain", generation=gen, host=host,
                      action=action, reason=why,
                      rc=rcs[0] if len(rcs) == 1 else rcs)
        if not abort_posted:
            self._post_abort(f"drain of {host} ({why})")
        terminate_workers([self._workers.pop(n) for n in members])
        for n in members:
            self._launched_at.pop(n, None)
            self._server.clear_heartbeat(n)
        self._blacklist(host, f"{action}: {why}")
        self._server.record_policy_action(action)
        if decision is not None:
            self._policy.record_drain(decision, generation=gen)
        else:
            metrics.POLICY_DECISIONS.inc(action=action)
        self._reconfigure()

    def _handle_preempt_notices(self, version: int) -> None:
        """External notices (``PUT /preempt/<host>``) drain their host:
        the driver forwards the SIGTERM, so a notice works where the cloud
        cannot signal the worker. A spare host's spares retire; a host
        running nothing of ours is blacklisted (the cooldown re-admits
        it). Each notice is handled once."""
        for host in self._server.preempt_notices():
            self._server.consume_preempt(host)
            metrics.event("preempt_notice", generation=version, host=host)
            if any(_host_of(n) == host for n in self._workers):
                self._log.warning("elastic: preemption notice for %s — "
                                  "draining it", host)
                self._drain_host(host, "external preemption notice",
                                 action="preempt")
                continue
            for n in [n for n in self._spare_procs if _host_of(n) == host]:
                self._retire_spare(n, "external preemption notice", version)
            self._blacklist(host, "external preemption notice")

    # -- the integrity vote --------------------------------------------------

    def _integrity_tick(self) -> None:
        """One vote over the fingerprints the heartbeats carry (armed by
        ``HOROVOD_INTEGRITY_INTERVAL``, with or without a goodput target:
        corruption is correctness). The newest complete (generation, step)
        group is voted once. A named outlier is journaled, counted,
        quarantined (its current replica evicted, the ``.prev`` kept),
        struck for the policy, and under ``HOROVOD_INTEGRITY_ACTION=drain``
        drained with the abort posted FIRST (survivors stop rotating the
        last good replica set away before the drain's grace)."""
        from ... import integrity

        if not integrity.enabled():
            return
        now = time.monotonic()
        if now - self._last_integrity_tick < 0.25:
            return
        self._last_integrity_tick = now
        # Idle ticks cost one compare: the heartbeat store's mutation count.
        hbv = self._server.heartbeat_version()
        if hbv == self._last_integrity_hb_version or not self._world_hosts:
            return
        self._last_integrity_hb_version = hbv
        records, voted = self._server.integrity_vote_cached()
        if not records or voted is None:
            return
        group, verdict = voted
        if group <= self._integrity_acted_group:
            return
        self._integrity_acted_group = group
        if not verdict.get("divergent"):
            # A clean complete vote resets the consecutive strikes.
            if self._integrity_strikes or self._last_outlier is not None:
                self._integrity_strikes.clear()
                self._last_outlier = None
                self._save_state()
            return
        gen = self._server.generation
        if (verdict.get("ambiguous") and verdict.get("voters") == 2
                and self._last_outlier is not None):
            # Two voters and persistent corruption: every vote after the
            # first is ambiguous (the outlier's prev, its own condemned
            # record, disagrees with the peer's). When the last named
            # rank's prev IS the digest that vote condemned, it is the
            # same corruption persisting.
            lrank, ldigest = self._last_outlier
            rec = records.get(int(lrank)) or {}
            prev = rec.get("prev")
            if isinstance(prev, dict) and prev.get("digest") == ldigest:
                verdict = dict(verdict, ambiguous=False,
                               method="continuity",
                               outlier_rank=rec.get("rank", lrank),
                               outlier_host=rec.get("host"))
        host = verdict.get("outlier_host")
        rank = verdict.get("outlier_rank")
        if verdict.get("ambiguous") or not host:
            self._log.error(
                "elastic: integrity vote at group %s is DIVERGENT but "
                "ambiguous (%d voters, digests %s); no worker named, no "
                "action taken", group, verdict.get("voters"),
                verdict.get("digests"))
            metrics.event(
                "integrity_divergence", generation=gen, host=None,
                rank=None, ambiguous=True, step=group[1],
                group_generation=group[0], voters=verdict.get("voters"),
                digests=verdict.get("digests"))
            self._save_state()
            return
        out_rec = records.get(int(rank)) or {}
        if out_rec.get("digest"):
            self._last_outlier = (int(rank), str(out_rec["digest"]))
        # Strikes last a membership: a departed worker's count does not
        # follow it back in through the spare tier.
        world = set(self._world_names(self._world_hosts))
        for n in [n for n in self._integrity_strikes if n not in world]:
            del self._integrity_strikes[n]
        self._integrity_strikes[host] = self._integrity_strikes.get(
            host, 0) + 1
        strikes = self._integrity_strikes[host]
        self._log.error(
            "elastic: integrity vote named %s (rank %s) DIVERGENT at "
            "generation %d step %d (method=%s, strike %d): silent data "
            "corruption evidence", host, rank, group[0], group[1],
            verdict.get("method"), strikes)
        metrics.INTEGRITY_DIVERGENCE.inc(host=host)
        self._server.record_integrity_divergence(host)
        metrics.event(
            "integrity_divergence", generation=gen, host=host, rank=rank,
            ambiguous=False, step=group[1], group_generation=group[0],
            method=verdict.get("method"), voters=verdict.get("voters"),
            digests=verdict.get("digests"), strikes=strikes)
        payload = self._server.trace_payload(host) or {}
        metrics.FLIGHT_DUMPS.inc(reason="integrity_divergence")
        metrics.event(
            "flight_record", generation=gen,
            reason="integrity_divergence", host=host,
            steps=(payload.get("steps") or [])[-2:],
            digests=verdict.get("digests"))
        # Fence and evict first. When the outlier's own previous
        # fingerprint already disagreed with its peers', the corruption
        # predates this vote: condemn from that commit (and generation).
        qgen, qstep = group
        try:
            outlier_prev = out_rec.get("prev") or {}
            peer_prevs = {(r2.get("prev") or {}).get("digest")
                          for k, r2 in records.items() if int(k) != int(rank)}
            if (outlier_prev.get("digest") and len(peer_prevs) == 1
                    and None not in peer_prevs
                    and outlier_prev["digest"] not in peer_prevs):
                qstep = int(outlier_prev.get("step", qstep))
                qgen = int(outlier_prev.get("generation", qgen))
        except (TypeError, ValueError, AttributeError):
            pass
        self._server.quarantine_rank(rank, host, generation=group[0],
                                     step=group[1], from_generation=qgen,
                                     from_step=qstep)
        self._policy.note_integrity(host)
        self._save_state()
        if (integrity.integrity_action() == "drain"
                and strikes >= integrity.confirmations()
                and host in self._workers):
            self._post_abort(
                f"integrity divergence on {host} (rank {rank}, generation "
                f"{group[0]} step {group[1]})")
            self._drain_host(
                host, f"integrity divergence (strike {strikes}, method "
                      f"{verdict.get('method')})",
                action="drain", abort_posted=True)

    # -- the policy ----------------------------------------------------------

    def _update_world_rate(self) -> None:
        """The policy's throughput signal: each world worker's commit rate
        from successive heartbeat counters, averaged (a counter reset by a
        relaunch reseeds, never goes negative)."""
        now = time.monotonic()
        world = set(self._world_names(self._world_hosts))
        for n in [n for n in self._rate_state if n not in world]:
            del self._rate_state[n]
        rates = []
        for name in world:
            raw = self._server.heartbeat_payload(name)
            if raw is None:
                continue
            try:
                commits = json.loads(raw).get("commits")
            except (ValueError, UnicodeDecodeError):
                continue
            if not isinstance(commits, (int, float)):
                continue
            prev = self._rate_state.get(name)
            self._rate_state[name] = (float(commits), now)
            if prev is None:
                continue
            dt, delta = now - prev[1], float(commits) - prev[0]
            if dt > 0 and delta >= 0:
                rates.append(delta / dt)
        if rates:
            self._policy.note_rate(sum(rates) / len(rates))

    def _policy_tick(self) -> None:
        """One self-healing evaluation (at most every policy interval, 0.25
        to 30 s): reconcile the spares, handle the notices and, when the
        controller is armed, fold the evidence, decide and drain."""
        now = time.monotonic()
        if now - self._last_policy_tick < max(
                min(self._policy.interval_s, 30.0), 0.25):
            return
        self._last_policy_tick = now
        version = self._server.generation
        self._ensure_spares(version)
        self._handle_preempt_notices(version)
        if not self._policy.armed:
            return
        world = self._world_names(self._world_hosts)
        if self._policy.enabled:
            self._update_world_rate()
            try:
                skew = self._server.straggler_summary()
            except Exception as e:  # noqa: BLE001 — evidence is best-effort
                self._log.debug("elastic: straggler summary failed: %s", e)
                skew = {}
            residuals: dict = {}
            if self._policy.comms_residual_s > 0:
                try:
                    residuals = (self._server.comms_summary()
                                 .get("residuals") or {})
                except Exception as e:  # noqa: BLE001
                    self._log.debug("elastic: comms summary failed: %s", e)
            regression: dict | None = None
            if self._policy.step_regression_s > 0:
                try:
                    # Every world worker measured healthy unless suspect.
                    regression = {n: 0.0 for n in world}
                    regression.update(self._server.regression_suspects())
                except Exception as e:  # noqa: BLE001
                    self._log.debug("elastic: regression suspects failed: "
                                    "%s", e)
                    regression = None
            self._policy.observe(skew, self._server.heartbeat_ages(), world,
                                 comms_residuals=residuals,
                                 regression_excess=regression)
        decision = self._policy.decide(world, self._warm_spare_count())
        if decision is not None and decision.host in self._workers:
            self._drain_host(decision.host, decision.reason,
                             decision=decision, action=decision.action)
        realized = self._policy.realize_tick()
        if realized is not None:
            self._log.info("elastic: policy decision on %s realized: %s",
                           realized.host, realized.predicted.get("realized"))

    def _install_sigterm_forwarder(self):
        """SIGTERM on the DRIVER forwards the drain to every worker, so a
        launcher-level preemption notice drains the whole job through
        final commits. Returns the previous handler (to restore on exit)
        or None when not installable (non-main thread)."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_sigterm(signum, frame):
            if self._draining:
                return
            self._draining = True
            metrics.event("driver_drain", generation=self._server.generation)
            self._log.warning(
                "elastic: driver received SIGTERM — forwarding the drain "
                "to %d worker(s) and %d spare(s)", len(self._workers),
                len(self._spare_procs))
            for w in (list(self._workers.values())
                      + list(self._spare_procs.values())):
                drain_worker(w)

        try:
            return signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            return None

    def _monitor(self) -> int:
        last_poll = 0.0
        while True:
            if self._superseded:
                # A fenced write: a driver of a higher epoch owns the world.
                metrics.event("driver_superseded",
                              generation=self._server.generation,
                              driver_epoch=self.driver_epoch)
                return EXIT_DRIVER_SUPERSEDED
            # 1. Reap exited workers.
            finished = {
                n: w for n, w in self._workers.items()
                if w.popen.poll() is not None
            }
            need_reconfigure = False
            for name, w in finished.items():
                rc = w.popen.returncode
                del self._workers[name]
                self._launched_at.pop(name, None)
                self._server.clear_heartbeat(name)
                metrics.event("worker_exit",
                              generation=self._server.generation,
                              host=name, rc=rc,
                              adopted=isinstance(w.popen, _AdoptedPopen))
                if isinstance(w.popen, _AdoptedPopen):
                    # An adopted worker's exit code cannot be read: its
                    # done record says it completed; anything else is an
                    # unclean exit, relaunched without blacklisting (a
                    # guess must not blacklist a host).
                    if name in self._server.done_records():
                        self._log.info("elastic: adopted worker %s finished "
                                       "ok (done record)", name)
                        metrics.event("job_complete",
                                      generation=self._server.generation,
                                      host=name)
                        return 0
                    self._log.warning(
                        "elastic: adopted worker %s exited with an "
                        "unreadable code and no done record; relaunching "
                        "without blacklisting", name)
                    self._post_abort(f"adopted worker {name} exited "
                                     "uncleanly")
                    need_reconfigure = True
                    continue
                if rc == 0:
                    # Success on any worker ⇒ the job completed (reference
                    # semantics: the training function returned).
                    self._log.info("elastic: worker %s finished ok", name)
                    metrics.event("job_complete",
                                  generation=self._server.generation,
                                  host=name)
                    return 0
                if rc == EXIT_REMOVED:
                    # Clean self-exit of a worker dropped from the world.
                    self._log.info("elastic: removed worker %s exited", name)
                    continue
                if rc == EXIT_DRIVER_LOST:
                    # A control-plane fault, not a host fault: relaunch
                    # without blacklisting, up to 3 consecutive times.
                    n = self._driver_lost_counts.get(name, 0) + 1
                    self._driver_lost_counts[name] = n
                    self._server.record_driver_lost(name)
                    metrics.DRIVER_LOST.inc(host=name)
                    metrics.event(
                        "driver_lost", generation=self._server.generation,
                        host=name, consecutive=n, capped=n > 3)
                    if n <= 3:
                        self._log.error(
                            "elastic: worker %s lost the rendezvous KV "
                            "(rc=%d, %d consecutive); relaunching without "
                            "blacklisting", name, rc, n,
                        )
                        self._post_abort(
                            f"worker {name} exited EXIT_DRIVER_LOST")
                        need_reconfigure = True
                        continue
                    del self._driver_lost_counts[name]
                    self._post_abort(
                        f"worker {name} lost the rendezvous KV "
                        f"{n} consecutive times; blacklisted")
                    self._blacklist(
                        name, f"{n} consecutive EXIT_DRIVER_LOST exits")
                    need_reconfigure = True
                    continue
                self._driver_lost_counts.pop(name, None)
                self._log.warning(
                    "elastic: worker %s failed (rc=%d); blacklisting",
                    name, rc,
                )
                self._post_abort(
                    f"worker {name} failed with rc={rc}; blacklisted")
                self._blacklist(name, f"worker failed with rc={rc}")
                need_reconfigure = True
            # 1b. Liveness plane: kill + blacklist workers the heartbeat
            # deadline has condemned. Abort FIRST, kill second.
            for name, why in self._dead_by_heartbeat():
                self._log.warning(
                    "elastic: worker %s is hung (%s); killing and "
                    "blacklisting", name, why,
                )
                self._post_abort(f"worker {name} is hung ({why}); killed")
                metrics.event("worker_hung",
                              generation=self._server.generation,
                              host=name, reason=why)
                terminate_worker(self._workers.pop(name))
                self._launched_at.pop(name, None)
                self._server.clear_heartbeat(name)
                self._blacklist(name, f"hung: {why}")
                need_reconfigure = True
            # Driver-level drain: once every worker has exited, the job is
            # drained — don't re-form a world we were told to vacate.
            if self._draining:
                if not self._workers:
                    self._log.info("elastic: drain complete; exiting")
                    return 0
                time.sleep(0.05)
                continue
            if need_reconfigure:
                self._reconfigure()
                continue
            # 1c. The integrity vote and the self-healing policy: their
            # failures are logged, never fatal to the driver.
            try:
                self._integrity_tick()
            except Exception as e:  # noqa: BLE001
                self._log.warning("elastic: integrity tick failed: %s", e)
            try:
                self._policy_tick()
            except Exception as e:  # noqa: BLE001
                self._log.warning("elastic: policy tick failed: %s", e)
            # 1d. The periodic snapshot refresh: it catches a resumed
            # predecessor too (its first refresh is fenced).
            if (self._store is not None and self._state_refresh_s > 0
                    and time.monotonic() - self._last_state_save
                    >= self._state_refresh_s):
                self._save_state()
            # 2. Poll discovery.
            if time.time() - last_poll >= self._poll_interval:
                last_poll = time.time()
                try:
                    changed = self._manager.update_available_hosts()
                except HostDiscoveryFailedError:
                    raise  # sustained streak: fail the job loudly
                except Exception as e:
                    self._log.warning("elastic: discovery failed: %s", e)
                    changed = False
                if changed:
                    self._log.info("elastic: host set changed; reconfiguring")
                    self._reconfigure()
            time.sleep(0.05)


def run_elastic(settings, sink=None, discovery=None) -> int:
    """Entry used by ``hvdrun-torch --host-discovery-script ...``."""
    driver = ElasticDriver(settings, discovery=discovery, sink=sink)
    return driver.run()
