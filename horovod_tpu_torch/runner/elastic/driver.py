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
touches no worker. The snapshot holds what the port's driver has: the
world, the blacklist, the workers, the driver-lost counts, the generation
and the epoch.

Not ported yet: the warm spares, preemption notices, integrity tick and
self-healing policy (and with them the policy and integrity parts of the
snapshot), with the host drain (``_drain_host`` :852) that only the
policy and preemption ticks call.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

from ... import faults
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
            "blacklist": self._manager.export_blacklist(),
            "driver_lost_counts": dict(self._driver_lost_counts),
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
        for name, info in (snap.get("workers") or {}).items():
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
                        "elastic: pid %d of %s was recycled (start ticks %s "
                        "!= recorded %s); not adopting", pid, name, ticks,
                        recorded)
                    continue
            assignment = ProcessAssignment(
                hostname=_host_of(name), rank=0, size=1, local_rank=0,
                local_size=1, cross_rank=0, cross_size=1)
            self._workers[name] = WorkerProc(assignment, _AdoptedPopen(pid),
                                             None)
            self._launched_at[name] = time.monotonic()
            adopted.append(name)
            self._log.info("elastic: adopted orphaned worker %s (pid %d)",
                           name, pid)
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
            return False
        if faults.fire(faults.DRIVER_TAKEOVER):
            raise faults.InjectedFault("driver takeover dropped (injected)")
        try:
            generation = int(snap.get("generation", 0))
        except (TypeError, ValueError):
            generation = 0
        self._server.seed(generation=generation,
                          driver_epoch=self._store.epoch)
        self._manager.restore_blacklist(snap.get("blacklist"))
        counts = snap.get("driver_lost_counts")
        if isinstance(counts, dict):
            for name, n in counts.items():
                try:
                    self._driver_lost_counts[str(name)] = int(n)
                except (TypeError, ValueError):
                    continue
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

    def _reconfigure(self) -> None:
        hosts = self._pick()
        if _slots(hosts) < self._min_np:
            hosts = self._wait_for_available_slots(
                self._min_np, self._settings.elastic_timeout
            )
        keep = {worker_name(a.hostname, a.local_rank)
                for a in get_host_assignments(hosts)}
        # Kill workers on slots that left the world.
        leaving = [n for n in self._workers if n not in keep]
        for name in leaving:
            self._log.info("elastic: removing worker %s", name)
            self._server.clear_heartbeat(name)
            self._launched_at.pop(name, None)
        terminate_workers([self._workers.pop(n) for n in leaving])
        version = self._publish_world(hosts)
        self._launch_missing_workers(version)

    # -- main loop -----------------------------------------------------------

    def run(self) -> int:
        takeover = self._prepare_takeover()
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
            # The old world's state is unknowable (a worker may wait in a
            # collective on a peer that died with the driver): abort the
            # restored generation, so every survivor rolls back and joins
            # the world at g+1 (on the peer rung when its state replicates).
            self._post_abort(
                f"driver takeover (epoch {self.driver_epoch}): re-forming "
                f"the world at generation {self._server.generation + 1}")
        version = self._publish_world(hosts)
        self._launch_missing_workers(version)
        prev_sigterm = self._install_sigterm_forwarder()
        try:
            return self._monitor()
        finally:
            if self._superseded:
                # The successor adopted the workers: terminating them
                # would end its world.
                self._log.warning(
                    "elastic: superseded driver standing down without "
                    "touching %d worker(s)", len(self._workers))
            else:
                terminate_workers(list(self._workers.values()))
            for w in self._workers.values():
                if w.pump is not None:
                    w.pump.join(timeout=5)
            if prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_sigterm)
                except (ValueError, OSError):
                    pass
            self._server.stop()

    def _dead_by_heartbeat(self) -> list[tuple[str, str]]:
        """Workers the liveness plane has declared dead: (worker, why).

        A worker is dead when its last heartbeat is older than hb_timeout,
        or — if it has NEVER heartbeated — when hb_grace has elapsed since
        its launch. popen.poll() cannot see either case: a SIGSTOP'd
        process or a livelocked trainer is still "running" to the OS.
        """
        if self._hb_timeout <= 0:
            return []
        dead: list[tuple[str, str]] = []
        now = time.monotonic()
        for name, w in self._workers.items():
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
        gen = self._server.post_abort(reason)
        self._log.warning(
            "elastic: posting coordinated abort for world generation %d "
            "(%s)", gen, reason,
        )

    def _blacklist(self, name: str, why: str) -> None:
        host = _host_of(name)
        self._manager.blacklist(host)
        self._log.warning("elastic: blacklisting host %s (%s)", host, why)
        self._save_state()

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
            self._log.warning(
                "elastic: driver received SIGTERM — forwarding the drain "
                "to %d worker(s)", len(self._workers))
            for w in list(self._workers.values()):
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
                if isinstance(w.popen, _AdoptedPopen):
                    # An adopted worker's exit code cannot be read: its
                    # done record says it completed; anything else is an
                    # unclean exit, relaunched without blacklisting (a
                    # guess must not blacklist a host).
                    if name in self._server.done_records():
                        self._log.info("elastic: adopted worker %s finished "
                                       "ok (done record)", name)
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
            # 1c. The periodic snapshot refresh: it catches a resumed
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
