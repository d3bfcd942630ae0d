"""Durable control-plane state: the elastic driver's crash-restart story.

Port of ``horovod_tpu/runner/elastic/driver_state.py`` (the same files,
the same fences). Without it the driver is a single point of failure: its
death orphans the workers, which exit ``EXIT_DRIVER_LOST`` once the
rendezvous server has been silent for
``HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT`` seconds. With
``HOROVOD_DRIVER_STATE_DIR`` set:

1. **Snapshot store** (:class:`DriverStateStore`): the driver journals its
   state (the world and its slots, the generation, the blacklist with the
   ages of its entries, so cooldowns survive a restart, the live workers'
   pids and start ticks, the job's HMAC secret) to
   ``$HOROVOD_DRIVER_STATE_DIR/driver_state.json`` at every change, through
   ``checkpoint.atomic_install`` (the previous snapshot stays at ``.prev``),
   with a sha256 over its body; a load verifies it and falls back to
   ``.prev`` on a torn write.
2. **Endpoint record** (:meth:`DriverStateStore.publish_endpoint` /
   :func:`read_endpoint`): ``{addr, port, driver_epoch, generation}``, the
   record orphaned workers re-resolve the rendezvous server from.
3. **Driver epoch**: each (re)started driver claims an epoch one above any
   the directory has seen (an ``O_EXCL`` claim file, so two drivers started
   at once get distinct epochs). A write whose epoch is lower than the one
   on disk raises :class:`DriverFencedError`: a driver stopped through its
   successor's takeover can neither overwrite the successor's snapshot nor
   draw the workers back. The same epoch rides the driver's and workers'
   KV writes as ``X-Hvd-Driver-Epoch``, which the server fences
   (``runner/http/kv_server.py``).

Standard library only: the driver (before any framework) and the
worker's poll thread both import it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

from ... import faults
from ...checkpoint import atomic_install, atomic_read, payload_digest
from ...utils.logging import get_logger

ENV_STATE_DIR = "HOROVOD_DRIVER_STATE_DIR"
ENV_DRIVER_EPOCH = "HOROVOD_DRIVER_EPOCH"

#: Snapshot + endpoint file names inside the state dir.
STATE_FILE = "driver_state.json"
ENDPOINT_FILE = "endpoint.json"


def state_dir() -> str | None:
    """The configured control-plane state directory, or None (the
    feature is then off: a lost driver ends its workers with
    ``EXIT_DRIVER_LOST``)."""
    d = os.environ.get(ENV_STATE_DIR, "").strip()
    return d or None


class DriverFencedError(RuntimeError):
    """A stale driver (lower epoch) tried to write control-plane state
    already owned by a higher-epoch successor. The correct reaction is
    to stand down, NOT to retry: the world has moved on."""


def _encode(record: Mapping[str, Any]) -> bytes:
    """One self-verifying JSON document: the record plus the sha256 of
    its canonical body, so a torn write fails verification instead of
    parsing as a plausible-but-partial state."""
    body = json.dumps(record, sort_keys=True)
    return json.dumps({"body": body,
                       "sha256": payload_digest(body.encode())}).encode()


def _decode(blob: bytes) -> dict:
    """Verify + parse; raises ``ValueError`` on any malformation."""
    outer = json.loads(blob)
    if not isinstance(outer, dict) or "body" not in outer:
        raise ValueError("driver-state record has no body")
    body = outer["body"]
    if payload_digest(str(body).encode()) != outer.get("sha256"):
        raise ValueError(
            "driver-state record failed its integrity check "
            "(torn/corrupted write)")
    record = json.loads(body)
    if not isinstance(record, dict):
        raise ValueError("driver-state body is not a mapping")
    return record


def _read_record(path: str) -> dict | None:
    """Newest verifiable record at ``path`` (falling back to ``.prev``
    on a torn current file), or None when neither slot is readable."""
    log = get_logger()
    for blob, which in atomic_read(path):
        try:
            return _decode(blob)
        except Exception as e:  # noqa: BLE001 — corrupt slot: keep looking
            log.error(
                "driver-state %s slot of %s is unreadable (%s); %s",
                which, path,
                e, "falling back to the previous snapshot"
                if which == "current" else "no snapshot recovered")
    return None


def _disk_epoch(path: str) -> int | None:
    rec = _read_record(path)
    if rec is None:
        return None
    try:
        return int(rec.get("driver_epoch", 0))
    except (TypeError, ValueError):
        return None


def proc_start_ticks(pid: int) -> int | None:
    """The kernel's process start time (clock ticks since boot, field 22
    of ``/proc/<pid>/stat``) — the PID-reuse guard for worker adoption:
    a snapshot PID whose start time no longer matches names a DIFFERENT
    process, which the takeover driver must never adopt (it would later
    SIGKILL an innocent process group). None where unreadable (non-proc
    platforms, vanished pid) — callers then fall back to PID-only."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode(errors="replace")
        # comm can contain spaces/parens: field 22 counts from AFTER
        # the last ')' (fields 3..) — standard /proc/stat parsing.
        rest = stat.rsplit(")", 1)[1].split()
        return int(rest[19])  # field 22 overall = index 19 after comm
    except (OSError, IndexError, ValueError):
        return None


def read_endpoint(directory: str | None = None) -> dict | None:
    """The rendezvous-endpoint discovery record orphaned workers poll:
    ``{"addr", "port", "driver_epoch", "generation"}`` or None. Workers
    follow the HIGHEST driver epoch they have seen — a record at or
    below their current epoch is the dead driver's own and is ignored."""
    d = directory if directory is not None else state_dir()
    if not d:
        return None
    rec = _read_record(os.path.join(d, ENDPOINT_FILE))
    if rec is None:
        return None
    try:
        rec["driver_epoch"] = int(rec.get("driver_epoch", 0))
        rec["port"] = int(rec["port"])
        rec["addr"] = str(rec["addr"])
    except (KeyError, TypeError, ValueError):
        return None
    return rec


class DriverStateStore:
    """The driver-side handle: fenced snapshot saves, takeover loads,
    endpoint publication. One instance per driver process, constructed
    only when ``HOROVOD_DRIVER_STATE_DIR`` is set."""

    def __init__(self, directory: str, epoch: int = 0):
        self._dir = directory
        self.epoch = epoch
        os.makedirs(directory, exist_ok=True)
        try:
            # The snapshot carries the job's HMAC secret (the takeover
            # driver MUST resume it — a fresh key would 403 every
            # orphaned worker's rejoin), so the dir is operator-only.
            os.chmod(directory, 0o700)
        except OSError:
            pass
        self._log = get_logger()

    @property
    def directory(self) -> str:
        return self._dir

    @property
    def state_path(self) -> str:
        return os.path.join(self._dir, STATE_FILE)

    @property
    def endpoint_path(self) -> str:
        return os.path.join(self._dir, ENDPOINT_FILE)

    # -- fenced writes --------------------------------------------------------

    def _fenced_install(self, path: str, record: dict) -> None:
        """Install one record with the epoch fence: a higher epoch
        anywhere in the state dir — snapshot OR endpoint record, since a
        successor may have written either first — means THIS driver is
        the stale one: raise :class:`DriverFencedError`, touch nothing."""
        for probe in (self.state_path, self.endpoint_path):
            disk = _disk_epoch(probe)
            if disk is not None and disk > self.epoch:
                raise DriverFencedError(
                    f"driver epoch {self.epoch} superseded by epoch "
                    f"{disk} at {probe}; standing down")
        atomic_install(path, _encode(record))

    def save(self, snapshot: Mapping[str, Any]) -> None:
        """Persist one control-plane snapshot (fires the
        ``driver.snapshot`` fault point; ``raise`` simulates a storage
        blip, a SIGKILL mid-write is the torn-write chaos case the
        ``.prev`` fallback covers)."""
        if faults.fire(faults.DRIVER_SNAPSHOT):
            raise faults.InjectedFault("driver snapshot dropped")
        record = dict(snapshot)
        record["driver_epoch"] = self.epoch
        record["t_wall"] = time.time()
        self._fenced_install(self.state_path, record)

    def publish_endpoint(self, addr: str, port: int,
                         generation: int) -> None:
        """Refresh the discovery record orphaned workers re-resolve the
        rendezvous endpoint from (same epoch fence)."""
        record = {
            "addr": addr,
            "port": int(port),
            "driver_epoch": self.epoch,
            "generation": int(generation),
        }
        self._fenced_install(self.endpoint_path, record)

    # -- takeover loads -------------------------------------------------------

    def load(self) -> dict | None:
        """The newest verifiable snapshot (``.prev`` fallback on a torn
        current file), or None on a fresh state dir."""
        return _read_record(self.state_path)

    @classmethod
    def open(cls, directory: str) -> tuple["DriverStateStore", dict | None]:
        """Takeover entry: load the predecessor's snapshot (if any) and
        return a store whose epoch is one past the highest epoch the
        dir has seen — the restarted driver's fencing identity.

        The epoch is CLAIMED atomically (``O_EXCL`` marker file): two
        drivers relaunched concurrently by a flapping supervisor would
        otherwise both read epoch e and both serve as e+1 — equal
        epochs pass every fence, which is exactly the split brain this
        module exists to prevent. The loser of the claim race takes
        e+2 and immediately fences the winner out."""
        store = cls(directory)
        snap = store.load()
        prev = 0
        if snap is not None:
            try:
                prev = int(snap.get("driver_epoch", 0))
            except (TypeError, ValueError):
                prev = 0
        # The endpoint record can outlive a snapshot (or carry a higher
        # epoch after a crash between the two writes), and a claimed
        # epoch can predate both records (a driver that crashed before
        # its first save): the new epoch must clear ALL of them.
        ep = read_endpoint(directory)
        if ep is not None:
            prev = max(prev, ep["driver_epoch"])
        for name in os.listdir(directory):
            if name.startswith("epoch.") and name.endswith(".claim"):
                try:
                    prev = max(prev, int(name.split(".")[1]))
                except (IndexError, ValueError):
                    continue
        while True:
            epoch = prev + 1
            try:
                fd = os.open(
                    os.path.join(directory, f"epoch.{epoch}.claim"),
                    os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
                os.close(fd)
                break
            except FileExistsError:
                prev = epoch  # raced: a peer claimed it — go higher
        store.epoch = epoch
        return store, snap
