"""Elastic host discovery.

A copy of ``horovod_tpu/runner/elastic/discovery.py`` (``HostDiscovery``,
``HostDiscoveryScript``, ``FixedHostDiscovery``, ``snap_to_topology`` :77,
``HostManager`` :114, with ``export_blacklist`` :216 and
``restore_blacklist`` :225 for the driver's takeover), itself the analog
of upstream's ``horovod/runner/elastic/discovery.py``: the driver
periodically asks a user-provided source which hosts exist; the manager
diffs successive views, keeps the failure blacklist (with an optional
cooldown), and answers which hosts may run workers now. A host's slots
are its GPUs.

The warm-spare tier (``HOROVOD_WARM_SPARES``, :346-357): up to that many
usable hosts are held out of the world (``spare_hosts``), where the driver
keeps warm workers parked on the assignment wait, and a host whose
blacklist cooldown expired re-enters as a spare before the world needs it.
The port's ``max_np`` counts slots, so the spare-aware pick fills the
world up to ``max_np`` slots (the JAX package's counts hosts, one worker
each).
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Callable, Sequence

from ... import faults
from ...exceptions import HostDiscoveryFailedError
from ...utils.env import get_float, get_int
from ..hosts import HostInfo

class HostDiscovery:
    """Interface: return the current world as {hostname: slots}."""

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs a user script that prints ``host:slots`` (or ``host``) per line.

    Tests drive it the way upstream's fault-injection tests do: they edit
    the file the script reads, and the driver picks up the change on the
    next poll.
    """

    def __init__(self, script_path: str, timeout: float = 10.0):
        self._script = script_path
        self._timeout = timeout

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        out = subprocess.run(
            [self._script],
            capture_output=True,
            timeout=self._timeout,
            check=True,
            text=True,
            shell=False,
        ).stdout
        hosts: dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            info = HostInfo.from_string(line)
            hosts[info.hostname] = info.slots
        return hosts


class FixedHostDiscovery(HostDiscovery):
    """Static host set (elastic with a fixed -H list)."""

    def __init__(self, hosts: Sequence[HostInfo]):
        self._hosts = {h.hostname: h.slots for h in hosts}

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        return dict(self._hosts)


def snap_to_topology(
    hosts: Sequence[HostInfo],
    max_hosts: int | None = None,
) -> list[HostInfo]:
    """Snap a candidate host set to a valid world: whole hosts only, and
    every chosen host contributes the SAME slot count L.

    The chosen L maximizes total ranks ``count(slots >= L) * L`` over the
    candidate L values present in the set; ties prefer the LARGER L. Hosts
    are returned in the input order (rank stability) with slots clamped to
    L.
    """
    ordered = list(hosts)
    if max_hosts is not None:
        ordered = ordered[:max_hosts]
    if not ordered:
        return []
    candidates = sorted({h.slots for h in ordered}, reverse=True)
    best_l, best_total = 0, -1
    for L in candidates:
        total = sum(1 for h in ordered if h.slots >= L) * L
        if total > best_total:  # ties keep the earlier (larger) L
            best_l, best_total = L, total
    return [HostInfo(h.hostname, best_l)
            for h in ordered if h.slots >= best_l]


class HostManager:
    """Tracks discovered hosts, the blacklist, and world-size validity."""

    def __init__(
        self,
        discovery: HostDiscovery,
        valid_sizes: Callable[[int], bool] | None = None,
        cooldown_s: float | None = None,
        max_discovery_failures: int | None = None,
        warm_spares: int | None = None,
    ):
        self._discovery = discovery
        # The warm-spare tier: up to this many usable hosts held OUT of the
        # world, launched and heartbeating, so a replacement costs one
        # re-rendezvous instead of a cold launch. 0 (default): no tier.
        self._warm_spares = (get_int("HOROVOD_WARM_SPARES", 0)
                             if warm_spares is None else warm_spares)
        self._spares: set[str] = set()
        # Hosts whose cooldown expired while still discovered: with the
        # tier on they come back as spares, and leave that state when the
        # world needs them (a shrink below its budget).
        self._cooldown_returned: set[str] = set()
        # A single discovery blip is routine (script timeout, cloud API
        # hiccup) and the driver retries it; a STREAK of
        # HOROVOD_ELASTIC_DISCOVERY_FAILURES consecutive failures means
        # the driver is blind to the fleet and must fail loudly. 0
        # disables escalation.
        self._max_discovery_failures = (
            get_int("HOROVOD_ELASTIC_DISCOVERY_FAILURES", 10)
            if max_discovery_failures is None else max_discovery_failures)
        self._discovery_failures = 0
        self._lock = threading.Lock()
        self._current: dict[str, int] = {}
        # host -> blacklist timestamp. With a cooldown
        # (HOROVOD_BLACKLIST_COOLDOWN seconds) entries EXPIRE — the
        # recovery path for whole-generation failures where the same hosts
        # come back; 0 keeps the permanent blacklist.
        self._blacklist: dict[str, float] = {}
        self._cooldown_s = (
            get_float("HOROVOD_BLACKLIST_COOLDOWN", 0.0)
            if cooldown_s is None else cooldown_s)
        self._expired_pending = False  # expiry happened since last poll
        self._valid = valid_sizes or (lambda n: n >= 1)

    def update_available_hosts(self) -> bool:
        """Poll discovery; returns True if the usable host set changed.

        Raises :class:`HostDiscoveryFailedError` after
        ``max_discovery_failures`` CONSECUTIVE poll failures (one success
        resets the streak); below that the underlying exception propagates
        so the caller can log-and-retry.
        """
        try:
            if faults.fire(faults.DISCOVERY_POLL):
                return False  # injected drop: this poll never happened
            found = self._discovery.find_available_hosts_and_slots()
        except HostDiscoveryFailedError:
            raise
        except Exception as e:
            self._discovery_failures += 1
            if (self._max_discovery_failures > 0
                    and self._discovery_failures
                    >= self._max_discovery_failures):
                raise HostDiscoveryFailedError(
                    f"host discovery failed {self._discovery_failures} "
                    f"consecutive times (last: {e}); the elastic driver "
                    "cannot see the fleet — giving up"
                ) from e
            raise
        self._discovery_failures = 0
        with self._lock:
            # 'before' is the PRE-PRUNE view, the world the caller last
            # acted on: a cooldown expiry must read as a change whether it
            # happens during this poll or was absorbed by an earlier lazy
            # prune (_expired_pending records those).
            before = {h: s for h, s in self._current.items()
                      if h not in self._blacklist}
            self._current = found
            after = self._usable_locked()
            changed = before != after or self._expired_pending
            self._expired_pending = False
            return changed

    def blacklist(self, hostname: str) -> None:
        with self._lock:
            # monotonic: a wall-clock step must not stretch or collapse the
            # cooldown window.
            self._blacklist[hostname] = time.monotonic()

    def export_blacklist(self) -> dict[str, float]:
        """The blacklist as {host: age in seconds}: ages, because monotonic
        stamps do not survive a driver restart (the durable snapshot,
        ``driver_state.py``)."""
        now = time.monotonic()
        with self._lock:
            self._prune_blacklist_locked()
            return {h: now - t for h, t in self._blacklist.items()}

    def restore_blacklist(self, ages) -> None:
        """A takeover's resume: the exported entries with their ages on
        this process's monotonic clock, so cooldowns go on counting across
        the crash."""
        if not isinstance(ages, dict):
            return
        now = time.monotonic()
        with self._lock:
            for host, age in ages.items():
                try:
                    self._blacklist[str(host)] = now - max(float(age), 0.0)
                except (TypeError, ValueError):
                    continue

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            self._prune_blacklist_locked()
            return hostname in self._blacklist

    def blacklist_count(self) -> int:
        """Hosts currently blacklisted (cooldown-pruned)."""
        with self._lock:
            self._prune_blacklist_locked()
            return len(self._blacklist)

    def _prune_blacklist_locked(self) -> None:
        if self._cooldown_s <= 0:
            return
        now = time.monotonic()
        for h in [h for h, t in self._blacklist.items()
                  if now - t >= self._cooldown_s]:
            del self._blacklist[h]
            # Only a host discovery STILL lists is a usable-set change.
            if h in self._current:
                self._expired_pending = True
                if self._warm_spares > 0:
                    self._cooldown_returned.add(h)

    def _usable_locked(self) -> dict[str, int]:
        self._prune_blacklist_locked()
        return {
            h: s for h, s in self._current.items() if h not in self._blacklist
        }

    def usable_hosts(self) -> list[HostInfo]:
        with self._lock:
            return [HostInfo(h, s) for h, s in sorted(self._usable_locked().items())]

    def pick_world(
        self, preferred: Sequence[str], max_np: int | None
    ) -> list[HostInfo]:
        """Choose the next world's hosts: keep ``preferred`` (current
        workers) first for rank stability, append new hosts, cap at
        ``max_np`` hosts, snap to a valid shape (:func:`snap_to_topology`),
        then snap down to the largest valid host count.

        With the warm-spare tier on, the pick also holds up to
        ``warm_spares`` surplus hosts out of the world (``spare_hosts``):
        the world takes hosts until it holds ``max_np`` slots (without
        ``max_np``: all hosts but ``warm_spares``), hosts back from a
        cooldown last; a blacklisted host is in neither."""
        with self._lock:
            usable = self._usable_locked()
            # A returned host that left discovery sheds the flag.
            self._cooldown_returned &= set(usable)
            returned = set(self._cooldown_returned)
        ordered: list[HostInfo] = []
        for h in preferred:
            if h in usable:
                ordered.append(HostInfo(h, usable[h]))
        for h, s in sorted(usable.items()):
            if all(o.hostname != h for o in ordered):
                ordered.append(HostInfo(h, s))
        if self._warm_spares <= 0:
            ordered = snap_to_topology(ordered, max_hosts=max_np)
            while ordered and not self._valid(len(ordered)):
                ordered.pop()
            with self._lock:
                self._spares = set()
            return ordered
        world = _fill(
            [h for h in ordered if h.hostname not in returned]
            + [h for h in ordered if h.hostname in returned],
            max_np, max(len(ordered) - self._warm_spares, 1))
        promoted = {h.hostname for h in world} & returned
        # Back to the preferred-first order (rank stability).
        index = {h.hostname: i for i, h in enumerate(ordered)}
        world.sort(key=lambda h: index[h.hostname])
        world = snap_to_topology(world)
        while world and not self._valid(len(world)):
            world.pop()
        names = {h.hostname for h in world}
        spares = [h for h in ordered
                  if h.hostname not in names][: self._warm_spares]
        with self._lock:
            self._cooldown_returned -= promoted & names
            self._spares = {h.hostname for h in spares}
        return world

    def spare_hosts(self) -> list[HostInfo]:
        """The spare tier: usable hosts the last ``pick_world`` held out
        of the world (empty with the tier off)."""
        with self._lock:
            usable = self._usable_locked()
            return [HostInfo(h, usable[h])
                    for h in sorted(self._spares) if h in usable]

    @property
    def warm_spares_target(self) -> int:
        return self._warm_spares


def _fill(hosts: list[HostInfo], max_slots: int | None,
          max_hosts: int) -> list[HostInfo]:
    """Hosts in order until they hold ``max_slots`` slots (or, without it,
    the first ``max_hosts``)."""
    if max_slots is None:
        return list(hosts[:max_hosts])
    out, slots = [], 0
    for h in hosts:
        if slots >= max_slots:
            break
        out.append(h)
        slots += h.slots
    return out
