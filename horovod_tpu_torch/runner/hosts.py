"""Host parsing and rank assignment for the launcher.

Port of ``horovod_tpu/runner/hosts.py`` (``HostInfo``, ``parse_hosts``,
``parse_hostfile``, ``get_host_assignments``) with upstream Horovod's
process model, not the JAX package's: one process per slot, and one slot
per GPU (``horovod/runner/common/util/hosts.py — get_host_assignments``,
which ``horovod_tpu/runner/hosts.py:103-105`` cites). So ``-H a:4,b:4 -np
8`` starts four processes on each host, ``local_rank`` 0-3 and
``local_size`` 4 there, and each process drives the card of its local
rank.
"""

from __future__ import annotations

import dataclasses
import re


class HostParseError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One host spec: ``hostname:slots`` (slots default 1)."""

    hostname: str
    slots: int

    @classmethod
    def from_string(cls, spec: str) -> "HostInfo":
        spec = spec.strip()
        m = re.fullmatch(r"([^\s:]+)(?::(\d+))?", spec)
        if not m:
            raise HostParseError(f"bad host spec {spec!r}; expected host[:slots]")
        slots = int(m.group(2)) if m.group(2) else 1
        if slots < 1:
            raise HostParseError(f"bad slot count in {spec!r}: must be >= 1")
        return cls(m.group(1), slots)


def parse_hosts(hosts_string: str) -> list[HostInfo]:
    """Parse ``-H h1:4,h2:4`` (comma separated host:slots)."""
    hosts = [
        HostInfo.from_string(s) for s in hosts_string.split(",") if s.strip()
    ]
    if not hosts:
        raise HostParseError(f"no hosts in {hosts_string!r}")
    seen: set[str] = set()
    for h in hosts:
        if h.hostname in seen:
            raise HostParseError(f"duplicate host {h.hostname!r}")
        seen.add(h.hostname)
    return hosts


def parse_hostfile(path: str) -> list[HostInfo]:
    """Parse a hostfile: one ``host slots=N`` or ``host:N`` per line."""
    hosts: list[HostInfo] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.fullmatch(r"(\S+)\s+slots\s*=\s*(\d+)", line)
            if m:
                hosts.append(HostInfo(m.group(1), int(m.group(2))))
            else:
                hosts.append(HostInfo.from_string(line))
    if not hosts:
        raise HostParseError(f"hostfile {path!r} contains no hosts")
    return hosts


@dataclasses.dataclass(frozen=True)
class ProcessAssignment:
    """One launched worker process (one GPU) and its world facts, as
    ``horovod_tpu_torch.basics`` reads them from the env block."""

    hostname: str
    rank: int  # global rank (HOROVOD_RANK, HOROVOD_PROCESS_ID)
    size: int  # world size
    local_rank: int  # index among this host's processes: its card
    local_size: int  # processes on this host
    cross_rank: int  # index of this host among those with this local rank
    cross_size: int  # hosts with a process of this local rank


def get_host_assignments(hosts: list[HostInfo],
                         np: int | None = None) -> list[ProcessAssignment]:
    """Assign ranks to slots, hosts in the given order, each host filled
    before the next (upstream's rule: as many processes as possible share
    a host). ``np`` (default: every slot) caps the world size; more than
    the hosts' slots raises.

    ``cross_rank`` is the host's index among the hosts that have a process
    of the same local rank, and ``cross_size`` their number (upstream's
    ``cross_ranks`` table): on hosts of equal slots, the host index and the
    number of hosts.
    """
    total = sum(h.slots for h in hosts)
    np = total if np is None else np
    if np < 1 or np > total:
        raise HostParseError(
            f"requested {np} processes but the hosts have {total} slot(s)")
    host_ranks: list[tuple[HostInfo, list[int]]] = []
    cross: dict[int, dict[str, int]] = {}
    rank = 0
    for h in hosts:
        ranks = []
        for local_rank in range(h.slots):
            if rank == np:
                break
            ranks.append(rank)
            rank += 1
            at_local = cross.setdefault(local_rank, {})
            at_local[h.hostname] = len(at_local)
        if ranks:
            host_ranks.append((h, ranks))
    out = []
    for h, ranks in host_ranks:
        for local_rank, r in enumerate(ranks):
            out.append(ProcessAssignment(
                hostname=h.hostname, rank=r, size=np, local_rank=local_rank,
                local_size=len(ranks),
                cross_rank=cross[local_rank][h.hostname],
                cross_size=len(cross[local_rank])))
    return out
