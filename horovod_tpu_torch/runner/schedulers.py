"""Cluster-scheduler host discovery for ``hvdrun-torch``.

A copy of ``horovod_tpu/runner/schedulers.py``. Parity:
``horovod/runner/util/lsf.py`` (``LSFUtils.using_lsf`` /
``get_compute_hosts``) and the reference's Slurm support (upstream rides
``mpirun`` inside an allocation; we parse the allocation directly since
there is no MPI here). When ``hvdrun`` runs inside an LSF or Slurm job and
the user gave no ``-H``/``--hostfile``, the allocation's hosts are used
automatically — same UX as the reference's LSF auto-detection.

Slots follow this launcher's meaning (one process per slot, one slot per
GPU, see :mod:`.hosts`), so scheduler task/cpu counts are carried through
as the per-host slot count.
"""

from __future__ import annotations

import os
import re

from .hosts import HostInfo, HostParseError


def in_lsf(environ=os.environ) -> bool:
    """True inside an LSF job (parity: LSFUtils.using_lsf)."""
    return "LSB_JOBID" in environ and (
        "LSB_MCPU_HOSTS" in environ or "LSB_HOSTS" in environ
    )


def lsf_hosts(environ=os.environ) -> list[HostInfo]:
    """Hosts of the current LSF allocation, first-seen order.

    ``LSB_MCPU_HOSTS`` is "host1 n1 host2 n2 ..."; ``LSB_HOSTS`` repeats
    each hostname once per slot. The batch/launch host LSF prepends is
    kept — the reference also trains on it.
    """
    mcpu = environ.get("LSB_MCPU_HOSTS")
    counts: dict[str, int] = {}
    if mcpu:
        toks = mcpu.split()
        if len(toks) % 2:
            raise HostParseError(f"malformed LSB_MCPU_HOSTS: {mcpu!r}")
        for host, n in zip(toks[::2], toks[1::2]):
            if not n.isdigit() or int(n) < 1:
                raise HostParseError(
                    f"malformed LSB_MCPU_HOSTS count for {host}: {n!r}"
                )
            counts[host] = counts.get(host, 0) + int(n)
    else:
        for host in environ.get("LSB_HOSTS", "").split():
            counts[host] = counts.get(host, 0) + 1
    if not counts:
        raise HostParseError("no LSF hosts found in LSB_MCPU_HOSTS/LSB_HOSTS")
    return [HostInfo(h, n) for h, n in counts.items()]


def in_slurm(environ=os.environ) -> bool:
    """True inside a Slurm allocation."""
    return "SLURM_JOB_ID" in environ and (
        "SLURM_JOB_NODELIST" in environ or "SLURM_NODELIST" in environ
    )


def expand_nodelist(nodelist: str) -> list[str]:
    """Expand Slurm's compressed nodelist syntax:
    ``"gpu[001-004,007],login1"`` -> gpu001..gpu004, gpu007, login1.
    Zero-padding of range endpoints is preserved.
    """
    hosts: list[str] = []
    i = 0
    n = len(nodelist)
    while i < n:
        j = i
        # scan one comma-separated element, tracking bracket depth
        depth = 0
        while j < n and (nodelist[j] != "," or depth > 0):
            if nodelist[j] == "[":
                depth += 1
            elif nodelist[j] == "]":
                depth -= 1
            j += 1
        elem = nodelist[i:j].strip()
        i = j + 1
        if not elem:
            continue
        m = re.fullmatch(r"([^\[\]]*)\[([^\]]+)\]([^\[\]]*)", elem)
        if not m:
            if "[" in elem or "]" in elem:
                raise HostParseError(f"bad Slurm nodelist element {elem!r}")
            hosts.append(elem)
            continue
        prefix, body, suffix = m.groups()
        for part in body.split(","):
            part = part.strip()
            if "-" in part:
                lo, hi = part.split("-", 1)
                width = len(lo) if lo.startswith("0") else 0
                if not (lo.isdigit() and hi.isdigit() and int(lo) <= int(hi)):
                    raise HostParseError(
                        f"bad Slurm range {part!r} in {elem!r}"
                    )
                for v in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{v:0{width}d}{suffix}")
            else:
                if not part.isdigit():
                    raise HostParseError(
                        f"bad Slurm range element {part!r} in {elem!r}"
                    )
                hosts.append(f"{prefix}{part}{suffix}")
    if not hosts:
        raise HostParseError(f"empty Slurm nodelist {nodelist!r}")
    return hosts


def _expand_tasks_per_node(spec: str, n_hosts: int) -> list[int]:
    """Expand SLURM_TASKS_PER_NODE, e.g. ``"2(x3),1"`` -> [2,2,2,1];
    pads/truncates defensively to n_hosts (1 slot default)."""
    out: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        m = re.fullmatch(r"(\d+)(?:\(x(\d+)\))?", part)
        if not m:
            raise HostParseError(f"bad SLURM_TASKS_PER_NODE element {part!r}")
        count = int(m.group(2)) if m.group(2) else 1
        out.extend([int(m.group(1))] * count)
    out = out[:n_hosts]
    out.extend([1] * (n_hosts - len(out)))
    return out


def slurm_hosts(environ=os.environ) -> list[HostInfo]:
    """Hosts of the current Slurm allocation with per-node task counts as
    slots."""
    nodelist = environ.get("SLURM_JOB_NODELIST") or environ.get(
        "SLURM_NODELIST"
    )
    if not nodelist:
        raise HostParseError("no SLURM_JOB_NODELIST/SLURM_NODELIST set")
    names = expand_nodelist(nodelist)
    tasks = environ.get("SLURM_TASKS_PER_NODE")
    slots = (
        _expand_tasks_per_node(tasks, len(names))
        if tasks
        else [1] * len(names)
    )
    return [HostInfo(h, s) for h, s in zip(names, slots)]


def detect_scheduler_hosts(environ=os.environ) -> list[HostInfo] | None:
    """Hosts from the surrounding scheduler allocation, or None when not
    running under a recognized scheduler. LSF is checked first (the
    reference's only auto-detected scheduler), then Slurm."""
    if in_lsf(environ):
        return lsf_hosts(environ)
    if in_slurm(environ):
        return slurm_hosts(environ)
    return None
