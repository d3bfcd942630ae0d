"""Small networking helpers of the launcher.

The parts of ``horovod_tpu/runner/network.py`` the launcher and the
elastic driver use, copied (parity: ``horovod/runner/util/network.py``).
"""

from __future__ import annotations

import socket

LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def is_local(hostname: str) -> bool:
    # The whole 127.0.0.0/8 block is the loopback device: any 127.x.y.z
    # literal names THIS machine (the kernel routes the full /8), which
    # is what lets the localhost-as-cluster test harness emulate more
    # distinct "hosts" than the three canonical local names — a shared
    # multi-job pool needs disjoint per-job host sets plus spares.
    return (hostname in LOCAL_NAMES
            or hostname.startswith("127.")
            or hostname == socket.gethostname())


def routable_addr() -> str:
    """This host's address as reachable from other machines."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return socket.gethostname()


def driver_addr(hostnames: list[str]) -> str:
    """The address workers use to reach services running in the launcher
    (the elastic driver's rendezvous KV): loopback only when the world is
    known-local (a NON-EMPTY all-local host list), else this host's
    routable address."""
    if hostnames and all(is_local(h) for h in hostnames):
        return "127.0.0.1"
    return routable_addr()


def coordinator_addr(hostnames: list[str]) -> str:
    """The address of rank 0's TCP store, where the workers meet: rank 0's
    host."""
    first = hostnames[0]
    if first in LOCAL_NAMES:
        return "127.0.0.1"
    return first
