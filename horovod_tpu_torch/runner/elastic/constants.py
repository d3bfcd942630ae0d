"""Shared driver↔worker constants.

A copy of ``horovod_tpu/runner/elastic/constants.py``'s codes that the
port's driver and worker use (parity:
``horovod/runner/elastic/constants.py``).
"""

# Exit code for a worker whose host was dropped from the world: neither
# success (which would end the whole job) nor failure (which would
# blacklist a healthy host).
EXIT_REMOVED = 202

# Exit code for a worker that gave up on a lost driver: the rendezvous KV
# stayed unreachable past HOROVOD_ELASTIC_DRIVER_LOST_TIMEOUT. Distinct
# from EXIT_REMOVED so an operator can tell "the driver dropped me" from
# "the driver vanished" at a glance.
EXIT_DRIVER_LOST = 203

# Exit code of a driver that found a successor with a higher driver epoch
# in its state directory (it was stopped, or cut off, through a takeover):
# it stands down without touching the workers its successor adopted.
EXIT_DRIVER_SUPERSEDED = 205

# Consecutive KV poll failures before the worker escalates its logging
# from debug to warning (the first couple of blips are routine — a driver
# mid-reconfiguration answers late; a streak is a signal).
POLL_FAILURE_WARN_AFTER = 3

# The worker-name env key: a worker is one process on one GPU slot of a
# host, and its assignment, heartbeat and completion records are keyed by
# ``<host>:<slot>``.
WORKER_ENV = "HOROVOD_ELASTIC_WORKER"


def worker_name(hostname: str, slot: int) -> str:
    """The key of the worker on GPU slot ``slot`` of ``hostname``."""
    return f"{hostname}:{slot}"
