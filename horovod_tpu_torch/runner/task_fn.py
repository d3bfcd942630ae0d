"""Per-host task-service entry point (a copy of
``horovod_tpu/runner/task_fn.py``; parity: ``horovod/runner/task_fn.py``).

The driver launches ``python -m horovod_tpu_torch.runner.task_fn`` on every
host during the pre-flight probe; the process prints its service port (the
driver reads it from the muxed output), serves NIC queries, and exits when
the driver is done (or after ``--ttl`` seconds as a safety net).
"""

from __future__ import annotations

import argparse
import signal
import threading

from .driver_service import TaskService


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--ttl", type=float, default=120.0,
                   help="exit after this many seconds (orphan safety net)")
    args = p.parse_args()
    svc = TaskService(port=args.port)
    port = svc.start()
    print(f"HVD_TASK_SERVICE_PORT={port}", flush=True)
    # SIGTERM (driver teardown / preemption notice) ends the TTL wait
    # immediately and exits 0 — a probe service has nothing to drain, so
    # an interruptible wait is the whole graceful-shutdown story (the old
    # time.sleep forced the driver to wait out SIGKILL escalation).
    done = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: done.set())
    except ValueError:  # not the main thread (embedded use): TTL only
        pass
    done.wait(args.ttl)
    svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
