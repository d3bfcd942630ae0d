"""Device-profiler integration (the reference's NVTX/Nsight role).

Port of ``horovod_tpu/profiler.py``: :func:`start`, :func:`stop`,
:func:`active`, :func:`trace`, :func:`maybe_start_from_env`
(``HOROVOD_PROFILER_LOGDIR``, started by ``hvd.init()``),
:func:`annotate_collective` and :func:`summary`, on ``torch.profiler``
where the JAX package uses ``jax.profiler``:

- a capture records the host's ops and, where a card is visible, its
  kernels (``ProfilerActivity.CPU`` and ``CUDA``); :func:`stop` writes one
  Chrome trace per rank into the log directory, ``rank<r>.trace.json``,
  loadable in Perfetto or ``chrome://tracing``;
- the timeline's activities (``timeline.activity``) and
  :func:`annotate_collective`'s ``hvd.<name>`` ranges are
  ``record_function`` ranges, so a capture shows the framework's step
  phases, eager collectives and gradient buckets above the kernels they
  launched (and, on a CUDA world, as NVTX ranges for an external
  profiler).

``torch.profiler`` holds every event of a capture in memory: capture a few
steps (``with hvd.profiler.trace(logdir): ...``), not a whole run.
A failure to start or stop a capture is an error, never a silent no-op.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_active_logdir: str | None = None
_prof = None


def _rank() -> int:
    from . import basics

    if basics.is_initialized():
        return basics.rank()
    return int(os.environ.get("HOROVOD_RANK", "0") or 0)


def start(logdir: str) -> None:
    """Begin a capture into ``logdir`` (idempotent per process): the
    host's ops, and the card's kernels where a card is visible."""
    global _active_logdir, _prof
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _active_logdir is not None:
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _prof, _active_logdir = prof, logdir


def stop() -> str | None:
    """End the capture and write this rank's Chrome trace,
    ``<logdir>/rank<r>.trace.json``; returns its path (None when no
    capture was running)."""
    global _active_logdir, _prof
    with _lock:
        if _active_logdir is None:
            return None
        prof, logdir = _prof, _active_logdir
        _prof, _active_logdir = None, None
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"rank{_rank()}.trace.json")
        prof.export_chrome_trace(path)
        return path


def active() -> bool:
    return _active_logdir is not None


def maybe_start_from_env() -> None:
    """Called by ``hvd.init()``: start a capture into
    ``HOROVOD_PROFILER_LOGDIR`` when it is set."""
    logdir = os.environ.get("HOROVOD_PROFILER_LOGDIR", "")
    if logdir:
        start(logdir)


def summary() -> dict:
    """One-call observability snapshot: the capture's state, the elastic
    goodput ledger, the checkpoint and replication ledger, the straggler
    view (this rank's clock offset and, with a rendezvous server, the
    cluster's skew), the parameter-sharding ledger, the step-time
    attribution plane (the last synced step's decomposition and MFU), the
    communication observatory (``comms``: the fitted alpha-beta model, its
    samples and residual), the memory observatory (``memory``: resident
    bytes by kind, phase watermarks, the predicted footprint and its
    drift, the largest leaves), the integrity plane's ledger
    (``integrity``: armed, interval, fingerprints, commits, the latest
    digest, non-finite detections, rewinds, pending skip-ahead) and
    ``cache_stats()`` (per-kind eager dispatches)."""
    from . import (attribution, comms_model, integrity, memory, metrics,
                   tracing)
    from .ops.collective_ops import cache_stats

    return {
        "trace_active": active(),
        "trace_logdir": _active_logdir,
        "goodput": metrics.goodput().summary(),
        "checkpoint": metrics.checkpoint_summary(),
        "stragglers": tracing.straggler_summary(),
        "fsdp": metrics.fsdp_summary(),
        "attribution": attribution.summary(),
        "comms": comms_model.summary(),
        "integrity": integrity.summary(),
        "memory": memory.summary(),
        **cache_stats(),
    }


def annotate_collective(name: str):
    """A ``hvd.<name>`` range (``record_function``, and NVTX on a CUDA
    world; a host timeline event when the timeline is on) around a
    collective region: the optimizer wraps each gradient bucket's launch
    and finish, so a capture shows which bucket's transfer overlaps which
    stretch of backward."""
    from .timeline import activity

    return activity(f"hvd.{name}", "collective")


class trace:
    """Scoped capture: ``with hvd.profiler.trace('/tmp/prof'): step()``;
    :attr:`path` is the trace written on exit."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: str | None = None

    def __enter__(self):
        start(self.logdir)
        return self

    def __exit__(self, *exc):
        self.path = stop()
        return False
