"""The ``HOROVOD_*`` environment keys the PyTorch port reads.

Names and defaults follow ``horovod_tpu/utils/env.py`` and the launcher's
world contract (``horovod_tpu/process_world.py``), so deployment scripts
keep working. Precedence is the same: an API argument beats the env var,
which beats the default.
"""

from __future__ import annotations

import os

# Tensor fusion: bucket cap in bytes (reference default 64 MiB).
FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Gradient sync mode: allreduce, sharded (ZeRO-1) or fsdp (ZeRO-3).
SYNC_MODE = "HOROVOD_SYNC_MODE"
# Contiguous leaf segments of a step's parameters (default 4), and the fsdp
# mode's own count of per-segment parameter gathers (unset: the former).
OVERLAP_SEGMENTS = "HOROVOD_OVERLAP_SEGMENTS"
FSDP_SEGMENTS = "HOROVOD_FSDP_SEGMENTS"
# "0" makes the fsdp mode gather all parameters up front in one segment
# (default "1": a gather per segment, just before its layers run).
FSDP_RESHARD_AFTER_FORWARD = "HOROVOD_FSDP_RESHARD_AFTER_FORWARD"
# Rank-0 checkpoint writes: attempts and the first backoff in seconds.
CHECKPOINT_RETRIES = "HOROVOD_CHECKPOINT_RETRIES"
CHECKPOINT_RETRY_BACKOFF = "HOROVOD_CHECKPOINT_RETRY_BACKOFF"
# "1" keeps the compression / bucketing / collective path on a one-rank
# world instead of short-circuiting it (measures the framework's overhead).
FORCE_WIRE_MACHINERY = "HOROVOD_FORCE_WIRE_MACHINERY"
# The non-finite tripwire over the reduced gradients: warn, skip or abort
# (unset: no check).
NONFINITE_ACTION = "HOROVOD_NONFINITE_ACTION"
# Leveled logging (utils/logging.py).
LOG_LEVEL = "HOROVOD_LOG_LEVEL"
LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"

# World facts written by the launcher for each worker process.
NUM_PROCESSES = "HOROVOD_NUM_PROCESSES"
PROCESS_ID = "HOROVOD_PROCESS_ID"
LOCAL_RANK = "HOROVOD_LOCAL_RANK"
LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
# Host index and host count, where the launcher knows them.
CROSS_RANK = "HOROVOD_CROSS_RANK"
CROSS_SIZE = "HOROVOD_CROSS_SIZE"
# host:port of rank 0's rendezvous for a multi-process world.
COORDINATOR_ADDR = "HOROVOD_COORDINATOR_ADDR"


def get_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        return default


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)
