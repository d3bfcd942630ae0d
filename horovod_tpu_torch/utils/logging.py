"""Leveled logging, mirroring the reference's ``horovod/common/logging.cc``.

Copy of ``horovod_tpu/utils/logging.py`` for the PyTorch port (importing
any ``horovod_tpu`` module would import jax), logging as
``horovod_tpu_torch``.

``HOROVOD_LOG_LEVEL`` in {trace, debug, info, warning, error, fatal};
``HOROVOD_LOG_HIDE_TIME`` drops the time from the prefix.

Every record is prefixed with ``[rank/size g<generation>]`` when the
process runs inside a launched world (``HOROVOD_RANK`` set), the
generation part appearing only in elastic worlds, so the interleaved
stdout of a multi-worker job stays attributable per line. With
``HOROVOD_JOB_ID`` set the prefix leads with the job id:
``[job/rank/size g<gen>]`` for workers, ``[job]`` for a rankless process.
The prefix re-reads the environment per record, so a record after an
elastic resize carries the new identity.
"""

from __future__ import annotations

import logging
import os
import sys

from . import env

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger: logging.Logger | None = None


def rank_prefix() -> str:
    """``"[rank/size g<generation>] "`` for launched workers — with the
    job id prepended (``[job/rank/size g<gen>] ``) when ``HOROVOD_JOB_ID``
    is set — ``"[job] "`` for a job-tagged rankless process (the per-job
    elastic driver under the multi-tenant scheduler), and ``""``
    elsewhere (single-process scripts keep clean logs)."""
    job = os.environ.get("HOROVOD_JOB_ID") or ""
    rank = os.environ.get("HOROVOD_RANK")
    if rank is None:
        return f"[{job}] " if job else ""
    size = os.environ.get("HOROVOD_SIZE") or "?"
    prefix = f"[{job}/{rank}/{size}" if job else f"[{rank}/{size}"
    if (os.environ.get("HOROVOD_ELASTIC") == "1"
            or "HOROVOD_WORLD_VERSION" in os.environ):
        prefix += f" g{os.environ.get('HOROVOD_WORLD_VERSION', '0') or '0'}"
    return prefix + "] "


class RankPrefixFormatter(logging.Formatter):
    """Injects :func:`rank_prefix` as ``%(hvdctx)s`` — computed per
    record, not per handler, so elastic identity changes show up live."""

    def format(self, record: logging.LogRecord) -> str:
        record.hvdctx = rank_prefix()
        return super().format(record)


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("horovod_tpu_torch")
        level = os.environ.get(env.LOG_LEVEL, "warning").lower()
        logger.setLevel(_LEVELS.get(level, logging.WARNING))
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            if os.environ.get(env.LOG_HIDE_TIME):
                fmt = "[%(levelname)s] %(hvdctx)s%(message)s"
            else:
                fmt = "%(asctime)s [%(levelname)s] %(hvdctx)s%(message)s"
            handler.setFormatter(RankPrefixFormatter(fmt))
            logger.addHandler(handler)
        logger.propagate = False
        _logger = logger
    return _logger
