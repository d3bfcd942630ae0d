"""Bounded retry with exponential backoff and jitter.

A copy of ``horovod_tpu/utils/retry.py``'s ``backoff_delay`` and
``call_with_retries`` (the port imports nothing of the JAX package), cut
to what the rank-0 checkpoint writes use: a transient storage error is
retried a bounded number of times before the failure propagates.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

T = TypeVar("T")

# The reference's defaults: the longest sleep, and the uniform spread
# around each sleep.
MAX_DELAY = 5.0
JITTER = 0.5


def backoff_delay(attempt: int, base_delay: float) -> float:
    """The delay before attempt ``attempt + 1`` (attempts are 1-based):
    ``min(MAX_DELAY, base_delay * 2**(attempt-1))`` scaled by a uniform
    ``1 +- JITTER`` factor, floored at 0."""
    delay = min(MAX_DELAY, base_delay * (2 ** (attempt - 1)))
    return max(0.0, delay * (1.0 + random.uniform(-JITTER, JITTER)))


def call_with_retries(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    give_up_on: tuple[type[BaseException], ...] = (),
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping
    :func:`backoff_delay` between attempts; ``on_retry(attempt, error)``
    runs before each sleep, and the last attempt's error propagates, as
    does at once an error of a ``give_up_on`` type."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= attempts or isinstance(e, give_up_on):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_delay(attempt, base_delay))
    raise AssertionError("unreachable")
