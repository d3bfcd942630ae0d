"""Bounded retry with exponential backoff and jitter.

A copy of ``horovod_tpu/utils/retry.py``'s ``backoff_delay`` and
``call_with_retries`` (the port imports nothing of the JAX package), cut
to what the rendezvous KV client and the rank-0 checkpoint writes use: a
transient error is retried a bounded number of times before the failure
propagates, and an exhausted budget is journaled.
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


def _note_exhausted(name: str | None, attempts: int,
                    error: BaseException) -> None:
    """Journal one ``retry_budget_exhausted`` event; never masks the
    error about to propagate."""
    try:
        from .. import metrics

        metrics.event("retry_budget_exhausted", name=name or "",
                      attempts=attempts, deadline=False,
                      error=str(error)[:200])
    except Exception:  # noqa: BLE001 — journaling never blocks the raise
        pass


def call_with_retries(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    give_up_on: tuple[type[BaseException], ...] = (),
    on_retry: Callable[[int, BaseException], None] | None = None,
    name: str | None = None,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping
    :func:`backoff_delay` between attempts; ``on_retry(attempt, error)``
    runs before each sleep, and the last attempt's error propagates, as
    does at once an error of a ``give_up_on`` type (an answer, not a
    blip). An exhausted budget journals ``retry_budget_exhausted``
    (labelled ``name``) before the error propagates, as the reference
    does; the reference's ``deadline_s`` serves only its serving tier,
    which the port does not have."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:
            if isinstance(e, give_up_on):
                raise
            if attempt >= attempts:
                _note_exhausted(name, attempt, e)
                raise
            from .. import metrics

            metrics.RETRIES.inc()
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_delay(attempt, base_delay))
    raise AssertionError("unreachable")
