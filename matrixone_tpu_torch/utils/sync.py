"""Event-driven waiting: `wait_until` and `notify_waiters`.

The port's copy of `matrixone_tpu/utils/sync.py`.  Components that
change observable state (a circuit breaker's transitions, a logtail
consumer's applied position) call `notify_waiters()`; `wait_until`
blocks on one shared condition variable and re-evaluates its predicate
on each notification.  A small wait cap bounds the cost of a transition
that forgot to notify.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

_COND = threading.Condition()

#: safety net for transitions made without notify_waiters()
_MAX_WAIT = 0.25


def notify_waiters() -> None:
    """Wake every wait_until() so it re-checks its predicate.  Never
    blocks: a caller may hold its own lock, which a waiter's predicate
    may take while holding the condition; when the condition is busy the
    notify is skipped and the waiter's bounded wait re-checks."""
    if _COND.acquire(blocking=False):
        try:
            _COND.notify_all()
        finally:
            _COND.release()


def wait_until(predicate: Callable[[], Any], timeout: float = 10.0,
               message: Optional[str] = None,
               raise_on_timeout: bool = True) -> Any:
    """Block until `predicate()` is truthy and return its value; raise
    TimeoutError after `timeout` seconds (or return False with
    `raise_on_timeout=False`).  The predicate runs before the first wait,
    and a raising predicate propagates its own exception."""
    deadline = time.monotonic() + timeout
    with _COND:
        while True:
            value = predicate()
            if value:
                return value
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if not raise_on_timeout:
                    return False
                raise TimeoutError(
                    message or f"wait_until: predicate still false "
                               f"after {timeout}s")
            _COND.wait(min(remaining, _MAX_WAIT))
