"""Hybrid logical clock (reference: pkg/txn/clock/hlc.go — redesigned).

Timestamps are single int64s: (physical_ms << 20) | logical. One process
needs only monotonicity; the multi-host path (parallel/) forwards clocks on
message receipt the usual HLC way.
"""

from __future__ import annotations

import threading
import time

_LOGICAL_BITS = 20
_LOGICAL_MASK = (1 << _LOGICAL_BITS) - 1


class HLC:
    def __init__(self):
        self._last = 0
        self._lock = threading.Lock()

    def now(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000) << _LOGICAL_BITS
            self._last = max(phys, self._last + 1)
            return self._last

    def update(self, observed: int) -> int:
        """Forward the clock past a timestamp observed from a peer."""
        with self._lock:
            self._last = max(self._last, observed)
            return self._last


def physical_ms(ts: int) -> int:
    return ts >> _LOGICAL_BITS
