"""Admission control: two lanes, per-account quotas and load shedding.

The port's copy of `matrixone_tpu/serving/admission.py` (reference
analogue: the proxy/queryservice tier that gates every session).
Workload statements (SELECT, INSERT, UPDATE, DELETE) pass an
`AdmissionController` before they execute:

  * two lanes: `interactive` (default) and `background`
    (`SET query_priority = 'background'`).  Freed slots go to the
    interactive lane first; background admits only when no interactive
    query is waiting.
  * per-account concurrency quotas (`account_slots`).  The port has no
    accounts yet: every session is the `sys` account's.
  * queue wait is bounded by the lane budget (`MO_ADMISSION_QUEUE_MS`,
    background `MO_ADMISSION_BG_QUEUE_MS`), capped by the thread's
    `deadline_scope`.  On exhaustion the query is shed with
    `AdmissionRejected`, a clean retryable error.
  * KILL: a queued query polls its ProcessRegistry slot, so
    `KILL QUERY <id>` removes it from the queue (QueryKilled).

Off by default (`MO_ADMISSION_SLOTS=0`); armed by the env or by
`mo_ctl('serving', 'slots:<n>')`.  Every submitted query lands in one
`mo_admission_total{lane,outcome}` bucket: admitted | shed_capacity |
shed_timeout | shed_deadline | killed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from matrixone_tpu_torch.queryservice import QueryKilled

#: wait-slice granularity: KILL/deadline reaction time while queued
_SLICE_S = 0.05

LANES = ("interactive", "background")


class Deadline:
    """Absolute expiry on the monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, seconds: float):
        self.expires_at = time.monotonic() + seconds

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()


_tls = threading.local()


def current_deadline() -> Optional[Deadline]:
    return getattr(_tls, "deadline", None)


@contextmanager
def deadline_scope(seconds: Optional[float] = None, *,
                   ms: Optional[float] = None):
    """Bound the statements this thread runs in the scope's extent (the
    reference's `cluster.rpc.deadline_scope`, which the port's RPC layer
    will take over).  Nested scopes can only shrink the budget."""
    budget = (ms / 1000.0) if ms is not None else \
        (seconds if seconds is not None else 30.0)
    new = Deadline(budget)
    prev = current_deadline()
    if prev is not None:
        new.expires_at = min(new.expires_at, prev.expires_at)
    _tls.deadline = new
    try:
        yield new
    finally:
        _tls.deadline = prev


class AdmissionRejected(RuntimeError):
    """Load shed — safe to retry on this or another CN."""
    retryable = True


class _Waiter:
    __slots__ = ("account", "lane", "admitted", "enq")

    def __init__(self, account: str, lane: str):
        self.account = account
        self.lane = lane
        self.admitted = False
        self.enq = time.monotonic()


class _Ticket:
    """Held while the admitted statement runs; release() frees the slot."""
    __slots__ = ("ctl", "account", "queue_wait_s", "_done")

    def __init__(self, ctl, account: str, queue_wait_s: float):
        self.ctl = ctl
        self.account = account
        self.queue_wait_s = queue_wait_s
        self._done = False

    def release(self) -> None:
        if self._done:
            return
        self._done = True
        self.ctl._release(self.account)


class AdmissionController:
    def __init__(self, slots: int = 0, queue_ms: float = 5000.0,
                 bg_queue_ms: float = 500.0, account_slots: int = 0,
                 max_queue: int = 256):
        self._cv = threading.Condition()
        self.slots = slots                  # 0 = admission disabled
        self.queue_ms = queue_ms
        self.bg_queue_ms = bg_queue_ms
        self.account_slots = account_slots  # 0 = unlimited per account
        self.max_queue = max_queue
        self.running = 0
        self._by_account: dict = {}
        self._queues = {lane: deque() for lane in LANES}

    @property
    def enabled(self) -> bool:
        return self.slots > 0

    # ---------------------------------------------------------- internals
    def _account_free(self, account: str) -> bool:
        return (self.account_slots <= 0
                or self._by_account.get(account, 0) < self.account_slots)

    def _dispatch(self) -> None:
        """Admit eligible waiters, interactive lane first (under _cv).
        Background admits only when no interactive waiter is CURRENTLY
        eligible — but interactive waiters stuck on their account quota
        must not starve other work while global slots sit free (after
        the interactive scan, anyone still queued is quota-blocked)."""
        for lane in LANES:
            q = self._queues[lane]
            for w in list(q):
                if self.running >= self.slots:
                    return      # slots gone: priority order preserved
                if not self._account_free(w.account):
                    continue        # quota-blocked: skip, don't block lane
                q.remove(w)
                w.admitted = True
                self.running += 1
                self._by_account[w.account] = \
                    self._by_account.get(w.account, 0) + 1

    def _release(self, account: str) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        with self._cv:
            self.running -= 1
            n = self._by_account.get(account, 1) - 1
            if n <= 0:
                self._by_account.pop(account, None)
            else:
                self._by_account[account] = n
            self._dispatch()
            self._cv.notify_all()
            M.admission_running.set(self.running)
            M.admission_queued.set(
                sum(len(q) for q in self._queues.values()))

    # ------------------------------------------------------------ acquire
    def acquire(self, account: str = "sys", lane: str = "interactive",
                conn_id: Optional[int] = None, registry=None) -> _Ticket:
        """Block until admitted; raise AdmissionRejected on shed and
        QueryKilled when the queued query is killed."""
        from matrixone_tpu_torch.utils import metrics as M
        if lane not in LANES:
            lane = "interactive"
        if not self.enabled:
            # pre-released: this ticket never incremented any counter, so
            # its release() must not decrement one (an operator flipping
            # slots mid-flight would otherwise corrupt `running` forever)
            t = _Ticket(self, account, 0.0)
            t._done = True
            return t

        budget_s = (self.bg_queue_ms if lane == "background"
                    else self.queue_ms) / 1000.0
        dl = current_deadline()
        if dl is not None:
            rem = dl.remaining()
            if rem <= 0:
                M.admission_total.inc(lane=lane, outcome="shed_deadline")
                raise AdmissionRejected(
                    "admission: deadline exhausted before execution; "
                    "retry with a fresh deadline")
            budget_s = min(budget_s, rem)

        with self._cv:
            # fast path: a free slot and an empty (or quota-eligible) queue
            if self.running < self.slots and self._account_free(account) \
                    and not self._queues["interactive"] \
                    and (lane == "interactive"
                         or not self._queues["background"]):
                self.running += 1
                self._by_account[account] = \
                    self._by_account.get(account, 0) + 1
                M.admission_total.inc(lane=lane, outcome="admitted")
                M.admission_running.set(self.running)
                return _Ticket(self, account, 0.0)
            if sum(len(q) for q in self._queues.values()) >= self.max_queue:
                M.admission_total.inc(lane=lane, outcome="shed_capacity")
                raise AdmissionRejected(
                    f"admission: queue full ({self.max_queue} waiting); "
                    f"server overloaded, retry later")
            w = _Waiter(account, lane)
            self._queues[lane].append(w)
            M.admission_queued.set(
                sum(len(q) for q in self._queues.values()))
            if registry is not None and conn_id is not None:
                registry.set_queued(conn_id, True)
            from matrixone_tpu_torch.utils import motrace
            self._dispatch()     # may admit immediately (e.g. the only
            deadline = time.monotonic() + budget_s   # blockers are
            try:                                     # quota-blocked)
                with motrace.span("admission.queue", lane=lane):
                    while not w.admitted:
                        if registry is not None and conn_id is not None:
                            try:
                                registry.check_killed(conn_id)
                            except QueryKilled:
                                # only a REAL kill counts as
                                # outcome=killed; an internal registry
                                # error must surface as itself, not
                                # skew the shed accounting
                                M.admission_total.inc(lane=lane,
                                                      outcome="killed")
                                raise
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            M.admission_total.inc(lane=lane,
                                                  outcome="shed_timeout")
                            raise AdmissionRejected(
                                f"admission: no {lane} slot within "
                                f"{budget_s * 1000:.0f} ms "
                                f"({self.running}/{self.slots} running); "
                                f"server busy, retry later")
                        self._cv.wait(min(remaining, _SLICE_S))
                        self._dispatch()
            except BaseException:    # noqa: BLE001 — cleanup-only,
                # re-raised below; incl. KeyboardInterrupt so an
                # interrupted waiter never leaks its queue ticket.
                # not admitted: leave the queue; admitted mid-exception
                # (can't happen once removed, but belt and braces):
                # release the slot
                if w.admitted:
                    self.running -= 1
                    n = self._by_account.get(account, 1) - 1
                    if n <= 0:
                        self._by_account.pop(account, None)
                    else:
                        self._by_account[account] = n
                    self._dispatch()
                    self._cv.notify_all()
                else:
                    try:
                        self._queues[lane].remove(w)
                    except ValueError:
                        pass
                M.admission_queued.set(
                    sum(len(q) for q in self._queues.values()))
                if registry is not None and conn_id is not None:
                    registry.set_queued(conn_id, False)
                raise
            if registry is not None and conn_id is not None:
                registry.set_queued(conn_id, False)
            wait_s = time.monotonic() - w.enq
            M.admission_total.inc(lane=lane, outcome="admitted")
            M.admission_queue_seconds.observe(wait_s)
            M.admission_running.set(self.running)
            M.admission_queued.set(
                sum(len(q) for q in self._queues.values()))
            return _Ticket(self, account, wait_s)

    # ------------------------------------------------------------- status
    def stats(self) -> dict:
        from matrixone_tpu_torch.utils import metrics as M
        with self._cv:
            queued = {lane: len(q) for lane, q in self._queues.items()}
            return {
                "slots": self.slots, "running": self.running,
                "queued": queued,
                "account_slots": self.account_slots,
                "queue_ms": self.queue_ms,
                "bg_queue_ms": self.bg_queue_ms,
                "by_account": dict(self._by_account),
                "admitted": {lane: int(M.admission_total.get(
                    lane=lane, outcome="admitted")) for lane in LANES},
                "shed": {lane: int(
                    M.admission_total.get(lane=lane,
                                          outcome="shed_capacity")
                    + M.admission_total.get(lane=lane,
                                            outcome="shed_timeout")
                    + M.admission_total.get(lane=lane,
                                            outcome="shed_deadline"))
                    for lane in LANES},
                "killed": {lane: int(M.admission_total.get(
                    lane=lane, outcome="killed")) for lane in LANES},
                "enabled": self.enabled,
            }
