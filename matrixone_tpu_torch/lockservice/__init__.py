"""Pessimistic lock service with deadlock detection.

The port's copy of `matrixone_tpu/lockservice/__init__.py` (host-only),
with a plain `threading.Condition` where the reference builds one
through its lock sanitizer.

Reference analogue: `pkg/lockservice` (34k LoC — lock tables allocated per
table, row/range locks, distributed deadlock detection `deadlock.go`,
orphan GC), collapsed to the single-service form: an in-process lock table
keyed by (table, row), shared/exclusive modes, and a wait-for graph
checked for cycles before every block — the waiter whose edge completes a
cycle aborts (`DeadlockError`), matching the reference's kill-the-latecomer
policy. Each row lock keeps a FIFO waiter queue (reference: per-lock
queues in lockservice/lock.go): a new request must not barge past earlier
waiters, so an exclusive waiter cannot starve under sustained shared
traffic; wait-for edges include earlier queued waiters, keeping deadlock
detection sound under queue ordering.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

SHARED = "shared"
EXCLUSIVE = "exclusive"


class DeadlockError(RuntimeError):
    pass


class LockTimeoutError(RuntimeError):
    pass


class _RowLock:
    __slots__ = ("owners", "mode", "waiters")

    def __init__(self):
        self.owners: Set[int] = set()
        self.mode: Optional[str] = None
        self.waiters: List[Tuple[int, str]] = []   # FIFO arrival order


class LockService:
    def __init__(self):
        self._locks: Dict[Tuple[str, int], _RowLock] = {}
        self._held: Dict[int, Set[Tuple[str, int]]] = defaultdict(set)
        #: waiter txn -> (key, mode) it is currently blocked on; wait-for
        #: edges are DERIVED fresh at cycle-check time (stored edge sets go
        #: stale the moment an owner releases, producing false deadlocks)
        self._waiting_on: Dict[int, Tuple[Tuple[str, int], str]] = {}
        self._cond = threading.Condition()

    # ------------------------------------------------------------- locking
    def lock(self, txn_id: int, table: str, rows, mode: str = EXCLUSIVE,
             timeout: float = 10.0) -> None:
        """Acquire locks on every row (all-or-block, row at a time in
        sorted order — ordered acquisition limits livelock)."""
        for row in sorted(int(r) for r in rows):
            self._lock_one(txn_id, (table, row), mode, timeout)

    def _compatible(self, lk: _RowLock, txn_id: int, mode: str) -> bool:
        if not lk.owners or lk.owners == {txn_id}:
            return True
        if mode == SHARED and lk.mode == SHARED:
            return True
        return False

    def _grantable(self, lk: _RowLock, txn_id: int, mode: str) -> bool:
        """Owner-compatible AND FIFO-fair: no barging past earlier waiters
        (two shared requests may be granted together)."""
        if lk.owners == {txn_id}:
            return True             # re-entrant / upgrade fast path
        if txn_id in lk.owners and mode == SHARED and lk.mode == SHARED:
            return True             # re-reading a shared hold must never
                                    # queue behind (or deadlock on) waiters
        if not self._compatible(lk, txn_id, mode):
            return False
        for t, m in lk.waiters:
            if t == txn_id:
                return True         # nothing ahead of us blocks
            if m == EXCLUSIVE or mode == EXCLUSIVE:
                return False        # would barge past an earlier waiter
        return True

    def _blockers(self, lk: _RowLock, txn_id: int, mode: str) -> Set[int]:
        out = set(lk.owners) - {txn_id}
        for t, m in lk.waiters:     # earlier waiters we queue behind
            if t == txn_id:
                break
            if m == EXCLUSIVE or mode == EXCLUSIVE:
                out.add(t)
        return out

    def _lock_one(self, txn_id: int, key, mode: str, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cond:
            lk = self._locks.setdefault(key, _RowLock())
            ticket = (txn_id, mode)
            lk.waiters.append(ticket)
            try:
                while not self._grantable(lk, txn_id, mode):
                    self._waiting_on[txn_id] = (key, mode)
                    if self._creates_cycle(txn_id):
                        raise DeadlockError(
                            f"txn {txn_id} would deadlock on {key}")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(
                            timeout=remaining):
                        raise LockTimeoutError(
                            f"txn {txn_id} timed out on {key}")
                    # lk object identity is stable: our queued ticket keeps
                    # it alive in _locks (unlock_all only deletes entries
                    # with no owners AND no waiters)
            except BaseException:   # noqa: BLE001 — waiter-ticket
                # cleanup (incl. KeyboardInterrupt): a leaked ticket
                # deadlocks every later acquirer; always re-raised
                try:
                    lk.waiters.remove(ticket)
                except ValueError:
                    pass
                self._waiting_on.pop(txn_id, None)
                if not lk.owners and not lk.waiters:
                    self._locks.pop(key, None)
                self._cond.notify_all()   # our slot freed: re-evaluate
                raise
            lk.waiters.remove(ticket)
            self._waiting_on.pop(txn_id, None)
            lk.owners.add(txn_id)
            if mode == EXCLUSIVE or lk.mode is None:
                lk.mode = mode      # never downgrades an EXCLUSIVE hold
            self._held[txn_id].add(key)
            self._cond.notify_all()   # shared co-grants may now proceed

    def _edges(self, txn: int) -> Set[int]:
        """Current blockers of a waiting txn, derived from live lock
        state (owners + earlier queued waiters)."""
        w = self._waiting_on.get(txn)
        if w is None:
            return set()
        key, mode = w
        lk = self._locks.get(key)
        if lk is None:
            return set()
        return self._blockers(lk, txn, mode)

    def _creates_cycle(self, start: int) -> bool:
        """DFS over the DERIVED wait-for graph from start back to start."""
        seen = set()
        stack = list(self._edges(start))
        while stack:
            t = stack.pop()
            if t == start:
                return True
            if t in seen:
                continue
            seen.add(t)
            stack.extend(self._edges(t))
        return False

    # ------------------------------------------------------------ release
    def unlock_all(self, txn_id: int) -> None:
        with self._cond:
            for key in self._held.pop(txn_id, set()):
                lk = self._locks.get(key)
                if lk is None:
                    continue
                lk.owners.discard(txn_id)
                if not lk.owners and not lk.waiters:
                    del self._locks[key]
            self._waiting_on.pop(txn_id, None)
            self._cond.notify_all()

    # ------------------------------------------------------------- status
    def held_by(self, txn_id: int) -> Set[Tuple[str, int]]:
        with self._cond:
            return set(self._held.get(txn_id, ()))

    def n_locks(self) -> int:
        with self._cond:
            return len(self._locks)
