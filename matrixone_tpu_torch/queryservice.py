"""Query service: the process list and query cancellation of one engine.

The port's copy of the part of `matrixone_tpu/queryservice.py` a
session needs (reference: `pkg/queryservice`, behind SHOW PROCESSLIST
and KILL).  Sessions of one engine share a ProcessRegistry keyed by
connection id; KILL flips a flag that the executor's pull loop checks
between device batches, so cancellation lands at batch granularity: a
replayed CUDA graph or a launched kernel is never interrupted.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class QueryKilled(RuntimeError):
    pass


def account_of(user: str) -> str:
    """Tenant account of a registered user label. Sessions register as
    "account:user" (frontend/session.py); bare labels are engine-internal
    (embed, tests) and belong to the sys tenant."""
    return user.split(":", 1)[0] if ":" in user else "sys"


class ProcessRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 1
        # conn_id -> record
        self._procs: Dict[int, dict] = {}

    def register(self, user: str = "root") -> int:
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._procs[cid] = {"id": cid, "user": user, "state": "idle",
                                "query": "", "started": 0.0,
                                "killed": False, "terminated": False}
            return cid

    def unregister(self, cid: int) -> None:
        with self._lock:
            self._procs.pop(cid, None)

    def start_query(self, cid: int, sql: str) -> None:
        with self._lock:
            rec = self._procs.get(cid)
            if rec is not None:
                rec.update(state="running", query=sql,
                           started=time.monotonic(), killed=False)

    def end_query(self, cid: int) -> None:
        with self._lock:
            rec = self._procs.get(cid)
            if rec is not None:
                rec.update(state="idle", query="", killed=False)

    def set_queued(self, cid: int, queued: bool) -> None:
        """Admission control (serving/admission.py) flips the visible
        state while a statement waits for a slot, so SHOW PROCESSLIST
        distinguishes queue time from execute time."""
        with self._lock:
            rec = self._procs.get(cid)
            if rec is not None and rec["state"] in ("running", "queued"):
                rec["state"] = "queued" if queued else "running"

    def kill(self, cid: int, query_only: bool = True) -> bool:
        """KILL QUERY interrupts the current statement; plain KILL (the
        MySQL connection form) additionally marks the connection
        terminated — every later statement on it fails until the owner
        closes it."""
        with self._lock:
            rec = self._procs.get(cid)
            if rec is None:
                return False
            rec["killed"] = True
            if not query_only:
                rec["terminated"] = True
            return True

    def check_killed(self, cid: int) -> None:
        with self._lock:
            rec = self._procs.get(cid)
            killed = rec is not None and (rec["killed"] or rec["terminated"])
        if killed:
            raise QueryKilled(f"query of connection {cid} was killed")

    def owner_account(self, cid: int) -> Optional[str]:
        """Tenant account owning a connection; None if no such conn."""
        with self._lock:
            rec = self._procs.get(cid)
            return None if rec is None else account_of(rec["user"])

    def is_terminated(self, cid: int) -> bool:
        with self._lock:
            rec = self._procs.get(cid)
            return rec is not None and rec["terminated"]

    def processlist(self):
        with self._lock:
            now = time.monotonic()
            return [{"Id": r["id"], "User": r["user"], "State": r["state"],
                     "Time": (round(now - r["started"], 3)
                              if r["state"] == "running" else 0.0),
                     "Query": r["query"]}
                    for r in sorted(self._procs.values(),
                                    key=lambda r: r["id"])]


def registry_for(engine) -> ProcessRegistry:
    reg = getattr(engine, "_queryservice", None)
    if reg is None:
        reg = ProcessRegistry()
        engine._queryservice = reg
    return reg
