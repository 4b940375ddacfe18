"""Background compaction / checkpoint / GC scheduler.

The port's copy of `matrixone_tpu/storage/merge_sched.py` (reference
analogue: tae/db/merge and tae/db/checkpoint runners behind the
taskservice).  One MergeScheduler per engine picks work each cycle:

  * small-segment compaction: a table whose live segment count reached
    `min_segments` is rewritten into one segment (per partition)
    by Engine.merge_table's capture -> rewrite without the lock -> brief
    swap, so foreground commits are never wedged;
  * tombstone-ratio rewrite: a table whose dead/live row ratio passed
    `tombstone_ratio` is compacted even below the segment floor;
  * object GC: Engine.gc_fences releases the merge fences no named
    snapshot or registered watermark can reach, then deletes their
    unreferenced objects (the fence-free manifest durable first);
  * checkpoints: after any cycle that merged or released, and at least
    every `ckpt_cycles` idle cycles.

A cycle defers whole while explicit transactions are open (their
workspaces hold pre-merge gids), deferred or raced merges (-2/-3) retry
next cycle, and a FAILING merge retries with jittered exponential
backoff (`backoff_delay`, a copy of the reference's `cluster/rpc.py`
one) without poisoning the engine; every outcome counts in
mo_merge_tasks_total.

`scheduler_for(engine)` returns the per-engine scheduler (not started);
`maybe_start(engine)` starts its thread when MO_MERGE_SCHED=1.
`mo_ctl('merge', ...)` drives it from SQL (`frontend/session.py`); the
taskservice executor is not ported (ROADMAP.md, section A, step 5).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from matrixone_tpu_torch.utils import metrics as M

#: attempts beyond which a failing table's backoff stops growing
_MAX_BACKOFF_ATTEMPTS = 8


#: the merge's backoff curve (the reference's RPC retry defaults)
BACKOFF_BASE = 0.02
BACKOFF_MAX = 1.0
#: policy defaults; tests and callers set a scheduler's attributes
INTERVAL_S = 0.5
MIN_SEGMENTS = 4
TOMBSTONE_RATIO = 0.2
CKPT_CYCLES = 8


def backoff_delay(attempt: int) -> float:
    """Exponential backoff with full jitter: attempt 1 -> ~BASE,
    doubling, capped at BACKOFF_MAX (a copy of
    `matrixone_tpu/cluster/rpc.py:backoff_delay`)."""
    d = min(BACKOFF_MAX, BACKOFF_BASE * (2 ** max(0, attempt - 1)))
    return d * (0.5 + random.random())


class MergeScheduler:
    """Policy-driven background merge/checkpoint/GC loop for one engine.

    Thread-light: all state behind one small lock; the storage work runs
    through Engine.merge_table / gc_fences / checkpoint, which carry
    their own locking, so run_cycle is safe to call from the loop thread
    or a caller alike (the engine's merge lock serializes them)."""

    def __init__(self, engine, interval_s: Optional[float] = None):
        self.engine = engine
        self.interval_s = INTERVAL_S if interval_s is None else interval_s
        self.min_segments = MIN_SEGMENTS
        self.tombstone_ratio = TOMBSTONE_RATIO
        self.ckpt_cycles = CKPT_CYCLES
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._paused = False
        self.cycles = 0
        self._cycles_since_ckpt = 0
        #: per-table consecutive merge FAILURES (exceptions, not defers)
        self._fails: Dict[str, int] = {}
        #: per-table earliest retry (monotonic clock) after a failure
        self._next_try: Dict[str, float] = {}
        self._last_errors: Dict[str, str] = {}
        self.last_cycle: dict = {}

    # ------------------------------------------------------------ policy
    def candidates(self) -> List[dict]:
        """Tables the policy wants compacted this cycle, with reasons.
        Reads table shapes without the commit lock — counts may be a
        commit stale, which only mis-times (never mis-applies) a merge."""
        out = []
        for name in list(self.engine.tables):
            t = self.engine.tables.get(name)
            if t is None or name.startswith("system_") \
                    or getattr(t, "is_external", False):
                continue
            n_segs = len(t.segments)
            if n_segs < 2:
                continue
            dead = sum(len(g) for _, g in t.tombstones)
            total = sum(s.n_rows for s in t.segments)
            ratio = dead / total if total else 0.0
            if n_segs >= self.min_segments:
                out.append({"table": name, "reason": "segments",
                            "segments": n_segs, "dead_ratio": ratio})
            elif dead and ratio >= self.tombstone_ratio:
                out.append({"table": name, "reason": "tombstones",
                            "segments": n_segs, "dead_ratio": ratio})
        return out

    # ------------------------------------------------------------- cycle
    def run_cycle(self) -> dict:
        """One scheduler pass: pick -> merge -> fence GC -> checkpoint.
        Never raises — every failure is isolated into the summary and
        the metrics, and a failing table backs off exponentially."""
        summary = {"merged": [], "deferred": [], "skipped": [],
                   "failed": [], "gc": None, "checkpoint": False}
        eng = self.engine
        if eng.active_txns > 0:
            # admission pacing: open txn workspaces hold pre-merge gids;
            # merge_table would defer each table anyway — defer the
            # whole cycle cheaply and retry next tick
            M.merge_tasks.inc(kind="compact", outcome="deferred")
            summary["deferred"].append("*active-txns*")
            self._finish_cycle(summary)
            return summary
        now = time.monotonic()
        for cand in self.candidates():
            name = cand["table"]
            if self._next_try.get(name, 0.0) > now:
                summary["skipped"].append(name)   # still backing off
                continue
            try:
                kept = eng.merge_table(name, min_segments=2,
                                       checkpoint=False)
            except Exception as e:   # noqa: BLE001 — task isolation: a
                # broken merge must never poison the engine or the loop;
                # it retries with jittered exponential backoff
                fails = self._fails.get(name, 0) + 1
                self._fails[name] = fails
                self._next_try[name] = now + backoff_delay(
                    min(fails, _MAX_BACKOFF_ATTEMPTS))
                self._last_errors[name] = f"{type(e).__name__}: {e}"[:256]
                M.merge_tasks.inc(kind="compact", outcome="failed")
                summary["failed"].append(
                    {"table": name, "error": self._last_errors[name],
                     "attempt": fails})
                continue
            if kept >= 0:
                self._fails.pop(name, None)
                self._next_try.pop(name, None)
                self._last_errors.pop(name, None)
                M.merge_tasks.inc(kind="compact", outcome="ok")
                summary["merged"].append(
                    {"table": name, "kept": kept,
                     "reason": cand["reason"]})
            elif kept == -1:
                M.merge_tasks.inc(kind="compact", outcome="noop")
                summary["skipped"].append(name)
            else:
                # -2 open txns / -3 lost a race with a concurrent
                # delete: foreground won; retry next cycle (no backoff —
                # defers are the pacing working as designed)
                M.merge_tasks.inc(kind="compact", outcome="deferred")
                summary["deferred"].append(name)
        try:
            summary["gc"] = eng.gc_fences()
            M.merge_tasks.inc(kind="gc", outcome="ok")
        except Exception as e:   # noqa: BLE001 — same isolation rung as
            # the merge leg: a GC fault surfaces in metrics + status
            M.merge_tasks.inc(kind="gc", outcome="failed")
            summary["gc"] = {"error": f"{type(e).__name__}: {e}"[:256]}
        self._finish_cycle(summary)
        return summary

    def _finish_cycle(self, summary: dict) -> None:
        with self._lock:
            self.cycles += 1
            self._cycles_since_ckpt += 1
            need_ckpt = bool(summary["merged"]) or \
                (summary.get("gc") or {}).get("released", 0) > 0 or \
                self._cycles_since_ckpt >= max(1, self.ckpt_cycles)
        if need_ckpt:
            try:
                self.engine.checkpoint()
                M.merge_tasks.inc(kind="checkpoint", outcome="ok")
                summary["checkpoint"] = True
                with self._lock:
                    self._cycles_since_ckpt = 0
            except Exception as e:   # noqa: BLE001 — isolated like the
                # merge leg; the WAL keeps everything durable meanwhile
                M.merge_tasks.inc(kind="checkpoint", outcome="failed")
                summary["checkpoint"] = f"{type(e).__name__}: {e}"[:256]
        with self._lock:
            self.last_cycle = summary

    # ------------------------------------------------------------ thread
    def start(self) -> "MergeScheduler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mo-merge-sched", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=5)

    def pause(self) -> None:
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                paused = self._paused
            if not paused:
                self.run_cycle()   # never raises (failure isolation)
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------ status
    def status(self) -> dict:
        with self._lock:
            st = {
                "running": self._thread is not None,
                "paused": self._paused,
                "cycles": self.cycles,
                "interval_ms": int(self.interval_s * 1000),
                "min_segments": self.min_segments,
                "tombstone_ratio": self.tombstone_ratio,
                "ckpt_cycles": self.ckpt_cycles,
                "backoff": {n: round(t - time.monotonic(), 3)
                            for n, t in self._next_try.items()
                            if t > time.monotonic()},
                "fails": dict(self._fails),
                "last_errors": dict(self._last_errors),
                "last_cycle": dict(self.last_cycle),
            }
        st["fences"] = {
            name: {"count": len(t.fences), "delta_floor": t.delta_floor,
                   "oldest_merge_ts": t.fences[0].merge_ts}
            for name, t in self.engine.tables.items()
            if getattr(t, "fences", None)}
        st["candidates"] = self.candidates()
        return st


# --------------------------------------------------- per-engine singleton
_LOCK = threading.Lock()


def scheduler_for(engine) -> MergeScheduler:
    """One scheduler per engine, created idle: callers start() the loop
    thread or drive run_cycle() themselves."""
    host = engine
    sched = getattr(host, "_merge_scheduler", None)
    if sched is None:
        with _LOCK:
            sched = getattr(host, "_merge_scheduler", None)
            if sched is None:
                sched = MergeScheduler(host)
                host._merge_scheduler = sched
    return sched


def maybe_start(engine) -> Optional[MergeScheduler]:
    """Start the background loop iff MO_MERGE_SCHED=1 (embedded/server
    startup hook — tests and default sessions stay thread-free)."""
    if os.environ.get("MO_MERGE_SCHED") != "1":
        return None
    return scheduler_for(engine).start()
