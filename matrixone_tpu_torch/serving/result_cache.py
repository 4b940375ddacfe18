"""Snapshot-consistent result cache.

The port's copy of `matrixone_tpu/serving/result_cache.py`.
Correctness comes from MVCC, not from TTLs:

  * an entry is keyed on (tenant scope, statement template, parameter
    values) and pins the per-table version of every table the plan
    scanned, `(last_commit_ts, n_segments, n_tombstone_batches)`, plus
    the engine's ddl_gen.  Every commit, merge and restore touching a
    referenced table moves its version (storage/engine.py
    apply_segment / apply_tombstones / merge_table), so the next lookup
    sees a mismatch, drops the entry and executes against the fresh
    frontier.
  * `AS OF SNAPSHOT/TIMESTAMP` scans read an immutable past: their
    version component is the as-of timestamp, so those entries live
    until evicted.
  * versions and the execution snapshot are captured in one hold of
    the engine's commit lock (frontend/session.py _capture_versions).
  * the cached batch is the host copy of the result (`from_device`
    copies every column off the card), never a view of a CUDA graph's
    output buffers, which the graph's next replay overwrites.

Bypass (the caller enforces, see frontend/session.py): statements with
non-deterministic functions, in-transaction reads and multi-statement
texts.  `MO_RESULT_CACHE_MB` bounds the cache in bytes (LRU; 0, the
default, disables it; `mo_ctl('serving','result:on')` turns it on);
the budget counts the host result's column bytes.
`MO_RESULT_CACHE=0` force-disables.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


def batch_nbytes(batch) -> int:
    """Approximate host footprint of a result Batch: its columns' bytes
    (numpy arrays or host tensors, `nbytes` either way) and dictionary
    strings."""
    total = 0
    for name in batch.columns:
        v = batch.columns[name]
        data = getattr(v, "data", None)
        total += int(getattr(data, "nbytes", 64))
        for s in getattr(v, "dict", None) or []:
            total += len(s) if isinstance(s, str) else 8
    return total + 256


class _Entry:
    __slots__ = ("batch", "versions", "nbytes")

    def __init__(self, batch, versions, nbytes):
        self.batch = batch
        self.versions = versions
        self.nbytes = nbytes


class ResultCache:
    """LRU over result batches, bounded by bytes."""

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def get(self, key: tuple, current_versions) -> Optional[tuple]:
        """current_versions: stored_versions -> versions tuple recomputed
        by the caller against the live catalog.  Returns (batch,
        stored_versions) — the versions carry the scanned table names so
        the caller can re-run privilege checks — or None."""
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
        if e is None:
            M.result_cache_ops.inc(outcome="miss")
            return None
        now = current_versions(e.versions)
        if now != e.versions:
            with self._lock:
                # evict only if OUR stale entry is still resident — a
                # concurrent put() may have replaced it with a fresh one
                # while we recomputed versions outside the lock, and
                # popping that would both drop a live result and subtract
                # the wrong nbytes from the budget
                if self._entries.get(key) is e:
                    self._entries.pop(key)
                    self._bytes -= e.nbytes
                M.result_cache_entries.set(len(self._entries))
                M.result_cache_bytes.set(self._bytes)
            M.result_cache_ops.inc(outcome="stale")
            return None
        M.result_cache_ops.inc(outcome="hit")
        return e.batch, e.versions

    def put(self, key: tuple, batch, versions) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        nb = batch_nbytes(batch)
        if nb > self.max_bytes // 4 or nb > self.max_bytes:
            return                      # one giant result must not wipe
        with self._lock:                # the whole working set
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(batch, versions, nb)
            self._bytes += nb
            while self._bytes > self.max_bytes and self._entries:
                _, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                M.result_cache_evictions.inc()
            M.result_cache_entries.set(len(self._entries))
            M.result_cache_bytes.set(self._bytes)

    def set_max_bytes(self, nb: int) -> None:
        """Resize the budget; shrinking evicts immediately (a read-hot
        workload may never call put(), so the put()-side loop alone
        would hold the old budget's memory indefinitely)."""
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            self.max_bytes = nb
            while self._bytes > self.max_bytes and self._entries:
                _, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                M.result_cache_evictions.inc()
            M.result_cache_entries.set(len(self._entries))
            M.result_cache_bytes.set(self._bytes)

    def clear(self) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            M.result_cache_entries.set(0)
            M.result_cache_bytes.set(0)

    def stats(self) -> dict:
        from matrixone_tpu_torch.utils import metrics as M
        hits = M.result_cache_ops.get(outcome="hit")
        misses = (M.result_cache_ops.get(outcome="miss")
                  + M.result_cache_ops.get(outcome="stale"))
        with self._lock:
            n, b = len(self._entries), self._bytes
        return {"entries": n, "bytes": b, "max_bytes": self.max_bytes,
                "hits": int(hits), "misses": int(misses),
                "stale": int(M.result_cache_ops.get(outcome="stale")),
                "evictions": int(M.result_cache_evictions.get()),
                "hit_rate": (hits / (hits + misses)
                             if hits + misses else 0.0),
                "enabled": self.enabled}
