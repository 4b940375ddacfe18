"""Transaction client: snapshot handle + write workspace.

Reference analogue: `pkg/txn/client` TxnOperator (operator.go:1098 Commit)
+ the CN-side workspace (`disttae/txn.go:89 WriteBatch`). A transaction
buffers inserts as uncommitted segments and deletes as row-id sets; reads
merge the workspace into the snapshot; commit hands everything to the
engine's single-writer pipeline.

The port's copy of `matrixone_tpu/txn/client.py`, the commit's
`txn.commit` trace span included.  A handle registers with the
engine's count of open transactions (`Engine.txn_opened` and
`txn_closed`), which defers merges: a workspace holds pre-merge row
ids.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List

import numpy as np

from matrixone_tpu_torch.storage.engine import Engine, Segment
from matrixone_tpu_torch.utils import motrace


class TxnState(enum.Enum):
    ACTIVE = 1
    COMMITTED = 2
    ABORTED = 3


@dataclasses.dataclass
class TableWorkspace:
    segments: List[Segment] = dataclasses.field(default_factory=list)
    delete_gids: List[np.ndarray] = dataclasses.field(default_factory=list)
    _next_local_gid: int = -2   # workspace rows get negative gids

    def all_deletes(self) -> np.ndarray:
        if not self.delete_gids:
            return np.zeros(0, np.int64)
        return np.concatenate(self.delete_gids)


_txn_counter = itertools.count(1)


class TxnHandle:
    def __init__(self, engine: Engine, snapshot_ts: int):
        self.engine = engine
        self.snapshot_ts = snapshot_ts
        self.state = TxnState.ACTIVE
        self.workspace: Dict[str, TableWorkspace] = {}
        self._txn_id = next(_txn_counter)   # never reused (id(self) can be)
        engine.txn_opened(self._txn_id)
        self._closed = False

    def _close(self):
        if not self._closed:
            self._closed = True
            self.engine.txn_closed(self._txn_id)

    def __del__(self):
        # orphan GC (reference: lockservice orphan-txn cleanup): an
        # abandoned ACTIVE handle must not pin its row locks forever
        try:
            if self.state == TxnState.ACTIVE:
                self.engine.locks.unlock_all(self._txn_id)
                self._close()
        except Exception:   # noqa: BLE001 — __del__ runs during GC /
            pass            # interpreter teardown; raising here aborts
                            # unrelated code and half-torn modules make
                            # any exception type possible

    def ws(self, table: str) -> TableWorkspace:
        return self.workspace.setdefault(table, TableWorkspace())

    # ------------------------------------------------------------ writes
    def write_batch(self, table: str, arrays, validity) -> int:
        t = self.engine.get_table(table)
        w = self.ws(table)
        n = len(next(iter(arrays.values())))
        seg = Segment(seg_id=-1, commit_ts=0, arrays=arrays,
                      validity=validity, n_rows=n,
                      base_gid=w._next_local_gid - n)
        w._next_local_gid -= n + 1
        w.segments.append(seg)
        return n

    def delete_rows(self, table: str, gids: np.ndarray) -> int:
        w = self.ws(table)
        committed = np.asarray(gids[gids >= 0], np.int64)
        if len(committed):
            w.delete_gids.append(committed)
        # deletes of rows inserted by this txn: drop from workspace segments
        local = gids[gids < 0]
        if len(local):
            for seg in w.segments:
                seg_gids = np.arange(seg.base_gid,
                                     seg.base_gid + seg.n_rows)
                keep = ~np.isin(seg_gids, local)
                if not keep.all():
                    seg.arrays = {c: a[keep] for c, a in seg.arrays.items()}
                    seg.validity = {c: v[keep]
                                    for c, v in seg.validity.items()}
                    seg.n_rows = int(keep.sum())
        return len(gids)

    # ------------------------------------------------------------ finish
    @property
    def txn_id(self) -> int:
        return self._txn_id

    def commit(self) -> int:
        assert self.state == TxnState.ACTIVE, "txn not active"
        inserts = {t: [(s.arrays, s.validity) for s in w.segments
                       if s.n_rows > 0]
                   for t, w in self.workspace.items() if w.segments}
        deletes = {t: w.all_deletes() for t, w in self.workspace.items()
                   if w.delete_gids}
        try:
            with motrace.span("txn.commit", tables=len(inserts)):
                affected = self.engine.commit_txn(self.snapshot_ts,
                                                  inserts, deletes)
        except Exception:   # noqa: BLE001 — abort/unlock cleanup for
            # ANY commit failure (conflict, constraint, transport,
            # injected fault); always re-raised
            self.state = TxnState.ABORTED
            self.engine.locks.unlock_all(self.txn_id)
            self._close()
            raise
        self.state = TxnState.COMMITTED
        self.engine.locks.unlock_all(self.txn_id)
        self._close()
        return affected

    def rollback(self) -> None:
        self.workspace.clear()
        self.state = TxnState.ABORTED
        self.engine.locks.unlock_all(self.txn_id)
        self._close()


class TxnClient:
    """reference: txn/client — hands out snapshot-stamped handles."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def begin(self) -> TxnHandle:
        # snapshot at the last fully-applied commit, not the raw clock: a
        # commit mid-apply must be entirely invisible (no torn reads)
        return TxnHandle(self.engine, self.engine.committed_ts)
