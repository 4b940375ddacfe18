"""Per-query execution context (reference: pkg/vm/process/types.go:386
`Process` — the per-query bag of engine handle + txn + session state that
every operator receives).

The port of `matrixone_tpu/vm/process.py`, plus `device`, the torch
device every scan uploads its chunks to.  Outside a transaction a
statement reads the frontier frozen at its start; inside one it reads
the transaction's snapshot plus its workspace.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ExecContext:
    catalog: object                     # storage.engine.Engine
    txn: Optional[object] = None        # txn.client.TxnHandle
    variables: Optional[dict] = None
    #: committed_ts captured ONCE at statement start: every table in the
    #: statement reads the same frontier (no cross-table tearing)
    frozen_ts: Optional[int] = None
    #: where the operators run (a torch.device; None means CUDA, as
    #: resolve_device resolves it)
    device: Optional[object] = None

    def __post_init__(self):
        from matrixone_tpu_torch import resolve_device
        self.device = resolve_device(self.device)
        if self.txn is None and self.frozen_ts is None:
            self.frozen_ts = getattr(self.catalog, "committed_ts", None)

    @property
    def snapshot_ts(self) -> Optional[int]:
        if self.txn is not None:
            return self.txn.snapshot_ts
        return self.frozen_ts

    def table_read_args(self, table: str) -> dict:
        """kwargs for MVCCTable.iter_chunks realizing this context's view."""
        if self.txn is None:
            return ({"snapshot_ts": self.frozen_ts}
                    if self.frozen_ts is not None else {})
        w = self.txn.workspace.get(table)
        return {
            "snapshot_ts": self.txn.snapshot_ts,
            "extra_segments": list(w.segments) if w else None,
            "extra_deletes": w.all_deletes() if w else None,
        }
