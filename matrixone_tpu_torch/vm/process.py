"""Per-query execution context (reference: pkg/vm/process/types.go:386
`Process` — the per-query bag of engine handle + session state that every
operator receives).

The port of `matrixone_tpu/vm/process.py` without transactions (not
ported yet), plus `device`, the torch device every scan uploads its
chunks to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ExecContext:
    catalog: object                     # storage.engine.Engine
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
        if self.frozen_ts is None:
            self.frozen_ts = getattr(self.catalog, "committed_ts", None)

    def table_read_args(self, table: str) -> dict:
        """kwargs for MVCCTable.iter_chunks realizing this context's view."""
        return ({"snapshot_ts": self.frozen_ts}
                if self.frozen_ts is not None else {})
