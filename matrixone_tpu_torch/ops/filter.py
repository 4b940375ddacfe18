"""Selection / compaction (reference: colexec/filter + Vector.Shrink).

The port of `matrixone_tpu/ops/filter.py`.  Filters produce a *mask*,
not a compacted batch — downstream operators consume masks directly.
`compact()` gathers the live rows to the front of a fixed capacity, as
`jnp.nonzero(size=capacity, fill_value=0)` does, without a host sync.
"""

from __future__ import annotations

import torch

from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn


def predicate_mask(pred: DeviceColumn, batch: DeviceBatch) -> torch.Tensor:
    """bool mask of rows passing a predicate column (NULL -> excluded).

    Deliberately does NOT fold in batch.row_mask(): the pipeline's
    ExecBatch.mask tracks live rows (which are non-contiguous after joins);
    callers AND this mask into it."""
    data = pred.data
    valid = pred.validity
    if pred.is_const:
        n = batch.padded_len
        data = data.expand(n)
        valid = valid.expand(n)
    return data & valid


def _nonzero_fixed(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The positions of the first `capacity` true entries of mask, in
    order, padded with 0 to [capacity] (int64).  Rows past the capacity
    and false rows scatter into one extra slot that is dropped."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    target = torch.where(mask & (pos < capacity), pos, capacity)
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, target, torch.arange(mask.shape[0], device=mask.device))
    return idx[:capacity]


def compact(batch: DeviceBatch, mask: torch.Tensor,
            capacity: int) -> DeviceBatch:
    """Gather masked rows to the front; result padded to `capacity` rows."""
    idx = _nonzero_fixed(mask, capacity)
    n_out = mask.to(torch.int32).sum().to(torch.int32)
    keep = torch.arange(capacity, dtype=torch.int32,
                        device=mask.device) < n_out
    out_cols = {}
    for name, col in batch.columns.items():
        if col.is_const:
            out_cols[name] = col
            continue
        out_cols[name] = DeviceColumn(
            data=col.data[idx],
            validity=col.validity[idx] & keep,
            dtype=col.dtype)
    return DeviceBatch(columns=out_cols, n_rows=n_out)


def gather(batch: DeviceBatch, indices: torch.Tensor,
           n_rows: torch.Tensor) -> DeviceBatch:
    """Row gather (ORDER BY / top-k materialization)."""
    out_cols = {}
    idx = indices.to(torch.int64)
    keep = torch.arange(indices.shape[0], dtype=torch.int32,
                        device=indices.device) < n_rows
    for name, col in batch.columns.items():
        if col.is_const:
            out_cols[name] = col
            continue
        out_cols[name] = DeviceColumn(
            data=col.data[idx],
            validity=col.validity[idx] & keep,
            dtype=col.dtype)
    return DeviceBatch(columns=out_cols, n_rows=n_rows.to(torch.int32))
