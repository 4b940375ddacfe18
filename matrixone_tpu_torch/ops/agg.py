"""Group-by aggregation as sort/segment kernels — no hash tables.

The port of `matrixone_tpu/ops/agg.py` (its general path; the dense
small-key path `dense_lane_partials` waits for the TPC-H Q1 slice):

    row hash (ops.hash) -> stable argsort in unsigned order -> boundary
    detect -> cumsum group ids -> masked segment sum/min/max scatters

`max_groups` bounds the group table; when a batch has more groups the
caller re-runs with the next bucket.  Group ids, their order and the
representative rows are bit-identical to the JAX package's.  Sums over
integers and decimals are exact (int64); float32 sums go through the
hand-kernel seam (ops/kernels.py), where the call site asks for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from matrixone_tpu_torch.ops import hash as mohash
from matrixone_tpu_torch.ops import kernels as HK

#: the hash padding rows take: UINT64_MAX, so they sort last
_NULL_GROUP_SENTINEL = -1


class GroupIds(NamedTuple):
    gids: torch.Tensor        # int32 [n]: group id per row (garbage for padding rows)
    num_groups: torch.Tensor  # int32 scalar: number of distinct groups
    rep_rows: torch.Tensor    # int32 [max_groups]: a representative row per group


def _slots(gids: torch.Tensor, max_groups: int) -> torch.Tensor:
    """int64 scatter targets: the gid, or the drop slot `max_groups` for
    gids outside [0, max_groups) (XLA's segment ops drop out-of-range
    ids)."""
    g = gids.to(torch.int64)
    return torch.where((g >= 0) & (g < max_groups), g, max_groups)


def group_ids(key_columns: Sequence[torch.Tensor],
              key_validities: Sequence[Optional[torch.Tensor]],
              row_mask: torch.Tensor,
              max_groups: int) -> GroupIds:
    """Assign dense group ids to rows by their key tuple (by 64-bit row
    hash, as the reference does).  Padding rows (row_mask False) sort
    last and take no group id."""
    h = mohash.hash_columns(key_columns, key_validities)
    h = torch.where(row_mask, h, _NULL_GROUP_SENTINEL)
    order = torch.argsort(mohash.unsigned_order(h), stable=True)
    sorted_h = h[order]
    sorted_mask = row_mask[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=h.device),
                       sorted_h[1:] != sorted_h[:-1]])
    first = first & sorted_mask
    gid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    num_groups = torch.where(
        sorted_mask.any(),
        torch.where(sorted_mask, gid_sorted, -1).max() + 1, 0)
    # scatter group ids back to row order
    gids = torch.empty(h.shape[0], dtype=torch.int32, device=h.device)
    gids[order] = gid_sorted.to(torch.int32)
    # representative row for each group = first row (in sorted order)
    rep_target = torch.where(first & (gid_sorted < max_groups), gid_sorted,
                             max_groups)
    rep_rows = torch.zeros(max_groups + 1, dtype=torch.int32,
                           device=h.device)
    rep_rows.scatter_(0, rep_target, order.to(torch.int32))
    return GroupIds(gids=gids, num_groups=num_groups.to(torch.int32),
                    rep_rows=rep_rows[:max_groups])


def _masked(values: torch.Tensor, mask: torch.Tensor, fill) -> torch.Tensor:
    return torch.where(mask, values, torch.full_like(values, fill))


def seg_sum(values, gids, mask, max_groups: int, use_pallas: bool = False):
    """Masked segment sum, through the hand-kernel seam (ops/kernels.py):
    with `use_pallas` (what the JAX package's compile resolves on its
    TPU), float32 sums take the segment-sum kernel; exact int64/decimal
    and f64 sums always stay on the plain scatter."""
    return HK.grouped_scatter_add(values, gids, mask, max_groups,
                                  use_pallas=use_pallas)


def seg_count(gids, mask, max_groups: int):
    return HK.grouped_scatter_add(mask.to(torch.int64), gids, mask,
                                  max_groups)


def _reduce_fill(dtype, for_min: bool):
    """Identity element for min/max over dtype (BOOL included)."""
    if dtype == torch.bool:
        return True if for_min else False
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _seg_reduce(values, gids, mask, max_groups: int, for_min: bool):
    is_bool = values.dtype == torch.bool
    v = values.to(torch.int32) if is_bool else values
    v = _masked(v, mask, _reduce_fill(values.dtype, for_min))
    # an empty segment holds the identity of the reduced dtype, as
    # jax.ops.segment_min/max give it
    out = torch.full((max_groups + 1,), _reduce_fill(v.dtype, for_min),
                     dtype=v.dtype, device=v.device)
    out.scatter_reduce_(0, _slots(gids, max_groups), v,
                        "amin" if for_min else "amax", include_self=True)
    out = out[:max_groups]
    return out.to(torch.bool) if is_bool else out


def seg_min(values, gids, mask, max_groups: int):
    return _seg_reduce(values, gids, mask, max_groups, True)


def seg_max(values, gids, mask, max_groups: int):
    return _seg_reduce(values, gids, mask, max_groups, False)


def gather_keys(key_columns: Sequence[torch.Tensor],
                key_validities: Sequence[Optional[torch.Tensor]],
                rep_rows: torch.Tensor) -> Tuple[list, list]:
    """Materialize one key value per group from representative rows."""
    idx = rep_rows.to(torch.int64)
    out_vals, out_vals_valid = [], []
    for data, valid in zip(key_columns, key_validities):
        out_vals.append(data[idx])
        if valid is None:
            out_vals_valid.append(torch.ones(rep_rows.shape,
                                             dtype=torch.bool,
                                             device=rep_rows.device))
        else:
            out_vals_valid.append(valid[idx])
    return out_vals, out_vals_valid


# scalar (no GROUP BY) aggregates ------------------------------------------

def scalar_sum(values, mask):
    return _masked(values, mask, 0).sum()


def scalar_count(mask):
    return mask.to(torch.int64).sum()


def scalar_min(values, mask):
    is_bool = values.dtype == torch.bool
    v = values.to(torch.int32) if is_bool else values
    out = _masked(v, mask, _reduce_fill(v.dtype, True)).min()
    return out.to(torch.bool) if is_bool else out


def scalar_max(values, mask):
    is_bool = values.dtype == torch.bool
    v = values.to(torch.int32) if is_bool else values
    out = _masked(v, mask, _reduce_fill(v.dtype, False)).max()
    return out.to(torch.bool) if is_bool else out
