"""Group-by aggregation as sort/segment kernels — no hash tables.

The port of `matrixone_tpu/ops/agg.py`.  The general path:

    row hash (ops.hash) -> stable argsort in unsigned order -> boundary
    detect -> cumsum group ids -> masked segment sum/min/max scatters

`max_groups` bounds the group table; when a batch has more groups the
caller re-runs with the next bucket.  Group ids, their order and the
representative rows are bit-identical to the JAX package's.  Sums over
integers and decimals are exact (int64); float32 sums go through the
hand-kernel seam (ops/kernels.py), where the call site asks for it.

The dense small-key path (`dense_lane_partials`, the TPC-H Q1 shape)
takes the group id as a mixed-radix number over the key dictionaries
instead: no hash, no sort.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

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


def dense_slot_strides(sizes: Sequence[int], null_slots: bool = True
                       ) -> Tuple[Tuple[int, ...], int]:
    """Row-major strides over the dense key space. With null_slots each
    key contributes (size + 1) slots — the extra slot is its NULL group;
    without, exactly `size` slots (a chunk proven all-valid)."""
    strides = []
    acc = 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s + (1 if null_slots else 0)
    return tuple(reversed(strides)), acc


def dense_lane_partials(codes, valids, row_mask, int_vals, int_masks,
                        float_vals, float_masks, *, sizes, with_null):
    """Small-key grouped partials without hash or sort.

    When every group key is a dictionary code (or bool) the group id is
    a mixed-radix digit expansion over the key space.  The lanes of one
    dtype class stack into an (n, L) matrix (a lane's mask folds in as
    a zero, masked-out rows go to a spare slot).  The int64 lanes
    reduce in ONE `index_add_` into (G, L): integer adds are exact in
    any order.  The float64 lanes reduce per slot in an order fixed by
    the data (`_slot_sums`), so a launch on the card gives the same bits
    every time (`index_add_` adds with atomics there).  `rows` rides the int stack as one more lane that counts the
    row mask (a `bincount` would sync the host to size its output).

    Lanes: parallel (value, mask) tuples per dtype class. value None
    means "count the mask"; mask None means "row_mask only". Returns
    (int64 lanes [Li, G], float64 lanes [Lf, G], rows [G]) with G the
    compact (with_null=False) or NULL-slotted key space.
    """
    strides, G = dense_slot_strides(sizes, null_slots=with_null)
    n = row_mask.shape[0]
    dev = row_mask.device
    gid = torch.zeros((n,), dtype=torch.int64, device=dev)
    for c, v, s, st in zip(codes, valids, sizes, strides):
        # int8/int16 dictionary codes widen before they index
        slot = torch.clamp(c.to(torch.int64), 0, s - 1)
        if with_null:
            slot = torch.where(v, slot, s)
        gid = gid + slot * st
    gid = torch.where(row_mask, gid, G)        # the spare slot

    def lane_sums(vals, masks, dtype) -> torch.Tensor:
        if not vals:
            return torch.zeros((0, G), dtype=dtype, device=dev)
        cols: List[torch.Tensor] = []
        for v, m in zip(vals, masks):
            x = (torch.ones((n,), dtype=dtype, device=dev) if v is None
                 else v.to(dtype).expand(n))
            if m is not None:
                x = torch.where(m, x, torch.zeros((), dtype=dtype,
                                                  device=dev))
            cols.append(x)
        if dtype.is_floating_point:
            return _slot_sums(torch.stack(cols), gid, G)
        out = torch.zeros((G + 1, len(cols)), dtype=dtype, device=dev)
        out.index_add_(0, gid, torch.stack(cols, dim=1))
        return out[:G].T

    ints = lane_sums(list(int_vals) + [None], list(int_masks) + [None],
                     torch.int64)
    floats = lane_sums(float_vals, float_masks, torch.float64)
    return ints[:-1], floats, ints[-1]


#: rows a block sum of the sorted f64 lanes covers
_SUM_BLOCK = 1024


def _slot_sums(x: torch.Tensor, gid: torch.Tensor, G: int) -> torch.Tensor:
    """(L, G) sums of x's (L, n) lanes by slot gid in [0, G], slot G
    dropped, in an order fixed by the data alone.  The rows are sorted
    stably by slot, so slot g holds rows [lo, hi); each slot sums its
    head (lo up to the next multiple of `_SUM_BLOCK`), the sums of the
    whole blocks inside its rows, and its tail, in that order, each as a
    masked `sum` along a contiguous dimension.  No atomics, so the bits
    are the same on every launch; a masked-out value is never added, so
    a NaN or inf stays in its own slot, as in the reference's masked
    sums; no host sync, so a CUDA graph captures it.  Cost O(n L + G L
    n / _SUM_BLOCK), whatever the order of the rows."""
    L, n = x.shape
    dev = x.device
    if n == 0:
        return torch.zeros((L, G), dtype=x.dtype, device=dev)
    B = _SUM_BLOCK
    key = gid.to(torch.int16 if G < (1 << 15) else torch.int32)
    sorted_gid, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        sorted_gid, torch.arange(G + 1, dtype=key.dtype, device=dev))
    lo, hi = bounds[:-1], bounds[1:]
    xs = x[:, order]
    nb = n // B
    blocks = xs[:, :nb * B].view(L, nb, B).sum(-1)             # (L, nb)
    first, last = (lo + B - 1) // B, hi // B    # whole blocks [first, last)
    b = torch.arange(nb, device=dev)
    inside = (b >= first[:, None]) & (b < last[:, None])        # (G, nb)
    whole = torch.where(inside, blocks[:, None, :], 0).sum(-1)
    head_end = torch.minimum(first * B, hi)
    tail_start = torch.maximum(last * B, head_end)
    step = torch.arange(B, device=dev)

    def rows(start, end):                  # rows [start, end) of a block
        idx = start[:, None] + step                             # (G, B)
        vals = xs[:, torch.clamp(idx, max=n - 1)]               # (L, G, B)
        return torch.where(idx < end[:, None], vals, 0).sum(-1)
    return rows(lo, head_end) + whole + rows(tail_start, hi)


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
