"""Sort and top-k (reference: pkg/sort, colexec/{order,top}).

The port of `matrixone_tpu/ops/sort.py`: the same row orders, ties and
NULL classes, bit for bit.  Multi-column ORDER BY is a sequence of
stable argsorts from the least-significant key to the most-significant;
integer/decimal keys sort in their native integer domain (descending via
bitwise-not); NULLs come first on ASC and last on DESC, applied as a
separate stable class-key pass.  Top-k is a stable descending sort of
the score, which picks the lowest index among equal scores, as
`jax.lax.top_k` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _is_int(dtype) -> bool:
    return not dtype.is_floating_point


def _value_key(data: torch.Tensor, descending: bool) -> torch.Tensor:
    """Order-preserving transform so ascending argsort realizes the order."""
    if _is_int(data.dtype):
        d = data.to(torch.int64) if data.dtype == torch.bool else data
        return ~d if descending else d
    key = data.to(torch.float64)
    return -key if descending else key


def _class_key(validity: Optional[torch.Tensor], descending: bool,
               row_mask: torch.Tensor) -> torch.Tensor:
    """0/1/2 class: nulls-first-or-last per MySQL, padding always last."""
    cls = torch.ones(row_mask.shape, dtype=torch.int32,
                     device=row_mask.device)
    if validity is not None:
        null_cls = 2 if descending else 0   # DESC: nulls after values
        cls = torch.where(validity, cls, null_cls)
    return torch.where(row_mask, cls, 3)


def sort_indices(columns: Sequence[torch.Tensor],
                 validities: Sequence[Optional[torch.Tensor]],
                 descendings: Sequence[bool],
                 row_mask: torch.Tensor) -> torch.Tensor:
    """Row permutation [n] int64 realizing a multi-column ORDER BY
    (stable)."""
    n = row_mask.shape[0]
    order = torch.arange(n, device=row_mask.device)
    # least-significant key first; stable sorts preserve prior order.
    # each key = value pass then null/padding class pass (both stable).
    for data, valid, desc in reversed(list(zip(columns, validities,
                                               descendings))):
        vkey = _value_key(data, desc)
        if valid is not None:
            # NULL lanes carry arbitrary underlying data; a constant key
            # keeps the value pass a no-op for them
            vkey = torch.where(valid, vkey, torch.zeros_like(vkey))
        perm = torch.argsort(vkey[order], stable=True)
        order = order[perm]
        ckey = _class_key(valid, desc, row_mask)[order]
        perm = torch.argsort(ckey, stable=True)
        order = order[perm]
    return order


def top_k_indices(key: torch.Tensor, validity: Optional[torch.Tensor],
                  descending: bool, row_mask: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k rows under ORDER BY key [DESC] LIMIT k.

    Returns (indices [k] int64, count) with count = min(k, n_real_rows).
    The key is transformed so that "comes first" == "largest", staying in
    the integer domain for int keys."""
    if _is_int(key.dtype):
        d = key.to(torch.int64) if key.dtype == torch.bool else key
        score = d if descending else ~d
        lo = torch.iinfo(score.dtype).min
        if validity is not None:
            # ASC: nulls first -> top priority; DESC: nulls last but ahead
            # of padding
            null_score = torch.iinfo(score.dtype).max if not descending \
                else lo + 1
            score = torch.where(validity, score, null_score)
        score = torch.where(row_mask, score, lo)
    else:
        keyf = key.to(torch.float64)
        score = keyf if descending else -keyf
        if validity is not None:
            null_score = (-torch.finfo(torch.float64).max if descending
                          else float("inf"))
            score = torch.where(validity, score, null_score)
        score = torch.where(row_mask, score, float("-inf"))
    idx = torch.sort(score, descending=True, stable=True).indices[:k]
    count = torch.clamp(row_mask.to(torch.int32).sum(), max=k)
    return idx, count
