"""Top-k selection with the JAX package's tie order."""

from __future__ import annotations

from typing import Tuple

import torch


def topk_smallest(scores: torch.Tensor, k: int,
                  dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries along `dim`, ascending, ties in index
    order: what `jax.lax.top_k(-scores, k)` returns, positions
    included.  Where equal scores straddle the k-th value, JAX keeps the
    lowest positions among them; `torch.topk` keeps any.  So the scores
    take one stable sort and its first k.  A NaN ranks after +inf and
    -0.0 ties with +0.0, whatever their sign bits: XLA ranks by IEEE
    total order, which puts a NaN whose sign is set first and -0.0
    before +0.0, but the sign of a NaN or a zero that arithmetic makes
    differs between x86 and CUDA, and the CPU's sort compares values
    where the card's radix sort ranks bits.  Adding 0.0 turns -0.0 into
    +0.0, and on the card any NaN into the canonical one, so both rank
    alike.  No host sync: a captured step may call it.  Positions are
    int64."""
    if scores.is_floating_point():
        scores = scores + 0.0
    vals, pos = torch.sort(scores, dim=dim, stable=True)
    return (vals.narrow(dim, 0, k).contiguous(),
            pos.narrow(dim, 0, k).contiguous())
