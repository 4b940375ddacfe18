"""Narrow dictionary codes: per-column storage dtype selection.

The port of the dict-code half of `matrixone_tpu/ops/encodings.py`,
with the policy the JAX package resolves on its TPU backend (on): int8
codes when the dictionary fits 128 entries, int16 under 32768, int32
otherwise.  Lossless and bit-identical — codes hash, compare and gather
alike at any width (ops/hash widens to int64 before mixing) — so it is
purely a bandwidth choice, applied at the host->device boundary
(vm/operators.chunk_to_execbatch).  The JAX package's bf16 float-lane
narrowing belongs to its fused fragments, which this port has not yet.
"""

from __future__ import annotations

import numpy as np


def code_np_dtype(dict_len: int) -> np.dtype:
    """Narrowest signed int dtype holding codes 0..dict_len-1."""
    if dict_len <= (1 << 7):
        return np.dtype(np.int8)
    if dict_len <= (1 << 15):
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def narrow_codes(arr: np.ndarray, dict_len: int) -> np.ndarray:
    """Cast a host code array to its narrowest width (never widens)."""
    cdt = code_np_dtype(dict_len)
    if arr.dtype == cdt or np.dtype(arr.dtype).itemsize < cdt.itemsize:
        return arr
    return arr.astype(cdt)
