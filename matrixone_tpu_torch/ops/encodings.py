"""Narrow column encodings: per-column storage and compute dtypes.

The port of `matrixone_tpu/ops/encodings.py`:

  * **dict codes** (lossless, bit-identical): int8 codes when the
    dictionary fits 128 entries, int16 under 32768, int32 otherwise,
    applied at the host->device boundary
    (vm/operators.chunk_to_execbatch) on every device, as the JAX
    package does on its TPU.  Codes hash, compare and gather alike at
    any width (ops/hash widens to int64 before mixing).
  * **bf16 float-agg lanes** (lossy, documented tolerance): FLOAT32
    aggregate input lanes of the fused dense grouped terminal
    (vm/fusion.py) round to bfloat16 before the always-f64
    accumulation: elements lose mantissa (bf16's 8 bits, about 2-3
    significant decimal digits, so a sum of same-signed elements stays
    within about 0.4%), sums keep their order.  FLOAT64 lanes,
    decimals and counts are never narrowed.

`MO_NARROW_ENCODINGS` is `auto` by default, which is on for the
accelerator (a CUDA tensor or session) and off on the CPU, as the JAX
package resolves it per backend; `1` forces the bf16 lanes on and `0`
off.  The resolved value rides the fragment cache key (`signature`).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flag() -> str:
    return os.environ.get("MO_NARROW_ENCODINGS", "auto").lower()


def enabled(device=None) -> bool:
    """The bf16 lane policy for work on `device` (a torch.device or
    its name; None is the CPU)."""
    v = _flag()
    if v in ("1", "on", "true"):
        return True
    if v in ("0", "off", "false", ""):
        return False
    return device is not None and torch.device(device).type == "cuda"


def signature(device=None) -> tuple:
    """Fragment-key component: the resolved policy.  The bf16 choice is
    made inside the step, invisible in the input dtypes."""
    return ("narrow", enabled(device))


def narrow_lane(val):
    """Round one float aggregate-input lane to bf16 (FLOAT32 only: f64
    and non-floats pass through).  The accumulation downstream stays
    f64, so only element precision narrows."""
    if val is not None and val.dtype == torch.float32 \
            and enabled(val.device):
        return val.to(torch.bfloat16)
    return val


def code_np_dtype(dict_len: int) -> np.dtype:
    """Narrowest signed int dtype holding codes 0..dict_len-1."""
    if dict_len <= (1 << 7):
        return np.dtype(np.int8)
    if dict_len <= (1 << 15):
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def narrow_codes(arr, dict_len: int):
    """Cast a code array to its narrowest width (never widens): a host
    array on the host, a tensor (the block cache's device tier) on its
    device."""
    cdt = code_np_dtype(dict_len)
    if isinstance(arr, torch.Tensor):
        tdt = {1: torch.int8, 2: torch.int16, 4: torch.int32}[cdt.itemsize]
        if arr.dtype == tdt or arr.element_size() < cdt.itemsize:
            return arr
        return arr.to(tdt)
    if arr.dtype == cdt or np.dtype(arr.dtype).itemsize < cdt.itemsize:
        return arr
    return arr.astype(cdt)
