"""64-bit hashing on the device.

The port of `matrixone_tpu/ops/hash.py`: the same splitmix64 finalizer,
`combine` and NULL sentinel, bit for bit.  PyTorch has no usable uint64,
so a hash is an int64 tensor holding the uint64 bit pattern: `+`, `*`,
`^`, `&` and `<<` wrap identically on those bits, while `>>` is
arithmetic and is masked back to a logical shift (`_shr`).
"""

from __future__ import annotations

import torch


def _s64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 holding its bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)
#: the hash every NULL key takes (SQL GROUP BY groups NULLs together)
NULL_HASH = _s64(0xDEADBEEFCAFEF00D)
#: -2^63: the sign bit
INT64_MIN = -(1 << 63)


def unsigned_order(h: torch.Tensor) -> torch.Tensor:
    """A key whose signed order is the unsigned order of the uint64 bit
    patterns in h (the sign bit flipped): what sorts and searches of
    hashes compare."""
    return h ^ INT64_MIN


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Finalizer of splitmix64 (public-domain PRNG) on int64 bit
    patterns."""
    x = x.to(torch.int64) + _GOLDEN
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def hash_column(data: torch.Tensor) -> torch.Tensor:
    """Hash one column's values to uint64 bits (floats hashed by bit
    pattern, f32 bits zero-extended; integers sign-extended to 64 bits
    first, so every integer width of one value hashes alike)."""
    if data.dtype == torch.float64:
        bits = data.view(torch.int64)
    elif data.dtype == torch.float32:
        bits = data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    else:
        bits = data.to(torch.int64)
    return splitmix64(bits)


def combine(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-dependent hash combine (boost::hash_combine shape)."""
    return splitmix64(h1 ^ (h2 + _GOLDEN + (h1 << 6) + _shr(h1, 2)))


def hash_columns(columns, validities=None) -> torch.Tensor:
    """Row hash over multiple key columns; NULLs hash to a fixed sentinel
    so `NULL` groups together (SQL GROUP BY treats NULLs as equal —
    reference: hashmap's hasNull handling)."""
    out = None
    for i, data in enumerate(columns):
        h = hash_column(data)
        if validities is not None and validities[i] is not None:
            h = torch.where(validities[i], h,
                            torch.full_like(h, NULL_HASH))
        out = h if out is None else combine(out, h)
    return out
