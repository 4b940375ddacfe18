"""SQL type system for device-resident columnar data.

The port's copy of `matrixone_tpu/container/dtypes.py`: each fixed-width
type maps to a torch dtype (`torch_dtype`) beside its numpy dtype.

Re-designs the reference's type oids (`pkg/container/types/types.go`) for a
TPU target: every type is either
  * fixed-width and device-native (maps to a torch dtype), or
  * variable-length (VARCHAR/CHAR/TEXT/BLOB), kept host-side as Arrow arrays
    and shipped to device only as dictionary codes (int32) — TPUs cannot
    pointer-chase a varlena `area` (reference: container/vector/vector.go:43),
    so dictionary/offset encoding is the device representation.

DECIMAL is a scaled int64 (DECIMAL64) or scaled int128-as-two-int64
(not yet implemented). Reference: pkg/container/types/decimal.go. Exact
integer arithmetic keeps TPC-H money sums bit-identical to the CPU oracle —
float reduction order issues do not arise.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeOid(enum.IntEnum):
    BOOL = 10
    INT8 = 20
    INT16 = 21
    INT32 = 22
    INT64 = 23
    UINT8 = 24
    UINT16 = 25
    UINT32 = 26
    UINT64 = 27
    FLOAT32 = 30
    FLOAT64 = 31
    DECIMAL64 = 32
    DATE = 40        # days since unix epoch, int32
    DATETIME = 41    # microseconds since unix epoch, int64
    TIMESTAMP = 42   # microseconds since unix epoch (UTC), int64
    VARCHAR = 50
    CHAR = 51
    TEXT = 52
    BLOB = 53
    JSON = 54
    VECF32 = 60      # fixed-dim float32 embedding (reference: types.T_array_float32)
    VECF64 = 61


_FIXED_NP = {
    TypeOid.BOOL: np.bool_,
    TypeOid.INT8: np.int8,
    TypeOid.INT16: np.int16,
    TypeOid.INT32: np.int32,
    TypeOid.INT64: np.int64,
    TypeOid.UINT8: np.uint8,
    TypeOid.UINT16: np.uint16,
    TypeOid.UINT32: np.uint32,
    TypeOid.UINT64: np.uint64,
    TypeOid.FLOAT32: np.float32,
    TypeOid.FLOAT64: np.float64,
    TypeOid.DECIMAL64: np.int64,
    TypeOid.DATE: np.int32,
    TypeOid.DATETIME: np.int64,
    TypeOid.TIMESTAMP: np.int64,
    TypeOid.VECF32: np.float32,
    TypeOid.VECF64: np.float64,
}

_VARLEN = {TypeOid.VARCHAR, TypeOid.CHAR, TypeOid.TEXT, TypeOid.BLOB, TypeOid.JSON}
_INTS = {TypeOid.INT8, TypeOid.INT16, TypeOid.INT32, TypeOid.INT64,
         TypeOid.UINT8, TypeOid.UINT16, TypeOid.UINT32, TypeOid.UINT64}
_FLOATS = {TypeOid.FLOAT32, TypeOid.FLOAT64}


@dataclasses.dataclass(frozen=True)
class DType:
    """A SQL column type: oid + (width | scale | dim) modifiers."""

    oid: TypeOid
    width: int = 0      # display width / max length for VARCHAR(n)
    scale: int = 0      # decimal scale: stored value = real * 10**scale
    dim: int = 0        # embedding dimension for VECF32/VECF64

    @property
    def is_varlen(self) -> bool:
        return self.oid in _VARLEN

    @property
    def is_numeric(self) -> bool:
        return self.oid in _INTS or self.oid in _FLOATS or self.oid == TypeOid.DECIMAL64

    @property
    def is_integer(self) -> bool:
        return self.oid in _INTS

    @property
    def is_float(self) -> bool:
        return self.oid in _FLOATS

    @property
    def is_vector(self) -> bool:
        return self.oid in (TypeOid.VECF32, TypeOid.VECF64)

    @property
    def np_dtype(self) -> np.dtype:
        if self.is_varlen:
            raise TypeError(f"{self} has no fixed-width numpy dtype")
        return np.dtype(_FIXED_NP[self.oid])

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype_of(self.np_dtype)

    def __str__(self) -> str:
        sql_names = {TypeOid.INT8: "tinyint", TypeOid.INT16: "smallint",
                     TypeOid.INT32: "int", TypeOid.INT64: "bigint",
                     TypeOid.FLOAT32: "float", TypeOid.FLOAT64: "double"}
        n = sql_names.get(self.oid, self.oid.name.lower())
        if self.oid == TypeOid.DECIMAL64:
            return f"decimal({self.width or 18},{self.scale})"
        if self.oid == TypeOid.VARCHAR and self.width:
            return f"varchar({self.width})"
        if self.is_vector and self.dim:
            return f"{n}({self.dim})"
        return n


_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype_of(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (one map for the whole port)."""
    return _NP_TO_TORCH[np.dtype(np_dtype)]


# Shorthand constructors (match reference's types.New(...) helpers).
BOOL = DType(TypeOid.BOOL)
INT8 = DType(TypeOid.INT8)
INT16 = DType(TypeOid.INT16)
INT32 = DType(TypeOid.INT32)
INT64 = DType(TypeOid.INT64)
UINT8 = DType(TypeOid.UINT8)
UINT16 = DType(TypeOid.UINT16)
UINT32 = DType(TypeOid.UINT32)
UINT64 = DType(TypeOid.UINT64)
FLOAT32 = DType(TypeOid.FLOAT32)
FLOAT64 = DType(TypeOid.FLOAT64)
DATE = DType(TypeOid.DATE)
DATETIME = DType(TypeOid.DATETIME)
TIMESTAMP = DType(TypeOid.TIMESTAMP)
VARCHAR = DType(TypeOid.VARCHAR, width=65535)
CHAR = DType(TypeOid.CHAR, width=255)
TEXT = DType(TypeOid.TEXT)


def decimal64(precision: int = 18, scale: int = 2) -> DType:
    return DType(TypeOid.DECIMAL64, width=precision, scale=scale)


def varchar(n: int = 65535) -> DType:
    return DType(TypeOid.VARCHAR, width=n)


def vecf32(dim: int) -> DType:
    return DType(TypeOid.VECF32, dim=dim)


def vecf64(dim: int) -> DType:
    return DType(TypeOid.VECF64, dim=dim)


#: numeric promotion lattice for binary ops (reference:
#: pkg/sql/plan/function overload resolution — simplified).
_RANK = [TypeOid.BOOL, TypeOid.INT8, TypeOid.UINT8, TypeOid.INT16, TypeOid.UINT16,
         TypeOid.INT32, TypeOid.UINT32, TypeOid.INT64, TypeOid.UINT64,
         TypeOid.DECIMAL64, TypeOid.FLOAT32, TypeOid.FLOAT64]


def promote(a: DType, b: DType) -> DType:
    """Result type of a numeric binary op."""
    if a.oid == b.oid:
        if a.oid == TypeOid.DECIMAL64:
            return a if a.scale >= b.scale else b
        return a
    ra, rb = _RANK.index(a.oid), _RANK.index(b.oid)
    hi = a if ra >= rb else b
    if TypeOid.DECIMAL64 in (a.oid, b.oid) and hi.oid != TypeOid.DECIMAL64:
        return FLOAT64  # decimal + float -> float64
    return hi


# ---------------------------------------------------------------- epochs
# ONE conversion for date/datetime <-> epoch integers (binder literal
# coercion, INSERT coercion, and clock functions all share it; exact
# integer arithmetic — float total_seconds() truncates ~1% of
# microsecond values by 1us)
import datetime as _dtm

_EPOCH_D = _dtm.date(1970, 1, 1)
_EPOCH_DT = _dtm.datetime(1970, 1, 1)
_US = _dtm.timedelta(microseconds=1)


def epoch_days(d: "_dtm.date") -> int:
    return (d - _EPOCH_D).days


def epoch_micros(dtv: "_dtm.datetime") -> int:
    return (dtv - _EPOCH_DT) // _US


def epoch_days_from_iso(s: str) -> int:
    return epoch_days(_dtm.date.fromisoformat(s.strip()))


def epoch_micros_from_iso(s: str) -> int:
    return epoch_micros(_dtm.datetime.fromisoformat(s.strip()))
