"""Host-side columnar Vector — the CPU half of the container layer.

The port's copy of `matrixone_tpu/container/vector.py` without its Arrow
interop (the card machine has no `pyarrow`): fixed-width data is a numpy
array + bool validity; varlena (VARCHAR/TEXT) is a Python list of str
(None for NULL).  Query results come back to the host as Vectors.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional

import numpy as np

from matrixone_tpu_torch.container.dtypes import DType, TypeOid


@dataclasses.dataclass
class Vector:
    """Host column: fixed-width numpy data or a list of strings, +
    validity."""

    dtype: DType
    data: Optional[np.ndarray] = None       # fixed-width types
    strings: Optional[List[Optional[str]]] = None   # varlena types
    validity: Optional[np.ndarray] = None   # bool; None => all valid

    def __len__(self) -> int:
        if self.dtype.is_varlen:
            return len(self.strings)
        return len(self.data)

    @classmethod
    def from_values(cls, values, dtype: DType) -> "Vector":
        if dtype.is_varlen:
            strings = [None if v is None else str(v) for v in values]
            val = np.array([s is not None for s in strings], np.bool_)
            return cls(dtype=dtype, strings=strings,
                       validity=None if val.all() else val)
        values = list(values)
        val = np.array([v is not None for v in values], dtype=np.bool_)
        filled = [v if v is not None else 0 for v in values]
        if dtype.oid == TypeOid.DECIMAL64:
            scaled = [int(round(float(v) * 10 ** dtype.scale)) for v in filled]
            data = np.array(scaled, dtype=np.int64)
        elif dtype.oid == TypeOid.DATE:
            epoch = datetime.date(1970, 1, 1)
            days = [(v - epoch).days if isinstance(v, datetime.date) else int(v)
                    for v in filled]
            data = np.asarray(days, dtype=np.int32)
        elif dtype.oid in (TypeOid.DATETIME, TypeOid.TIMESTAMP):
            epoch = datetime.datetime(1970, 1, 1)
            us = [int((v - epoch).total_seconds() * 1e6)
                  if isinstance(v, datetime.datetime) else int(v)
                  for v in filled]
            data = np.asarray(us, dtype=np.int64)
        else:
            data = np.asarray(filled, dtype=dtype.np_dtype)
        return cls(dtype=dtype, data=data,
                   validity=None if val.all() else val)

    def valid_mask(self) -> np.ndarray:
        if self.validity is not None:
            return self.validity
        return np.ones(len(self), dtype=np.bool_)

    def to_pylist(self):
        if self.dtype.is_varlen:
            return list(self.strings)
        mask = self.valid_mask()
        if self.dtype.oid == TypeOid.DECIMAL64:
            scale = 10 ** self.dtype.scale
            return [int(v) / scale if m else None
                    for v, m in zip(self.data, mask)]
        if self.dtype.oid == TypeOid.DATE:
            epoch = datetime.date(1970, 1, 1)
            return [epoch + datetime.timedelta(days=int(v)) if m else None
                    for v, m in zip(self.data, mask)]
        if self.dtype.oid in (TypeOid.DATETIME, TypeOid.TIMESTAMP):
            epoch = datetime.datetime(1970, 1, 1)
            return [epoch + datetime.timedelta(microseconds=int(v)) if m
                    else None for v, m in zip(self.data, mask)]
        if self.dtype.is_vector:
            return [[float(x) for x in self.data[i]] if mask[i] else None
                    for i in range(len(self))]
        return [self.data[i].item() if mask[i] else None
                for i in range(len(self))]
