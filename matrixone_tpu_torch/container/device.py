"""Device-resident columnar containers on torch tensors.

The port of `matrixone_tpu/container/device.py` (there, JAX pytrees):

  reference (Go, CPU)                      this module (torch, CUDA)
  ------------------------------           -----------------------------------
  data []byte (fixed-width values)    ->   DeviceColumn.data  tensor
  nulls *nulls.Nulls (bitmap)         ->   DeviceColumn.validity bool tensor
  area []byte (varlena heap)          ->   dictionary codes in .data (int32,
                                           or narrower), strings host-side
  batch.Batch{Vecs, rowCount}         ->   DeviceBatch{columns, n_rows}

Batches are padded to the JAX package's bucketed lengths
(`bucket_length`), so both packages see the same padded shapes, batch
for batch: padding rows are masked out by `DeviceBatch.row_mask()`.
A "const" (scalar) column is a length-1 tensor broadcast by kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container.dtypes import DType, torch_dtype_of

#: batch length buckets — powers of two from 1Ki to 1Mi (the JAX
#: package's, which it needs to bound its jit cache; the port keeps them
#: so both packages pad alike)
_BUCKETS = [1 << k for k in range(10, 21)]


def bucket_length(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    # beyond 1Mi rows, round up to the next multiple of 1Mi
    m = _BUCKETS[-1]
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class DeviceColumn:
    """One typed column on a device: values + validity mask.

    ``data``: shape [n] (scalar types) or [n, dim] (VECF32 embeddings).
    ``validity``: bool [n]; True = value present (Arrow convention).
    ``dtype``: the SQL type.
    """

    data: torch.Tensor
    validity: torch.Tensor
    dtype: DType

    @property
    def padded_len(self) -> int:
        return self.data.shape[0]

    @classmethod
    def const(cls, value, dtype: DType, device) -> "DeviceColumn":
        """Length-1 'const' column (reference: const-class vectors)."""
        data = torch.tensor([value], dtype=dtype.torch_dtype, device=device)
        return cls(data=data,
                   validity=torch.ones((1,), dtype=torch.bool, device=device),
                   dtype=dtype)

    @classmethod
    def const_null(cls, dtype: DType, device) -> "DeviceColumn":
        data = torch.zeros((1,), dtype=dtype.torch_dtype, device=device)
        return cls(data=data,
                   validity=torch.zeros((1,), dtype=torch.bool,
                                        device=device),
                   dtype=dtype)

    @property
    def is_const(self) -> bool:
        return self.data.shape[0] == 1


@dataclasses.dataclass
class DeviceBatch:
    """A batch of named columns + row count.

    ``n_rows`` is an int32 0-d tensor on the batch's device, so a row
    count computed on the device never forces a host sync."""

    columns: Dict[str, DeviceColumn]
    n_rows: torch.Tensor  # int32 scalar

    @property
    def padded_len(self) -> int:
        for c in self.columns.values():
            if not c.is_const:
                return c.padded_len
        return 1

    def row_mask(self) -> torch.Tensor:
        """bool [padded_len]: True for real (non-padding) rows."""
        return torch.arange(self.padded_len, dtype=torch.int32,
                            device=self.n_rows.device) < self.n_rows


def _dtype_ok(have, want: np.dtype) -> bool:
    """Accept the declared dtype OR a narrower signed int (narrow dict
    codes from ops/encodings: int8/int16 codes under a declared int32
    column must survive staging, not silently widen back)."""
    have = np.dtype(have)
    if have == want:
        return True
    return (have.kind == "i" and want.kind == "i"
            and have.itemsize < want.itemsize)


def from_numpy(arrays: Dict[str, np.ndarray],
               dtypes: Dict[str, DType],
               validity: Optional[Dict[str, np.ndarray]] = None,
               n_rows: Optional[int] = None,
               pad_to: Optional[int] = None,
               device=None) -> DeviceBatch:
    """Build a padded DeviceBatch on `device` from host numpy arrays
    (zero rows allowed); padding rows hold zeros and are invalid."""
    if device is None:
        raise ValueError("from_numpy needs a device")
    if n_rows is None:
        n_rows = len(next(iter(arrays.values()))) if arrays else 0
    padded = pad_to if pad_to is not None else bucket_length(max(n_rows, 1))
    cols = {}
    for name, arr in arrays.items():
        dt = dtypes[name]
        val = None if validity is None else validity.get(name)
        arr = np.asarray(arr)
        if not _dtype_ok(arr.dtype, np.dtype(dt.np_dtype)):
            arr = np.asarray(arr, dtype=dt.np_dtype)
        data = torch.zeros((padded,) + arr.shape[1:],
                           dtype=torch_dtype_of(arr.dtype), device=device)
        valid = torch.zeros((padded,), dtype=torch.bool, device=device)
        if n_rows:
            data[:n_rows] = torch.from_numpy(
                np.ascontiguousarray(arr[:n_rows])).to(device)
            if val is None:
                valid[:n_rows] = True
            else:
                valid[:n_rows] = torch.from_numpy(
                    np.ascontiguousarray(val[:n_rows], np.bool_)).to(device)
        cols[name] = DeviceColumn(data=data, validity=valid, dtype=dt)
    return DeviceBatch(columns=cols,
                       n_rows=torch.tensor(n_rows, dtype=torch.int32,
                                           device=device))

