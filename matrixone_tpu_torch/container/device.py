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
import threading
from typing import Dict, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container.dtypes import DType, torch_dtype_of
from matrixone_tpu_torch.utils import qa

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
        """Length-1 'const' column (reference: const-class vectors).  A
        fill, not a host copy, so a CUDA graph can capture it."""
        try:
            data = torch.full((1,), value, dtype=dtype.torch_dtype,
                              device=device)
        except RuntimeError:
            # a float past the dtype's range: the copy rounds it to inf
            data = torch.tensor([value], dtype=dtype.torch_dtype,
                                device=device)
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


# ------------------------------------------------ host arrays on the device

_TAPE = threading.local()


class ConstTape:
    """The device copies of the host arrays (dictionary LUTs, slot
    maps) that one fused step makes, in the order it makes them.

    A CUDA graph cannot capture a copy from pageable host memory (it
    syncs the stream), and it bakes the address of every tensor it
    reads.  So the step's warm-up run records each copy here
    (`mode="record"`); while the graph is captured the same calls
    (`mode="replay"`) get the recorded tensors back, which live as
    long as the tape does.  A replayed call must ask for the same bytes
    it recorded: anything else means the step's cache key missed what
    the step baked, and raises."""

    def __init__(self):
        self.items = []
        self.mode = "record"
        self.pos = 0

    def take(self, host: torch.Tensor, device) -> torch.Tensor:
        if self.mode == "record":
            dev = host.to(device)
            self.items.append((host.clone(), dev))
            return dev
        if self.pos >= len(self.items):
            raise RuntimeError("fused step made more host constants while "
                               "captured than in its warm-up")
        want, dev = self.items[self.pos]
        self.pos += 1
        if want.dtype != host.dtype or want.shape != host.shape \
                or not torch.equal(want, host):
            raise RuntimeError("fused step baked other host constants "
                               "while captured than in its warm-up: its "
                               "cache key misses what it baked")
        return dev


class const_tape:
    """Route `to_device` through `tape` for the scope's duration."""

    def __init__(self, tape: ConstTape, mode: str):
        self._tape = tape
        self._mode = mode

    def __enter__(self):
        self._prev = getattr(_TAPE, "tape", None)
        self._tape.mode = self._mode
        self._tape.pos = 0
        _TAPE.tape = self._tape
        return self._tape

    def __exit__(self, *exc):
        _TAPE.tape = self._prev
        return False


def to_device(arr, device) -> torch.Tensor:
    """A host numpy array as a tensor on `device`.  Under a
    `const_tape` (a fused step being warmed up or captured on the card)
    the copy goes through the tape."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    tape = getattr(_TAPE, "tape", None)
    if tape is None or device.type != "cuda":
        return host.to(device)
    return tape.take(host, device)


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


_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


def _dtype_ok(have, want: torch.dtype) -> bool:
    """Accept the declared dtype OR a narrower signed int (narrow dict
    codes from ops/encodings: int8/int16 codes under a declared int32
    column must survive staging, not silently widen back).  `have` is a
    tensor's torch dtype or a host array's numpy dtype."""
    if not isinstance(have, torch.dtype):
        try:
            have = torch_dtype_of(have)
        except KeyError:
            return False
    return have == want or (have in _SIGNED and want in _SIGNED
                            and have.itemsize < want.itemsize)


def _rows_on(arr, n_rows: int, device) -> torch.Tensor:
    """The first n_rows of a host array, or of a tensor (the device fast
    path: a tensor on `device` is copied device to device, never through
    the host), as a tensor on `device`."""
    if isinstance(arr, torch.Tensor):
        return arr[:n_rows].to(device)
    return torch.from_numpy(np.ascontiguousarray(arr[:n_rows])).to(device)


#: numpy dtype of each torch dtype an upload may carry (the canary's)
_NP_OF = {torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
          torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
          torch.int64: np.dtype(np.int64),
          torch.uint8: np.dtype(np.uint8),
          torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64),
          torch.float16: np.dtype(np.float16)}


def from_numpy(arrays: Dict[str, np.ndarray],
               dtypes: Dict[str, DType],
               validity: Optional[Dict[str, np.ndarray]] = None,
               n_rows: Optional[int] = None,
               pad_to: Optional[int] = None,
               device=None) -> DeviceBatch:
    """Build a padded DeviceBatch on `device` from host numpy arrays
    (zero rows allowed); padding rows hold zeros (the padding canary's
    poison when `utils/qa` is armed) and are invalid.

    Device fast path (the block cache's device tier): a column or a
    validity given as a tensor already on `device`, at the declared (or
    a narrower signed int) dtype, is copied device to device into the
    padded buffer (a cast, if any, on the device too)."""
    if device is None:
        raise ValueError("from_numpy needs a device")
    if n_rows is None:
        n_rows = len(next(iter(arrays.values()))) if arrays else 0
    padded = pad_to if pad_to is not None else bucket_length(max(n_rows, 1))
    cols = {}
    for name, arr in arrays.items():
        dt = dtypes[name]
        val = None if validity is None else validity.get(name)
        want = torch_dtype_of(dt.np_dtype)
        if isinstance(arr, torch.Tensor):
            if not _dtype_ok(arr.dtype, want):
                arr = arr.to(want)
            tdt = arr.dtype
        else:
            arr = np.asarray(arr)
            if not _dtype_ok(arr.dtype, want):
                arr = np.asarray(arr, dtype=dt.np_dtype)
            tdt = torch_dtype_of(arr.dtype)
        data = torch.zeros((padded,) + tuple(arr.shape[1:]), dtype=tdt,
                           device=device)
        if qa._ARMED and padded > n_rows:
            # the padded tail, canary-poisoned under the padding audit
            # (utils/qa.py): the tail is dead by contract, so its fill
            # must never be observable
            poison = qa.canary_value(_NP_OF[tdt])
            if poison is not None:
                data[n_rows:] = poison.item()
        valid = torch.zeros((padded,), dtype=torch.bool, device=device)
        if n_rows:
            data[:n_rows] = _rows_on(arr, n_rows, device)
            if val is None:
                valid[:n_rows] = True
            elif isinstance(val, torch.Tensor):
                valid[:n_rows] = _rows_on(val, n_rows, device)
            else:
                valid[:n_rows] = _rows_on(np.asarray(val, np.bool_),
                                          n_rows, device)
        cols[name] = DeviceColumn(data=data, validity=valid, dtype=dt)
    return DeviceBatch(columns=cols,
                       n_rows=torch.tensor(n_rows, dtype=torch.int32,
                                           device=device))

