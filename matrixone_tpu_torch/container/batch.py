"""Host-side Batch: named Vectors + row count, and the host<->device bridge.

The port's copy of `matrixone_tpu/container/batch.py` without Arrow
interop and without the padding-canary audit (`utils/qa`).
`from_device` brings a DeviceBatch back to the host, trimming padding
and decoding dictionary-coded varlena columns through their host-side
dictionaries (`HostDicts`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from matrixone_tpu_torch.container import device as dev
from matrixone_tpu_torch.container.dtypes import DType, varchar
from matrixone_tpu_torch.container.vector import Vector

#: host-side dictionaries for device dictionary-encoded varlena columns
HostDicts = Dict[str, List[str]]


@dataclasses.dataclass
class Batch:
    columns: Dict[str, Vector]

    def __len__(self) -> int:
        for v in self.columns.values():
            return len(v)
        return 0

    @property
    def schema(self) -> Dict[str, DType]:
        return {n: v.dtype for n, v in self.columns.items()}


def from_device(dbatch: dev.DeviceBatch, dicts: Optional[HostDicts] = None,
                schema: Optional[Dict[str, DType]] = None) -> Batch:
    """Pull a DeviceBatch back to host, trimming padding and decoding dicts."""
    dicts = dicts or {}
    n = int(dbatch.n_rows)
    cols: Dict[str, Vector] = {}
    for name, col in dbatch.columns.items():
        data = col.data.cpu().numpy()
        val = col.validity.cpu().numpy()
        if col.is_const and n > 1:
            data = np.broadcast_to(data, (n,) + data.shape[1:]).copy()
            val = np.broadcast_to(val, (n,)).copy()
        data, val = data[:n], val[:n]
        dtype = (schema or {}).get(name, col.dtype)
        if name in dicts or dtype.is_varlen:
            if name not in dicts and n > 0 and val.any():
                raise ValueError(
                    f"varchar column {name!r} reached the host without a "
                    f"dictionary — an operator dropped dict propagation")
            lut = dicts.get(name, [])
            strings = [lut[c] if v else None for c, v in zip(data, val)]
            cols[name] = Vector(dtype=dtype if dtype.is_varlen else varchar(),
                                strings=strings,
                                validity=None if val.all() else val)
        else:
            cols[name] = Vector(dtype=dtype, data=data,
                                validity=None if val.all() else val)
    return Batch(cols)
