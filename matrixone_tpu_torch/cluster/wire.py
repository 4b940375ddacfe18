"""Columns on the fabric: the WAL's insert payload, self-contained.

The JAX package ships a fragment's rows, a partial group table and a
shuffle bucket as Arrow IPC (`storage/arrowio`); the card machine has no
pyarrow.  The port ships them in the format its WAL already logs
inserts in (`storage/wal.arrays_to_payload`): numpy blocks under
`objectio.encode_columns` (each block CRC32-checked), varchar columns
as `DictEncoded` batch-local codes plus their strings.  One format then
serves the WAL, the logtail and the fabric.

    blob = u32 JSON length | JSON {"cols": index, "strings": {...}} | body

A column of strings (a list of str or None) is dictionary-encoded
before it is written (`encode_strings`).  2-D vector columns, NULLs of
every type, empty and all-NULL columns round-trip.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch.storage import wal as walmod
from matrixone_tpu_torch.storage.wal import DictEncoded

_LEN = struct.Struct("<I")


def encode_strings(values: List[Optional[str]]) -> DictEncoded:
    """A list of strings (None: NULL) -> DictEncoded, categories in
    first-appearance order, NULL rows code 0."""
    cats: List[str] = []
    lut: Dict[str, int] = {}
    codes = np.zeros(len(values), np.int32)
    for i, s in enumerate(values):
        if s is None:
            continue
        c = lut.get(s)
        if c is None:
            c = lut[s] = len(cats)
            cats.append(s)
        codes[i] = c
    return DictEncoded(codes, cats)


def pack_parts(arrays: Dict[str, object], validity: Dict[str, np.ndarray]
               ) -> List[bytes]:
    """Columns -> the blob's parts (sent without joining them).  A list
    column is dictionary-encoded first; a column without a validity
    entry is all valid."""
    enc, val = {}, {}
    for c, a in arrays.items():
        if isinstance(a, list):
            a = encode_strings(a)
        enc[c] = a
        n = len(a.codes) if isinstance(a, DictEncoded) else len(a)
        v = validity.get(c)
        val[c] = (np.ones(n, np.bool_) if v is None
                  else np.ascontiguousarray(v, dtype=np.bool_))
    fields, parts = walmod.arrays_to_payload(enc, val)
    hj = json.dumps(fields).encode()
    return [_LEN.pack(len(hj)) + hj] + list(parts)


def pack(arrays: Dict[str, object], validity: Dict[str, np.ndarray]
         ) -> bytes:
    return b"".join(bytes(p) for p in pack_parts(arrays, validity))


def unpack(blob) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """Inverse of `pack`: varchar columns come back as DictEncoded."""
    mv = memoryview(blob)
    if not len(mv):
        return {}, {}
    (hlen,) = _LEN.unpack_from(mv, 0)
    fields = json.loads(bytes(mv[4:4 + hlen]).decode())
    return walmod.payload_to_arrays(fields, mv[4 + hlen:])


def merge_encoded(parts: List[DictEncoded]) -> Tuple[np.ndarray, List[str]]:
    """Several DictEncoded columns -> (int32 codes into one union
    dictionary, the union dictionary): each part's categories are
    looked up once, its codes remapped in one numpy gather."""
    union: List[str] = []
    lut: Dict[str, int] = {}
    out = []
    for p in parts:
        remap = np.empty(len(p.cats), np.int32)
        for i, s in enumerate(p.cats):
            c = lut.get(s)
            if c is None:
                c = lut[s] = len(union)
                union.append(s)
            remap[i] = c
        codes = np.asarray(p.codes, np.int64)
        out.append(remap[codes] if len(remap)
                   else np.zeros(len(codes), np.int32))
    codes = (np.concatenate(out).astype(np.int32) if out
             else np.zeros(0, np.int32))
    return codes, union
