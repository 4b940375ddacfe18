"""Columnar object format: the port's own.

The counterpart of `matrixone_tpu/storage/objectio.py` (reference
analogue: pkg/objectio), which writes Arrow IPC blocks.  The port owns
a format of numpy buffers behind a JSON header instead (standard
library and numpy only), so an object written here is read by the port
alone; its rows, not its bytes, are what the tests hold to the
reference's.

An object is one committed segment's columns:

    MAGIC "MOTO" | u32 version | u32 header length | u32 header CRC32
    | JSON header | padding to 64 bytes | body

The header carries the table, the object id, `n_rows`, `commit_ts`,
per-column zonemaps (min, max, null count) and, per column, its numpy
dtype and shape and the [offset, length, CRC32] of its data block and
of its validity block in the body.  Each block is the column's raw
little-endian bytes (validity: one byte a row), starting on a 64-byte
boundary.  Varchar columns are the table's int32 dictionary codes; the
dictionary lives in the checkpoint manifest.  A reader fetches one
column with one ranged read (`read_column_block`) and prunes by the
header's zonemaps before fetching anything.  Every block and the
header are checked against their CRC32: a mismatch raises
`ObjectCorrupt`, it never yields rows.

Blocks are written uncompressed: the card machine has no lz4, and zlib
made the reference's load compression-bound.  The WAL (`storage/wal.py`)
frames its insert payloads with the same block encoding.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
import zlib
from typing import Dict, List, Tuple

import numpy as np

from matrixone_tpu_torch.storage.fileservice import FileService
from matrixone_tpu_torch.utils import metrics
from matrixone_tpu_torch.utils.fault import INJECTOR

_MAGIC = b"MOTO"
_VERSION = 1
_PREFIX = struct.Struct("<4sIII")       # magic, version, header len, crc
_ALIGN = 64
#: header prefetch of a ranged header read: covers the JSON of any
#: realistic object (zonemaps for hundreds of columns) in one read
_HDR_PREFETCH = 64 << 10


class ObjectCorrupt(IOError):
    """An object's bytes fail their magic, version or a CRC32."""


@dataclasses.dataclass
class ZoneMap:
    min: object
    max: object
    null_count: int


@dataclasses.dataclass
class ObjectMeta:
    table: str
    object_id: str
    n_rows: int
    commit_ts: int
    zonemaps: Dict[str, ZoneMap]
    kind: str = "data"

    def to_dict(self) -> dict:
        return {"table": self.table, "object_id": self.object_id,
                "n_rows": self.n_rows, "commit_ts": self.commit_ts,
                "kind": self.kind,
                "zonemaps": {c: [_enc(z.min), _enc(z.max), z.null_count]
                             for c, z in self.zonemaps.items()}}


def _meta_from_raw(raw: dict) -> ObjectMeta:
    zm = {c: ZoneMap(v[0], v[1], v[2])
          for c, v in raw.get("zonemaps", {}).items()}
    return ObjectMeta(table=raw["table"], object_id=raw["object_id"],
                      n_rows=raw["n_rows"], commit_ts=raw["commit_ts"],
                      zonemaps=zm, kind=raw.get("kind", "data"))


def _enc(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def compute_zonemaps(arrays: Dict[str, np.ndarray],
                     validity: Dict[str, np.ndarray]) -> Dict[str, ZoneMap]:
    """Per-column (min, max, null count) over the valid rows; vectors
    and booleans get none."""
    out = {}
    for c, a in arrays.items():
        val = validity.get(c)
        nulls = 0 if val is None else int((~val).sum())
        if a.ndim != 1 or a.dtype == np.bool_:
            continue
        vals = a if val is None else a[val]
        if len(vals) == 0:
            out[c] = ZoneMap(None, None, nulls)
        else:
            out[c] = ZoneMap(_enc(vals.min()), _enc(vals.max()), nulls)
    return out


def object_path(table: str, object_id: str) -> str:
    return f"objects/{table}/{object_id}.obj"


# --------------------------------------------------------------- blocks

def _le(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def _pad(n: int) -> int:
    return (-n) % _ALIGN


def encode_columns(arrays: Dict[str, np.ndarray],
                   validity: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, dict], List[bytes]]:
    """-> (column index, body parts): each column's data block then its
    validity block, each on a 64-byte boundary of the body, with its
    [offset, length, CRC32] in the index."""
    index: Dict[str, dict] = {}
    parts: List[bytes] = []
    off = 0
    for c, a in arrays.items():
        a = _le(np.asarray(a))
        v = np.ascontiguousarray(validity[c], dtype=np.bool_)
        ent = {"dtype": a.dtype.str, "shape": list(a.shape)}
        for kind, arr in (("data", a), ("validity", v)):
            mv = memoryview(arr.reshape(-1).view(np.uint8))
            ent[kind] = [off, len(mv), zlib.crc32(mv)]
            parts.append(mv)
            off += len(mv)
            pad = _pad(off)
            if pad:
                parts.append(b"\0" * pad)
                off += pad
        index[c] = ent
    return index, parts


def _block(body, base: int, ent: dict, kind: str, where: str) -> np.ndarray:
    off, ln, crc = ent[kind]
    mv = memoryview(body)[off - base:off - base + ln]
    if len(mv) != ln or zlib.crc32(mv) != crc:
        raise ObjectCorrupt(f"{where}: {kind} block fails its CRC32")
    if kind == "validity":
        return np.frombuffer(mv, dtype=np.bool_)
    dtype = np.dtype(ent["dtype"])
    return np.frombuffer(mv, dtype=dtype).reshape(ent["shape"])


def decode_column(body, ent: dict, where: str, base: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One column's (data, validity) out of `body`, which holds the
    body's bytes from offset `base` on; both blocks CRC-checked."""
    return (_block(body, base, ent, "data", where),
            _block(body, base, ent, "validity", where))


def decode_columns(index: Dict[str, dict], body, where: str
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    arrays, validity = {}, {}
    for c, ent in index.items():
        arrays[c], validity[c] = decode_column(body, ent, f"{where} {c}")
    return arrays, validity


# -------------------------------------------------------------- objects

def write_object(fs: FileService, meta: ObjectMeta,
                 arrays: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray]) -> str:
    """Serialize a segment through the file service (one atomic write);
    -> its path."""
    t0 = time.perf_counter()
    index, parts = encode_columns(arrays, validity)
    header = meta.to_dict()
    header["cols"] = index
    hj = json.dumps(header).encode()
    head = _PREFIX.pack(_MAGIC, _VERSION, len(hj), zlib.crc32(hj)) + hj
    head += b"\0" * _pad(len(head))
    path = object_path(meta.table, meta.object_id)
    if INJECTOR.trigger("object.write") == "fail":
        raise IOError(f"fault injected: object.write {path}")
    fs.write(path, b"".join([head] + parts))
    metrics.object_write_seconds.inc(time.perf_counter() - t0)
    return path


def _parse_prefix(head, path: str) -> Tuple[int, int]:
    if len(head) < _PREFIX.size:
        raise ObjectCorrupt(f"{path}: truncated object")
    magic, version, hlen, hcrc = _PREFIX.unpack_from(head, 0)
    if magic != _MAGIC:
        raise ObjectCorrupt(f"{path}: bad object magic")
    if version != _VERSION:
        raise ObjectCorrupt(f"{path}: object version {version}")
    return hlen, hcrc


def _parse_header(head, hlen: int, hcrc: int, path: str) -> dict:
    hj = bytes(head[_PREFIX.size:_PREFIX.size + hlen])
    if len(hj) != hlen or zlib.crc32(hj) != hcrc:
        raise ObjectCorrupt(f"{path}: header fails its CRC32")
    raw = json.loads(hj.decode())
    n = _PREFIX.size + hlen
    raw["_body_off"] = n + _pad(n)
    return raw


def read_header_ranged(fs: FileService, path: str
                       ) -> Tuple[ObjectMeta, dict]:
    """Header-only read (one ranged read for any realistic header): the
    zonemap prune's source, never touching column bytes.  -> (meta, the
    raw header with `_body_off`)."""
    head = fs.read_range(path, 0, _HDR_PREFETCH)
    hlen, hcrc = _parse_prefix(head, path)
    if len(head) < _PREFIX.size + hlen:
        head = bytes(head) + bytes(fs.read_range(
            path, len(head), _PREFIX.size + hlen - len(head)))
    raw = _parse_header(head, hlen, hcrc, path)
    return _meta_from_raw(raw), raw


def read_column_block(fs: FileService, path: str, raw: dict, col: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One column of an object, given its parsed header `raw`: one
    ranged read of its data and validity blocks.  -> (data, validity)."""
    if INJECTOR.trigger("object.read") == "fail":
        raise IOError(f"fault injected: object.read {path}")
    ent = raw["cols"][col]
    lo = min(ent["data"][0], ent["validity"][0])
    hi = max(ent["data"][0] + ent["data"][1],
             ent["validity"][0] + ent["validity"][1])
    buf = fs.read_range(path, raw["_body_off"] + lo, hi - lo)
    return decode_column(buf, ent, f"{path} {col}", base=lo)


def read_object(fs: FileService, path: str
                ) -> Tuple[ObjectMeta, Dict[str, np.ndarray],
                           Dict[str, np.ndarray]]:
    """The whole object in one read."""
    if INJECTOR.trigger("object.read") == "fail":
        raise IOError(f"fault injected: object.read {path}")
    blob = fs.read(path)
    hlen, hcrc = _parse_prefix(blob, path)
    raw = _parse_header(blob, hlen, hcrc, path)
    body = memoryview(blob)[raw["_body_off"]:]
    arrays, validity = decode_columns(raw["cols"], body, path)
    return _meta_from_raw(raw), arrays, validity
