"""Write-ahead log: CRC-framed records on the file service.

The counterpart of `matrixone_tpu/storage/wal.py` (reference analogue:
pkg/vm/engine/tae/logstore + logservice), in the port's own format:

    frame   = MAGIC u32 | payload length u32 | payload CRC32 u32 | payload
    payload = JSON header length u32 | JSON header | blob

An insert's blob is its columns in the object format's block encoding
(`objectio.encode_columns`, index in the header); varchar columns travel
as batch-local dictionary codes plus their strings (`DictEncoded`, the
reference's `to_dict_encoded`), so a replay re-encodes them into the
table's dictionary as it stands then, however it has grown since.  A
delete's blob is its row ids as raw little-endian int64.  Replay stops
at the first torn or CRC-failing frame: nothing after it is applied,
and its bytes are counted in `torn_bytes`.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch.storage import objectio
from matrixone_tpu_torch.storage.fileservice import FileService
from matrixone_tpu_torch.utils.fault import INJECTOR

_FRAME_MAGIC = 0x4D4F5741  # 'MOWA'
_FRAME = struct.Struct("<III")


@dataclasses.dataclass
class DictEncoded:
    """A varchar column as batch-local dictionary codes + their strings:
    `codes[i]` indexes `cats`; NULL rows carry code 0 and are masked by
    the validity beside the column."""
    codes: np.ndarray          # int32 [n]
    cats: List[str]


def to_dict_encoded(dictionary: List[str], codes: np.ndarray,
                    valid: np.ndarray) -> DictEncoded:
    """Table codes -> batch-local DictEncoded: O(n + dictionary) numpy,
    the strings of the codes present only, in code order (the
    reference's np.unique order)."""
    codes = np.asarray(codes, np.int64)
    if len(dictionary) == 0 or len(codes) == 0:
        return DictEncoded(np.zeros(len(codes), np.int32), [])
    safe = np.where(np.asarray(valid, bool),
                    np.clip(codes, 0, len(dictionary) - 1), 0)
    present = np.zeros(len(dictionary), np.bool_)
    present[safe] = True
    uniq = np.flatnonzero(present)
    remap = np.zeros(len(dictionary), np.int32)
    remap[uniq] = np.arange(len(uniq), dtype=np.int32)
    return DictEncoded(remap[safe], [dictionary[int(u)] for u in uniq])


def arrays_to_payload(arrays: Dict[str, object],
                      validity: Dict[str, np.ndarray]
                      ) -> Tuple[dict, List[bytes]]:
    """An insert's columns (numpy arrays, or DictEncoded varchar) ->
    (header fields, blob parts)."""
    plain, strings = {}, {}
    for c, a in arrays.items():
        if isinstance(a, DictEncoded):
            strings[c] = a.cats
            plain[c] = np.asarray(a.codes, np.int32)
        else:
            plain[c] = a
    index, parts = objectio.encode_columns(plain, validity)
    return {"cols": index, "strings": strings}, parts


def payload_to_arrays(header: dict, blob
                      ) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """Inverse of `arrays_to_payload`: varchar columns come back as
    DictEncoded."""
    arrays, validity = objectio.decode_columns(header["cols"], blob,
                                               "wal insert")
    for c, cats in header.get("strings", {}).items():
        arrays[c] = DictEncoded(arrays[c], list(cats))
    return arrays, validity


class WalWriter:
    def __init__(self, fs: FileService, path: str = "wal/wal.log"):
        self.fs = fs
        self.path = path

    def append(self, header: dict, blob=b"") -> None:
        """One frame; `blob` is bytes or a list of byte-like parts."""
        if INJECTOR.trigger("wal.append") == "fail":
            raise IOError("fault injected: wal.append failed")
        parts = blob if isinstance(blob, list) else [blob]
        hj = json.dumps(header).encode()
        payload = b"".join([struct.pack("<I", len(hj)), hj] + parts)
        frame = _FRAME.pack(_FRAME_MAGIC, len(payload),
                            zlib.crc32(payload)) + payload
        self.fs.append(self.path, frame)

    def truncate(self) -> None:
        # atomic-replace truncation, called only after the checkpoint
        # manifest is durable: a crash in between replays the tail
        # against the old manifest
        self.fs.write(self.path, b"")

    def replay(self, stats: Optional[dict] = None
               ) -> Iterator[Tuple[dict, memoryview]]:
        return replay(self.fs, self.path, stats=stats)


def replay(fs: FileService, path: str = "wal/wal.log",
           stats: Optional[dict] = None
           ) -> Iterator[Tuple[dict, memoryview]]:
    """Yield (header, blob) of each intact frame; stop at the first torn
    or corrupt one.  `stats`, when given, fills as the scan proceeds:
    at exhaustion it holds the frames replayed, the torn-tail bytes
    discarded (everything after the last intact frame) and the log's
    bytes."""
    if stats is None:
        stats = {}
    stats.update(frames=0, torn_bytes=0, bytes=0)
    if not fs.exists(path):
        return
    blob = memoryview(fs.read(path))
    stats["bytes"] = len(blob)
    off = 0
    while off + _FRAME.size <= len(blob):
        magic, plen, crc = _FRAME.unpack_from(blob, off)
        if magic != _FRAME_MAGIC or off + _FRAME.size + plen > len(blob):
            break
        payload = blob[off + _FRAME.size:off + _FRAME.size + plen]
        if zlib.crc32(payload) != crc:
            break
        (hlen,) = struct.unpack_from("<I", payload, 0)
        header = json.loads(bytes(payload[4:4 + hlen]).decode())
        stats["frames"] += 1
        off += _FRAME.size + plen
        yield header, payload[4 + hlen:]
    stats["torn_bytes"] = len(blob) - off
