"""The fabric's frame: one JSON header and one blob, length-prefixed.

    u32 header length | header JSON | u32 blob length | blob

The port's copy of `_send_msg`/`_recv_msg` of
`matrixone_tpu/logservice/replicated.py`, the framing every lane of the
fabric shares (CN -> TN commits and DDL, the logtail push, CN <-> CN
fragments and shuffle pushes).  A receive reads each part into one
buffer allocated at its full length (`recv_into`), so a blob of n bytes
costs O(n) however many segments the socket delivers it in.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Tuple

_LEN = struct.Struct("<I")


def send_msg(sock: socket.socket, header: dict, blob=b"") -> None:
    """One frame.  `blob` is bytes-like or a list of bytes-like parts
    (sent without joining them)."""
    hj = json.dumps(header).encode()
    parts = blob if isinstance(blob, list) else [blob]
    n = sum(memoryview(p).nbytes for p in parts)
    head = _LEN.pack(len(hj)) + hj + _LEN.pack(n)
    if len(parts) == 1 and n < (1 << 16):
        sock.sendall(head + bytes(parts[0]))
        return
    sock.sendall(head)
    for p in parts:
        if memoryview(p).nbytes:
            sock.sendall(p)


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly n bytes, into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    """One frame -> (header, blob).  The blob is a bytearray (b"" when
    empty)."""
    (hlen,) = _LEN.unpack(recv_exact(sock, 4))
    header = json.loads(bytes(recv_exact(sock, hlen)).decode())
    (blen,) = _LEN.unpack(recv_exact(sock, 4))
    return header, (recv_exact(sock, blen) if blen else b"")
