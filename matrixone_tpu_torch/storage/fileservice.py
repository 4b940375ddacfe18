"""File service: the storage backend under objects, the WAL and
checkpoints.

The port's copy of `matrixone_tpu/storage/fileservice.py` (reference
analogue: pkg/fileservice `file_service.go:31`): a memory backend for
tests and a local-disk one.  S3 and the crash journal's recording
wrapper are not ported (ROADMAP.md, section A).

Write discipline: `write` is ATOMIC-REPLACE, so a crashed writer leaves
either the old content or the new, never a torn mix (LocalFS: write a
tmp file, fsync it, `os.replace` it over the target, fsync the
directory; a `*.tmp` left by a crash between the fsync and the replace
is an orphan, listed by `orphans()` and deleted by `Engine.open`).
`append` is DURABLE-ON-RETURN (fsync; the directory entry is fsynced
when the file is created, so a new WAL file cannot vanish with its
dirent after a power loss).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List


class FileService:
    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def append(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Ranged read (the column-fetch path of object-backed
        segments).  The default slices a full read; backends with a
        cheaper partial read override it."""
        return self.read(path)[offset:offset + length]

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def orphans(self) -> List[str]:
        """`*.tmp` files left by a writer that crashed between its tmp
        fsync and the atomic replace.  `list()` never shows them;
        `Engine.open` deletes them at startup."""
        return []


class MemoryFS(FileService):
    def __init__(self):
        self._files: Dict[str, bytearray] = {}
        self._lock = threading.Lock()

    def write(self, path, data):
        with self._lock:
            self._files[path] = bytearray(data)

    def append(self, path, data):
        with self._lock:
            self._files.setdefault(path, bytearray()).extend(data)

    def read(self, path):
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            return bytes(self._files[path])

    def read_range(self, path, offset, length):
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            # a writable copy of the range only
            return bytearray(self._files[path][offset:offset + length])

    def exists(self, path):
        with self._lock:
            return path in self._files

    def delete(self, path):
        with self._lock:
            self._files.pop(path, None)

    def list(self, prefix):
        with self._lock:
            return sorted(p for p in self._files if p.startswith(prefix)
                          and not p.endswith(".tmp"))

    def orphans(self):
        with self._lock:
            return sorted(p for p in self._files if p.endswith(".tmp"))


def _fsync_dir(path: str) -> None:
    """Durability of the directory ENTRY: a rename lives in the
    directory inode, and without a directory fsync a power loss can
    roll it back.  Best effort: platforms that cannot open a directory
    skip it."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class LocalFS(FileService):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, path: str) -> str:
        full = os.path.join(self.root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return full

    def write(self, path, data):
        full = self._p(path)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)
        _fsync_dir(full)

    def append(self, path, data):
        full = self._p(path)
        created = not os.path.exists(full)
        with open(full, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if created:
            _fsync_dir(full)

    def read(self, path):
        with open(os.path.join(self.root, path), "rb") as f:
            return f.read()

    def read_range(self, path, offset, length):
        # into a writable buffer: the column decoded from it is handed
        # to torch without a copy
        buf = bytearray(length)
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            got = f.readinto(buf)
        return buf if got == length else buf[:got]

    def exists(self, path):
        return os.path.exists(os.path.join(self.root, path))

    def delete(self, path):
        try:
            os.remove(os.path.join(self.root, path))
        except FileNotFoundError:
            pass

    def list(self, prefix):
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix) and not rel.endswith(".tmp"):
                    out.append(rel)
        return sorted(out)

    def orphans(self):
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          self.root)
                    out.append(rel.replace(os.sep, "/"))
        return sorted(out)
