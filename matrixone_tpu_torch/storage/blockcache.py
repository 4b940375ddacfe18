"""Object-backed segments: a two-tier decoded-column cache and lazy
column views.

The port's copy of `matrixone_tpu/storage/blockcache.py` (reference
analogue: the CN read path, `readutil/reader.go:600`,
`fileservice/mem_cache.go`):

  * `BlockCache`, process-wide LRUs of DECODED columns keyed by (file
    service token, object path, column, kind): a HOST tier of numpy
    arrays (`MO_BLOCK_CACHE_MB`, default 256) and a DEVICE tier of the
    same columns as `torch.Tensor`s on the scanning engine's device
    (`MO_DEVICE_CACHE_MB`, default the host budget; 0 pins nothing).
    Device-tier keys carry the device as well.  A warm scan is served
    from the device tier: no decode and no host-to-device copy.
    `MO_BLOCK_CACHE_DISABLE=1` turns every lookup into a miss.
  * `LazyColumns`, a Mapping[str, np.ndarray] over one object's columns.

A design change from the reference, on purpose: `LazyColumns[c]` returns
the HOST array (from the host tier), and only the scan asks for the
device tensor, through `LazyColumns.device(c, device)`.  The reference
hands device arrays to every reader and relies on `np.asarray` of a JAX
array; here the host readers (the commit's key checks, merges,
`fetch_rows`, partition routing, `convert.tables_to_numpy`, the host
library) could not read a CUDA tensor.  So the counters split too: a
device lookup counts as the reference's lookup does (hits, misses,
dev_hits, dev_misses, uploads), a host lookup counts hits and misses
only.

The scan's read-ahead thread (`vm/operators._ChunkPrefetcher`) touches
the host tier only (`LazyColumns.warm`): a CUDA allocation or copy from
that thread could land inside a CUDA graph the consumer is capturing.
The upload into the device tier runs on the consumer's thread; a column
the read-ahead decoded counts as the miss at that upload, as it would
have without the read-ahead.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.utils import metrics


def _budget_bytes() -> int:
    return int(os.environ.get("MO_BLOCK_CACHE_MB", "256")) << 20


def _device_budget_bytes() -> int:
    """The device tier's budget: the host budget unless
    `MO_DEVICE_CACHE_MB` names one (0: nothing is pinned, every warm
    scan re-uploads from the host tier)."""
    v = os.environ.get("MO_DEVICE_CACHE_MB", "")
    if v == "":
        return _budget_bytes()
    return int(v) << 20


def _disabled() -> bool:
    return os.environ.get("MO_BLOCK_CACHE_DISABLE") == "1"


def _as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A cached host column as a tensor on `device` (a copy on CUDA; on
    the CPU it shares the array's memory).  Cached columns are immutable
    by contract, so a read-only array is fine to wrap."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(a)
    return host.to(device)


class BlockCache:
    """Process-wide decoded-column LRUs under per-tier byte budgets.

    A device-tier miss with a host hit costs one upload (counted in
    `uploaded_bytes`); only a miss in both tiers decodes.  A column
    larger than a whole tier's budget is still admitted (the scan must
    go on) but evicts everything else in that tier; `peak_bytes` keeps
    the true high-water mark of both tiers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._host: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._host_sizes: Dict[tuple, int] = {}
        self._dev: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._dev_sizes: Dict[tuple, int] = {}
        #: device-tier entries per host key (one a device), for `contains`
        self._dev_bases: Dict[tuple, int] = {}
        #: columns the read-ahead decoded that no device lookup served
        #: yet: their first upload counts as the miss
        self._pending: set = set()
        self.host_used_bytes = 0
        self.dev_used_bytes = 0
        self.host_peak_bytes = 0
        self.dev_peak_bytes = 0
        self.peak_bytes = 0
        self.hits = 0                 # served without a decode
        self.misses = 0               # a decode was needed
        self.dev_hits = 0             # served with no upload
        self.dev_misses = 0
        self.host_evictions = 0
        self.dev_evictions = 0
        self.uploaded_bytes = 0       # host -> device copies
        self.decode_seconds = 0.0
        self.bytes_fetched = 0        # decoded bytes brought in on misses

    # -------------------------------------------------------- host tier

    def host_get(self, key: tuple, count: bool = True):
        """The host array of `key`, or None."""
        if _disabled():
            a = None
        else:
            with self._lock:
                a = self._host.get(key)
                if a is not None:
                    self._host.move_to_end(key)
        if count:
            with self._lock:
                if a is None:
                    self.misses += 1
                else:
                    self.hits += 1
            metrics.blockcache_ops.inc(
                outcome="miss" if a is None else "hit")
        return a

    def host_put(self, key: tuple, value: np.ndarray) -> np.ndarray:
        nb = int(value.nbytes)
        with self._lock:
            if key not in self._host:
                budget = _budget_bytes()
                while self._host and self.host_used_bytes + nb > budget:
                    k, _v = self._host.popitem(last=False)
                    self.host_used_bytes -= self._host_sizes.pop(k)
                    self.host_evictions += 1
                self._host[key] = value
                self._host_sizes[key] = nb
                self.host_used_bytes += nb
                self.host_peak_bytes = max(self.host_peak_bytes,
                                           self.host_used_bytes)
                self._note_peak_locked()
        return value

    # ------------------------------------------------------ device tier

    @staticmethod
    def _dev_key(key: tuple, device) -> tuple:
        return key + (str(torch.device(device)),)

    def dev_get(self, key: tuple, device):
        """The device tensor of `key` on `device`, or None (not
        counted)."""
        if _disabled():
            return None
        dk = self._dev_key(key, device)
        with self._lock:
            t = self._dev.get(dk)
            if t is not None:
                self._dev.move_to_end(dk)
            return t

    def upload(self, key: tuple, host_value: np.ndarray, device
               ) -> torch.Tensor:
        """host array -> tensor on `device`, admitted to the device tier
        under its budget (not pinned when the budget is 0)."""
        t = _as_tensor(host_value, device)
        nb = int(t.numel() * t.element_size())
        budget = _device_budget_bytes()
        dk = self._dev_key(key, device)
        with self._lock:
            self.uploaded_bytes += nb
            if budget > 0 and dk not in self._dev and not _disabled():
                while self._dev and self.dev_used_bytes + nb > budget:
                    k, _v = self._dev.popitem(last=False)
                    self._dev_forget_locked(k)
                    self.dev_evictions += 1
                self._dev[dk] = t
                self._dev_sizes[dk] = nb
                self._dev_bases[key] = self._dev_bases.get(key, 0) + 1
                self.dev_used_bytes += nb
                self.dev_peak_bytes = max(self.dev_peak_bytes,
                                          self.dev_used_bytes)
            self._note_peak_locked()
        metrics.blockcache_upload_bytes.inc(nb)
        return t

    def count_device(self, outcome: str) -> None:
        """One device lookup's outcome: "hit" (no upload), "upload"
        (host hit, re-staged) or "miss" (decoded)."""
        with self._lock:
            if outcome == "hit":
                self.dev_hits += 1
                self.hits += 1
            else:
                self.dev_misses += 1
                if outcome == "upload":
                    self.hits += 1
                else:
                    self.misses += 1
        metrics.blockcache_ops.inc(
            outcome="miss" if outcome == "miss" else "hit")
        metrics.blockcache_device_ops.inc(outcome=outcome)

    # ----------------------------------------------------------------

    def put(self, key: tuple, value, device=None):
        """Admit a decoded host column to the host tier, and to the
        device tier of `device` when one is named; -> the device tensor
        (or the host array)."""
        value = np.asarray(value)
        self.host_put(key, value)
        if device is None:
            return value
        t = self.dev_get(key, device)
        return t if t is not None else self.upload(key, value, device)

    def contains(self, key: tuple) -> bool:
        """Either-tier presence of `key` (on any device): no counting, no
        upload (the scan's read-ahead decision)."""
        if _disabled():
            return False
        with self._lock:
            return key in self._host or key in self._dev_bases

    def _dev_forget_locked(self, dk: tuple) -> None:
        """Account for device-tier entry `dk` having left the tier."""
        self.dev_used_bytes -= self._dev_sizes.pop(dk)
        base = dk[:-1]
        left = self._dev_bases[base] - 1
        if left:
            self._dev_bases[base] = left
        else:
            del self._dev_bases[base]

    def _note_peak_locked(self) -> None:
        self.peak_bytes = max(self.peak_bytes,
                              self.host_used_bytes + self.dev_used_bytes)

    # ---------------------------------------------------- maintenance

    def drop_path(self, path: str) -> None:
        """Forget every column of one object in both tiers, under every
        file-service token and device: a stale pinned tensor would serve
        a merged-away object's rows."""
        with self._lock:
            for k in [k for k in self._host if k[1] == path]:
                del self._host[k]
                self.host_used_bytes -= self._host_sizes.pop(k)
            for k in [k for k in self._dev if k[1] == path]:
                del self._dev[k]
                self._dev_forget_locked(k)
            self._pending = {k for k in self._pending if k[1] != path}

    def clear(self) -> None:
        with self._lock:
            self._host.clear()
            self._host_sizes.clear()
            self._dev.clear()
            self._dev_sizes.clear()
            self._dev_bases.clear()
            self._pending.clear()
            self.host_used_bytes = 0
            self.dev_used_bytes = 0

    def reset_stats(self) -> None:
        """Zero the counters; entries stay, so the peaks restart at what
        is still resident."""
        with self._lock:
            self.hits = self.misses = 0
            self.dev_hits = self.dev_misses = 0
            self.host_evictions = self.dev_evictions = 0
            self.uploaded_bytes = 0
            self.decode_seconds = 0.0
            self.bytes_fetched = 0
            self.host_peak_bytes = self.host_used_bytes
            self.dev_peak_bytes = self.dev_used_bytes
            self.peak_bytes = self.host_used_bytes + self.dev_used_bytes

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            dev_total = self.dev_hits + self.dev_misses
            return {
                "used_bytes": self.host_used_bytes + self.dev_used_bytes,
                "peak_bytes": self.peak_bytes,
                "budget_bytes": _budget_bytes(),
                "entries": len(self._host),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else None,
                "evictions": self.host_evictions + self.dev_evictions,
                "decode_seconds": round(self.decode_seconds, 4),
                "bytes_fetched": self.bytes_fetched,
                "uploaded_bytes": self.uploaded_bytes,
                "host_tier": {
                    "used_bytes": self.host_used_bytes,
                    "peak_bytes": self.host_peak_bytes,
                    "budget_bytes": _budget_bytes(),
                    "entries": len(self._host),
                    "evictions": self.host_evictions,
                },
                "device_tier": {
                    "used_bytes": self.dev_used_bytes,
                    "peak_bytes": self.dev_peak_bytes,
                    "budget_bytes": _device_budget_bytes(),
                    "entries": len(self._dev),
                    "evictions": self.dev_evictions,
                    "hits": self.dev_hits, "misses": self.dev_misses,
                    "hit_rate": ((self.dev_hits / dev_total)
                                 if dev_total else None),
                    "uploaded_bytes": self.uploaded_bytes,
                },
            }


#: the process-wide cache (the reference keeps one per process)
CACHE = BlockCache()

#: cache keys carry a per-file-service token: two engines of one process
#: may hold DIFFERENT objects at the SAME path on different backends
_fs_token_lock = threading.Lock()
_next_token = itertools.count(1)


def _fs_token(fs) -> int:
    tok = getattr(fs, "_blockcache_token", None)
    if tok is None:
        with _fs_token_lock:
            tok = getattr(fs, "_blockcache_token", None)
            if tok is None:
                tok = next(_next_token)
                fs._blockcache_token = tok
    return tok


class _ObjectSource:
    """One object's column loader, shared by a segment's `arrays` and
    `validity` views, so a miss decodes a column's data and validity
    once, together."""

    def __init__(self, fs, path: str, columns: Tuple[str, ...]):
        self.fs = fs
        self.path = path
        self.columns = columns
        self._tok = _fs_token(fs)
        self._load_lock = threading.Lock()
        self._raw = None          # the parsed header, read once

    def _key(self, col: str, kind: str) -> tuple:
        return (self._tok, self.path, col, kind)

    def _header(self) -> dict:
        if self._raw is None:
            from matrixone_tpu_torch.storage import objectio
            _meta, self._raw = objectio.read_header_ranged(self.fs,
                                                           self.path)
        return self._raw

    def _cached_pair(self, col: str):
        d = CACHE.host_get(self._key(col, "data"), count=False)
        v = CACHE.host_get(self._key(col, "validity"), count=False)
        return (d, v) if d is not None and v is not None else None

    def _decode(self, col: str) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one column into the host tier (under the load lock,
        rechecked: a burst of misses decodes once)."""
        with self._load_lock:
            pair = self._cached_pair(col)
            if pair is not None:
                return pair
            from matrixone_tpu_torch.storage import objectio
            t0 = time.perf_counter()
            raw = self._header()
            if col not in raw["cols"]:
                raise KeyError(f"column {col!r} not in object {self.path}")
            data, valid = objectio.read_column_block(self.fs, self.path,
                                                     raw, col)
            CACHE.host_put(self._key(col, "data"), data)
            CACHE.host_put(self._key(col, "validity"), valid)
            nb = int(data.nbytes) + int(valid.nbytes)
            dt = time.perf_counter() - t0
            with CACHE._lock:
                CACHE.bytes_fetched += nb
                CACHE.decode_seconds += dt
            metrics.blockcache_bytes.inc(nb)
            metrics.decode_seconds.inc(dt)
            return data, valid

    def host(self, col: str, kind: str, count: bool = True) -> np.ndarray:
        """The host array (the host readers' path)."""
        a = CACHE.host_get(self._key(col, kind), count=count)
        if a is not None:
            return a
        data, valid = self._decode(col)
        return data if kind == "data" else valid

    def warm(self, col: str):
        """Decode `col` into the host tier if it is cold in both tiers
        (the read-ahead thread's path: no device, no count) -> the
        decoded (data, validity), or None when it was not cold.  The
        device lookup that first serves it counts the miss."""
        if CACHE.contains(self._key(col, "data")):
            return None
        pair = self._decode(col)
        with CACHE._lock:
            CACHE._pending.add(self._key(col, "data"))
        return pair

    def device(self, col: str, kind: str, device, pair=None
               ) -> torch.Tensor:
        """The tensor on `device` (the scan's path), counted as the
        reference counts a lookup.  A miss decodes and uploads both the
        data and the validity, as the reference's admission does; `pair`,
        the read-ahead's decoded (data, validity), spares a second
        decode when the host tier evicted them meanwhile."""
        key = self._key(col, kind)
        t = CACHE.dev_get(key, device)
        if t is not None:
            CACHE.count_device("hit")
            return t
        dkey = self._key(col, "data")
        with CACHE._lock:
            pending = dkey in CACHE._pending
            CACHE._pending.discard(dkey)
        a = CACHE.host_get(key, count=False)
        if a is not None and not pending:
            CACHE.count_device("upload")
            return CACHE.upload(key, a, device)
        CACHE.count_device("miss")
        if pair is None or self._cached_pair(col) is not None:
            pair = self._decode(col)
        else:                       # evicted since the read-ahead: re-admit
            CACHE.host_put(self._key(col, "data"), pair[0])
            CACHE.host_put(self._key(col, "validity"), pair[1])
        data, valid = pair
        out = None
        for k, a in (("data", data), ("validity", valid)):
            kk = self._key(col, k)
            got = CACHE.dev_get(kk, device)
            if got is None:
                got = CACHE.upload(kk, a, device)
            if k == kind:
                out = got
        return out


class LazyColumns(Mapping):
    """Mapping[str, np.ndarray] over one object's columns, fetched on
    demand through the process cache.  Immutable by contract."""

    def __init__(self, source: _ObjectSource, kind: str):
        self._source = source
        self._kind = kind

    def __getitem__(self, col: str) -> np.ndarray:
        return self._source.host(col, self._kind)

    def __iter__(self) -> Iterator[str]:
        return iter(self._source.columns)

    def __len__(self) -> int:
        return len(self._source.columns)

    def __contains__(self, col) -> bool:
        return col in self._source.columns

    def host(self, col: str, count: bool = True) -> np.ndarray:
        return self._source.host(col, self._kind, count=count)

    def device(self, col: str, device, pair=None) -> torch.Tensor:
        return self._source.device(col, self._kind, device, pair)

    def warm(self, col: str):
        return self._source.warm(col)

    def cold_columns(self, cols) -> list:
        """The columns of `cols` in neither tier (no fetch, no count):
        the scan's read-ahead decision."""
        src = self._source
        return [c for c in cols if c in src.columns
                and not CACHE.contains(src._key(c, self._kind))]


def lazy_pair(fs, path: str, columns) -> Tuple[LazyColumns, LazyColumns]:
    """(arrays, validity) views over one object, sharing a loader."""
    src = _ObjectSource(fs, path, tuple(columns))
    return LazyColumns(src, "data"), LazyColumns(src, "validity")
