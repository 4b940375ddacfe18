"""Host library of the port: ctypes bindings over its own `mo_native.cpp`.

The port's counterpart of `matrixone_tpu/native/__init__.py`, for the
parts the port calls: 64-bit hashing (the splitmix64 of ops/hash.py,
bit for bit), the blocked bloom filter (the primary-key check of
storage/engine.py), sorted-set membership, the roaring bitmap (the
scan's tombstone filter) and the HNSW graph (`mo_hnsw_*`, the walk of
vectorindex/hnsw.py; `mo_has_hnsw` says whether the loaded library
has it).  The C++ source is the port's own copy
(`matrixone_tpu_torch/native/mo_native.cpp`), compiled with g++ at first
use into `build/torch_native/` of the checkout; where no compiler
works, the same numpy fallbacks as the JAX package's answer instead.
`route()` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mo_native.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
_SO = os.path.join(_BUILD_DIR, "libmo_native.so")

_lib = None
_lock = threading.Lock()
_tried = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, OSError):
        # compiler missing/failed/timed out: numpy fallback paths apply
        return False


def get_lib():
    """The loaded library, or None (numpy fallback paths apply)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mo_hash64_i64.argtypes = [i64p, ctypes.c_size_t, u64p]
        lib.mo_bloom_add.argtypes = [u64p, ctypes.c_size_t, u8p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.mo_bloom_probe.argtypes = [u64p, ctypes.c_size_t, u8p,
                                       ctypes.c_uint64, ctypes.c_int, u8p]
        lib.mo_sorted_contains.argtypes = [i64p, ctypes.c_size_t, i64p,
                                           ctypes.c_size_t, u8p]
        lib.mo_rbm_create.restype = ctypes.c_void_p
        lib.mo_rbm_free.argtypes = [ctypes.c_void_p]
        lib.mo_rbm_add.argtypes = [ctypes.c_void_p, i64p, ctypes.c_size_t]
        lib.mo_rbm_test.argtypes = [ctypes.c_void_p, i64p,
                                    ctypes.c_size_t, u8p]
        lib.mo_rbm_test_range.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64, u8p]
        lib.mo_rbm_count.restype = ctypes.c_int64
        lib.mo_rbm_count.argtypes = [ctypes.c_void_p]
        lib.mo_rbm_bytes.restype = ctypes.c_int64
        lib.mo_rbm_bytes.argtypes = [ctypes.c_void_p]
        lib.mo_rbm_and.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mo_rbm_or.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mo_rbm_to_array.restype = ctypes.c_int64
        lib.mo_rbm_to_array.argtypes = [ctypes.c_void_p, i64p,
                                        ctypes.c_int64]
        try:        # an older cached .so may predate the HNSW symbols
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.mo_hnsw_build.restype = ctypes.c_void_p
            lib.mo_hnsw_build.argtypes = [f32p, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_uint64]
            lib.mo_hnsw_search.argtypes = [ctypes.c_void_p, f32p,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, i64p, f32p]
            lib.mo_hnsw_n.restype = ctypes.c_int64
            lib.mo_hnsw_n.argtypes = [ctypes.c_void_p]
            lib.mo_hnsw_free.argtypes = [ctypes.c_void_p]
            lib.mo_has_hnsw = True
        except AttributeError:
            lib.mo_has_hnsw = False
        _lib = lib
        return _lib


def route() -> str:
    """"c" when the compiled library serves the calls, else "numpy"."""
    return "c" if get_lib() is not None else "numpy"


def _p(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


# ------------------------------------------------------------------ hashing

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + _GOLDEN
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def hash64(values: np.ndarray) -> np.ndarray:
    """splitmix64 over int64 values -> uint64, bit-identical to the
    device's ops/hash.py."""
    values = np.ascontiguousarray(values, np.int64)
    lib = get_lib()
    out = np.empty(len(values), np.uint64)
    if lib is not None:
        lib.mo_hash64_i64(_p(values, ctypes.c_int64), len(values),
                          _p(out, ctypes.c_uint64))
        return out
    return _splitmix_np(values.view(np.uint64))


# ------------------------------------------------------------- bloom filter

class BloomFilter:
    """k probes derived from one 64-bit hash (double hashing) into a bit
    array of `bits_per_item` bits per expected item (reference:
    common/bloomfilter): no false negatives."""

    def __init__(self, n_items: int, bits_per_item: int = 10, k: int = 4):
        nbits = max(64, n_items * bits_per_item)
        self.nbits = int(nbits)
        self.k = k
        self.bits = np.zeros((self.nbits + 7) // 8, np.uint8)

    def add_hashes(self, hashes: np.ndarray):
        hashes = np.ascontiguousarray(hashes, np.uint64)
        lib = get_lib()
        if lib is not None:
            lib.mo_bloom_add(_p(hashes, ctypes.c_uint64), len(hashes),
                             _p(self.bits, ctypes.c_uint8), self.nbits,
                             self.k)
            return
        h2 = _splitmix_np(hashes)
        for j in range(self.k):
            with np.errstate(over="ignore"):
                bit = (hashes + np.uint64(j) * h2) % np.uint64(self.nbits)
            np.bitwise_or.at(self.bits,
                             (bit >> np.uint64(3)).astype(np.int64),
                             (np.uint8(1) << (bit & np.uint64(7)))
                             .astype(np.uint8))

    def probe_hashes(self, hashes: np.ndarray) -> np.ndarray:
        hashes = np.ascontiguousarray(hashes, np.uint64)
        lib = get_lib()
        out = np.empty(len(hashes), np.uint8)
        if lib is not None:
            lib.mo_bloom_probe(_p(hashes, ctypes.c_uint64), len(hashes),
                               _p(self.bits, ctypes.c_uint8), self.nbits,
                               self.k, _p(out, ctypes.c_uint8))
            return out.astype(bool)
        hit = np.ones(len(hashes), bool)
        h2 = _splitmix_np(hashes)
        for j in range(self.k):
            with np.errstate(over="ignore"):
                bit = (hashes + np.uint64(j) * h2) % np.uint64(self.nbits)
            hit &= (self.bits[(bit >> np.uint64(3)).astype(np.int64)]
                    >> (bit & np.uint64(7)).astype(np.uint8)) & 1 > 0
        return hit

    def add_int64(self, values: np.ndarray):
        self.add_hashes(hash64(values))

    def probe_int64(self, values: np.ndarray) -> np.ndarray:
        return self.probe_hashes(hash64(values))


def sorted_contains(haystack: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Membership of ids in a sorted haystack."""
    haystack = np.ascontiguousarray(haystack, np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(ids), np.uint8)
        lib.mo_sorted_contains(_p(haystack, ctypes.c_int64), len(haystack),
                               _p(ids, ctypes.c_int64), len(ids),
                               _p(out, ctypes.c_uint8))
        return out.astype(bool)
    if not len(haystack):
        return np.zeros(len(ids), bool)
    pos = np.searchsorted(haystack, ids)
    pos_c = np.clip(pos, 0, len(haystack) - 1)
    return (pos < len(haystack)) & (haystack[pos_c] == ids)


# --------------------------------------------------------- roaring bitmap

class RoaringBitmap:
    """Compressed id set: ids bucketed by their high bits, each bucket a
    sorted 16-bit array (sparse) or a 64-Kbit bitmap (dense).  The scan's
    tombstone filter: the answers of a dense bitset at a fraction of its
    memory when few rows are dead.  Without the library, a sorted numpy
    array (searchsorted membership)."""

    def __init__(self, ids=None):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.mo_rbm_create()
        else:
            self._sorted = np.zeros(0, np.int64)
        if ids is not None and len(ids):
            self.add(ids)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.mo_rbm_free(self._h)
            self._h = None

    def add(self, ids) -> None:
        ids = np.ascontiguousarray(ids, np.int64)
        if self._lib is not None:
            self._lib.mo_rbm_add(self._h, _p(ids, ctypes.c_int64),
                                 len(ids))
        else:
            self._sorted = np.union1d(self._sorted, ids[ids >= 0])

    def test(self, ids) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64)
        if self._lib is not None:
            out = np.zeros(len(ids), np.uint8)
            self._lib.mo_rbm_test(self._h, _p(ids, ctypes.c_int64),
                                  len(ids), _p(out, ctypes.c_uint8))
            return out.astype(np.bool_)
        return np.isin(ids, self._sorted)

    def test_range(self, lo: int, hi: int) -> np.ndarray:
        """Membership of every id in [lo, hi) (a scan chunk's gids are
        contiguous)."""
        n = max(int(hi) - int(lo), 0)
        if self._lib is not None:
            out = np.zeros(n, np.uint8)
            self._lib.mo_rbm_test_range(self._h, int(lo), int(hi),
                                        _p(out, ctypes.c_uint8))
            return out.astype(np.bool_)
        i0, i1 = np.searchsorted(self._sorted, [lo, hi])
        out = np.zeros(n, np.bool_)
        out[self._sorted[i0:i1] - lo] = True
        return out

    def _to_numpy(self, ids: np.ndarray) -> None:
        """Leave the library: hold `ids` as the sorted fallback array."""
        if self._lib is not None:
            self._lib.mo_rbm_free(self._h)
            self._h = None
            self._lib = None
        self._sorted = ids

    def and_(self, other: "RoaringBitmap") -> None:
        if self._lib is not None and other._lib is not None:
            self._lib.mo_rbm_and(self._h, other._h)
        else:
            self._to_numpy(np.intersect1d(self.to_array(),
                                          other.to_array()))

    def or_(self, other: "RoaringBitmap") -> None:
        if self._lib is not None and other._lib is not None:
            self._lib.mo_rbm_or(self._h, other._h)
        else:
            self._to_numpy(np.union1d(self.to_array(), other.to_array()))

    def count(self) -> int:
        if self._lib is not None:
            return int(self._lib.mo_rbm_count(self._h))
        return len(self._sorted)

    def nbytes(self) -> int:
        """Memory the set holds."""
        if self._lib is not None:
            return int(self._lib.mo_rbm_bytes(self._h))
        return int(self._sorted.nbytes)

    def to_array(self) -> np.ndarray:
        if self._lib is None:
            return self._sorted.copy()
        n = self.count()
        out = np.empty(n, np.int64)
        got = self._lib.mo_rbm_to_array(self._h, _p(out, ctypes.c_int64),
                                        n)
        return out[:got]
