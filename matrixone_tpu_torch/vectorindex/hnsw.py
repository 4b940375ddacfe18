"""HNSW index: hierarchical small-world graph, host-side walk.

The port of `matrixone_tpu/vectorindex/hnsw.py` (reference analogue:
`pkg/vectorindex/hnsw/{build,search}.go` over the usearch C++ library).
The graph walk is pointer-chasing and stays on the host, as in the
JAX package: `build` takes the port's own C++ graph
(`native/mo_native.cpp`, `mo_hnsw_*`) when the host library loads, else
the numpy graph of `build_py`, which is also the test oracle.  Neither
touches a device; the SQL layer's Project re-ranks the candidates
exactly, as for IVF.  Distances inside the numpy walk are vectorized
over neighbour blocks.

Standard construction (Malkov & Yashunin 2016): exponential level draw,
greedy descent through upper layers, beam (ef) search per layer,
bidirectional links pruned to M.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HnswIndex:
    vectors: np.ndarray                 # [n, d] f32
    neighbors: List[np.ndarray]         # per level: [n, M_l] int32, -1 pad
    node_level: np.ndarray              # [n] int8
    entry: int
    metric: str = "l2"
    M: int = 16
    ef_construction: int = 64

    @property
    def n(self) -> int:
        return len(self.vectors)

    @property
    def max_level(self) -> int:
        return len(self.neighbors) - 1


def _dists(vectors: np.ndarray, ids: np.ndarray, q: np.ndarray,
           metric: str) -> np.ndarray:
    v = vectors[ids]
    if metric in ("cosine", "ip"):
        return 1.0 - v @ q
    d = v - q
    return np.einsum("nd,nd->n", d, d)


class NativeHnswIndex:
    """Handle to the C++ graph (native/mo_native.cpp mo_hnsw_*), the
    usearch-role walker; ~100x the Python walk at scale.  Same search
    contract as HnswIndex.  The graph is not readable from Python: the
    build's rows and parameters (`seed` included) are what rebuild it,
    and the native build is deterministic for a seed."""

    def __init__(self, handle, n: int, d: int, metric: str, M: int,
                 ef_construction: int, lib, seed: int = 0):
        self._handle = handle
        self._n = n
        self.d = d
        self.metric = metric
        self.M = M
        self.ef_construction = ef_construction
        self.seed = seed
        self._lib = lib

    @property
    def n(self) -> int:
        return self._n

    def search(self, queries: np.ndarray, k: int, ef: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        import ctypes
        qs = np.ascontiguousarray(queries, np.float32)
        nq = len(qs)
        out_i = np.empty((nq, k), np.int64)
        out_d = np.empty((nq, k), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._lib.mo_hnsw_search(
            self._handle, qs.ctypes.data_as(f32p), nq, k, max(ef, k),
            out_i.ctypes.data_as(i64p), out_d.ctypes.data_as(f32p))
        return out_d, out_i

    def __del__(self):
        try:
            self._lib.mo_hnsw_free(self._handle)
        except Exception:           # noqa: BLE001  (interpreter teardown)
            pass


def build(dataset: np.ndarray, M: int = 16, ef_construction: int = 64,
          metric: str = "l2", seed: int = 0, native: bool = True):
    """Native C++ walker when the toolchain built it; the pure-Python
    graph below is the fallback + test oracle."""
    if metric == "ip":
        raise ValueError(
            "hnsw supports l2/cosine; max-inner-product needs an MIPS "
            "transform (normalization would silently rank by cosine)")
    if native and len(dataset):
        from matrixone_tpu_torch import native as N
        lib = N.get_lib()
        if lib is not None and getattr(lib, "mo_has_hnsw", False):
            import ctypes
            data = np.ascontiguousarray(dataset, np.float32)
            n, d = data.shape
            f32p = ctypes.POINTER(ctypes.c_float)
            handle = lib.mo_hnsw_build(
                data.ctypes.data_as(f32p), n, d, M, ef_construction,
                1 if metric == "cosine" else 0, seed)
            return NativeHnswIndex(handle, n, d, metric, M,
                                   ef_construction, lib, seed)
    return build_py(dataset, M=M, ef_construction=ef_construction,
                    metric=metric, seed=seed)


def build_py(dataset: np.ndarray, M: int = 16, ef_construction: int = 64,
             metric: str = "l2", seed: int = 0) -> HnswIndex:
    data = np.ascontiguousarray(dataset, np.float32)
    if metric in ("cosine",):
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        data = data / np.maximum(norms, 1e-30)
    n, d = data.shape
    if n == 0:
        return HnswIndex(vectors=data, neighbors=[np.zeros((0, 2 * M),
                                                           np.int32)],
                         node_level=np.zeros(0, np.int8), entry=-1,
                         metric=metric, M=M,
                         ef_construction=ef_construction)
    rng = np.random.default_rng(seed)
    mult = 1.0 / np.log(M)
    levels = np.minimum((-np.log(rng.random(n)) * mult).astype(np.int64), 8)
    max_level = int(levels.max()) if n else 0
    M0 = 2 * M
    neighbors = [np.full((n, M0 if lv == 0 else M), -1, np.int32)
                 for lv in range(max_level + 1)]
    counts = [np.zeros(n, np.int32) for _ in range(max_level + 1)]
    entry = 0

    def search_layer(q, ep, ef, lv):
        visited = {ep}
        d0 = float(_dists(data, np.asarray([ep]), q, metric)[0])
        cand = [(d0, ep)]                 # min-heap to expand
        best = [(-d0, ep)]                # max-heap of ef best
        while cand:
            dc, c = heapq.heappop(cand)
            if dc > -best[0][0] and len(best) >= ef:
                break
            nbrs = neighbors[lv][c][:counts[lv][c]]
            fresh = [x for x in nbrs.tolist() if x not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            ds = _dists(data, np.asarray(fresh), q, metric)
            for x, dx in zip(fresh, ds.tolist()):
                if len(best) < ef or dx < -best[0][0]:
                    heapq.heappush(cand, (dx, x))
                    heapq.heappush(best, (-dx, x))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-nd, x) for nd, x in best)

    def select_heuristic(base_vec, cand_ids, cap):
        """Malkov Alg.4 diversity heuristic: keep a candidate only if it is
        closer to the base than to every already-kept neighbor — without
        this, clustered data packs all links inside one cluster and the
        graph stops being navigable across clusters."""
        # Alg.4 requires nearest-first processing: always sort
        order = np.argsort(_dists(data, cand_ids, base_vec, metric))
        cand_ids = cand_ids[order]
        kept: List[int] = []
        d_base = _dists(data, cand_ids, base_vec, metric)
        for ci, db in zip(cand_ids.tolist(), d_base.tolist()):
            if len(kept) >= cap:
                break
            if kept:
                d_kept = _dists(data, np.asarray(kept), data[ci], metric)
                if (d_kept < db).any():
                    continue
            kept.append(ci)
        # backfill with nearest remaining if the heuristic was too strict
        if len(kept) < min(cap, len(cand_ids)):
            for ci in cand_ids.tolist():
                if len(kept) >= cap:
                    break
                if ci not in kept:
                    kept.append(ci)
        return np.asarray(kept, np.int32)

    def connect(node, picks, lv):
        cap = neighbors[lv].shape[1]
        sel = select_heuristic(data[node], picks, cap)
        neighbors[lv][node, :len(sel)] = sel
        counts[lv][node] = len(sel)
        for p in sel:                    # bidirectional + prune
            cnt = counts[lv][p]
            if cnt < cap:
                neighbors[lv][p, cnt] = node
                counts[lv][p] = cnt + 1
            else:
                ids = np.concatenate([neighbors[lv][p][:cnt],
                                      [node]]).astype(np.int32)
                keep = select_heuristic(data[p], ids, cap)
                neighbors[lv][p, :len(keep)] = keep
                neighbors[lv][p, len(keep):] = -1
                counts[lv][p] = len(keep)

    for i in range(1, n):
        q = data[i]
        lv_i = int(levels[i])
        ep = entry
        for lv in range(int(levels[entry]), lv_i, -1):
            res = search_layer(q, ep, 1, lv)
            ep = res[0][1]
        for lv in range(min(lv_i, int(levels[entry])), -1, -1):
            res = search_layer(q, ep, ef_construction, lv)
            picks = np.asarray([x for _, x in res], np.int32)
            connect(i, picks, lv)
            ep = res[0][1]
        if lv_i > levels[entry]:
            entry = i

    return HnswIndex(vectors=data, neighbors=neighbors,
                     node_level=levels.astype(np.int8), entry=entry,
                     metric=metric, M=M, ef_construction=ef_construction)


def search(index, queries: np.ndarray, k: int = 10,
           ef: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """-> (distances [b,k], positions [b,k]); walk per query on host."""
    if isinstance(index, NativeHnswIndex):
        return index.search(queries, k, ef)
    qs = np.ascontiguousarray(queries, np.float32)
    if index.n == 0 or index.entry < 0:
        return (np.zeros((len(qs), 0), np.float32),
                np.zeros((len(qs), 0), np.int64))
    if index.metric in ("cosine",):
        qs = qs / np.maximum(np.linalg.norm(qs, axis=1, keepdims=True),
                             1e-30)
    data = index.vectors
    nbrs = index.neighbors
    out_d = np.full((len(qs), k), np.inf, np.float32)
    out_i = np.full((len(qs), k), -1, np.int64)

    for bi, q in enumerate(qs):
        ep = index.entry
        for lv in range(index.max_level, 0, -1):
            improved = True
            dep = float(_dists(data, np.asarray([ep]), q, index.metric)[0])
            while improved:
                improved = False
                cand = nbrs[lv][ep]
                cand = cand[cand >= 0]
                if len(cand) == 0:
                    break
                ds = _dists(data, cand, q, index.metric)
                j = int(np.argmin(ds))
                if ds[j] < dep:
                    dep = float(ds[j])
                    ep = int(cand[j])
                    improved = True
        # beam at layer 0
        visited = {ep}
        d0 = float(_dists(data, np.asarray([ep]), q, index.metric)[0])
        cand_heap = [(d0, ep)]
        best = [(-d0, ep)]
        while cand_heap:
            dc, c = heapq.heappop(cand_heap)
            if dc > -best[0][0] and len(best) >= ef:
                break
            neigh = nbrs[0][c]
            neigh = neigh[neigh >= 0]
            fresh = [x for x in neigh.tolist() if x not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            ds = _dists(data, np.asarray(fresh), q, index.metric)
            for x, dx in zip(fresh, ds.tolist()):
                if len(best) < ef or dx < -best[0][0]:
                    heapq.heappush(cand_heap, (dx, x))
                    heapq.heappush(best, (-dx, x))
                    if len(best) > ef:
                        heapq.heappop(best)
        top = sorted((-nd, x) for nd, x in best)[:k]
        for j, (dx, x) in enumerate(top):
            out_d[bi, j] = dx
            out_i[bi, j] = x
    return out_d, out_i
