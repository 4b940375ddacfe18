"""Vector-index scan operator (reference: colexec/table_function/
ivf_search.go + vectorindex/ivfflat/search.go).

The port of `matrixone_tpu/vm/vector_scan.py`.  An IVF index is a
dataclass of tensors on its device and the search is the port's batched
`ivf_flat.search` / `ivf_pq.search` (the L2 kernel in the probe, the ADC
kernel's list form in IVF-PQ's scoring); under `SET ivf_shards = N`
(MO_IVF_SHARDS) an IVF-Flat search runs cluster-sharded over N slots
of the mesh (`vectorindex/sharded.py`, the repack cached on the index's
options); an HNSW index is a host graph
walked on the host (`vectorindex/hnsw.search`, ef = max(64, 2k)).
Candidate rows are fetched by row id on the host and re-enter the
pipeline on the context's device; the exact re-rank is the Project's.  The operator is a source that syncs with the host
(top-k, the `pos >= 0` mask, row ids to numpy, `fetch_rows`), so no
fused step contains it: the fragments above it start from its batch.

Txn-workspace caveat: the planner only applies the index rewrite outside
transactions (sql/optimize.apply_indices skip_tables): in-txn queries
take the exact scan path, which merges the workspace.  Committed rows
past the statement's snapshot and deletes ARE handled here via
MVCCTable.visible_gids.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.vm.exprs import ExecBatch
from matrixone_tpu_torch.vm.operators import Operator, chunk_to_execbatch


def ivf_shards(variables, index) -> int:
    """The shard count a query asks for (`SET ivf_shards = N`, or the
    MO_IVF_SHARDS default), cut to the mesh's slots and the lists there
    are, as the reference cuts it to its devices."""
    from matrixone_tpu_torch.parallel import mesh as MS
    want = (variables or {}).get("ivf_shards",
                                 os.environ.get("MO_IVF_SHARDS", 0))
    try:
        want = int(want)
    except (TypeError, ValueError):
        return 0
    return min(want, len(MS.devices(index.device)), index.nlist)


def sharded_view(ix, index, shards: int):
    """The cluster-sharded repack of `index` over `shards` slots, cached
    on the IndexMeta as (index, shards, sharded index): a refresh or a
    recluster swaps `index_obj`, which invalidates it (the identity is
    compared, not the id, so an id reused after a free cannot alias)."""
    cached = ix.options.get("_sharded")
    if cached is not None and cached[0] is index and cached[1] == shards:
        return cached[2]
    from matrixone_tpu_torch.parallel.mesh import make_mesh
    from matrixone_tpu_torch.vectorindex import sharded as shmod
    sidx = shmod.shard_ivf(index, make_mesh(shards, device=index.device))
    ix.options["_sharded"] = (index, shards, sidx)
    return sidx


def delta_distances(ix, q: torch.Tensor, delta_vecs) -> np.ndarray:
    """Exact distances of the delta segment's rows to the one query
    q [1, d], commensurate with what the index's search returns:
    ivfflat gives squared l2 | 1 - cos | 1 - ip; ivfpq under cosine
    gives squared l2 of the NORMALISED vectors (= 2 (1 - cos)).  The
    squared l2 is the L2 kernel on the card."""
    from matrixone_tpu_torch.ops import distance as D
    dv = torch.as_tensor(np.asarray(delta_vecs, np.float32),
                         device=q.device)
    metric = ix.options.get("_metric", "l2")
    if metric == "l2":
        dd = D.l2_distance_sq(dv, q)[:, 0]
    elif metric == "cosine":
        if ix.algo == "ivfpq":
            dd = D.l2_distance_sq(D.normalize(dv), D.normalize(q))[:, 0]
        else:
            dd = 1.0 - D.inner_product(D.normalize(dv), D.normalize(q))[:, 0]
    else:                              # ip: search returns 1 - x.q
        dd = 1.0 - D.inner_product(dv, q)[:, 0]
    return dd.cpu().numpy()


class VectorTopKOp(Operator):
    def __init__(self, node: P.VectorTopK, ctx):
        self.node = node
        self.ctx = ctx
        self.schema = node.schema

    def _ivf_search(self, ix, index, row_gids):
        """(gids, distances, query tensor) of the IVF-Flat / IVF-PQ
        search of the node's query on the index's device."""
        from matrixone_tpu_torch.vectorindex import ivf_flat, ivf_pq
        q = torch.as_tensor(
            np.asarray([self.node.query_vector], dtype=np.float32),
            device=index.device)
        nprobe = min(self.node.nprobe, index.nlist)
        pool = nprobe * index.max_cluster_size
        k = min(self.node.k, index.n, pool) or 1
        shards = (ivf_shards(self.ctx.variables, index)
                  if ix.algo == "ivfflat" else 0)
        if shards >= 2:
            from matrixone_tpu_torch.vectorindex import sharded as shmod
            dists, pos = shmod.search_sharded(
                sharded_view(ix, index, shards), q, k=k, nprobe=nprobe)
        else:
            search_fn = (ivf_pq.search if ix.algo == "ivfpq"
                         else ivf_flat.search)
            dists, pos = search_fn(index, q, k=k, nprobe=nprobe)
        main_d = dists[0].cpu().numpy()
        pos = pos[0].cpu().numpy()
        keep = pos >= 0
        return row_gids[pos[keep]], main_d[keep], q

    def execute(self) -> Iterator[ExecBatch]:
        from matrixone_tpu_torch import indexing
        from matrixone_tpu_torch.vectorindex import hnsw
        catalog = self.ctx.catalog
        ix = catalog.indexes[self.node.index_name]
        # snapshot index + delta under the commit lock: a fold mutates
        # both at once, and a concurrent cache eviction mid-read must
        # retry the refresh instead of yielding an empty result
        for _ in range(8):
            indexing.refresh_if_dirty(catalog, ix, self.ctx.device)
            with catalog._commit_lock:
                if ix.dirty:
                    continue
                index = ix.index_obj
                row_gids = np.asarray(ix.options["_row_gids"])
                delta_vecs = ix.options.get("_delta_vecs")
                delta_gids = (np.asarray(ix.options["_delta_gids"])
                              if delta_vecs is not None and len(delta_vecs)
                              else None)
                break
        else:
            raise RuntimeError(
                f"index {ix.name} kept getting evicted/dirtied; raise the "
                f"index cache budget")
        catalog.index_cache.touch(ix)
        table = catalog.get_table(self.node.table)

        if index is None:        # index over an empty table
            arrays, validity = table.fetch_rows(
                np.zeros(0, np.int64), self.node.columns)
            yield chunk_to_execbatch(arrays, validity, table.dicts, 0,
                                     self.node.columns, self.node.schema,
                                     self.ctx.device)
            return

        if ix.algo == "hnsw":
            # the graph walk is host work; HNSW keeps no delta (every
            # refresh rebuilds it)
            k = min(self.node.k, index.n) or 1
            _d, pos2 = hnsw.search(
                index, np.asarray([self.node.query_vector], np.float32),
                k=k, ef=max(64, 2 * k))
            keep = pos2[0] >= 0
            gids = row_gids[pos2[0][keep]]
        else:
            gids, main_d, q = self._ivf_search(ix, index, row_gids)
        # delta segment: rows inserted since the last full build are
        # scanned exactly and merged by distance (indexing._try_incremental)
        if delta_gids is not None:
            dd = delta_distances(ix, q, delta_vecs)
            all_d = np.concatenate([main_d, dd])
            all_g = np.concatenate([gids, delta_gids])
            order = np.argsort(all_d)[:self.node.k]
            gids = all_g[order]
        read_args = self.ctx.table_read_args(self.node.table)
        gids = table.visible_gids(
            gids, snapshot_ts=self.ctx.snapshot_ts,
            extra_deletes=read_args.get("extra_deletes"))
        arrays, validity = table.fetch_rows(gids, self.node.columns)
        yield chunk_to_execbatch(arrays, validity, table.dicts, len(gids),
                                 self.node.columns, self.node.schema,
                                 self.ctx.device)
