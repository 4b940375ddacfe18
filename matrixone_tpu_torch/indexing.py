"""Index build/refresh shared by DDL and the scan operators.

The port of `matrixone_tpu/indexing.py` (reference analogue: the iscp
IndexSync consumer + idxcron re-clustering, `pkg/iscp`,
`pkg/vectorindex/idxcron`).  Commits mark dependent indexes dirty
(engine.commit_txn) and the next index-accelerated query refreshes
lazily.  IVF-Flat and IVF-PQ refresh incrementally: rows inserted since
the last build go to a delta segment that the search scans exactly, and
past `RECLUSTER_FRACTION` of the indexed rows the index is built again.
HNSW (a host graph) and FULLTEXT (BM25 postings on the device) refresh
by a full rebuild, as in the JAX package.  An index is built on the
device the caller names (a session's), and refreshed where it lies.

Not ported yet (ROADMAP.md, section A, step 5):
`register_recluster_task`, which needs the task service.
"""

from __future__ import annotations

import numpy as np

from matrixone_tpu_torch.storage.engine import Engine, IndexMeta
from matrixone_tpu_torch.vectorindex.ivf_pq import pick_subspaces

#: delta fraction beyond which a dirty refresh falls back to a full
#: recluster (reference: idxcron re-clustering policy)
RECLUSTER_FRACTION = 0.1


def _index_device(ix: IndexMeta, device):
    """`device`, else where the last build lay (the meta remembers it
    across an eviction), else CUDA; remembered on the meta."""
    from matrixone_tpu_torch import resolve_device
    dev = resolve_device(device if device is not None
                         else ix.options.get("_device"))
    ix.options["_device"] = dev
    return dev


def build_ivfflat(engine: Engine, ix: IndexMeta, device=None) -> None:
    """Build an IVF-Flat or IVF-PQ index (`ix.algo`) over the table's
    visible rows, on `device`, else where the last build lay (the meta
    remembers it across an eviction), else CUDA."""
    from matrixone_tpu_torch.vectorindex import ivf_flat, ivf_pq
    dev = _index_device(ix, device)
    table = engine.get_table(ix.table)
    data, gids = table.read_column_f32(ix.columns[0])
    if len(data) == 0:
        ix.index_obj = None            # empty table: nothing to index yet
        ix.options["_row_gids"] = gids
        ix.dirty = False
        return
    nlist = int(ix.options.get("lists", 64))
    metric = ix.options.get("_metric", "l2")
    nlist = max(1, min(nlist, max(1, len(data))))
    if ix.algo == "ivfpq":
        d = data.shape[1]
        m = int(ix.options.get("subspaces", 0)) or pick_subspaces(d)
        if d % m != 0:
            raise ValueError(f"dim {d} must divide into n_subspaces={m}")
        ix.index_obj = ivf_pq.build(data, nlist=nlist, n_subspaces=m,
                                    metric=metric, device=dev)
    else:
        ix.index_obj = ivf_flat.build(data, nlist=nlist, metric=metric,
                                      device=dev)
    ix.options["_row_gids"] = gids
    ix.options.pop("_delta_vecs", None)
    ix.options.pop("_delta_gids", None)
    ix.dirty = False


def build_hnsw(engine: Engine, ix: IndexMeta, device=None) -> None:
    """Build an HNSW graph over the table's visible rows.  The graph is
    host memory (the walk stays on the host, as in the JAX package), so
    `device` is not used."""
    from matrixone_tpu_torch.vectorindex import hnsw
    table = engine.get_table(ix.table)
    data, gids = table.read_column_f32(ix.columns[0])
    if len(data) == 0:
        ix.index_obj = None
        ix.options["_row_gids"] = gids
        ix.dirty = False
        return
    m = int(ix.options.get("m", 16))
    ef_c = int(ix.options.get("ef_construction", 64))
    metric = ix.options.get("_metric", "l2")
    ix.index_obj = hnsw.build(np.asarray(data), M=m, ef_construction=ef_c,
                              metric=metric)
    ix.options["_row_gids"] = gids
    ix.options.pop("_delta_vecs", None)
    ix.options.pop("_delta_gids", None)
    ix.dirty = False


def build_fulltext(engine: Engine, ix: IndexMeta, device=None) -> None:
    """Build the BM25 index of the table's visible rows on `device`
    (see `_index_device`).  A multi-column index indexes the columns'
    texts joined by a space, as the JAX package does."""
    from matrixone_tpu_torch import fulltext as FT
    dev = _index_device(ix, device)
    table = engine.get_table(ix.table)
    texts = None
    gids = None
    for col in ix.columns:
        col_texts, col_gids = table.read_texts(col)
        if texts is None:
            texts, gids = col_texts, col_gids
        else:
            texts = [" ".join(t for t in (a, b) if t) or None
                     for a, b in zip(texts, col_texts)]
    ix.index_obj = FT.build(texts or [], device=dev)
    ix.options["_row_gids"] = gids if gids is not None \
        else np.zeros(0, np.int64)
    ix.options.pop("_delta_vecs", None)
    ix.options.pop("_delta_gids", None)
    ix.dirty = False


#: the build function of each index kind
BUILD_FNS = {"ivfflat": build_ivfflat, "ivfpq": build_ivfflat,
            "hnsw": build_hnsw, "fulltext": build_fulltext}


def refresh_if_dirty(engine: Engine, ix: IndexMeta, device=None) -> None:
    if not ix.dirty:
        return
    # under the commit lock: a concurrent commit must not set dirty=True
    # between our table read and the trailing dirty=False (lost update)
    with engine._commit_lock:
        if not ix.dirty:
            return
        if ix.algo not in ("ivfflat", "ivfpq") or \
                not _try_incremental(engine, ix):
            BUILD_FNS[ix.algo](engine, ix, device)
        register_in_cache(engine, ix)


def _try_incremental(engine: Engine, ix: IndexMeta) -> bool:
    """Incremental refresh (reference: iscp IndexSync feed): rows INSERTED
    since the last build land in a brute-force delta segment the search
    path scans exactly; DELETEs need no index change (visible_gids filters
    dead candidates at search).  Falls back to a full recluster when the
    delta outgrows RECLUSTER_FRACTION of the indexed rows (idxcron role)
    or when gids were rewritten (table merge)."""
    if ix.index_obj is None:
        return False
    table = engine.get_table(ix.table)
    data, gids = table.read_column_f32(ix.columns[0])
    base = np.asarray(ix.options.get("_row_gids", np.zeros(0, np.int64)))
    dgids = np.asarray(ix.options.get("_delta_gids",
                                      np.zeros(0, np.int64)))
    known = np.union1d(base, dgids)
    new_mask = ~np.isin(gids, known)
    n_new = int(new_mask.sum())
    if n_new == 0:
        ix.dirty = False
        return True
    if n_new + len(dgids) > RECLUSTER_FRACTION * max(len(base), 1):
        return False
    new_vecs = np.asarray(data)[new_mask]
    old = ix.options.get("_delta_vecs")
    ix.options["_delta_vecs"] = (new_vecs if old is None or not len(old)
                                 else np.concatenate([old, new_vecs]))
    ix.options["_delta_gids"] = np.concatenate([dgids, gids[new_mask]])
    ix.dirty = False
    return True


def fold_delta(engine: Engine, ix: IndexMeta, device=None) -> bool:
    """Full recluster folding the delta back in (the idxcron background
    job body).  Returns True when a rebuild happened."""
    with engine._commit_lock:
        has_delta = len(ix.options.get("_delta_gids", ())) > 0
        if not (ix.dirty or has_delta):
            return False
        BUILD_FNS[ix.algo](engine, ix, device)
        register_in_cache(engine, ix)
        return True


def register_in_cache(engine: Engine, ix: IndexMeta) -> None:
    if ix.index_obj is not None:
        engine.index_cache.put(ix)
