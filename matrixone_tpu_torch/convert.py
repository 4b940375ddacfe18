"""Carry indexes and tables built by the JAX package across to the port.

`ivf_flat_from_numpy` and `ivf_pq_from_numpy` take the numpy view of a
JAX `IvfFlatIndex` or `IvfPqIndex` (each array field through
`np.asarray`, plus `metric`, `max_cluster_size` and `n`) and return the
port's index of the same kind on a device, field by field and bit for
bit, so both packages can search the same index.  JAX's bf16 arrays come
out of numpy as `ml_dtypes.bfloat16`; they are carried bit for bit
through a uint16 view, so `ml_dtypes` is needed only by the caller that
made them.

`tables_to_numpy` reads the tables of an engine (the JAX package's or
the port's: it only reads attributes) as plain schemas, numpy segments
with their commit timestamps and global row ids, tombstones,
dictionaries, counters and the engine's named snapshots;
`tables_from_numpy` places them in a port engine as they are, segment
for segment and code for code, merge fences included, so both engines
hold the same rows in the same order and give the same view at every
timestamp (`AS OF` reads included, before a merge too).

`indexes_to_numpy` reads an engine's secondary indexes (IVF-Flat,
IVF-PQ, HNSW and FULLTEXT) with their built index as numpy fields, their
row gids and delta segment; `indexes_from_numpy` registers them in a
port engine holding the same tables, each index on a device, so both
sessions search the same lists, graphs and postings.
"""

from __future__ import annotations

import numpy as np
import torch

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.storage.engine import (Engine, IndexMeta,
                                                MergeFence, Segment,
                                                TableMeta, schema_from_json,
                                                schema_to_json)
from matrixone_tpu_torch.storage.partition import PartitionSpec
from matrixone_tpu_torch.vectorindex.ivf_flat import IvfFlatIndex
from matrixone_tpu_torch.vectorindex.ivf_pq import IvfPqIndex

IVF_FLAT_FIELDS = ("centroids", "vectors", "r_norm2", "r_dot_c", "ids",
                   "offsets")
IVF_PQ_FIELDS = ("centroids", "codebooks", "codes", "ids", "offsets")


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """numpy array -> tensor on `device` (CUDA unless named), bf16
    (`ml_dtypes.bfloat16`) included."""
    dev = resolve_device(device)
    # a JAX array's numpy view is read-only: copy it, once, if so
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _from_numpy(cls, names, fields: dict, device):
    tensors = {f: tensor_from_numpy(fields[f], device) for f in names}
    return cls(metric=str(fields["metric"]),
               max_cluster_size=int(fields["max_cluster_size"]),
               n=int(fields["n"]), **tensors)


def ivf_flat_from_numpy(fields: dict, device=None) -> IvfFlatIndex:
    """`fields` maps centroids, vectors, r_norm2, r_dot_c, ids, offsets
    to arrays and metric, max_cluster_size, n to their values."""
    return _from_numpy(IvfFlatIndex, IVF_FLAT_FIELDS, fields, device)


SHARDED_IVF_FIELDS = ("owner", "local_slot", "vectors", "r_norm2",
                      "r_dot_c", "ids", "local_offsets")


def sharded_ivf_from_numpy(fields: dict, mesh):
    """The reference's ShardedIvfIndex arrays (centroids, owner,
    local_slot [nlist]; vectors, r_norm2, r_dot_c, ids [S, rows]; and
    local_offsets [S, L + 1], bf16 included) and metric,
    max_cluster_size, n, as the port's index over `mesh`'s S slots."""
    from matrixone_tpu_torch.vectorindex import sharded
    cpu = "cpu"
    packed = {f: tensor_from_numpy(fields[f], cpu)
              for f in SHARDED_IVF_FIELDS}
    return sharded.from_packing(
        tensor_from_numpy(fields["centroids"], mesh.slots[0]), packed,
        str(fields["metric"]), int(fields["max_cluster_size"]),
        int(fields["n"]), mesh)


def sharded_ivf_to_numpy(sidx) -> dict:
    """The port's ShardedIvfIndex as the reference's arrays (each slot's
    arrays stacked in slot order; bf16 vectors as float32) and values."""
    out = {f: np.stack([(t.float() if t.dtype == torch.bfloat16 else t)
                        .cpu().numpy() for t in getattr(sidx, f)])
           for f in ("vectors", "r_norm2", "r_dot_c", "ids",
                     "local_offsets")}
    for f in ("centroids", "owner", "local_slot"):
        out[f] = getattr(sidx, f)[0].cpu().numpy()
    out.update(metric=sidx.metric, max_cluster_size=sidx.max_cluster_size,
               n=sidx.n)
    return out


def ivf_pq_from_numpy(fields: dict, device=None) -> IvfPqIndex:
    """`fields` maps centroids, codebooks, codes (uint8), ids, offsets
    to arrays and metric, max_cluster_size, n to their values."""
    return _from_numpy(IvfPqIndex, IVF_PQ_FIELDS, fields, device)


def _segment_to_numpy(seg) -> dict:
    return {"seg_id": seg.seg_id, "commit_ts": seg.commit_ts,
            "base_gid": seg.base_gid,
            "part_id": getattr(seg, "part_id", -1),
            "arrays": {c: np.asarray(a) for c, a in seg.arrays.items()},
            "validity": {c: np.asarray(v) for c, v in seg.validity.items()}}


def _segment_from_numpy(seg: dict) -> Segment:
    arrays = {c: np.array(a) for c, a in seg["arrays"].items()}
    return Segment(
        seg_id=seg["seg_id"], commit_ts=seg["commit_ts"], arrays=arrays,
        validity={c: np.array(v, np.bool_)
                  for c, v in seg["validity"].items()},
        n_rows=len(next(iter(arrays.values()))), base_gid=seg["base_gid"],
        part_id=seg.get("part_id", -1))


def _tombstones_to_numpy(tombstones) -> list:
    return [(int(ts), np.asarray(g, np.int64)) for ts, g in tombstones]


def tables_to_numpy(engine) -> dict:
    """{table: {"schema", "primary_key", "not_null", "auto_increment",
    "partition", "segments", "tombstones", "fences", "last_merge_ts",
    "delta_floor", "dicts", "next_gid", "next_seg", "next_auto",
    "last_commit_ts", "committed_ts", "snapshots"}} of every table of
    `engine`: the schema as `schema_to_json` rows, the partition spec as
    its JSON, each committed segment as a dict of its `seg_id`,
    `commit_ts`, `base_gid`, `part_id` and (arrays, validity) numpy
    dicts (varchar columns as dictionary codes), each tombstone as
    (commit_ts, gids), each merge fence (the table before a merge) as
    its `merge_ts` with its segments and tombstones in the same form,
    each varchar column's dictionary, and the engine's frontier and
    named snapshots.  External tables hold no rows (their files are
    read in place) and are not carried."""
    out = {}
    for name, t in engine.tables.items():
        if getattr(t, "is_external", False):
            continue
        out[name] = {
            "schema": schema_to_json(t.meta.schema),
            "primary_key": list(t.meta.primary_key),
            "not_null": list(t.meta.not_null),
            "auto_increment": getattr(t.meta, "auto_increment", None),
            "partition": (t.meta.partition.to_json()
                          if getattr(t.meta, "partition", None) is not None
                          else None),
            "segments": [_segment_to_numpy(seg) for seg in t.segments],
            "tombstones": _tombstones_to_numpy(t.tombstones),
            "fences": [{"merge_ts": int(f.merge_ts),
                        "segments": [_segment_to_numpy(seg)
                                     for seg in f.segments],
                        "tombstones": _tombstones_to_numpy(f.tombstones)}
                       for f in getattr(t, "fences", [])],
            "last_merge_ts": getattr(t, "last_merge_ts", 0),
            "delta_floor": getattr(t, "delta_floor", 0),
            "dicts": {c: list(d) for c, d in t.dicts.items()},
            "next_gid": t.next_gid, "next_seg": t.next_seg,
            "next_auto": getattr(t, "next_auto", 1),
            "last_commit_ts": t.last_commit_ts,
            "committed_ts": engine.committed_ts,
            "snapshots": dict(getattr(engine, "snapshots", {}))}
    return out


def tables_from_numpy(tables: dict, engine=None) -> Engine:
    """Create `tables` (as `tables_to_numpy` gives them) in `engine` (a
    new port engine when None) and place their segments, tombstones,
    merge fences, dictionaries and counters as they are; the engine's
    clock and read frontier move past every timestamp carried, and the
    named snapshots are taken over."""
    engine = engine if engine is not None else Engine()
    for name, f in tables.items():
        engine.create_table(TableMeta(
            name, schema_from_json(f["schema"]), list(f["primary_key"]),
            auto_increment=f["auto_increment"],
            not_null=list(f["not_null"]),
            partition=PartitionSpec.from_json(f.get("partition"))))
        t = engine.get_table(name)
        for col, d in f["dicts"].items():
            t.encode_strings_list(col, list(d))
        for seg in f["segments"]:
            t.apply_segment(_segment_from_numpy(seg))
        for ts, gids in f["tombstones"]:
            t.apply_tombstones(ts, np.array(gids, np.int64))
        t.fences = [MergeFence(
            merge_ts=fence["merge_ts"],
            segments=[_segment_from_numpy(seg)
                      for seg in fence["segments"]],
            tombstones=[(ts, np.array(g, np.int64))
                        for ts, g in fence["tombstones"]])
            for fence in f.get("fences", [])]
        t.last_merge_ts = f.get("last_merge_ts", 0)
        t.delta_floor = f.get("delta_floor", 0)
        t.next_gid, t.next_seg = f["next_gid"], f["next_seg"]
        t.next_auto = f["next_auto"]
        t.last_commit_ts = max(t.last_commit_ts, f["last_commit_ts"])
        engine.snapshots.update(f["snapshots"])
        engine.hlc.update(max([f["committed_ts"]]
                              + list(f["snapshots"].values())))
        engine.committed_ts = max(engine.committed_ts, f["committed_ts"])
    return engine


#: options a session keeps on an index meta for itself: a device, a
#: sharded repack; never carried across
_LOCAL_OPTIONS = ("_device", "_sharded")


FULLTEXT_FIELDS = ("doc_idx", "tf", "term_offsets", "idf", "doc_norm")


def _arrays_to_numpy(obj, names) -> dict:
    """The array fields `names` of an index (either package's) as
    numpy."""
    return {f: (getattr(obj, f).cpu().numpy()
                if isinstance(getattr(obj, f), torch.Tensor)
                else np.asarray(getattr(obj, f))) for f in names}


def _ivf_to_numpy(ix) -> dict:
    obj = ix.index_obj
    return dict(_arrays_to_numpy(obj, IVF_PQ_FIELDS if ix.algo == "ivfpq"
                                 else IVF_FLAT_FIELDS),
                metric=obj.metric, max_cluster_size=obj.max_cluster_size,
                n=obj.n)


def _fulltext_to_numpy(ix) -> dict:
    obj = ix.index_obj
    return dict(_arrays_to_numpy(obj, FULLTEXT_FIELDS),
                vocab=dict(obj.vocab), n_docs=obj.n_docs,
                max_postings=obj.max_postings, k1=obj.k1, b=obj.b)


def _hnsw_to_numpy(engine, ix) -> dict:
    """The numpy route's graph as it is; a native graph, which Python
    cannot read, as its rows and build parameters (it is rebuilt)."""
    obj = ix.index_obj
    params = {"metric": obj.metric, "M": obj.M,
              "ef_construction": obj.ef_construction}
    if hasattr(obj, "neighbors"):
        return dict(params, route="numpy",
                    vectors=np.asarray(obj.vectors),
                    neighbors=[np.asarray(n) for n in obj.neighbors],
                    node_level=np.asarray(obj.node_level),
                    entry=int(obj.entry))
    gids = np.asarray(ix.options["_row_gids"], np.int64)
    arrays, _valid = engine.get_table(ix.table).fetch_rows(
        gids, [ix.columns[0]])
    return dict(params, route="native", seed=getattr(obj, "seed", 0),
                rows=np.asarray(arrays[ix.columns[0]], np.float32))


def _hnsw_from_numpy(fields: dict):
    from matrixone_tpu_torch.vectorindex import hnsw
    if fields["route"] == "native":
        return hnsw.build(fields["rows"], M=int(fields["M"]),
                          ef_construction=int(fields["ef_construction"]),
                          metric=str(fields["metric"]),
                          seed=int(fields["seed"]))
    return hnsw.HnswIndex(
        vectors=np.array(fields["vectors"], np.float32),
        neighbors=[np.array(n, np.int32) for n in fields["neighbors"]],
        node_level=np.array(fields["node_level"], np.int8),
        entry=int(fields["entry"]), metric=str(fields["metric"]),
        M=int(fields["M"]), ef_construction=int(fields["ef_construction"]))


def indexes_to_numpy(engine) -> dict:
    """{index name: {"table", "columns", "algo", "dirty", "options",
    "index"}} of every secondary index of `engine` (the JAX package's or
    the port's): the options with their arrays (`_row_gids`,
    `_delta_vecs`, `_delta_gids`) as numpy, and the built index as
    numpy fields, or None (an empty table, an evicted index).  IVF-Flat
    and IVF-PQ give the fields `ivf_flat_from_numpy` / `ivf_pq_from_numpy`
    take; FULLTEXT its five arrays, the vocabulary, `n_docs`,
    `max_postings`, `k1` and `b`; HNSW its graph (`vectors`,
    `neighbors`, `node_level`, `entry`) when the numpy route built it,
    else the indexed rows and the seed, to rebuild the native graph
    (deterministic for a seed), with `metric`, `M` and
    `ef_construction` either way."""
    out = {}
    for name, ix in engine.indexes.items():
        opts = {k: (np.asarray(v) if k.startswith("_") and k != "_metric"
                    else v)
                for k, v in ix.options.items() if k not in _LOCAL_OPTIONS}
        fields = None
        if ix.index_obj is not None:
            fields = (_fulltext_to_numpy(ix) if ix.algo == "fulltext"
                      else _hnsw_to_numpy(engine, ix) if ix.algo == "hnsw"
                      else _ivf_to_numpy(ix))
        out[name] = {"table": ix.table, "columns": list(ix.columns),
                     "algo": ix.algo, "dirty": bool(ix.dirty),
                     "options": opts, "index": fields}
    return out


def indexes_from_numpy(indexes: dict, engine: Engine, device=None) -> Engine:
    """Register `indexes` (as `indexes_to_numpy` gives them) in `engine`,
    which holds their tables, each built index placed on `device` (CUDA
    unless named; an HNSW graph stays in host memory), and in the
    engine's index cache."""
    from matrixone_tpu_torch import fulltext as FT
    from matrixone_tpu_torch import indexing
    dev = resolve_device(device)
    for name, f in indexes.items():
        opts = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                for k, v in f["options"].items()}
        opts["_device"] = dev
        obj, fields = None, f["index"]
        if fields is not None:
            obj = (FT.from_arrays(fields, dev) if f["algo"] == "fulltext"
                   else _hnsw_from_numpy(fields) if f["algo"] == "hnsw"
                   else ivf_pq_from_numpy(fields, dev)
                   if f["algo"] == "ivfpq"
                   else ivf_flat_from_numpy(fields, dev))
        meta = IndexMeta(name, f["table"], list(f["columns"]), f["algo"],
                         opts, index_obj=obj, dirty=f["dirty"])
        engine.register_index(meta)
        indexing.register_in_cache(engine, meta)
    return engine
