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
and dictionaries; `tables_from_numpy` commits them into a port engine,
segment for segment and code for code, so both engines hold the same
rows in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.storage.engine import (Engine, TableMeta,
                                                schema_from_json,
                                                schema_to_json)
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


def ivf_pq_from_numpy(fields: dict, device=None) -> IvfPqIndex:
    """`fields` maps centroids, codebooks, codes (uint8), ids, offsets
    to arrays and metric, max_cluster_size, n to their values."""
    return _from_numpy(IvfPqIndex, IVF_PQ_FIELDS, fields, device)


def tables_to_numpy(engine) -> dict:
    """{table: {"schema", "primary_key", "not_null", "segments",
    "dicts"}} of every table of `engine`: the schema as `schema_to_json`
    rows, each committed segment as (arrays, validity) numpy dicts
    (varchar columns as dictionary codes), and each varchar column's
    dictionary."""
    out = {}
    for name, t in engine.tables.items():
        out[name] = {
            "schema": schema_to_json(t.meta.schema),
            "primary_key": list(t.meta.primary_key),
            "not_null": list(t.meta.not_null),
            "segments": [({c: np.asarray(a) for c, a in seg.arrays.items()},
                          {c: np.asarray(v) for c, v in seg.validity.items()})
                         for seg in t.segments],
            "dicts": {c: list(d) for c, d in t.dicts.items()}}
    return out


def tables_from_numpy(tables: dict, engine=None) -> Engine:
    """Create and load `tables` (as `tables_to_numpy` gives them) in
    `engine` (a new port engine when None): one commit per segment, the
    dictionaries taken over as they are, so every code keeps its
    string."""
    engine = engine if engine is not None else Engine()
    for name, f in tables.items():
        engine.create_table(TableMeta(name, schema_from_json(f["schema"]),
                                      list(f["primary_key"]),
                                      not_null=list(f["not_null"])))
        t = engine.get_table(name)
        for col, d in f["dicts"].items():
            t.encode_strings_list(col, list(d))
        for arrays, validity in f["segments"]:
            engine.commit_write(
                name, {c: np.array(a) for c, a in arrays.items()},
                {c: np.array(v, np.bool_) for c, v in validity.items()})
    return engine
