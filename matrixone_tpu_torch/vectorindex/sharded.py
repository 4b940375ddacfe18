"""Cluster-sharded IVF serving over the slot mesh.

The port of `matrixone_tpu/vectorindex/sharded.py` (reference analogue:
the cuVS worker's shard mode, `cgo/cuvs/README.md`).  The inverted lists
of ONE IvfFlatIndex are partitioned cluster-wise over the slots of a
`parallel/mesh.py` mesh (greedy size-balanced, so every slot carries
about 1/S of the rows); the centroids are replicated.  `search_sharded`
runs, on every slot, the same probe against the replicated centroid
table (the L2 kernel on the card), keeps the probes that slot owns,
scores them with `ivf_flat`'s own chunk scorer over the slot's packing,
and takes its top-k; then one `all_gather` of the [b, k] candidates in
slot order and a merge by `ops/topk.topk_smallest`.

Correctness contract (the reference's): every slot derives the same
global top-nprobe probe list, so the union of the slots' candidates is
the single index's candidate set, and the merge of S x k candidates
selects its global top-k: after `rerank_exact` the sharded ids equal the
single index's.  `probe_capacity` < nprobe caps each slot's probe budget
for a small recall cost.

On one card the slots are one device: a slot's arrays are its share of
the lists (the index's rows are not duplicated) and the replicated
centroids are one tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.ops import distance as D
from matrixone_tpu_torch.ops.topk import topk_smallest
from matrixone_tpu_torch.parallel import mesh as MS
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vectorindex.ivf_flat import (
    METRIC_COSINE, IvfFlatIndex, _bucket_batch, _probe, _score_chunk)


@dataclasses.dataclass
class ShardedIvfIndex:
    centroids: List[torch.Tensor]      # [nlist, d] f32 per slot
    owner: List[torch.Tensor]          # [nlist] i32 per slot: owning slot
    local_slot: List[torch.Tensor]     # [nlist] i32 per slot: list's place
    vectors: List[torch.Tensor]        # per slot [rows_pad, d] residuals
    r_norm2: List[torch.Tensor]        # per slot [rows_pad] f32
    r_dot_c: List[torch.Tensor]        # per slot [rows_pad] f32
    ids: List[torch.Tensor]            # per slot [rows_pad] i32 (global)
    local_offsets: List[torch.Tensor]  # per slot [L + 1] i32 CSR
    metric: str
    max_cluster_size: int
    n: int
    mesh: MS.Mesh

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def nlist(self) -> int:
        return int(self.centroids[0].shape[0])

    def view(self, s: int) -> IvfFlatIndex:
        """Slot s's lists as an IvfFlatIndex whose CSR is its packing."""
        return IvfFlatIndex(
            centroids=self.centroids[s], vectors=self.vectors[s],
            r_norm2=self.r_norm2[s], r_dot_c=self.r_dot_c[s],
            ids=self.ids[s], offsets=self.local_offsets[s],
            metric=self.metric, max_cluster_size=self.max_cluster_size,
            n=self.n)


def pack(index: IvfFlatIndex, n_shards: int) -> dict:
    """The cluster-sharded packing of `index` in the reference's layout:
    owner, local_slot [nlist]; vectors [S, rows_pad, d] (a tensor on the
    index's device), r_norm2, r_dot_c, ids [S, rows_pad]; local_offsets
    [S, L + 1] (numpy).  Clusters go greedily, largest first, to the
    lightest shard."""
    S = n_shards
    offs = index.offsets.cpu().numpy()
    counts = np.diff(offs)
    nlist = index.nlist
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(S, np.int64)
    owner = np.zeros(nlist, np.int32)
    for c in order:
        s = int(np.argmin(loads))
        owner[c] = s
        loads[s] += int(counts[c])
    shard_clusters = [np.flatnonzero(owner == s) for s in range(S)]
    L = max(1, max(len(cl) for cl in shard_clusters))
    rows_pad = max(128, int(-(-int(loads.max()) // 128) * 128))
    vec = index.vectors
    vecs = torch.zeros((S, rows_pad, index.dim), dtype=vec.dtype,
                       device=vec.device)
    rn_np = index.r_norm2.cpu().numpy()
    rc_np = index.r_dot_c.cpu().numpy()
    ids_np = index.ids.cpu().numpy()
    rns = np.zeros((S, rows_pad), rn_np.dtype)
    rcs = np.zeros((S, rows_pad), rc_np.dtype)
    gids = np.zeros((S, rows_pad), np.int32)
    lofs = np.zeros((S, L + 1), np.int32)
    local_slot = np.zeros(nlist, np.int32)
    for s, clusters in enumerate(shard_clusters):
        pos = 0
        for j, c in enumerate(clusters):
            local_slot[c] = j
            lo, hi = int(offs[c]), int(offs[c + 1])
            m = hi - lo
            vecs[s, pos:pos + m] = vec[lo:hi]
            rns[s, pos:pos + m] = rn_np[lo:hi]
            rcs[s, pos:pos + m] = rc_np[lo:hi]
            gids[s, pos:pos + m] = ids_np[lo:hi]
            lofs[s, j] = pos
            pos += m
        lofs[s, len(clusters):] = pos       # trailing empty clusters
    M.vector_shard_imbalance.set(float(loads.max())
                                 / max(1.0, float(loads.mean())))
    return {"owner": owner, "local_slot": local_slot, "vectors": vecs,
            "r_norm2": rns, "r_dot_c": rcs, "ids": gids,
            "local_offsets": lofs}


def from_packing(centroids: torch.Tensor, packed: dict, metric: str,
                 max_cluster_size: int, n: int,
                 mesh: MS.Mesh) -> ShardedIvfIndex:
    """A ShardedIvfIndex over `mesh` from a packing (`pack`'s, or the
    reference's arrays carried across): slot s takes row s of every
    sharded array, and a replica of the centroid, owner and local-slot
    tables."""
    def rows(name):
        a = packed[name]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return [t[s].to(d) for s, d in enumerate(mesh.slots)]

    def rep(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return MS.replicate(mesh, t)

    return ShardedIvfIndex(
        centroids=MS.replicate(mesh, centroids), owner=rep(packed["owner"]),
        local_slot=rep(packed["local_slot"]), vectors=rows("vectors"),
        r_norm2=rows("r_norm2"), r_dot_c=rows("r_dot_c"), ids=rows("ids"),
        local_offsets=rows("local_offsets"), metric=metric,
        max_cluster_size=max_cluster_size, n=n, mesh=mesh)


def shard_ivf(index: IvfFlatIndex, mesh: MS.Mesh) -> ShardedIvfIndex:
    """Repack an IvfFlatIndex cluster-sharded over `mesh`; the achieved
    max/mean row ratio is exported as mo_vector_shard_imbalance."""
    return from_packing(index.centroids, pack(index, mesh.size),
                        index.metric, index.max_cluster_size, index.n,
                        mesh)


def search_sharded(sidx: ShardedIvfIndex, queries, k: int, nprobe: int,
                   query_chunk: int = 32, compute_dtype=torch.bfloat16,
                   probe_capacity: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF search -> (distances [b, k], row positions [b, k]) on
    slot 0's device; the batch contract of `ivf_flat.search` (internal
    power-of-two padding).  probe_capacity=None gives the single index's
    candidates; an integer < nprobe caps each slot's probe budget."""
    dst = sidx.mesh.slots[0]
    q = queries if isinstance(queries, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(queries))
    q = q.to(dst, torch.float32)
    b, d = q.shape
    target, qc = _bucket_batch(b, query_chunk)
    if sidx.metric == METRIC_COSINE:
        q = D.normalize(q)
    if target != b:
        q = torch.cat([q, q.new_zeros((target - b, d))])
        M.vector_search_pad_rows.inc(target - b)
    M.vector_search_queries.inc(b)
    L = int(sidx.local_offsets[0].shape[0]) - 1
    lp = min(nprobe, L) if probe_capacity is None \
        else max(1, min(probe_capacity, nprobe, L))
    dls, ils = [], []
    for s, slot in enumerate(sidx.mesh.slots):
        view = sidx.view(s)
        qs = q.to(slot)
        # the probe against the REPLICATED centroids: every slot derives
        # the same global top-nprobe list, then keeps its own
        cscores, probes = _probe(view, qs, nprobe)
        own = sidx.owner[s][probes] == s                    # [b, nprobe]
        if lp < nprobe:
            # owned probes first, the first lp kept
            order = torch.argsort((~own).to(torch.int8), dim=1,
                                  stable=True)[:, :lp]
            probes = probes.gather(1, order)
            cscores = cscores.gather(1, order)
            own = own.gather(1, order)
        pc_local = sidx.local_slot[s][probes].to(torch.int64)
        parts = [_score_chunk(view, qs[i:i + qc], pc_local[i:i + qc],
                              cscores[i:i + qc], k, compute_dtype,
                              pmask=own[i:i + qc])
                 for i in range(0, target, qc)]
        dls.append(torch.cat([p[0] for p in parts]))
        ils.append(torch.cat([p[1] for p in parts]))
    # one small collective: the S x k union, slot-major per query
    alld = MS.all_gather(dls, dst, dim=1)
    alli = MS.all_gather(ils, dst, dim=1)
    top_s, top_pos = topk_smallest(alld, min(k, alld.shape[1]))
    ids = alli.gather(1, top_pos)
    return top_s[:b], ids[:b]
