"""IVF-Flat index: build and batched search.

Counterpart of `matrixone_tpu/vectorindex/ivf_flat.py` (its mesh-sharded
search is `vectorindex/sharded.py`, over this module's chunk scorer),
with the same design:

 * build = k-means (kmeans.py) + one stable argsort: vectors are stored
   cluster-major with CSR offsets, so an inverted list is a contiguous
   slice and probing it is a dense gather;
 * storage is residual-encoded (r = x - centroid):
   ||x-q||^2 = ||c-q||^2 + ||r||^2 + 2 r.c - 2 r.q, where ||c-q||^2
   comes from the probe and ||r||^2, r.c are f32 scalars kept from the
   build, so bf16 storage rounds only the small-magnitude r.q term;
 * search runs fixed-size query chunks: the probe scores every query
   against the centroid table with the fused L2 kernel (exact f32) and
   keeps the nprobe nearest lists; each chunk gathers its probed lists
   into a padded [chunk, nprobe, pad, d] tensor and scores every query
   against its own candidates only (a batched [pad, d] @ [d] product);
   top-k is two-stage, per probe then over nprobe * k;
 * `rerank_exact` re-scores the final k in f64 with a sequential fold,
   bit-identical to the CPU scalar path.

The index is a dataclass of tensors on one device, where it stays
between queries.  Ids are int32 at the API, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.ops import distance as D
from matrixone_tpu_torch.ops.topk import topk_smallest
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vectorindex import kmeans

METRIC_L2 = "l2"
METRIC_COSINE = "cosine"
METRIC_IP = "ip"


@dataclasses.dataclass
class IvfFlatIndex:
    centroids: torch.Tensor  # [nlist, d] f32
    vectors: torch.Tensor    # [n, d] RESIDUALS x - c, cluster-major (storage dtype)
    r_norm2: torch.Tensor    # [n] f32 ||r||^2
    r_dot_c: torch.Tensor    # [n] f32 r . centroid (l2 metric)
    ids: torch.Tensor        # [n] int32 original row position
    offsets: torch.Tensor    # [nlist+1] int32 CSR into vectors
    metric: str = METRIC_L2
    max_cluster_size: int = 0
    n: int = 0

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _as_tensor(x, device=None) -> torch.Tensor:
    """A tensor input stays where it is unless `device` is named; numpy
    input goes to `device` (CUDA unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def build(dataset, nlist: int, metric: str = METRIC_L2,
          n_iter: int = 10, seed: int = 0, storage_dtype=None,
          balance_weight: float = 0.3, kmeans_sample: Optional[int] = 262144,
          compute_dtype=torch.bfloat16,
          max_list_factor: Optional[float] = 4.0,
          kmeans_minibatch: Optional[int] = None,
          balance_mode: str = "cap",
          target_list_size: int = 224,
          device=None) -> IvfFlatIndex:
    """Build an IVF-Flat index from `dataset` [n, d] (numpy, built on
    `device`, CUDA by default; or a tensor, built where it lies).

    The cosine metric stores normalised vectors (cosine -> inner
    product).  max_list_factor caps every inverted list at factor *
    ceil(n/nlist) rows (overflow points go to their next-nearest
    centroid): the cap bounds the search's padded gather.
    kmeans_minibatch rotates Lloyd iterations through fixed-size blocks
    of the training sample.  Build stages are metered in
    mo_vector_build_seconds.

    balance_mode picks how oversized lists are bounded:
      "cap"   relocation to the next-nearest centroid (capped_labels);
      "split" kmeans.split_oversized: big clusters become local child
              clusters of at most target_list_size rows (nlist grows by
              the number of extra children).
    """
    data = _as_tensor(dataset, device).to(torch.float32)
    dev = data.device
    n = data.shape[0]
    if metric == METRIC_COSINE:
        data = D.normalize(data)
    t0 = time.perf_counter()
    km = kmeans.fit(data, nlist, n_iter=n_iter, seed=seed,
                    balance_weight=balance_weight, sample=kmeans_sample,
                    compute_dtype=compute_dtype,
                    minibatch=kmeans_minibatch,
                    final_assign=(max_list_factor is None
                                  or balance_mode == "split"))
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="kmeans")
    t0 = time.perf_counter()
    centroids = km.centroids
    if balance_mode == "split":
        cents2, labels2, _cap = kmeans.split_oversized(
            data.cpu().numpy(), centroids.cpu().numpy(),
            km.labels.cpu().numpy(), target=target_list_size, seed=seed)
        centroids = torch.from_numpy(cents2).to(dev)
        labels = torch.from_numpy(labels2).to(dev)
        counts = torch.from_numpy(np.bincount(
            labels2, minlength=len(cents2)).astype(np.int32)).to(dev)
    elif max_list_factor is not None:
        labels, counts, _ = kmeans.capped_labels(
            data, centroids, nlist, max_list_factor,
            compute_dtype=compute_dtype)
    else:
        labels = km.labels
        counts = km.cluster_sizes
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="assign")
    t0 = time.perf_counter()
    order = torch.argsort(labels, stable=True)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0).to(torch.int32)])
    sorted_centroids = centroids[labels[order].to(torch.int64)]
    residuals = data[order] - sorted_centroids          # small magnitude
    r_norm2 = (residuals * residuals).sum(dim=-1)
    r_dot_c = (residuals * sorted_centroids).sum(dim=-1)
    del sorted_centroids
    if storage_dtype is not None:
        residuals = residuals.to(storage_dtype)
    max_cs = int(counts.max())
    max_cs = ((max_cs + 127) // 128) * 128   # 128-aligned gather budget
    index = IvfFlatIndex(centroids=centroids, vectors=residuals,
                         r_norm2=r_norm2, r_dot_c=r_dot_c,
                         ids=order.to(torch.int32), offsets=offsets,
                         metric=metric, max_cluster_size=max_cs, n=n)
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="pack")
    return index


def _bucket_batch(b: int, query_chunk: int) -> Tuple[int, int]:
    """(padded batch, effective chunk): batches pad up to the next power
    of two, so a search runs a small set of shapes, and the chunk never
    exceeds the padded batch. The effective chunk is rounded DOWN to a
    power of two so it always divides the padded batch."""
    target = max(1, 1 << (max(b, 1) - 1).bit_length())
    qc = max(1, min(query_chunk, target))
    return target, 1 << (qc.bit_length() - 1)


def _probe(index: IvfFlatIndex, q: torch.Tensor, nprobe: int):
    """Stage 1: centroid scores + top-nprobe lists per query ->
    (scores [b, nprobe] f32, lists [b, nprobe] int64).  Full f32
    precision: these scores re-enter the candidate distances.  For L2
    the tiled axis is nlist (the large one) and the scores are the
    fused kernel's."""
    if index.metric == METRIC_L2:
        cdist = D.l2_distance_sq(index.centroids, q).T     # [b, nlist]
    else:
        cdist = -D.inner_product(q, index.centroids)
    return topk_smallest(cdist, nprobe)                    # ||c-q||^2 / -c.q


def _residual_scores(index: IvfFlatIndex, cs: torch.Tensor,
                     cand: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """Candidate scores from the residual decomposition, given the
    probe-stage score `cs` of each candidate's list and own = r.q:
         ||x-q||^2 = ||c-q||^2 + ||r||^2 + 2 r.c - 2 r.q
    (ip/cosine):     x.q   = c.q + r.q   (cs = -c.q, score = 1 - x.q)"""
    if index.metric == METRIC_L2:
        rn = index.r_norm2[cand]
        rc = index.r_dot_c[cand]
        return torch.clamp_min(cs + rn + 2.0 * rc - 2.0 * own, 0.0)
    return 1.0 - (-cs + own)


def _score_chunk(index: IvfFlatIndex, qc: torch.Tensor, pc: torch.Tensor,
                 cs: torch.Tensor, k: int, compute_dtype,
                 pmask: Optional[torch.Tensor] = None):
    """Score one query chunk's probed lists and return its top-k.

    qc [qc, d] queries, pc [qc, nprobe] probed list ids, cs [qc, nprobe]
    probe-stage scores, pmask [qc, nprobe] the live probes (None: all;
    the sharded search masks the lists other slots own).  Lanes past a
    list's end or of a dead probe score +inf and carry candidate 0; they
    sort after every real candidate."""
    query_chunk, nprobe = pc.shape
    pad = index.max_cluster_size
    d = index.dim
    starts = index.offsets[pc]                         # [qc, nprobe]
    ends = index.offsets[pc + 1]
    lane = torch.arange(pad, dtype=torch.int32, device=qc.device)
    cand = starts[:, :, None] + lane[None, None, :]    # [qc, nprobe, pad]
    valid = cand < ends[:, :, None]
    if pmask is not None:
        valid = valid & pmask[:, :, None]
    cand = torch.where(valid, cand, torch.zeros_like(cand)).to(torch.int64)
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    vecs = index.vectors[cand].to(cdt)                 # [qc, nprobe, pad, d]
    # each query against its own candidates only
    own = D.matmul_f32(vecs.view(query_chunk, nprobe * pad, d),
                       qc.to(cdt)[:, :, None])
    own = own.view(query_chunk, nprobe, pad)
    del vecs
    dist = _residual_scores(index, cs[:, :, None], cand, own)
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    # two-stage top-k: per-probe partial top-k, then merge nprobe*kk
    kk = min(k, pad)
    s1, p1 = topk_smallest(dist, kk)                   # [qc, nprobe, kk]
    c1 = cand.gather(2, p1)
    s1f = s1.reshape(query_chunk, nprobe * kk)
    c1f = c1.reshape(query_chunk, nprobe * kk)
    top_s, top_pos = topk_smallest(s1f, min(k, nprobe * kk))
    top_cand = c1f.gather(1, top_pos)
    return top_s, index.ids[top_cand]


def _prepare_queries(index: IvfFlatIndex, queries, query_chunk: int):
    """-> (f32 queries on the index's device padded to the bucket,
    real rows, effective chunk); cosine queries are normalised."""
    q = _as_tensor(queries, index.device).to(torch.float32)
    b, d = q.shape
    target, qc_eff = _bucket_batch(b, query_chunk)
    if target != b:
        q = torch.cat([q, q.new_zeros((target - b, d))])
    if index.metric == METRIC_COSINE:
        q = D.normalize(q)
    return q, b, qc_eff


def search(index: IvfFlatIndex, queries, k: int, nprobe: int,
           query_chunk: int = 32, compute_dtype=torch.bfloat16
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched IVF search -> (distances [b, k] f32, row positions [b, k]
    int32), on the index's device.

    Distances are squared l2 (metric=l2) or 1-ip (cosine/ip). Any batch
    size b works: queries are padded internally to the next power of two
    (pad rows are zero queries whose results are stripped before
    return)."""
    q, b, qc_eff = _prepare_queries(index, queries, query_chunk)
    target = q.shape[0]
    if target != b:
        M.vector_search_pad_rows.inc(target - b)
    M.vector_search_queries.inc(b)
    cs, probes = _probe(index, q, nprobe)
    parts = [_score_chunk(index, q[i:i + qc_eff], probes[i:i + qc_eff],
                          cs[i:i + qc_eff], k, compute_dtype)
             for i in range(0, target, qc_eff)]
    dists = torch.cat([p[0] for p in parts])
    ids = torch.cat([p[1] for p in parts])
    return dists[:b], ids[:b]


def search_profiled(index: IvfFlatIndex, queries, k: int, nprobe: int,
                    query_chunk: int = 32,
                    compute_dtype=torch.bfloat16) -> dict:
    """Diagnostic re-execution of the search pipeline with a device sync
    between stages, attributing wall time to probe / score / merge.
    Not the serving path: it fills the mo_vector_search_seconds stage
    counters and returns the per-stage breakdown with the results."""
    q, b, qc_eff = _prepare_queries(index, queries, query_chunk)
    dev = index.device
    target = q.shape[0]
    # warm once so the stage times measure steady-state execution
    cs, probes = _probe(index, q, nprobe)
    _score_chunk(index, q[:qc_eff], probes[:qc_eff], cs[:qc_eff], k,
                 compute_dtype)
    _sync(dev)
    t0 = time.perf_counter()
    cs, probes = _probe(index, q, nprobe)
    _sync(dev)
    t_probe = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = [_score_chunk(index, q[i:i + qc_eff], probes[i:i + qc_eff],
                          cs[i:i + qc_eff], k, compute_dtype)
             for i in range(0, target, qc_eff)]
    _sync(dev)
    t_score = time.perf_counter() - t0
    t0 = time.perf_counter()
    dists = np.concatenate([p[0].cpu().numpy() for p in parts])[:b]
    ids = np.concatenate([p[1].cpu().numpy() for p in parts])[:b]
    t_merge = time.perf_counter() - t0
    M.vector_search_seconds.inc(t_probe, stage="probe")
    M.vector_search_seconds.inc(t_score, stage="score")
    M.vector_search_seconds.inc(t_merge, stage="merge")
    return {"probe_seconds": t_probe, "score_seconds": t_score,
            "merge_seconds": t_merge, "dists": dists, "ids": ids}


def rerank_exact(dataset, queries, ids, metric: str = METRIC_L2,
                 valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score candidate ids [b, k] with the f64 sequential-order
    row-wise distances and re-sort (stably) -> (distances [b, k] f64,
    ids [b, k]), bit-identical to the CPU scalar path applied to the
    same candidates.  `valid` masks padded candidate lanes, which keep
    +inf and sort last.  Runs on `dataset`'s device."""
    dataset = _as_tensor(dataset)
    queries = _as_tensor(queries, dataset.device)
    ids = _as_tensor(ids, dataset.device)
    b, k = ids.shape
    cand = dataset[ids.reshape(-1).to(torch.int64)].reshape(b * k, -1)
    qe = queries[:, None, :].expand(b, k, queries.shape[1]).reshape(b * k, -1)
    if metric == METRIC_L2:
        dist = D.l2_distance_rowwise(cand, qe)
    elif metric == METRIC_COSINE:
        dist = D.cosine_distance_rowwise(cand, qe)
    else:
        dist = -D.inner_product_rowwise(cand, qe)
    dist = dist.reshape(b, k)
    if valid is not None:
        dist = torch.where(_as_tensor(valid, dataset.device), dist,
                           torch.full_like(dist, float("inf")))
    order = torch.argsort(dist, dim=1, stable=True)
    return dist.gather(1, order), ids.gather(1, order)
