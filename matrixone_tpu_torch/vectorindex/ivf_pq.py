"""IVF-PQ index: product-quantized residuals and ADC scoring.

Counterpart of `matrixone_tpu/vectorindex/ivf_pq.py`, with the same
design:

 * build = coarse k-means (kmeans.py) + capped assignment + one stable
   argsort, so lists are contiguous CSR slices as in ivf_flat; the
   residual r = x - centroid of every row is split into M subspaces,
   each quantized by its own 256-entry k-means codebook, and a row is
   stored as M uint8 codes (768 dims at M = 96: 96 bytes a row);
 * search: the coarse probe scores every query against the centroid
   table with the fused L2 kernel (exact f32) and keeps the nprobe
   nearest lists; per (query, probed list) a [M, 256] lookup table of
   sub-distances ||q_m - c_m - codebook[m, j]||^2 comes from one small
   product, and every candidate's score is the sum of its M table
   entries (asymmetric distance computation), which on the card is the
   hand-written ADC kernel's list form (`ops/kernels.py:adc_score_lists`):
   it reads each probed list's codes where they lie in the index, with
   no padded gather; top-k is two-stage, per probe then over nprobe * k.

Scores are PQ approximations of the squared distance; `ivf_flat.
rerank_exact` over a deeper pool recovers the order where the caller
holds the raw vectors.  The index is a dataclass of tensors on one
device.  Ids are int32 at the API, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from matrixone_tpu_torch.ops import distance as D
from matrixone_tpu_torch.ops import kernels as K
from matrixone_tpu_torch.ops.topk import topk_smallest
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vectorindex import kmeans
from matrixone_tpu_torch.vectorindex.ivf_flat import (_as_tensor,
                                                      _prepare_queries,
                                                      _sync)

METRIC_L2 = "l2"
METRIC_COSINE = "cosine"


@dataclasses.dataclass
class IvfPqIndex:
    centroids: torch.Tensor   # [nlist, d] f32 coarse centroids
    codebooks: torch.Tensor   # [M, 256, ds] f32 per-subspace codebooks
    codes: torch.Tensor       # [n, M] uint8, cluster-major
    ids: torch.Tensor         # [n] int32 original row position
    offsets: torch.Tensor     # [nlist+1] int32 CSR
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
    def n_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centroids.device


def pick_subspaces(d: int) -> int:
    """Largest divisor of d with subspace width >= 4, capped at d // 4
    (the JAX package's `indexing._pick_subspaces`)."""
    for m in (96, 64, 48, 32, 24, 16, 12, 8, 6, 4, 2, 1):
        if m <= max(d // 4, 1) and d % m == 0:
            return m
    return 1


def build(dataset, nlist: int, n_subspaces: int = 16,
          metric: str = METRIC_L2, n_iter: int = 10, pq_iter: int = 8,
          seed: int = 0, balance_weight: float = 0.3,
          kmeans_sample: Optional[int] = 262144,
          compute_dtype=torch.bfloat16,
          max_list_factor: Optional[float] = 4.0,
          device=None) -> IvfPqIndex:
    """Build an IVF-PQ index from `dataset` [n, d] (numpy, built on
    `device`, CUDA by default; or a tensor, built where it lies).

    The cosine metric stores normalised vectors.  max_list_factor caps
    every inverted list as in ivf_flat.build.  Build stages are metered
    in mo_vector_build_seconds (kmeans, assign, pq)."""
    if metric not in (METRIC_L2, METRIC_COSINE):
        raise ValueError(
            f"ivf_pq supports l2/cosine metrics only (got {metric!r}); "
            f"inner-product ADC needs a dedicated formulation")
    data = _as_tensor(dataset, device).to(torch.float32)
    dev = data.device
    n, d = data.shape
    if d % n_subspaces != 0:
        raise ValueError(
            f"dim {d} must divide into n_subspaces={n_subspaces}")
    ds = d // n_subspaces
    if metric == METRIC_COSINE:
        data = D.normalize(data)
    t0 = time.perf_counter()
    km = kmeans.fit(data, nlist, n_iter=n_iter, seed=seed,
                    balance_weight=balance_weight, sample=kmeans_sample,
                    compute_dtype=compute_dtype,
                    final_assign=max_list_factor is None)
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="kmeans")
    t0 = time.perf_counter()
    if max_list_factor is not None:
        labels, counts, _ = kmeans.capped_labels(
            data, km.centroids, nlist, max_list_factor,
            compute_dtype=compute_dtype)
    else:
        labels, counts = km.labels, km.cluster_sizes
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="assign")
    t0 = time.perf_counter()
    order = torch.argsort(labels, stable=True)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0).to(torch.int32)])
    residuals = data[order] - km.centroids[labels[order].to(torch.int64)]

    # per-subspace k-means over residual slices (256 codes = 8 bits)
    k_pq = min(256, max(2, n))
    codebooks, codes = [], []
    for m in range(n_subspaces):
        sub = residuals[:, m * ds:(m + 1) * ds].contiguous()
        skm = kmeans.fit(sub, k_pq, n_iter=pq_iter, seed=seed + 1000 + m,
                         sample=kmeans_sample, compute_dtype=None)
        cb = skm.centroids
        if k_pq < 256:   # pad the codebook so codes stay uint8-addressable
            cb = torch.cat([cb, torch.full((256 - k_pq, ds), 1e10,
                                           device=dev)])
        codebooks.append(cb)
        codes.append(skm.labels.to(torch.uint8))
    del residuals
    max_cs = int(counts.max())
    max_cs = ((max_cs + 127) // 128) * 128   # 128-aligned gather budget
    index = IvfPqIndex(centroids=km.centroids,
                       codebooks=torch.stack(codebooks),     # [M, 256, ds]
                       codes=torch.stack(codes, dim=1),      # [n, M]
                       ids=order.to(torch.int32), offsets=offsets,
                       metric=metric, max_cluster_size=max_cs, n=n)
    _sync(dev)
    M.vector_build_seconds.inc(time.perf_counter() - t0, stage="pq")
    return index


def _probe(index: IvfPqIndex, q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The nprobe nearest lists of each query [b, nprobe] (int64), from
    exact-f32 centroid distances: the fused L2 kernel on the card, with
    the long nlist axis as its row axis."""
    cdist = D.l2_distance_sq(index.centroids, q).T          # [b, nlist]
    return topk_smallest(cdist, nprobe)[1]


def adc_inputs(index: IvfPqIndex, qc: torch.Tensor, pc: torch.Tensor,
               compute_dtype):
    """What the ADC kernel scores for one query chunk: qc [qc, d]
    queries and pc [qc, nprobe] probed lists -> (lut [qc, nprobe, M,
    256] f32, candidate rows [qc, nprobe, pad] int64, list starts and
    ends [qc, nprobe] int32).  Lanes past a list's end carry candidate
    0."""
    query_chunk, nprobe = pc.shape
    m_sub = index.n_subspaces
    ds = index.dim // m_sub
    # residual queries per probed list, split into subspaces
    qr = qc[:, None, :] - index.centroids[pc]               # [qc, np, d]
    qr_sub = qr.reshape(query_chunk, nprobe, m_sub, ds)
    # lut[q, p, m, j] = ||qr_sub - codebook[m, j]||^2 from one product
    # per subspace, in the compute dtype with f32 results
    cb = index.codebooks                                     # [M, 256, ds]
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    a = qr_sub.to(cdt).permute(2, 0, 1, 3).reshape(
        m_sub, query_chunk * nprobe, ds)
    dots = D.matmul_f32(a, cb.to(cdt).transpose(1, 2))      # [M, qc*np, 256]
    dots = dots.reshape(m_sub, query_chunk, nprobe, 256).permute(1, 2, 0, 3)
    cb2 = (cb * cb).sum(dim=-1)                              # [M, 256]
    qr2 = (qr_sub * qr_sub).sum(dim=-1)                      # [qc, np, M]
    lut = qr2[..., None] + cb2[None, None] - 2.0 * dots
    # candidates: each probed list's rows, padded to the largest list
    starts = index.offsets[pc]
    ends = index.offsets[pc + 1]
    lane = torch.arange(index.max_cluster_size, dtype=torch.int32,
                        device=qc.device)
    cand = starts[:, :, None] + lane[None, None, :]          # [qc, np, pad]
    valid = cand < ends[:, :, None]
    cand = torch.where(valid, cand, torch.zeros_like(cand)).to(torch.int64)
    return lut, cand, starts, ends


def _score_chunk(index: IvfPqIndex, qc: torch.Tensor, pc: torch.Tensor,
                 k: int, compute_dtype):
    """ADC-score one query chunk's probed lists and return its top-k
    (distances [qc, k] f32, ids [qc, k] int32).  The ADC kernel reads
    each list's codes where they lie in the index and scores the lanes
    past a list's end +inf."""
    query_chunk, nprobe = pc.shape
    pad = index.max_cluster_size
    m_sub = index.n_subspaces
    lut, cand, starts, ends = adc_inputs(index, qc, pc, compute_dtype)
    g = query_chunk * nprobe
    dist = K.adc_score_lists(index.codes, starts.reshape(g),
                             ends.reshape(g), lut.reshape(g, m_sub, 256),
                             pad).reshape(query_chunk, nprobe, pad)
    # two-stage top-k (as in ivf_flat: the top-k of the probe union is
    # contained in the union of per-probe top-ks)
    kk = min(k, pad)
    s1, p1 = topk_smallest(dist, kk)                         # [qc, np, kk]
    c1 = cand.gather(2, p1)
    s1f = s1.reshape(query_chunk, nprobe * kk)
    c1f = c1.reshape(query_chunk, nprobe * kk)
    top_s, top_pos = topk_smallest(s1f, min(k, nprobe * kk))
    return top_s, index.ids[c1f.gather(1, top_pos)]


def search(index: IvfPqIndex, queries, k: int, nprobe: int,
           query_chunk: int = 32, compute_dtype=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ADC search -> (approximate squared distances [b, k] f32,
    row positions [b, k] int32), on the index's device.

    Same batch contract as ivf_flat.search: any b works, padded
    internally to the next power of two (pad rows are stripped)."""
    q, b, qc_eff = _prepare_queries(index, queries, query_chunk)
    target = q.shape[0]
    if target != b:
        M.vector_search_pad_rows.inc(target - b)
    M.vector_search_queries.inc(b)
    probes = _probe(index, q, nprobe)
    parts = [_score_chunk(index, q[i:i + qc_eff], probes[i:i + qc_eff], k,
                          compute_dtype)
             for i in range(0, target, qc_eff)]
    dists = torch.cat([p[0] for p in parts])
    ids = torch.cat([p[1] for p in parts])
    return dists[:b], ids[:b]
