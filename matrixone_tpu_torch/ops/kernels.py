"""Hand-kernel dispatch seam of the port.

Counterpart of `matrixone_tpu/ops/kernels.py`: callers name these
functions and never a kernel.  The choice is made by where the tensors
live and by nothing else: a CUDA tensor runs the CUDA kernel (and
raises if it cannot build or launch), a CPU tensor runs the kernel's
plain PyTorch version.  There is no switch and no fallback.
"""

from __future__ import annotations

import torch

from matrixone_tpu_torch.ops import cuda_kernels as CK


def _l2_operands(x: torch.Tensor, q: torch.Tensor):
    """(x, q) as contiguous f32 and ||q||^2, which is computed here,
    outside the kernel, as the TPU version computes it outside its
    tile."""
    xf = x.to(torch.float32).contiguous()
    qf = q.to(torch.float32).contiguous()
    return xf, qf, (qf * qf).sum(dim=1)


def l2_distance_sq_exact(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact-f32 squared L2 distances [n, b] between rows of x [n, d]
    and q [b, d]."""
    xf, qf, q2 = _l2_operands(x, q)
    if xf.is_cuda:
        return CK.l2_distance_sq(xf, qf, q2)
    return CK.l2_distance_sq_plain(xf, qf, q2)


def l2_distance_sq_masked_exact(x: torch.Tensor, q: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """`l2_distance_sq_exact` with the rows of x where mask [n] is false
    scoring +inf (the filtered-search prefilter of the TPU kernel)."""
    xf, qf, q2 = _l2_operands(x, q)
    m = mask.to(torch.bool).contiguous()
    if xf.is_cuda:
        return CK.l2_distance_sq_masked(xf, qf, q2, m)
    return CK.l2_distance_sq_masked_plain(xf, qf, q2, m)


def adc_score(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """IVF-PQ ADC scores [G, P] f32: scores[g, p] = sum_m lut[g, m,
    codes[g, p, m]] for codes [G, P, M] (uint8 or int32) and lut
    [G, M, 256]."""
    lf = lut.to(torch.float32).contiguous()
    if codes.is_cuda:
        return CK.adc_score(codes.contiguous(), lf)
    return CK.adc_score_plain(codes, lf)


def sorted_lookup(sorted_hash: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """searchsorted-left positions [m] int32 of the probe hashes in the
    sorted build-side hashes: the hash-join probe's entry into each
    hash run.  Both are int64 bit patterns of uint64 hashes, ordered
    as unsigned."""
    s = sorted_hash.contiguous()
    q = queries.contiguous()
    if q.is_cuda:
        return CK.sorted_search(s, q)
    return CK.sorted_search_plain(s, q)


def grouped_scatter_add(values: torch.Tensor, gids: torch.Tensor,
                        mask: torch.Tensor, max_groups: int,
                        use_pallas: bool = False) -> torch.Tensor:
    """Masked segment sum [max_groups], the grouped aggregate's
    group-scatter.  As in the reference, the call site decides: with
    `use_pallas`, float32 values into at most 4096 groups take the
    segment-sum kernel; every other call (int64 counts and decimals,
    f64, the merge of partial tables) is a plain scatter-add, the
    counterpart of XLA's segment_sum.  Rows that are masked, or whose
    gid lies outside [0, max_groups), add nothing."""
    if (use_pallas and values.dtype == torch.float32
            and max_groups <= CK.SEGMENT_SUM_MAX_GROUPS
            and values.shape[0] > 0):
        v = values.contiguous()
        g = gids.to(torch.int32).contiguous()
        m = mask.contiguous()
        if v.is_cuda:
            return CK.segment_sum(v, g, m, max_groups)
        return CK.segment_sum_plain(v, g, m, max_groups)
    return CK.segment_sum_plain(values, gids, mask, max_groups)
