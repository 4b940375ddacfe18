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
