"""Carry an index built by the JAX package across to the port.

`ivf_flat_from_numpy` and `ivf_pq_from_numpy` take the numpy view of a
JAX `IvfFlatIndex` or `IvfPqIndex` (each array field through
`np.asarray`, plus `metric`, `max_cluster_size` and `n`) and return the
port's index of the same kind on a device, field by field and bit for
bit, so both packages can search the same index.  JAX's bf16 arrays come
out of numpy as `ml_dtypes.bfloat16`; they are carried bit for bit
through a uint16 view, so `ml_dtypes` is needed only by the caller that
made them.
"""

from __future__ import annotations

import numpy as np
import torch

from matrixone_tpu_torch import resolve_device
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
