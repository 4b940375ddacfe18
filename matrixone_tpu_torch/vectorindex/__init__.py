"""Vector indexes of the port (counterpart of matrixone_tpu.vectorindex)."""

from matrixone_tpu_torch.vectorindex import (brute_force, ivf_flat, ivf_pq,
                                             kmeans, recall)
from matrixone_tpu_torch.vectorindex.ivf_flat import IvfFlatIndex
from matrixone_tpu_torch.vectorindex.ivf_pq import IvfPqIndex

__all__ = ["brute_force", "ivf_flat", "ivf_pq", "kmeans", "recall",
           "IvfFlatIndex", "IvfPqIndex"]
