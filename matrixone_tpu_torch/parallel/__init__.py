"""Distribution over the slot mesh (`mesh.py`): the device-shard half of
the JAX package's `parallel/` (its host-peer half is a later slice)."""

from matrixone_tpu_torch.parallel import dist_query, mesh
from matrixone_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                               shard_rows, simulated_slots)

__all__ = ["dist_query", "mesh", "make_mesh", "replicate", "shard_rows",
           "simulated_slots"]
