"""Distribution: the device shards over the slot mesh (`mesh.py`,
`dist_query.py`, `merge_exec.py`) and the host peers, fragment servers
reached over the RPC fabric (`fragments.py`, `cluster/`).  The JAX
package's `remote_exec.py` (stages through its gRPC worker) is not
ported: the card machine has no grpcio."""

from matrixone_tpu_torch.parallel import dist_query, mesh
from matrixone_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                               shard_rows, simulated_slots)

__all__ = ["dist_query", "mesh", "make_mesh", "replicate", "shard_rows",
           "simulated_slots"]
