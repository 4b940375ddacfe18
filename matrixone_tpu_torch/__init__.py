"""matrixone_tpu_torch — the PyTorch/CUDA port of `matrixone_tpu`.

A second package beside the JAX one, written for one NVIDIA H100.  Its
slices so far are vector search — IVF-Flat served by `WorkerCore`, and
IVF-PQ (`vectorindex/ivf_pq.py`) — and the relational path from SQL
text to the device: `frontend.Session.execute` over the SQL front end
(`sql/`), an MVCC engine (`storage/engine.py`: a WAL, checkpoints to
objects in the port's own format, object-backed segments behind a
block cache with a device tier, merges) and the
executor (`vm/`: scans, filters, projections, hash joins, grouped
aggregates, windows, sort, top-k, limit), whose fusable chains run as
fused fragments, each step one CUDA graph replayed once per batch
(`vm/fusion.py`, `vm/graphs.py`), as the JAX package runs them by
default; and distribution, over the slots of the device mesh
(`parallel/`) and over host peers: fragment servers, a TN and its CN
replicas in the reference's CN/TN split (`cluster/`).  It
mirrors the JAX package's layout (`container/`, `ops/`, `sql/`, `vm/`,
`frontend/`, `vectorindex/`, `worker/`, `utils/`) so each module's
counterpart is easy to find, and it is held against that package on
the same inputs by the `tests/test_torch_*.py` suite.  It imports
`torch` and numpy only: never `jax` and nothing of `matrixone_tpu`,
whose host-only helpers it keeps its own copies of.

Device rule: functions run where their input tensors live.  Entry
points that take numpy (`WorkerCore`, `ivf_flat.build`,
`ivf_pq.build`, the data generator, `Session` and the executor's
`ExecContext`) resolve their `device` argument
with `resolve_device`, which defaults to CUDA and raises when CUDA is
missing unless the caller asks for the CPU.  A CUDA tensor always runs the hand-written CUDA kernel
(`ops/cuda_kernels.py`); a CPU tensor runs its plain PyTorch version.
There is no switch between the two and no fallback.

Importing the package builds nothing and does not initialise CUDA: the
kernels are compiled at their first launch.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point taking host data should work on.

    None means CUDA.  Asking for CUDA without a usable CUDA runtime
    raises a RuntimeError rather than silently running on the CPU; the
    CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "matrixone_tpu_torch: CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


# the index types, after resolve_device: their modules import it
from matrixone_tpu_torch.vectorindex import (  # noqa: E402
    IvfFlatIndex, IvfPqIndex)

__all__ = ["resolve_device", "IvfFlatIndex", "IvfPqIndex"]
