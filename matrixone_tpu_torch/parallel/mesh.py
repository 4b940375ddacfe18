"""The device mesh of the port: an ordered list of slots in one process.

The port of `matrixone_tpu/parallel/mesh.py`.  The reference's device
path is single-controller: one Python process loops over
`jax.devices()[:n]`, runs each shard's fragment under that device, and
merges the partials with `shard_map` collectives inside the same
process (`parallel/dist_query.py`, `merge_exec.py`,
`vectorindex/sharded.py`).  The port keeps that shape:

  * a mesh is an ordered list of **slots**, each a `torch.device`;
    shard s of a plan runs on slot s;
  * `devices()` stands where the reference calls `jax.devices()`: one
    slot per visible CUDA device, or the one CPU when the caller asks
    for the CPU.  On a machine with one card that is one slot, so a
    plan asking for 2 shards or more degrades to one device there,
    exactly as the reference does on one TPU chip;
  * `simulated_slots(n)` lays n slots round-robin over the devices
    present for a scope: the counterpart of the reference's test rig,
    which forces 8 host devices (`--xla_force_host_platform_device_
    count=8`).  The port's tests and `chip_smoke.py` run under 8, so
    `query_shards` 2, 4 and 8 shard and 9 degrades;
  * the collectives are plain functions over one tensor per slot:
    `psum` and `pmax` move every part to the destination slot and fold
    them in slot order (a fixed order: the same bits on every run),
    `all_gather` concatenates in slot order and `all_to_all` hands each
    destination its slices in source order.  A move to the device a
    tensor is on is no copy, so on one card the slots share memory; on
    several cards a move is a peer copy.

There is no `torch.distributed` and no NCCL here: NCCL cannot put two
ranks on one card, and the reference's device path is one process.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, List, Optional, Sequence

import torch

#: the slot count of the innermost `simulated_slots` scope of this
#: context (None: one slot per device present); a scope in one thread
#: leaves every other thread's mesh as it was
_SIMULATED: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "simulated_slots", default=None)


def _base_devices(device=None) -> List[torch.device]:
    """The devices present for `device`'s kind: every visible CUDA
    device, or the one CPU."""
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def devices(device=None) -> List[torch.device]:
    """The slots a mesh can take, in order (`jax.devices()`'s place):
    one per device of `device`'s kind, or as many as the innermost
    `simulated_slots` scope lays over them, round-robin."""
    base = _base_devices(device)
    n = _SIMULATED.get()
    if n is None:
        return base
    return [base[i % len(base)] for i in range(n)]


@contextlib.contextmanager
def simulated_slots(n: int) -> Iterator[None]:
    """For the scope, `devices()` returns n slots laid round-robin over
    the devices present (8 slots on one card are 8 views of it).  The
    count is held per context (a `contextvars.ContextVar`), so the scope
    covers the calling thread and what runs in its context, not other
    threads."""
    if n < 1:
        raise ValueError(f"simulated_slots: n must be >= 1, got {n}")
    token = _SIMULATED.set(int(n))
    try:
        yield
    finally:
        _SIMULATED.reset(token)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of slots with the reference's one axis name."""
    slots: tuple
    axis_name: str = "shard"

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> tuple:
        return self.slots


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shard",
              device=None) -> Mesh:
    devs = devices(device)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_mesh: {n_devices} slots asked for, "
                             f"{len(devs)} present")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis_name)


def shard_rows(mesh: Mesh, arr: torch.Tensor) -> List[torch.Tensor]:
    """A [n, ...] tensor split row-wise over the mesh: slot s holds rows
    [s n / S, (s + 1) n / S) (n must divide, as a row sharding of the
    reference's requires)."""
    n = arr.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_rows: {n} rows do not split over "
                         f"{mesh.size} slots")
    per = n // mesh.size
    return [arr[s * per:(s + 1) * per].to(d)
            for s, d in enumerate(mesh.slots)]


def replicate(mesh: Mesh, arr: torch.Tensor) -> List[torch.Tensor]:
    """The tensor on every slot (no copy where the slot is its device)."""
    return [arr.to(d) for d in mesh.slots]


# ------------------------------------------------------------ collectives

def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of one tensor per slot on `device`, added in slot order."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def pmax(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The elementwise maximum of one tensor per slot on `device`."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(device))
    return acc


def all_gather(parts: Sequence[torch.Tensor], device,
               dim: int = 0) -> torch.Tensor:
    """One tensor per slot concatenated along `dim` in slot order."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def all_to_all(mesh: Mesh, buckets: Sequence[Sequence[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """`buckets[s][p]` is what source slot s sends destination slot p;
    slot p receives the concatenation of its slices in source order."""
    return [torch.cat([buckets[s][p].to(d) for s in range(mesh.size)])
            for p, d in enumerate(mesh.slots)]
