"""Capture and replay of one fused step as a CUDA graph.

The port's counterpart of `jax.jit` for the fused fragments
(vm/fusion.py, vm/fusion_join.py, vm/fusion_window.py): where the JAX
package compiles a fragment's step function into one program per
fragment key, the port captures it once as a CUDA graph and replays the
graph once per batch.  A graph replays exactly the kernels the eager
step launched (the plain torch ops and the hand-written kernels), so
the fused path computes what the per-operator path computes; nothing is
re-fused.

`StepGraph` holds, for one step and one key:

  * the static input buffers (columns, validities, mask, row count,
    lifted literals, the LIMIT counters, the build side of a join, the
    aggregate or top-k carry).  Each call copies every input in, except
    the carry buffers themselves and the inputs the caller names stable
    for the execution (the build side of a join probe), which are copied
    once and then skipped while they are the same tensor, unchanged.  A
    replay rewrites its outputs without bumping their `_version`, so an
    input that may be a graph's output (the LIMIT counters) is never
    taken as unchanged;
  * the warm-up: the first call runs the step once eagerly on the static
    buffers (which also builds the hand kernels and records the host
    constants the step copies to the card, `container.device.ConstTape`),
    then captures it and replays it;
  * the graph's private memory pool (`torch.cuda.graph` gives each graph
    its own): fragments replay interleaved (a join's build, its probe, a
    terminal above), so pools are not shared.  `held_bytes` is what the
    graph holds on the card (its pool and its static buffers), which the
    fragment cache bounds (vm/fusion.FragmentCompileCache);
  * the launch accounting: the hand kernels' wrappers count where they
    are called, which under a graph is once, at capture.  The capture's
    counts are taken back and added again at every replay
    (`ops/cuda_kernels.LAUNCHES`).

A carried step (a grouped or scalar aggregate, a top-k) returns its new
carry first; the captured graph copies it back into its carry input
buffers inside the graph, so the carry stays on the card between
replays.  The outputs of a graph are overwritten by its next replay: a
caller that keeps one across the next call clones it.

Concurrent executions (sessions on several threads, the same fragment
key) never share a graph: a graph belongs to one execution from its
first call in it to `release` at the execution's end (`owner`), and an
execution that finds its key's graph owned by another captures a spare
of its own (`claim`), kept in the cache entry for the next
concurrent execution.  Captures are serialized (`_CAPTURE_LOCK`:
`torch.cuda.graph` captures on one side stream shared by all captures)
and run in the thread-local capture mode, so another thread's CUDA work
meanwhile neither fails the capture nor lands in it; the launches a
capture records are counted on the capturing thread only
(`LAUNCHES.recording`).  Nothing falls back to eager execution on a
conflict.

Nothing here catches an error: a capture or replay that raises on the
card is a fault of the step and propagates.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from matrixone_tpu_torch.container.device import ConstTape, const_tape
from matrixone_tpu_torch.ops.cuda_kernels import LAUNCHES
from matrixone_tpu_torch.utils import metrics as M


#: one capture at a time (the capture side stream is shared)
_CAPTURE_LOCK = threading.Lock()
#: guards which execution owns which graph and the entries' graph
#: lists (re-entrant: `drop_free_spares` holds it while its `over`
#: reads `entry_graphs`)
_OWN_LOCK = threading.RLock()


def _static_copy(x, device):
    """A fresh device buffer holding x (a static input of a graph)."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.to(device).clone()


class StepGraph:
    """One step function captured on the card for one fragment key."""

    def __init__(self, fn, carry_index: Optional[int] = None,
                 stable: Sequence[int] = ()):
        self.fn = fn
        self.carry_index = carry_index
        #: top-level argument positions fixed for an execution
        self.stable = frozenset(stable)
        self.graph = None
        self._spec = None
        self._static = None       # flat static inputs
        self._stable_flat = None  # per flat input: in a stable argument
        self._last = None         # (source tensor, its version) per input
        self._out = None
        self._tape = ConstTape()
        #: {(kernel, shape): launches} one replay makes
        self.launches: dict = {}
        self.replays = 0
        self.capture_s = 0.0
        #: device bytes the graph holds: its static buffers and recorded
        #: constants, and what its capture reserved (its private pool)
        self.held_bytes = 0
        #: the execution that runs the graph until its `release`
        self.owner = None
        self.device = None

    @property
    def active(self) -> bool:
        """Owned by an execution that has not ended."""
        return self.owner is not None

    # --------------------------------------------------------- helpers
    def _body(self, *args):
        """The step as captured: the carry's new value is copied back
        into the carry buffers (inside the graph)."""
        out = self.fn(*args)
        ci = self.carry_index
        if ci is None or args[ci] is None:
            return out
        dst, _ = tree_flatten(args[ci])
        src, _ = tree_flatten(out[0])
        for d, s in zip(dst, src):
            d.copy_(s)
        return (args[ci],) + tuple(out[1:])

    def _bind(self, flat, spec, static) -> None:
        """Take `static` as the graph's input buffers for inputs shaped
        as `flat`, `spec`."""
        self._spec = spec
        self._static = static
        self._stable_flat = [
            flag for pos, a in enumerate(tree_unflatten(flat, spec))
            for flag in [pos in self.stable] * len(tree_flatten(a)[0])]
        self._last = [None] * len(flat)

    def _load(self, flat) -> None:
        for i, (dst, src) in enumerate(zip(self._static, flat)):
            if not isinstance(dst, torch.Tensor):
                if dst != src:
                    raise RuntimeError(
                        f"fused step: input {i} is {src!r}, the graph was "
                        f"captured with {dst!r}")
                continue
            if src is dst:
                continue
            stable = self._stable_flat[i]
            last = self._last[i]
            if stable and last is not None and last[0] is src \
                    and last[1] == src._version:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise RuntimeError(
                    f"fused step: input {i} is {src.dtype} "
                    f"{tuple(src.shape)}, the graph was captured with "
                    f"{dst.dtype} {tuple(dst.shape)}")
            if src.device.type == "cpu" and dst.device.type != "cpu":
                # a lifted literal: one host value, written by a fill
                dst.fill_(src.item())
            else:
                dst.copy_(src)
            if stable:
                self._last[i] = (src, src._version)

    def _count_replay(self) -> None:
        for (name, shape), n in self.launches.items():
            LAUNCHES.add(name, shape, n)
        self.replays += 1
        M.fusion_graphs.inc(event="replay")

    # ----------------------------------------------------------- call
    def __call__(self, args):
        flat, spec = tree_flatten(args)
        if self.graph is None:
            return self._capture(flat, spec)
        if spec != self._spec:
            raise RuntimeError("fused step: the inputs' structure differs "
                               "from the captured graph's")
        self._load(flat)
        self.graph.replay()
        self._count_replay()
        return self._out

    def _capture(self, flat, spec):
        t0 = time.perf_counter()
        device = self.device = next(
            x.device for x in flat
            if isinstance(x, torch.Tensor) and x.is_cuda)
        self._bind(flat, spec, [_static_copy(x, device) for x in flat])
        args = tree_unflatten(self._static, spec)
        carry = (args[self.carry_index] if self.carry_index is not None
                 else None)
        carry_flat = tree_flatten(carry)[0] if carry is not None else []
        carry_saved = [c.clone() for c in carry_flat]
        # warm-up: builds the kernels, records the host constants; its
        # launches are real and stay counted
        with const_tape(self._tape, "record"):
            self._body(*args)
        for c, v in zip(carry_flat, carry_saved):
            c.copy_(v)                 # undo the warm-up's carry update
        del carry_saved
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, LAUNCHES.recording() as recorded:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                with const_tape(self._tape, "replay"):
                    out = self._body(*args)
        # what the graph holds: its static buffers, the recorded
        # constants and its private pool's segments (counted by pool, so
        # other threads' allocations meanwhile are not the graph's)
        self.held_bytes = sum(
            x.nbytes for x in self._static + [d for _h, d in self._tape.items]
            if isinstance(x, torch.Tensor)) + _pool_bytes(device,
                                                          graph.pool())
        # the capture launched nothing: its launches count at replays
        self.launches = {k: n for k, n in recorded.items() if n}
        self.graph = graph
        self._out = out
        M.fusion_graphs.inc(event="capture")
        self.capture_s = time.perf_counter() - t0
        self._load(flat)
        graph.replay()
        self._count_replay()
        return out

    def release(self) -> None:
        """End of the owning execution: the graph is free for the next,
        and the references to the last stable inputs (kept so an
        unchanged one is not copied again) are dropped."""
        if self._last is not None:
            self._last = [None] * len(self._last)
        self.owner = None


def _pool_bytes(device, pool) -> int:
    """Bytes of the card's memory segments in a graph's private pool."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("device") == device.index
               and tuple(seg.get("segment_pool_id", ())) == pool)


def drop_free_spares(entries, over) -> int:
    """Drop the spare graphs no execution owns, oldest entries first,
    while `over()` holds -> how many were dropped (their pools go back
    to the allocator with them)."""
    dropped = 0
    with _OWN_LOCK:
        for e in entries:
            for spares in e.get("spares", {}).values():
                for g in list(spares):
                    if not over():
                        return dropped
                    if g.owner is None:
                        spares.remove(g)
                        dropped += 1
    return dropped


def entry_graphs(entry: dict) -> list:
    """Every graph of a fragment cache entry: one per slot, and the
    spares concurrent executions captured."""
    with _OWN_LOCK:
        out = list(entry["graphs"].values())
        for spares in entry.get("spares", {}).values():
            out.extend(spares)
    return out


def claim(entry: dict, slot: str, fn, args, carry_index=None,
          stable: Sequence[int] = (), owner=None) -> Optional[StepGraph]:
    """The graph of `slot` that `owner`'s execution runs (a new one
    captures at its first call), or None when the step's inputs are not
    on the card: the caller then calls the step eagerly, which on the
    CPU is the fused path itself.  The graph is the one the execution
    owns already, else a free one, else a new one: the slot's first
    graph, or a spare when other executions own every graph of the slot.
    `stable` names the top-level arguments that stay the same tensors
    for the whole execution."""
    device = _device_of(args)
    if device is None or device.type != "cuda":
        return None
    return claim_in(entry, slot, lambda: StepGraph(fn, carry_index, stable),
                    owner)


def claim_in(entry: dict, slot: str, new_graph, owner):
    """The ownership rule of `claim`, `new_graph()` making a new graph."""
    with _OWN_LOCK:
        first = entry["graphs"].get(slot)
        spares = entry.setdefault("spares", {}).setdefault(slot, [])
        pool = ([first] if first is not None else []) + spares
        for g in pool:
            if g.owner is owner:
                return g
        for g in pool:
            if g.owner is None:
                g.owner = owner
                return g
        g = new_graph()
        g.owner = owner
        if first is None:
            entry["graphs"][slot] = g
        else:
            spares.append(g)
            M.fusion_graphs.inc(event="spare")
        return g


def _device_of(args) -> Optional[torch.device]:
    for x in tree_flatten(args)[0]:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    for x in tree_flatten(args)[0]:
        if isinstance(x, torch.Tensor):
            return x.device
    return None
