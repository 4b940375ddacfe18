"""Device-owning compute worker: the serving path of vector search.

Counterpart of `WorkerCore` in `matrixone_tpu/worker/server.py` (the
cuvs_worker_t design: a persistent owner of device-resident indexes with
dynamic batching of concurrent searches), in its single, replicated and
sharded index modes over the slots of the mesh (`parallel/mesh.py`).
The JAX package's `run_stage` operators and its gRPC transport are not
ported (the card machine has neither pyarrow nor grpc).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict

import numpy as np
import torch

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vectorindex import ivf_flat


class _MicroBatcher:
    """Dynamic micro-batching of concurrent searches against one index
    (reference: cgo/cuvs dynamic_batching.hpp). Drain-loop design: the
    first arrival becomes the key's dispatcher and loops draining the
    bucket; requests that land WHILE a dispatch is on the device coalesce
    into the next batch.

    Coalescing needs a short collection LINGER: once the device path is
    warm a dispatch returns in about a millisecond, so a drain loop that
    grabs the queue at once sees only what raced in during that time.
    The leader therefore waits up to `linger_s` while there are MORE
    requests in flight (entered `run`, not yet dispatched) than are
    queued on its key, i.e. while stragglers are demonstrably on their
    way. A sequential caller pays no added latency: with one request in
    flight the linger condition is false on arrival. No thread of its
    own: every dispatch runs on the thread of a caller."""

    def __init__(self, max_batch: int = 256, linger_s: float = 0.004):
        self.max_batch = max_batch
        self.linger_s = linger_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[tuple, list] = {}
        self._busy: Dict[tuple, bool] = {}
        self._inflight = 0         # entered run(), not yet dispatch-grabbed
        self.dispatches = 0
        self.requests = 0

    @staticmethod
    def _count(batch) -> None:
        M.vector_batch_rows.inc(sum(len(e["q"]) for e in batch))
        M.vector_batch_coalesced.inc(len(batch) - 1)

    def run(self, key: tuple, queries: np.ndarray, fn):
        """fn(all_queries) -> (d, i) arrays; returns this caller's slice."""
        entry = {"q": queries, "out": None, "err": None,
                 "ev": threading.Event()}
        with self._cv:
            self.requests += 1
            self._inflight += 1
            self._pending.setdefault(key, []).append(entry)
            self._cv.notify_all()
            leader = not self._busy.get(key, False)
            if leader:
                self._busy[key] = True
        if not leader:
            entry["ev"].wait(timeout=120)
            if entry["err"] is not None:
                raise entry["err"]
            if entry["out"] is None:
                raise TimeoutError("batch dispatcher never returned")
            return entry["out"]
        clean_exit = False
        try:
            while True:
                with self._cv:
                    if self.linger_s > 0:
                        # every arrival buys another linger_s, hard-capped
                        # at 5x so the added latency stays bounded under
                        # a sustained arrival stream
                        now = time.monotonic()
                        deadline = now + self.linger_s
                        hard = now + 5 * self.linger_s
                        seen = len(self._pending.get(key, ()))
                        while seen < min(self._inflight, self.max_batch):
                            left = min(deadline, hard) - time.monotonic()
                            if left <= 0:
                                break
                            self._cv.wait(left)
                            cur = len(self._pending.get(key, ()))
                            if cur > seen:
                                seen = cur
                                deadline = time.monotonic() + self.linger_s
                    bucket = self._pending.get(key, [])
                    batch, rest = (bucket[:self.max_batch],
                                   bucket[self.max_batch:])
                    if rest:
                        self._pending[key] = rest
                    else:
                        self._pending.pop(key, None)
                    self._inflight -= len(batch)
                    if not batch:
                        self._busy[key] = False
                        clean_exit = True
                        break
                    self.dispatches += 1
                    self._count(batch)
                try:
                    outs = fn(np.concatenate([e["q"] for e in batch]))
                    off = 0
                    for e in batch:
                        n = len(e["q"])
                        e["out"] = tuple(o[off:off + n] for o in outs)
                        off += n
                except Exception as err:   # noqa: BLE001 — delivered to
                    for e in batch:        # every co-batched caller and
                        e["err"] = err     # re-raised on their threads
                finally:
                    for e in batch:
                        e["ev"].set()
        finally:
            # interrupt-path safety: never leave the key wedged busy.
            # Only on the abnormal path: after a clean exit the flag was
            # released under the lock, and a newer leader may hold it.
            if not clean_exit:
                with self._lock:
                    self._busy[key] = False
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]


class WorkerCore:
    """Device-owning state + search execution (transport-independent).

    `device` defaults to CUDA and raises without it; the tests pass
    device="cpu"."""

    def __init__(self, device=None, linger_s: float = 0.004):
        self.device = resolve_device(device)
        self.indexes: Dict[str, dict] = {}
        self.started = time.time()
        self._lock = threading.Lock()
        self.batcher = _MicroBatcher(linger_s=linger_s)

    # ---- index lifecycle
    def load_index(self, name: str, data: np.ndarray, nlist: int = 64,
                   metric: str = "l2", mode: str = "single") -> dict:
        """Build an IVF-Flat index of `data` on the worker's device and
        serve it under `name` in `mode` (`serve_index`), with the JAX
        worker's build settings (nlist, metric, bf16 storage, capped
        balancing)."""
        if mode not in ("single", "sharded", "replicated"):
            raise ValueError(f"unknown index mode {mode!r}")
        idx = ivf_flat.build(np.asarray(data, np.float32),
                             nlist=max(1, min(nlist, len(data))),
                             metric=metric, storage_dtype=torch.bfloat16,
                             device=self.device)
        return self.serve_index(name, idx, mode)

    def serve_index(self, name: str, idx, mode: str = "single") -> dict:
        """Serve a built IvfFlatIndex under `name`.  The modes are the
        reference's (cuvs_worker_t single / replicated / sharded), over
        the slots of the mesh (`parallel/mesh.devices`):

          * "sharded": ONE index, its inverted lists cluster-sharded over
            the slots (`vectorindex/sharded.py`); a search returns the
            single index's candidates;
          * "replicated": the index on every slot, searches taken round
            robin (replicas on one card share the index's storage: `.to`
            the same device is no copy).

        With one slot, "sharded" serves the single index."""
        from matrixone_tpu_torch.parallel import mesh as MS
        slots = MS.devices(self.device)
        if mode == "sharded":
            from matrixone_tpu_torch.vectorindex import sharded as shmod
            n_shards = max(1, min(len(slots), idx.nlist))
            if n_shards > 1:
                entry = {"mode": "sharded", "n": idx.n,
                         "sharded": shmod.shard_ivf(
                             idx, MS.Mesh(tuple(slots[:n_shards])))}
            else:
                entry = {"mode": "single", "index": idx, "n": idx.n}
        elif mode == "replicated":
            replicas = [dataclasses.replace(
                idx, **{f.name: getattr(idx, f.name).to(d)
                        for f in dataclasses.fields(idx)
                        if isinstance(getattr(idx, f.name), torch.Tensor)})
                for d in slots]
            entry = {"mode": "replicated", "replicas": replicas,
                     "rr": [0], "n": idx.n}
        elif mode == "single":
            entry = {"mode": "single", "index": idx, "n": idx.n}
        else:
            raise ValueError(f"unknown index mode {mode!r}")
        with self._lock:
            self.indexes[name] = entry
        return {"ok": True, "n": idx.n, "mode": mode,
                "devices": len(slots)}

    def search_index(self, name: str, queries: np.ndarray, k: int = 10,
                     nprobe: int = 8):
        """Batched (dynamic micro-batching) search against a loaded index;
        returns (distances [n, k] f32, ids [n, k] int64) as numpy."""
        entry = self.indexes[name]
        if len(queries) == 0:
            return (np.zeros((0, 1), np.float32), np.zeros((0, 1), np.int64))
        # query dim is part of the key: a malformed-dim request must fail
        # alone, not poison the concatenation of a whole co-batch
        key = (name, k, nprobe, int(queries.shape[1]))
        return self.batcher.run(
            key, queries, lambda qs: self._search_all(entry, qs, k, nprobe))

    def _search_all(self, entry: dict, q: np.ndarray, k: int, nprobe: int):
        q = np.asarray(q, np.float32)
        if entry["mode"] == "sharded":
            from matrixone_tpu_torch.vectorindex import sharded as shmod
            idx = entry["sharded"]
            search = shmod.search_sharded
        else:
            if entry["mode"] == "replicated":
                with self._lock:
                    r = entry["rr"][0]
                    entry["rr"][0] = (r + 1) % len(entry["replicas"])
                idx = entry["replicas"][r]
            else:
                idx = entry["index"]
            search = ivf_flat.search
        np_ = min(nprobe, idx.nlist)
        kk = min(k, idx.n, np_ * idx.max_cluster_size) or 1
        d, i = search(idx, q, k=kk, nprobe=np_)
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def health(self) -> dict:
        dev = self.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return {"backend": dev.type,
                "devices": [name],
                "uptime_s": round(time.time() - self.started, 1),
                "indexes": sorted(self.indexes),
                "batch_requests": self.batcher.requests,
                "batch_dispatches": self.batcher.dispatches}
