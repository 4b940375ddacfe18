"""Runtime fault injection (reference: pkg/util/fault fault.go:44-53 —
RETURN/SLEEP/PANIC/WAIT actions at named trigger sites, settable at
runtime through `Session.execute("set fault_point = ...")`,
`select mo_ctl('fault', ...)` or the Python API).

The port's copy of `matrixone_tpu/utils/fault.py`.  A fault point
optionally fires probabilistically (`prob=0.3`), on every Nth hit
(`every=3`), or only for the first K hits (`times=1`): the SQL spec is
`'name:action[:arg][:mod[:mod...]]'`, e.g.
`set fault_point = 'object.read:return:fail:times=1'`.

Trigger sites of the port (the JAX package's local ones):
  commit.before      engine commit pipeline entry
  scan.before        table scan entry
  object.read        objectio column-block and whole-object reads
  object.write       objectio object writes
  wal.append         WAL append
  merge.rewrite      merge, entering the rewrite without the commit lock
                     (the scheduler isolates the failure and retries
                     with backoff; foreground commits proceed)
  merge.swap         merge, before the swap under the commit lock
                     publishes the merged segment and its fence
  rpc.send           cluster/rpc.py, before a request is framed
                     ("drop", or "partial": half a frame, then a drop)
  rpc.recv           cluster/rpc.py, after the request reached the peer
                     ("drop": the reply is lost)
  logtail.subscribe  cluster/cn.py, a CN dialing the TN's logtail
                     ("drop": the subscription fails; the consumer
                     backs off and retries)

The JAX package's `proxy.relay` and `udf.remote` wait for the port's
proxy and remote UDF services (ROADMAP.md, section A).  Unarmed, a site
costs one attribute read.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

_ACTIONS = ("return", "sleep", "panic", "wait")


class FaultPoint:
    def __init__(self, name: str, action: str, arg=None,
                 prob: Optional[float] = None, every: Optional[int] = None,
                 times: Optional[int] = None):
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; use one of {_ACTIONS}")
        self.name = name
        self.action = action
        self.arg = arg
        self.prob = prob
        self.every = every
        self.times = times
        self.hits = 0         # times the site was reached while armed
        self.fired = 0        # times the fault actually triggered
        self.event = threading.Event()

    def should_fire(self) -> bool:
        """Called with the injector lock held; `hits` already counted."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.every is not None and self.hits % self.every != 0:
            return False
        if self.prob is not None and random.random() >= self.prob:
            return False
        return True


class FaultInjector:
    def __init__(self):
        self._points: Dict[str, FaultPoint] = {}
        self._lock = threading.Lock()
        #: lock-free fast path: hot seams (object reads, rpc sends) call
        #: trigger() per operation — when nothing is armed the cost must
        #: be one attribute read, not a lock acquisition
        self._armed = False

    def add(self, name: str, action: str, arg=None,
            prob: Optional[float] = None, every: Optional[int] = None,
            times: Optional[int] = None):
        with self._lock:
            self._points[name] = FaultPoint(name, action, arg, prob=prob,
                                            every=every, times=times)
            self._armed = True

    def remove(self, name: str):
        with self._lock:
            fp = self._points.pop(name, None)
            if fp is not None:
                fp.event.set()   # release waiters
            self._armed = bool(self._points)

    def clear(self):
        with self._lock:
            for fp in self._points.values():
                fp.event.set()
            self._points = {}
            self._armed = False

    def notify(self, name: str):
        with self._lock:
            fp = self._points.get(name)
        if fp is not None:
            fp.event.set()

    def trigger(self, name: str) -> Optional[object]:
        """Call at an injection site. Returns the RETURN arg (site decides
        how to interpret it), or None when no fault is armed/fired."""
        if not self._armed:
            return None
        with self._lock:
            fp = self._points.get(name)
            if fp is None:
                return None
            fp.hits += 1
            if not fp.should_fire():
                return None
            fp.fired += 1
        from matrixone_tpu_torch.utils.metrics import fault_fired
        fault_fired.inc(point=name)
        if fp.action == "return":
            return fp.arg
        if fp.action == "sleep":
            time.sleep(float(fp.arg or 0))
            return None
        if fp.action == "panic":
            raise RuntimeError(f"fault point {name!r} panic")
        if fp.action == "wait":
            fp.event.wait(timeout=float(fp.arg) if fp.arg else None)
            return None
        return None

    def status(self):
        with self._lock:
            return {n: (p.action, p.arg, p.hits)
                    for n, p in self._points.items()}

    def describe(self):
        """Full operational view (mo_ctl('fault','status'))."""
        with self._lock:
            return {n: {"action": p.action, "arg": p.arg, "hits": p.hits,
                        "fired": p.fired, "prob": p.prob,
                        "every": p.every, "times": p.times}
                    for n, p in self._points.items()}


def parse_spec(spec: str):
    """'name:action[:arg][:mod...]' -> add() kwargs. Mods: prob=0.3 (or
    p=0.3), every=3, times=1. An empty arg segment ('name:panic::times=1')
    means no arg."""
    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError("fault_point format: 'name:action[:arg][:mod...]'")
    kwargs = {"name": parts[0], "action": parts[1],
              "arg": (parts[2] or None) if len(parts) > 2 else None}
    for mod in parts[3:]:
        if not mod:
            continue
        if "=" not in mod:
            raise ValueError(f"bad fault modifier {mod!r}; "
                             "use prob=F | every=N | times=K")
        k, v = mod.split("=", 1)
        k = k.strip().lower()
        if k in ("p", "prob"):
            kwargs["prob"] = float(v)
        elif k == "every":
            kwargs["every"] = int(v)
        elif k == "times":
            kwargs["times"] = int(v)
        else:
            raise ValueError(f"unknown fault modifier {k!r}")
    return kwargs


#: process-global injector (reference: fault package singleton)
INJECTOR = FaultInjector()
