"""Capture / cache-key completeness auditor.

The port's copy of `matrixone_tpu/utils/keys.py` (its runtime half; the
static pass of the JAX package's tools has no counterpart here).  A
cached fused step must be keyed by everything it captures.  For a CUDA
graph that matters more than for a traced program: a graph holds the
addresses of the dictionary LUTs and constants it baked, so a key that
misses their content serves wrong rows silently.

Armed (`MO_KEY_AUDIT=1` or `arm()`), every fragment-cache surface calls

    keys.audit("<relpath>:<label>", cache_key, {dep_name: value, ...})

once per cache access, where the deps are the capture-relevant values
recomputed from source state (dictionary contents, baked literal
values, lifted-literal arity, the encoding policy), never sliced back
out of the key.  The first sight of a (site, key) records a content
hash per dep and the recording stack; every later sight re-hashes and
compares.  A mismatch means the key collided: two capture contents
mapped to one cached step.  Disarmed, an audit costs one module
attribute read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import traceback
from collections import OrderedDict
from typing import Dict, List

import numpy as np

_ARMED = os.environ.get("MO_KEY_AUDIT", "0").lower() not in (
    "0", "", "false", "off")

#: recorded (site, key) entries kept; eviction only means the next
#: sight re-records (a fresh baseline), never a false finding
MAX_RECORDS = 4096
#: findings kept verbatim; later duplicates only bump `count`
MAX_FINDINGS = 200
_STACK_FRAMES = 8


def armed() -> bool:
    return _ARMED


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


class _ArmedScope:
    """Context manager: arm for the duration, restore the prior state."""

    def __enter__(self):
        self._prev = _ARMED
        arm()
        return self

    def __exit__(self, *exc):
        global _ARMED
        _ARMED = self._prev
        return False


def armed_scope() -> _ArmedScope:
    return _ArmedScope()


def _encode(v, h, depth: int = 0) -> None:
    """Feed a canonical byte form of `v` into hasher `h`.  Host values
    only: tensors are digested by (dtype, shape) without content, since
    reading them back would sync the device on the audit path."""
    if depth > 6:
        h.update(b"<deep>")
        return
    if v is None:
        h.update(b"N")
    elif isinstance(v, bool):
        h.update(b"b1" if v else b"b0")
    elif isinstance(v, (int, np.integer)):
        h.update(b"i" + str(int(v)).encode())
    elif isinstance(v, (float, np.floating)):
        h.update(b"f" + repr(float(v)).encode())
    elif isinstance(v, str):
        h.update(b"s" + v.encode("utf-8", "replace"))
    elif isinstance(v, bytes):
        h.update(b"y" + v)
    elif isinstance(v, np.ndarray):
        h.update(b"a" + str(v.dtype).encode() + str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, (list, tuple)):
        h.update(b"(" if isinstance(v, tuple) else b"[")
        for x in v:
            _encode(x, h, depth + 1)
            h.update(b",")
        h.update(b")")
    elif isinstance(v, (set, frozenset)):
        h.update(b"{")
        for d in sorted(digest(x) for x in v):
            h.update(d.encode())
        h.update(b"}")
    elif isinstance(v, dict):
        h.update(b"d{")
        for k in sorted(v, key=repr):
            _encode(k, h, depth + 1)
            h.update(b":")
            _encode(v[k], h, depth + 1)
        h.update(b"}")
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        h.update(b"D" + type(v).__qualname__.encode())
        for f in dataclasses.fields(v):
            h.update(f.name.encode() + b"=")
            _encode(getattr(v, f.name, None), h, depth + 1)
    elif callable(v):
        h.update(b"F" + getattr(v, "__qualname__",
                                type(v).__qualname__).encode())
    elif hasattr(v, "dtype") and hasattr(v, "shape"):
        h.update(b"A" + str(v.dtype).encode() + str(tuple(v.shape)).encode())
    else:
        h.update(b"O" + type(v).__qualname__.encode())


def digest(v) -> str:
    """Stable content hash of one capture value (hex, 16 bytes)."""
    h = hashlib.blake2b(digest_size=16)
    _encode(v, h)
    return h.hexdigest()


class Finding:
    """One capture-content mismatch under a colliding cache key."""

    __slots__ = ("site", "name", "detail", "record_stack", "hit_stack",
                 "count")

    def __init__(self, site, name, detail, record_stack, hit_stack):
        self.site = site
        self.name = name
        self.detail = detail
        self.record_stack = record_stack
        self.hit_stack = hit_stack
        self.count = 1

    def format(self) -> str:
        extra = f" (x{self.count})" if self.count > 1 else ""
        return (f"[key-capture-mismatch] {self.site} capture "
                f"{self.name!r}: {self.detail}{extra}\n"
                f"  recorded at:\n{self.record_stack}"
                f"  hit at:\n{self.hit_stack}")


_LOCK = threading.Lock()
_RECORDS: "OrderedDict[tuple, dict]" = OrderedDict()
_FINDINGS: List[Finding] = []
_OBSERVED: Dict[str, set] = {}


def _stack() -> str:
    frames = traceback.format_stack()[:-2]
    return "".join("    " + ln for f in frames[-_STACK_FRAMES:]
                   for ln in f.splitlines(keepends=True))


def _site_label(site: str) -> str:
    return site.rsplit(":", 1)[-1]


def _record_finding(site, name, detail, record_stack, hit_stack) -> None:
    from matrixone_tpu_torch.utils import metrics as M
    with _LOCK:
        for f in _FINDINGS:
            if f.site == site and f.name == name:
                f.count += 1
                break
        else:
            if len(_FINDINGS) < MAX_FINDINGS:
                _FINDINGS.append(Finding(site, name, detail, record_stack,
                                         hit_stack))
    M.key_findings.inc(site=_site_label(site))


def audit(site: str, key, deps: Dict[str, object]) -> None:
    """One call per cache access: the first sight of (site, key)
    records a content hash per dep; every later sight re-hashes and
    compares, and a mismatch is reported with both stacks."""
    if not _ARMED:
        return
    from matrixone_tpu_torch.utils import metrics as M
    kd = digest(key)
    fresh = {name: digest(v) for name, v in deps.items()}
    with _LOCK:
        _OBSERVED.setdefault(site, set()).update(fresh)
        rec = _RECORDS.get((site, kd))
        if rec is None:
            _RECORDS[(site, kd)] = {"deps": fresh, "stack": _stack()}
            while len(_RECORDS) > MAX_RECORDS:
                _RECORDS.popitem(last=False)
            M.key_captures.inc(len(fresh))
            return
        _RECORDS.move_to_end((site, kd))
        mismatched = [name for name, d in fresh.items()
                      if rec["deps"].get(name) not in (None, d)]
        for name, d in fresh.items():
            rec["deps"].setdefault(name, d)
        record_stack = rec["stack"]
    M.key_audits.inc(outcome="mismatch" if mismatched else "ok")
    for name in mismatched:
        _record_finding(
            site, name,
            "content changed under an UNCHANGED cache key: the key is "
            "missing this capture (a stale cached step served)",
            record_stack, _stack())


def clear() -> None:
    """Drop findings, records and the observed inventory."""
    with _LOCK:
        del _FINDINGS[:]
        _RECORDS.clear()
        _OBSERVED.clear()


def report() -> dict:
    with _LOCK:
        return {"armed": _ARMED,
                "records": len(_RECORDS),
                "sites": sorted(_OBSERVED),
                "findings": len(_FINDINGS),
                "findings_list": [f.format() for f in _FINDINGS[:10]]}
