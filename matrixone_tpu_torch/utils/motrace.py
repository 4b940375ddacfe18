"""motrace: per-statement span trees for the port.

The port's copy of `matrixone_tpu/utils/motrace.py` (reference:
`pkg/util/trace`, per-statement span trees feeding `statement_info`).
The span tree covers a statement's life on the host:

    statement (root, frontend/session.py)
      parse                      sql/parser via Session.execute
      run                        per-statement execution envelope
        admission.queue          serving/admission.py slot wait
        plan                     prepare, bind, CBO, index rewrites
        fusion.compile           vm/fusion.py first run and graph capture
        fusion.dispatch          vm/fusion.py step call or graph replay
        join.build.livesync      vm/join.py build-side live-row drain
        txn.commit               txn/client.py commit pipeline

Spans time host work: CUDA is asynchronous, so a span around a graph
replay measures its launch, not the card's work, except in profile mode
(`MO_FUSION_PROFILE=1`) and EXPLAIN ANALYZE, which synchronize.

Across the fabric (`cluster/rpc.py`): each RPC attempt runs in an
`rpc.call` span; `inject` puts the trace context on the request header
beside `deadline_ms`, the server re-enters it (`remote_session`: a span
such as `tn.commit` under the caller's `rpc.call`), its spans collect
in the session's sink and ride back on the response header, and
`merge_remote` folds them into the caller's trace.

Cost discipline: unarmed, every instrumentation site costs one
attribute read (`TRACER.armed`): `span()` returns a shared no-op
context manager before touching anything else.  Armed, completed spans
land in a bounded ring with head sampling: the sampling decision is
made once at the root span (`MO_TRACE_SAMPLE`) and children inherit it
through the ambient context.

Knobs: `MO_TRACE` (arm), `MO_TRACE_SAMPLE` (head-sampling fraction),
`MO_TRACE_SLOW_MS` (persist slow statements' full span tree into
system_statement_info), `MO_TRACE_RING` (ring capacity, spans).
Ops surface: `SHOW TRACE`, `mo_ctl('trace', 'status|on|off|clear|'
'sample:<f>|slow:<ms>|dump:<path>')`.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Ctx:
    """Ambient trace context for one open span (immutable; the
    contextvar stack IS the span stack)."""

    __slots__ = ("trace_id", "span_id", "proc", "sink", "attrs",
                 "events")

    def __init__(self, trace_id: str, span_id: str, proc: str,
                 sink: Optional[list], attrs: dict, events: list):
        self.trace_id = trace_id
        self.span_id = span_id
        self.proc = proc
        #: remote sessions collect spans here (shipped back on the
        #: response) instead of the local ring
        self.sink = sink
        #: live references so event()/annotate() reach the OPEN span
        self.attrs = attrs
        self.events = events


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "mo_trace_ctx", default=None)


def _new_id() -> str:
    return f"{random.getrandbits(64):016x}"


class Tracer:
    """Process-global tracer: armed flag, sampling, bounded span ring."""

    def __init__(self):
        self.armed = os.environ.get("MO_TRACE", "0").lower() not in (
            "0", "", "false", "off")
        self.sample = _env_float("MO_TRACE_SAMPLE", 1.0)
        self.slow_ms = _env_float("MO_TRACE_SLOW_MS", 0.0)
        self.proc = "cn"
        cap = int(_env_float("MO_TRACE_RING", 4096))
        self._ring: deque = deque(maxlen=max(16, cap))
        self._lock = threading.Lock()

    # ------------------------------------------------------------ control
    def arm(self, sample: Optional[float] = None,
            slow_ms: Optional[float] = None) -> None:
        if sample is not None:
            self.sample = float(sample)
        if slow_ms is not None:
            self.slow_ms = float(slow_ms)
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------- record
    def record(self, rec: dict, sink: Optional[list] = None) -> None:
        """One completed span: to the remote-session sink when present
        (shipped back to the caller), else to the local ring.  The
        counter ticks only on RING arrival — a sink span counts once,
        when the trace-owning process merges it (otherwise an
        in-process TN/worker would double-count every shipped span)."""
        from matrixone_tpu_torch.utils import metrics as M
        if sink is not None:
            sink.append(rec)
            return
        M.trace_spans.inc(proc=rec["proc"])
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                M.trace_ring_dropped.inc()
            self._ring.append(rec)

    # -------------------------------------------------------------- reads
    def spans_of(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [r for r in self._ring if r["tid"] == trace_id]

    def trace_ids(self) -> List[str]:
        """Distinct trace ids, oldest first."""
        with self._lock:
            seen, out = set(), []
            for r in self._ring:
                if r["tid"] not in seen:
                    seen.add(r["tid"])
                    out.append(r["tid"])
            return out

    def traces(self) -> List[dict]:
        """Per-trace summaries (SHOW TRACE), oldest first."""
        with self._lock:
            rows: Dict[str, dict] = {}
            for r in self._ring:
                t = rows.setdefault(
                    r["tid"], {"trace_id": r["tid"], "root": "",
                               "spans": 0, "procs": set(),
                               "ts_us": r["ts_us"], "dur_ms": 0.0})
                t["spans"] += 1
                t["procs"].add(r["proc"])
                t["ts_us"] = min(t["ts_us"], r["ts_us"])
        out = []
        for t in rows.values():
            spans = self.spans_of(t["trace_id"])
            ids = {s["sid"] for s in spans}
            roots = [s for s in spans if s["psid"] not in ids]
            if roots:
                root = max(roots, key=lambda s: s["dur_us"])
                t["root"] = root["name"]
                t["dur_ms"] = round(root["dur_us"] / 1000.0, 3)
            t["procs"] = ",".join(sorted(t["procs"]))
            out.append(t)
        out.sort(key=lambda t: t["ts_us"])
        return out

    def status(self) -> dict:
        with self._lock:
            n = len(self._ring)
            tids = len({r["tid"] for r in self._ring})
        return {"armed": self.armed, "sample": self.sample,
                "slow_ms": self.slow_ms, "proc": self.proc,
                "ring_capacity": self._ring.maxlen,
                "spans": n, "traces": tids}


TRACER = Tracer()


# ------------------------------------------------------------------ spans
class _NoopSpan:
    """Shared do-nothing context manager: the disarmed/unsampled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class _Span:
    """One recording span.  ONLY ever opened via `with` (molint rule
    span-hygiene) — enter/exit balance is what keeps the ambient
    context stack and the ring consistent."""

    __slots__ = ("name", "attrs", "_tid", "_psid", "_sid", "_proc",
                 "_sink", "_events", "_t0", "_token")

    def __init__(self, name: str, trace_id: str, parent_sid: str,
                 proc: str, sink: Optional[list], attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tid = trace_id
        self._psid = parent_sid
        self._sid = _new_id()
        self._proc = proc
        self._sink = sink
        self._events: list = []
        self._t0 = 0
        self._token = None

    def __enter__(self):
        self._t0 = time.time_ns()
        self._token = _CTX.set(_Ctx(self._tid, self._sid, self._proc,
                                    self._sink, self.attrs,
                                    self._events))
        return self

    def __exit__(self, exc_type, exc, tb):
        _CTX.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        dur = time.time_ns() - self._t0
        TRACER.record({"tid": self._tid, "sid": self._sid,
                       "psid": self._psid, "name": self.name,
                       "proc": self._proc,
                       "thread": threading.current_thread().name,
                       "ts_us": self._t0 // 1000,
                       "dur_us": dur // 1000,
                       "attrs": self.attrs, "events": self._events},
                      sink=self._sink)
        return False


def span(name: str, **attrs):
    """Child span under the current context; no-op when disarmed OR
    when no sampled trace is active (head sampling: the root decides)."""
    if not TRACER.armed:
        return _NOOP
    ctx = _CTX.get()
    if ctx is None:
        return _NOOP
    return _Span(name, ctx.trace_id, ctx.span_id, ctx.proc, ctx.sink,
                 attrs)


def root_span(name: str, proc: Optional[str] = None, **attrs):
    """Explicit new-trace root, head-sampled; nested under an existing
    context it degrades to an ordinary child span (a re-entrant
    Session.execute must not fork a second trace)."""
    from matrixone_tpu_torch.utils import metrics as M
    if not TRACER.armed:
        return _NOOP
    ctx = _CTX.get()
    if ctx is not None:
        return _Span(name, ctx.trace_id, ctx.span_id, ctx.proc,
                     ctx.sink, attrs)
    if random.random() >= TRACER.sample:
        M.trace_traces.inc(outcome="unsampled")
        return _NOOP
    M.trace_traces.inc(outcome="sampled")
    return _Span(name, _new_id(), "", proc or TRACER.proc, None, attrs)


def statement_span(sql: str):
    """Root span for one Session.execute — the trace boundary."""
    if not TRACER.armed:
        return _NOOP
    return root_span("statement", sql=sql[:1024])


def event(name: str, **attrs) -> None:
    """Attach a point event to the CURRENT open span (dropped when
    disarmed or no span is open)."""
    if not TRACER.armed:
        return
    ctx = _CTX.get()
    if ctx is None:
        return
    ctx.events.append({"name": name, "ts_us": time.time_ns() // 1000,
                       "attrs": attrs})


def annotate(**attrs) -> None:
    """Merge attributes into the CURRENT open span."""
    if not TRACER.armed:
        return
    ctx = _CTX.get()
    if ctx is not None:
        ctx.attrs.update(attrs)


# --------------------------------------------------- wire propagation
def inject(header: dict) -> None:
    """Add the trace context to an outgoing wire header (it rides beside
    `deadline_ms`).  One attribute read when disarmed."""
    if not TRACER.armed:
        return
    ctx = _CTX.get()
    if ctx is not None:
        header["trace"] = [ctx.trace_id, ctx.span_id]


def merge_remote(resp_header) -> None:
    """Fold the spans a server shipped back on its response header into
    the local trace (or onward, inside a remote session of our own: a
    chain of hops forwards them toward the trace's owner)."""
    if not TRACER.armed or not isinstance(resp_header, dict):
        return
    spans = resp_header.pop("trace_spans", None)
    if not spans:
        return
    ctx = _CTX.get()
    sink = ctx.sink if ctx is not None else None
    for rec in spans:
        if isinstance(rec, dict) and "tid" in rec:
            TRACER.record(rec, sink=sink)


class _NoopRemote:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def attach(self, resp) -> None:
        return None


_NOOP_REMOTE = _NoopRemote()


class _RemoteSession:
    """The server side of a call: one span named for the op under the
    caller's span, whose spans collect into a sink that `attach()` ships
    back on the response header."""

    __slots__ = ("_span", "_sink")

    def __init__(self, trace_id: str, parent_sid: str, proc: str,
                 name: str, attrs: dict):
        self._sink: list = []
        self._span = _Span(name, trace_id, parent_sid, proc,
                           self._sink, attrs)

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._span.__exit__(exc_type, exc, tb)

    def attach(self, resp) -> None:
        if self._sink and isinstance(resp, dict):
            resp["trace_spans"] = self._sink


def remote_session(header, proc: str, name: str, **attrs):
    """Re-enter the trace context a request header carries (the server
    half of `inject`); a no-op when disarmed or the caller sent none."""
    if not TRACER.armed:
        return _NOOP_REMOTE
    t = header.get("trace") if isinstance(header, dict) else None
    if not (isinstance(t, (list, tuple)) and len(t) == 2):
        return _NOOP_REMOTE
    return _RemoteSession(str(t[0]), str(t[1]), proc, name, attrs)


# ----------------------------------------------------------- summaries
def statement_record(dur_ms: float, since: int = 0):
    """-> (trace_id, span_count, span_summary_json, span_tree_json) for
    the statement recorder, covering the trace's spans from index
    `since` (the span count of the statements before) onward; the tree
    persists only past MO_TRACE_SLOW_MS (the slow-query hook).  Empty
    strings when disarmed or unsampled."""
    if not TRACER.armed:
        return "", 0, "", ""
    ctx = _CTX.get()
    if ctx is None:
        return "", 0, "", ""
    spans = TRACER.spans_of(ctx.trace_id)[since:]
    if not spans:
        return ctx.trace_id, 0, "", ""
    by_name: Dict[str, float] = {}
    for s in spans:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) \
            + s["dur_us"] / 1000.0
    summary = json.dumps({k: round(v, 3)
                          for k, v in sorted(by_name.items())})
    tree_js = ""
    if TRACER.slow_ms > 0 and dur_ms >= TRACER.slow_ms:
        tree_js = json.dumps(_forest(spans))
    return ctx.trace_id, len(spans), summary, tree_js


def tree(trace_id: str) -> List[dict]:
    """Nested span tree(s) of one trace: roots are spans whose parent
    is not in the ring (the statement root mid-flight counts its
    completed children as roots — still one coherent forest)."""
    return _forest(TRACER.spans_of(trace_id))


def _forest(spans: List[dict]) -> List[dict]:
    by_sid = {s["sid"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in spans:
        node = by_sid[s["sid"]]
        parent = by_sid.get(s["psid"])
        if parent is None:
            roots.append(node)
        else:
            parent["children"].append(node)
    for n in by_sid.values():
        n["children"].sort(key=lambda c: c["ts_us"])
    roots.sort(key=lambda c: c["ts_us"])
    return roots


# ------------------------------------------------------ chrome export
def chrome_trace(trace_id: str) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): one pid lane per
    logical process (cn/tn/worker/...), one tid lane per thread,
    complete ("X") events carrying span/parent ids, instant ("i")
    events for span events."""
    spans = TRACER.spans_of(trace_id)
    procs = sorted({s["proc"] for s in spans})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    tid_of: Dict[tuple, int] = {}
    events: List[dict] = []
    for p in procs:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid_of[p], "tid": 0,
                       "args": {"name": p}})
    for s in spans:
        key = (s["proc"], s["thread"])
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of
                               if k[0] == s["proc"]]) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid_of[s["proc"]],
                           "tid": tid_of[key],
                           "args": {"name": s["thread"]}})
    for s in spans:
        pid = pid_of[s["proc"]]
        tid = tid_of[(s["proc"], s["thread"])]
        events.append({
            "ph": "X", "name": s["name"], "cat": "motrace",
            "pid": pid, "tid": tid, "ts": s["ts_us"],
            "dur": max(1, s["dur_us"]),
            "args": dict(s["attrs"], span_id=s["sid"],
                         parent_id=s["psid"])})
        for ev in s["events"]:
            events.append({
                "ph": "i", "s": "t", "name": ev["name"],
                "cat": "motrace", "pid": pid, "tid": tid,
                "ts": ev["ts_us"], "args": dict(ev["attrs"])})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id}}


def dump(dirpath: str) -> List[str]:
    """Write one Perfetto-loadable JSON file per trace_id in the ring;
    returns the written paths."""
    os.makedirs(dirpath, exist_ok=True)
    out = []
    for tid in TRACER.trace_ids():
        path = os.path.join(dirpath, f"trace_{tid}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(chrome_trace(tid), f)
        out.append(path)
    return out
