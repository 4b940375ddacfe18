"""Delta maintenance: materialized-view state updated from the commit
funnel instead of recomputed.

The port of `matrixone_tpu/mview/maintain.py`.  Wiring (one service per
engine, `service_for`):

  * a logtail subscriber (`Engine.subscribe`) captures each commit's
    deltas for the tracked source tables: an insert event keeps its
    Segment (immutable), a delete event decodes the doomed rows' columns
    at once, through `MVCCTable.fetch_rows`, while the commit lock is
    still held (object-backed segments included), so a later merge
    cannot compact them away first;
  * `Engine._notify_post_commit` drives `on_commit` on the committing
    thread after the commit has applied and the lock is released: the
    queue drains in commit order, one thread applying at a time, and
    `on_commit` returns only when every event queued before it has been
    applied (a writer's next statement sees its own delta in the view);
  * one commit's events update the partial-aggregate state and land the
    changed groups in the backing table as ONE ordinary commit, then the
    view's watermark advances: reads are plain MVCC reads of the backing
    table, consistent at that watermark.

Three tiers evaluate a delta:

  * dense: the Q1 shape (dictionary or bool keys, at most 4096 slots,
    COUNT/SUM/AVG only): filters, keys and `ops/agg.dense_lane_partials`
    inside one step that the fragment cache (`vm/fusion.CACHE`) keys by
    content; on the card the step is a CUDA graph (`vm/graphs.py`), so a
    delta is one replay, counted as `fusion_dispatch{kind=step}`;
  * general: any maintainable shape, the expressions on the device and
    the grouping on the host;
  * init / recompute: `_partial_plan` through `compile_plan`, the
    executor's own path (f32 sums under an integer key launch the
    segment-sum kernel there).

SUM/COUNT/AVG retract exactly; a delete that touches a MIN/MAX group
recomputes that group from the source at the commit's snapshot.  A group
whose live row count reaches zero leaves the view.  A failed apply
poisons that view's state: the next commit initializes it again, and no
maintenance error ever fails the writer's commit.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt, from_device
from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn
from matrixone_tpu_torch.container.dtypes import TypeOid
from matrixone_tpu_torch.ops import agg as A, filter as F
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import AggCall, BoundCast
from matrixone_tpu_torch.utils import metrics as M, motrace
from matrixone_tpu_torch.vm.exprs import ExecBatch, eval_expr

from matrixone_tpu_torch.mview import catalog as mcat
from matrixone_tpu_torch.mview.planner import MaintainSpec, analyze

#: aggregate functions the dense tier handles (the additive subset;
#: MIN/MAX take the general tier)
_DENSE_FUNCS = frozenset({"count", "sum", "avg"})
#: the dense tier's key-space bound (NULL slots included)
DENSE_MAX_SLOTS = 4096


def _maintain_fields(a: AggCall) -> List[str]:
    """Partial-state fields of one aggregate (host scalars per group)."""
    if a.func == "count":
        return ["count"]
    if a.func in ("sum", "avg"):
        return ["sum", "count"]
    return [a.func, "count"]        # min / max


def _partial_arg(a: AggCall):
    """The expression whose per-group SUM is this aggregate's additive
    partial: AVG over floats sums in f64."""
    if a.func == "avg" and a.arg.dtype.is_float:
        return BoundCast(a.arg, dt.FLOAT64)
    return a.arg


def _new_group(spec: MaintainSpec) -> dict:
    return {"rows": 0, "parts": [dict.fromkeys(_maintain_fields(a), None)
                                 for a in spec.aggs]}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ViewRuntime:
    """One maintained view: spec, partial-aggregate state and watermark.
    Mutated only under the owning service's maintenance lock."""

    def __init__(self, name: str, spec: MaintainSpec, def_hash: str):
        self.name = name
        self.spec = spec
        self.def_hash = def_hash
        #: key tuple -> {"rows": int, "parts": [per-agg field dict]}
        self.groups: Optional[Dict[tuple, dict]] = None
        self.watermark: Optional[int] = None

    def n_groups(self) -> Optional[int]:
        return None if self.groups is None else len(self.groups)

    def invalidate(self) -> None:
        """Poison the state: the next commit initializes it again."""
        self.groups = None
        self.watermark = None

    def replace_state(self, groups: Dict[tuple, dict], ts: int) -> None:
        self.groups = groups
        self.watermark = ts

    def merge_delta(self, delta: Dict[tuple, dict], sign: int,
                    ts: int) -> set:
        """Fold one delta's per-group partials into the state with
        `sign` (+1 insert, -1 retract) and advance the watermark to `ts`.
        -> the touched keys (the backing rewrite set)."""
        touched = set()
        for key, d in delta.items():
            touched.add(key)
            g = self.groups.get(key)
            if g is None:
                g = self.groups[key] = _new_group(self.spec)
            g["rows"] += sign * d["rows"]
            for a, part, dp in zip(self.spec.aggs, g["parts"], d["parts"]):
                for f in _maintain_fields(a):
                    v = dp.get(f)
                    if v is None:
                        continue
                    cur = part.get(f)
                    if f in ("sum", "count"):
                        part[f] = v * sign if cur is None \
                            else cur + sign * v
                    elif f == "min":
                        part[f] = v if cur is None else min(cur, v)
                    else:               # max
                        part[f] = v if cur is None else max(cur, v)
            if g["rows"] <= 0:
                del self.groups[key]
        self.watermark = max(self.watermark, ts)
        return touched


class MViewService:
    """Per-engine maintenance service (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        #: where deltas are evaluated when no session is executing on the
        #: committing thread (CUDA, resolved at first use)
        self.device = None
        # queue lock: taken by the subscriber UNDER the commit lock, so it
        # never takes the commit lock itself
        self._qlock = threading.Lock()
        self._qcv = threading.Condition(self._qlock)
        self._queue: List[tuple] = []
        self._applying = False
        # maintenance lock: serializes state changes and backing commits
        self._lock = threading.RLock()
        self._maint = threading.local()       # re-entrancy guard
        self._views: Dict[str, ViewRuntime] = {}
        self._sources: frozenset = frozenset()
        self._needed_cols: Dict[str, List[str]] = {}
        #: def_hashes whose init failed: not retried until the definition
        #: changes, so a broken view cannot wedge every commit into a
        #: failing recompute
        self._failed: set = set()
        #: the traceback of the last maintenance error (status surface)
        self.last_error: Optional[str] = None
        #: the dense tier's steps, and on the card the graph captures and
        #: replays they made (one replay a delta, a capture the first
        #: time a padded shape is seen)
        self.dense = {"steps": 0, "graph_captures": 0, "graph_replays": 0}
        engine.subscribe(self._on_event)

    def _device(self):
        from matrixone_tpu_torch import resolve_device
        from matrixone_tpu_torch.frontend.session import current_session
        s = current_session()
        if s is not None:
            return s.device
        if self.device is None:
            # the TN's service names its engine's device (cluster/tn.py)
            self.device = resolve_device(
                getattr(self.engine, "default_device", None))
        return self.device

    # ------------------------------------------------------- event intake
    def _on_event(self, commit_ts: int, table: str, kind: str,
                  payload) -> None:
        """Logtail subscriber, run under the engine's commit lock: it
        only buffers.  A delete's rows are decoded here, while they are
        certainly still present."""
        if table not in self._sources:
            return
        if kind == "delete":
            gids = np.asarray(payload, np.int64)
            if len(gids) == 0:
                return
            t = self.engine.get_table(table)
            cols = self._needed_cols.get(table) \
                or [c for c, _ in t.meta.schema]
            arrays, validity = t.fetch_rows(gids, cols)
            payload = (arrays, validity, len(gids))
        with self._qlock:
            self._queue.append((commit_ts, table, kind, payload))

    # ---------------------------------------------------------- the hook
    def on_commit(self, commit_ts: int, touched: set) -> None:
        """The post-commit hook (Engine._notify_post_commit): returns only
        when every event queued before the call has been applied.  The
        triggering commit is already durable, so no maintenance error
        surfaces from here: a view's failure poisons its own state."""
        if getattr(self._maint, "active", False):
            return             # a maintenance commit: the outer call drains
        self._maint.active = True
        try:
            self._sync_views()
            self._init_pending()
            self._drain_all()
        except Exception:   # noqa: BLE001 — the writer's commit has
            # applied; a crash of the service itself (the registry read
            # mid-drop) is recorded and the next commit retries
            self.last_error = traceback.format_exc()
            M.mview_apply.inc(tier="error")
        finally:
            self._maint.active = False

    def runtime(self, name: str) -> Optional[ViewRuntime]:
        return self._views.get(name)

    def stats(self) -> dict:
        with self._qlock:
            queued = len(self._queue)
        return {"incremental": sorted(self._views),
                "queued_events": queued,
                "sources": sorted(self._sources),
                "dense": dict(self.dense),
                "last_error": (self.last_error.strip().splitlines()[-1]
                               if self.last_error else None)}

    def refresh_dynamic(self, name: str, sql: str):
        """Delta refresh of a dynamic table: dynamic tables are not
        ported yet (ROADMAP.md, section A, step 5)."""
        raise NotImplementedError(
            "dynamic tables are not ported yet (ROADMAP.md, section A, "
            "step 5)")

    # ------------------------------------------------------ registry sync
    def _sync_views(self) -> None:
        """Diff the system_mview registry against the attached runtimes:
        attach, detach, and rebuild the source map."""
        reg = mcat.registry_for(self.engine)
        with self._lock:
            want = {n: d for n, d in reg.items()
                    if d.mode == "incremental"}
            # a dropped definition forgives its failure, so a drop and
            # re-create of the same SQL retries
            self._failed &= {d.def_hash for d in reg.values()}
            for n in list(self._views):
                d = want.get(n)
                if d is None or d.def_hash != self._views[n].def_hash:
                    del self._views[n]
            for n, d in want.items():
                if n in self._views or d.def_hash in self._failed:
                    continue
                from matrixone_tpu_torch.sql.parser import parse
                try:
                    spec, _why = analyze(parse(d.sql)[0], self.engine)
                except Exception:       # noqa: BLE001 — a definition
                    spec = None         # that stopped binding (its
                    #                     source dropped) detaches
                if spec is not None:
                    self._views[n] = ViewRuntime(n, spec, d.def_hash)
            self._rebuild_sources()

    def _rebuild_sources(self) -> None:
        srcs: Dict[str, set] = {}
        for rt in self._views.values():
            srcs.setdefault(rt.spec.source, set()).update(
                rt.spec.scan_columns)
        self._needed_cols = {t: sorted(c) for t, c in srcs.items()}
        self._sources = frozenset(srcs)

    # ----------------------------------------------------- initialization
    def _init_pending(self) -> None:
        for rt in list(self._views.values()):
            if rt.groups is None:
                try:
                    self._init_view(rt)
                except Exception:   # noqa: BLE001 — an unbuildable view
                    # (its source dropped) detaches and is remembered;
                    # a drop and re-create retries it
                    self.last_error = traceback.format_exc()
                    with self._lock:
                        self._failed.add(rt.def_hash)
                        self._views.pop(rt.name, None)
                        self._rebuild_sources()

    def _init_view(self, rt: ViewRuntime) -> None:
        """Full compute at the current frontier: the state and one
        rewrite commit.  Events at or below that frontier are skipped by
        the watermark; later ones apply on top."""
        t0 = time.perf_counter()
        with self._lock:
            if rt.groups is not None:     # another thread initialized it
                return
            ts0 = self.engine.committed_ts
            rt.replace_state(self._compute_groups(rt.spec, ts0), ts0)
            self._rewrite_backing(rt, set(rt.groups), full=True)
        M.mview_apply.inc(tier="init")
        M.mview_apply_seconds.inc(time.perf_counter() - t0, kind="full")

    # ----------------------------------------------------------- draining
    def _drain_all(self) -> None:
        """Apply every queued event; while another thread applies, wait
        for it, so the caller's read-your-writes holds."""
        while True:
            with self._qlock:
                if not self._queue:
                    if not self._applying:
                        return
                    self._qcv.wait(timeout=1.0)
                    continue
                if self._applying:
                    self._qcv.wait(timeout=1.0)
                    continue
                batch, self._queue = self._queue, []
                self._applying = True
            try:
                self._apply_events(batch)
            finally:
                with self._qlock:
                    self._applying = False
                    self._qcv.notify_all()

    def _apply_events(self, events: List[tuple]) -> None:
        """Apply one popped batch in per-commit runs, so a view's
        watermark only passes commits that fully applied."""
        i = 0
        while i < len(events):
            ts = events[i][0]
            j = i
            while j < len(events) and events[j][0] == ts:
                j += 1
            run = events[i:j]
            i = j
            for rt in list(self._views.values()):
                mine = [e for e in run if e[1] == rt.spec.source]
                if not mine:
                    continue
                try:
                    with self._lock:
                        self._apply_run(rt, ts, mine)
                except Exception:   # noqa: BLE001 — never leave wrong
                    # state behind: poison it, the next commit rebuilds
                    self.last_error = traceback.format_exc()
                    with self._lock:
                        rt.invalidate()

    def _apply_run(self, rt: ViewRuntime, ts: int, run: List[tuple]
                   ) -> None:
        """One commit's events for one view (deletes before inserts, as
        the funnel orders them): merge the deltas, recompute the MIN/MAX
        groups a delete touched, rewrite the changed backing rows."""
        if rt.groups is None or ts <= rt.watermark:
            return
        t0 = time.perf_counter()
        with motrace.span("mview.apply", view=rt.name, events=len(run)):
            touched: set = set()
            recompute: set = set()
            for _ts, _table, kind, payload in run:
                if kind == "insert":
                    seg = payload
                    delta = self._delta_partials(
                        rt, seg.arrays, seg.validity, seg.n_rows)
                    touched |= rt.merge_delta(delta, +1, ts)
                else:
                    arrays, validity, n = payload
                    delta = self._delta_partials(rt, arrays, validity, n)
                    if rt.spec.has_minmax:
                        recompute |= set(delta)
                    touched |= rt.merge_delta(delta, -1, ts)
            if recompute:
                # an extremum cannot be retracted: the affected groups'
                # state comes from the source at this snapshot
                live = recompute & set(rt.groups)
                fresh = self._compute_groups(rt.spec, ts, only_keys=live)
                for key in live:
                    g = fresh.get(key)
                    if g is None:
                        rt.groups.pop(key, None)
                    else:
                        rt.groups[key] = g
                rt.watermark = max(rt.watermark, ts)
                M.mview_apply.inc(tier="recompute")
            self._rewrite_backing(rt, touched | recompute)
        M.mview_apply_seconds.inc(time.perf_counter() - t0, kind="delta")

    # =================================================== delta evaluation
    def _delta_partials(self, rt: ViewRuntime, arrays, validity, n: int
                        ) -> Dict[tuple, dict]:
        """Per-group partials of one delta (a segment's rows or the rows
        behind a tombstone), through the dense tier where the shape
        allows, else the general tier."""
        from matrixone_tpu_torch.vm.operators import chunk_to_execbatch
        spec = rt.spec
        t = self.engine.get_table(spec.source)
        ex = chunk_to_execbatch(arrays, validity, t.dicts, n,
                                spec.scan_columns, spec.scan_schema,
                                self._device())
        M.mview_rows.inc(n)
        dense = self._dense_delta(rt, ex)
        if dense is not None:
            M.mview_apply.inc(tier="dense")
            return dense
        M.mview_apply.inc(tier="general")
        return self._general_delta(spec, ex)

    # ---- general tier (host grouping; any maintainable shape)
    def _general_delta(self, spec: MaintainSpec, ex: ExecBatch
                       ) -> Dict[tuple, dict]:
        from matrixone_tpu_torch.vm import operators as O
        for f in spec.filters:
            ex.mask = ex.mask & F.predicate_mask(eval_expr(f, ex),
                                                 ex.batch)
        mask = _host(ex.mask)
        keys_host = []
        for k in spec.group_keys:
            col = O._broadcast_full(eval_expr(k, ex), ex.padded_len)
            keys_host.append((_host(col.data), _host(col.validity),
                              k.dtype, O._expr_dict(k, ex)))
        vals_host = []
        for a in spec.aggs:
            if a.arg is None:
                vals_host.append(None)
                continue
            col = O._broadcast_full(eval_expr(_partial_arg(a), ex),
                                    ex.padded_len)
            vals_host.append((_host(col.data), _host(col.validity)))
        out: Dict[tuple, dict] = {}
        for i in np.nonzero(mask)[0]:
            key = tuple(_norm_key(dref, int(i), data, valid, dtype)
                        for data, valid, dtype, dref in keys_host)
            g = out.get(key)
            if g is None:
                g = out[key] = _new_group(spec)
            g["rows"] += 1
            for a, part, vh in zip(spec.aggs, g["parts"], vals_host):
                if a.arg is None:               # count(*)
                    part["count"] = (part["count"] or 0) + 1
                    continue
                data, valid = vh
                if not valid[i]:
                    continue
                part["count"] = (part["count"] or 0) + 1
                v = data[i].item()
                if a.func in ("sum", "avg"):
                    part["sum"] = v if part["sum"] is None \
                        else part["sum"] + v
                elif a.func == "min":
                    part["min"] = v if part["min"] is None \
                        else min(part["min"], v)
                elif a.func == "max":
                    part["max"] = v if part["max"] is None \
                        else max(part["max"], v)
        return out

    # ---- dense tier (one step, one graph replay on the card)
    def _dense_delta(self, rt: ViewRuntime, ex: ExecBatch
                     ) -> Optional[Dict[tuple, dict]]:
        from matrixone_tpu_torch.utils import keys as keyaudit
        from matrixone_tpu_torch.vm import fusion, graphs as G
        spec = rt.spec
        if any(a.func not in _DENSE_FUNCS for a in spec.aggs):
            return None
        sizes, key_dicts = [], []
        for k in spec.group_keys:
            d = fusion._static_dict(k, ex.dicts)
            if d is not None:
                sizes.append(max(len(d), 1))
                key_dicts.append(d)
            elif k.dtype.oid == TypeOid.BOOL:
                sizes.append(2)
                key_dicts.append(None)
            else:
                return None
        g = 1
        for s in sizes:
            g *= s + 1
        if g > DENSE_MAX_SLOTS:
            return None
        sizes = tuple(sizes)
        # content-addressed key: the definition, the batch's shapes and
        # dtypes, the dense sizes, the device and the CONTENT of every
        # dictionary an expression may bake into a lookup table (a grown
        # dictionary re-keys)
        t = self.engine.get_table(spec.source)
        colsig = tuple((nm, int(c.dtype.oid), str(c.data.dtype),
                        tuple(c.data.shape))
                       for nm, c in ex.batch.columns.items())
        dict_keys = tuple(fusion._dict_key(t.dicts.get(c))
                          for c in spec.scan_columns if c in t.dicts)
        key = ("mview", rt.def_hash, colsig, int(ex.mask.shape[0]),
               sizes, dict_keys, str(ex.mask.device))
        entry = fusion.CACHE.entry(key)
        if keyaudit.armed():
            # the dictionaries' full content, recomputed apart from
            # fusion._dict_key: a key that stopped covering it mismatches
            # on the first colliding hit instead of serving stale partials
            keyaudit.audit("mview/maintain.py:mview", key, {
                "scan_dict_content": tuple(
                    (c, tuple(str(s) for s in t.dicts[c]))
                    for c in spec.scan_columns if c in t.dicts),
                "env_dict_content": tuple(
                    sorted((nm, tuple(str(s) for s in d))
                           for nm, d in ex.dicts.items()
                           if d is not None)),
                "sizes": sizes,
                "shape": (len(spec.filters), len(spec.group_keys),
                          len(spec.aggs))})
        fn = entry["fn"].get("step")
        if fn is None:
            trig = tuple((nm, c.dtype)
                         for nm, c in ex.batch.columns.items())
            fn, fieldmap = self._make_dense_step(spec, trig, sizes,
                                                 dict(ex.dicts))
            entry["fn"]["step"] = fn
            entry["fieldmap"] = fieldmap
        datas = tuple(c.data for c in ex.batch.columns.values())
        valids = tuple(c.validity for c in ex.batch.columns.values())
        args = (datas, valids, ex.batch.n_rows, ex.mask)
        owner = object()
        graph = G.claim(entry, "step", fn, args, owner=owner)
        try:
            if graph is None:
                out = fn(*args)
            else:
                captures = graph.graph is None
                replays = graph.replays
                out = graph(args)
                self.dense["graph_captures"] += int(captures)
                self.dense["graph_replays"] += graph.replays - replays
            self.dense["steps"] += 1
            M.fusion_dispatch.inc(kind="step")
            # a graph's outputs are overwritten by its next replay: they
            # reach the host before the graph is released
            return self._dense_to_groups(spec, out, sizes, key_dicts,
                                         entry["fieldmap"])
        finally:
            if graph is not None:
                graph.release()

    def _make_dense_step(self, spec: MaintainSpec, trig_schema, sizes,
                         env0):
        """The delta step: filters -> keys -> deduplicated partial lanes
        -> dense_lane_partials, one function (eager on the CPU, captured
        as a graph on the card)."""
        from matrixone_tpu_torch.vm import fusion
        from matrixone_tpu_torch.vm import operators as O
        lane_of: Dict[tuple, tuple] = {}
        int_specs: List[tuple] = []      # (agg index, field)
        float_specs: List[tuple] = []
        fieldmap: List[List[tuple]] = []  # per agg: (field, lane)
        for ai, a in enumerate(spec.aggs):
            fm = []
            for f in _maintain_fields(a):
                if f == "count":
                    lk = ("count", None if a.arg is None
                          else fusion._dedup_sig(a.arg))
                    cls = "int"
                else:
                    arg = _partial_arg(a)
                    cls = "float" if arg.dtype.is_float else "int"
                    lk = ("sum", cls, fusion._dedup_sig(arg))
                lane = lane_of.get(lk)
                if lane is None:
                    if cls == "int":
                        lane = ("int", len(int_specs))
                        int_specs.append((ai, f))
                    else:
                        lane = ("float", len(float_specs))
                        float_specs.append((ai, f))
                    lane_of[lk] = lane
                fm.append((f, lane))
            fieldmap.append(fm)

        def step(datas, valids, n_rows, mask):
            cols = {nm: DeviceColumn(d, v, t)
                    for (nm, t), d, v in zip(trig_schema, datas, valids)}
            ex = ExecBatch(batch=DeviceBatch(columns=cols, n_rows=n_rows),
                           dicts=env0, mask=mask)
            for f in spec.filters:
                ex.mask = ex.mask & F.predicate_mask(
                    eval_expr(f, ex), ex.batch)
            n = ex.padded_len
            kdata, kvalid = [], []
            for k in spec.group_keys:
                kc = O._broadcast_full(eval_expr(k, ex), n)
                kdata.append(kc.data)
                kvalid.append(kc.validity)
            val_cache: dict = {}

            def _val(arg):
                sig = fusion._dedup_sig(arg)
                got = val_cache.get(sig)
                if got is None:
                    got = val_cache[sig] = O._broadcast_full(
                        eval_expr(arg, ex), n)
                return got

            int_vals, int_masks = [], []
            float_vals, float_masks = [], []
            for ai, f in int_specs:
                a = spec.aggs[ai]
                if f == "count":
                    int_vals.append(None)
                    int_masks.append(None if a.arg is None
                                     else _val(_partial_arg(a)).validity)
                else:
                    v = _val(_partial_arg(a))
                    int_vals.append(v.data)
                    int_masks.append(v.validity)
            for ai, f in float_specs:
                v = _val(_partial_arg(spec.aggs[ai]))
                float_vals.append(v.data)
                float_masks.append(v.validity)
            return A.dense_lane_partials(
                tuple(kdata), tuple(kvalid), ex.mask,
                tuple(int_vals), tuple(int_masks),
                tuple(float_vals), tuple(float_masks),
                sizes=sizes, with_null=True)

        return step, fieldmap

    def _dense_to_groups(self, spec: MaintainSpec, out, sizes,
                         key_dicts, fieldmap) -> Dict[tuple, dict]:
        """Dense lanes -> {key tuple: partials}, decoding the NULL-slotted
        mixed-radix slots back to key values."""
        ints, floats, rows = (_host(x) for x in out)
        strides, _g = A.dense_slot_strides(sizes)
        groups: Dict[tuple, dict] = {}
        for slot in np.nonzero(rows)[0]:
            key = []
            for k, s, st, d in zip(spec.group_keys, sizes, strides,
                                   key_dicts):
                code = (int(slot) // st) % (s + 1)
                if code >= s:
                    key.append(None)
                elif d is not None:
                    key.append(d[code])
                elif k.dtype.oid == TypeOid.BOOL:
                    key.append(bool(code))
                else:
                    key.append(int(code))
            parts = []
            for a, fm in zip(spec.aggs, fieldmap):
                part = dict.fromkeys(_maintain_fields(a), None)
                for f, lane in fm:
                    arr = ints if lane[0] == "int" else floats
                    v = arr[lane[1]][slot]
                    part[f] = float(v) if lane[0] == "float" else int(v)
                parts.append(part)
            groups[tuple(key)] = {"rows": int(rows[slot]), "parts": parts}
        return groups

    # =============================================== full/partial compute
    def _partial_plan(self, spec: MaintainSpec):
        """The partial-aggregate plan: the view's scan, filters and keys,
        its aggregates rewritten to their additive partials, so the result
        converts straight into maintenance state.  It runs through the
        ordinary compile_plan pipeline (dense path, fusion and the hand
        kernels), so the init and recompute numbers are the executor's."""
        from matrixone_tpu_torch.sql.binder import _agg_result_type
        from matrixone_tpu_torch.vm import fusion
        scan = P.Scan(spec.source, list(spec.scan_columns),
                      list(spec.scan_schema), filters=list(spec.filters))
        paggs: List[AggCall] = [AggCall("count", None, False, dt.INT64,
                                        out_name="_rows")]
        layout: List[dict] = []          # per agg: field -> out index
        seen: Dict[tuple, int] = {}
        for a in spec.aggs:
            fmap = {}
            for f in _maintain_fields(a):
                if f == "count" and a.arg is None:
                    fmap[f] = 0           # count(*) IS the rows lane
                    continue
                arg = a.arg if f in ("count", "min", "max") \
                    else _partial_arg(a)
                sk = (f, fusion._dedup_sig(arg))
                idx = seen.get(sk)
                if idx is None:
                    idx = len(paggs)
                    paggs.append(AggCall(f, arg, False,
                                         _agg_result_type(f, arg.dtype),
                                         out_name=f"_p{idx}"))
                    seen[sk] = idx
                fmap[f] = idx
            layout.append(fmap)
        schema = [(f"_g{i}", k.dtype)
                  for i, k in enumerate(spec.group_keys)] + \
            [(a.out_name, a.dtype) for a in paggs]
        return P.Aggregate(scan, list(spec.group_keys), paggs,
                           schema), layout

    def _compute_groups(self, spec: MaintainSpec, ts: int,
                        only_keys: Optional[set] = None
                        ) -> Dict[tuple, dict]:
        """Full (or key-restricted) partial compute at snapshot `ts`
        through the operator pipeline: init, restart rebuild and the
        MIN/MAX recompute."""
        from matrixone_tpu_torch.vm.compile import compile_plan
        from matrixone_tpu_torch.vm.process import ExecContext
        node, layout = self._partial_plan(spec)
        ctx = ExecContext(catalog=self.engine, txn=None,
                          variables={"batch_rows": 1 << 20},
                          frozen_ts=ts, device=self._device())
        op = compile_plan(node, ctx)
        nk = len(spec.group_keys)
        groups: Dict[tuple, dict] = {}
        for ex in op.execute():
            db = F.compact(ex.batch, ex.mask, ex.padded_len)
            b = from_device(db, ex.dicts, schema=dict(node.schema))
            n = len(b)
            if n == 0:
                continue
            kcols = []
            for (name, dtype), k in zip(node.schema[:nk],
                                        spec.group_keys):
                vec = b.columns[name]
                if dtype.is_varlen:
                    kcols.append(("s", vec.to_pylist(), None))
                else:
                    kcols.append((dtype, vec.data, vec.valid_mask()))
            pcols = [(b.columns[name].data, b.columns[name].valid_mask())
                     for name, _d in node.schema[nk:]]
            for i in range(n):
                key = tuple(ent[1][i] if ent[0] == "s"
                            else _norm_key(None, i, ent[1], ent[2], ent[0])
                            for ent in kcols)
                if only_keys is not None and key not in only_keys:
                    continue
                parts = []
                for a, fmap in zip(spec.aggs, layout):
                    part = dict.fromkeys(_maintain_fields(a), None)
                    for f, idx in fmap.items():
                        data, valid = pcols[idx]
                        if not valid[i]:
                            continue
                        v = data[i].item()
                        part[f] = float(v) if isinstance(v, float) \
                            else int(v)
                    parts.append(part)
                groups[key] = {"rows": int(pcols[0][0][i]), "parts": parts}
        return groups

    # ------------------------------------------------- backing rewrites
    def _rewrite_backing(self, rt: ViewRuntime, keys: set,
                         full: bool = False) -> None:
        """Land the changed groups in the backing table as ONE commit:
        delete the keys' rows, insert their new values.  `full` rewrites
        everything (init, restart rebuild)."""
        if not keys and not full:
            return
        from matrixone_tpu_torch.storage.engine import ROWID
        spec = rt.spec
        t = self.engine.get_table(rt.name)
        names = [c for c, _ in t.meta.schema]
        key_col_of = {idx: name for (kind, idx), name
                      in zip(spec.out_cols, names) if kind == "key"}
        key_cols = [key_col_of[i] for i in range(len(spec.group_keys))]
        sd = dict(t.meta.schema)
        gids: List[int] = []
        for arrays, validity, dicts, n in t.iter_chunks(
                key_cols + [ROWID], 1 << 20):
            for i in range(n):
                key = []
                for c in key_cols:
                    if not validity[c][i]:
                        key.append(None)
                    elif sd[c].is_varlen:
                        key.append(dicts[c][int(arrays[c][i])])
                    elif sd[c].oid == TypeOid.BOOL:
                        key.append(bool(arrays[c][i]))
                    elif sd[c].is_float:
                        key.append(float(arrays[c][i]))
                    else:
                        key.append(int(arrays[c][i]))
                if full or tuple(key) in keys:
                    gids.append(int(arrays[ROWID][i]))
        live = [k for k in (rt.groups if full else keys)
                if k in rt.groups]
        inserts = {}
        if live:
            vals = {name: [] for name in names}
            valid = {name: [] for name in names}
            for key in live:
                g = rt.groups[key]
                for (kind, idx), name in zip(spec.out_cols, names):
                    if kind == "key":
                        v, ok = key[idx], key[idx] is not None
                    else:
                        v, ok = _final_value(spec.aggs[idx],
                                             g["parts"][idx])
                    vals[name].append(v)
                    valid[name].append(ok)
            arrays2, validity2 = {}, {}
            for name in names:
                d = sd[name]
                if d.is_varlen:
                    arrays2[name] = t.encode_strings_list(
                        name, [v if ok else None
                               for v, ok in zip(vals[name], valid[name])])
                else:
                    arrays2[name] = np.asarray(
                        [v if ok else 0
                         for v, ok in zip(vals[name], valid[name])],
                        d.np_dtype)
                validity2[name] = np.asarray(valid[name], np.bool_)
            inserts = {rt.name: [(arrays2, validity2)]}
        if not inserts and not gids:
            return
        self.engine.commit_txn(
            None, inserts,
            {rt.name: np.asarray(gids, np.int64)} if gids else {})


_SERVICE_LOCK = threading.Lock()


def service_for(engine) -> MViewService:
    """The engine's one maintenance service."""
    svc = engine._mview_service
    if svc is None:
        with _SERVICE_LOCK:
            svc = engine._mview_service
            if svc is None:
                svc = engine._mview_service = MViewService(engine)
    return svc


def _final_value(a: AggCall, part: dict) -> Tuple[object, bool]:
    """One group's partial finalized into the stored value, as the
    executor's grouped finalize does (decimal sums stay scaled ints; AVG
    divides in float64)."""
    c = part.get("count") or 0
    if a.func == "count":
        return int(c), True
    if c <= 0:
        return None, False
    if a.func == "sum":
        return part["sum"], True
    if a.func == "avg":
        s = float(part["sum"])
        if a.arg.dtype.oid == TypeOid.DECIMAL64:
            s = s / (10.0 ** a.arg.dtype.scale)
        return s / max(c, 1), True
    return part[a.func], True


def _norm_key(dref, i: int, data, valid, dtype):
    """The state key of one evaluated group-key cell, in its stored
    representation (a varchar decoded, so a grown dictionary cannot
    alias)."""
    if not valid[i]:
        return None
    if dref is not None:
        return dref[int(data[i])]
    if dtype.oid == TypeOid.BOOL:
        return bool(data[i])
    if dtype.is_float:
        return float(data[i])
    return int(data[i])
