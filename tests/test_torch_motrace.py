"""The port's tracing plane (utils/motrace.py), statement table
(utils/trace.py) and metrics registry (utils/metrics.py) against the JAX
package's, on the CPU.

The scenarios of tests/test_motrace.py but the distributed one, the
HTTP scrape endpoint and the UDF-offload fallback events (the RPC
fabric and the remote UDF tier are not ported) and the precheck smoke
gate (a tool of the JAX package): each runs through both packages on
the same statements (`torch_serving_pkgs.run_both`), comparing span
names and tree shapes, statement-table columns and counter deltas.  The
strict Prometheus parse runs on the port's `REGISTRY.render()`.  A
re-entrant execute (a statement run inside another statement's span,
as a dynamic-table refresh does in the reference) nests instead of
forking a trace.  The port's own: `fusion.compile` and
`fusion.dispatch` spans around a fused fragment's steps, the
`engine.recover` span with its recovery summary, and the statement
table's flush every 64 statements and at `mo_ctl('flush')`.
"""

import json
import os
import re

import pytest

from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.utils import motrace as tmotrace
from torch_serving_pkgs import packages, run_both


@pytest.fixture
def tracers():
    """Both packages' tracers armed at sample 1.0, restored after."""
    saved = []
    for pkg in packages():
        tr = pkg.motrace.TRACER
        saved.append((tr, (tr.armed, tr.sample, tr.slow_ms)))
        tr.arm(sample=1.0)
        tr.slow_ms = 0.0
        tr.clear()
    yield
    for tr, (armed, sample, slow) in saved:
        tr.armed, tr.sample, tr.slow_ms = armed, sample, slow
        tr.clear()


def _tree_names(node, depth=0):
    out = [(depth, node["name"])]
    for c in node["children"]:
        out.extend(_tree_names(c, depth + 1))
    return out


def _session(pkg):
    return pkg.session(pkg.Engine(pkg.fs.MemoryFS()))


# ------------------------------------------------------------- disarmed
def test_disarmed_is_noop():
    def scenario(pkg):
        mt = pkg.motrace
        tr = mt.TRACER
        assert not tr.armed
        tr.clear()
        assert mt.span("x") is mt._NOOP
        assert mt.statement_span("select 1") is mt._NOOP
        s = _session(pkg)
        s.execute("create table d0 (a bigint)")
        s.execute("insert into d0 values (1)")
        s.execute("select sum(a) from d0")
        assert tr.trace_ids() == []
        mt.event("nothing")
        mt.annotate(k=1)
    run_both(scenario)


def test_head_sampling_zero_records_nothing(tracers):
    def scenario(pkg):
        tr = pkg.motrace.TRACER
        tr.sample = 0.0
        s = _session(pkg)
        s.execute("create table s0 (a bigint)")
        s.execute("insert into s0 values (1)")
        assert tr.trace_ids() == []
        unsampled = pkg.M.trace_traces.get(outcome="unsampled")
        assert unsampled >= 2
    run_both(scenario)


# ----------------------------------------------------------- span trees
def test_statement_span_tree_shape(tracers):
    def scenario(pkg):
        tr = pkg.motrace.TRACER
        s = _session(pkg)
        s.execute("create table t1 (a bigint, b double)")
        s.execute("insert into t1 values (1, 1.5), (2, 2.5), (1, 3.0)")
        s.execute("select a, sum(b) from t1 group by a order by a")
        tids = tr.trace_ids()
        assert pkg.note("traces", len(tids)) == 3
        roots = pkg.motrace.tree(tids[-1])
        assert len(roots) == 1
        names = [n for _, n in _tree_names(roots[0])]
        assert names[0] == "statement"
        pkg.note("names", sorted(set(names)))
        assert {"parse", "run", "plan"} <= set(names)
        kids = {c["name"] for c in roots[0]["children"]}
        assert {"parse", "run"} <= kids
        spans = tr.spans_of(tids[-1])
        sids = {sp["sid"] for sp in spans}
        for sp in spans:
            assert sp["psid"] == "" or sp["psid"] in sids
        assert pkg.M.trace_spans.get(proc="cn") > 0
    run_both(scenario)


def test_reentrant_execute_nests_not_forks(tracers):
    """An execute inside an open statement span joins that trace as a
    child, never starts a second trace."""
    def scenario(pkg):
        tr = pkg.motrace.TRACER
        s = _session(pkg)
        s.execute("create table src (a bigint)")
        s.execute("insert into src values (1), (2)")
        tr.clear()
        with pkg.motrace.statement_span("outer"):
            assert s.execute("select sum(a) from src").rows() == [(3,)]
        tids = tr.trace_ids()
        assert pkg.note("traces", len(tids)) == 1
        names = [n for _, n in _tree_names(pkg.motrace.tree(tids[0])[0])]
        assert pkg.note("statements", names.count("statement")) == 2
    run_both(scenario)


def test_fused_fragment_spans(tracers, monkeypatch):
    """A fused fragment's first step is a `fusion.compile` span, the
    next ones `fusion.dispatch` spans (on the CPU: the eager step; on
    the card: the capture, then replays)."""
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    s = TSession(device="cpu")
    s.execute("create table ff (g varchar(4), v bigint)")
    s.execute("insert into ff values ('a', 10), ('b', 20), ('a', 30)")
    s.variables["batch_rows"] = 1
    q = "select g, sum(v) from ff where v > 5 group by g order by g"
    tmotrace.TRACER.clear()
    assert s.execute(q).rows() == [("a", 40), ("b", 20)]
    names = [sp["name"] for tid in tmotrace.TRACER.trace_ids()
             for sp in tmotrace.TRACER.spans_of(tid)]
    assert "fusion.compile" in names and "fusion.dispatch" in names


def test_engine_recover_span_carries_the_summary(tracers):
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.storage.fileservice import MemoryFS
    fs = MemoryFS()
    s = TSession(catalog=Engine(fs), device="cpu")
    s.execute("create table r (a bigint)")
    s.execute("insert into r values (1)")
    tmotrace.TRACER.clear()
    eng = Engine.open(fs)
    (tid,) = tmotrace.TRACER.trace_ids()
    (sp,) = tmotrace.TRACER.spans_of(tid)
    assert sp["name"] == "engine.recover"
    assert sp["attrs"]["frames_replayed"] == \
        eng.recovery_summary["frames_replayed"] > 0


# ------------------------------------------- statement table integration
def test_recorder_span_summary_columns(tracers):
    def scenario(pkg):
        s = _session(pkg)
        s.execute("create table rr (a bigint)")
        s.execute("insert into rr values (1)")
        s.catalog.stmt_recorder.flush()
        rows = s.execute(
            f"select statement, trace_id, span_count, span_summary, "
            f"span_tree from {pkg.trace.STMT_TABLE}").rows()
        ins = [r for r in rows if r[0].startswith("insert into rr")]
        assert ins, rows
        _, tid, n_spans, summary, tree_js = ins[0]
        assert re.fullmatch(r"[0-9a-f]{16}", tid)
        assert n_spans >= 2
        by_name = json.loads(summary)
        assert "parse" in by_name and "run" in by_name
        assert tree_js == ""
        pkg.note("columns", [c for c, _ in s.catalog.get_table(
            pkg.trace.STMT_TABLE).meta.schema])
    run_both(scenario)


def test_slow_query_hook_persists_full_tree(tracers):
    def scenario(pkg):
        pkg.motrace.TRACER.slow_ms = 0.001
        s = _session(pkg)
        s.execute("create table sq (a bigint)")
        s.execute("insert into sq values (1), (2)")
        s.catalog.stmt_recorder.flush()
        rows = s.execute(f"select statement, span_tree from "
                         f"{pkg.trace.STMT_TABLE}").rows()
        ins = [r for r in rows if r[0].startswith("insert into sq")]
        tree = json.loads(ins[0][1])
        assert isinstance(tree, list) and tree
        names = {n for root in tree for _, n in _tree_names(root)}
        assert "run" in names
    run_both(scenario)


def test_recorder_old_schema_auto_recreates():
    def scenario(pkg):
        from_pkg = pkg.engine
        eng = pkg.Engine(pkg.fs.MemoryFS())
        dt = (__import__("matrixone_tpu.container.dtypes",
                         fromlist=["x"]) if pkg.name == "jax" else
              __import__("matrixone_tpu_torch.container.dtypes",
                         fromlist=["x"]))
        old = [("stmt_id", dt.INT64), ("statement", dt.TEXT),
               ("status", dt.varchar(16)), ("duration_us", dt.INT64),
               ("rows_out", dt.INT64), ("error", dt.TEXT),
               ("ts", dt.INT64), ("cache_hit", dt.varchar(8)),
               ("queue_wait_ms", dt.INT64)]
        eng.create_table(from_pkg.TableMeta(pkg.trace.STMT_TABLE, old,
                                            ["stmt_id"]), log=False)
        rec = pkg.trace.StatementRecorder(eng)
        cols = [c for c, _ in eng.tables[pkg.trace.STMT_TABLE].meta.schema]
        assert "trace_id" in cols and "span_tree" in cols
        rec.record("select 1", "ok", 0.001, 1)
        rec.flush()
        assert pkg.note("rows", eng.get_table(
            pkg.trace.STMT_TABLE).n_rows) == 1
    run_both(scenario)


def test_recorder_flushes_on_engine_close():
    def scenario(pkg):
        eng = pkg.Engine(pkg.fs.MemoryFS())
        s = pkg.session(eng)
        s.execute("create table fc (a bigint)")
        s.execute("insert into fc values (1)")
        st = pkg.trace.STMT_TABLE
        assert st not in eng.tables or eng.get_table(st).n_rows == 0
        eng.close()
        assert pkg.note("rows", eng.get_table(st).n_rows) == 2
        s.close()
    run_both(scenario)


def test_recorder_flushes_every_64_and_on_mo_ctl_flush():
    def scenario(pkg):
        eng = pkg.Engine(pkg.fs.MemoryFS())
        s = pkg.session(eng)
        s.execute("create table fe (a bigint)")
        for i in range(63):
            s.execute(f"insert into fe values ({i})")
        st = pkg.trace.STMT_TABLE
        assert pkg.note("after 64", eng.get_table(st).n_rows) == 64
        s.execute("select count(*) from fe")
        assert eng.get_table(st).n_rows == 64
        s.execute("select mo_ctl('flush')")
        assert pkg.note("after flush", eng.get_table(st).n_rows) == 65
    run_both(scenario)


# ------------------------------------------------------- metrics plane
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [-+]?[0-9.eE+-]+$")


def test_prometheus_text_format_parses_strict():
    """The port's render() is exposition format: HELP/TYPE per family,
    every sample line well-formed (label values escaped), histograms
    cumulative with bucket/sum/count and +Inf == count."""
    s = TSession(device="cpu")
    s.execute("create table pm (a bigint)")
    s.execute("insert into pm values (1)")
    s.execute("select sum(a) from pm")
    TM.scan_segments.inc(0, outcome='odd "label"\\ \nvalue')
    text = TM.REGISTRY.render()
    families = {}
    cur = None
    for line in text.strip().split("\n"):
        if line.startswith("# HELP "):
            cur = line.split()[2]
            families.setdefault(cur, {"help": True})
        elif line.startswith("# TYPE "):
            parts = line.split()
            assert parts[2] == cur, f"TYPE without HELP: {line}"
            assert parts[3] in ("counter", "gauge", "histogram")
            families[cur]["type"] = parts[3]
        else:
            assert _SAMPLE_RE.match(line), f"malformed sample: {line!r}"
            name = line.split("{")[0].split(" ")[0]
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            assert base in families or name in families, line
    h = [ln for ln in text.split("\n")
         if ln.startswith("mo_query_duration_seconds")]
    buckets = [float(ln.rsplit(" ", 1)[1]) for ln in h
               if "_bucket{" in ln and "+Inf" not in ln]
    assert buckets == sorted(buckets)
    inf = [float(ln.rsplit(" ", 1)[1]) for ln in h
           if 'le="+Inf"' in ln][0]
    count = [float(ln.rsplit(" ", 1)[1]) for ln in h
             if ln.startswith("mo_query_duration_seconds_count")][0]
    assert inf == count > 0
    for fam in ("mo_trace_spans_total", "mo_fusion_graphs_total",
                "mo_plan_cache_ops_total", "mo_fault_triggered_total"):
        assert f"# TYPE {fam} counter" in text


def test_shared_metric_names_help_and_types_match_reference():
    """Every metric both registries hold has the same type, and the
    port keeps the reference's name for what it shares."""
    jax, port = packages()
    js, ts = jax.M.REGISTRY.snapshot(), port.M.REGISTRY.snapshot()
    shared = set(js) & set(ts)
    for name in ("mo_query_duration_seconds", "mo_scan_rows_total",
                 "mo_txn_commit_total", "mo_plan_cache_ops_total",
                 "mo_result_cache_ops_total", "mo_admission_total",
                 "mo_admission_queue_seconds", "mo_trace_spans_total",
                 "mo_trace_ring_dropped_total", "mo_fault_triggered_total",
                 "mo_fusion_dispatch_total", "mo_fusion_compile_total"):
        assert name in shared, name
    assert {n: js[n]["type"] for n in shared} == \
        {n: ts[n]["type"] for n in shared}


def test_multi_statement_span_attribution(tracers):
    """In a multi-statement execute each row covers only its own
    statement's spans: the first owns the shared `parse`, and each
    persisted span tree (every statement is "slow" here) holds exactly
    one `run` span, so statement 2 re-reports none of statement 1's
    (the cumulative-window bug)."""
    def scenario(pkg):
        pkg.motrace.TRACER.slow_ms = 0.001
        s = _session(pkg)
        s.execute("create table mA (a bigint); create table mB (b bigint)")
        s.catalog.stmt_recorder.flush()
        rows = s.execute(
            f"select statement, span_count, span_summary, span_tree from "
            f"{pkg.trace.STMT_TABLE} "
            f"where statement like 'create table mA%'").rows()
        assert pkg.note("rows", len(rows)) == 2
        first, second = sorted(rows, key=lambda r: r[1], reverse=True)
        s1 = json.loads(first[2])
        s2 = json.loads(second[2])
        assert "parse" in s1 and "parse" not in s2
        assert first[1] >= 2 and second[1] >= 1
        for row in (first, second):
            names = [n for root in json.loads(row[3])
                     for _, n in _tree_names(root)]
            assert pkg.note("runs", names.count("run")) == 1
    run_both(scenario)


def test_histogram_delta_quantile():
    def scenario(pkg):
        h = pkg.M.Histogram("mo_test_delta_seconds", "t")
        for _ in range(100):
            h.observe(0.002)
        before = h.snapshot()
        for _ in range(10):
            h.observe(0.3)
        after = h.snapshot()
        assert pkg.note("p50", pkg.M.histogram_delta_quantile(
            before, after, 0.5)) == 0.5
        assert after["count"] - before["count"] == 10
        assert pkg.note("q50", h.quantile(0.5)) == 0.005
    run_both(scenario)


def test_registry_snapshot_and_quantile():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("create table sn (a bigint)")
        s.execute("insert into sn values (1)")
        snap = pkg.M.REGISTRY.snapshot()
        q = snap["mo_query_duration_seconds"]
        assert q["type"] == "histogram" and q["count"] > 0 and q["sum"] > 0
        assert sum(b["count"] for b in q["buckets"]) == q["count"]
        assert snap["mo_txn_commit_total"]["type"] == "counter"
        assert pkg.M.query_seconds.quantile(0.5) > 0
        assert pkg.M.query_seconds.quantile(0.99) >= \
            pkg.M.query_seconds.quantile(0.5)
    run_both(scenario)


# ----------------------------------------------------------- ops surface
def test_mo_ctl_trace_and_show_trace(tracers, tmp_path):
    def scenario(pkg):
        tr = pkg.motrace.TRACER
        s = _session(pkg)
        s.execute("create table oc (a bigint)")
        s.execute("insert into oc values (1)")
        st = json.loads(
            s.execute("select mo_ctl('trace','status')").rows()[0][0])
        pkg.note("status keys", sorted(st))
        assert st["armed"] and st["traces"] >= 2
        rows = s.execute("show trace").rows()
        assert any(r[1] == "statement" and r[3] >= 2 for r in rows)
        pkg.note("show trace columns", s.execute(
            "show trace").column_names)
        out = str(tmp_path / pkg.name / "traces")
        msg = s.execute(
            f"select mo_ctl('trace','dump:{out}')").rows()[0][0]
        assert msg.startswith("dumped")
        files = sorted(os.listdir(out))
        assert len(files) >= st["traces"]
        assert all(f.startswith("trace_") and f.endswith(".json")
                   for f in files)
        ct = json.loads(open(os.path.join(out, files[0])).read())
        assert ct["traceEvents"]
        s.execute("select mo_ctl('trace','slow:25')")
        assert tr.slow_ms == 25.0
        s.execute("select mo_ctl('trace','sample:0.25')")
        assert tr.sample == 0.25
        tr.sample = 1.0
        s.execute("select mo_ctl('trace','off')")
        assert not tr.armed
        s.execute("select mo_ctl('trace','on')")
        assert tr.armed
        with pytest.raises(Exception) as ei:
            s.execute("select mo_ctl('trace','bogus')")
        pkg.note("bogus", type(ei.value).__name__)
    run_both(scenario)


def test_mo_ctl_metrics_dump():
    def scenario(pkg):
        s = _session(pkg)
        s.execute("create table md (a bigint)")
        text = s.execute("select mo_ctl('metrics','dump')").rows()[0][0]
        assert "# TYPE mo_query_duration_seconds histogram" in text
        snap = json.loads(s.execute(
            "select mo_ctl('metrics','snapshot')").rows()[0][0])
        assert snap["mo_query_duration_seconds"]["count"] > 0
    run_both(scenario)
