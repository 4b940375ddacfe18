"""Ingest on the port against the JAX package's, on the CPU: LOAD DATA
(a local path, file://, fs:// and stage://), the stage statements,
`load_csv`, `load_file()` over text and documents, and external CSV
tables.

Each case runs the same statements through the JAX `Session` and the
port's `Session(device="cpu")`, each on an engine of its own over the
same files, and holds the port to the JAX session statement by
statement (`torch_scripts.same_outcome`: rows, `affected`, and the
exception's class name wherever the reference raises).  The scripts are
the reference's own tests (tests/test_external_stage.py,
tests/test_sql_features.py's `load_csv`, tests/test_doctext.py), with
CSV in place of parquet where the reference reads parquet (the port
never imports pyarrow), plus the missing-column error, the
auto-increment column, a KILL between chunks, restarts and the
external table's cache.  The JAX side runs its per-operator path
(MO_PLAN_FUSION=0) with its Pallas kernels in interpret mode
(MO_HAND_KERNELS=1).

A DECIMAL column is the exception: the reference loads `12.50` into a
DECIMAL(15,2) as 0.12 (ROADMAP.md section C, standing decisions), so
that case is held to Python's `decimal` and to the port's INSERT of the
same literals instead.
"""

import decimal
import time

import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage import engine as jengine, external as jext, \
    fileservice as jfs
from matrixone_tpu.utils import metrics as JM
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.storage import engine as tengine, \
    external as text_, fileservice as tfs
from matrixone_tpu_torch.utils import metrics as TM
from test_doctext import _make_docx, _make_pdf
from torch_scripts import run_step, same_outcome

PKGS = ("jax", "port")
ENGINE = {"jax": jengine.Engine, "port": tengine.Engine}
LOCALFS = {"jax": jfs.LocalFS, "port": tfs.LocalFS}
EXTERNAL = {"jax": jext, "port": text_}
METRICS = {"jax": JM, "port": TM}


@pytest.fixture(scope="module", autouse=True)
def env():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    yield
    mp.undo()


def new_session(pkg, catalog=None):
    if pkg == "jax":
        return JSession() if catalog is None else JSession(catalog=catalog)
    return TSession(catalog=catalog, device="cpu")


def run_both(steps, make=None, setup=None):
    """Run `steps` on a fresh session of each package (`make(pkg)`
    builds it; `setup(pkg, sess)` runs first) and compare every step.
    `!` marks a step the reference must fail.  -> {pkg: outcomes}."""
    outs = {}
    for pkg in PKGS:
        sess = make(pkg) if make is not None else new_session(pkg)
        try:
            if setup is not None:
                setup(pkg, sess)
            outs[pkg] = [run_step(sess, s.lstrip("!")) for s in steps]
        finally:
            sess.close()
    for step, w, g in zip(steps, outs["jax"], outs["port"]):
        assert (w[0] == "err") == step.startswith("!"), (step, w)
        assert same_outcome(g, w), (step, g, w)
    return outs


def _message(sess, sql):
    with pytest.raises(Exception) as ei:
        sess.execute(sql)
    return type(ei.value).__name__, str(ei.value)


# ------------------------------------------------ LOAD DATA and stages

@pytest.mark.parametrize("where", ["stage", "local", "file", "fs"])
def test_load_data_csv_from_each_location(tmp_path, where):
    """tests/test_external_stage.py:48 (`test_load_data_csv_from_stage`)
    at each kind of location: a trailing empty string field is '' (CSV
    strings are never NULL), and a dropped stage no longer resolves."""
    body = b"a,b\n1,x\n2,y\n3,\n"
    (tmp_path / "rows.csv").write_bytes(body)
    url = {"stage": "stage://landing/rows.csv",
           "local": str(tmp_path / "rows.csv"),
           "file": f"file://{tmp_path}/rows.csv",
           "fs": "fs://in/rows.csv"}[where]

    def setup(pkg, sess):
        sess.catalog.fs.write("in/rows.csv", body)

    run_both([f"create stage landing url = 'file://{tmp_path}'",
              "show stages",
              "create table c (a int primary key, b varchar(5))",
              f"load data infile '{url}' into table c format csv",
              "select a, b from c order by a",
              "select count(*) from c where b = ''",
              "drop stage landing",
              "show stages",
              "!load data infile 'stage://landing/rows.csv' into table c",
              "!drop stage landing",
              "!load data infile 'stage://nope/rows.csv' into table c",
              f"!load data infile '{tmp_path}/missing.csv' into table c",
              f"!load data infile '{url}' into table c format iceberg",
              f"!load data infile '{url}' into table c format xml"],
             setup=setup)


def test_stage_errors_give_the_reference_text(tmp_path):
    (tmp_path / "rows.csv").write_text("a\n1\n")
    texts = {}
    for pkg in PKGS:
        s = new_session(pkg)
        s.execute("create table t (a int primary key)")
        s.execute("create stage deep url = 'stage://other'")
        texts[pkg] = [
            _message(s, "drop stage ghost"),
            _message(s, "load data infile 'stage://ghost/x.csv' into "
                        "table t"),
            _message(s, "load data infile 'stage://deep/x.csv' into "
                        "table t"),
            _message(s, f"load data infile '{tmp_path}/nope.csv' into "
                        f"table t"),
            _message(s, "load data infile '/tmp' into table t format "
                        "iceberg")]
        s.close()
    assert texts["port"] == texts["jax"]


def test_load_data_respects_transaction(tmp_path):
    """tests/test_external_stage.py:121: a rollback discards the load, a
    commit keeps it."""
    csv = tmp_path / "tx.csv"
    csv.write_text("a\n1\n2\n3\n")
    run_both(["create table tx (a int primary key)",
              "begin",
              f"load data infile '{csv}' into table tx",
              "select count(*) from tx",
              "rollback",
              "select count(*) from tx",
              "begin",
              f"load data infile '{csv}' into table tx",
              "commit",
              "select count(*), sum(a) from tx",
              f"!load data infile '{csv}' into table tx",
              "select count(*) from tx"])


def test_load_file_datalink(tmp_path):
    """tests/test_external_stage.py:137."""
    (tmp_path / "note.txt").write_text("hello datalink")
    run_both([f"create stage docs url = 'file://{tmp_path}'",
              "select load_file('stage://docs/note.txt') t",
              f"select load_file('{tmp_path}/note.txt') t",
              "select length(load_file('stage://docs/note.txt'))",
              "!select load_file('stage://docs/absent.txt')",
              "!select load_file('stage://nostage/note.txt')"])


def test_load_file_over_documents(tmp_path):
    """tests/test_doctext.py's `load_file` cases: .docx and .pdf text,
    `length()` over it, and a malformed document as a SQL error."""
    docx = tmp_path / "doc.docx"
    docx.write_bytes(_make_docx(["contract text body"]))
    pdf = tmp_path / "doc.pdf"
    pdf.write_bytes(_make_pdf(["invoice total 42"]))
    raw = tmp_path / "raw.pdf"
    raw.write_bytes(_make_pdf(["Alpha beta", "Gamma"], compress=False))
    bad = tmp_path / "not_really.docx"
    bad.write_text("just text")
    outs = run_both([f"select load_file('{docx}')",
                     f"select load_file('{pdf}')",
                     f"select load_file('{raw}')",
                     f"select length(load_file('{docx}'))",
                     f"!select load_file('{bad}')"])
    assert outs["port"][0][2] == [("contract text body",)]
    assert "invoice total 42" in outs["port"][1][2][0][0]
    s = new_session("port")
    with pytest.raises(Exception, match="cannot extract text"):
        s.execute(f"select load_file('{bad}')")
    s.close()


def test_load_csv_with_vector_literals(tmp_path):
    """tests/test_sql_features.py:215: `load_csv` into a table with an
    auto_increment key and a vecf32 column, quoted vector literals."""
    p = tmp_path / "x.csv"
    p.write_text('id,name,e\n10,aa,"[1,1,1,1]"\n11,bb,"[2,2,2,2]"\n'
                 '12,cc,""\n')

    def setup(pkg, sess):
        sess.execute("create table t (id bigint auto_increment primary "
                     "key, name varchar(10), e vecf32(4))")
        sess.execute("insert into t (name, e) values ('x', '[1,2,3,4]')")
        assert sess.load_csv("t", str(p)) == 3

    run_both(["select id, name, e from t order by id",
              "select count(*) from t where e is null",
              "insert into t (name, e) values ('y', '[0,0,0,1]')",
              "select id, name from t order by id"], setup=setup)
    s = new_session("port")
    s.execute("create table t (a int)")
    with pytest.raises(TypeError, match="no reader options"):
        s.load_csv("t", str(p), delimiter=";")
    s.close()


def test_missing_and_extra_columns(tmp_path):
    """The missing-column BindError (its text too); extra file columns
    are ignored."""
    (tmp_path / "m.csv").write_text("a,zz\n1,9\n2,8\n")
    (tmp_path / "x.csv").write_text("b,extra,a\nu,1,1\nv,2,2\n")
    run_both(["create table t (a bigint primary key, b varchar(4))",
              f"!load data infile '{tmp_path}/m.csv' into table t",
              f"load data infile '{tmp_path}/x.csv' into table t",
              "select a, b from t order by a"])
    texts = {}
    for pkg in PKGS:
        s = new_session(pkg)
        s.execute("create table t (a bigint primary key, b varchar(4))")
        texts[pkg] = _message(
            s, f"load data infile '{tmp_path}/m.csv' into table t")
        s.close()
    assert texts["port"] == texts["jax"]
    assert "file is missing columns ['b']" in texts["port"][1]


def test_auto_increment_absent_and_present(tmp_path):
    """The auto_increment column is allocated when the file lacks it and
    observed (the counter advances past) when it has it."""
    (tmp_path / "absent.csv").write_text("v\nx\ny\nz\n")
    (tmp_path / "present.csv").write_text("id,v\n10,p\n20,q\n")
    run_both(["create table t (id bigint auto_increment primary key, "
              "v varchar(4))",
              f"load data infile '{tmp_path}/absent.csv' into table t",
              f"load data infile '{tmp_path}/present.csv' into table t",
              "insert into t (v) values ('after')",
              f"load data infile '{tmp_path}/absent.csv' into table t",
              "select id, v from t order by id"])


def test_types_and_nulls_load_as_the_reference(tmp_path):
    """One file with every type the reader infers, into a table of the
    matching types and into varchar: the reference's values, NULLs and
    string forms (BVT `load/csv_nulls` at more types)."""
    (tmp_path / "t.csv").write_text(
        "i,f,b,d,ts,s,n\n"
        "007,1.5,true,2020-01-02,2020-01-02 03:04:05,\"a,b\",\n"
        "-3,,false,1999-12-31,2000-02-29T23:59:59,\"q\"\"t\",\n"
        ",nan,true,,,NULL,\n"
        "12,1e20,false,2024-02-29,1970-01-01 00:00:00,,\n")
    cols = "i bigint, f double, b bool, d date, s varchar(8)"
    strs = ("i varchar(9), f varchar(9), b varchar(9), d varchar(12), "
            "ts varchar(24), s varchar(9), n varchar(4)")
    run_both([f"create table typed ({cols})",
              f"load data infile '{tmp_path}/t.csv' into table typed",
              "select i, f, b, d, s from typed order by i",
              "select count(*) from typed where f is null",
              f"create table strs ({strs})",
              f"load data infile '{tmp_path}/t.csv' into table strs",
              "select i, f, b, d, ts, s, n from strs order by i",
              "select count(*) from strs where n is null"])


def test_kill_between_chunks_leaves_the_table(tmp_path, monkeypatch):
    """KILL QUERY between chunks: the statement-scoped transaction rolls
    back whole.  Both packages are killed before their first chunk; the
    port is also killed mid-file with its chunk rows patched to 2."""
    (tmp_path / "k.csv").write_text(
        "a\n" + "".join(f"{i}\n" for i in range(7)))
    load = f"load data infile '{tmp_path}/k.csv' into table k"

    def killer(sess, at):
        orig = sess._procs.check_killed
        calls = {"n": 0}

        def check(cid):
            calls["n"] += 1
            if calls["n"] == at:
                sess._procs.kill(cid, query_only=True)
            return orig(cid)
        monkeypatch.setattr(sess._procs, "check_killed", check)
        return calls

    def setup(pkg, sess):
        sess.execute("create table k (a int primary key)")
        sess.execute("insert into k values (100)")
        killer(sess, 1)

    run_both([f"!{load}", "select count(*), sum(a) from k",
              "select count(*) from k"], setup=setup)
    monkeypatch.setattr(TSession, "LOAD_CHUNK_ROWS", 2)
    s = new_session("port")
    s.execute("create table k (a int primary key)")
    s.execute("insert into k values (100)")
    calls = killer(s, 3)
    with pytest.raises(Exception) as ei:
        s.execute(load)
    assert type(ei.value).__name__ == "QueryKilled" and calls["n"] == 3
    assert s.execute("select count(*), sum(a) from k").rows() == [(1, 100)]
    assert s.execute(load).affected == 7          # the next load runs
    assert s.execute("select count(*) from k").rows() == [(8,)]
    s.close()


@pytest.mark.parametrize("checkpoint", [False, True])
def test_load_and_stages_survive_a_restart(tmp_path, checkpoint):
    """LOAD DATA, a stage and an external table over a LocalFS engine,
    then `Engine.open` of the directory: a WAL-only restart, and one
    after a checkpoint."""
    (tmp_path / "rows.csv").write_text("a,b\n1,x\n2,y\n3,\n")
    steps = [f"create stage st url = 'file://{tmp_path}'",
             "create table t (a int primary key, b varchar(5))",
             "load data infile 'stage://st/rows.csv' into table t",
             "create external table ext (a bigint, b varchar(5)) "
             "location 'stage://st/rows.csv'",
             "create stage gone url = '/nowhere'",
             "drop stage gone"]
    reads = ["show stages", "select a, b from t order by a",
             "select count(*), sum(a) from ext",
             "select load_file('stage://st/rows.csv')",
             "!insert into ext values (4, 'w')"]
    outs = {}
    for pkg in PKGS:
        d = str(tmp_path / f"data_{pkg}")
        eng = ENGINE[pkg](fs=LOCALFS[pkg](d))
        s = new_session(pkg, eng)
        for st in steps:
            s.execute(st)
        s.close()
        if checkpoint:
            eng.checkpoint()
        eng2 = ENGINE[pkg].open(LOCALFS[pkg](d))
        s2 = new_session(pkg, eng2)
        outs[pkg] = [run_step(s2, r.lstrip("!")) for r in reads]
        s2.close()
    for r, w, g in zip(reads, outs["jax"], outs["port"]):
        assert (w[0] == "err") == r.startswith("!"), (r, w)
        assert same_outcome(g, w), (r, g, w)


# ---------------------------------------------------- external tables

def _ext_csv(path, n):
    """id, name (never NULL: a CSV string), grp (NULL every 11th), v."""
    lines = ["id,name,grp,v"]
    for i in range(n):
        grp = "" if i % 11 == 0 else str(i % 7)
        lines.append(f"{i},n{i % 7},{grp},{i * 0.5}")
    path.write_text("\n".join(lines) + "\n")


def test_external_table_scan_group_join_refused_write(tmp_path):
    """tests/test_external_stage.py's `test_external_table_scan` over a
    CSV file: a scan, a GROUP BY with a NULL group, a join with an
    internal table, and a refused INSERT."""
    p = tmp_path / "e.csv"
    _ext_csv(p, 1000)
    run_both([f"create external table ext (id bigint, name varchar(10), "
              f"grp int, v double) location '{p}' format csv",
              "select count(*) c, sum(id), sum(v) from ext",
              "select grp, count(*) c from ext where id < 100 "
              "group by grp order by grp",
              "create table dim (name varchar(10), w int)",
              "insert into dim values ('n1', 10), ('n2', 20)",
              "select dim.name, count(*) c, sum(w) from ext, dim "
              "where ext.name = dim.name group by dim.name "
              "order by dim.name",
              "!insert into ext values (1, 'x', 1, 1.0)",
              "!delete from ext where id = 1",
              "!analyze table ext",
              "select count(*) from ext",
              "drop table ext",
              "!select count(*) from ext"])


def test_external_zonemap_skip(tmp_path):
    """Chunks whose zonemap excludes the filter are skipped: 1,000-row
    chunks of a 10,000-row file, `id < 1000` scans the first only, as
    `mo_scan_rows_total` counts in both packages."""
    p = tmp_path / "z.csv"
    p.write_text("id\n" + "".join(f"{i}\n" for i in range(10000)))
    scanned = {}
    for pkg in PKGS:
        s = new_session(pkg)
        s.variables["batch_rows"] = 1000
        s.execute(f"create external table big (id bigint) location "
                  f"'{p}'")
        before = METRICS[pkg].rows_scanned.get(table="big")
        assert s.execute("select count(*) from big where id < 1000"
                         ).rows() == [(1000,)]
        scanned[pkg] = METRICS[pkg].rows_scanned.get(table="big") - before
        s.close()
    assert scanned["port"] == scanned["jax"] == 1000


def test_external_cache_hits_and_invalidation(tmp_path, monkeypatch):
    """Repeat scans of an unchanged local file are served from the
    decoded-chunk cache (no re-open, no parse); rewriting the file
    invalidates it (mtime/size)."""
    for pkg in PKGS:
        p = tmp_path / f"ev_{pkg}.csv"
        p.write_text("id,v\n1,10\n2,20\n")
        s = new_session(pkg)
        s.execute(f"create external table ec (id bigint, v bigint) "
                  f"location '{p}' format csv")
        opens = {"n": 0}
        orig = EXTERNAL[pkg].open_location

        def counted(engine, url, orig=orig, opens=opens):
            opens["n"] += 1
            return orig(engine, url)
        monkeypatch.setattr(EXTERNAL[pkg], "open_location", counted)
        assert [tuple(map(int, r)) for r in
                s.execute("select id, v from ec order by id").rows()] \
            == [(1, 10), (2, 20)]
        first = opens["n"]
        assert first >= 1
        if pkg == "port":
            parses = TM.external_parses.get(table="ec")
        for _ in range(3):
            s.execute("select sum(v) from ec")
        assert opens["n"] == first, (pkg, "a cached scan re-opened")
        if pkg == "port":
            assert TM.external_parses.get(table="ec") == parses
        time.sleep(0.02)
        p.write_text("id,v\n1,10\n2,20\n3,30\n")
        rows = s.execute("select count(*), sum(v) from ec").rows()
        assert (int(rows[0][0]), int(rows[0][1])) == (3, 60)
        assert opens["n"] > first
        if pkg == "port":
            assert TM.external_parses.get(table="ec") > parses
        s.close()


def test_external_cache_budget_and_release(tmp_path, monkeypatch):
    """Past `MO_EXTERNAL_CACHE_MB` the table streams; DROP TABLE gives
    the cached bytes back to the process-wide budget."""
    p = tmp_path / "b.csv"
    _ext_csv(p, 300)
    s = new_session("port")
    s.execute(f"create external table b (id bigint, name varchar(10), "
              f"grp int, v double) location '{p}'")
    t = s.catalog.get_table("b")
    base = text_.ExternalTable._cache_used
    assert s.execute("select count(*) from b").rows() == [(300,)]
    held = text_.ExternalTable._cache_used - base
    assert held > 0 and t._cache is not None
    s.execute("drop table b")
    assert text_.ExternalTable._cache_used == base
    monkeypatch.setenv("MO_EXTERNAL_CACHE_MB", "0")
    s.execute(f"create external table b (id bigint, name varchar(10), "
              f"grp int, v double) location '{p}'")
    parses = TM.external_parses.get(table="b")
    for _ in range(2):
        assert s.execute("select sum(id) from b").rows() == [(44850,)]
    assert TM.external_parses.get(table="b") == parses + 2
    s.close()


def test_external_parquet_and_iceberg_name_pyarrow(tmp_path):
    """Parquet and iceberg external tables register (as the reference's
    do) and raise NotImplementedError naming pyarrow when read."""
    s = new_session("port")
    s.execute(f"create external table pq (a bigint) location "
              f"'{tmp_path}/x.parquet'")
    s.execute(f"create external table ice (a bigint) location "
              f"'{tmp_path}' format iceberg")
    for t in ("pq", "ice"):
        with pytest.raises(NotImplementedError, match="pyarrow"):
            s.execute(f"select count(*) from {t}")
    (tmp_path / "v.parquet").write_bytes(b"PAR1")
    s.execute("create table v (a bigint)")
    with pytest.raises(NotImplementedError, match="pyarrow"):
        s.execute(f"load data infile '{tmp_path}/v.parquet' into table v")
    s.close()


# ------------------------------------------------------------- DECIMAL

DECIMALS = ["12.50", "3.01", "100.99", "0", "-7.25", "  4.5 ", "+2.1",
            "99999999999.99", "-0.01", ".75", "8.", "1.005", "1.015",
            "2.675", "0.125", "-1.005", "1e3", "2.5E-1", "7"]


def test_decimal_loads_exactly(tmp_path):
    """DECIMAL(15,2) fields load as the exact scaled int64 (Python
    `decimal`, half to even) where they carry at most 2 fraction digits,
    and equal the port's INSERT of the same literal for every value
    (digits past the scale round as INSERT rounds them).  The
    reference's loss (12.50 -> 0.12) is not reproduced."""
    lines = ["k,price,qty"] + [f"{i},{v},{i}" for i, v in
                               enumerate(DECIMALS)] + [f"{len(DECIMALS)},,1"]
    (tmp_path / "d.csv").write_text("\n".join(lines) + "\n")
    s = new_session("port")
    s.execute("create table t (k bigint primary key, price decimal(15,2), "
              "qty decimal(10,0))")
    assert s.execute(f"load data infile '{tmp_path}/d.csv' into table t"
                     ).affected == len(DECIMALS) + 1
    tab = s.catalog.get_table("t")
    got = {}
    for arrays, validity, _d, n in tab.iter_chunks(["k", "price"], 1 << 20):
        for k, p, ok in zip(arrays["k"], arrays["price"],
                            validity["price"]):
            got[int(k)] = int(p) if ok else None
    assert got[len(DECIMALS)] is None
    ins = new_session("port")
    ins.execute("create table t (k bigint primary key, "
                "price decimal(15,2))")
    for i, v in enumerate(DECIMALS):
        ins.execute(f"insert into t values ({i}, {v.strip()})")
    itab = ins.catalog.get_table("t")
    want_insert = {}
    for arrays, _v, _d, _n in itab.iter_chunks(["k", "price"], 1 << 20):
        want_insert.update(zip(arrays["k"].tolist(),
                               arrays["price"].tolist()))
    for i, v in enumerate(DECIMALS):
        assert got[i] == want_insert[i], (v, got[i], want_insert[i])
        d = decimal.Decimal(v.strip())
        if -d.as_tuple().exponent <= 2:
            exact = int((d * 100).to_integral_value(decimal.ROUND_HALF_EVEN))
            assert got[i] == exact, (v, got[i], exact)
    rows = s.execute("select k, price from t where k < 3 order by k").rows()
    assert rows == [(0, 12.5), (1, 3.01), (2, 100.99)]
    assert s.execute("select sum(price) from t where k < 3").rows() == \
        [(116.5,)]
    with pytest.raises(ValueError, match="invalid decimal"):
        (tmp_path / "bad.csv").write_text("k,price,qty\n1,abc,1\n")
        s.execute(f"load data infile '{tmp_path}/bad.csv' into table t")
    assert s.execute("select count(*) from t").rows() == \
        [(len(DECIMALS) + 1,)]
    s.close()
    ins.close()


def test_reference_loses_the_decimal_fraction(tmp_path):
    """The standing decision's input, pinned: the reference stores 0.12,
    0.03 and 1.00 for 12.50, 3.01 and 100.99; the port stores them."""
    (tmp_path / "p.csv").write_text(
        "k,price\n1,12.50\n2,3.01\n3,100.99\n")
    rows = {}
    for pkg in PKGS:
        s = new_session(pkg)
        s.execute("create table t (k bigint primary key, "
                  "price decimal(15,2))")
        s.execute(f"load data infile '{tmp_path}/p.csv' into table t")
        rows[pkg] = s.execute("select price from t order by k").rows()
        s.close()
    assert rows["jax"] == [(0.12,), (0.03,), (1.0,)]
    assert rows["port"] == [(12.5,), (3.01,), (100.99,)]



def test_convert_carries_internal_tables_only(tmp_path):
    """`convert.tables_to_numpy` skips an external table (its rows live
    in a file) and carries the loaded one."""
    from matrixone_tpu_torch import convert
    (tmp_path / "r.csv").write_text("a,b\n1,x\n2,y\n")
    s = new_session("port")
    s.execute("create table t (a bigint primary key, b varchar(4))")
    s.execute(f"load data infile '{tmp_path}/r.csv' into table t")
    s.execute(f"create external table e (a bigint, b varchar(4)) "
              f"location '{tmp_path}/r.csv'")
    carried = convert.tables_to_numpy(s.catalog)
    assert "t" in carried and "e" not in carried
    s2 = TSession(catalog=convert.tables_from_numpy(carried), device="cpu")
    assert s2.execute("select a, b from t order by a").rows() == \
        [(1, "x"), (2, "y")]
    s.close()
    s2.close()
