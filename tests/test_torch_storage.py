"""The port's object format, WAL, checkpoints and restarts, on the CPU.

The format and the log are the port's own (numpy blocks behind a JSON
header, standard library only), so they are held to themselves: a round
trip of every column type with NULLs, zero rows, a ranged read of one
column, a flipped byte that raises, a torn WAL tail that is dropped.
The engine's durability is held to the JAX package's: the scenarios of
tests/test_txn_storage.py (WAL replay, checkpoint + WAL tail, LocalFS,
a torn tail, dictionary growth after a checkpoint, a merge), PARTITION
BY and AUTO_INCREMENT across restarts (tests/test_partition.py,
tests/test_spill.py) run through both packages, each on its own file
service, and every row set read after each restart, checkpoint and
merge must be equal (`torch_storage_pkgs.run_both`).
"""

import zlib

import numpy as np
import pytest

from matrixone_tpu.storage import arrowio as jarrowio
from matrixone_tpu_torch.storage import objectio, wal
from matrixone_tpu_torch.storage.fileservice import LocalFS, MemoryFS
from matrixone_tpu_torch.utils import metrics as TM
from torch_storage_pkgs import run_both, storage_env  # noqa: F401

pytestmark = pytest.mark.usefixtures("storage_env")


# ------------------------------------------------------------ the format

def _all_types(n, rng):
    arrays = {
        "b": rng.random(n) < 0.5,
        "i8": rng.integers(-128, 127, n).astype(np.int8),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "i32": rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int32),
        "i64": rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "u64": rng.integers(0, 2 ** 63, n).astype(np.uint64) * 2 + 1,
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n),
        "dec": rng.integers(-10 ** 12, 10 ** 12, n).astype(np.int64),
        "date": rng.integers(0, 20000, n).astype(np.int32),
        "codes": rng.integers(0, 50, n).astype(np.int32),
        "vec": rng.standard_normal((n, 7)).astype(np.float32),
    }
    validity = {c: rng.random(n) < 0.8 for c in arrays}
    return arrays, validity


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_object_round_trip_every_type(n):
    rng = np.random.default_rng(n)
    arrays, validity = _all_types(n, rng)
    fs = MemoryFS()
    zms = objectio.compute_zonemaps(arrays, validity)
    meta = objectio.ObjectMeta("t", f"o{n}", n, 7, zms)
    path = objectio.write_object(fs, meta, arrays, validity)
    assert path == "objects/t/o%d.obj" % n
    m2, a2, v2 = objectio.read_object(fs, path)
    assert (m2.n_rows, m2.commit_ts, m2.table) == (n, 7, "t")
    assert set(m2.zonemaps) == {c for c, a in arrays.items()
                                if a.ndim == 1 and a.dtype != np.bool_}
    for c in arrays:
        assert a2[c].dtype == arrays[c].dtype and \
            a2[c].shape == arrays[c].shape
        assert np.array_equal(a2[c], arrays[c]), c
        assert np.array_equal(v2[c], validity[c]), c
        if c in zms:
            want = arrays[c][validity[c]]
            zm = m2.zonemaps[c]
            assert zm.null_count == int((~validity[c]).sum())
            if len(want):
                assert (zm.min, zm.max) == (want.min(), want.max())
            else:
                assert (zm.min, zm.max) == (None, None)
    # one column by one ranged read, after a header-only read
    reads = []
    real = fs.read_range
    fs.read_range = lambda p, o, ln: reads.append(ln) or real(p, o, ln)
    m3, raw = objectio.read_header_ranged(fs, path)
    assert m3.n_rows == n and "cols" in raw
    d, v = objectio.read_column_block(fs, path, raw, "i64")
    assert np.array_equal(d, arrays["i64"])
    assert np.array_equal(v, validity["i64"])
    # the i64 data block (padded to 64 bytes) and its validity only
    assert len(reads) == 2 and reads[1] <= 64 + 9 * n + 64
    d, v = objectio.read_column_block(fs, path, raw, "vec")
    assert d.shape == (n, 7) and np.array_equal(d, arrays["vec"])
    assert np.array_equal(v, validity["vec"])


def _flip(fs, path, pos):
    blob = bytearray(fs.read(path))
    blob[pos] ^= 0x40
    fs.write(path, bytes(blob))


@pytest.mark.parametrize("where", ["data", "validity", "header"])
def test_flipped_byte_raises(where):
    rng = np.random.default_rng(5)
    arrays, validity = _all_types(500, rng)
    fs = MemoryFS()
    meta = objectio.ObjectMeta("t", "o", 500, 1,
                               objectio.compute_zonemaps(arrays, validity))
    path = objectio.write_object(fs, meta, arrays, validity)
    _m, raw = objectio.read_header_ranged(fs, path)
    if where == "header":
        pos = 40                      # inside the JSON header
    else:
        pos = raw["_body_off"] + raw["cols"]["i32"][where][0] + 3
    _flip(fs, path, pos)
    with pytest.raises(objectio.ObjectCorrupt):
        objectio.read_object(fs, path)
    if where != "header":
        with pytest.raises(objectio.ObjectCorrupt):
            objectio.read_column_block(fs, path, raw, "i32")
        # the other columns still read
        d, _v = objectio.read_column_block(fs, path, raw, "i64")
        assert np.array_equal(d, arrays["i64"])
    else:
        with pytest.raises(objectio.ObjectCorrupt):
            objectio.read_header_ranged(fs, path)


def test_wal_frames_round_trip_and_torn_tail(tmp_path):
    fs = LocalFS(str(tmp_path))
    w = wal.WalWriter(fs)
    codes = np.array([3, 1, 3, 0, 2], np.int32)
    valid = np.array([True, True, True, False, True])
    de = wal.to_dict_encoded(["a", "b", "c", "d"], codes, valid)
    ref = jarrowio.to_dict_encoded(["a", "b", "c", "d"], codes, valid)
    assert de.cats == ref.cats == ["a", "b", "c", "d"]
    assert de.codes.tolist() == ref.codes.tolist() == [3, 1, 3, 0, 2]
    big = np.random.default_rng(2).integers(0, 5000, 20000)
    bval = np.random.default_rng(3).random(20000) < 0.9
    words = [f"w{i}" for i in range(6000)]
    de2 = wal.to_dict_encoded(words, big, bval)
    ref2 = jarrowio.to_dict_encoded(words, big, bval)
    assert de2.cats == ref2.cats and np.array_equal(de2.codes, ref2.codes)
    fields, blob = wal.arrays_to_payload(
        {"k": np.arange(5, dtype=np.int64), "s": de},
        {"k": np.ones(5, bool), "s": valid})
    w.append({"op": "insert", "table": "t", "ts": 5, **fields}, blob)
    w.append({"op": "delete", "table": "t", "ts": 5, "n": 2},
             np.array([1, 4], "<i8").tobytes())
    w.append({"op": "commit", "ts": 5})
    good = len(fs.read("wal/wal.log"))
    fs.append("wal/wal.log", b"\x41\x57\x4f\x4d\xff\xff")
    stats = {}
    frames = list(w.replay(stats=stats))
    assert [h["op"] for h, _ in frames] == ["insert", "delete", "commit"]
    assert stats["frames"] == 3 and stats["torn_bytes"] == 6
    a, v = wal.payload_to_arrays(*frames[0])
    assert a["k"].tolist() == list(range(5))
    assert a["s"].cats == de.cats and a["s"].codes.tolist() == \
        de.codes.tolist()
    assert v["s"].tolist() == valid.tolist()
    # a flipped byte in the second frame: it and everything after it
    # are dropped
    blob2 = bytearray(fs.read("wal/wal.log"))
    first = 12 + int.from_bytes(blob2[4:8], "little")
    blob2[first + 20] ^= 1
    fs.write("wal/wal.log", bytes(blob2))
    stats = {}
    assert [h["op"] for h, _ in w.replay(stats=stats)] == ["insert"]
    assert stats["torn_bytes"] == len(blob2) - first
    assert good > first
    w.truncate()
    assert list(w.replay()) == []


def test_local_fs_atomic_write_and_orphans(tmp_path):
    fs = LocalFS(str(tmp_path))
    fs.write("a/b.obj", b"123456")
    assert fs.read_range("a/b.obj", 2, 3) == b"345"
    (tmp_path / "a" / "c.obj.tmp").write_bytes(b"half")
    assert fs.list("a/") == ["a/b.obj"]
    assert fs.orphans() == ["a/c.obj.tmp"]
    assert zlib.crc32(fs.read("a/b.obj")) == zlib.crc32(b"123456")


# ------------------------------------- durability against the reference

def _mk(pkg, fs):
    s = pkg.session(pkg.Engine(fs))
    s.execute("create table t (id bigint, v bigint)")
    s.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    return s


def test_wal_replay_restart(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = _mk(pkg, fs)
        s.execute("delete from t where id = 3")
        s.execute("begin")
        s.execute("insert into t values (5, 50)")
        s.execute("commit")
        eng2 = pkg.Engine.open(fs)
        got = pkg.rows(pkg.session(eng2), "select id, v from t order by id")
        assert got == [(1, 10), (2, 20), (5, 50)]
        return eng2.recovery_summary
    out = run_both(scenario, tmp_path)
    assert out["port"]["torn_bytes"] == out["jax"]["torn_bytes"] == 0
    assert out["port"]["frames_replayed"] > 0


def test_checkpoint_restart_and_wal_tail(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = _mk(pkg, fs)
        s.catalog.checkpoint()
        s.execute("insert into t values (6, 60)")
        s.execute("delete from t where id = 1")
        eng2 = pkg.Engine.open(fs)
        s2 = pkg.session(eng2)
        assert pkg.rows(s2, "select id from t order by id") == \
            [(2,), (3,), (6,)]
        s2.execute("create table st (k bigint, name varchar(10))")
        s2.execute("insert into st values (1, 'alpha'), (2, 'beta')")
        eng2.checkpoint()
        s3 = pkg.session(pkg.Engine.open(fs))
        assert pkg.rows(s3, "select name from st order by k") == \
            [("alpha",), ("beta",)]
        pkg.rows(s3, "select id, v from t order by id")
    run_both(scenario, tmp_path)


def test_local_fs_persistence(tmp_path):
    def scenario(pkg):
        s = _mk(pkg, pkg.local())
        s.catalog.checkpoint()
        s.execute("insert into t values (8, 80)")
        s2 = pkg.session(pkg.Engine.open(pkg.local()))
        assert len(pkg.rows(s2, "select * from t order by id")) == 4
        assert all(seg.is_lazy for seg in
                   s2.catalog.get_table("t").segments[:1])
    run_both(scenario, tmp_path)


def test_torn_wal_tail_ignored(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        _mk(pkg, fs)
        fs.append("wal/wal.log", b"\x41\x57\x4f\x4d\xff\xff")
        eng2 = pkg.Engine.open(fs)
        assert len(pkg.rows(pkg.session(eng2),
                            "select * from t order by id")) == 3
        return eng2.recovery_summary["torn_bytes"]
    out = run_both(scenario, tmp_path)
    assert out["port"] == out["jax"] == 6


def test_wal_strings_after_checkpoint_dict_growth(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = pkg.session(pkg.Engine(fs))
        s.execute("create table u (k bigint, name varchar(10))")
        s.execute("insert into u values (1, 'aa')")
        s.catalog.checkpoint()
        s.execute("insert into u values (2, 'bb'), (3, 'aa')")
        s2 = pkg.session(pkg.Engine.open(fs))
        assert pkg.rows(s2, "select name from u order by k") == \
            [("aa",), ("bb",), ("aa",)]
        # and once more, from the second engine's own WAL tail
        s2.execute("insert into u values (4, 'cc'), (5, null)")
        s3 = pkg.session(pkg.Engine.open(fs))
        pkg.rows(s3, "select k, name from u order by k")
    run_both(scenario, tmp_path)


def test_segment_merge_compacts_and_preserves_data(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = pkg.session(pkg.Engine(fs))
        s.execute("create table t (id bigint, v varchar(5))")
        for i in range(6):
            s.execute(f"insert into t values ({2*i}, 'a'), ({2*i+1}, 'b')")
        s.execute("delete from t where id % 3 = 0")
        t = s.catalog.get_table("t")
        assert len(t.segments) == 6 and len(t.tombstones) == 1
        kept = s.catalog.merge_table("t")
        assert kept == 8 and len(t.segments) == 1 and not t.tombstones
        rows = pkg.rows(s, "select id, v from t order by id")
        assert [r[0] for r in rows] == [i for i in range(12) if i % 3 != 0]
        s2 = pkg.session(pkg.Engine.open(fs))
        assert len(pkg.rows(s2, "select * from t order by id")) == 8
        s2.execute("delete from t where id = 1")
        assert len(pkg.rows(s2, "select * from t order by id")) == 7
        pkg.rows(s2, "select v, count(*) from t group by v order by v")
    run_both(scenario, tmp_path)


def test_partition_restart_persistence(tmp_path):
    """tests/test_partition.py's restart, through a LocalFS engine: the
    PARTITION BY spec survives a checkpoint and the WAL tail."""
    def scenario(pkg):
        s = pkg.session(pkg.Engine.open(pkg.local()))
        s.execute("create table pr (k int, v int) partition by range(k) ("
                  "partition a values less than (100),"
                  "partition b values less than (maxvalue))")
        s.execute("insert into pr values (1,1),(150,2)")
        s.catalog.checkpoint()
        s.execute("insert into pr values (2,3),(151,4)")   # WAL tail only
        s2 = pkg.session(pkg.Engine.open(pkg.local()))
        got = pkg.rows(s2, "show partitions from pr")
        assert [(r[0], r[-1]) for r in got] == [("a", 2), ("b", 2)]
        assert pkg.rows(s2, "select sum(v) sv from pr where k < 100") == \
            [(4,)]
        assert s2.catalog.get_table("pr").meta.partition.names == \
            ["a", "b"]
        # a DROP PARTITION is logged too
        s2.execute("alter table pr drop partition a")
        s3 = pkg.session(pkg.Engine.open(pkg.local()))
        pkg.rows(s3, "show partitions from pr")
        pkg.rows(s3, "select k, v from pr order by k")
    run_both(scenario, tmp_path)


def test_auto_increment_survives_checkpoint_and_wal_replay(tmp_path):
    """tests/test_spill.py's AUTO_INCREMENT case: next_auto rides the
    manifest and is rebuilt by the WAL replay."""
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = pkg.session(fs=fs) if pkg.name == "jax" else \
            pkg.session(pkg.Engine(fs))
        s.execute("create table t (id bigint primary key auto_increment, "
                  "x int)")
        s.execute("insert into t (x) values (10), (20)")
        s.catalog.checkpoint()
        s.execute("insert into t (x) values (30)")        # WAL-only tail
        s2 = pkg.session(pkg.Engine.open(fs))
        s2.execute("insert into t (x) values (40)")
        assert [(int(a), int(b)) for a, b in pkg.rows(
            s2, "select id, x from t order by id")] == [
            (1, 10), (2, 20), (3, 30), (4, 40)]
        s3 = pkg.session(pkg.Engine.open(fs))
        s3.execute("insert into t (x) values (50)")
        assert int(pkg.rows(s3, "select max(id) from t")[0][0]) == 5
    run_both(scenario, tmp_path)


def test_snapshots_survive_restart(tmp_path):
    """CREATE/DROP SNAPSHOT are logged: AS OF a snapshot reads the same
    rows after a replay and after a checkpoint."""
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = _mk(pkg, fs)
        s.execute("create snapshot s1")
        s.execute("create snapshot gone")
        s.execute("insert into t values (4, 40)")
        s.execute("drop snapshot gone")
        q = "select id from t as of snapshot 's1' order by id"
        want = pkg.rows(s, q)
        e2 = pkg.Engine.open(fs)
        assert pkg.rows(pkg.session(e2), q) == want
        assert sorted(e2.snapshots) == ["s1"]
        e2.checkpoint()
        e3 = pkg.Engine.open(fs)
        assert pkg.rows(pkg.session(e3), q) == want
        pkg.rows(pkg.session(e3), "select id from t order by id")
    run_both(scenario, tmp_path)


def test_recovery_summary_and_orphans(tmp_path):
    """Engine.open deletes crash-leftover tmp files and reports them,
    with the frames replayed and the checkpoint ts."""
    root = tmp_path / "store"
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.frontend import Session
    s = Session(catalog=Engine(LocalFS(str(root))), device="cpu")
    s.execute("create table t (id bigint)")
    s.execute("insert into t values (1)")
    s.catalog.checkpoint()
    s.execute("insert into t values (2)")
    (root / "objects" / "t" / "seg9.obj.tmp").write_bytes(b"x")
    o0 = TM.recovery_orphans.get()
    eng = Engine.open(LocalFS(str(root)))
    rs = eng.recovery_summary
    assert rs["orphans_gcd"] == 1 and rs["ckpt_ts"] > 0
    assert rs["frames_replayed"] == 2 and rs["torn_bytes"] == 0
    assert TM.recovery_orphans.get() == o0 + 1
    assert LocalFS(str(root)).orphans() == []
