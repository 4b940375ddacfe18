"""SQL scripts of the port's executor tests, as data.

Shared by the CPU tests that hold the port against the JAX package
(tests/test_torch_window.py, test_torch_setops.py,
test_torch_builtins.py) and the on-card test that holds the port's CUDA
session against its CPU session (tests/test_torch_cuda.py), so this
module imports neither JAX nor pandas.  A step is SQL text; a leading
`!` marks a step where the reference raises.  An outcome is
("err", exception class name) or ("ok", column names, rows, affected);
two outcomes are the same when they are equal, except that floats may
differ by the tolerance the caller states.
"""

import math

import numpy as np


def insert_sql(table, rows):
    def fmt(v):
        if v is None:
            return "null"
        return f"'{v}'" if isinstance(v, str) else str(v)
    return f"insert into {table} values " + ", ".join(
        "(" + ", ".join(fmt(v) for v in r) + ")" for r in rows)


def run_step(sess, sql):
    try:
        r = sess.execute(sql)
        return ("ok", r.column_names, r.rows(), r.affected)
    except Exception as e:   # noqa: BLE001 — the class is compared
        return ("err", type(e).__name__)


def _value_close(g, w, rtol, atol) -> bool:
    if isinstance(g, float) and isinstance(w, float) and rtol is not None:
        if math.isnan(g) or math.isnan(w):
            return math.isnan(g) and math.isnan(w)
        return abs(g - w) <= atol + rtol * abs(w)
    return g == w


def same_outcome(got, want, rtol=None, atol=None, ordered=True) -> bool:
    if got[0] != want[0] or got[0] == "err":
        return got == want
    if got[1] != want[1] or got[3] != want[3]:
        return False
    g_rows, w_rows = got[2], want[2]
    if not ordered:
        g_rows, w_rows = sorted(g_rows, key=repr), sorted(w_rows, key=repr)
    if len(g_rows) != len(w_rows):
        return False
    return all(len(gr) == len(wr)
               and all(_value_close(g, w, rtol, atol)
                       for g, w in zip(gr, wr))
               for gr, wr in zip(g_rows, w_rows))


# ------------------------------------------------------------ windows

def _wsess():
    """tests/test_window.py's `wsess` table."""
    rng = np.random.default_rng(13)
    g = rng.choice(list("abcd"), 200)
    v = rng.integers(0, 40, 200)
    p = np.round(rng.uniform(0, 100, 200), 2)
    return ["create table t (g varchar(2), v bigint, p decimal(8,2))",
            insert_sql("t", [(str(g[i]), int(v[i]), float(p[i]))
                             for i in range(200)])]


_WIN = ["create table w (id bigint primary key, g bigint,"
        " v bigint, nm varchar(8))",
        insert_sql("w", [(1, 1, 10, 'a'), (2, 1, 30, 'b'), (3, 1, 20, 'c'),
                         (4, 2, 5, 'd'), (5, 2, 15, 'e'), (6, 3, 7, 'f')])]


def _rows_frame_random():
    rng = np.random.default_rng(11)
    n = 500
    gs = rng.integers(0, 7, n)
    vs = np.round(rng.normal(size=n), 6)
    return [
        "create table r (id bigint primary key, g bigint, v double)",
        insert_sql("r", [(i, int(gs[i]), float(vs[i])) for i in range(n)]),
        "select id, sum(v) over (partition by g order by id"
        "   rows between 3 preceding and 1 following),"
        " min(v) over (partition by g order by id"
        "   rows between 2 preceding and 2 following),"
        " max(v) over (partition by g order by id"
        "   rows between unbounded preceding and current row),"
        " avg(v) over (partition by g order by id"
        "   rows between 4 preceding and current row)"
        " from r order by id"]


def _tombstones():
    """A DELETE leaves tombstones in the first segment, a second INSERT
    and an UPDATE add segments."""
    rng = np.random.default_rng(5)
    first = [(i, int(rng.integers(0, 9)), int(rng.integers(-50, 50)))
             for i in range(300)]
    second = [(i, int(rng.integers(0, 9)), int(rng.integers(-50, 50)))
              for i in range(300, 450)]
    return [
        "create table s (id bigint primary key, g bigint, v bigint)",
        insert_sql("s", first),
        "delete from s where id % 7 = 3 or v < -40",
        insert_sql("s", second),
        "update s set v = v + 1000 where id % 11 = 0",
        """select id, g, v,
        row_number() over (partition by g order by id) rn,
        rank() over (partition by g order by v) rk,
        sum(v) over (partition by g order by id) cs,
        max(v) over (partition by g order by id
            rows between 2 preceding and current row) mx,
        lag(v) over (partition by g order by id) lg
        from s order by id"""]


WINDOW = {
    # tests/test_window.py
    "ranking_functions": _wsess() + ["""select g, v,
        row_number() over (partition by g order by v) rn,
        rank() over (partition by g order by v) rk,
        dense_rank() over (partition by g order by v) dr
        from t order by g, v, rn"""],
    "cumulative_sum_range_peers": _wsess() + ["""select g, v,
        sum(v) over (partition by g order by v) cs
        from t order by g, v"""],
    "partition_totals_and_counts": _wsess() + ["""select g,
        sum(v) over (partition by g) t, count(*) over (partition by g) c
        from t order by g limit 4"""],
    "running_min_max_and_avg": _wsess() + ["""select g, v,
        min(v) over (partition by g order by v) mn,
        max(v) over (partition by g order by v) mx,
        avg(v) over (partition by g order by v) av
        from t order by g, v"""],
    "window_without_partition": _wsess() + [
        "select v, row_number() over (order by v) rn from t"
        " order by v, rn limit 3"],
    "window_error_paths": _wsess() + [
        "!select upper(g) over (partition by g) from t",
        "!select 1 + row_number() over (order by v) from t"],
    "all_null_frame_yields_null": [
        "create table n (g varchar(2), v bigint)",
        "insert into n values ('a', null), ('a', null), ('b', 1)",
        """select g, sum(v) over (partition by g) sv,
        min(v) over (partition by g) mv from n order by g"""],
    "over_group_by": [
        "create table t (g varchar(2), v bigint)",
        "insert into t values ('a',1),('a',2),('b',10),('b',20),('c',3)",
        """select g, sum(v) s, rank() over (order by sum(v) desc) rk
        from t group by g order by rk, g"""],
    "invalid_forms": [
        "create table t (g varchar(2), v bigint)",
        "insert into t values ('a', 1)",
        "!select sum(*) over (partition by g) from t",
        "!select count(distinct v) over (partition by g) from t",
        "!select min(g) over (partition by v) from t"],
    "lag_lead": _WIN + [
        "select id, lag(v) over (partition by g order by id),"
        " lead(v) over (partition by g order by id),"
        " lag(v, 2, -1) over (partition by g order by id)"
        " from w order by id"],
    "lag_over_strings": _WIN + [
        "select id, lag(nm) over (partition by g order by id)"
        " from w order by id"],
    "first_last_nth_value": _WIN + [
        "select id, first_value(v) over (partition by g order by v),"
        " last_value(v) over (partition by g order by v"
        "   rows between unbounded preceding and unbounded following),"
        " nth_value(v, 2) over (partition by g order by v)"
        " from w order by id"],
    "ntile": _WIN + [
        "select id, ntile(2) over (order by id) from w order by id",
        "select id, ntile(4) over (order by id) from w order by id"],
    "rows_frame_sum_avg_count": _WIN + [
        "select id, sum(v) over (partition by g order by id"
        "   rows between 1 preceding and current row),"
        " count(*) over (order by id rows between 1 preceding"
        "   and 1 following),"
        " avg(v) over (order by id rows between 2 preceding"
        "   and 1 preceding)"
        " from w order by id"],
    "rows_frame_min_max": _WIN + [
        "select id, min(v) over (order by id rows between 2 preceding"
        "   and current row),"
        " max(v) over (order by id rows between current row"
        "   and 2 following)"
        " from w order by id"],
    "rows_frame_vs_pandas_random": _rows_frame_random(),
    "frame_rejected_for_rank_funcs": _WIN + [
        "!select rank() over (order by id rows between"
        " 1 preceding and current row) from w"],
    # tests/test_builtins_r5.py:178
    "lag_null_default": [
        "create table w (id bigint primary key, v bigint)",
        "insert into w values (1, 10), (2, 20)",
        "select id, lag(v, 1, NULL) over (order by id) from w order by id"],
    # added
    "decimal_running_sum_and_avg": _wsess() + ["""select g, v, p,
        sum(p) over (partition by g order by v, p) sp,
        avg(p) over (partition by g order by v, p) ap,
        min(p) over (partition by g) mp
        from t order by g, v, p"""],
    "descending_order_and_peers": _wsess() + ["""select g, v,
        rank() over (partition by g order by v desc) rk,
        dense_rank() over (order by v desc) dr,
        count(v) over (partition by g order by v desc) c
        from t order by g, v desc, rk"""],
    "rows_frame_following_only": _WIN + [
        "select id, sum(v) over (partition by g order by id rows between"
        "   1 following and 3 following),"
        " first_value(nm) over (order by id rows between 1 following"
        "   and unbounded following)"
        " from w order by id"],
    "tombstones_and_two_segments": _tombstones(),
}


# ----------------------------------------------------- set operations

def _full_outer_batches():
    """FULL OUTER with duplicate keys on both sides, NULL keys and a
    probe side of several scan batches."""
    rng = np.random.default_rng(3)
    rows_a = [(i, None if i % 17 == 0 else int(rng.integers(0, 300)))
              for i in range(1500)]
    rows_b = [(i, None if i % 13 == 0 else int(rng.integers(150, 450)))
              for i in range(700)]
    return [
        "create table fa (id bigint, k bigint)",
        "create table fb (id bigint, k bigint)",
        insert_sql("fa", rows_a),
        insert_sql("fb", rows_b),
        "set batch_rows = 1024",
        "select sum(case when fa.id is null then 1 else 0 end),"
        " sum(case when fb.id is null then 1 else 0 end), count(*)"
        " from fa full outer join fb on fa.k = fb.k",
        "select fa.id, fb.id from fa full join fb on fa.k = fb.k"
        " where fa.id is null or fb.id is null or fa.id % 97 = 0"
        " order by fa.id, fb.id"]


_SQL_T = ["""create table t (
        id bigint primary key, grp varchar(10), val bigint,
        price decimal(10,2), d date)""",
          """insert into t values
        (1, 'a', 10, 1.50, '2020-01-01'),
        (2, 'a', 20, 2.25, '2020-02-01'),
        (3, 'b', 30, 3.00, '2020-03-01'),
        (4, 'b', null, 4.75, '2020-04-01'),
        (5, null, 50, null, null),
        (6, 'c', 60, 6.00, '2021-01-01')"""]

SETOPS = {
    # tests/test_operator_breadth.py
    "full_outer_join_exact": [
        "create table a (k int primary key, x int)",
        "create table b (k int primary key, y int)",
        "insert into a values (1,10),(2,20),(3,30),(7,70)",
        "insert into b values (2,200),(3,300),(5,500),(9,900)",
        "select a.k ak, a.x, b.k bk, b.y from a "
        "full outer join b on a.k = b.k order by a.k, b.k"],
    "full_join_empty_sides": [
        "create table fa (k int primary key)",
        "create table fb (k int primary key)",
        "insert into fa values (1),(2)",
        "select fa.k ka, fb.k kb from fa full join fb "
        "on fa.k = fb.k order by fa.k",
        "select fa.k ka, fb.k kb from fb full join fa "
        "on fb.k = fa.k order by fa.k"],
    "full_join_residual": [
        "create table ra (k int primary key, v int)",
        "create table rb (k int primary key, w int)",
        "insert into ra values (1,5),(2,50)",
        "insert into rb values (1,1),(2,2)",
        "select ra.k ka, rb.k kb from ra full join rb "
        "on ra.k = rb.k and ra.v > 10 order by ra.k, rb.k"],
    "sample_rows": [
        "create table st (id int primary key, v int)",
        insert_sql("st", [(i, i) for i in range(5000)]),
        "select count(*) c from (select id from st sample 100 rows) q",
        "select count(distinct id) d from (select id from st sample 100"
        " rows) q",
        "select count(*) c from (select id from st sample 10000 rows) q",
        "select id from st sample 50 rows order by id"],
    "sample_percent": [
        "create table sp (id int primary key)",
        insert_sql("sp", [(i,) for i in range(20000)]),
        "select count(*) c from (select id from sp sample 10 percent) q",
        "select sum(id) from sp sample 3 percent"],
    "time_bucket_group": [
        "create table ts (t int, v int)",
        insert_sql("ts", [(i * 7, i) for i in range(100)]),
        "select time_bucket(t, 100) b, sum(v) sv from ts "
        "group by time_bucket(t, 100) order by b"],
    "fill_prev_and_value": [
        "create table g (b int, v int)",
        "insert into g values (0,10),(0,20),(1,null),(2,40)",
        "select b, sum(v) sv from g group by b fill(prev) order by b",
        "select b, sum(v) sv from g group by b fill(value, -1) order by b"],
    "fill_linear": [
        "create table gl (b int, v int)",
        "insert into gl values (0,10),(1,null),(2,30)",
        "select b, sum(v) sv from gl group by b fill(linear) order by b"],
    "full_join_string_predicate_above": [
        "create table sa (k int primary key, name varchar(10))",
        "create table sb (k int primary key, y int)",
        "insert into sa values (1,'x'),(2,'z')",
        "insert into sb values (2,200),(5,500)",
        "select sa.name, sb.y from sa full join sb "
        "on sa.k = sb.k where sa.name = 'x' or sb.y = 500 order by 1, 2"],
    "fill_varchar_key_string_order": [
        "create table m (name varchar(10), v double)",
        "insert into m values ('c',30.0),('a',null),('b',null)",
        "select name, sum(v) sv from m group by name fill(prev) "
        "order by name"],
    "two_samples_independent": [
        "create table ind (id int primary key)",
        insert_sql("ind", [(i,) for i in range(20000)]),
        "select count(*) c from (select id from ind sample 10 percent) a, "
        "(select id from ind sample 10 percent) b where a.id = b.id"],
    "sample_alias_not_confused": [
        "create table tt (id int primary key)",
        "insert into tt values (1)",
        "select sample.id from tt sample"],
    # tests/test_sql.py
    "union": _SQL_T + [
        "create table t3 (id bigint, grp varchar(10))",
        "insert into t3 values (1, 'a'), (99, 'zz')",
        """select id, grp from t where id <= 2
        union all select id, grp from t3 order by id""",
        """select id, grp from t where id <= 2
        union select id, grp from t3 order by id"""],
    "union_in_derived_table": [
        "create table a (v bigint)",
        "insert into a values (3), (1)",
        """select max(v) from
        (select v from a union all select v + 10 from a) u"""],
    "cross_join_count": [
        "create table a (x bigint)",
        "create table b (y bigint)",
        "insert into a values (1), (2), (3)",
        "insert into b values (10), (20)",
        "select count(*) from a, b",
        "select a.x, b.y from a, b where a.x = 1 order by b.y"],
    # added
    "union_of_literals": ["select 1 union select 2",
                          "select 1 union all select 1 union select 2",
                          "select 'x' union all select 'y' order by 1"],
    "union_varchar_different_dictionaries": [
        "create table u1 (k bigint, s varchar(8))",
        "create table u2 (k bigint, s varchar(8))",
        "insert into u1 values (1, 'pear'), (2, 'apple'), (3, null),"
        " (4, 'fig')",
        "insert into u2 values (5, 'kiwi'), (6, 'apple'), (7, 'fig'),"
        " (8, 'plum')",
        "select s, count(*) from (select k, s from u1 union all"
        " select k, s from u2) q group by s order by s",
        "select s from u1 union select s from u2 order by s",
        "select k, s from u2 union all select k, s from u1 order by k",
        "select s, k from (select k, s from u1 union all select k, s"
        " from u2) q where s = 'fig' or s like 'p%' order by k",
        "select s from u1 where k > 1 union all select 'lit' order by 1",
        "!select k from u1 union select k, s from u2"],
    "union_numeric_promotion": [
        "create table n1 (a int, b decimal(6,2))",
        "create table n2 (a bigint, b double)",
        "insert into n1 values (1, 1.25), (2, null)",
        "insert into n2 values (3000000000, 2.5)",
        "select a, b from n1 union all select a, b from n2 order by a"],
    "union_in_cte": _SQL_T + [
        """with u as (select id, val from t where id < 3
        union all select id, val from t where id > 4)
        select count(*), sum(val) from u""",
        """with u as (select grp, price from t where id < 4
        union select grp, price from t where id > 2)
        select grp, sum(price) from u group by grp order by grp"""],
    "non_equi_inner_join": [
        "create table a (x bigint, u varchar(4))",
        "create table b (y bigint, w varchar(4))",
        "insert into a values (1,'p'),(2,'q'),(3,null),(null,'r')",
        "insert into b values (2,'q'),(3,'z'),(5,'p')",
        "select a.x, b.y from a join b on a.x < b.y order by a.x, b.y",
        "select a.x, b.y from a join b on a.x + b.y > 4 and a.x < 3"
        " order by a.x, b.y",
        "select a.x, b.y from a, b where a.x >= b.y order by 1, 2",
        "select a.u, b.y from a join b on a.u = b.w and a.x < b.y"
        " order by 1, 2"],
    "full_outer_over_several_batches": _full_outer_batches(),
    # 5000 rows scanned as 4096 + 904: two batches, padded to 4096 and
    # 1024, each drawing its own keys from the one generator
    "sample_across_two_scan_batches": [
        "create table st (id int primary key, v int)",
        insert_sql("st", [(i, i % 7) for i in range(5000)]),
        "set batch_rows = 4096",
        "select id, v from st sample 300 rows order by id",
        "select id from st sample 5 percent order by id",
        "select v, count(*) from (select v from st sample 40 percent) q"
        " group by v order by v"],
}

#: LEFT JOIN whose ON has no equi-key, held against sqlite3 (the JAX
#: package raises a TypeError there)
LEFT_NON_EQUI_DDL = [
    "create table a (x bigint, u varchar(4))",
    "create table b (y bigint, w varchar(4))",
    "insert into a values (1,'p'),(2,'q'),(3,null),(null,'r'),(7,'s')",
    "insert into b values (2,'q'),(3,'z'),(5,'p'),(null,'n')"]
LEFT_NON_EQUI_QUERIES = [
    "select a.x, b.y from a left join b on a.x > b.y order by a.x, b.y",
    "select a.x, b.y, b.w from a left join b on a.x + 10 < b.y"
    " order by a.x, b.y",
    "select a.u, count(b.y) from a left join b on a.x <= b.y"
    " group by a.u order by a.u"]


# ---------------------------------------------------------- builtins

D_TABLE = ["create table d (id bigint primary key, dte date,"
      " s varchar(32), n bigint)",
      "insert into d values"
      " (1, date '2023-01-31', '1.2.3.4', 3661),"
      " (2, date '2024-02-29', '10.0.0.255', -5),"
      " (3, date '2023-12-31', 'bad', 86400),"
      " (4, date '1969-12-31', '0.0.0.1', -9223372036854775807),"
      " (5, date '1900-02-28', null, null),"
      " (6, null, 'x', 4294967296)"]

B6_TABLE = ["create table b6 (id bigint primary key, s varchar(48),"
       " d date, n bigint)",
       "insert into b6 values"
       " (1, '1.2.3.4',  date '2024-01-15', 5),"
       " (2, '::1',      date '2023-01-01', 3),"
       " (3, 'not-an-ip', date '2020-12-31', 0)"]

BUILTINS = {
    # tests/test_builtins_r5.py, on its table plus rows before 1970,
    # INT64 extremes and NULLs
    "r5_date_add_units": D_TABLE + [
        "select id, date_add(dte, interval 1 month),"
        " date_sub(dte, interval 1 year),"
        " date_add(dte, interval 2 week),"
        " date_sub(dte, interval 3 quarter),"
        " date_sub(dte, interval 40 day)"
        " from d order by id"],
    "r5_date_add_time_units": D_TABLE + [
        "select id, date_add(dte, interval 90 minute),"
        " date_sub(dte, interval 1 second),"
        " date_add(dte, interval 25 hour),"
        " date_add(dte, interval 7 microsecond)"
        " from d order by id"],
    "r5_date_format": D_TABLE + [
        "select date_format(dte, '%Y/%c/%e (%a)') from d order by id",
        "select id, date_format(dte, '%d.%m.%y %H:%i:%s %j %W %M %p %%')"
        " from d order by id",
        "select date_format(date_add(dte, interval 1 hour),"
        " '%T %r %f') from d order by id"],
    "r5_timestamp_fns": D_TABLE + [
        "select timestampdiff(month, date '2023-01-31',"
        " date '2023-03-30')",
        "select timestampdiff(day, date '2023-01-01', date '2022-12-30')",
        "select timestampadd(minute, 61, date '2023-01-01')",
        "select id, timestampdiff(month, dte, date '1970-02-01'),"
        " timestampdiff(year, date '1950-06-15', dte),"
        " timestampdiff(week, dte, date '1969-01-01'),"
        " timestampdiff(quarter, dte, date '2000-01-01'),"
        " timestampdiff(hour, dte, date '1969-12-30'),"
        " timestampadd(month, -1, dte), timestampadd(second, -1, dte)"
        " from d order by id",
        "!select timestampadd(day, n, dte) from d",
        "!select timestampdiff(fortnight, dte, dte) from d"],
    "r5_period_and_makedate": D_TABLE + [
        "select period_add(202311, 3), period_diff(202402, 202311),"
        " makedate(2024, 366)",
        "select period_add(196901, -1), period_diff(196811, 197002),"
        " makedate(1969, 1), makedate(1900, 60), makedate(2023, 0)",
        "select id, period_add(196900 + id, 2),"
        " period_diff(196900 + id, 197001), makedate(1965 + id, 32)"
        " from d order by id"],
    "r5_inet_and_format": D_TABLE + [
        "select inet_aton('192.168.0.1'), inet_ntoa(3232235521)",
        "select format(1234567.891, 2), format(5, 0)",
        "select sec_to_time(3661), time_to_sec('01:01:01')",
        "select id, inet_ntoa(n), sec_to_time(n), format(n, 1)"
        " from d order by id"],
    # bit_count of negatives and of INT64_MIN (n - 1 on row 4)
    "r5_bit_count": D_TABLE + [
        "select bit_count(n) from d order by id",
        "select bit_count(-1), bit_count(-9223372036854775807 - 1),"
        " bit_count(0), bit_count(9223372036854775807), bit_count(-2)",
        "select id, bit_count(-n), bit_count(n - 1) from d order by id"],
    "r5_rand": D_TABLE + [
        "select rand(42), rand(42)",
        "select id, rand(7) from d order by id"],
    "r5_group_by_date_format": D_TABLE + [
        "select date_format(dte, '%Y'), count(*) from d"
        " group by date_format(dte, '%Y') order by 1"],
    "r5_hex_dual_semantics": D_TABLE + [
        "select hex('abc'), hex(255), hex(255.5),"
        " hex(cast(255 as decimal(6,2))), hex(-1), hex(0)",
        "select id, hex(n) from d order by id"],
    # tests/test_builtins_r6.py
    "r6_adddate_interval": B6_TABLE + [
        "select adddate(date '2024-01-31', interval 1 month)",
        "select adddate(d, interval 13 month), subdate(d, interval 1 week)"
        " from b6 order by id"],
    "r6_char_function": B6_TABLE + [
        "select char(77, 121, 83, 81, 76)",
        "select char(65, null, 66)",
        "select char(65.25)", "select char(65.5)",
        "select char(n + 64) from b6 order by id",
        "select char(-1)",
        "select char(n - 10) from b6 where id = 3"],
    "r6_make_set_and_export_set": B6_TABLE + [
        "select make_set(5, 'a', 'b', 'c')",
        "select make_set(3, 'x', null, 'z')",
        "select make_set(n, 'p', 'q', 'r') from b6 order by id",
        "select export_set(5, 'Y', 'N', ',', 4)",
        "select export_set(6, '1', '0', '', 8)",
        "select make_set(1.5, 'a', 'b')",
        "select export_set(5, null, 'N')",
        "select export_set(5, 'Y', 'N', ',', 3.7)",
        "select export_set(n, 'on', 'off', '|', 4) from b6 order by id"],
    "r6_maketime": B6_TABLE + [
        "select maketime(12, 15, 30)",
        "select maketime(12, 61, 30)",
        "select maketime(null, 0, 0)",
        "select maketime(10, 30.0, 0)",
        "select maketime(n, 5.9, 0) from b6 order by id",
        "!select adddate('2020-01-01', 'abc')",
        "!select maketime('a', 0, 0)",
        "select maketime(n, 30, 0) from b6 order by id",
        "select maketime(-n, 30, 0) from b6 order by id"],
    # added
    "time_bucket_before_1970": [
        "create table tb (t bigint, d date, v bigint)",
        "insert into tb values (-250, date '1969-12-01', 1),"
        " (-1, date '1969-12-31', 2), (0, date '1970-01-01', 3),"
        " (99, date '1970-01-02', 4), (100, date '1960-05-05', 5),"
        " (null, null, 6), (-100, date '1900-03-01', 7)",
        "select time_bucket(t, 100) b, sum(v) from tb"
        " group by time_bucket(t, 100) order by b",
        "select time_bucket(d, 7) b, count(*) from tb"
        " group by time_bucket(d, 7) order by b",
        "!select time_bucket(t, 0) from tb"],
    "vector_distances": [
        "create table vx (id bigint primary key, e vecf32(4))",
        "insert into vx values (1, '[1, 2, 3, 4]'),"
        " (2, '[0.5, -1.25, 3, 0]'), (3, '[0, 0, 0, 0.001]'),"
        " (4, '[-7.5, 2.25, 1000, 3]')",
        "select id, l2_distance(e, '[1, 0, 0, 1]'),"
        " l2_distance_sq(e, '[1, 0, 0, 1]'),"
        " cosine_distance(e, '[1, 0, 0, 1]'),"
        " inner_product(e, '[1, 0, 0, 1]'),"
        " cosine_similarity(e, '[1, 0, 0, 1]') from vx order by id",
        "select id from vx order by l2_distance(e, '[0, 0, 3, 0]')"
        " limit 3"],
}



# ------------------------------------------------------------ UDF bodies

#: every body tests/test_udf.py defines outside the offload, worker,
#: replica and tenant cases
UDF_REFERENCE_BODIES = (
    "x * 2.0 + y", "x * x", "x + 1.0", "x + 2.0", "x - y", "x", "x + 0.0",
    "x * 3.0", "x * 5.0", "x + 41.0", "1.0 / x",
    "if x > 2.0:\n    return x * 10.0\nreturn x",
    "float(len(range(int(x))))", "x + undefined_name")

#: the generated bodies' grammar over x (BIGINT), y (DOUBLE), z (FLOAT)
UDF_LEAVES = ["x", "y", "z", "2", "3", "-1", "0.5", "2.0", "-1.25"]
UDF_UNARY = ["-({})", "abs({})", "jnp.abs({})", "jnp.sqrt(jnp.abs({}))",
             "jnp.exp(jnp.clip({}, -5, 5))", "jnp.log1p(jnp.abs({}))",
             "jnp.tanh({})", "jnp.floor({})", "jnp.round({})",
             "jnp.square({})", "jnp.sign({})", "jnp.isnan({}) * 1.0"]
UDF_BINARY = ["({} + {})", "({} - {})", "({} * {})", "({} / {})",
              "({} // {})", "({} % {})", "jnp.minimum({}, {})",
              "jnp.maximum({}, {})", "jnp.where({0} > {1}, {0}, {1})",
              "jnp.power(jnp.abs({}) + 1.0, jnp.clip({}, -2, 2))"]
#: wrappers that decide the tier: the jit tier, or host code on a value
UDF_TIER = ["{}", "if x > 0:\n    return {}\nreturn y",
            "float(x) * 0.0 + {}", "math.exp(y * 0.0) * {}"]
