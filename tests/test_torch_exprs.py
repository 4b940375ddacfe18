"""The port's expression evaluator against the JAX package, on the CPU.

One seeded table goes into a JAX session and, through
`convert.tables_from_numpy`, into the port's; every query below runs on
both (the JAX side on its per-operator path, MO_PLAN_FUSION=0) and the
rows must be equal:

  * LIKE and NOT LIKE with `%`, `_`, regex metacharacters, the empty
    pattern and NULL subjects;
  * `year`/`month`/`day` and every function of `_DATE_FUNCS` over dates
    and datetimes before 1970, on 29 February (and 1900-02-28/03-01,
    not a leap year) and on NULL;
  * every function of `_STRING_FUNCS` (all but `llm_chat`, which needs
    a model endpoint) over a dictionary with NULLs, `substring` with 2
    and 3 arguments, and GROUP BY / ORDER BY / comparisons over a
    string function's re-encoded dictionary;
  * DISTINCT and COUNT(DISTINCT) with NULLs.
"""

import datetime

import numpy as np
import pytest

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage.engine import TableMeta as JMeta
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.vm import exprs as TE

N = 240
EPOCH = datetime.date(1970, 1, 1)
STRS = ["abc", "a.b", "axb", "a+b", "50%", "x_y", "(p)", "", "Hello World",
        "  pad  ", "2024-02-29", "12:34:56", "-01:02:03", "192.168.0.1",
        "::1", "YWJj", "616263", "a,b,c", "zz", "255", "ßtraße"]
JSONS = ['{"a": 1, "b": [1, 2]}', "[1, 2, 3]", '"str"', "not json",
         '{"a": {"c": true}}', "true", "[1, [2, 3]]"]
WKTS = ["POINT(1 2)", "POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))",
        "LINESTRING(0 0, 3 4)", "POINT(2 2)", "bad"]


def _days(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


DATES = [_days(*ymd) for ymd in [
    (1969, 12, 31), (1900, 1, 1), (1900, 2, 28), (1900, 3, 1),
    (1896, 2, 29), (1968, 2, 29), (2000, 2, 29), (2024, 2, 29),
    (2024, 3, 1), (1970, 1, 1), (1601, 1, 1), (1999, 12, 31),
    (2021, 1, 3), (2020, 12, 27), (1, 1, 1)]]


@pytest.fixture(scope="module")
def sessions():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    rng = np.random.default_rng(17)
    js = JSession()
    js.catalog.create_table(JMeta(
        "e", [("id", jdt.INT64), ("s", jdt.varchar(32)),
              ("j", jdt.varchar(64)), ("g", jdt.varchar(64)),
              ("d", jdt.DATE), ("t", jdt.DATETIME), ("b", jdt.BOOL)],
        ["id"]))
    us_day = 86_400_000_000
    d = rng.choice(DATES, N).astype(np.int32)
    arrays = {
        "id": np.arange(N, dtype=np.int64),
        "s": rng.integers(0, len(STRS), N).astype(np.int32),
        "j": rng.integers(0, len(JSONS), N).astype(np.int32),
        "g": rng.integers(0, len(WKTS), N).astype(np.int32),
        "d": d,
        "t": d.astype(np.int64) * us_day + rng.integers(0, us_day, N),
        "b": rng.integers(0, 2, N).astype(bool)}
    validity = {c: rng.random(N) < 0.85 for c in ("s", "j", "g", "d", "t",
                                                  "b")}
    js.catalog.get_table("e").insert_numpy(
        arrays, validity=validity,
        strings={"s": (arrays["s"], list(STRS)),
                 "j": (arrays["j"], list(JSONS)),
                 "g": (arrays["g"], list(WKTS))})
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    yield js, ts
    mp.undo()


def _both(sessions, sql, ordered=True):
    js, ts = sessions
    got = ts.execute(sql).rows()
    want = js.execute(sql).rows()
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert got == want, (sql, got[:5], want[:5])
    return got


# ------------------------------------------------------------------ LIKE

LIKE_PATTERNS = ["a%", "%b", "a_b", "a.b", "%+%", "50%", "x_y", "(%)", "",
                 "%", "_", "%l%o%", "%ß%"]


@pytest.mark.parametrize("pat", LIKE_PATTERNS)
def test_like_and_not_like_equal_reference(sessions, pat):
    _both(sessions, f"select id, s like '{pat}', s not like '{pat}' "
                    f"from e order by id")
    rows = _both(sessions, f"select id from e where s like '{pat}' "
                           f"order by id")
    _both(sessions, f"select id from e where s not like '{pat}' "
                    f"order by id")
    if pat == "a.b":   # the dot is a literal, not a regex wildcard
        assert {r[0] for r in rows}.isdisjoint(
            {r[0] for r in _both(sessions,
                                 "select id from e where s = 'axb'")})


def test_like_of_null_is_null_and_matches_nothing(sessions):
    rows = _both(sessions, "select id, s like '%' from e where s is null "
                           "order by id")
    assert rows and all(r[1] is None for r in rows)


def test_like_regex_is_anchored_and_escaped():
    rx = TE._like_regex("a.b%")
    assert rx.match("a.bxyz") and not rx.match("axb") \
        and not rx.match("za.b")
    assert TE._like_regex("a_c").match("a\nc")       # DOTALL, as MySQL


def test_like_over_a_non_dictionary_argument_raises(sessions):
    _, ts = sessions
    with pytest.raises(TE.EvalError):
        ts.execute("select id from e where id like '1%'")


# ----------------------------------------------------------------- dates

DATE_EXPRS = [
    "year(d)", "month(d)", "day(d)", "year(t)", "month(t)", "day(t)",
    "weekofyear(d)", "weekofyear(t)", "to_seconds(d)", "to_seconds(t)",
    "weekday(d)", "dayofweek(d)", "dayofyear(d)", "dayofyear(t)",
    "quarter(d)", "week(d)", "week(t)", "last_day(d)", "last_day(t)",
    "to_days(d)", "to_days(t)", "from_days(to_days(d))",
    "datediff(d, '2000-03-01')", "datediff(t, d)", "hour(t)", "minute(t)",
    "second(t)", "date(t)", "unix_timestamp(d)", "unix_timestamp(t)",
    "from_unixtime(id * 86399 - 10000000)", "monthname(d)", "dayname(d)",
    "monthname(t)", "dayname(t)", "microsecond(t)", "microsecond(d)",
    "yearweek(d)", "yearweek(t)", "d + interval '30' day",
    "d + interval '400' day", "adddate(d, id * 7)", "subdate(d, -id)"]


@pytest.mark.parametrize("expr", DATE_EXPRS)
def test_date_function_equals_reference(sessions, expr):
    rows = _both(sessions, f"select id, d, {expr} from e order by id")
    assert any(r[2] is None for r in rows) and any(
        r[2] is not None for r in rows) or "id" in expr


def test_civil_calendar_round_trips_and_floors_before_1970():
    """From 0001-01-01 on (the reference's `_days_from_civil` floors the
    era of years <= 0 twice, and the port keeps its arithmetic)."""
    import torch
    days = torch.arange(_days(1, 1, 1), 800_000, 37, dtype=torch.int64)
    y, m, d = TE._civil_from_days(days)
    assert torch.equal(TE._days_from_civil(y, m, d), days)
    for z, ymd in [(-1, (1969, 12, 31)), (_days(2000, 2, 29), (2000, 2, 29)),
                   (_days(1900, 3, 1), (1900, 3, 1)),
                   (_days(1896, 2, 29), (1896, 2, 29))]:
        yy, mm, dd = TE._civil_from_days(torch.tensor([z]))
        assert (int(yy), int(mm), int(dd)) == ymd


def test_monthname_dayname_group_by_their_dictionaries(sessions):
    _both(sessions, "select monthname(d), count(*) from e group by "
                    "monthname(d) order by monthname(d)")
    _both(sessions, "select dayname(d) as n, count(*) from e "
                    "where dayname(d) = 'Sunday' group by n")


# --------------------------------------------------------------- strings

STRING_EXPRS = [
    "upper(s)", "lower(s)", "length(s)", "reverse(s)", "trim(s)",
    "ltrim(s)", "rtrim(s)", "concat(s, '-x')", "concat('<', s, '>')",
    "substring(s, 2)", "substring(s, 2, 3)", "substring(s, -2)",
    "substring(s, 1, 2)", "substr(s, 3)", "replace(s, 'a', 'ZZ')",
    "starts_with(s, 'a')", "ends_with(s, 'b')", "lpad(s, 6, '*')",
    "rpad(s, 6, '*')", "lpad(s, 2, '*')", "repeat(s, 2)", "instr(s, 'b')",
    "locate('b', s)", "locate('b', s, 3)", "ascii(s)", "bit_length(s)",
    "hex(s)", "unhex(s)", "md5(s)", "sha1(s)", "sha2(s, 256)",
    "sha2(s, 512)", "crc32(s)", "to_base64(s)", "from_base64(s)",
    "substring_index(s, '.', 1)", "substring_index(s, ',', -2)",
    "field(s, 'a.b', 'x_y')", "find_in_set(s, 'abc,a,b,zz')",
    "strcmp(s, 'm')", "soundex(s)", "quote(s)", "bin(s)", "oct(s)",
    "conv(s, 10, 16)", "regexp_like(s, 'a.')", "regexp_instr(s, '[bc]')",
    "regexp_substr(s, '[a-z]+')", "regexp_replace(s, '[ab]', '#')",
    "left(s, 2)", "right(s, 2)", "ord(s)", "insert(s, 2, 1, 'QQ')",
    "elt(2, 'one', s)", "concat_ws('-', s, 'x')", "split_part(s, '.', 1)",
    "octet_length(s)", "inet_aton(s)", "str_to_date(s, '%Y-%m-%d')",
    "time_to_sec(s)", "is_ipv4(s)", "is_ipv6(s)", "inet6_aton(s)",
    "inet6_ntoa(s)", "json_quote(s)", "timediff(s, '01:00:00')",
    "addtime(s, '01:00:00')", "subtime(s, '01:00:00')",
    "time_format(s, '%H:%i %p')", "space('3')",
    "json_extract(j, '$.a')", "json_unquote(j)", "json_valid(j)",
    "json_length(j)", "json_type(j)", "json_keys(j)",
    "json_contains(j, '1')", "json_contains(j, '[1, 2]')",
    "st_geomfromtext(g)", "st_astext(g)", "st_x(g)", "st_y(g)",
    "st_area(g)", "st_geohash(g)", "st_distance(g, 'POINT(0 0)')",
    "st_within(g, 'POLYGON((0 0, 3 0, 3 3, 0 3, 0 0))')",
    "st_contains(g, 'POINT(1 1)')",
    "match_against(s, 'hello abc')", "upper('lit')", "length(null)"]


@pytest.mark.parametrize("expr", STRING_EXPRS)
def test_string_function_equals_reference(sessions, expr):
    _both(sessions, f"select id, {expr} from e order by id")


def test_every_string_function_is_covered():
    """The table above names each function of `_STRING_FUNCS` but
    llm_chat (it calls a model endpoint)."""
    from matrixone_tpu.vm.exprs import _STRING_FUNCS as J_FUNCS
    from matrixone_tpu_torch.vm.strfuncs import _STRING_FUNCS
    assert _STRING_FUNCS == J_FUNCS
    names = {"substr": "substring", "insert": "insert_str"}
    seen = {names.get(x.split("(")[0], x.split("(")[0])
            for x in STRING_EXPRS}
    assert _STRING_FUNCS - seen == {"llm_chat"}


@pytest.mark.parametrize("sql", [
    "select upper(s), count(*) from e group by upper(s) order by upper(s)",
    "select substring(s, 1, 1) as c, count(*) from e group by c order by c",
    "select substring(s, 2) as c, count(*), min(id) from e group by c "
    "order by c",
    "select id, substring(s, 1, 2) from e where substring(s, 1, 2) = 'a.' "
    "order by id",
    "select id, upper(s) from e where upper(s) in ('ABC', 'ZZ') "
    "order by id",
    "select id, lower(s) from e where lower(s) like 'hello%' order by id",
    "select id, s from e order by reverse(s), id limit 20",
    "select length(s) as n, count(*) from e group by n order by n"])
def test_string_function_results_group_order_and_compare(sessions, sql):
    _both(sessions, sql)


# -------------------------------------------------------------- DISTINCT

@pytest.mark.parametrize("sql", [
    "select distinct s from e", "select distinct b, s from e",
    "select distinct d from e", "select distinct upper(s) from e",
    "select count(distinct s) from e", "select count(distinct d) from e",
    "select b, count(distinct s) from e group by b order by b",
    "select distinct b from e where s is null"])
def test_distinct_equals_reference(sessions, sql):
    rows = _both(sessions, sql, ordered=False)
    if sql.startswith("select distinct s "):
        assert None in {r[0] for r in rows} and len(rows) == len(
            {r[0] for r in rows})


def test_llm_chat_without_an_endpoint_raises_as_the_reference(
        sessions, monkeypatch):
    """llm_chat reaches the port's copy of the endpoint client; with no
    endpoint configured both packages refuse before any request."""
    from matrixone_tpu.llm import LLMError as JLLMError
    from matrixone_tpu_torch.llm import LLMError
    js, ts = sessions
    monkeypatch.delenv("MO_LLM_ENDPOINT", raising=False)
    sql = "select id, llm_chat(s) from e order by id"
    with pytest.raises(LLMError, match="no LLM endpoint configured"):
        ts.execute(sql)
    with pytest.raises(JLLMError, match="no LLM endpoint configured"):
        js.execute(sql)
