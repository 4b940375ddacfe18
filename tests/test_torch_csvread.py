"""The port's CSV reader (`matrixone_tpu_torch/storage/csvread.py`)
against what the JAX package does with the same file:
`pyarrow.csv.read_csv` at its default options, then
`Vector.from_arrow` into the table's type (the cast LOAD DATA and
external tables make).  The test imports pyarrow; the port does not.

Hypothesis draws small CSV files whose columns hold ints, floats,
bools, ISO dates and timestamps (with and without a zone), strings with
commas and doubled quotes, every null token, empty fields, and mixtures
of these, and casts each column into bigint, int, double, float,
varchar, char, date, datetime, bool and vecf32 columns: values and
validity must be equal, and where the reference raises the port must
raise.  DECIMAL columns
are held to Python's `decimal` instead (the reference drops their
fraction: ROADMAP.md section C, standing decisions).
"""

import datetime
import decimal
import io
import math

import numpy as np
import pyarrow.csv as pacsv
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.container.vector import Vector as JVector
from matrixone_tpu_torch.container import dtypes as tdt
from matrixone_tpu_torch.storage import csvread

#: (reference dtype, port dtype) of each target column type
TARGETS = {
    "bigint": (jdt.INT64, tdt.INT64),
    "int": (jdt.INT32, tdt.INT32),
    "double": (jdt.FLOAT64, tdt.FLOAT64),
    "float": (jdt.FLOAT32, tdt.FLOAT32),
    "varchar": (jdt.varchar(16), tdt.varchar(16)),
    "char": (jdt.DType(jdt.TypeOid.CHAR, width=8),
             tdt.DType(tdt.TypeOid.CHAR, width=8)),
    "date": (jdt.DATE, tdt.DATE),
    "datetime": (jdt.DATETIME, tdt.DATETIME),
    "bool": (jdt.BOOL, tdt.BOOL),
    "vecf32": (jdt.vecf32(2), tdt.vecf32(2)),
}

NULLS = st.sampled_from(csvread.NULL_VALUES)
INTS = st.one_of(
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.integers(0, 999).map(lambda i: f"{i:05d}"),          # leading 0s
    st.integers(-99, 99).map(lambda i: f" {i} "),            # padded
    st.sampled_from(["9223372036854775807", "-9223372036854775808",
                     "99999999999999999999"]))
FLOATS = st.one_of(
    st.floats(allow_nan=False, width=64).map(repr),
    st.floats(-1e6, 1e6, allow_nan=False).map(lambda x: f"{x:.3f}"),
    st.sampled_from(["1e5", ".5", "5.", "-0.0", "inf", "-Infinity",
                     "NAN", "+2.5", "1E-7", "2.5e-05"]))
BOOLS = st.sampled_from(csvread.TRUE_VALUES + csvread.FALSE_VALUES)
DATES = st.dates(datetime.date(1900, 1, 1),
                 datetime.date(2100, 12, 31)).map(str)
STAMPS = st.tuples(
    st.datetimes(datetime.datetime(1900, 1, 1),
                 datetime.datetime(2100, 12, 31)),
    st.sampled_from([" ", "T"])).map(
        lambda t: t[0].isoformat(sep=t[1], timespec="seconds"))
ZONED = st.tuples(STAMPS, st.sampled_from(["Z", "+01:00", "-0530",
                                          "+00:00"])).map("".join)
STRINGS = st.text(alphabet="ab ,\"'xyz-1", min_size=1, max_size=6)
VECTORS = st.lists(st.integers(-9, 9), min_size=2, max_size=2).map(
    lambda v: "[" + ",".join(map(str, v)) + "]")
STYLES = {"int": INTS, "float": FLOATS, "bool": BOOLS, "date": DATES,
          "timestamp": STAMPS, "zoned": ZONED, "string": STRINGS,
          "vector": VECTORS}


@st.composite
def columns(draw):
    """A column's fields: one style, some null tokens, or a mixture."""
    style = draw(st.sampled_from(sorted(STYLES) + ["mixed", "null"]))
    if style == "null":
        cell = NULLS
    elif style == "mixed":
        cell = st.one_of(list(STYLES.values()) + [NULLS])
    else:
        cell = st.one_of(STYLES[style], NULLS) \
            if draw(st.booleans()) else STYLES[style]
    return draw(st.lists(cell, min_size=1, max_size=8))


def _quote(field: str, force: bool) -> str:
    if force or any(ch in field for ch in ',"') or field != field.strip():
        return '"' + field.replace('"', '""') + '"'
    return field


@st.composite
def csv_files(draw):
    ncol = draw(st.integers(1, 4))
    cols = [draw(columns()) for _ in range(ncol)]
    n = min(len(c) for c in cols)
    quote = draw(st.booleans())
    lines = [",".join(f"c{j}" for j in range(ncol))]
    for i in range(n):
        lines.append(",".join(_quote(c[i], quote) for c in cols))
    end = draw(st.sampled_from(["\n", "\r\n"]))
    return end.join(lines) + end, ncol


def _reference(text, name, jtype):
    """("ok", values) | ("err", class) of the reference's read + cast."""
    try:
        tbl = pacsv.read_csv(io.BytesIO(text.encode()))
        col = tbl.column(name)
        if col.num_chunks == 0 or len(col) == 0:
            return ("ok", [])
        return ("ok", JVector.from_arrow(col, jtype).to_pylist())
    except Exception as e:          # noqa: BLE001 (the outcome compared)
        return ("err", type(e).__name__)


def _port(text, name, ttype):
    try:
        tbl = csvread.read_csv(text.encode())
        return ("ok", tbl.columns[name].to_vector(ttype).to_pylist())
    except Exception as e:          # noqa: BLE001 (the outcome compared)
        return ("err", type(e).__name__)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b)


@settings(max_examples=120, deadline=None, database=None,
          derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(csv_files(), st.lists(st.sampled_from(sorted(TARGETS)),
                             min_size=4, max_size=4))
def test_reader_equals_pyarrow_and_from_arrow(file, targets):
    text, ncol = file
    for j in range(ncol):
        jtype, ttype = TARGETS[targets[j]]
        want = _reference(text, f"c{j}", jtype)
        got = _port(text, f"c{j}", ttype)
        if want[0] == "err":
            assert got[0] == "err", (text, j, targets[j], want, got)
        else:
            assert got[0] == "ok", (text, j, targets[j], want, got)
            assert _same(got[1], want[1]), (text, j, targets[j], want, got)


DEC_TEXT = st.decimals(min_value=-10 ** 12, max_value=10 ** 12,
                       places=2, allow_nan=False, allow_infinity=False)


@settings(max_examples=60, deadline=None, database=None,
          derandomize=True)
@given(st.lists(st.one_of(DEC_TEXT.map(str),
                          DEC_TEXT.map(lambda d: f"{d:f}".rstrip("0")),
                          st.integers(-10 ** 9, 10 ** 9).map(str),
                          st.sampled_from(["", "NULL"])),
                min_size=1, max_size=10))
def test_decimal_fields_load_exactly(cells):
    """DECIMAL(15,2) fields are the exact scaled int64 of their text;
    null tokens (in a column not inferred as string) are NULL."""
    text = "k,p\n" + "".join(f"{i},{c}\n" for i, c in enumerate(cells))
    vec = csvread.read_csv(text.encode()).columns["p"].to_vector(
        tdt.decimal64(15, 2))
    for c, v, ok in zip(cells, vec.data.tolist(),
                        vec.valid_mask().tolist()):
        if c in ("", "NULL"):
            assert not ok
            continue
        assert ok and v == int(decimal.Decimal(c) * 100), (c, v)


# ------------------------------------------------- the reference's quirks

def _both(text, col, target):
    jtype, ttype = TARGETS[target]
    want, got = _reference(text, col, jtype), _port(text, col, ttype)
    assert want[0] == got[0] == "ok" and _same(got[1], want[1]), (want, got)
    return got[1]


def test_digits_only_varchar_takes_the_int_form():
    """`007` in a column of digits loads into varchar as '7' (inferred
    int64, then cast to string), and `NULL` there is NULL."""
    assert _both("a\n007\nNULL\n42\n", "a", "varchar") == ["7", None, "42"]


def test_string_column_keeps_text_and_empty_fields():
    """With `abc` in the column it is a string column: `007` stays
    '007', an empty field is '' and `NULL` is the text 'NULL'."""
    assert _both('a\n007\nabc\n""\nNULL\n', "a", "varchar") == \
        ["007", "abc", "", "NULL"]


def test_empty_and_nan_are_null_in_a_double_column():
    assert _both("k,a\n1,1.5\n2,\n3,nan\n4,2\n", "a", "double") == \
        [1.5, None, None, 2.0]


def test_floats_print_as_arrow_casts_them():
    vals = [100000.0, 1e20, 0.1, 1e-7, 1.5, 1e15, 1e9, 1e10, -0.0, 2.5e-5,
            1234567.125, 12345678901.0, 9.5e-07, 5e-324,
            1.7976931348623157e308, float("inf"), float("-inf")]
    text = "a\n" + "".join(f"{v!r}\n" for v in vals)
    import pyarrow as pa
    want = pa.array(vals).cast(pa.string()).to_pylist()
    assert [csvread.format_float(v) for v in vals] == want
    assert _both(text, "a", "varchar") == want


def test_bool_column_with_null_raises_as_the_reference():
    """`fill_null(0)` of a bool Arrow array raises: a bool column with a
    NULL cannot load into a non-text column in either package."""
    text = "k,a\n1,true\n2,\n3,false\n"
    for target in ("bool", "bigint"):
        jtype, ttype = TARGETS[target]
        assert _reference(text, "a", jtype)[0] == "err"
        with pytest.raises(csvread.CsvError):
            csvread.read_csv(text.encode()).columns["a"].to_vector(ttype)
    assert _both(text, "a", "varchar") == ["true", None, "false"]


def test_field_count_mismatch_raises():
    with pytest.raises(csvread.CsvError, match="Expected 2 columns, got 1"):
        csvread.read_csv(b"a,b\n1,2\n3\n")
    with pytest.raises(csvread.CsvError, match="Expected 2 columns, got 3"):
        csvread.read_csv(b'a,b\n"1,2",3,4\n')


def test_large_file_columns_are_exact():
    """A 200,000-row file of int64, float64 and date columns: each
    column's kind and every value exact."""
    n = 200_000
    rng = np.random.default_rng(3)
    i = rng.integers(-10 ** 12, 10 ** 12, n)
    f = rng.normal(size=n)
    d = rng.integers(0, 20000, n)
    text = "i,f,d\n" + "\n".join(
        f"{a},{b!r},{np.datetime64(int(c), 'D')}"
        for a, b, c in zip(i.tolist(), f.tolist(), d.tolist())) + "\n"
    tbl = csvread.read_csv(text.encode())
    cols = {c: tbl.columns[c] for c in "ifd"}
    assert [cols[c].kind for c in "ifd"] == ["int", "float", "date"]
    assert np.array_equal(cols["i"].to_vector(tdt.INT64).data, i)
    assert np.array_equal(cols["f"].to_vector(tdt.FLOAT64).data, f)
    assert np.array_equal(cols["d"].to_vector(tdt.DATE).data, d)
