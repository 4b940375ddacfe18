"""The port's CSV reader: host numpy, no pyarrow.

The JAX package reads CSV with `pyarrow.csv.read_csv(src)` at its
default options and casts each record batch into the table's schema
with `Batch.from_arrow` (`matrixone_tpu/container/vector.py:127-165`).
The card machine has no pyarrow, so this module does both:

- **Format**: a header row names the columns; the delimiter is `,` and
  the quote `"` (`""` inside a quoted field); no newlines inside values;
  `\\r\\n` ends a line like `\\n`; empty lines are skipped; a row with
  another field count raises `CsvError`.
- **Inference**, per column over the whole file, in pyarrow's order:
  null, int64, bool, date32, time32[s], timestamp[s] (timestamp[ns] with
  a fraction), the same in UTC where every value carries a zone (`Z`,
  `+hh:mm`), float64, string.  Numbers, dates and times may carry
  spaces or tabs around them; bools and the null tokens match exactly.
  The null tokens (`NULL_VALUES`, pyarrow's default list) hold only in
  a column not inferred as string: strings are never null.
- **The cast** into a table type follows `Vector.from_arrow`: a varlen
  column takes the inferred column's string form (int 7 gives `'7'`,
  floats print as Arrow prints them); a vector column parses
  `'[1,2,...]'` and an empty cell is NULL; every other type is
  `np.asarray(values, dtype)` over the values pyarrow's `to_numpy` would
  give (nulls filled with 0 first: a bool or all-null column with a
  NULL in a chunk raises, as `fill_null(0)` does there).
- **DECIMAL is the exception** (a standing decision, ROADMAP.md section
  C): the field's text is parsed exactly into the scaled int64.  The
  reference casts pyarrow's float64 (or int64) straight to the scaled
  integer, so `12.50` in a DECIMAL(15,2) column loads as 0.12 there.
  Digits past the scale round as an INSERT of the same literal rounds
  them (`round(float(text) * 10**scale)`).

Splitting is one pass over the lines; each column is then inferred with
one regular expression over its joined text and converted with one
numpy conversion of its strings.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.container.vector import Vector

#: pyarrow.csv.ConvertOptions' default null, true and false values
NULL_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
               "-NaN", "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL",
               "NaN", "n/a", "nan", "null")
TRUE_VALUES = ("1", "True", "TRUE", "true")
FALSE_VALUES = ("0", "False", "FALSE", "false")


class CsvError(ValueError):
    """A file the reader cannot split, or a value it cannot cast."""


_WS = r"[ \t]*"
_HMS = r"(?:[01]\d|2[0-3])"
_MS = r"[0-5]\d"
_DATE = r"\d{4}-\d{2}-\d{2}"
#: value patterns of the non-string kinds, tried in pyarrow's order
_PATTERNS = (
    ("int", _WS + r"(?:-?\d+|0[xX][0-9a-fA-F]+)" + _WS),
    ("bool", "(?:" + "|".join(TRUE_VALUES + FALSE_VALUES) + ")"),
    ("date", _WS + _DATE + _WS),
    ("time", _WS + _HMS + ":" + _MS + "(?::" + _MS + ")?" + _WS),
    ("timestamp", _WS + _DATE + "(?:[ T]" + _HMS + "(?::" + _MS
     + r"(?::" + _MS + r"(?:\.\d{1,9})?)?)?)?" + _WS),
    # a zone suffix makes a UTC timestamp (the time's, not a date's)
    ("timestamp_tz", _WS + "(" + _DATE + "[ T]" + _HMS + "(?::" + _MS
     + r"(?::" + _MS + r"(?:\.\d{1,9})?)?)?)(Z|[+-]\d{2}:?\d{2})" + _WS),
    ("float", _WS + r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
     r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])" + _WS),
)
_ONE = {kind: re.compile(p) for kind, p in _PATTERNS}
_NULL_SET = frozenset(NULL_VALUES)
#: values of a column checked against each kind's pattern before any
#: numpy work: one that fails rules the kind out at once
_SAMPLE = 64
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def _codes(vals: np.ndarray):
    """A numpy unicode array as its code points [n, width] and lengths."""
    w = vals.dtype.itemsize // 4
    c = np.ascontiguousarray(vals).view(np.uint32).reshape(len(vals), w)
    return c, np.char.str_len(vals)


def _plain_number(c, L, dots: int):
    """Rows of `c` that are an optional '-', then digits with at most
    `dots` '.' among them and at least one digit.  -> (ok, within,
    digit, dot) masks."""
    pos = np.arange(c.shape[1])
    within = pos < L[:, None]
    dig = (c >= 48) & (c <= 57)
    dot = (c == 46) & within
    lead = (pos == 0) & (c == 45)
    ok = np.where(within, dig | dot | lead, True).all(1) & \
        (dot.sum(1) <= dots) & (dig & within).any(1)
    return ok, within, dig, dot


def _fast_ok(kind: str, c, L) -> np.ndarray:
    """Values that certainly have `kind`'s plainest form (checked on the
    code points, no Python per value); the rest go through the kind's
    regular expression one by one."""
    n, w = c.shape
    if kind in ("int", "float"):
        return _plain_number(c, L, 0 if kind == "int" else 1)[0]
    if kind not in ("date", "timestamp") or w < 10:
        return np.zeros(n, np.bool_)
    dig = (c >= 48) & (c <= 57)
    ok = (c[:, 4] == 45) & (c[:, 7] == 45)
    for p in (0, 1, 2, 3, 5, 6, 8, 9):
        ok &= dig[:, p]
    if kind == "date":
        return ok & (L == 10)
    if w < 19:
        return np.zeros(n, np.bool_)
    ok &= (L == 19) & ((c[:, 10] == 32) | (c[:, 10] == 84)) & \
        (c[:, 13] == 58) & (c[:, 16] == 58)
    for p in (11, 12, 14, 15, 17, 18):
        ok &= dig[:, p]
    v = c.astype(np.int64) - 48
    return ok & (v[:, 11] * 10 + v[:, 12] < 24) & (v[:, 14] < 6) & \
        (v[:, 17] < 6)


class CsvColumn:
    """One column of a file: its raw fields, the kind pyarrow would
    infer for it, and that kind's values (`data`, nulls filled with 0,
    the numpy form pyarrow's `to_numpy` gives) with `valid`."""

    def __init__(self, texts: Sequence[str]):
        self.texts = texts
        self.n = len(texts)
        self.kind = "string"
        self.data: Optional[np.ndarray] = None
        self.valid: Optional[np.ndarray] = None    # None: all valid
        self._infer()

    # ------------------------------------------------------------ inference
    def _infer(self) -> None:
        if self.n == 0:
            self.kind = "null"
            return
        sample = [v for v in self.texts[:_SAMPLE] if v not in _NULL_SET]
        kinds = [k for k, _ in _PATTERNS
                 if all(_ONE[k].fullmatch(v) for v in sample)]
        if sample and not kinds:
            return                       # a string column: no numpy work
        arr = np.array(self.texts, dtype=str)
        null = np.zeros(self.n, np.bool_)
        for tok in NULL_VALUES:
            null |= arr == tok
        if null.all():
            self.kind = "null"
            self.valid = ~null
            return
        vals = arr[~null]
        for kind in kinds:
            out = self._convert(kind, vals)
            if out is not None:
                full = np.zeros(self.n, out.dtype)
                full[~null] = out
                self.kind, self.data = kind, full
                self.valid = None if not null.any() else ~null
                return

    @staticmethod
    def _convert(kind: str, vals: np.ndarray):
        """The kind's values of the non-null fields; None when one does
        not have the kind's form or is out of its range (pyarrow then
        tries the next kind)."""
        if kind == "bool":
            if not np.isin(vals, TRUE_VALUES + FALSE_VALUES).all():
                return None
            return np.isin(vals, TRUE_VALUES)
        c, L = _codes(vals)
        unsure = np.flatnonzero(~_fast_ok(kind, c, L))
        rx = _ONE[kind]
        if not all(rx.fullmatch(v) for v in vals[unsure].tolist()):
            return None
        try:
            if kind == "int":
                hexed = [i for i in unsure.tolist()
                         if "x" in vals[i] or "X" in vals[i]]
                if hexed:
                    vals = vals.copy()
                    big = [int(str(vals[i]).strip(" \t"), 16)
                           for i in hexed]
                    vals[hexed] = "0"
                out = vals.astype(np.int64)
                if hexed:
                    out[hexed] = big
                return out
            if kind == "float":
                return vals.astype(np.float64)
            if len(unsure):
                vals = vals.copy()
                vals[unsure] = np.char.strip(vals[unsure], " \t")
            if kind == "date":
                return vals.astype("datetime64[D]")
            unit = "ns" if (np.char.find(vals, ".") >= 0).any() else "s"
            if kind == "timestamp":
                return vals.astype(f"datetime64[{unit}]")
            if kind == "timestamp_tz":
                # local time minus its offset: UTC, as pyarrow stores it
                parts = [rx.fullmatch(v).groups() for v in vals.tolist()]
                local = np.array([b for b, _z in parts]).astype(
                    f"datetime64[{unit}]")
                off = np.array([0 if z == "Z" else
                                (1 if z[0] == "+" else -1)
                                * (int(z[1:3]) * 60 + int(z[-2:]))
                                for _b, z in parts], np.int64)
                return local - off.astype("timedelta64[m]")
            parts = np.char.split(vals, ":")
            return np.array([int(p[0]) * 3600 + int(p[1]) * 60
                             + (int(p[2]) if len(p) > 2 else 0)
                             for p in parts.tolist()], np.int64)
        except (ValueError, OverflowError):
            return None

    # ------------------------------------------------------------ the cast
    def _chunk_valid(self, start: int, stop: int) -> Optional[np.ndarray]:
        if self.valid is None:
            return None
        v = self.valid[start:stop]
        return None if v.all() else v.copy()

    def strings(self, start: int = 0, stop: Optional[int] = None
                ) -> List[Optional[str]]:
        """The column's string form (an Arrow cast to string)."""
        stop = self.n if stop is None else stop
        if self.kind == "string":
            return list(self.texts[start:stop])
        if self.kind == "null":
            return [None] * (stop - start)
        d = self.data[start:stop]
        if self.kind == "int":
            out = d.astype(str).tolist()
        elif self.kind == "bool":
            out = np.where(d, "true", "false").tolist()
        elif self.kind == "date":
            out = np.datetime_as_string(d, unit="D").tolist()
        elif self.kind in ("timestamp", "timestamp_tz"):
            unit = np.datetime_data(d.dtype)[0]
            out = np.char.replace(np.datetime_as_string(d, unit=unit),
                                  "T", " ")
            if self.kind == "timestamp_tz":
                out = np.char.add(out, "Z")
            out = out.tolist()
        elif self.kind == "time":
            out = [f"{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}"
                   for s in d.tolist()]
        else:
            out = [format_float(x) for x in d.tolist()]
        v = self._chunk_valid(start, stop)
        if v is not None:
            out = [s if ok else None for s, ok in zip(out, v)]
        return out

    def dict_codes(self, encode, start: int = 0,
                   stop: Optional[int] = None):
        """Rows [start, stop) of a varlen cast as dictionary codes: the
        distinct strings, in order of first appearance, go to
        `encode(strings) -> their codes` once each (a table's
        dictionary); -> (codes int32, NULL rows 0; validity)."""
        strs = self.strings(start, stop)
        lut: Dict[str, int] = {}
        local = np.fromiter(
            (-1 if v is None else lut.setdefault(v, len(lut))
             for v in strs), np.int32, len(strs))
        valid = local >= 0
        if not lut:
            return np.zeros(len(strs), np.int32), valid
        remap = np.asarray(encode(list(lut)), np.int32)
        return np.where(valid, remap[local], 0).astype(np.int32), valid

    def to_vector(self, dtype: DType, start: int = 0,
                  stop: Optional[int] = None) -> Vector:
        """Rows [start, stop) cast into `dtype` as `Vector.from_arrow`
        casts a record batch (DECIMAL exactly instead)."""
        stop = self.n if stop is None else stop
        if dtype.is_varlen:
            s = self.strings(start, stop)
            val = self._chunk_valid(start, stop)
            if self.kind == "null":
                val = np.zeros(stop - start, np.bool_) if stop > start \
                    else None
            return Vector(dtype=dtype, strings=s, validity=val)
        if dtype.is_vector:
            return self._to_vector_type(dtype, start, stop)
        if dtype.oid == TypeOid.DECIMAL64:
            return self._to_decimal(dtype, start, stop)
        val = self._chunk_valid(start, stop)
        if self.kind == "null" and stop > start:
            val = np.zeros(stop - start, np.bool_)
        if val is not None and self.kind in ("bool", "null"):
            # fill_null(0) of a bool or null-typed Arrow array raises
            raise CsvError(
                f"cannot fill the NULLs of a {self.kind} CSV column with 0")
        if self.kind == "string":
            src = np.array(self.texts[start:stop], dtype=object)
        elif self.kind == "time":
            import datetime
            src = np.array([datetime.time(s // 3600, s // 60 % 60, s % 60)
                            for s in self.data[start:stop].tolist()],
                           dtype=object)
        elif self.kind == "null":
            src = np.zeros(0, np.float64)
        else:
            src = self.data[start:stop]
        return Vector(dtype=dtype, data=np.asarray(src, dtype=dtype.np_dtype),
                      validity=val)

    def _to_vector_type(self, dtype: DType, start: int, stop: int) -> Vector:
        if self.kind != "string":
            raise CsvError(f"cannot cast a {self.kind} CSV column into "
                           f"{dtype}: vectors load from '[...]' text")
        rows, valid = [], []
        for s in self.texts[start:stop]:
            txt = (s or "").strip()
            parts = [x for x in txt[1:-1].split(",") if x.strip()] \
                if txt.startswith("[") else []
            if parts:
                rows.append([float(x) for x in parts])
                valid.append(True)
            else:
                rows.append([0.0] * dtype.dim)
                valid.append(False)
        data = np.asarray(rows, dtype=dtype.np_dtype)
        if len(rows) == 0:
            data = data.reshape(0, dtype.dim)
        v = np.asarray(valid, np.bool_)
        return Vector(dtype=dtype, data=data, validity=None if v.all() else v)

    def _to_decimal(self, dtype: DType, start: int, stop: int) -> Vector:
        val = self._chunk_valid(start, stop)
        if self.kind == "null" and stop > start:
            val = np.zeros(stop - start, np.bool_)
        texts = np.array(self.texts[start:stop], dtype=str)
        live = np.ones(len(texts), np.bool_) if val is None else val
        data = np.zeros(len(texts), np.int64)
        if live.any():
            data[live] = decimal_scaled(texts[live], dtype.scale)
        return Vector(dtype=dtype, data=data, validity=val)


_DEC_TEXT = re.compile(
    _WS + r"([+-]?)(\d*)(?:\.(\d*))?([eE][+-]?\d+)?" + _WS)


def _decimal_one(text: str, scale: int) -> int:
    """One decimal field -> its scaled int: exact with at most `scale`
    fraction digits and no exponent, else INSERT's rounding."""
    m = _DEC_TEXT.fullmatch(text)
    if m is None or not (m.group(2) or m.group(3)):
        raise CsvError(f"invalid decimal value {text!r}")
    sign, ip, fp, exp = m.groups()
    if exp is None and len(fp or "") <= scale:
        v = int(ip or "0") * 10 ** scale + int((fp or "").ljust(scale, "0")
                                              or "0")
        v = -v if sign == "-" else v
    else:
        f = float(text) * float(10 ** scale)
        if f != f or abs(f) >= 2.0 ** 63:
            raise CsvError(f"decimal value out of range: {text!r}")
        v = round(f)
    if not -2 ** 63 <= v < 2 ** 63:
        raise CsvError(f"decimal value out of range: {text!r}")
    return v


def decimal_scaled(texts: np.ndarray, scale: int) -> np.ndarray:
    """Decimal text -> int64 scaled by 10**scale.  A plain number with
    at most `scale` fraction digits is parsed exactly; one with more
    digits or an exponent rounds as the port's INSERT of the literal
    does: `round(float(t) * 10**scale)`, half to even on the float
    product.  The plain form (an optional '-', digits, one '.') is read
    off the code points, 18 digits at most; every other field goes
    through `_decimal_one`."""
    out = np.zeros(len(texts), np.int64)
    if len(texts) == 0:
        return out
    c, L = _codes(texts)
    ok, within, dig, dot = _plain_number(c, L, 1)
    pos = np.arange(c.shape[1])
    dp = np.where(dot.any(1), dot.argmax(1), L)
    neg = c[:, 0] == 45
    ok &= (L - dp - 1 <= scale) & (dp - neg + scale <= 18)
    if ok.any():
        cc, dg = c[ok], dig[ok] & within[ok]
        d = np.where(dg, cc.astype(np.int64) - 48, 0)
        dpk = dp[ok][:, None]
        e = np.where(pos < dpk, dpk - 1 - pos + scale, scale - (pos - dpk))
        v = (d * _POW10[np.clip(e, 0, 18)]).sum(1)
        out[ok] = np.where(neg[ok], -v, v)
    for i in np.flatnonzero(~ok).tolist():
        out[i] = _decimal_one(str(texts[i]), scale)
    return out


def format_float(x: float) -> str:
    """A float64 as Arrow casts it to string: the shortest round-trip
    digits, positional for decimal exponents -6..9, otherwise
    `d.ddde+XX`."""
    if x != x:
        return "nan"
    if x in (float("inf"), float("-inf")):
        return "inf" if x > 0 else "-inf"
    if x == 0:
        return "-0" if str(x).startswith("-") else "0"
    r = repr(x)
    sign = "-" if r.startswith("-") else ""
    r = r.lstrip("-")
    mant, _, exp = r.partition("e")
    ip, _, fp = mant.partition(".")
    digits = (ip + fp).lstrip("0")
    # the decimal exponent of the first significant digit
    e = (int(exp) if exp else 0) + len(ip) - 1
    if ip == "0":
        e = (int(exp) if exp else 0) - (len(fp) - len(fp.lstrip("0"))) - 1
    digits = digits.rstrip("0") or "0"
    if -7 < e < 10:
        if e >= 0:
            whole = digits[:e + 1].ljust(e + 1, "0")
            rest = digits[e + 1:]
            return sign + whole + ("." + rest if rest else "")
        return sign + "0." + "0" * (-e - 1) + digits
    m = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return f"{sign}{m}e{'+' if e > 0 else '-'}{abs(e)}"


def _split(text: str):
    """-> (header, columns as sequences of raw fields)."""
    if text.startswith("\ufeff"):
        text = text[1:]
    if "\r" in text:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
    lines = text.split("\n")
    if "" in lines:
        lines = [ln for ln in lines if ln]
    if not lines:
        raise CsvError("CSV file is empty: no header row")
    if '"' not in text:
        header = lines[0].split(",")
        body = lines[1:]
        ncol = len(header)
        fields = ",".join(body).split(",") if body else []
        counts = np.fromiter((ln.count(",") for ln in body), np.int64,
                             len(body))
        bad = np.flatnonzero(counts != ncol - 1)
        if len(bad):
            ln = body[int(bad[0])]
            raise CsvError(f"CSV parse error: Expected {ncol} columns, "
                           f"got {ln.count(',') + 1}: {ln}")
        return header, [fields[j::ncol] for j in range(ncol)]
    rows = list(csv.reader(lines, strict=False))
    header, body = rows[0], rows[1:]
    ncol = len(header)
    for i, r in enumerate(body):
        if len(r) != ncol:
            raise CsvError(f"CSV parse error: Expected {ncol} columns, "
                           f"got {len(r)}: {lines[i + 1]}")
    if not body:
        return header, [[] for _ in header]
    return header, [list(c) for c in zip(*body)]


class CsvTable:
    """A whole file split and inferred: `names` in file order, a
    `CsvColumn` each, `n_rows`."""

    def __init__(self, text: str):
        header, cols = _split(text)
        self.names: List[str] = header
        self.columns: Dict[str, CsvColumn] = {}
        for name, texts in zip(header, cols):
            self.columns[name] = CsvColumn(texts)
        self.n_rows = len(cols[0]) if cols else 0


def read_csv(src: Union[str, bytes, os.PathLike]) -> CsvTable:
    """A path, or the file's bytes, read whole."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        blob = bytes(src)
    else:
        with open(src, "rb") as f:
            blob = f.read()
    try:
        text = blob.decode("utf-8")
    except UnicodeDecodeError as e:
        raise CsvError(f"CSV file is not UTF-8: {e}") from None
    return CsvTable(text)
