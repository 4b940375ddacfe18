"""Elementwise scalar kernels with SQL null semantics.

The port of `matrixone_tpu/ops/scalar.py` on torch tensors, function
for function and bit for bit where the reference is exact: validity
propagates as `a.valid & b.valid` (SQL ternary logic), AND/OR use Kleene
logic like MySQL, const (length-1) columns broadcast, and DECIMAL is a
scaled int64 whose scales align before +, - and comparisons and add on
multiply (reference: decimal.go).  Division and every mix of a decimal
with a float run in float64 on real values.
"""

from __future__ import annotations

import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import DeviceColumn
from matrixone_tpu_torch.container.dtypes import DType, TypeOid


def _expand(x: torch.Tensor, n: int) -> torch.Tensor:
    return x if x.shape[0] == n else x.expand((n,) + tuple(x.shape[1:]))


def _broadcast2(a: DeviceColumn, b: DeviceColumn):
    """Broadcast const columns; return (da, db, validity)."""
    n = max(a.data.shape[0], b.data.shape[0])
    return (_expand(a.data, n), _expand(b.data, n),
            _expand(a.validity, n) & _expand(b.validity, n))


def _decimal_rescale(a: DeviceColumn, b: DeviceColumn):
    """Align decimal scales for +,-,comparison (reference: decimal.go)."""
    sa = a.dtype.scale if a.dtype.oid == TypeOid.DECIMAL64 else 0
    sb = b.dtype.scale if b.dtype.oid == TypeOid.DECIMAL64 else 0
    s = max(sa, sb)
    da, db = a.data, b.data
    if sa < s:
        da = da * (10 ** (s - sa))
    if sb < s:
        db = db * (10 ** (s - sb))
    return da, db, s


def _result_type(a: DType, b: DType) -> DType:
    return dt.promote(a, b)


def _arith(a: DeviceColumn, b: DeviceColumn, fn, out_dtype: DType,
           null_mask=None) -> DeviceColumn:
    da, db, valid = _broadcast2(a, b)
    t = out_dtype.torch_dtype
    out = fn(da.to(t), db.to(t))
    if null_mask is not None:
        valid = valid & ~null_mask
    return DeviceColumn(data=out, validity=valid, dtype=out_dtype)


def _descale_for_float(a: DeviceColumn, b: DeviceColumn):
    """When decimal math lands in float (mixed operands), the decimal side
    must enter as its REAL value, not raw scaled ints (cents * 0.2 is off
    by 10^scale)."""
    def conv(c):
        if c.dtype.oid == TypeOid.DECIMAL64:
            return DeviceColumn(c.data.to(torch.float64)
                                / (10.0 ** c.dtype.scale),
                                c.validity, dt.FLOAT64)
        return c
    return conv(a), conv(b)


def add(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    if b.dtype.oid == TypeOid.DATE and a.dtype.is_integer:
        a, b = b, a
    if a.dtype.oid == TypeOid.DATE and b.dtype.is_integer:
        da, db, valid = _broadcast2(a, b)
        return DeviceColumn(da.to(torch.int32) + db.to(torch.int32),
                            valid, dt.DATE)
    out_t = _result_type(a.dtype, b.dtype)
    if out_t.oid == TypeOid.DECIMAL64:
        da, db, s = _decimal_rescale(a, b)
        _, _, valid = _broadcast2(a, b)
        return DeviceColumn(da + db, valid, dt.decimal64(scale=s))
    if out_t.is_float:
        a, b = _descale_for_float(a, b)
    return _arith(a, b, torch.add, out_t)


def sub(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    if a.dtype.oid == TypeOid.DATE and b.dtype.oid == TypeOid.DATE:
        da, db, valid = _broadcast2(a, b)
        return DeviceColumn(da.to(torch.int64) - db.to(torch.int64),
                            valid, dt.INT64)
    if a.dtype.oid == TypeOid.DATE and b.dtype.is_integer:
        da, db, valid = _broadcast2(a, b)
        return DeviceColumn(da.to(torch.int32) - db.to(torch.int32),
                            valid, dt.DATE)
    out_t = _result_type(a.dtype, b.dtype)
    if out_t.oid == TypeOid.DECIMAL64:
        da, db, s = _decimal_rescale(a, b)
        _, _, valid = _broadcast2(a, b)
        return DeviceColumn(da - db, valid, dt.decimal64(scale=s))
    if out_t.is_float:
        a, b = _descale_for_float(a, b)
    return _arith(a, b, torch.sub, out_t)


def mul(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    out_t = _result_type(a.dtype, b.dtype)
    if out_t.oid == TypeOid.DECIMAL64:
        # scales add on multiply (reference: Decimal64Mul)
        sa = a.dtype.scale if a.dtype.oid == TypeOid.DECIMAL64 else 0
        sb = b.dtype.scale if b.dtype.oid == TypeOid.DECIMAL64 else 0
        da, db, valid = _broadcast2(a, b)
        return DeviceColumn(da * db, valid, dt.decimal64(scale=sa + sb))
    if out_t.is_float:
        a, b = _descale_for_float(a, b)
    return _arith(a, b, torch.mul, out_t)


def div(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """SQL '/': true division; NULL on divide-by-zero (MySQL semantics)."""
    da, db, valid = _broadcast2(a, b)
    if a.dtype.oid == TypeOid.DECIMAL64 or b.dtype.oid == TypeOid.DECIMAL64:
        sa = a.dtype.scale if a.dtype.oid == TypeOid.DECIMAL64 else 0
        sb = b.dtype.scale if b.dtype.oid == TypeOid.DECIMAL64 else 0
        # widen to float64 for division; exactness only required for +,-,*
        fa = da.to(torch.float64) / (10.0 ** sa)
        fb = db.to(torch.float64) / (10.0 ** sb)
        zero = fb == 0
        out = fa / torch.where(zero, 1.0, fb)
        return DeviceColumn(out, valid & ~zero, dt.FLOAT64)
    zero = db == 0
    fa = da.to(torch.float64)
    fb = torch.where(zero, torch.ones_like(db), db).to(torch.float64)
    return DeviceColumn(fa / fb, valid & ~zero, dt.FLOAT64)


def mod(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    out_t = _result_type(a.dtype, b.dtype)
    da, db, valid = _broadcast2(a, b)
    zero = db == 0
    safe = torch.where(zero, torch.ones_like(db), db)
    t = out_t.torch_dtype
    if out_t.is_float:
        out = torch.fmod(da.to(t), safe.to(t))
    else:
        # MySQL % keeps the dividend's sign (C truncation)
        q = da.to(t)
        s = safe.to(t)
        out = torch.sign(q) * (torch.abs(q) % torch.abs(s))
    return DeviceColumn(out, valid & ~zero, out_t)


def neg(a: DeviceColumn) -> DeviceColumn:
    return DeviceColumn(-a.data, a.validity, a.dtype)


def _cmp(a: DeviceColumn, b: DeviceColumn, fn) -> DeviceColumn:
    if TypeOid.DECIMAL64 in (a.dtype.oid, b.dtype.oid) \
            and a.dtype.is_numeric and b.dtype.is_numeric \
            and not (a.dtype.is_float or b.dtype.is_float):
        da, db, _ = _decimal_rescale(a, b)
        _, _, valid = _broadcast2(a, b)
        n = max(da.shape[0], db.shape[0])
        return DeviceColumn(fn(_expand(da, n), _expand(db, n)), valid,
                            dt.BOOL)
    da, db, valid = _broadcast2(a, b)
    if TypeOid.DECIMAL64 in (a.dtype.oid, b.dtype.oid) and \
            (a.dtype.is_float or b.dtype.is_float):
        # decimal vs float: descale the decimal to real units (cents
        # compared against a float threshold would be off by 10^scale)
        if a.dtype.oid == TypeOid.DECIMAL64:
            da = da.to(torch.float64) / (10 ** a.dtype.scale)
        if b.dtype.oid == TypeOid.DECIMAL64:
            db = db.to(torch.float64) / (10 ** b.dtype.scale)
        return DeviceColumn(fn(da.to(torch.float64), db.to(torch.float64)),
                            valid, dt.BOOL)
    if a.dtype.is_numeric and b.dtype.is_numeric and a.dtype.oid != b.dtype.oid:
        ct = dt.promote(a.dtype, b.dtype).torch_dtype
        da, db = da.to(ct), db.to(ct)
    return DeviceColumn(fn(da, db), valid, dt.BOOL)


def eq(a, b): return _cmp(a, b, torch.eq)
def ne(a, b): return _cmp(a, b, torch.ne)
def lt(a, b): return _cmp(a, b, torch.lt)
def le(a, b): return _cmp(a, b, torch.le)
def gt(a, b): return _cmp(a, b, torch.gt)
def ge(a, b): return _cmp(a, b, torch.ge)


def between(x: DeviceColumn, lo: DeviceColumn, hi: DeviceColumn) -> DeviceColumn:
    return logical_and(ge(x, lo), le(x, hi))


def isnull(a: DeviceColumn) -> DeviceColumn:
    v = a.validity
    return DeviceColumn(~v, torch.ones_like(v), dt.BOOL)


def isnotnull(a: DeviceColumn) -> DeviceColumn:
    v = a.validity
    return DeviceColumn(v, torch.ones_like(v), dt.BOOL)


def logical_and(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """Kleene AND: FALSE dominates NULL."""
    da, db, _ = _broadcast2(a, b)
    va = _expand(a.validity, da.shape[0])
    vb = _expand(b.validity, db.shape[0])
    false_a = va & ~da
    false_b = vb & ~db
    valid = (va & vb) | false_a | false_b
    # treat NULL operands as TRUE for the value (masked by validity anyway)
    out = (da | ~va) & (db | ~vb)
    return DeviceColumn(out, valid, dt.BOOL)


def logical_or(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """Kleene OR: TRUE dominates NULL."""
    da, db, _ = _broadcast2(a, b)
    va = _expand(a.validity, da.shape[0])
    vb = _expand(b.validity, db.shape[0])
    true_a = va & da
    true_b = vb & db
    out = true_a | true_b
    valid = (va & vb) | true_a | true_b
    return DeviceColumn(out, valid, dt.BOOL)


def logical_not(a: DeviceColumn) -> DeviceColumn:
    return DeviceColumn(~a.data, a.validity, dt.BOOL)


def in_list(a: DeviceColumn, values) -> DeviceColumn:
    """`x IN (v1, v2, ...)` with literal list (small, unrolled)."""
    hit = torch.zeros(a.data.shape, dtype=torch.bool, device=a.data.device)
    for v in values:
        hit = hit | (a.data == v)
    return DeviceColumn(hit, a.validity, dt.BOOL)


def cast(a: DeviceColumn, to: DType) -> DeviceColumn:
    """Numeric/temporal cast (reference: function/func_cast.go)."""
    if a.dtype.oid == to.oid and a.dtype.scale == to.scale:
        return a
    src, d = a.dtype, a.data
    if src.oid == TypeOid.DECIMAL64 and to.is_float:
        out = d.to(to.torch_dtype) / (10.0 ** src.scale)
    elif src.oid == TypeOid.DECIMAL64 and to.oid == TypeOid.DECIMAL64:
        if to.scale >= src.scale:
            out = d * (10 ** (to.scale - src.scale))
        else:
            out = torch.div(d, 10 ** (src.scale - to.scale),
                            rounding_mode="floor")
    elif to.oid == TypeOid.DECIMAL64:
        if src.is_float:
            out = torch.round(d.to(torch.float64)
                              * (10.0 ** to.scale)).to(torch.int64)
        else:
            out = d.to(torch.int64) * (10 ** to.scale)
    else:
        out = d.to(to.torch_dtype)
    return DeviceColumn(out, a.validity, to)


def coalesce(*cols: DeviceColumn) -> DeviceColumn:
    out = cols[0]
    for c in cols[1:]:
        da, db, _ = _broadcast2(out, c)
        va = _expand(out.validity, da.shape[0])
        vb = _expand(c.validity, db.shape[0])
        out = DeviceColumn(torch.where(va, da, db), va | vb, out.dtype)
    return out


def case_when(cond: DeviceColumn, then: DeviceColumn, els: DeviceColumn) -> DeviceColumn:
    dc, dthen, _ = _broadcast2(cond, then)
    _, dels, _ = _broadcast2(cond, els)
    take_then = _expand(cond.validity, dc.shape[0]) & dc
    data = torch.where(take_then, dthen, dels)
    valid = torch.where(take_then,
                        _expand(then.validity, dthen.shape[0]),
                        _expand(els.validity, dels.shape[0]))
    out_t = then.dtype if then.dtype.is_numeric else els.dtype
    return DeviceColumn(data, valid, out_t)


# math builtins (reference: pkg/vectorize/momath)
def _unary_float(a: DeviceColumn, fn, out=dt.FLOAT64) -> DeviceColumn:
    d = a.data
    if a.dtype.oid == TypeOid.DECIMAL64:
        d = d.to(torch.float64) / (10.0 ** a.dtype.scale)
    return DeviceColumn(fn(d.to(out.torch_dtype)), a.validity, out)


def abs_(a):
    if a.dtype.is_numeric and not a.dtype.is_float:
        return DeviceColumn(torch.abs(a.data), a.validity, a.dtype)
    return _unary_float(a, torch.abs)


def floor(a): return _unary_float(a, torch.floor)
def ceil(a): return _unary_float(a, torch.ceil)
def sqrt(a): return _unary_float(a, torch.sqrt)
def exp(a): return _unary_float(a, torch.exp)
def ln(a): return _unary_float(a, torch.log)
def sin(a): return _unary_float(a, torch.sin)
def cos(a): return _unary_float(a, torch.cos)


def power(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    da, db, valid = _broadcast2(a, b)
    out = torch.pow(da.to(torch.float64), db.to(torch.float64))
    return DeviceColumn(out, valid, dt.FLOAT64)


def round_(a: DeviceColumn, digits: int = 0) -> DeviceColumn:
    if a.dtype.oid == TypeOid.DECIMAL64:
        return cast(a, dt.decimal64(scale=digits))
    return _unary_float(a, lambda x: torch.round(x, decimals=digits))


def tan(a): return _unary_float(a, torch.tan)
def asin(a): return _unary_float(a, torch.asin)
def acos(a): return _unary_float(a, torch.acos)
def atan(a): return _unary_float(a, torch.atan)
def cot(a): return _unary_float(a, lambda x: 1.0 / torch.tan(x))
def degrees(a): return _unary_float(a, torch.rad2deg)
def radians(a): return _unary_float(a, torch.deg2rad)
def log2(a): return _unary_float(a, torch.log2)
def log10(a): return _unary_float(a, torch.log10)


def atan2(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    da, db, valid = _broadcast2(a, b)
    out = torch.atan2(da.to(torch.float64), db.to(torch.float64))
    return DeviceColumn(out, valid, dt.FLOAT64)


def sign(a: DeviceColumn) -> DeviceColumn:
    # scale never changes the sign, so decimals need no rescale
    return DeviceColumn(torch.sign(a.data).to(torch.int64), a.validity,
                        dt.INT64)


def truncate(a: DeviceColumn, digits: int = 0) -> DeviceColumn:
    """TRUNCATE(x, d): toward zero (ROUND's half-away sibling)."""
    if a.dtype.oid == TypeOid.DECIMAL64:
        diff = a.dtype.scale - digits
        if diff <= 0:
            return a
        f = 10 ** diff
        d = a.data
        # zero the truncated digits but KEEP the scale (the bound output
        # type is the input type)
        q = torch.sign(d) * torch.div(torch.abs(d), f,
                                      rounding_mode="floor") * f
        return DeviceColumn(q.to(d.dtype), a.validity, a.dtype)
    f = 10.0 ** digits
    return _unary_float(a, lambda x: torch.trunc(x * f) / f)


def _pick2(a: DeviceColumn, b: DeviceColumn, fn) -> DeviceColumn:
    """GREATEST/LEAST pairwise step: NULL if either side is NULL
    (MySQL semantics); decimal scales align, and a decimal mixed with a
    float enters as its REAL value (descale), never as scaled ints."""
    if a.dtype.is_float or b.dtype.is_float:
        a, b = _descale_for_float(a, b)
    elif TypeOid.DECIMAL64 in (a.dtype.oid, b.dtype.oid):
        da_, db_, s_ = _decimal_rescale(a, b)
        a = DeviceColumn(da_, a.validity, dt.decimal64(scale=s_))
        b = DeviceColumn(db_, b.validity, dt.decimal64(scale=s_))
    da, db, valid = _broadcast2(a, b)
    if da.dtype != db.dtype:
        ct = torch.promote_types(da.dtype, db.dtype)
        da, db = da.to(ct), db.to(ct)
    out_t = (a.dtype if a.dtype.oid == b.dtype.oid
             else _result_type(a.dtype, b.dtype))
    return DeviceColumn(fn(da, db), valid, out_t)


def greatest(*cols: DeviceColumn) -> DeviceColumn:
    out = cols[0]
    for c in cols[1:]:
        out = _pick2(out, c, torch.maximum)
    return out


def least(*cols: DeviceColumn) -> DeviceColumn:
    out = cols[0]
    for c in cols[1:]:
        out = _pick2(out, c, torch.minimum)
    return out

