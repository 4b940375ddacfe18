"""A torch-backed namespace shaped like `jax.numpy`, for UDF bodies.

The JAX package hands a UDF body the real `jax.numpy` (`jnp`); the port
hands it this module, so the bodies the reference stores run unchanged.
Two things have to hold for that:

  * the same dtypes as JAX with 64-bit mode on.  Every operation here
    promotes its operands by JAX's lattice, restricted to the types a
    UDF sees:  bool < i* < int8 < int16 < int32 < int64 < f* < float32 <
    float64, where i* and f* are the WEAK types of Python ints and
    floats (a result is weak when every operand is).  So an int64
    column times 2.0 is float64 (torch would give float32), an int32
    column plus 1 stays int32, `where(c, 1, 0) * int32` is int32.
    Functions that need an inexact type take JAX's: bool, int8, int16
    and int32 become float32, int64 (and i*) float64.  Floor division
    and `%` follow Python's sign rules (for integers by zero: -1 - (x !=
    0) and 0, what JAX gives on the CPU), rounding is half to even, and
    Python's `round(x)` gives int64;
  * a body JAX cannot trace must fail here too.  The jit tier hands the
    body `Array(traced=True)` values, which refuse every host conversion
    as a JAX tracer does: `bool()` (so a Python `if` on a value),
    `float()`, `int()`, `operator.index`, `__array__` (so `np.*` over a
    column and `math.*`), `.item()` and `.tolist()`; a boolean-mask
    index by a traced value is refused too.  A name this module lacks
    raises AttributeError.  Either way the executor marks the body's jit
    tier failed and runs it row by row (udf/executor.py), which is the
    reference's path for a body it cannot trace.

Values that depend on no column (Python scalars in the row tier, host
arrays in the aggregate tier, constants a body builds) are concrete
`Array`s: they convert to host values freely, as concrete JAX arrays do.
Host inputs land on the device `on_device` names (the session's).

Covered names (`NAMES`): the dtypes bool_, int8, int16, int32, int64,
float32, float64; the constants pi, e, inf, nan, newaxis; asarray,
array, zeros, ones, full, zeros_like, ones_like, full_like, arange,
broadcast_to, where, clip, minimum, maximum, fmin, fmax, add, subtract,
multiply, divide, true_divide, floor_divide, mod, remainder, fmod,
power, negative, positive, abs, absolute, sign, square, sqrt, cbrt,
exp, exp2, expm1, log, log1p, log2, log10, sin, cos, tan, arcsin,
arccos, arctan, arctan2, sinh, cosh, tanh, hypot, floor, ceil, trunc,
rint, round, around, isnan, isinf, isfinite, logical_and, logical_or,
logical_not, logical_xor, equal, not_equal, less, less_equal, greater,
greater_equal, sum, prod, mean, max, min, amax, amin, std, var, median,
percentile, quantile, cumsum, sort, searchsorted and count_nonzero.
"""

from __future__ import annotations

import contextlib
import math as _math
import threading
from typing import Optional

import numpy as np
import torch


class TracerError(TypeError):
    """A traced value was asked for a host value (JAX's
    ConcretizationTypeError / TracerArrayConversionError)."""


_CTX = threading.local()


@contextlib.contextmanager
def on_device(device):
    """Host inputs that the body turns into arrays land on `device`."""
    prev = getattr(_CTX, "device", None)
    _CTX.device = torch.device(device)
    try:
        yield
    finally:
        _CTX.device = prev


def _ctx_device() -> torch.device:
    return getattr(_CTX, "device", None) or torch.device("cpu")


# ---------------------------------------------------------------- dtypes

class DType:
    """A dtype of the namespace: compares equal to its name and its
    torch dtype, and casts when called (`jnp.float32(x)`)."""

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch = torch_dtype

    def __call__(self, x):
        return asarray(x, dtype=self)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch == other.torch
        if isinstance(other, torch.dtype):
            return self.torch == other
        if isinstance(other, str):
            return self.name == other
        try:
            return np.dtype(other).name == self.name
        except TypeError:
            return False

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"dtype('{self.name}')"

    __str__ = lambda self: self.name  # noqa: E731


bool_ = DType("bool", torch.bool)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
_DTYPES = {d.torch: d for d in (bool_, int8, int16, int32, int64, float32,
                                float64)}
#: JAX's promotion chain over the UDF types: (torch dtype, weak) by rank
_CHAIN = [(torch.bool, False), (torch.int64, True), (torch.int8, False),
          (torch.int16, False), (torch.int32, False), (torch.int64, False),
          (torch.float64, True), (torch.float32, False),
          (torch.float64, False)]
_RANK = {k: i for i, k in enumerate(_CHAIN)}
_INT_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, DType):
        return d.torch
    if isinstance(d, torch.dtype):
        return d
    if d is bool:
        return torch.bool
    if d is int:
        return torch.int64
    if d is float:
        return torch.float64
    name = np.dtype(d).name
    for t, dd in _DTYPES.items():
        if dd.name == name:
            return t
    raise TypeError(f"unsupported dtype {d!r}")


def _to_inexact(t: torch.dtype, weak: bool):
    """JAX's inexact type for a promoted type: bool and ints up to 32
    bits -> float32, int64 -> float64; a weak int -> weak float."""
    if t.is_floating_point:
        return t, weak
    if weak:
        return torch.float64, True
    return (torch.float64 if t == torch.int64 else torch.float32), False


# ---------------------------------------------------------------- Array

def _refuse(what: str):
    raise TracerError(
        f"{what} of a traced value: the body depends on a column's value "
        f"in host code, which the jit tier cannot trace")


class Array:
    """A tensor with JAX's typing: its weak flag, and `traced` (a value
    that depends on a column in the jit tier, which refuses host
    conversion)."""

    __slots__ = ("_t", "_weak", "_traced")
    #: numpy's binary operators defer to this type (as to JAX arrays)
    __array_priority__ = 100

    def __init__(self, t: torch.Tensor, weak: bool = False,
                 traced: bool = False):
        self._t = t
        self._weak = weak
        self._traced = traced

    # ---- shape and type
    @property
    def dtype(self) -> DType:
        return _DTYPES[self._t.dtype]

    @property
    def shape(self) -> tuple:
        return tuple(self._t.shape)

    @property
    def ndim(self) -> int:
        return self._t.dim()

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def T(self) -> "Array":
        return Array(self._t.T, self._weak, self._traced)

    def __len__(self) -> int:
        if self._t.dim() == 0:
            raise TypeError("len() of unsized object")
        return self._t.shape[0]

    def __repr__(self) -> str:
        return (f"Array({'traced ' if self._traced else ''}"
                f"{self.dtype.name}{list(self.shape)})")

    __hash__ = None

    # ---- host conversion: refused while traced
    def __bool__(self):
        if self._traced:
            _refuse("bool()")
        return bool(self._t)

    def __float__(self):
        if self._traced:
            _refuse("float()")
        return float(self._t)

    def __int__(self):
        if self._traced:
            _refuse("int()")
        return int(self._t)

    def __index__(self):
        if self._traced:
            _refuse("an index")
        if self._t.dtype.is_floating_point or self._t.dtype == torch.bool:
            raise TypeError("only integer arrays convert to an index")
        return int(self._t)

    def __complex__(self):
        if self._traced:
            _refuse("complex()")
        return complex(float(self._t))

    def __array__(self, dtype=None, copy=None):
        if self._traced:
            _refuse("a numpy conversion")
        a = self._t.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def item(self):
        if self._traced:
            _refuse(".item()")
        return self._t.item()

    def tolist(self):
        if self._traced:
            _refuse(".tolist()")
        return self._t.tolist()

    def __round__(self, ndigits=None):
        if self._t.dtype == torch.bool:
            raise ValueError("round does not accept dtype bool")
        if ndigits is None:
            t = torch.round(self._t) if self._t.dtype.is_floating_point \
                else self._t
            return Array(t.to(torch.int64), False, self._traced)
        return round_(self, ndigits)

    # ---- indexing and iteration
    def __getitem__(self, idx):
        if isinstance(idx, Array):
            if idx._traced and idx._t.dtype == torch.bool:
                _refuse("a boolean-mask index")
            idx = idx._t
        return Array(self._t[idx], self._weak, self._traced)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---- operators
    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return subtract(self, o)

    def __rsub__(self, o):
        return subtract(o, self)

    def __mul__(self, o):
        return multiply(self, o)

    def __rmul__(self, o):
        return multiply(o, self)

    def __truediv__(self, o):
        return divide(self, o)

    def __rtruediv__(self, o):
        return divide(o, self)

    def __floordiv__(self, o):
        return floor_divide(self, o)

    def __rfloordiv__(self, o):
        return floor_divide(o, self)

    def __mod__(self, o):
        return remainder(self, o)

    def __rmod__(self, o):
        return remainder(o, self)

    def __pow__(self, o):
        return power(self, o)

    def __rpow__(self, o):
        return power(o, self)

    def __neg__(self):
        return negative(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return abs_(self)

    def __invert__(self):
        return _unary(self, torch.bitwise_not)

    def __and__(self, o):
        return _binary(torch.bitwise_and, self, o)

    def __rand__(self, o):
        return _binary(torch.bitwise_and, o, self)

    def __or__(self, o):
        return _binary(torch.bitwise_or, self, o)

    def __ror__(self, o):
        return _binary(torch.bitwise_or, o, self)

    def __xor__(self, o):
        return _binary(torch.bitwise_xor, self, o)

    def __rxor__(self, o):
        return _binary(torch.bitwise_xor, o, self)

    def __lt__(self, o):
        return less(self, o)

    def __le__(self, o):
        return less_equal(self, o)

    def __gt__(self, o):
        return greater(self, o)

    def __ge__(self, o):
        return greater_equal(self, o)

    def __eq__(self, o):
        return equal(self, o)

    def __ne__(self, o):
        return not_equal(self, o)

    # ---- methods
    def astype(self, dtype) -> "Array":
        return Array(self._t.to(_torch_dtype(dtype)), False, self._traced)

    def sum(self, axis=None, dtype=None, out=None, keepdims=False,
            **_kw):
        return sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, out=None, keepdims=False,
             **_kw):
        return mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=False, **_kw):
        return max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, out=None, keepdims=False, **_kw):
        return min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, dtype=None, out=None, keepdims=False, **_kw):
        return prod(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def std(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **_kw):
        return std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **_kw):
        return var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def clip(self, min=None, max=None):
        return clip(self, min, max)

    def round(self, decimals=0):
        return round_(self, decimals)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Array(self._t.reshape(shape), self._weak, self._traced)

    def cumsum(self, axis=None, dtype=None, out=None):
        return cumsum(self, axis=axis, dtype=dtype)

    def argsort(self, axis=-1):
        return Array(torch.argsort(self._t, dim=axis, stable=True),
                     False, self._traced)


# ------------------------------------------------------------ promotion

def _node(x):
    """(torch dtype, weak, tensor or None, traced) of one operand."""
    if isinstance(x, Array):
        return x._t.dtype, x._weak, x._t, x._traced
    # numpy scalars first: np.float64 is a Python float, but strong
    if isinstance(x, (np.ndarray, np.generic)):
        return _torch_dtype(x.dtype), False, None, False
    if isinstance(x, bool):
        return torch.bool, False, None, False
    if isinstance(x, int):
        return torch.int64, True, None, False
    if isinstance(x, float):
        return torch.float64, True, None, False
    if isinstance(x, (list, tuple)):
        return _node(asarray(x))
    raise TypeError(f"unsupported operand type {type(x).__name__}")


def _join(nodes):
    best = 0
    for d, weak, _t, _tr in nodes:
        key = (d, weak and d in (torch.int64, torch.float64))
        if key not in _RANK:
            raise TypeError(f"unsupported dtype {d}")
        best = builtins_max(best, _RANK[key])
    return _CHAIN[best]


def _device_of(nodes) -> torch.device:
    for _d, _w, t, _tr in nodes:
        if t is not None:
            return t.device
    return _ctx_device()


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(x, Array):
        return x._t.to(device=device, dtype=dtype)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)
    if isinstance(x, (list, tuple)):
        return asarray(x)._t.to(device=device, dtype=dtype)
    # a fill, not a host copy: no sync on the card
    return torch.full((), x, dtype=dtype, device=device)


def _promote(*xs, inexact: bool = False):
    """Operands -> (tensors of the promoted type, weak, traced)."""
    nodes = [_node(x) for x in xs]
    dtype, weak = _join(nodes)
    if inexact:
        dtype, weak = _to_inexact(dtype, weak)
    dev = _device_of(nodes)
    traced = any(n[3] for n in nodes)
    return [_as_tensor(x, dtype, dev) for x in xs], weak, traced


def _binary(op, a, b, inexact: bool = False):
    (x, y), weak, traced = _promote(a, b, inexact=inexact)
    return Array(op(x, y), weak, traced)


def _compare(op, a, b):
    (x, y), _w, traced = _promote(a, b)
    return Array(op(x, y), False, traced)


def _unary(a, op, inexact: bool = False):
    (x,), weak, traced = _promote(a, inexact=inexact)
    return Array(op(x), weak, traced)


builtins_max = max


# ------------------------------------------------------------ creation

def asarray(x, dtype=None) -> Array:
    if isinstance(x, Array):
        return x if dtype is None else x.astype(dtype)
    if isinstance(x, (list, tuple)) and any(isinstance(v, Array)
                                            for v in x):
        parts = [asarray(v) for v in x]
        (ts), weak, traced = _promote(*parts)
        out = Array(torch.stack(ts), weak, traced)
        return out if dtype is None else out.astype(dtype)
    dev = _ctx_device()
    if isinstance(x, (np.ndarray, np.generic)) or isinstance(x,
                                                             (list, tuple)):
        a = np.asarray(x)
        if a.dtype == np.float64 or a.dtype.kind in "biuf":
            t = torch.as_tensor(a, device=dev)
        else:
            raise TypeError(f"unsupported array dtype {a.dtype}")
        weak = False
    else:
        d, weak, _t, _tr = _node(x)
        t = torch.full((), x, dtype=d, device=dev)
    out = Array(t, weak)
    return out if dtype is None else out.astype(dtype)


array = asarray


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None) -> Array:
    return Array(torch.zeros(_shape(shape), device=_ctx_device(),
                             dtype=_torch_dtype(dtype or float64)))


def ones(shape, dtype=None) -> Array:
    return Array(torch.ones(_shape(shape), device=_ctx_device(),
                            dtype=_torch_dtype(dtype or float64)))


def full(shape, fill_value, dtype=None) -> Array:
    v = asarray(fill_value, dtype)
    return Array(v._t.expand(_shape(shape)).clone(), v._weak and dtype is None)


def zeros_like(x, dtype=None) -> Array:
    x = asarray(x)
    return Array(torch.zeros_like(x._t, dtype=_torch_dtype(dtype)
                                  if dtype is not None else None),
                 x._weak and dtype is None, x._traced)


def ones_like(x, dtype=None) -> Array:
    x = asarray(x)
    return Array(torch.ones_like(x._t, dtype=_torch_dtype(dtype)
                                 if dtype is not None else None),
                 x._weak and dtype is None, x._traced)


def full_like(x, fill_value, dtype=None) -> Array:
    x = asarray(x)
    d = _torch_dtype(dtype) if dtype is not None else x._t.dtype
    return Array(torch.full_like(x._t, fill_value, dtype=d),
                 x._weak and dtype is None, x._traced)


def arange(start, stop=None, step=1, dtype=None) -> Array:
    if stop is None:
        start, stop = 0, start
    vals = [start, stop, step]
    d = (_torch_dtype(dtype) if dtype is not None else
         torch.float64 if any(isinstance(v, float) for v in vals)
         else torch.int64)
    return Array(torch.arange(start, stop, step, dtype=d,
                              device=_ctx_device()))


def broadcast_to(x, shape) -> Array:
    x = asarray(x)
    return Array(x._t.expand(_shape(shape)), x._weak, x._traced)


# ------------------------------------------------------------ elementwise

def add(a, b):
    return _binary(torch.add, a, b)


def subtract(a, b):
    return _binary(torch.sub, a, b)


def multiply(a, b):
    return _binary(torch.mul, a, b)


def divide(a, b):
    return _binary(torch.div, a, b, inexact=True)


true_divide = divide


def _int_div_zero(x, y, q, zero_value):
    """JAX's integer result where the divisor is 0 (its values on the
    CPU), computed without dividing by 0 (which raises in torch)."""
    z = y == 0
    return torch.where(z, zero_value, q)


def floor_divide(a, b):
    (x, y), weak, traced = _promote(a, b)
    if x.dtype in _INT_TYPES or x.dtype == torch.bool:
        if x.dtype == torch.bool:
            x, y = x.to(torch.int32), y.to(torch.int32)
        safe = torch.where(y == 0, torch.ones_like(y), y)
        q = torch.floor_divide(x, safe)
        out = _int_div_zero(x, y, q, -1 - (x != 0).to(x.dtype))
        return Array(out, weak, traced)
    # JAX's float divmod: round((x - fmod(x, y)) / y), adjusted by sign
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    ind = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    div = torch.where(ind, div - 1, div)
    return Array(torch.round(div), weak, traced)


def remainder(a, b):
    (x, y), weak, traced = _promote(a, b)
    if x.dtype in _INT_TYPES or x.dtype == torch.bool:
        if x.dtype == torch.bool:
            x, y = x.to(torch.int32), y.to(torch.int32)
        safe = torch.where(y == 0, torch.ones_like(y), y)
        r = torch.remainder(x, safe)
        return Array(_int_div_zero(x, y, r, torch.zeros_like(x)), weak,
                     traced)
    trunc = torch.fmod(x, y)
    plus = ((trunc < 0) != (y < 0)) & (trunc != 0)
    return Array(torch.where(plus, trunc + y, trunc), weak, traced)


mod = remainder


def fmod(a, b):
    (x, y), weak, traced = _promote(a, b)
    if x.dtype in _INT_TYPES:
        safe = torch.where(y == 0, torch.ones_like(y), y)
        return Array(_int_div_zero(x, y, torch.fmod(x, safe),
                                   torch.zeros_like(x)), weak, traced)
    return Array(torch.fmod(x, y), weak, traced)


def power(a, b):
    if isinstance(b, int) and not isinstance(b, bool):
        # JAX's integer_pow: the base's type (a bool base counts as int32)
        base = asarray(a)
        if base._t.dtype == torch.bool:
            x, weak, traced = base._t.to(torch.int32), False, base._traced
        else:
            (x, _y), weak, traced = _promote(a, b)
        if not x.dtype.is_floating_point and b < 0:
            raise TypeError("Integers cannot be raised to negative powers")
        return Array(torch.pow(x, b), weak, traced)
    return _binary(torch.pow, a, b)


def negative(a):
    a = asarray(a) if not isinstance(a, Array) else a
    if a._t.dtype == torch.bool:
        raise TypeError("negative does not accept dtype bool")
    return Array(torch.neg(a._t), a._weak, a._traced)


def positive(a):
    return asarray(a)


def abs_(a):
    a = asarray(a)
    if a._t.dtype == torch.bool:
        return a
    return Array(torch.abs(a._t), a._weak, a._traced)


absolute = abs_


def sign(a):
    return _unary(a, torch.sign)


def square(a):
    return _unary(a, torch.square)


def _inexact_fn(op):
    def fn(a):
        return _unary(a, op, inexact=True)
    fn.__name__ = op.__name__
    return fn


sqrt = _inexact_fn(torch.sqrt)
exp = _inexact_fn(torch.exp)
exp2 = _inexact_fn(torch.exp2)
expm1 = _inexact_fn(torch.expm1)
log = _inexact_fn(torch.log)
log1p = _inexact_fn(torch.log1p)
log2 = _inexact_fn(torch.log2)
log10 = _inexact_fn(torch.log10)
sin = _inexact_fn(torch.sin)
cos = _inexact_fn(torch.cos)
tan = _inexact_fn(torch.tan)
arcsin = _inexact_fn(torch.asin)
arccos = _inexact_fn(torch.acos)
arctan = _inexact_fn(torch.atan)
sinh = _inexact_fn(torch.sinh)
cosh = _inexact_fn(torch.cosh)
tanh = _inexact_fn(torch.tanh)


def cbrt(a):
    return _unary(a, lambda t: torch.sign(t) * torch.abs(t) ** (1.0 / 3.0),
                  inexact=True)


def arctan2(a, b):
    return _binary(torch.atan2, a, b, inexact=True)


def hypot(a, b):
    return _binary(torch.hypot, a, b, inexact=True)


def _float_only(op):
    """floor/ceil/trunc/rint: the identity on integers and bools."""
    def fn(a):
        a = asarray(a)
        if not a._t.dtype.is_floating_point:
            return a
        return Array(op(a._t), a._weak, a._traced)
    fn.__name__ = op.__name__
    return fn


floor = _float_only(torch.floor)
ceil = _float_only(torch.ceil)
trunc = _float_only(torch.trunc)
rint = _float_only(torch.round)


def round_(a, decimals=0):
    a = asarray(a)
    if a._t.dtype == torch.bool:
        raise ValueError("round does not accept dtype bool")
    if not a._t.dtype.is_floating_point:
        return a
    return Array(torch.round(a._t, decimals=int(decimals)), a._weak,
                 a._traced)


around = round_


def isnan(a):
    a = asarray(a)
    return Array(torch.isnan(a._t), False, a._traced)


def isinf(a):
    a = asarray(a)
    return Array(torch.isinf(a._t), False, a._traced)


def isfinite(a):
    a = asarray(a)
    return Array(torch.isfinite(a._t), False, a._traced)


def where(cond, a=None, b=None):
    if a is None or b is None:
        raise TypeError("where needs three arguments in a UDF body")
    c = asarray(cond)
    (x, y), weak, traced = _promote(a, b)
    ct = c._t.to(device=x.device, dtype=torch.bool)
    return Array(torch.where(ct, x, y), weak, traced or c._traced)


def clip(a, a_min=None, a_max=None):
    args = [x for x in (a, a_min, a_max) if x is not None]
    ts, weak, traced = _promote(*args)
    x = ts[0]
    i = 1
    if a_min is not None:
        x = torch.maximum(x, ts[i])
        # NaN bounds and NaN values propagate as JAX's clip does
        i += 1
    if a_max is not None:
        x = torch.minimum(x, ts[i])
    return Array(x, weak, traced)


def minimum(a, b):
    return _binary(torch.minimum, a, b)


def maximum(a, b):
    return _binary(torch.maximum, a, b)


def fmin(a, b):
    return _binary(torch.fmin, a, b)


def fmax(a, b):
    return _binary(torch.fmax, a, b)


def _logical(op):
    def fn(a, b):
        (x, y), _w, traced = _promote(a, b)
        return Array(op(x.to(torch.bool), y.to(torch.bool)), False, traced)
    return fn


logical_and = _logical(torch.logical_and)
logical_or = _logical(torch.logical_or)
logical_xor = _logical(torch.logical_xor)


def logical_not(a):
    a = asarray(a)
    return Array(torch.logical_not(a._t), False, a._traced)


def equal(a, b):
    return _compare(torch.eq, a, b)


def not_equal(a, b):
    return _compare(torch.ne, a, b)


def less(a, b):
    return _compare(torch.lt, a, b)


def less_equal(a, b):
    return _compare(torch.le, a, b)


def greater(a, b):
    return _compare(torch.gt, a, b)


def greater_equal(a, b):
    return _compare(torch.ge, a, b)


# ------------------------------------------------------------ reductions

def _dims(axis, ndim):
    if axis is None:
        return None
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(int(a) % builtins_max(ndim, 1) for a in axes)


def _reduce(a, fn, axis, keepdims, dtype):
    dims = _dims(axis, a._t.dim())
    t = a._t.to(dtype) if dtype is not None else a._t
    out = fn(t) if dims is None else fn(t, dim=dims, keepdim=keepdims)
    if dims is None and keepdims:
        out = out.reshape((1,) * a._t.dim())
    return Array(out, False, a._traced)


def sum(a, axis=None, dtype=None, keepdims=False, **_kw):
    a = asarray(a)
    d = (_torch_dtype(dtype) if dtype is not None else
         torch.int64 if not a._t.dtype.is_floating_point else a._t.dtype)
    return _reduce(a, torch.sum, axis, keepdims, d)


def prod(a, axis=None, dtype=None, keepdims=False, **_kw):
    a = asarray(a)
    d = (_torch_dtype(dtype) if dtype is not None else
         torch.int64 if not a._t.dtype.is_floating_point else a._t.dtype)
    dims = _dims(axis, a._t.dim())
    t = a._t.to(d)
    if dims is None:
        return Array(torch.prod(t), False, a._traced)
    out = t
    for dim in sorted(dims, reverse=True):
        out = torch.prod(out, dim=dim, keepdim=keepdims)
    return Array(out, False, a._traced)


def mean(a, axis=None, dtype=None, keepdims=False, **_kw):
    a = asarray(a)
    d = (_torch_dtype(dtype) if dtype is not None
         else _to_inexact(a._t.dtype, False)[0])
    return _reduce(a, torch.mean, axis, keepdims, d)


def _extreme(a, axis, keepdims, amax: bool):
    a = asarray(a)
    dims = _dims(axis, a._t.dim())
    t = a._t
    if dims is None:
        out = torch.amax(t) if amax else torch.amin(t)
        if keepdims:
            out = out.reshape((1,) * t.dim())
    else:
        out = (torch.amax if amax else torch.amin)(t, dim=dims,
                                                   keepdim=keepdims)
    return Array(out, False, a._traced)


def max(a, axis=None, keepdims=False, **_kw):
    return _extreme(a, axis, keepdims, True)


def min(a, axis=None, keepdims=False, **_kw):
    return _extreme(a, axis, keepdims, False)


amax, amin = max, min


def var(a, axis=None, ddof=0, keepdims=False, **_kw):
    a = asarray(a)
    d = _to_inexact(a._t.dtype, False)[0]
    t = a._t.to(d)
    dims = _dims(axis, t.dim())
    out = torch.var(t, dim=dims, correction=ddof, keepdim=keepdims)
    return Array(out, False, a._traced)


def std(a, axis=None, ddof=0, keepdims=False, **_kw):
    v = var(a, axis=axis, ddof=ddof, keepdims=keepdims)
    return Array(torch.sqrt(v._t), False, v._traced)


def quantile(a, q, axis=None, keepdims=False, **_kw):
    a = asarray(a)
    d = _to_inexact(a._t.dtype, False)[0]
    t = a._t.to(d)
    qt = torch.as_tensor(np.asarray(q, np.float64), dtype=d,
                         device=t.device)
    if axis is None:
        t = t.reshape(-1)
        out = torch.quantile(t, qt, interpolation="linear")
    else:
        out = torch.quantile(t, qt, dim=int(axis), keepdim=keepdims,
                             interpolation="linear")
    return Array(out, False, a._traced)


def percentile(a, q, axis=None, keepdims=False, **_kw):
    return quantile(a, np.asarray(q, np.float64) / 100.0, axis=axis,
                    keepdims=keepdims)


def median(a, axis=None, keepdims=False, **_kw):
    return quantile(a, 0.5, axis=axis, keepdims=keepdims)


def cumsum(a, axis=None, dtype=None):
    a = asarray(a)
    d = (_torch_dtype(dtype) if dtype is not None else
         torch.int64 if a._t.dtype == torch.bool else a._t.dtype)
    t = a._t.reshape(-1) if axis is None else a._t
    return Array(torch.cumsum(t.to(d), dim=0 if axis is None else axis),
                 False, a._traced)


def sort(a, axis=-1):
    a = asarray(a)
    return Array(torch.sort(a._t, dim=axis, stable=True).values, a._weak,
                 a._traced)


def searchsorted(a, v, side="left"):
    a, v = asarray(a), asarray(v)
    (x, y), _w, traced = _promote(a, v)
    out = torch.searchsorted(x, y, right=(side == "right"))
    return Array(out.to(torch.int32), False, traced)


def count_nonzero(a, axis=None):
    a = asarray(a)
    return Array(torch.count_nonzero(a._t, dim=axis), False, a._traced)


# ------------------------------------------------------------ constants

pi = _math.pi
e = _math.e
inf = float("inf")
nan = float("nan")
newaxis = None
round = round_     # noqa: A001 — the namespace's name, as jnp's
abs = abs_         # noqa: A001

#: every name the namespace offers a UDF body
NAMES = tuple(sorted(
    n for n in dir() if not n.startswith("_") and n not in (
        "annotations", "contextlib", "np", "torch", "threading",
        "Optional", "on_device", "TracerError", "DType", "Array",
        "builtins_max", "round_", "abs_")))


def namespace():
    """What a body sees as `jnp`: the names above and nothing else of
    this module (not torch, not the module's internals)."""
    import sys
    import types
    mod = sys.modules[__name__]
    return types.SimpleNamespace(**{n: getattr(mod, n) for n in NAMES})
