"""UDF execution: the vectorized (jit) tier, the row-loop tier and the
aggregate tier, over one compile cache.

The port of `matrixone_tpu/udf/executor.py`.  The same body has three
tiers:

  jit       — the body is called ONCE per batch over whole-column tensors
              on the session's device, through the torch-backed `jnp`
              (udf/jnp.py).  The label is the reference's: there the body
              is traced into one XLA program.  A UDF call breaks fusion
              in both packages (vm/fusion.py), so the call runs eagerly
              in its operator's pull loop.
  row       — a body the jit tier cannot run (host control flow on a
              value, `float(x)`, `np.*` over a column, a name the
              namespace lacks, a dtype or shape rule it breaks; see
              `_TRACE_FAILURES`) runs per row on host scalars: only the
              rows that are valid and pass the batch's mask, with a
              deadline and KILL check every `_ROW_CHECK` rows; a runtime
              error or an out-of-range return comes back as a UdfError.
  aggregate — an aggregate UDF's body runs once over the compacted host
              (numpy) arrays of its arguments; `jnp.*` over them runs on
              the session's device.

A failure of the card itself (out of memory, a failed launch or copy)
is never taken for a body the jit tier cannot run: it surfaces as it is,
and the body keeps its jit tier for the next call.

The reference's remote tier (`MO_UDF_OFFLOAD=1`: the worker process over
gRPC and Arrow) is not ported and not queued: the machine with the card
has neither transport; asking for it raises NotImplementedError.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.udf import jnp
from matrixone_tpu_torch.udf.sandbox import UdfError, compile_body
from matrixone_tpu_torch.utils import metrics as M

#: sentinel: the jit tier failed for this (body, signature): row tier
_JIT_FAILED = object()

#: rows between deadline and KILL checks in the row-loop tier
_ROW_CHECK = 4096

#: what a body the jit tier cannot run raises: a host conversion of a
#: traced value (`jnp.TracerError`, a TypeError), a name the namespace
#: or the sandbox lacks (AttributeError, NameError), the dtype and shape
#: rules (TypeError, ValueError, LookupError, and torch's RuntimeError
#: where JAX's tracer raises a TypeError), arithmetic on constants
#: (ArithmeticError).  Anything else (a host MemoryError), and any of
#: these that is a fault of the card (`_device_fault`), surfaces.
_TRACE_FAILURES = (TypeError, ValueError, AttributeError, NameError,
                   LookupError, ArithmeticError, RuntimeError)

#: what torch's message says when a launch, a copy or a library call
#: failed on the card (torch releases before AcceleratorError raise
#: these as plain RuntimeErrors)
_CUDA_FAULT_TEXT = ("CUDA error", "CUDA out of memory", "CUBLAS_STATUS",
                    "cuDNN error", "device-side assert")


class DeadlineExceeded(RuntimeError):
    """The statement's deadline ran out during a UDF's evaluation."""


def _jit_enabled() -> bool:
    return os.environ.get("MO_UDF_JIT", "1") != "0"


def _reject_offload() -> None:
    """The remote tier needs the reference's gRPC worker transport."""
    if os.environ.get("MO_UDF_OFFLOAD") != "1":
        return
    addr = os.environ.get("MO_UDF_WORKER", "")
    if not addr:
        from matrixone_tpu_torch.frontend.session import current_session
        s = current_session()
        addr = str((s.variables.get("udf_worker") or "")
                   if s is not None else "")
    if addr:
        raise NotImplementedError(
            "MO_UDF_OFFLOAD: the remote UDF tier needs the worker's gRPC "
            "and Arrow transport, which the port does not have (not "
            "queued, ROADMAP.md)")


class UdfCompileCache:
    """LRU of (body_hash, dtype signature) -> the compiled body and
    whether its jit tier failed.  `mo_ctl('udf', 'status'|'clear')`
    exposes it."""

    def __init__(self, max_entries: Optional[int] = None):
        from matrixone_tpu_torch.utils.lru import LruCache, env_entries
        if max_entries is None:
            max_entries = env_entries("MO_UDF_COMPILE_CACHE", 256)
        self._lru = LruCache(max_entries)

    @property
    def max_entries(self) -> int:
        return self._lru.max_entries

    def entry(self, key: tuple, name: str, body: str,
              arg_names: List[str]) -> dict:
        from matrixone_tpu_torch.utils import keys as keyaudit
        if keyaudit.armed():
            # the key carries the body's HASH; the audit re-checks the
            # body text and argument names behind it on every hit
            keyaudit.audit("udf/executor.py:udf", key,
                           {"body": body, "arg_names": tuple(arg_names)})
        e = self._lru.lookup(key)
        if e is not None:
            M.udf_compile.inc(outcome="hit")
            return e
        M.udf_compile.inc(outcome="miss")
        fn = compile_body(name, body, arg_names)   # UdfError on bad body
        return self._lru.insert(key, {"py": fn, "jit": None, "name": name})

    def mark_jit_failed(self, e: dict) -> None:
        e["jit"] = _JIT_FAILED
        M.udf_compile.inc(outcome="trace_fail")

    def jit_failed(self, e: dict) -> bool:
        return e["jit"] is _JIT_FAILED

    def peek(self, key: tuple) -> Optional[dict]:
        """The resident entry or None (EXPLAIN's tier prediction)."""
        return self._lru.lookup(key)

    def clear(self) -> None:
        self._lru.clear()

    def stats(self) -> dict:
        entries = self._lru.snapshot()
        return {"entries": len(entries),
                "jit_failed": sum(1 for e in entries
                                  if e["jit"] is _JIT_FAILED),
                "max_entries": self.max_entries,
                "hits": int(M.udf_compile.get(outcome="hit")),
                "misses": int(M.udf_compile.get(outcome="miss")),
                "trace_failures": int(
                    M.udf_compile.get(outcome="trace_fail"))}


#: process-global cache (every session shares it)
COMPILE_CACHE = UdfCompileCache()


def _cache_key(e) -> tuple:
    return (e.body_hash,) + tuple((int(t.oid), t.width, t.scale)
                                  for t in e.arg_types) \
        + (int(e.dtype.oid),)


def _device_fault(exc: BaseException, dev: torch.device) -> bool:
    """A failure of the card (out of memory, a failed launch or copy),
    which says nothing of the body: never a reason for the row tier."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return dev.type == "cuda" and isinstance(exc, RuntimeError) \
        and any(t in str(exc) for t in _CUDA_FAULT_TEXT)


def _check_deadline(name: str) -> None:
    """Between rows: the statement's deadline and a KILL of its query."""
    from matrixone_tpu_torch.frontend.session import current_session
    from matrixone_tpu_torch.serving.admission import current_deadline
    dl = current_deadline()
    if dl is not None and dl.remaining() <= 0:
        raise DeadlineExceeded(
            f"udf {name!r}: the statement's deadline ran out")
    s = current_session()
    if s is not None:
        s._procs.check_killed(s.conn_id)


def expected_tier(e) -> str:
    """The tier this call takes on its next execution (EXPLAIN): a known
    jit failure or MO_UDF_JIT=0 demotes it to row."""
    _reject_offload()
    if not (_jit_enabled() and e.vectorized):
        return "row"
    ce = COMPILE_CACHE.peek(_cache_key(e))
    if ce is not None and ce["jit"] is _JIT_FAILED:
        return "row"
    return "jit"


def _ret_dtypes(dtype) -> Tuple[torch.dtype, type]:
    from matrixone_tpu_torch.container.dtypes import TypeOid, \
        torch_dtype_of
    if dtype.oid == TypeOid.BOOL:
        return torch.bool, np.bool_
    return torch_dtype_of(dtype.np_dtype), dtype.np_dtype


def _row_eval(name: str, fn, arg_arrays, valid: np.ndarray, np_ret,
              device) -> Tuple[np.ndarray, np.ndarray]:
    """The body per row, over the rows `valid` marks only."""
    n = len(valid)
    out = np.zeros(n, np_ret)
    out_valid = valid.copy()
    with jnp.on_device(device):
        for j, i in enumerate(np.nonzero(valid)[0]):
            if j % _ROW_CHECK == 0:
                _check_deadline(name)
            try:
                v = fn(*[a[i].item() for a in arg_arrays])
                if v is None:
                    out_valid[i] = False
                else:
                    # the cast stays inside the try: an out-of-range
                    # return is a clean UdfError too
                    out[i] = np_ret(v) if np_ret is np.bool_ else v
            except UdfError:
                raise
            except Exception as ex:     # noqa: BLE001 — user code
                raise UdfError(f"udf {name!r}: {type(ex).__name__}: {ex}")
    return out, out_valid


def _broadcast(data: torch.Tensor, n: int) -> torch.Tensor:
    if data.shape[0] == n:
        return data
    return data[:1].expand((n,) + tuple(data.shape[1:]))


def _column_of(out, n: int, device) -> torch.Tensor:
    """A jit-tier body's result as a tensor of n rows (a scalar result
    broadcasts)."""
    if isinstance(out, jnp.Array):
        t = out._t
    elif isinstance(out, torch.Tensor):
        t = out
    else:
        t = torch.as_tensor(np.asarray(out) if isinstance(
            out, (np.ndarray, np.generic)) else out, device=device)
    if t.dim() == 0:
        t = t.expand(n)
    return t


def _cast_result(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The jit tier's cast of a result to the declared type, as XLA
    casts (the reference's `astype`): a float into an integer type
    saturates, NaN becomes 0 (torch's cast leaves those undefined)."""
    if t.dtype.is_floating_point and not dtype.is_floating_point \
            and dtype != torch.bool:
        info = torch.iinfo(dtype)
        top = float(2 ** (info.bits - 1))
        out = torch.where(torch.isnan(t) | (t >= top) | (t < -top),
                          torch.zeros((), dtype=t.dtype, device=t.device),
                          t).to(dtype)
        out = torch.where(t >= top, torch.full_like(out, info.max), out)
        return torch.where(t < -top, torch.full_like(out, info.min), out)
    return t.to(dtype)


def eval_udf_call(e, ex):
    """vm/exprs entry: a BoundUdfCall over an ExecBatch -> DeviceColumn."""
    from matrixone_tpu_torch.container.device import DeviceColumn
    from matrixone_tpu_torch.vm.exprs import eval_expr
    _check_deadline(e.name)
    _reject_offload()
    n = ex.padded_len
    dev = ex.mask.device
    cols = [eval_expr(a, ex) for a in e.args]
    datas = [_broadcast(c.data, n) for c in cols]
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    for c in cols:
        valid = valid & _broadcast(c.validity, n)
    # rows a WHERE filtered out, and padding, never reach the row tier:
    # the jit tier computes them harmlessly in-vector, but a row-loop body
    # would pay for them and could fail on values the predicate excluded
    eval_valid = valid & ex.mask
    torch_ret, np_ret = _ret_dtypes(e.dtype)
    entry = COMPILE_CACHE.entry(_cache_key(e), e.name, e.body,
                                e.arg_names)
    if e.vectorized and _jit_enabled() \
            and not COMPILE_CACHE.jit_failed(entry):
        try:
            with jnp.on_device(dev):
                out = entry["py"](*[jnp.Array(d, traced=True)
                                    for d in datas])
            out = _column_of(out, n, dev)
            if tuple(out.shape) != (n,):
                raise UdfError(
                    f"udf {e.name!r}: body produced shape "
                    f"{tuple(out.shape)}, expected ({n},)")
            M.udf_calls.inc(tier="jit")
            M.udf_rows.inc(int(n), tier="jit")
            entry["jit"] = True
            return DeviceColumn(_cast_result(out.to(dev), torch_ret),
                                valid, e.dtype)
        except UdfError:
            raise
        except _TRACE_FAILURES as exc:
            if _device_fault(exc, dev):
                raise
            # a body the jit tier cannot run: the documented row-tier
            # path (counted as trace_fail)
            COMPILE_CACHE.mark_jit_failed(entry)
    out, out_valid = _row_eval(e.name, entry["py"],
                               [d.cpu().numpy() for d in datas],
                               eval_valid.cpu().numpy(), np_ret, dev)
    M.udf_calls.inc(tier="row")
    M.udf_rows.inc(int(n), tier="row")
    return DeviceColumn(torch.from_numpy(out).to(dev),
                        torch.from_numpy(out_valid).to(dev), e.dtype)


def eval_udf_aggregate(e, arg_arrays: List[np.ndarray], device=None):
    """An aggregate UDF: ONE body call over the compacted host arrays of
    its arguments -> a Python scalar (None is SQL NULL)."""
    entry = COMPILE_CACHE.entry(_cache_key(e), e.name, e.body,
                                e.arg_names)
    _check_deadline(e.name)
    dev = torch.device(device if device is not None else "cpu")
    try:
        with jnp.on_device(dev):
            v = entry["py"](*arg_arrays)
            if isinstance(v, jnp.Array):
                v = v._t.detach().cpu().numpy()
    except Exception as ex:         # noqa: BLE001 — user code: clean
        if _device_fault(ex, dev):
            raise
        raise UdfError(f"udf {e.name!r}: {type(ex).__name__}: {ex}")
    M.udf_calls.inc(tier="aggregate")
    M.udf_rows.inc(int(len(arg_arrays[0]) if arg_arrays else 0),
                   tier="aggregate")
    if v is None:
        return None
    arr = np.asarray(v)
    if arr.ndim != 0:
        raise UdfError(
            f"udf {e.name!r}: aggregate body must return a scalar, got "
            f"shape {arr.shape}")
    return arr.item()


def stats() -> dict:
    tiers = ("jit", "row", "aggregate")
    return {"compile_cache": COMPILE_CACHE.stats(),
            "calls": {t: int(M.udf_calls.get(tier=t)) for t in tiers},
            "rows": {t: int(M.udf_rows.get(tier=t)) for t in tiers}}
