"""The resilient RPC fabric: pooled per-peer connections, an error
taxonomy, per-call deadlines that follow the call chain, retries with
jittered exponential backoff, per-peer circuit breakers with half-open
probing, and server-side request dedup.

The port's copy of `matrixone_tpu/cluster/rpc.py` (reference analogue:
`pkg/common/morpc`), over the port's frame (`cluster/frame.py`).  Host
only: it moves bytes between processes, never tensors.

Error taxonomy (callers classify by isinstance, never by string):

  * TransportError (ConnectionError): the peer was unreachable or the
    connection died.  Retried, but only for idempotent calls: reads, or
    mutations carrying a request id ("rid") that the server dedups.
  * DeadlineExceeded (TimeoutError): the call's time budget ran out;
    never retried.
  * BreakerOpen (ConnectionError): the peer's circuit is open; raised
    without touching the network, so callers degrade at once.
  * engine errors (ConflictError, ...): the server executed the call and
    said no; never retried.

`MO_RPC_RESILIENCE=off` turns retries, breakers and deadline checks off
(one attempt, errors surface raw): the chaos drills use it to show the
layer is what keeps statements alive under injected faults.

Fault points: `rpc.send` ("drop": the connection dies before the
request leaves; "partial": half a frame is written, then the connection
dies) and `rpc.recv` ("drop": the request reached the peer, the reply
is lost).  Each attempt runs in an `rpc.call` span.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import socket
import struct
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from matrixone_tpu_torch.cluster.frame import recv_msg, send_msg
from matrixone_tpu_torch.storage.engine import (ConflictError,
                                                ConstraintError,
                                                DuplicateKeyError)
from matrixone_tpu_torch.utils import metrics as M, motrace
from matrixone_tpu_torch.utils.fault import INJECTOR


def parse_addr(addr) -> tuple:
    if isinstance(addr, (tuple, list)):
        return addr[0], int(addr[1])
    host, port = addr.rsplit(":", 1)
    return host, int(port)


# --------------------------------------------------------------- config
def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def resilience_enabled() -> bool:
    return os.environ.get("MO_RPC_RESILIENCE", "on").lower() \
        not in ("off", "0", "false")


#: retry / backoff / breaker knobs (the JAX package's names)
RETRIES = _env_int("MO_RPC_RETRIES", 4)              # attempts per call
BACKOFF_BASE = _env_float("MO_RPC_BACKOFF_BASE", 0.02)
BACKOFF_MAX = _env_float("MO_RPC_BACKOFF_MAX", 1.0)
POOL_SIZE = _env_int("MO_RPC_POOL", 2)               # idle sockets a peer
BREAKER_THRESHOLD = _env_int("MO_RPC_BREAKER_THRESHOLD", 5)
BREAKER_COOLDOWN = _env_float("MO_RPC_BREAKER_COOLDOWN", 2.0)


def backoff_delay(attempt: int) -> float:
    """Exponential backoff with jitter: attempt 1 -> about BASE,
    doubling, capped at BACKOFF_MAX."""
    d = min(BACKOFF_MAX, BACKOFF_BASE * (2 ** max(0, attempt - 1)))
    return d * (0.5 + random.random())


# ------------------------------------------------------- error taxonomy
class RpcError(Exception):
    """Marker base of the fabric's own failures."""


class TransportError(RpcError, ConnectionError):
    """The peer was unreachable or the connection died."""


class DeadlineExceeded(RpcError, TimeoutError):
    """The call's time budget ran out (possibly an enclosing
    deadline_scope's)."""


class BreakerOpen(RpcError, ConnectionError):
    """The peer's circuit is open: failing fast instead of dialing."""


ERR_TYPES = {"conflict": ConflictError, "duplicate": DuplicateKeyError,
             "constraint": ConstraintError}


def err_name(e: BaseException) -> str:
    if isinstance(e, ConflictError):
        return "conflict"
    if isinstance(e, DuplicateKeyError):
        return "duplicate"
    if isinstance(e, ConstraintError):
        return "constraint"
    return "error"


# ------------------------------------------------- deadline propagation
class Deadline:
    """Absolute expiry on the monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, seconds: float):
        self.expires_at = time.monotonic() + seconds

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0


_tls = threading.local()


def current_deadline() -> Optional[Deadline]:
    return getattr(_tls, "deadline", None)


@contextmanager
def deadline_scope(seconds: Optional[float] = None, *,
                   ms: Optional[float] = None):
    """Bound every RPC this thread issues in the block.  Nested scopes
    only shrink the budget; servers re-enter the scope from the
    request's `deadline_ms`, so the budget follows the call chain across
    processes."""
    budget = (ms / 1000.0) if ms is not None else \
        (seconds if seconds is not None else 30.0)
    new = Deadline(budget)
    prev = current_deadline()
    if prev is not None:
        new.expires_at = min(new.expires_at, prev.expires_at)
    _tls.deadline = new
    try:
        yield new
    finally:
        _tls.deadline = prev


# ------------------------------------------------------ circuit breaker
class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open -> (cooldown)
    -> half-open: one probe call is admitted; its success closes the
    circuit, its failure re-opens it.  Transitions are exported as
    `mo_rpc_breaker_state` and wake `utils.sync` waiters."""

    _STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}

    def __init__(self, addr: tuple, threshold: Optional[int] = None,
                 cooldown: Optional[float] = None):
        self.addr = addr
        self.peer = f"{addr[0]}:{addr[1]}"
        self.threshold = threshold or BREAKER_THRESHOLD
        self.cooldown = cooldown if cooldown is not None else \
            BREAKER_COOLDOWN
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self._probe_in_flight = False
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if (time.monotonic() - self.opened_at) >= self.cooldown:
                    self._set("half-open")
                    self._probe_in_flight = True
                    return True
                return False
            if not self._probe_in_flight:      # half-open: one probe
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._probe_in_flight = False
            if self.state != "closed":
                self._set("closed")

    def release_probe(self) -> None:
        """An admitted call ended without a verdict (its deadline ran
        out first): free the half-open probe slot."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            self.failures += 1
            if self.state == "half-open" or \
                    (self.state == "closed"
                     and self.failures >= self.threshold):
                self.opened_at = time.monotonic()
                self._set("open")
            elif self.state == "open":
                self.opened_at = time.monotonic()   # stay open, re-arm

    def _set(self, state: str) -> None:
        # called with the lock held
        self.state = state
        M.rpc_breaker_state.set(self._STATE_CODE[state], peer=self.peer)
        M.rpc_breaker_transitions.inc(peer=self.peer, state=state)
        from matrixone_tpu_torch.utils.sync import notify_waiters
        notify_waiters()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown}


_breakers: Dict[tuple, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(addr) -> CircuitBreaker:
    key = parse_addr(addr)
    with _breakers_lock:
        b = _breakers.get(key)
        if b is None:
            b = _breakers[key] = CircuitBreaker(key)
        return b


def breaker_states() -> Dict[str, dict]:
    """Per-peer breaker view (mo_ctl('rpc'))."""
    with _breakers_lock:
        bs = list(_breakers.values())
    return {b.peer: b.snapshot() for b in bs}


def reset_breakers() -> None:
    """Forget every peer's breaker state (tests, drills)."""
    with _breakers_lock:
        _breakers.clear()


# ------------------------------------------------------ request dedup
class _Pending:
    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class RequestDedup:
    """Server-side idempotency: rid -> (resp, blob), LRU-bounded.  A
    retried mutation (same rid, perhaps on a new connection after a
    mid-call disconnect) replays the recorded response instead of
    executing again; a retry that arrives while the first attempt still
    runs waits for its result (`claim`)."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._d: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()

    def claim(self, rid: str, timeout: float = 30.0):
        """-> ("mine", None): the caller executes, then complete(rid).
        -> ("done", (resp, blob)): replay this recorded response."""
        with self._lock:
            ent = self._d.get(rid)
            if ent is None:
                self._d[rid] = _Pending()
                return "mine", None
            if isinstance(ent, tuple):
                self._d.move_to_end(rid)
                return "done", ent
            event = ent.event
        event.wait(timeout)
        with self._lock:
            ent = self._d.get(rid)
            if isinstance(ent, tuple):
                return "done", ent
        return "done", ({"ok": False,
                         "err": f"duplicate request {rid} still "
                                f"in flight after {timeout}s"}, b"")

    def complete(self, rid: str, resp: dict, blob=b"") -> None:
        with self._lock:
            ent = self._d.get(rid)
            self._d[rid] = (resp, blob)
            self._d.move_to_end(rid)
            while len(self._d) > self.cap:
                k = next(iter(self._d))
                if isinstance(self._d[k], _Pending):
                    break            # never evict an in-flight entry
                self._d.popitem(last=False)
        if isinstance(ent, _Pending):
            ent.event.set()          # wake waiting duplicates


_rid_counter = itertools.count(1)
_rid_prefix = f"{os.getpid():x}-{random.getrandbits(32):08x}"


def new_rid() -> str:
    """Process-unique idempotency id of one logical call (made once,
    reused by every retry of that call)."""
    return f"{_rid_prefix}-{next(_rid_counter)}"


# ------------------------------------------------------------ transport
class RpcClient:
    """Pooled request/response channel to one peer (the morpc backend).
    Thread-safe: each call checks a socket out of the peer's pool (up to
    `pool_size` kept warm; a burst opens sockets that close on return).
    `close()` closes every pooled socket, so the peer's handler threads
    end.

    Retries: transport failures are retried with jittered exponential
    backoff, only for idempotent calls (`retryable=True`, or a header
    carrying "rid"), within the call's deadline and the peer's circuit
    breaker."""

    def __init__(self, addr, timeout: float = 30.0,
                 pool_size: Optional[int] = None,
                 retries: Optional[int] = None):
        self.addr = parse_addr(addr)
        self.timeout = timeout
        self.pool_size = pool_size if pool_size is not None else POOL_SIZE
        self.retries = retries if retries is not None else RETRIES
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self.breaker = breaker_for(self.addr)

    def _checkout(self, budget: float) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return socket.create_connection(
            self.addr, timeout=max(0.001, min(self.timeout, budget)))

    def _checkin(self, s: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.pool_size:
                self._idle.append(s)
                return
        _close(s)

    def call(self, header: dict, blob=b"",
             retryable: Optional[bool] = None) -> Tuple[dict, bytes]:
        on = resilience_enabled()
        op = str(header.get("op", ""))
        if retryable is None:
            retryable = "rid" in header
        dl = current_deadline() or Deadline(self.timeout)
        attempts = max(1, self.retries) if (on and retryable) else 1
        if on and not self.breaker.allow():
            M.rpc_errors.inc(kind="breaker", op=op)
            raise BreakerOpen(
                f"circuit open for peer {self.addr} "
                f"({self.breaker.failures} consecutive failures)")
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                M.rpc_retries.inc(op=op)
                delay = min(backoff_delay(attempt),
                            max(0.0, dl.remaining()))
                if delay > 0:
                    time.sleep(delay)
                if on and not self.breaker.allow():
                    M.rpc_errors.inc(kind="breaker", op=op)
                    raise BreakerOpen(f"circuit open for peer {self.addr}")
            if on and dl.expired():
                M.rpc_errors.inc(kind="deadline", op=op)
                self.breaker.release_probe()
                raise DeadlineExceeded(
                    f"rpc {op!r} to {self.addr}: deadline exceeded "
                    f"after {attempt} attempt(s)") from last
            M.rpc_attempts.inc(op=op)
            t0 = time.perf_counter()
            try:
                with motrace.span("rpc.call", op=op,
                                  peer=self.breaker.peer,
                                  attempt=attempt):
                    out = self._attempt(header, blob, dl)
                if on:
                    self.breaker.record_success()
                M.rpc_seconds.observe(time.perf_counter() - t0)
                # spans the server shipped back on the response header
                # fold into the caller's trace
                motrace.merge_remote(out[0])
                return out
            except DeadlineExceeded:
                M.rpc_errors.inc(kind="deadline", op=op)
                if on:
                    self.breaker.release_probe()
                raise
            except (OSError, ConnectionError) as e:
                if on:
                    self.breaker.record_failure()
                last = e
            except Exception:  # noqa: BLE001 — counted, then re-raised
                # a garbage response (a decode error) is a misbehaving
                # peer: count it against the breaker, surface the error
                if on:
                    self.breaker.record_failure()
                raise
        if on and dl.expired():
            M.rpc_errors.inc(kind="deadline", op=op)
            raise DeadlineExceeded(
                f"rpc {op!r} to {self.addr}: deadline exceeded "
                f"({last!r})") from last
        M.rpc_errors.inc(kind="transport", op=op)
        raise TransportError(
            f"rpc {op!r} to {self.addr} failed after {attempts} "
            f"attempt(s): {last!r}") from last

    def _attempt(self, header: dict, blob, dl: Deadline
                 ) -> Tuple[dict, bytes]:
        rem = dl.remaining()
        if rem <= 0:
            raise DeadlineExceeded(
                f"rpc to {self.addr}: no budget left before send")
        s = self._checkout(rem)
        ok = False
        try:
            s.settimeout(max(0.001, min(self.timeout, dl.remaining())))
            wire = dict(header)
            wire["deadline_ms"] = int(max(1.0, dl.remaining() * 1000))
            # the trace context rides the header beside the deadline
            motrace.inject(wire)
            fault = INJECTOR.trigger("rpc.send")
            if fault == "drop":
                raise ConnectionError(
                    "fault injected: connection dropped at rpc.send")
            if fault == "partial":
                # a torn half-frame: the server reads a truncated message
                # and drops the connection; the request was not applied
                hj = json.dumps(wire).encode()
                body = b"".join(bytes(p) for p in (
                    blob if isinstance(blob, list) else [blob]))
                frame = (struct.pack("<I", len(hj)) + hj
                         + struct.pack("<I", len(body)) + body)
                s.sendall(frame[:max(1, len(frame) // 2)])
                raise ConnectionError(
                    "fault injected: partial send at rpc.send")
            send_msg(s, wire, blob)
            if INJECTOR.trigger("rpc.recv") == "drop":
                # the request reached the peer and the reply is lost:
                # the hazard idempotency rids exist for
                raise ConnectionError(
                    "fault injected: connection dropped at rpc.recv")
            out = recv_msg(s)
            ok = True
            return out
        finally:
            if ok:
                self._checkin(s)
            else:
                _close(s)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            _close(s)


def _close(s: socket.socket) -> None:
    try:
        s.close()
    except OSError:
        pass


def pack_blobs(blobs: List[bytes]) -> bytes:
    return b"".join(struct.pack("<I", len(b)) + bytes(b) for b in blobs)


def unpack_blobs(blob) -> List[memoryview]:
    mv = memoryview(blob)
    out, off = [], 0
    while off + 4 <= len(mv):
        (n,) = struct.unpack_from("<I", mv, off)
        out.append(mv[off + 4:off + 4 + n])
        off += 4 + n
    return out
