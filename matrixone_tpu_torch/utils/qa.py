"""The padding canary (the port's copy of the canary half of
`matrixone_tpu/utils/qa.py`; the corpus runner, tools/moqa, is not
ported: it imports the JAX package).

Every device batch is padded to a power-of-two bucket
(container/device.bucket_length) and the padded tail is supposed to be
DEAD: masked out of every reduction by the row mask, invisible to every
result.  Nothing enforces that: a kernel that sums raw data instead of
masked data reads zeros from the tail and returns a plausible answer.
On the card that covers the hand-written CUDA kernels and the captured
CUDA graphs too.

Armed (`MO_QA_CANARY=1` or `arm()`), this module:

  * POISONS the padded tail of every host->device upload
    (container/device.from_numpy) with NaN (floats) / a recognizable
    sentinel (ints, near the dtype extreme) / True (bools) instead of
    zeros: a correct engine is bit-identical under poison because the
    tail is masked everywhere; an unmasked read turns into a loud NaN
    or an absurd magnitude;
  * AUDITS results at the device->host boundary
    (container/batch.from_device): a canary value in a *valid* visible
    cell is recorded as a `canary-in-result` finding;
  * AUDITS fused aggregate carries (vm/fusion.FusedFragmentOp
    _finalize_agg): a NaN in a float carry lane means a poisoned pad
    row reached an accumulator: `canary-in-carry`.

Disarmed, it costs ONE module-attribute read on the upload path.
Findings accumulate process-globally and surface through `report()` and
the `mo_qa_*` metrics.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

#: module-level armed flag: read on every from_numpy call, so keep the
#: fast path to one attribute access
_ARMED = os.environ.get("MO_QA_CANARY", "0").lower() not in (
    "0", "", "false", "off")

#: findings kept verbatim; later duplicates only bump `count`
MAX_FINDINGS = 200


def armed() -> bool:
    return _ARMED


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


class _ArmedScope:
    """Context manager: arm for the duration, restore the prior state."""

    def __enter__(self):
        self._prev = _ARMED
        arm()
        return self

    def __exit__(self, *exc):
        global _ARMED
        _ARMED = self._prev
        return False


def armed_scope() -> _ArmedScope:
    return _ArmedScope()


# ------------------------------------------------------------- canaries

#: int canaries sit near (not at) the dtype extreme: far outside any
#: value a test generator produces, but still representable, so a
#: leak into a sum/min/max produces an absurd magnitude instead of a
#: silent zero.  Floats use NaN — it propagates through any unmasked
#: arithmetic.  Bools use True — the poison for an unmasked count.
_INT_CANARIES = {
    1: np.int8(-113),
    2: np.int16(-28913),
    4: np.int32(-1_879_048_193),         # -0x70000001
    8: np.int64(-8_070_450_532_247_928_833),   # -0x7000000000000001
}


def canary_value(dtype: np.dtype):
    """The poison value for one numpy dtype (None = dtype not poisoned)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return dtype.type(np.nan)
    if dtype.kind == "b":
        return np.bool_(True)
    if dtype.kind in ("i",):
        return _INT_CANARIES.get(dtype.itemsize)
    if dtype.kind == "u":
        return dtype.type(np.iinfo(dtype).max - 113)
    return None


def pad_fill(dtype: np.dtype, shape) -> np.ndarray:
    """The padded-tail fill block: canary-poisoned when armed, zeros
    otherwise (the historical behaviour).  Called by
    container/device.from_numpy for every upload that pads."""
    if not _ARMED:
        return np.zeros(shape, dtype=dtype)
    v = canary_value(dtype)
    if v is None:
        return np.zeros(shape, dtype=dtype)
    return np.full(shape, v, dtype=dtype)


# ------------------------------------------------------------- findings

class Finding:
    """One canary sighting (or corpus finding routed through here)."""

    __slots__ = ("rule", "where", "detail", "count")

    def __init__(self, rule: str, where: str, detail: str):
        self.rule = rule
        self.where = where
        self.detail = detail
        self.count = 1

    def format(self) -> str:
        extra = f" (x{self.count})" if self.count > 1 else ""
        return f"[{self.rule}] {self.where}: {self.detail}{extra}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail, "count": self.count}


_FINDINGS: List[Finding] = []


def record_finding(rule: str, where: str, detail: str) -> None:
    from matrixone_tpu_torch.utils import metrics as M
    for f in _FINDINGS:
        if f.rule == rule and f.where == where:
            f.count += 1
            M.qa_findings.inc(kind=rule)
            return
    if len(_FINDINGS) < MAX_FINDINGS:
        _FINDINGS.append(Finding(rule, where, detail))
    M.qa_findings.inc(kind=rule)


def findings() -> List[Finding]:
    return list(_FINDINGS)


class _Capture:
    """Swap in a fresh findings sink for the scope's duration (the
    per-run detection of a differential runner: the process-global list dedups by
    (rule, where), so `len(findings())` deltas go blind on repeats —
    an isolated sink sees every run's findings fresh)."""

    def __enter__(self):
        global _FINDINGS
        self._saved = _FINDINGS
        _FINDINGS = []
        self._mine = _FINDINGS
        return self

    def findings(self) -> List[Finding]:
        return list(self._mine)

    def __exit__(self, *exc):
        global _FINDINGS
        _FINDINGS = self._saved
        return False


def capture() -> _Capture:
    return _Capture()


def clear() -> None:
    del _FINDINGS[:]


def report() -> dict:
    """mo_ctl('qa','status') payload half: the canary side."""
    return {"armed": _ARMED,
            "findings": len(_FINDINGS),
            "findings_list": [f.format() for f in _FINDINGS[:20]]}


# --------------------------------------------------------------- audits

def audit_host_column(name: str, data: np.ndarray,
                      valid: np.ndarray) -> None:
    """Device->host boundary audit: a canary in a VALID visible cell of
    a result column means a poisoned pad row leaked through an operator
    (container/batch.from_device calls this per column when armed)."""
    v = canary_value(data.dtype)
    if v is None:
        return
    if data.dtype.kind == "f":
        hits = np.isnan(data) & valid
    elif data.dtype.kind == "b":
        # bool columns can legitimately be True: no host audit (a leak
        # into a bool still skews counts, which the lockstep diff sees)
        return
    else:
        hits = (data == v) & valid
    n = int(np.count_nonzero(hits))
    if n:
        record_finding("canary-in-result", f"column {name!r}",
                f"{n} valid result cell(s) carry the padding canary "
                f"({v!r}) — an operator read the padded tail unmasked")


def audit_carry(fields, where: str) -> None:
    """Fused-aggregate carry audit: NaN in a float accumulator lane
    means a poisoned pad value entered a reduction (vm/fusion calls
    this at finalize when armed).  Int lanes are not auditable here —
    the host-result audit and the lockstep diff cover them."""
    for i, arr in enumerate(fields):
        if not arr.dtype.is_floating_point:
            continue
        n = int(arr.isnan().sum())
        if n:
            record_finding("canary-in-carry", where,
                    f"float carry lane {i} holds {n} NaN slot(s) — a "
                    f"padded row reached the aggregate accumulator")


# ----------------------------------------------------- corpus counters
# Single drive point for the mo_qa_* metrics: a differential runner calls
# these instead of touching the registry.

def note_query(n: int = 1) -> None:
    from matrixone_tpu_torch.utils import metrics as M
    M.qa_queries.inc(n)


def note_check(oracle: str, n: int = 1) -> None:
    from matrixone_tpu_torch.utils import metrics as M
    M.qa_oracle_checks.inc(n, oracle=oracle)


def note_finding(kind: str) -> None:
    from matrixone_tpu_torch.utils import metrics as M
    M.qa_findings.inc(kind=kind)
