"""Serving layer: the plan cache, the snapshot-consistent result cache
and admission control, one bundle per engine.

The port's copy of `matrixone_tpu/serving/__init__.py`.  The session's
execute path (frontend/session.py) consults this state for every
statement; `mo_ctl('serving', ...)` exposes its status and control.
Knobs, with the reference's defaults:

  MO_PLAN_CACHE=0            disable the plan cache (default: on)
  MO_PLAN_CACHE_SIZE=N       plan cache entries (default 256, LRU)
  MO_RESULT_CACHE_MB=N       result cache budget in MB (default 0 = off)
  MO_RESULT_CACHE=0          force the result cache off
  MO_ADMISSION_SLOTS=N       concurrent statements (default 0 = off)
  MO_ADMISSION_QUEUE_MS      interactive queue budget (default 5000)
  MO_ADMISSION_BG_QUEUE_MS   background queue budget (default 500)
  MO_ADMISSION_ACCOUNT_SLOTS per-account concurrency (default 0 = inf)
"""

from __future__ import annotations

import os

from matrixone_tpu_torch.serving.admission import (AdmissionController,
                                                   AdmissionRejected,
                                                   deadline_scope)
from matrixone_tpu_torch.serving.plan_cache import NONDET_FUNCS, PlanCache
from matrixone_tpu_torch.serving.result_cache import ResultCache

__all__ = ["ServingState", "serving_for", "AdmissionRejected",
           "PlanCache", "ResultCache", "AdmissionController",
           "NONDET_FUNCS", "deadline_scope"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ServingState:
    """The per-engine bundle the session execute path consults."""

    def __init__(self):
        self.plan_cache = PlanCache(
            max_entries=_env_int("MO_PLAN_CACHE_SIZE", 256),
            enabled=os.environ.get("MO_PLAN_CACHE", "1") != "0")
        mb = _env_int("MO_RESULT_CACHE_MB", 0)
        if os.environ.get("MO_RESULT_CACHE") == "0":
            mb = 0
        self.result_cache = ResultCache(max_bytes=mb << 20)
        self.admission = AdmissionController(
            slots=_env_int("MO_ADMISSION_SLOTS", 0),
            queue_ms=_env_float("MO_ADMISSION_QUEUE_MS", 5000.0),
            bg_queue_ms=_env_float("MO_ADMISSION_BG_QUEUE_MS", 500.0),
            account_slots=_env_int("MO_ADMISSION_ACCOUNT_SLOTS", 0))

    def status(self) -> dict:
        return {"plan_cache": self.plan_cache.stats(),
                "result_cache": self.result_cache.stats(),
                "admission": self.admission.stats()}

    def clear(self) -> None:
        self.plan_cache.clear()
        self.result_cache.clear()


def serving_for(catalog) -> ServingState:
    """One ServingState per engine (the cache keys carry the account
    scope, so tenant sessions will share it when accounts are ported)."""
    host = getattr(catalog, "_inner", catalog)
    sv = getattr(host, "_serving", None)
    if sv is None:
        sv = ServingState()
        try:
            host._serving = sv
        except AttributeError:  # a facade refusing attributes serves
            pass                # uncached rather than fail
    return sv
