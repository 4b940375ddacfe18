"""LLM SQL functions (reference: plan/function/func_builtin_llm.go +
pkg/monlp/llm): `llm_chat(prompt)` and `llm_embed(text)` call a
configured model endpoint from inside SQL.

Configuration (no endpoint -> a clear error, never a silent stub):
    SET llm_endpoint = 'http://host:port/path'   -- per session
    MO_LLM_ENDPOINT=...                          -- process default
    SET llm_embed_dim = 16                       -- embedding width

Protocol: one POST per distinct input with a JSON body
  {"op": "chat",  "prompt": "..."}  -> {"text": "..."}
  {"op": "embed", "text": "...", "dim": N} -> {"embedding": [floats]}
(An OpenAI-style gateway is a ~10-line adapter serving this shape.)

Evaluation cost model matches the other string functions: host work is
per DISTINCT dictionary entry, so `llm_chat(col)` over a million rows
with 50 distinct values makes 50 calls, and results gather on device.

The port's copy of `matrixone_tpu/llm.py` (pure Python).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import List, Optional


class LLMError(RuntimeError):
    pass


def endpoint(variables: Optional[dict] = None) -> str:
    ep = None
    if variables:
        ep = variables.get("llm_endpoint")
    ep = ep or os.environ.get("MO_LLM_ENDPOINT")
    if not ep:
        raise LLMError(
            "no LLM endpoint configured: SET llm_endpoint = 'http://...'"
            " (or MO_LLM_ENDPOINT)")
    return str(ep)


def _post(ep: str, payload: dict, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        ep, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception as e:               # noqa: BLE001
        raise LLMError(f"LLM endpoint {ep!r} failed: "
                       f"{type(e).__name__}: {e}") from None


#: process-level result cache: SQL evaluates string functions once per
#: DISTINCT dictionary entry, and the projection's dict derivation plus
#: the device eval both walk the dictionary — without a cache each
#: distinct prompt would hit the endpoint more than once per query
#: (and once more on every later query). Keyed by endpoint so a
#: reconfigured session never serves another model's answers.
_CACHE: dict = {}
_CACHE_MAX = 4096


def _cached(key, fn):
    if key in _CACHE:
        return _CACHE[key]
    val = fn()
    if len(_CACHE) >= _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = val
    return val


def chat(prompt: str, variables: Optional[dict] = None) -> str:
    ep = endpoint(variables)

    def call():
        resp = _post(ep, {"op": "chat", "prompt": prompt})
        if "text" not in resp:
            raise LLMError(f"LLM endpoint returned no 'text': {resp}")
        return str(resp["text"])
    return _cached(("chat", ep, prompt), call)


def embed(text: str, dim: int,
          variables: Optional[dict] = None) -> List[float]:
    ep = endpoint(variables)

    def call():
        resp = _post(ep, {"op": "embed", "text": text, "dim": dim})
        vec = resp.get("embedding")
        if not isinstance(vec, list) or len(vec) != dim:
            raise LLMError(
                f"LLM endpoint returned a bad embedding (want {dim} "
                f"floats, got {type(vec).__name__}"
                f"{f' of {len(vec)}' if isinstance(vec, list) else ''})")
        return [float(x) for x in vec]
    return _cached(("embed", ep, dim, text), call)
