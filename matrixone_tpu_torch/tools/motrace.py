"""`python -m matrixone_tpu_torch.tools.motrace`: the tracing plane's
smoke gate.

The port's copy of the JAX package's `tools/motrace.py`: run a real
query through the port's `Session` with tracing armed, then check a
well-formed span tree (a single root, parent links that resolve, the
lifecycle children) and a valid Chrome-trace JSON export.  One
embedded engine and a few hundred rows: well under 30 s.
"""

from __future__ import annotations

import json
import sys
import time


def run_smoke(device=None) -> dict:
    """-> {ok, errors, traces, spans, chrome_events, seconds}.  Arms the
    tracer for the drill and restores its state.  The session runs on
    `device` (CUDA unless the caller names the CPU)."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import motrace
    t0 = time.time()
    errors = []
    tr = motrace.TRACER
    was_armed, was_sample = tr.armed, tr.sample
    tr.arm(sample=1.0)
    tr.clear()
    try:
        s = Session(device=device)
        try:
            s.execute("create table trace_smoke (a bigint, b double)")
            vals = ", ".join(f"({i % 7}, {i}.5)" for i in range(200))
            s.execute(f"insert into trace_smoke values {vals}")
            s.execute("select a, sum(b), count(*) from trace_smoke "
                      "group by a order by a")
        finally:
            s.close()
        tids = tr.trace_ids()
        if len(tids) < 3:
            errors.append(f"expected >=3 traces (one per statement), "
                          f"got {len(tids)}")
        # the SELECT's trace: the last statement executed
        tid = tids[-1] if tids else ""
        spans = tr.spans_of(tid)
        roots = motrace.tree(tid)
        if len(roots) != 1:
            errors.append(f"span tree has {len(roots)} roots, want 1 "
                          f"(unbalanced spans or broken parent links)")
        else:
            root = roots[0]
            if root["name"] != "statement":
                errors.append(f"root span is {root['name']!r}, "
                              f"want 'statement'")
            kids = {c["name"] for c in root["children"]}
            for want in ("parse", "run"):
                if want not in kids:
                    errors.append(f"missing lifecycle child {want!r} "
                                  f"under the statement root "
                                  f"(have {sorted(kids)})")
        sids = {sp["sid"] for sp in spans}
        for sp in spans:
            if sp["psid"] and sp["psid"] not in sids:
                errors.append(f"span {sp['name']!r} has dangling "
                              f"parent {sp['psid']}")
        # Chrome export: valid JSON, Perfetto-loadable shape
        ct = json.loads(json.dumps(motrace.chrome_trace(tid)))
        evs = ct.get("traceEvents", [])
        if not any(e.get("ph") == "M"
                   and e.get("name") == "process_name" for e in evs):
            errors.append("chrome trace lacks process_name metadata")
        for e in evs:
            if e.get("ph") == "X" and not all(
                    k in e for k in ("name", "pid", "tid", "ts", "dur")):
                errors.append(f"malformed X event: {e}")
                break
        return {"ok": not errors, "errors": errors,
                "traces": len(tids), "spans": len(spans),
                "chrome_events": len(evs),
                "seconds": round(time.time() - t0, 2)}
    finally:
        tr.armed = was_armed
        tr.sample = was_sample
        tr.clear()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m matrixone_tpu_torch.tools.motrace")
    ap.add_argument("--device", default=None,
                    help="the session's device (default: cuda)")
    args = ap.parse_args(argv)
    rep = run_smoke(args.device)
    for e in rep["errors"]:
        print(f"trace-smoke: {e}", file=sys.stderr)
    print(f"trace-smoke: {'ok' if rep['ok'] else 'FAIL'} "
          f"({rep['traces']} traces, {rep['spans']} spans, "
          f"{rep['chrome_events']} chrome events, {rep['seconds']}s)")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
