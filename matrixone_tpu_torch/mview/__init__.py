"""Incremental materialized views (the port of `matrixone_tpu/mview`).

A materialized view is a real engine table (the backing table) whose
rows are the output of a stored SELECT.  Definitions are rows of the
`system_mview` catalog table, so durability and restart replay ride the
commit and WAL funnels (the same design as `udf/`).

Two maintenance modes, chosen by `mview.planner.analyze`:

  * ``incremental``: the maintainable shapes (one table, scan -> filter
    -> GROUP BY with SUM/COUNT/AVG/MIN/MAX).  Each commit's deltas, from
    the engine's logtail subscribers and its post-commit hook, update a
    partial-aggregate state (`mview/maintain.py`), and the changed groups
    land in the backing table as one ordinary commit;
  * ``full``: every other shape rematerializes in full on demand
    (REFRESH MATERIALIZED VIEW, `mo_ctl('mview','refresh:<v>')`).

SHOW MATERIALIZED VIEWS and EXPLAIN say which mode a view runs in.
"""

from matrixone_tpu_torch.mview.catalog import (MVIEW_TABLE, MViewDef,
                                               ensure_table, is_mview_table,
                                               registry_for)
from matrixone_tpu_torch.mview.planner import MaintainSpec, analyze
from matrixone_tpu_torch.mview.maintain import MViewService, service_for

__all__ = ["MVIEW_TABLE", "MViewDef", "ensure_table", "is_mview_table",
           "registry_for", "MaintainSpec", "analyze", "MViewService",
           "service_for", "stats"]


def stats(catalog) -> dict:
    """mo_ctl('mview','status'): the registry and each view's runtime."""
    reg = registry_for(catalog)
    svc = getattr(catalog, "_mview_service", None)
    views = {}
    for name, d in sorted(reg.items()):
        entry = {"mode": d.mode, "watermark": None}
        if svc is not None:
            rt = svc.runtime(name)
            if rt is not None:
                entry["watermark"] = rt.watermark
                entry["groups"] = rt.n_groups()
        views[name] = entry
    out = {"views": views, "n_views": len(reg)}
    if svc is not None:
        out.update(svc.stats())
    return out
