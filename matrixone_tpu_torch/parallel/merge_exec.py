"""Cross-shard partial-aggregate merge (mergegroup).

The port of `matrixone_tpu/parallel/merge_exec.py`.  The device-shard
executor (`parallel/dist_query.py`) runs one fragment per slot and
collects the partial group tables; the functions here fold them into
one state on the merge device:

  * `_general_merge` — group tables of any key shape: every shard's
    representative rows concatenated in slot order, re-grouped ONCE
    (`ops/agg.group_ids`), each partial field folded over the shards in
    slot order (`_fold`: the same bits on every run);
  * `_dense_merge`   — dense accumulators over the same key space: an
    elementwise `psum` over the slots (`parallel/mesh.psum`, slot order);
  * `_scalar_combine`— the scalar (ungrouped) aggregates' algebra.

Where the reference compiles each merge into one program and caches it
per state layout, the port's merge is eager torch work with nothing to
cache.  The reference's cache key is still audited at every merge as the
key site `parallel/merge_exec.py:merge`, so a layout that the key would
conflate shows at the colliding merge.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from matrixone_tpu_torch.ops import agg as A
from matrixone_tpu_torch.parallel import mesh as MS
from matrixone_tpu_torch.utils import keys as keyaudit

SITE_MERGE = "parallel/merge_exec.py:merge"

#: test hook: merge invocations (one per sharded statement)
_MERGE_CALLS = {"count": 0}


class ShardDegrade(RuntimeError):
    """A shard-side condition the merge cannot absorb (divergent
    dictionaries, unmergeable partial fields): the caller runs the whole
    statement on one device instead, never a wrong answer."""


def _fold_op(field: str):
    """(fold of two group rows, identity element of a dtype) of one
    partial field."""
    if field in ("sum", "count", "sumsq"):
        return torch.add, lambda dt: 0
    if field == "min":
        return torch.minimum, lambda dt: A._reduce_fill(dt, True)
    if field == "max":
        return torch.maximum, lambda dt: A._reduce_fill(dt, False)
    raise ShardDegrade(f"unmergeable partial field {field!r}")


def _fold(field: str, parts, gids, masks, mg_out: int, device):
    """One partial field of every shard into mg_out groups.  A shard's
    rows are distinct groups, so each shard writes its own row of an
    [S, mg_out] table without a collision, and the rows fold in slot
    order: the same bits on every run (a scatter-add of all the rows
    would add in no fixed order on the card)."""
    op, ident = _fold_op(field)
    acc = None
    for v, g, m in zip(parts, gids, masks):
        v = v.to(device)
        row = torch.full((mg_out,), ident(v.dtype), dtype=v.dtype,
                         device=device)
        row[g[m].to(torch.int64)] = v[m]
        acc = row if acc is None else op(acc, row)
    return acc


def _general_merge(states, aggs, psig, device):
    """mergegroup over the shards' general group tables: concatenate
    every shard's rep rows on `device`, re-group once, fold each partial
    field over the shards (`_fold`)."""
    n_sh = len(states)
    nkeys = len(states[0]["keys"])
    mgs = tuple(int(st["present"].shape[0]) for st in states)
    mg_out = 1 << max(sum(mgs) - 1, 1).bit_length()
    kdts = tuple(str(states[0]["keys"][i].dtype) for i in range(nkeys))
    fl = tuple(tuple(sorted(states[0]["partials"][j].keys()))
               for j in range(len(aggs)))
    fdts = tuple(tuple(str(states[0]["partials"][j][f].dtype)
                       for f in fs) for j, fs in enumerate(fl))
    for f in (f for fs in fl for f in fs):
        _fold_op(f)             # reject unmergeable layouts up front
    if keyaudit.armed():
        keyaudit.audit(
            SITE_MERGE,
            ("general", n_sh, mgs, mg_out, kdts, fl, fdts, "shard", psig),
            {"mesh_shape": (n_sh,), "shard_axis": "shard",
             "partition_spec": psig, "mg_out": mg_out, "fl": fl,
             "state_layout": (mgs, kdts, fl, fdts)})
    _MERGE_CALLS["count"] += 1
    kd = [MS.all_gather([st["keys"][i] for st in states], device)
          for i in range(nkeys)]
    kv = [MS.all_gather([st["kvalid"][i] for st in states], device)
          for i in range(nkeys)]
    mask = MS.all_gather([st["present"] for st in states], device)
    gi = A.group_ids(kd, kv, mask, mg_out)
    rep_k, rep_v = A.gather_keys(kd, kv, gi.rep_rows)
    present = torch.arange(mg_out, dtype=torch.int32,
                           device=device) < gi.num_groups
    gids = torch.split(gi.gids, list(mgs))
    masks = torch.split(mask, list(mgs))
    partials = [{f: _fold(f, [st["partials"][j][f] for st in states],
                          gids, masks, mg_out, device) for f in fs}
                for j, fs in enumerate(fl)]
    return {"keys": list(rep_k), "kvalid": list(rep_v),
            "present": present, "partials": partials,
            "n": gi.num_groups}


def _dense_merge(helper, denses, psig, device):
    """Same-shape dense accumulators merged with an elementwise psum
    over the slots (the mview delta merge's kernel family: adds of
    (G,)-sized partials)."""
    n_sh = len(denses)
    sizes = denses[0]["sizes"]
    layout = [("rows", None)]
    for j, a in enumerate(helper.node.aggs):
        for _c, f in type(helper)._dense_fields(a):
            layout.append((f, j))

    def flat(d):
        return [d["rows"]] + [d["partials"][j][f] for f, j in layout[1:]]

    flats = [flat(d) for d in denses]
    dts = tuple(str(a.dtype) for a in flats[0])
    g = int(flats[0][0].shape[0])
    if keyaudit.armed():
        keyaudit.audit(SITE_MERGE, ("dense", n_sh, g, dts, "shard", psig),
                       {"mesh_shape": (n_sh,), "shard_axis": "shard",
                        "partition_spec": psig, "state_layout": (g, dts)})
    _MERGE_CALLS["count"] += 1
    merged = [MS.psum([fl[i] for fl in flats], device)
              for i in range(len(dts))]
    out = {"sizes": sizes, "rows": merged[0],
           "partials": [dict(p) for p in denses[0]["partials"]]}
    for (f, j), arr in zip(layout[1:], merged[1:]):
        out["partials"][j][f] = arr
    return helper._dense_to_state(out)


def _merge_key_dicts(kds, nkeys: int):
    out: List[Optional[list]] = [None] * nkeys
    for i in range(nkeys):
        for kd in kds:
            d = kd[i]
            if d is None:
                continue
            cur = out[i]
            if cur is None or (d is not cur and len(d) > len(cur)):
                if cur is not None and list(d[:len(cur)]) != list(cur):
                    raise ShardDegrade(
                        "divergent group-key dictionaries across shards")
                out[i] = d
            elif d is not cur and list(d) != list(cur[:len(d)]):
                raise ShardDegrade(
                    "divergent group-key dictionaries across shards")
    return out


def _merge_trackers(trackers, aggs):
    """min/max-over-strings dictionaries must AGREE across shards:
    collation ranks compare only against one frozen dictionary."""
    from matrixone_tpu_torch.vm.operators import _AggDictTracker
    out = _AggDictTracker(aggs)
    for tr in trackers:
        for name, d in tr.dicts.items():
            cur = out.dicts.get(name)
            if cur is None:
                out.dicts[name] = d
                out._sizes[name] = len(d)
            elif d is not cur and list(d) != list(cur):
                raise ShardDegrade(
                    "divergent min/max string dictionaries across shards")
    return out


def _scalar_combine(a, s1, s2):
    if a.func == "count":
        return s1 + s2
    if a.func in ("sum", "avg"):
        return (s1[0] + s2[0], s1[1] + s2[1])
    if a.func == "min":
        return (torch.minimum(s1[0], s2[0]), s1[1] + s2[1])
    if a.func == "max":
        return (torch.maximum(s1[0], s2[0]), s1[1] + s2[1])
    # stddev/variance family: (sum, sumsq, count)
    return (s1[0] + s2[0], s1[1] + s2[1], s1[2] + s2[2])
