"""Window function operator (reference: pkg/sql/colexec/window).

The port of `matrixone_tpu/vm/window.py`: materialize, assign partition
ids (ops.agg.group_ids), sort rows by (partition, order keys), then
every window function is a segmented scan over the sorted order:

  row_number  = position since partition start
  rank        = position of the first peer + 1
  dense_rank  = per-partition count of peer-group starts
  agg + ORDER = cumulative aggregate up to the LAST PEER of the row
                (SQL default frame RANGE UNBOUNDED PRECEDING..CURRENT ROW)
  agg alone   = whole-partition aggregate broadcast
  ROWS frame  = prefix differences (sum/count/avg) or a sparse table
                (min/max) queried per row

Torch has no associative scan: `_seg_scan` is a log-step (Hillis-Steele)
scan over (value, segment) pairs with the reference's combine.  Integer
and decimal lanes are exact; float sums add in another order than
XLA's scan tree, so they agree to float tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn
from matrixone_tpu_torch.ops import agg as A, hash as H, sort as msort
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.vm.exprs import EvalError, ExecBatch, eval_expr
from matrixone_tpu_torch.vm.operators import (Operator, _broadcast_full,
                                              _concat_batches, _expr_dict,
                                              _sort_key_col)

_BIG = 1 << 62     # int64 "no boundary" sentinel


def _seg_scan(vals: torch.Tensor, seg: torch.Tensor, combine):
    """Inclusive scan of `combine` over vals, restarting at each new value
    of the (nondecreasing) segment id: ceil(log2 n) shifted combines."""
    n = vals.shape[0]
    out = vals
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        merged = torch.where(same, combine(out[:-d], out[d:]), out[d:])
        out = torch.cat([out[:d], merged])
        d *= 2
    return out


def _suffix_min(vals: torch.Tensor) -> torch.Tensor:
    """suffix_min[i] = min(vals[i:])."""
    return torch.flip(torch.cummin(torch.flip(vals, [0]), 0).values, [0])


def _scatter(order: torch.Tensor, vals_s: torch.Tensor) -> torch.Tensor:
    """Sorted-order values back to row order (`order` is a permutation)."""
    out = torch.empty_like(vals_s)
    out[order] = vals_s
    return out


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """x[1:] followed by one `fill`."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])


class WindowOp(Operator):
    def __init__(self, node: P.Window, child: Operator,
                 max_partitions: int = 65536):
        self.node = node
        self.child = child
        self.schema = node.schema
        self.max_partitions = max_partitions

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.node.child.schema)
        out_cols, out_dicts = self.compute_columns(ex)
        db = DeviceBatch(columns=out_cols, n_rows=ex.batch.n_rows)
        yield ExecBatch(batch=db, dicts=out_dicts, mask=ex.mask)

    def compute_columns(self, ex: ExecBatch):
        """Evaluate every window entry over one materialized batch ->
        (output columns, output dicts)."""
        out_cols = dict(ex.batch.columns)
        out_dicts = dict(ex.dicts)
        # entries sharing one OVER spec share the sort/segment machinery
        spec_cache = {}
        for entry in self.node.entries:
            (fn, arg, part, okeys, odescs, out_name) = entry[:6]
            extra = entry[6] if len(entry) > 6 else {}
            key = (tuple(repr(p) for p in part),
                   tuple(repr(k) for k in okeys), tuple(odescs))
            if key not in spec_cache:
                spec_cache[key] = self._spec(part, okeys, odescs, ex)
            out_cols[out_name] = self._compute(fn, arg, spec_cache[key],
                                               ex, extra)
            # value functions over varchar carry their source dictionary
            if arg is not None and arg.dtype.is_varlen:
                d = _expr_dict(arg, ex)
                if d is not None:
                    out_dicts[out_name] = d
        return out_cols, out_dicts

    # ------------------------------------------------------------ kernels
    def _spec(self, part, okeys, odescs, ex):
        """Sort + segment machinery shared by every fn over one OVER spec."""
        n = ex.padded_len
        mask = ex.mask
        device = ex.device
        if part:
            cols = [_broadcast_full(eval_expr(p, ex), n) for p in part]
            gi = A.group_ids([c.data for c in cols],
                             [c.validity for c in cols], mask,
                             self.max_partitions)
            pid = gi.gids
        else:
            pid = torch.zeros((n,), dtype=torch.int32, device=device)

        ocols = [_sort_key_col(k, ex) for k in okeys]
        order = msort.sort_indices(
            [pid] + [c.data for c in ocols],
            [None] + [c.validity for c in ocols],
            [False] + list(odescs), mask)
        pid_s = pid[order]
        mask_s = mask[order]
        idx = _arange(n, device)
        one = torch.ones((1,), dtype=torch.bool, device=device)
        first = torch.cat([one, (pid_s[1:] != pid_s[:-1])
                           | (mask_s[1:] != mask_s[:-1])])
        seg = torch.cumsum(first.to(torch.int64), 0)   # partition seq no

        # position within partition (0-based): idx - partition start
        start_idx = _seg_scan(torch.where(first, idx, 0), seg, torch.maximum)
        pos = idx - start_idx

        if ocols:
            okey_hash = H.hash_columns(
                [c.data[order] for c in ocols],
                [None if c.validity is None else c.validity[order]
                 for c in ocols])
            new_peer = torch.cat([one, okey_hash[1:] != okey_hash[:-1]]) \
                | first
        else:
            new_peer = first

        # last row index of each peer group: next peer start - 1 (or the
        # partition/array end)
        next_peer_start = _suffix_min(
            _shift_left(torch.where(new_peer, idx, _BIG), _BIG))
        next_part_start = _suffix_min(
            _shift_left(torch.where(first, idx, _BIG), _BIG))
        part_end = torch.where(next_part_start == _BIG, n - 1,
                               next_part_start - 1)
        peer_end = torch.minimum(torch.where(next_peer_start == _BIG,
                                             n - 1, next_peer_start - 1),
                                 part_end)
        return {"order": order, "seg": seg, "first": first, "pos": pos,
                "new_peer": new_peer, "peer_end": peer_end,
                "part_end": part_end, "mask_s": mask_s,
                "start_idx": start_idx, "has_order": bool(ocols)}

    def _compute(self, fn, arg, spec, ex, extra=None) -> DeviceColumn:
        extra = extra or {}
        order = spec["order"]
        seg = spec["seg"]
        pos = spec["pos"]
        new_peer = spec["new_peer"]
        mask_s = spec["mask_s"]

        if fn == "row_number":
            vals_s, out_t = pos + 1, dt.INT64
        elif fn == "rank":
            vals_s = _seg_scan(torch.where(new_peer, pos + 1, 0), seg,
                               torch.maximum)
            out_t = dt.INT64
        elif fn == "dense_rank":
            vals_s = _seg_scan(new_peer.to(torch.int64), seg, torch.add)
            out_t = dt.INT64
        elif fn == "ntile":
            vals_s = self._ntile(extra["n"], spec)
            out_t = dt.INT64
        else:
            if fn in ("lag", "lead", "first_value", "last_value",
                      "nth_value"):
                vals_s, valid_out, out_t = self._value_window(
                    fn, arg, ex, spec, extra)
            elif extra.get("frame") is not None:
                vals_s, valid_out, out_t = self._framed_agg(
                    fn, arg, ex, spec, extra["frame"])
            else:
                take_at = spec["peer_end"] if spec["has_order"] \
                    else spec["part_end"]
                vals_s, valid_out, out_t = self._agg_window(
                    fn, arg, ex, order, seg, mask_s, take_at)
            return DeviceColumn(_scatter(order, vals_s),
                                _scatter(order, mask_s & valid_out), out_t)
        return DeviceColumn(_scatter(order, vals_s),
                            _scatter(order, mask_s), out_t)

    def _ntile(self, nt: int, spec):
        """MySQL ntile: first (count % nt) buckets get one extra row;
        when count < nt every row is its own bucket."""
        pos = spec["pos"]
        count = spec["part_end"] - spec["start_idx"] + 1
        size = count // nt
        rem = count % nt
        big_span = rem * (size + 1)
        in_big = pos < big_span
        bucket_small = torch.where(size > 0,
                                   rem + (pos - big_span)
                                   // torch.clamp(size, min=1),
                                   pos)
        bucket = torch.where(in_big, pos // torch.clamp(size + 1, min=1),
                             bucket_small)
        return bucket + 1

    # ---------------------------------------------------- value functions
    def _value_window(self, fn, arg, ex, spec, extra):
        n = ex.padded_len
        order = spec["order"]
        idx = _arange(n, ex.device)
        start = spec["start_idx"]
        pend = spec["part_end"]
        col = _broadcast_full(eval_expr(arg, ex), n)
        v_s = col.data[order]
        cval_s = col.validity[order]

        if fn in ("lag", "lead"):
            off = extra.get("offset", 1)
            src = idx - off if fn == "lag" else idx + off
            in_part = (src >= start) & (src <= pend)
            srcc = torch.clamp(src, 0, n - 1)
            vals = v_s[srcc]
            valid = in_part & cval_s[srcc]
            dflt = extra.get("default")
            if dflt is not None:
                dv = torch.as_tensor(np.asarray(dflt.value)).to(
                    device=ex.device, dtype=v_s.dtype)
                vals = torch.where(in_part, vals, dv)
                valid = valid | ~in_part
            return vals, valid, arg.dtype
        frame = extra.get("frame")
        lo = self._frame_lo(spec, frame)
        hi = self._frame_hi(spec, frame)
        if fn == "first_value":
            src = lo
        elif fn == "last_value":
            src = hi
        else:                                  # nth_value
            src = lo + extra["n"] - 1
        in_frame = (src >= lo) & (src <= hi) & (lo <= hi)
        srcc = torch.clamp(src, 0, n - 1)
        return v_s[srcc], in_frame & cval_s[srcc], arg.dtype

    # ------------------------------------------------------------- frames
    def _frame_lo(self, spec, frame):
        start = spec["start_idx"]
        if frame is None:
            return start                        # default: RANGE UNB..CUR
        idx = _arange(len(spec["pos"]), start.device)
        kind, k = frame[1]
        if kind == "unbounded_preceding":
            raw = start
        elif kind == "current":
            raw = idx
        elif kind == "preceding":
            raw = idx - k
        else:                                   # following
            raw = idx + k
        return torch.maximum(raw, start)

    def _frame_hi(self, spec, frame):
        pend = spec["part_end"]
        if frame is None:
            return spec["peer_end"] if spec["has_order"] else pend
        idx = _arange(len(spec["pos"]), pend.device)
        kind, k = frame[2]
        if kind == "unbounded_following":
            raw = pend
        elif kind == "current":
            raw = idx
        elif kind == "following":
            raw = idx + k
        else:                                   # preceding
            raw = idx - k
        return torch.minimum(raw, pend)

    @staticmethod
    def _arg_sorted(arg, ex, order, mask_s):
        """(values, validity) of the aggregate argument in sorted order;
        count(*) counts ones."""
        n = ex.padded_len
        if arg is None:
            return (torch.ones((n,), dtype=torch.int64, device=ex.device),
                    mask_s)
        col = _broadcast_full(eval_expr(arg, ex), n)
        return col.data[order], col.validity[order] & mask_s

    @staticmethod
    def _sum_type(arg):
        return (arg.dtype if arg.dtype.oid == dt.TypeOid.DECIMAL64
                else dt.INT64 if arg.dtype.is_integer else dt.FLOAT64)

    @staticmethod
    def _avg(s, cnt, arg):
        cs = s.to(torch.float64)
        if arg is not None and arg.dtype.oid == dt.TypeOid.DECIMAL64:
            cs = cs / (10.0 ** arg.dtype.scale)
        return cs / torch.clamp(cnt, min=1)

    def _framed_agg(self, fn, arg, ex, spec, frame):
        """ROWS-frame aggregate: sum/count/avg by inclusive-prefix
        difference; min/max by a sparse table (log-levels of shifted
        combines) queried per row — O(n log n), no per-partition loop."""
        n = ex.padded_len
        order = spec["order"]
        seg = spec["seg"]
        mask_s = spec["mask_s"]
        start = spec["start_idx"]
        lo = self._frame_lo(spec, frame)
        hi = self._frame_hi(spec, frame)
        nonempty = lo <= hi
        loc = torch.clamp(lo, 0, n - 1)
        hic = torch.clamp(hi, 0, n - 1)
        before = torch.clamp(lo - 1, 0, n - 1)
        v_s, valid_s = self._arg_sorted(arg, ex, order, mask_s)

        def frame_sum(prefix):
            zero = torch.zeros((), dtype=prefix.dtype, device=prefix.device)
            return torch.where(
                nonempty,
                prefix[hic] - torch.where(lo > start, prefix[before], zero),
                zero)

        cnt = frame_sum(_seg_scan(valid_s.to(torch.int64), seg, torch.add))
        if fn == "count":
            return cnt, torch.ones_like(cnt, dtype=torch.bool), dt.INT64
        frame_valid = (cnt > 0) & nonempty
        if fn in ("sum", "avg"):
            x = torch.where(valid_s, v_s, torch.zeros_like(v_s))
            s = frame_sum(_seg_scan(x, seg, torch.add))
            if fn == "avg":
                return self._avg(s, cnt, arg), frame_valid, dt.FLOAT64
            out_t = self._sum_type(arg)
            return s.to(out_t.torch_dtype), frame_valid, out_t
        # min / max over arbitrary in-partition ranges: sparse table
        is_bool = v_s.dtype == torch.bool
        if is_bool:
            v_s = v_s.to(torch.int8)
        fill = A._reduce_fill(v_s.dtype, fn == "min")
        comb = torch.minimum if fn == "min" else torch.maximum
        x = torch.where(valid_s, v_s, torch.full_like(v_s, fill))
        n_levels = n.bit_length()               # spans 1, 2, ... <= n
        # st[j, i] = comb(x[i : i + 2^j]); past the end comb with the
        # identity leaves the previous level's value
        st = torch.empty((n_levels, n), dtype=x.dtype, device=x.device)
        st[0] = x
        for j in range(1, n_levels):
            span = 1 << (j - 1)
            st[j, :n - span] = comb(st[j - 1, :n - span], st[j - 1, span:])
            st[j, n - span:] = st[j - 1, n - span:]
        length = torch.clamp(hi - lo + 1, min=1)
        # k = floor(log2(length)), exact via comparisons
        k = torch.zeros_like(length)
        for j in range(1, n_levels):
            k = k + (length >= (1 << j)).to(length.dtype)
        right = torch.clamp(
            hi - (torch.bitwise_left_shift(torch.ones_like(k), k) - 1),
            0, n - 1)
        vals = comb(st[k, loc], st[k, right])
        vals = torch.where(frame_valid, vals, torch.full_like(vals, fill))
        if is_bool:
            vals = vals.to(torch.bool)
        return vals, frame_valid, (arg.dtype if arg is not None
                                   else dt.INT64)

    def _agg_window(self, fn, arg, ex, order, seg, mask_s, take_at):
        v_s, valid_s = self._arg_sorted(arg, ex, order, mask_s)
        cnt = _seg_scan(valid_s.to(torch.int64), seg, torch.add)[take_at]
        if fn == "count":
            return cnt, torch.ones_like(cnt, dtype=torch.bool), dt.INT64
        # an all-NULL frame yields SQL NULL, not the identity element
        if fn in ("sum", "avg"):
            x = torch.where(valid_s, v_s, torch.zeros_like(v_s))
            csum = _seg_scan(x, seg, torch.add)[take_at]
            if fn == "avg":
                return self._avg(csum, cnt, arg), cnt > 0, dt.FLOAT64
            out_t = self._sum_type(arg)
            return csum.to(out_t.torch_dtype), cnt > 0, out_t
        if fn in ("min", "max"):
            is_bool = v_s.dtype == torch.bool
            if is_bool:
                v_s = v_s.to(torch.int8)
            fill = A._reduce_fill(v_s.dtype, fn == "min")
            x = torch.where(valid_s, v_s, torch.full_like(v_s, fill))
            comb = torch.minimum if fn == "min" else torch.maximum
            vals = _seg_scan(x, seg, comb)[take_at]
            if is_bool:
                vals = vals.to(torch.bool)
            return vals, cnt > 0, (arg.dtype if arg is not None
                                   else dt.INT64)
        raise EvalError(f"unsupported window function {fn}")
