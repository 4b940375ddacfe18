"""Frame-free window fragments: WindowOp as the prelude of a fused step.

The port of `matrixone_tpu/vm/fusion_window.py`.  The supported entry
shapes (`row_number` / `rank` / `dense_rank` / `ntile` and the
frame-free `sum`/`count`/`avg`/`min`/`max` partition aggregates) run
`WindowOp.compute_columns`, the same method the per-operator path runs,
in one step together with the filter/project/agg/topk chain above it:
one CUDA graph on the card, keyed on the entry signatures, the column
signature, the batch bucket and the order-key dictionary content.

Framed aggregates and the value functions (lag/lead/first_value/
last_value/nth_value) stay barriers; `MO_FUSION_WINDOW=0` turns the
whole pass off.  Degradations (tiny batches, a grouped terminal's key
space going non-dense) land on the ORIGINAL WindowOp -> chain.
"""

from __future__ import annotations

import itertools
from typing import List

from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vm import exprs as EX
from matrixone_tpu_torch.vm import fusion as FF
from matrixone_tpu_torch.vm import fusion_join as FJ
from matrixone_tpu_torch.vm import operators as O
from matrixone_tpu_torch.vm.exprs import ExecBatch
from matrixone_tpu_torch.vm.operators import _concat_batches

_RANK_FNS = {"row_number", "rank", "dense_rank", "ntile"}
_AGG_FNS = {"sum", "count", "avg", "min", "max"}


def window_fusable(op) -> bool:
    """Can this WindowOp run in a fragment's step?  Every entry must be
    a frame-free supported shape with partition/order keys and an
    argument a step can run."""
    from matrixone_tpu_torch.vm.window import WindowOp
    if not isinstance(op, WindowOp) or not FF.window_fusion_enabled():
        return False
    probe = FF._ExprInfo()
    for entry in op.node.entries:
        fn, arg, part, okeys, _odescs, _out_name = entry[:6]
        extra = entry[6] if len(entry) > 6 else {}
        if extra.get("frame") is not None:
            return False
        if fn not in _RANK_FNS and fn not in _AGG_FNS:
            return False
        if arg is not None:
            if arg.dtype.is_varlen \
                    or getattr(arg.dtype, "is_vector", False):
                return False
            if not FF._analyze_expr(arg, probe):
                return False
        for p in part:
            if getattr(p.dtype, "is_vector", False):
                return False
            if not FF._analyze_expr(p, probe):
                return False
        for k in okeys:
            if getattr(k.dtype, "is_vector", False):
                return False
            if not FF._analyze_expr(k, probe):
                return False
    return True


class FusedWindowOp(FF.FusedFragmentOp):
    """One fragment covering WindowOp + the fusable chain above it.
    The window needs every row, so the fragment materializes the child
    stream into ONE concatenated batch, exactly as the per-operator
    WindowOp does, and then runs a single step: window prelude + stages
    + terminal."""

    _allow_scan_defer = False

    def __init__(self, window_op, stages, agg_op, child_src, ctx,
                 fragment_id: int, sort_op=None):
        self._window = window_op
        window_op.child = child_src
        super().__init__(child_src, stages, agg_op, ctx, fragment_id,
                         sort_op=sort_op)
        self.covered_nodes.add(id(window_op.node))
        self.node_roles[id(window_op.node)] = "window"

    # ------------------------------------------------- analysis hooks
    def _source_schema(self):
        return self._window.node.schema

    def _source_node(self):
        return self._window.node

    def _analyze_prelude(self, info) -> None:
        info.env_idx = 0
        for entry in self._window.node.entries:
            _fn, arg, part, okeys, _odescs, _out_name = entry[:6]
            if arg is not None:
                FF._analyze_expr(arg, info)
            for e in itertools.chain(part, okeys):
                FF._analyze_expr(e, info)
                if e.dtype.is_varlen:
                    # order keys bake a collation-rank LUT, partition
                    # keys hash codes: both must capture anew when the
                    # dictionary content changes
                    info.dictdep.append((0, e))

    def _prelude_sig(self, lift_ids) -> List[tuple]:
        sigs = []
        for entry in self._window.node.entries:
            fn, arg, part, okeys, odescs, out_name = entry[:6]
            extra = entry[6] if len(entry) > 6 else {}
            sigs.append((
                fn, out_name,
                FF._expr_sig(arg, lift_ids) if arg is not None
                else None,
                tuple(FF._expr_sig(p, lift_ids) for p in part),
                tuple(FF._expr_sig(k, lift_ids) for k in okeys),
                tuple(bool(d) for d in odescs),
                FF._norm_val(extra.get("n")),
                FF._norm_val(extra.get("offset"))))
        return [("window", tuple(sigs))]

    def _prelude_labels(self) -> List[str]:
        return ["WindowOp"]

    def _audit_exprs(self) -> list:
        out = super()._audit_exprs()
        for entry in self._window.node.entries:
            _fn, arg, part, okeys, _odescs, _out_name = entry[:6]
            if arg is not None:
                out.append(arg)
            out.extend(part)
            out.extend(okeys)
        return out

    def _out_schema(self, ex):
        for st in reversed(self.stages):
            if st.kind == "project":
                return ([n for n, _ in st.schema],
                        [d for _, d in st.schema])
        wn = self._window.node
        return ([n for n, _ in wn.schema], [d for _, d in wn.schema])

    # ----------------------------------------------------- execution
    def original_ops(self) -> list:
        return [self._window] + super().original_ops()

    def execute(self):
        self._begin_execution()
        batches = list(self.child.execute())
        if not batches:
            M.fusion_exec.inc(mode="fallback")
            self.last_stats["mode"] = "fallback"
            yield from self._orig_window_chain([])
            return
        ex = _concat_batches(batches, self._window.node.child.schema)
        if ex.padded_len < FF.min_fused_rows():
            M.fusion_exec.inc(mode="eager")
            self.last_stats["mode"] = "eager"
            yield from self._orig_window_chain(batches)
            return
        try:
            yield from self._execute_fused(ex, iter(()), [], [],
                                           FF._ExprInfo())
        finally:
            self._release_graphs()

    def _make_step(self, trig_schema, sizes, flags, envs, scan_filters,
                   rt_lift):
        """Window prelude + the shared stage/terminal chain, one step.
        `compute_columns` is the same method the per-operator WindowOp
        runs."""
        chain = self._make_chain_fn(sizes, flags, envs)
        wop = self._window
        lift_lits = self._lift_lits + rt_lift
        env0 = envs[0]

        def _window_step(datas, valids, n_rows, mask, lifted, seens,
                         carry):
            binding = {id(lit): v
                       for lit, v in zip(lift_lits, lifted)}
            with EX.lifted_literal_scope(binding):
                cols = {nm: DeviceColumn(d, v, t)
                        for (nm, t), d, v in zip(trig_schema, datas,
                                                 valids)}
                cex = ExecBatch(batch=DeviceBatch(columns=cols,
                                                  n_rows=n_rows),
                                dicts=env0, mask=mask)
                out_cols, _out_dicts = wop.compute_columns(cex)
                wex = ExecBatch(
                    batch=DeviceBatch(columns=out_cols,
                                      n_rows=cex.batch.n_rows),
                    dicts=env0, mask=cex.mask)
                return chain(wex, seens, carry)

        return _window_step

    def _orig_window_chain(self, batches):
        """The fallback ladder: original WindowOp -> chain over the
        already-pulled child batches."""
        wop = self._window
        saved = wop.child
        wop.child = FJ._IterSource(batches, iter(()), self.child.schema)
        if self._orig_bottom is not None:
            self._orig_bottom.child = wop
        try:
            top = self._orig_top if self._orig_top is not None else wop
            yield from top.execute()
        finally:
            wop.child = saved

    def _degrade_grouped(self, carry, sizes, key_dicts, ex, rest,
                         scan_filters):
        """Grouped-terminal degrade: replay the window INPUT batch
        through the ORIGINAL WindowOp -> chain, seeded with the fused
        partials."""
        agg = self._agg_op
        agg._agg_tracker = O._AggDictTracker(agg.node.aggs)
        seed = None
        if carry is not None:
            dense = self._grouped_partials(carry, sizes)
            seed = agg._dense_to_state(dense)
        wop = self._window
        saved = wop.child
        wop.child = FJ._IterSource([ex], rest, self.child.schema)
        rewire = self._orig_bottom if self.stages else agg
        saved_child = rewire.child
        rewire.child = wop
        try:
            yield from agg._grouped_agg(seed=seed, seed_dicts=key_dicts)
        finally:
            wop.child = saved
            rewire.child = saved_child
