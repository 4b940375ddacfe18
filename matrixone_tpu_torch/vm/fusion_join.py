"""Join fragments: the fusion planner's answer to the join barrier.

The port of `matrixone_tpu/vm/fusion_join.py`.  A fusable `JoinOp`
(inner / left / semi / anti with keys and a residual a step can run)
splits into two steps instead of splitting the plan:

  * **build step**: key hash -> argsort -> sorted hash array (plus the
    runtime-filter min/max ranges), one step per build, keyed on the
    build side's shape, dtypes and key-dictionary content;
  * **probe step**: probe hash -> the sorted-search kernel -> duplicate
    lane expand -> key verify -> gather -> the downstream
    filter/project/agg/topk chain, one step per probe batch.

On the card each is one CUDA graph per key (vm/graphs.py), so the
probe's sorted-search kernel (csrc/sorted_search.cu) launches inside a
captured graph.  Both steps call the same pure kernels `JoinOp` runs
(vm/join.py), so fused and unfused compute alike.  The degradation
ladder is the reference's: a build side past the budget, an empty
build, tiny probe batches or `MO_FUSION_JOIN=0` land on the original
`JoinOp`; duplicate fan-out past `max_matches` re-runs the same probe
batch with a doubled lane budget (the overflow flag is an output of the
probe step: one host sync, and one more graph per lane budget).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional

import torch

from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn
from matrixone_tpu_torch.utils import keys as keyaudit
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vm import exprs as EX
from matrixone_tpu_torch.vm import fusion as FF
from matrixone_tpu_torch.vm import join as J
from matrixone_tpu_torch.vm import operators as O
from matrixone_tpu_torch.vm.exprs import ExecBatch
from matrixone_tpu_torch.vm.operators import Operator, _concat_batches

#: join kinds the probe step runs; cross has no keys and full carries
#: cross-batch build-matched state the host loop owns
_FUSABLE_KINDS = ("inner", "left", "semi", "anti")


def join_fusable(op) -> bool:
    """Can this operator become a fused build/probe fragment pair?"""
    if not isinstance(op, J.JoinOp) or not FF.join_fusion_enabled():
        return False
    node = op.node
    if node.kind not in _FUSABLE_KINDS or not node.right_keys:
        return False
    probe = FF._ExprInfo()
    for k in list(node.left_keys) + list(node.right_keys):
        if getattr(k.dtype, "is_vector", False):
            return False
        if not FF._analyze_expr(k, probe):
            return False
    if node.residual is not None \
            and not FF._analyze_expr(node.residual, probe):
        return False
    return True


class _IterSource(Operator):
    """Already-pulled batches (plus the rest of an iterator) as an
    operator, so the original JoinOp can re-enter the degradation
    ladder without re-executing its children."""

    def __init__(self, batches, rest, schema):
        self._batches = batches
        self._rest = rest
        self.schema = schema

    def execute(self) -> Iterator[ExecBatch]:
        yield from itertools.chain(self._batches, self._rest)


def _keep_on(flag, old, new):
    """`old` where the 0-d bool `flag` is set, else `new`, leaf by leaf
    of two nested tuples of tensors of one structure."""
    if isinstance(new, torch.Tensor):
        return torch.where(flag, old, new)
    return type(new)(_keep_on(flag, o, n) for o, n in zip(old, new))


class FusedJoinProbeOp(FF.FusedFragmentOp):
    """One fragment covering JoinOp + the fusable chain above it.

    `child` is the probe (left) side, `right` the build side: tree
    walkers traverse both unchanged."""

    _allow_scan_defer = False

    def __init__(self, join_op, stages, agg_op, probe_src, build_src,
                 ctx, fragment_id: int, sort_op=None):
        self._join = join_op
        # keep the original operator pointed at the FUSED children so
        # every fallback re-enters the per-operator ladder unchanged
        join_op.left = probe_src
        join_op.right = build_src
        super().__init__(probe_src, stages, agg_op, ctx, fragment_id,
                         sort_op=sort_op)
        self.right = build_src
        self.covered_nodes.add(id(join_op.node))
        self.node_roles[id(join_op.node)] = "join=build+probe"
        self._build_dicts: Dict[str, list] = {}
        self._bkey_dicts: List[Optional[list]] = []

    # ------------------------------------------------- analysis hooks
    def _source_schema(self):
        return self._join.node.schema

    def _source_node(self):
        return self._join.node

    def _analyze_prelude(self, info) -> None:
        node = self._join.node
        info.env_idx = 0
        for k in list(node.left_keys) + list(node.right_keys):
            FF._analyze_expr(k, info)
        if node.residual is not None:
            FF._analyze_expr(node.residual, info)

    def _prelude_sig(self, lift_ids) -> List[tuple]:
        node = self._join.node
        return [("join", node.kind,
                 tuple(FF._expr_sig(k, lift_ids)
                       for k in node.left_keys),
                 tuple(FF._expr_sig(k, lift_ids)
                       for k in node.right_keys),
                 FF._expr_sig(node.residual, lift_ids)
                 if node.residual is not None else None,
                 tuple((nm, FF._tsig(t)) for nm, t in node.left.schema),
                 tuple((nm, FF._tsig(t))
                       for nm, t in node.right.schema))]

    def _prelude_labels(self) -> List[str]:
        return ["JoinBuild", "JoinProbe"]

    def _audit_exprs(self) -> list:
        node = self._join.node
        out = super()._audit_exprs()
        out.extend(node.left_keys)
        out.extend(node.right_keys)
        if node.residual is not None:
            out.append(node.residual)
        return out

    # --------------------------------------------------- dict plumbing
    def _dict_envs(self, dicts0):
        merged = dict(self._build_dicts)
        merged.update(dicts0)
        return super()._dict_envs(merged)

    def _out_schema(self, ex):
        for st in reversed(self.stages):
            if st.kind == "project":
                return ([n for n, _ in st.schema],
                        [d for _, d in st.schema])
        # no projection: the stream payload's column ORDER is the probe
        # chain's construction order, left schema then (inner/left)
        # right schema.  NOT jn.schema: after a CBO side swap the join
        # node's declared order differs from the physical batch order
        jn = self._join.node
        sch = list(jn.left.schema)
        if jn.kind not in ("semi", "anti"):
            sch += list(jn.right.schema)
        return ([n for n, _ in sch], [d for _, d in sch])

    def _stream_batch(self, ex, payload, envs) -> ExecBatch:
        out_datas, out_valids, out_mask = payload
        names, dtypes = self._out_schema(ex)
        cols = {nm: DeviceColumn(d, v, t)
                for nm, t, d, v in zip(names, dtypes, out_datas,
                                       out_valids)}
        env_final = envs[-1]
        dicts = {nm: env_final[nm] for nm, t in zip(names, dtypes)
                 if t.is_varlen and env_final.get(nm) is not None}
        db = DeviceBatch(columns=cols,
                         n_rows=out_mask.to(torch.int32).sum())
        out = ExecBatch(batch=db, dicts=dicts, mask=out_mask)
        # same lane discipline as the per-operator probe: join output
        # lanes are np*mm wide but usually sparse
        return J._maybe_compact(out)

    # ----------------------------------------------------- execution
    def original_ops(self) -> list:
        return [self._join] + super().original_ops()

    def _new_stats(self) -> dict:
        return dict(super()._new_stats(), build_dispatches=0)

    def execute(self):
        self._begin_execution()
        join = self._join
        node = join.node
        build_iter = self.right.execute()
        build_batches, overflowed = J.stream_build_side(
            build_iter, join.build_budget)
        if overflowed or not build_batches:
            # over budget or empty build side: the original JoinOp owns
            # every one of those ladders
            M.fusion_exec.inc(mode="fallback")
            self.last_stats["mode"] = "fallback"
            yield from self._orig_join_chain(build_batches, build_iter)
            return
        build = _concat_batches(build_batches, node.right.schema)
        try:
            # build BEFORE the first probe pull: the build step's ranges
            # become runtime filters on the probe scans, and zonemap
            # pruning only sees them for chunks not yet read
            bstate = self._build_state(build)
            probe_iter = self.child.execute()
            first = next(probe_iter, None)
            # degrade ladders below re-enter the ORIGINAL JoinOp: hand
            # it the finalized build state so it neither re-runs the
            # build math nor re-pushes the runtime filters
            sorted_hash, order, bvalid, bkeys, _bkey = bstate
            join._prepared_build = (build, sorted_hash, order, bvalid,
                                    bkeys, list(self._bkey_dicts))
            if first is None:
                M.fusion_exec.inc(mode="fallback")
                self.last_stats["mode"] = "fallback"
                yield from self._orig_join_chain([build], iter(()),
                                                 probe=([], iter(())))
                return
            if first.padded_len < FF.min_fused_rows():
                M.fusion_exec.inc(mode="eager")
                self.last_stats["mode"] = "eager"
                yield from self._orig_join_chain(
                    [build], iter(()), probe=([first], probe_iter))
                return
            join._prepared_build = None
            yield from self._execute_join_fused(build, bstate, first,
                                                probe_iter)
        finally:
            self._release_graphs()

    def _orig_join_chain(self, build_batches, build_rest, probe=None):
        """Run the ORIGINAL JoinOp (+ the original chain above it) over
        the partially-pulled sides: the ladder for every degradation."""
        join = self._join
        node = join.node
        saved_l, saved_r = join.left, join.right
        join.right = _IterSource(build_batches, build_rest,
                                 node.right.schema)
        if probe is not None:
            join.left = _IterSource(probe[0], probe[1],
                                    node.left.schema)
        if self._orig_bottom is not None:
            self._orig_bottom.child = join
        try:
            top = self._orig_top if self._orig_top is not None else join
            if self._partial_wanted():
                self._partial[0] = (top.partial_state()
                                    if top.node.group_keys
                                    else top.partial_scalar_state())
                return
            yield from top.execute()
        finally:
            join.left, join.right = saved_l, saved_r

    def _build_state(self, build):
        """Run the build step for this build batch: ONE step giving the
        sorted hash array, the row order, the key columns and the
        runtime-filter ranges."""
        node = self._join.node
        self._build_dicts = dict(build.dicts)
        self._bkey_dicts = [
            O._expr_dict(k, build) if k.dtype.is_varlen else None
            for k in node.right_keys]
        specs = J.runtime_filter_specs(node)
        # the build step depends ONLY on the build-key expressions: two
        # fragments sharing a build side but differing above the probe
        # share one cached build step
        binfo = FF._ExprInfo()
        binfo.env_idx = 0
        for k in node.right_keys:
            FF._analyze_expr(k, binfo)
        lift_lits = list(binfo.lift)
        colsig = tuple((nm, int(c.dtype.oid), str(c.data.dtype),
                        tuple(c.data.shape))
                       for nm, c in build.batch.columns.items())
        blids = frozenset(id(x) for x in lift_lits)
        device = build.device
        key = ("joinbuild",
               tuple(FF._expr_sig(k, blids) for k in node.right_keys),
               tuple(i for i, _lk in specs), colsig,
               int(build.mask.shape[0]),
               tuple(FF._norm_val(lit.value) for lit in binfo.baked),
               tuple(FF._dict_key(d) for d in self._bkey_dicts),
               tuple(FF._dict_key(FF._static_dict(e, self._build_dicts))
                     for _i, e in binfo.dictdep),
               FF.ENC.signature(device), FF.HK.signature(), str(device))
        entry = FF.CACHE.entry(key)
        if keyaudit.armed():
            keyaudit.audit("vm/fusion_join.py:joinbuild", key, {
                "bkey_dict_content": tuple(
                    tuple(str(s) for s in d) if d is not None else None
                    for d in self._bkey_dicts),
                "dictdep_content": tuple(
                    tuple(str(s) for s in d) if d is not None else None
                    for d in (FF._static_dict(e, self._build_dicts)
                              for _i, e in binfo.dictdep)),
                "baked_values": tuple(FF._norm_val(lit.value)
                                      for lit in binfo.baked),
                "lift_arity": len(lift_lits),
                "rf_spec_indexes": tuple(i for i, _lk in specs),
                "encoding_policy": (FF.ENC.signature(device),
                                    FF.HK.signature()),
            })
        bschema = tuple((nm, c.dtype)
                        for nm, c in build.batch.columns.items())
        bdicts = self._build_dicts

        def _join_build_step(datas, valids, n_rows, mask, lifted):
            binding = {id(lit): v
                       for lit, v in zip(lift_lits, lifted)}
            with EX.lifted_literal_scope(binding):
                cols = {nm: DeviceColumn(d, v, t)
                        for (nm, t), d, v in zip(bschema, datas,
                                                 valids)}
                bex = ExecBatch(batch=DeviceBatch(columns=cols,
                                                  n_rows=n_rows),
                                dicts=bdicts, mask=mask)
                bkeys, _ = J.build_key_columns(node, bex)
                sorted_hash, order, bvalid = J.build_sorted_hash(
                    bkeys, bex.mask)
                lo, hi, anyv = J.runtime_filter_ranges(specs, bkeys,
                                                       bvalid)
                return (sorted_hash, order, bvalid,
                        tuple(k.data for k in bkeys),
                        tuple(k.validity for k in bkeys), lo, hi, anyv)

        fn = entry["fn"].get("build")
        if fn is None:
            fn = _join_build_step
            entry["fn"]["build"] = fn
        args = (tuple(c.data for c in build.batch.columns.values()),
                tuple(c.validity for c in build.batch.columns.values()),
                build.batch.n_rows.to(torch.int32), build.mask,
                tuple(torch.tensor([lit.value],
                                   dtype=lit.dtype.torch_dtype)
                      for lit in lift_lits))
        out, graphed = self._run(entry, "build", fn, args,
                                 stat="build_dispatches")
        if graphed:
            # the build state outlives later replays of this graph (the
            # next execution of the same build key)
            out = FF._clone_tree(out)
        (sorted_hash, order, bvalid, bkdatas, bkvalids,
         lo, hi, anyv) = out
        bkeys = [DeviceColumn(d, v, k.dtype)
                 for d, v, k in zip(bkdatas, bkvalids,
                                    node.right_keys)]
        if specs and node.kind in ("inner", "semi"):
            self._join.apply_runtime_filters(
                specs, lo.tolist(), hi.tolist(), bool(anyv))
        return sorted_hash, order, bvalid, bkeys, key

    def _probe_runtime_key(self, ex, envs, mm, build_key, sizes_flags):
        cols = ex.batch.columns
        colsig = tuple((nm, int(c.dtype.oid), str(c.data.dtype),
                        tuple(c.data.shape))
                       for nm, c in cols.items())
        baked = tuple(FF._norm_val(lit.value)
                      for lit in self._baked_lits)
        dicts = tuple(FF._dict_key(FF._static_dict(e, envs[i]))
                      for i, e in self._dictdeps)
        # the varchar key-translation LUT depends on BOTH dictionaries
        node = self._join.node
        keydicts = tuple(
            (FF._dict_key(bd),
             FF._dict_key(O._expr_dict(k, ex))
             if k.dtype.is_varlen else None)
            for k, bd in zip(node.left_keys, self._bkey_dicts))
        return (self._plan_sig, colsig, int(ex.mask.shape[0]), baked,
                dicts, sizes_flags, mm, build_key, keydicts,
                FF.ENC.signature(ex.device), FF.HK.signature(),
                str(ex.device))

    def _make_probe_step(self, trig_schema, bschema, sizes, flags, envs,
                         mm):
        chain = self._make_chain_fn(sizes, flags, envs)
        node = self._join.node
        lift_lits = list(self._lift_lits)
        bkey_dicts = list(self._bkey_dicts)
        bdicts = self._build_dicts
        kinds_collapse = node.kind in ("semi", "anti")

        def _join_probe_step(pdatas, pvalids, p_nrows, pmask, bdatas,
                             bvalids, b_nrows, bmask, sorted_hash,
                             border, bkdatas, bkvalids, lifted, seens,
                             carry):
            binding = {id(lit): v
                       for lit, v in zip(lift_lits, lifted)}
            with EX.lifted_literal_scope(binding):
                pcols = {nm: DeviceColumn(d, v, t)
                         for (nm, t), d, v in zip(trig_schema, pdatas,
                                                  pvalids)}
                pex = ExecBatch(batch=DeviceBatch(columns=pcols,
                                                  n_rows=p_nrows),
                                dicts=dict(envs[0]), mask=pmask)
                bcols = {nm: DeviceColumn(d, v, t)
                         for (nm, t), d, v in zip(bschema, bdatas,
                                                  bvalids)}
                build = ExecBatch(batch=DeviceBatch(columns=bcols,
                                                    n_rows=b_nrows),
                                  dicts=bdicts, mask=bmask)
                bkeys = [DeviceColumn(d, v, k.dtype)
                         for d, v, k in zip(bkdatas, bkvalids,
                                            node.right_keys)]
                pkeys = J.probe_key_columns(node, pex, bkey_dicts)
                phash, pvalid = J.hash_valid_keys(pkeys, pex.mask)
                out, overflow, _bm = J.expand_probe(
                    node, pex, build, sorted_hash, border, phash,
                    pvalid, pkeys, bkeys, mm, None)
                if kinds_collapse:
                    oex = J.collapse_semi_anti(node, pex, out.mask, mm)
                else:
                    oex = out
                payload, out_seens = chain(oex, seens, carry)
                if carry is not None:
                    # an overflowed batch re-runs with more lanes: its
                    # partial result must not reach the carry, which the
                    # captured step writes back in place
                    payload = _keep_on(overflow, carry, payload)
                return payload, out_seens, overflow

        return _join_probe_step

    def _execute_join_fused(self, build, bstate, first, probe_iter):
        M.fusion_exec.inc(mode="fused")
        self.last_stats["mode"] = "fused"
        sorted_hash, border, bvalid, bkeys, build_key = bstate
        node = self._agg_op.node if self._agg_op is not None else None
        grouped = self._terminal == "agg_grouped"
        nkeys = len(node.group_keys) if grouped else 0
        key_dicts: List[Optional[list]] = [None] * nkeys
        bschema = tuple((nm, c.dtype)
                        for nm, c in build.batch.columns.items())
        device = first.device
        mm = self._join.max_matches
        carry = None
        if self._terminal == "topk":
            carry = self._init_topk_carry(device)
        seens: tuple = self._zero_seens(device)
        trace_sizes: object = ()
        build_args = (tuple(c.data for c in build.batch.columns.values()),
                      tuple(c.validity
                            for c in build.batch.columns.values()),
                      build.batch.n_rows.to(torch.int32), build.mask,
                      sorted_hash, border,
                      tuple(k.data for k in bkeys),
                      tuple(k.validity for k in bkeys))
        batches = itertools.chain([first], probe_iter)
        for ex in batches:
            envs = self._dict_envs(ex.dicts)
            sizes = None
            flags = None
            if grouped:
                for i, k in enumerate(node.group_keys):
                    d = FF._static_dict(k, envs[-1])
                    if d is not None:
                        key_dicts[i] = d
                sizes = self._sizes(envs[-1])
                if trace_sizes == ():
                    trace_sizes = sizes
                if sizes is None or sizes != trace_sizes:
                    M.fusion_exec.inc(mode="degraded")
                    self.last_stats["mode"] = "degraded"
                    # same build-state handoff as the execute() ladders
                    self._join._prepared_build = (
                        build, sorted_hash, border, bvalid, bkeys,
                        list(self._bkey_dicts))
                    yield from self._degrade_join_grouped(
                        self._carry_out(carry), trace_sizes, key_dicts,
                        build, ex, batches)
                    return
                flags = self._lane_flags()
                if carry is None:
                    carry = self._init_grouped_carry(sizes, device)
            M.fusion_batches.inc()
            trig = tuple((nm, c.dtype)
                         for nm, c in ex.batch.columns.items())
            while True:
                key = self._probe_runtime_key(ex, envs, mm, build_key,
                                              (sizes, flags))
                entry = FF.CACHE.entry(key)
                if keyaudit.armed():
                    deps = self._audit_deps(envs, [], [],
                                            (sizes, flags), device)
                    deps["keydict_content"] = tuple(
                        (tuple(str(s) for s in bd)
                         if bd is not None else None,
                         tuple(str(s)
                               for s in O._expr_dict(k, ex) or ())
                         if k.dtype.is_varlen else None)
                        for k, bd in zip(self._join.node.left_keys,
                                         self._bkey_dicts))
                    deps["max_matches"] = mm
                    keyaudit.audit("vm/fusion_join.py:joinprobe", key,
                                   deps)
                slot = self._slot(carry)
                fn = entry["fn"].get(slot)
                if fn is None:
                    fn = self._make_probe_step(trig, bschema, sizes,
                                               flags, envs, mm)
                    entry["fn"][slot] = fn
                args = ((tuple(c.data
                               for c in ex.batch.columns.values()),
                         tuple(c.validity
                               for c in ex.batch.columns.values()),
                         ex.batch.n_rows.to(torch.int32), ex.mask)
                        + build_args
                        + (self._lifted_values([]), seens, carry))
                out, graphed = self._run(entry, slot, fn, args,
                                         self._carry_index(carry, 14),
                                         stable=range(4, 12))
                payload, new_seens, overflow = out
                if not bool(overflow):
                    seens = new_seens
                    break
                # duplicate fan-out past the lane budget: re-run the
                # SAME batch with doubled lanes (the JoinOp ladder)
                mm *= 2
            if self._terminal == "stream":
                if graphed:
                    payload = FF._clone_tree(payload)
                yield self._stream_batch(ex, payload, envs)
            else:
                carry = payload
            if self._limits_satisfied(seens):
                if hasattr(probe_iter, "close"):
                    probe_iter.close()
                break
        if self._terminal == "stream":
            return
        if self._partial_wanted():
            self._keep_partial(carry, trace_sizes, key_dicts)
            return
        carry = self._carry_out(carry)
        if self._terminal == "topk":
            yield self._finalize_topk(carry)
            return
        yield self._finalize_agg(carry, trace_sizes, key_dicts)

    def _degrade_join_grouped(self, carry, sizes, key_dicts, build, ex,
                              rest):
        """A group-key dictionary grew mid-probe-stream (or the key
        space was never dense): convert the fused partials into a
        general group-table state and continue on the ORIGINAL JoinOp
        -> chain, seeded."""
        agg = self._agg_op
        agg._agg_tracker = O._AggDictTracker(agg.node.aggs)
        seed = None
        if carry is not None:
            dense = self._grouped_partials(carry, sizes)
            seed = agg._dense_to_state(dense)
        join = self._join
        node = join.node
        saved_l, saved_r = join.left, join.right
        join.right = _IterSource([build], iter(()), node.right.schema)
        join.left = _IterSource([ex], rest, node.left.schema)
        rewire = self._orig_bottom if self.stages else agg
        saved_child = rewire.child
        rewire.child = join
        try:
            if self._partial_wanted():
                self._partial[0] = agg.partial_state(seed=seed,
                                                     seed_dicts=key_dicts)
                return
            yield from agg._grouped_agg(seed=seed, seed_dicts=key_dicts)
        finally:
            join.left, join.right = saved_l, saved_r
            rewire.child = saved_child
