"""Full-text top-k scan operator (reference: table_function/fulltext +
vectorindex-style candidate fetch).

The port of `matrixone_tpu/vm/fulltext_scan.py`: the BM25 scores of the
query's terms are summed on the index's device (`fulltext.search`), the
top `k + offset` documents come back to the host, and their rows are
fetched by row id and re-enter the pipeline on the context's device.

Semantics kept from the unrewritten plan: ORDER BY score DESC LIMIT k
returns up to k rows INCLUDING zero-score rows when fewer than k
documents match (MySQL ORDER BY does not filter), and OFFSET is applied
here because this operator replaces the whole Project+TopK subtree.  A
commit into the table marks the index dirty; the next query rebuilds it
lazily (`indexing.refresh_if_dirty`).  The zero-score fill reads the
table's row ids from the host tier.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.storage.engine import ROWID
from matrixone_tpu_torch.vm.exprs import ExecBatch
from matrixone_tpu_torch.vm.operators import Operator, chunk_to_execbatch


class FulltextTopKOp(Operator):
    def __init__(self, node: P.FulltextTopK, ctx):
        self.node = node
        self.ctx = ctx
        self.schema = node.schema

    def _visible(self, table, gids: np.ndarray) -> np.ndarray:
        read_args = self.ctx.table_read_args(self.node.table)
        return table.visible_gids(
            gids, snapshot_ts=self.ctx.snapshot_ts,
            extra_deletes=read_args.get("extra_deletes"))

    def execute(self) -> Iterator[ExecBatch]:
        from matrixone_tpu_torch import fulltext as FT
        from matrixone_tpu_torch import indexing
        catalog = self.ctx.catalog
        ix = catalog.indexes[self.node.index_name]
        indexing.refresh_if_dirty(catalog, ix, self.ctx.device)
        catalog.index_cache.touch(ix)
        index = ix.index_obj
        row_gids = np.asarray(ix.options["_row_gids"])
        table = catalog.get_table(self.node.table)

        want = self.node.k + self.node.offset
        scores, pos = FT.search(index, self.node.query,
                                k=min(max(want * 2, want), index.n_docs))
        hit = scores > 0
        scores, pos = scores[hit], pos[hit]
        gids = row_gids[pos] if len(pos) else np.zeros(0, np.int64)
        alive = np.isin(gids, self._visible(table, gids)) if len(gids) \
            else np.zeros(0, bool)
        gids, scores = gids[alive], scores[alive]
        if len(gids) < want:
            # fill with zero-score rows: ORDER BY must not drop rows
            all_gids = [arrays[ROWID] for arrays, _v, _d, _n in
                        table.iter_chunks(
                            [ROWID], 1 << 20,
                            **self.ctx.table_read_args(self.node.table))]
            if all_gids:
                rest = np.setdiff1d(np.concatenate(all_gids), gids)
                fill = rest[:want - len(gids)]
                gids = np.concatenate([gids, fill])
                scores = np.concatenate(
                    [scores, np.zeros(len(fill), np.float32)])
        gids = gids[self.node.offset:want]
        scores = scores[self.node.offset:want]

        raw_cols = sorted({spec[1] for spec in self.node.out_exprs
                           if spec[0] == "col"})
        arrays, validity = table.fetch_rows(gids, raw_cols)
        # assemble under RAW column names (dicts are raw-keyed), then let
        # chunk_to_execbatch rename to the output schema
        score_key = "__ft_score"
        arrays[score_key] = scores.astype(np.float64)
        validity[score_key] = np.ones(len(gids), np.bool_)
        columns = [spec[1] if spec[0] == "col" else score_key
                   for spec in self.node.out_exprs]
        yield chunk_to_execbatch(arrays, validity, table.dicts, len(gids),
                                 columns, self.node.schema,
                                 self.ctx.device)
