#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`matrixone_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 1M x 768, 1024 queries

Phases, each of which raises on failure:

 1. environment: torch/CUDA versions, the card's name and power limit,
    and the build of every CUDA kernel from `matrixone_tpu_torch/csrc/`;
 2. every kernel against its plain PyTorch version (in float64) at edge
    shapes (the L2 kernel, its masked form, the ADC kernel's dense form,
    and its list form against the dense form on the padded gather, bit
    for bit), then, in phases 3 and 4, at every shape each path launched
    it with, on that path's own inputs; each timed with CUDA events
    (device time: the timed calls are queued behind a sleep so the card
    runs them back to back) beside the plain version, one library call
    and the bound (for the L2 kernels two bounds: three TF32 products on
    the tensor cores, as the kernel runs them, and f32 on the CUDA
    cores; for the ADC list form the bytes its lists hold), the L2
    kernels also launched twice on the same inputs for the same bits;
 3. the serving path at the full shape of the IVF-Flat benchmark.  The
    exact truth and each path below get their own launch counts, set to
    0 just before and read just after; a path that launched no kernel
    fails:
    a. `ivf_flat.build`/`search` in the benchmark's configuration
       (recall@20 against exact brute-force truth >= 0.80);
    b. `WorkerCore.load_index`/`search_index`, sequential and from 8
       threads through the micro-batcher: recall against the exact
       top-20 of each query's probed lists, scored in f64 from what the
       index stores with the search's own formula, >= 0.99 (the score
       stage loses no neighbour the probe found); threaded recall within
       0.005 of sequential; the recall against the probed lists' original
       f32 rows is recorded beside it (the loss of bf16 storage);
    c. `rerank_exact`, bit-identical to a numpy f64 left-fold oracle;
    d. the worker's sharded and replicated modes over b's index on 8
       slots of the card (`WorkerCore.serve_index`, no second build):
       the ids of every query equal the single index's after the exact
       re-rank, recall@20 equal, every L2 launch held against its plain
       version, QPS of each mode;
 4. IVF-PQ at `bench.py`'s IVF-PQ configuration, on the same data,
    queries and truth: the build and one search run of all queries each
    counted (the search must launch the ADC kernel's list form and the
    L2 kernel, and never the dense form on a padded gather); the list
    form at each path shape on the search's own inputs against the dense
    form on the padded gather and f64, timed beside that padded path;
    the search's ids and distances equal to its former padded-gather
    path's, both run side by side and profiled; probed-list
    ADC recall against an f64 host oracle >= 0.99; recall@20 against the
    exact truth and after `rerank_exact` of a k = 100 pool, recorded
    without a gate (on this data the PQ error of the reference design
    exceeds the gaps between neighbours); the JAX package's own recall
    bars (raw ADC >= 0.40, re-ranked >= 0.85) on its own test data and
    configuration; warm QPS, build seconds by stage, index bytes and
    peak device memory.

 5. the relational path at TPC-H scale factor 1, through the SQL
    executor (`Session.execute`, the reference's per-operator path):
    a. load lineitem (6,000,000 rows), orders (1,500,000) and customer
       (150,000) with the repository's generator, and a table v (id,
       grp = id % 1000, xi integer-valued in [0, 16), xn N(0,1), all
       float32) of 6,000,000 rows; load seconds and host bytes;
    b. TPC-H Q3 from SQL text: rows exactly `q3_oracle`'s; the sorted-
       search kernel (every hash-join probe) must launch on the counted
       warm run; cold time, best of 3 warm runs as lineitem rows/s, one
       profiled run;
    c. `select grp, sum(xi), sum(xn) from v group by grp order by grp`:
       1000 rows, sum(xi) exact, sum(xn) within rtol 1e-4 / atol 1e-3 of
       an f64 sum; the segment-sum kernel must launch at G = 4096 on the
       counted warm run; times and a profile as in b;
    d. both kernels re-checked and timed at every shape b and c launched
       them with, on the inputs those paths handed them; the segment sum
       also over copies of its input set larger than the L2 together
       (`ms_l2_cold`), with one call profiled (its own kernel only, no
       memset), and the share of its launches that took the 16-byte walk.
   Phase 2 also holds the two relational kernels against their plain
   versions at edge shapes (bit for bit for the search, with its sample
   tree's edges: n about the sample count, runs of equal keys across a
   sample, 0 and 2^64 - 1, n = 2^22; the segment sum also on skewed,
   unaligned, out-of-range and NaN/inf inputs, every shape launched twice
   for the same bits).

 6. all of TPC-H through the same executor:
    a. Q1 and Q6 on phase 5's SF1 lineitem (no second load): Q1 held
       to `q1_oracle` on the engine's exact values by `q1_exact` (each
       sum's scaled int64 and each count equal, the averages within
       `q1_check`'s bounds); `q1_check` itself is only recorded, and
       reads false at SF1, because it reads the sums as floats and
       sum_charge x 10^6 is past 2^53 there; Q1's grouped
       aggregate takes the dense small-key path (the AggOp's
       `agg_chunks` counter: every chunk dense, none general); Q6
       equals its integer oracle; cold seconds, the best of 3 warm runs
       as lineitem rows/s, the kernels each launched (expected none:
       no join, and Q1's decimal lanes are int64) and the device's busy
       share of one profiled run, beside Q3's; Q1's dense lane partials
       on the card against the CPU, whose f64 lanes must give the same
       bits on 5 launches;
    b. the 22 queries of `utils/tpch_full.py` at scale factor 0.1
       (lineitem 600K rows): each held to the sqlite3 oracle by
       `run_compare` on its cold run and again on its counted warm run;
       per query the best of 3 warm seconds, the sorted-search and
       segment-sum launches of the counted run and the busy share; the
       sorted search re-checked bit for bit at every shape the 22
       launched it with, on their own inputs, and timed at the most
       launched one.

 7. the write path: TPC-H's refresh functions (`tpch_full.rf1`, `rf2`:
    SF x 1500 orders with their lineitems inserted, then as many
    deleted, each as SQL text in one transaction) through
    `Session.execute`:
    a. on 6b's session and sqlite3 connection: RF1, the 22 each equal
       to sqlite3 (`run_compare`, the sorted-search and segment-sum
       launches of each counted by shape and their inputs captured),
       RF2, the 22 again; after each, both kernels held against their
       plain versions at every shape the 22 launched them with, on those
       inputs (the search timed at its most launched shape); a second
       RF1 rolled back (Q1 and Q3 unchanged); a live key inserted again
       (DuplicateKeyError at COMMIT, nothing changed); an order RF2
       deleted inserted again with its lineitems (accepted, Q3 equal to
       sqlite3);
    b. on phase 5's SF1 tables, with a second session's transaction
       open across the refresh: RF1 and RF2 (rows written a second;
       RF1's primary-key checks' seconds, the bloom filter's suspects);
       Q1, Q3 and Q6 exact to oracles of the refreshed arrays, each as
       in 5b/6a (cold, counted, best of 3 warm, profiled); the open
       transaction still reads the old Q3 and row counts, and the new
       ones after its COMMIT; `CREATE SNAPSHOT s`, an UPDATE of 6000 v
       rows, the float GROUP BY against an f64 sum of the updated arrays
       (the segment sum must launch), and v joined with its snapshot
       (3M rows a side; count and the sum of the differences exact to
       the UPDATE; the sorted search must launch); both kernels held
       against their plain versions at every shape 7b launched them
       with, on its own inputs.

 8. the rest of the executor on phase 5's SF1 tables, read-only (so it
    runs before phase 7 changes them), each query as SQL text through
    `Session.execute` with its cold seconds, the best of 3 warm runs as
    rows/s of the tables it scans, the kernels' launches of the counted
    run by shape and one profiled run:
    a. FULL OUTER of the orders with a returned line and those with a
       line shipped after 1995-06-17 (TPC-DS q97's three classes): equal
       to numpy set arithmetic; the sorted search must launch;
    b. rank() over orders by customer (150K partitions, past the
       window's max_partitions), the first orders counted by year exact
       to a lexsort oracle; a running sum, a 10-row moving average and
       maximum over all of v: sums and maxima exact, averages within
       rtol 1e-4 / atol 1e-3 of f64;
    c. 5c's GROUP BY over a UNION ALL of v's two halves, with 5c's gates
       and the segment sum at G = 4096; a UNION of c_mktsegment and
       l_returnflag (two dictionaries), exact;
    d. SAMPLE 10 PERCENT of lineitem equal to a replay of the draws (the
       plan's seed, the scan's padded lengths) and within 5 sigma of
       10%; SAMPLE 1000 ROWS of v the replay's rows; time_bucket groups
       exact to numpy;
    e. a comma join and a non-equi join of 2000 customers and 4096
       orders: counts exact;
    then both kernels held against their plain versions at every shape
    phase 8 launched them with, on phase 8's own inputs.

 9. the fused fragments (fusion on, default knobs: each step one CUDA
    graph, replayed once per batch), after phase 8 and before phase 7
    writes; phases 5-8 run with `plan_fusion = 0`.  Each path's cold
    run, counted warm run (captures, replays, batches, exec modes, peak
    device memory), best of 3 warm runs and one profiled run:
    a. Q3 (probe fragments), Q1 (dense grouped terminal, at most one
       replay a batch), Q6 (scalar terminal) at SF1, each exact to its
       oracle and equal to the per-operator rows of this run; 5c's
       GROUP BY (integer key) not fused; an f32 sum under a varchar key
       with the default MO_NARROW_ENCODINGS (bf16 lanes on the card)
       within the reference's 0.4% of the f64 sums and off them by more
       than 1e-4, and with MO_NARROW_ENCODINGS=0 equal to the
       per-operator rows;
    b. 8b's rank() (a window fragment) and an ORDER BY .. LIMIT top-k
       over lineitem, exact to numpy;
    c. the 22 at SF 0.1, each equal to sqlite3 and to 6b's rows;
    d. the sorted search inside Q3's captured probe graphs, bit for bit
       against its plain version on each replay's inputs;
    e. 9a's Q3, Q1 and Q6 again after the 22 without clearing the
       fragment cache: beside each query's own graphs, the cached graphs
       hold no more than the cache's byte bound (an eighth of the card).
    In 9c the queries with a decorrelated subquery (Q2, Q4, Q17, Q20,
    Q21, Q22) capture nothing on their warm runs.

10. spills and storage, after phase 9 and before phase 7 writes, on all
    of TPC-H at SF1 (`tpch_full.load_tpch`, lineitem 6M rows) in an
    engine of its own, freed after; the host library
    (`matrixone_tpu_torch/native`) must be the compiled one.  Each path
    runs fused (default knobs) and per-operator (`plan_fusion = 0`):
    a counted first run (spill counters: partitions, bytes, seconds
    partitioning, writing and replaying; kernel launches by shape with
    their inputs captured; peak device memory) and `SPILL_WARM_RUNS`
    warm runs, every run's rows checked:
    a. Q21 with the default join budget (it must spill) and with one
       past its largest build (it must not): the same rows;
    b. 5c's float GROUP BY over v's values under 4096 groups with the
       AggOp's budget cut to 256 / 1024 groups in 8 partitions (it must
       spill): sum(xi) exact, sum(xn) within rtol 1e-4 / atol 1e-3 of
       f64 and of the unspilled run; GROUP BY l_orderkey (1.5M groups)
       through 2^18 groups (it must spill): equal to the unspilled run;
    c. orders partitioned by year of o_orderdate: one year's count and
       sum of o_totalprice equal numpy's and the unpartitioned table's,
       and its scan reads one segment and prunes the others;
    then both kernels held against their plain versions at every shape
    the spilled runs launched them with, on their own inputs.

11. storage with objects, last (its tables are its own): phase 5's
    SF1 tables (regenerated from the same seed) loaded into
    `Engine(LocalFS(tmp))`, checkpointed to the port's objects and
    demoted (`checkpoint(demote=True)`, as `bench.py` runs Q1 and Q3:
    every segment must be object-backed), the block cache's budgets
    sized to the working set; each query's cold run starts from an
    empty cache (the scan's read-ahead thread on), then a counted warm
    run and 3 warm runs that must be served by the device tier (hit
    rate >= 99%, 0 bytes uploaded), each run checked:
    a. Q3 fused (its steps capture while the read-ahead runs) and
       per-operator, exact to `q3_oracle` and to each other; load,
       checkpoint and object bytes, decode seconds, busy share and the
       host-to-device copies of one profiled run;
    b. Q1 (dense path on every chunk), Q6 and 5c's GROUP BY, under 6a's
       and 5c's gates;
    c. `Engine.open` of the directory (Q3 equal), RF1 and RF2 as 7b
       runs them, a second restart from the checkpoint and the WAL tail
       alone (Q1 and Q3 exact to oracles of the refreshed arrays), then
       `merge_table` of lineitem and orders: Q1 again, and Q1 AS OF a
       timestamp before the merge equal to the same read before it;
    then both kernels held against their plain versions at every shape
    11a and 11b launched them with, graph replays included.
12. the serving and operations surface, over phase 11's object-backed
    tables between 11b and 11c (`phase_serving`):
    a. `bench.py`'s `bench_serving` workload: 8 point queries
       (`l_orderkey = ?`) and Q1 a pass, cold (both caches off), plan
       cache only and warm (plan and result caches); each pass's qps,
       the hit rates and p50/p99 from `query_seconds`; every row equal
       to the uncached run's and to the oracles, the plan-only hit rate
       at least 0.9;
    b. Q3 (market segment a parameter) and 5c's GROUP BY (a lower bound
       on id) through the plan cache's reused operator tree, fused and
       per-operator, 3 values each: exact to `q3_oracle` for each
       segment and to 5c's oracle, the tree taken twice; warm best with
       the plan cache on and off; both kernels held against their plain
       versions at every shape 12b launched them with, graph replays
       included;
    c. one traced warm run each of Q1, Q3 and Q6: milliseconds by span
       name and the device's busy share from one profiler trace;
    d. four threads, each its own session, on fused Q3 with the result
       cache off: every result equal to the serial run's, nothing run
       eagerly;
    e. EXPLAIN ANALYZE of Q3; an `object.read` fault on a cold scan
       raises, and the next Q1 is exact.
13. vector search through SQL, last, in an engine of its own, at
    bench.py's configuration: 1M x 768 rows of the clustered recipe
    (`datagen.make_clustered`, `--seed`) loaded with `insert_numpy`,
    `lists = 1024`, `ivf_nprobe` 8, `limit 20`, 64 queries:
    a. `create index ... using ivfflat` (seconds, the index's bytes in
       the `IndexCache`); the plan holds VectorTopK and no Scan; a
       counted pass and a timed pass of the 64 statements (the busy
       share from a trace of 4 more): each query's VectorTopK
       candidates (20 x the planner's overfetch of 3) equal to the
       exact top over its 8 probed lists scored in f64 from what the
       index stores (`probed_truth_stored`; rows within the L2
       kernel's error bound of the cut may swap), and its rows equal,
       ids and distances, to an f64 re-rank of its candidates, in both
       passes; recall@20
       against the exact scan of the same session (a transaction: the
       planner skips the index); three warm runs capture no graph;
    b. upkeep: 100 rows inserted near a centre are served from the
       delta of the same index (the L2 kernel scores them), deleted
       they are gone, an insert past `RECLUSTER_FRACTION` reclusters,
       `fold_delta` folds a second delta in, and an index evicted under
       a small `IndexCache` budget frees its card memory and is rebuilt
       by the next query;
    c. `using ivfpq` (96 subspaces, `pick_subspaces`) on a second table
       of the same rows: candidates (x 3 again) equal to
       `pq_probed_truth`'s over the probed lists, rows as in a; recall
       before and after the overfetch's exact re-rank, recorded without
       a gate;
    d. the L2 kernel and the ADC kernel's list form against their plain
       versions at every shape 13a-13c launched them with, on the
       paths' own inputs, timed at each;
    e. (after a) `SET ivf_shards = 8` on 8 slots over a's index (its
       cluster-sharded repack cached on the index, no second build): the
       64 statements' rows equal a's, every L2 probe launch held, ms a
       statement.
14. HNSW, full text and `llm_embed` through SQL, last, each in an engine
    of its own, with default knobs; every kernel's launches counted in
    each part (the path launches none of the five):
    a. `create index ... using hnsw m = 16 ef_construction = 64` over
       `HNSW_ROWS` rows of 13's recipe (a cut of its 1M: the native
       build is single-threaded host C++) on the host library's graph
       (`native.route()` must be "c"); the plan holds VectorTopK and no
       Scan; 64 statements, each timed: its candidates equal the
       graph walk's, its 20 rows an f64 re-rank of them (ids and
       distances); recall@20 against an exact f64 scan >= 0.80; three
       warm runs capture no graph; build seconds, p50/p99, busy share;
    b. `create index ... using fulltext` over 100,000 documents of
       40-120 tokens drawn Zipf(1.1) from a 30,000-word vocabulary made
       from `--seed` (build seconds by stage: the host read, tokenizing,
       the CSR arrays, the upload; the postings' bytes on the card); 64
       `order by match(body) against (...) desc limit 10` statements of
       1-3 terms of ranks 10-5,000: the plan holds FulltextTopK and no
       Scan; each statement's rows equal an f64 BM25 oracle's top 10
       over the index's own arrays (ties to the lower position; rows
       within rtol 1e-5 of the oracle's score at their rank may swap),
       scores within rtol 1e-5; p50/p99, busy share;
    c. 1,000 documents with a term new to the corpus inserted: the next
       statement rebuilds the index and finds them; deleted, and the
       index evicted under a small budget, it frees >= 90% of its bytes,
       the next statement rebuilds it to 14b's rows and the deleted
       documents are gone (one rebuild for both: a cut, PERF.md);
    d. `select id, llm_embed(txt)` over 100,000 rows holding 512 distinct
       texts against a loopback endpoint served from a thread of this
       script: exactly 512 calls, every row the endpoint's vector for
       its text.
15. ingest, last, in a durable `Engine(LocalFS(tmp))` of its own, with
    default knobs: TPC-H's bulk load of customer (150,000 rows) and
    orders (1,500,000) at SF1 (phase 10's generator arrays):
    a. both tables written as CSV files (a header, RFC 4180 quoting,
       DECIMAL with 2 places, ISO dates) and a note file; their bytes;
    b. `create stage tpch url = 'file://<dir>'`, the two tables with
       `tpch_full`'s schemas and keys, and `load data infile
       'stage://tpch/<t>.csv' into table <t>`: `affected` the row count,
       every column read back through the engine equal to the
       generator's array; parse, ingest and commit seconds, MB/s, rows/s;
    c. the segments' orders and o_totalprice (`INGEST_JOIN_SQL`) on the
       card, exact to numpy (the sum as the scaled int64); cold, counted
       (the sorted search must launch; nothing captured) and best of 3
       warm seconds, the busy share of one trace; every sorted search
       held bit for bit to its plain version on its own inputs, graph
       replays included, timed at the most launched shape;
    d. the same over `create external table orders_x ... location
       'stage://tpch/orders.csv'`: one parse in all its runs (the
       decoded-chunk cache serves the rest), an INSERT refused;
    e. `Engine.open` of the directory: the stage, orders_x, and orders'
       count and sum as loaded; its seconds;
    f. `begin`, a LOAD into a copy of customer, `rollback`: 0 rows;
    g. `load_file` of the note through the stage, the scrape text
       (`tools/moscrape.render_text`, holding
       `mo_query_duration_seconds`) and the trace smoke
       (`tools/motrace.run_smoke` on the card) ok.

16. materialized views, UDFs and the padding canary, last, in an
    in-memory engine of its own with default knobs, over phase 5's SF1
    generator arrays (lineitem 6M, orders 1.5M, customer 150K, v 6M and
    a copy of v without a view): a dashboard over a fact table kept
    current by TPC-H's refresh functions.
    a. `create materialized view mv_q1 as` Q1 (the dense tier) and mv_v
       (`MV_V_SQL`: count, sum, min and max of v's f32 xn by its integer
       grp; the general tier): mv_q1 exact to `q1_oracle`'s scaled
       int64, mv_v within 5c's tolerance of an f64 numpy oracle with
       counts, min and max exact; the segment sum launched in mv_v's
       first computation; the init seconds;
    b. RF1 then RF2 (`tpch_full.rf1`/`rf2` at SF1), the UPDATE and the
       DELETE on v (MIN/MAX recompute: the segment sum launches again),
       200 single-row commits into v and 200 into v_copy: after RF1, RF2,
       the UPDATE, the DELETE and every 50th single-row commit each view
       equals its defining SELECT run fresh in the same engine (mv_q1
       also `q1_oracle` of the refreshed arrays); one dense step and ONE
       graph replay per lineitem delta (`mo_mview_apply{tier=dense}` =
       the lineitem deltas, a capture only for a new padded shape), no
       eager dispatch; each tier's apply seconds, commit p50/p99 with the
       view and without;
    c. UDFs over v: a `jnp.exp`/`jnp.where` body in the jit tier over
       every row (within rtol 1e-9 of numpy's f64), a Python `if` body in
       the row tier over `id < 20000` (equal), an aggregate percentile
       over every row (numpy's within 1e-12); EXPLAIN's tiers; rows/s
       per tier and the jit body's achieved GB/s at 1M rows
       (`utils/roofline`);
    d. the padding canary armed (`utils/qa`): Q1, Q3 and 5c's GROUP BY
       fused, rows bit-identical to the unarmed run's and no finding;
    every segment sum and sorted search of 16a, 16b's recompute and 16d's
    armed runs held to its plain version on its own inputs, as many held
    as launched (graph replays included: a copy of the graph's own
    tensors after each replay; `PathInputs` in `every`): the sorted
    search bit for bit, the segment sum as `segment_sum_agrees` holds it
    (bit for bit where its values are integer-valued and every group's
    sum of |v| stays below 2^24, else within rtol 1e-4 / atol 1e-3 of the
    f64 plain sum: the plain version's `index_add_` adds in no fixed
    order on the card; NaN and infinities in the same groups), the same
    bits on a second launch; each timed at its most launched shape.

17. sharded SQL (`SET query_shards`), after phase 10 and before phase 7,
    on 8 slots laid on the one card (`parallel/mesh.simulated_slots`),
    default knobs, `batch_rows` 375,000 (bench.py's n // 16): each
    statement's counted run traced (for each sharded fragment one
    `shard.exec` span, one `shard.partial` span per shard and one merge
    counted; Q18's IN subquery is a fragment of its own), every sorted
    search and segment sum held against its plain version (graph replays
    included, `PathInputs` in `every`); warm seconds local and sharded:
    a. over phase 5's arrays in an engine of its own: Q3 at 2, 4 and 8
       shards, its rows `q3_oracle`'s and the local run's; Q1 at 8 (the
       dense psum merge), the local rows; 5c's GROUP BY at 8 within rtol
       1e-4 / atol 1e-3 of the local run and f64; and over phase 10's
       TPC-H tables lineitem joined to orders on the order key, grouped
       by o_orderpriority: EXPLAIN's exchange=shuffle, rows shuffled,
       the local rows;
    b. a copy of orders `PARTITION BY HASH(o_custkey) SHARDS 8`, grouped
       by o_custkey at 8: exchange=local, 0 rows shuffled, the local rows;
    c. Q5, Q9 and Q18 at 8 over phase 10's tables: the local rows (as a
       multiset; whether their order matched is recorded).

18. host peers (`parallel/fragments.py` over `cluster/`), after phase
    17, default knobs (fused):
    a. PEERS (4) `FragmentServer`s in this process over phase 10's SF1
       engine with phase 5's v loaded beside it, `dist_min_rows` 0 and
       `dist_batch_rows` PEER_BATCH_ROWS (262,144: 5-6 of lineitem's
       chunks a peer): TPC-H Q1, Q3, Q6, Q10, Q18 (the JAX package's
       distributed set), 5c's f32 GROUP BY and lineitem joined to orders
       as a shuffle join.  The peers' rows equal the local run's (Q1's
       decimals also exact to an int64 oracle; 5c within rtol 1e-4 /
       atol 1e-3 of the local run and of f64; the shuffle join as a
       multiset); 4 fragments for each distributed aggregate or top-k
       (Q18: 8), 12 for the shuffle; every sorted search and segment sum
       the peers launched held against its plain version (graph replays
       included, `PathInputs` in `every` on every peer's thread);
       seconds local and on the peers, bytes on the fabric, rows pushed,
       graph captures and spares recorded;
    b. one peer stopped: the next statement runs locally, the same rows;
    c. a `TNService` and two `RemoteCatalog` CNs in this process on a
       LocalFS directory: TPC-H at SF 0.1 loaded through CN 1 (rows/s;
       the same tables as 6b's), the 22 on CN 2 against sqlite3's
       answers from 6b, RF1 and RF2 through CN 1 with Q1 and Q3 on CN 2
       after each against a copy of 6b's sqlite3 database, a view of
       Q1 made through CN 1 and maintained by the TN read fresh on CN 2
       after RF1, Q3 and Q18 on both CNs' fragment servers equal to CN
       2's local rows (every launch there held against its plain
       version, as in a), and the logtail's lag from a commit to CN 2's
       applied position (p50/p99);
       every thread of the services joined at their stop.

The second-to-last line of output is the kernels' JSON record and the
last is {"ok": true, "device": {...}}.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# utils/roofline.py holds them
try:
    from matrixone_tpu_torch.utils.roofline import (  # noqa: F401
        H100_F32_FLOPS, H100_HBM_BYTES_S, H100_L2_BYTES, H100_TF32_FLOPS)
except ImportError:     # outside a checkout: main() says so and exits
    pass

K = 20
NPROBE = 8
BATCH = 256
QUERY_CHUNK = 64
TRUTH_CHUNK = 65536
INF = float("inf")


def log(*a):
    print(*a, flush=True)


class DeviceMs(float):
    """A time in milliseconds, with `queued`: whether the timed calls ran
    back to back on the card (True) or the reading includes the host's
    gaps between them (False)."""
    queued = True


def cuda_time_ms(fn, warm: int = 3, iters: int = 20) -> DeviceMs:
    """Device milliseconds a call of `fn`, the mean of `iters` warm calls
    timed with CUDA events.  The calls are queued behind a sleep on the
    stream, long enough for the host to enqueue them all, so the card runs
    them back to back and the events time the card, not the host's
    launches.  A call that synchronises the host defeats that: after four
    ever longer sleeps the reading is returned with `queued` False, and
    the rows that carry it say so."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / warm
    torch.cuda.synchronize()
    for attempt in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # about 2e9 sleep cycles a second on an H100
        torch.cuda._sleep(int((1.5 * host_s * iters * 2 ** attempt
                               + 50e-6) * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()      # the card was still asleep
        torch.cuda.synchronize()
        if queued:
            break
    out = DeviceMs(start.elapsed_time(end) / iters)
    out.queued = queued
    if not queued:
        log(f"[timing] {out:.4f} ms: the calls were not queued, the "
            f"reading includes the host's gaps")
    return out


def all_queued(row: dict) -> bool:
    """Whether every time in a row was taken with its calls queued."""
    return all(getattr(v, "queued", True) for v in row.values())


def l2_bound(n: int, b: int, d: int, extra_bytes: int = 0):
    """The least time of one fused L2 call (`extra_bytes`: a mask's) ->
    (ms, 'bytes'|'operations', f32_ms, f32_by): first for the f32-
    accurate product as the kernel runs it, three TF32 products on the
    tensor cores; then for IEEE f32 on the CUDA cores."""
    t_bytes = (4.0 * (n * d + b * d + n * b) + extra_bytes) \
        / H100_HBM_BYTES_S
    out = ()
    for ops in (3 * 2.0 * n * b * d / H100_TF32_FLOPS,
                2.0 * n * b * d / H100_F32_FLOPS):
        out += (max(ops, t_bytes) * 1e3,
                "operations" if ops >= t_bytes else "bytes")
    return out


def l2_timing(row: dict) -> str:
    """The [kernel] line's tail: the share of each bound reached, and
    the ratio to the library call."""
    return (f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, 3xTF32, "
            f"{row['bound_ms'] / row['ms']:.0%}) "
            f"f32_cores_bound_ms={row['bound_f32_cores_ms']:.4f} "
            f"({row['bound_f32_cores_by']}, "
            f"{row['bound_f32_cores_ms'] / row['ms']:.0%}) "
            f"x_library={row['ms'] / row['library_ms']:.2f}")


def l2_bits_repeat(torch, CK, name: str, first, launch) -> None:
    """A second launch on the same inputs must give the same bits."""
    if not torch.equal(first, launch()):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ")


def check_kernel(torch, CK, name: str, x, q) -> dict:
    """The L2 kernel on x [n, d], q [b, d] against its plain version in
    float64 (|err| <= 1e-5*(x2+q2) + 1e-4), timed warm beside the plain
    version in f32 (TF32 off) and cuBLAS f32 `x @ q.T`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (n, d), b = x.shape, q.shape[0]
    q2 = (q * q).sum(dim=1)
    got = CK.l2_distance_sq(x, q, q2)
    torch.cuda.synchronize()
    x64, q64 = x.double(), q.double()
    x2_64 = (x64 * x64).sum(1, keepdim=True)
    q2_64 = (q64 * q64).sum(1)
    ref = CK.l2_distance_sq_plain(x64, q64, q2_64)
    err = (got.double() - ref).abs()
    tol = 1e-5 * (x2_64 + q2_64[None, :]) + 1e-4
    if got.shape != (n, b) or not bool(torch.isfinite(got).all()) \
            or bool((err > tol).any()):
        raise AssertionError(
            f"l2_distance_sq {name} {n}x{b}x{d}: max err "
            f"{float(err.max())} exceeds 1e-5*(x2+q2)+1e-4")
    l2_bits_repeat(torch, CK, f"l2_distance_sq {name}", got,
                   lambda: CK.l2_distance_sq(x, q, q2))
    ms = cuda_time_ms(lambda: CK.l2_distance_sq(x, q, q2))
    plain_ms = cuda_time_ms(lambda: CK.l2_distance_sq_plain(x, q, q2))
    lib_ms = cuda_time_ms(lambda: torch.mm(x, q.T))
    bound_ms, bound_by, f32_ms, f32_by = l2_bound(n, b, d)
    row = {"shape": name, "n": n, "b": b, "d": d,
           "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / tol).max()), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_cores_ms": f32_ms, "bound_f32_cores_by": f32_by}
    log(f"[kernel] l2_distance_sq {name:14s} n={n} b={b} d={d} "
        f"err={row['max_abs_err']:.3e} "
        f"(tol share {row['max_err_over_tol']:.3f}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} cublas_mm_ms={lib_ms:.4f} "
        f"{l2_timing(row)}")
    return row


def check_masked(torch, CK, name: str, x, q, mask) -> dict:
    """The masked L2 kernel on x [n, d], q [b, d], mask [n] against its
    plain version in float64: +inf exactly on the masked rows, elsewhere
    |err| <= 1e-5*|want| + 1e-4; an all-true mask gives the unmasked
    kernel's bits.  Timed beside the plain version in f32 and cuBLAS
    `x @ q.T` + `masked_fill_`."""
    (n, d), b = x.shape, q.shape[0]
    q2 = (q * q).sum(dim=1)
    got = CK.l2_distance_sq_masked(x, q, q2, mask)
    torch.cuda.synchronize()
    x64, q64 = x.double(), q.double()
    want = CK.l2_distance_sq_masked_plain(x64, q64, (q64 * q64).sum(1), mask)
    keep = mask[:, None].expand(n, b)
    err = (got.double() - want).abs()[keep]
    tol = (1e-5 * want.abs() + 1e-4)[keep]
    max_err = float(err.max()) if err.numel() else 0.0
    if got.shape != (n, b) or not bool(torch.isfinite(got[keep]).all()) \
            or not bool((got[~keep] == INF).all()) \
            or bool((err > tol).any()):
        raise AssertionError(f"l2_distance_sq_masked {name} {n}x{b}x{d}: "
                             f"max err {max_err} or +inf pattern wrong")
    if bool(mask.all()) and not torch.equal(got,
                                            CK.l2_distance_sq(x, q, q2)):
        raise AssertionError(f"l2_distance_sq_masked {name}: an all-true "
                             f"mask differs from the unmasked kernel")
    l2_bits_repeat(torch, CK, f"l2_distance_sq_masked {name}", got,
                   lambda: CK.l2_distance_sq_masked(x, q, q2, mask))
    ms = cuda_time_ms(lambda: CK.l2_distance_sq_masked(x, q, q2, mask))
    plain_ms = cuda_time_ms(
        lambda: CK.l2_distance_sq_masked_plain(x, q, q2, mask))
    drop = ~mask[:, None]
    lib_ms = cuda_time_ms(lambda: torch.mm(x, q.T).masked_fill_(drop, INF))
    bound_ms, bound_by, f32_ms, f32_by = l2_bound(n, b, d, extra_bytes=n)
    row = {"shape": name, "n": n, "b": b, "d": d,
           "kept": int(mask.sum()), "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_cores_ms": f32_ms, "bound_f32_cores_by": f32_by}
    log(f"[kernel] l2_distance_sq_masked {name:18s} n={n} b={b} d={d} "
        f"kept={row['kept']} err={max_err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} cublas_mm+masked_fill_ms={lib_ms:.4f} "
        f"{l2_timing(row)}")
    return row


def adc_bound(g: int, p: int, m: int, code_bytes: int):
    """(ms, 'bytes'|'operations'): the least time of one ADC call: every
    code, LUT and output byte moved once; G*P*M f32 adds."""
    t_ops = float(g) * p * m / H100_F32_FLOPS
    t_bytes = (float(g) * p * m * code_bytes + 4.0 * g * m * 256
               + 4.0 * g * p) / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_adc(torch, CK, name: str, codes, lut) -> dict:
    """The ADC kernel on codes [G, P, M], lut [G, M, 256] against its
    plain version in float64 (|err| <= 1e-5*|want| + 1e-4), timed beside
    the plain version in f32 (a few calls: it gathers [G, P, M] floats)
    and the gather-and-sum pair `lut.gather(...).sum(-1)`, two library
    calls, since no single PyTorch call computes it."""
    g, p, m = codes.shape
    got = CK.adc_score(codes, lut)
    torch.cuda.synchronize()
    want = CK.adc_score_plain(codes, lut.double())
    err = (got.double() - want).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if got.shape != (g, p) or not bool(torch.isfinite(got).all()) \
            or bool((err > 1e-5 * want.abs() + 1e-4).any()):
        raise AssertionError(f"adc_score {name} {g}x{p}x{m}: max err "
                             f"{max_err} exceeds 1e-5*|want|+1e-4")
    del want, err
    ms = cuda_time_ms(lambda: CK.adc_score(codes, lut))
    plain_ms = cuda_time_ms(lambda: CK.adc_score_plain(codes, lut),
                            warm=1, iters=3)
    flat = (codes.to(torch.int64) + 256 * torch.arange(
        m, device=codes.device)).reshape(g, p * m)
    lut_flat = lut.reshape(g, m * 256)
    lib_ms = cuda_time_ms(
        lambda: lut_flat.gather(1, flat).reshape(g, p, m).sum(-1))
    del flat
    bound_ms, bound_by = adc_bound(g, p, m, codes.element_size())
    row = {"shape": name, "G": g, "P": p, "M": m,
           "codes": str(codes.dtype).replace("torch.", ""),
           "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] adc_score {name:16s} G={g} P={p} M={m} "
        f"{row['codes']} err={row['max_abs_err']:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} gather+sum_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    torch.cuda.empty_cache()
    return row


def adc_lists_bound(rows: int, g: int, pad: int, m: int, code_bytes: int):
    """(ms, 'bytes'|'operations'): the least time of one list-form ADC
    call on these inputs: the scored rows' codes (rows = sum of the list
    lengths), the LUT and the output moved once; rows * M f32 adds."""
    t_ops = float(rows) * m / H100_F32_FLOPS
    t_bytes = (float(rows) * m * code_bytes + 4.0 * g * m * 256
               + 4.0 * g * pad) / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_adc_lists(torch, CK, name: str, codes, starts, ends, lut,
                    pad: int, timed: bool = True) -> dict:
    """The ADC kernel's list form on codes [n, M] and the lists [starts,
    ends) against its dense form on the padded candidate gather (the
    search's path before the list form): the same bits on every valid
    lane, +inf on every other; both forms within 1e-5*|want| + 1e-4 of
    f64.  Timed beside its plain version, that padded path (the gather,
    then the dense kernel), the gather alone, the gather with
    `lut.gather(...).sum(-1)` (three calls: no single PyTorch call
    computes it), and the list form on codes whose lookups never share a
    bank (code % 32 = row % 32), the cost of the LUT's bank conflicts."""
    g, m = lut.shape[0], lut.shape[1]
    got = CK.adc_score_lists(codes, starts, ends, lut, pad)
    torch.cuda.synchronize()
    lane = torch.arange(pad, device=codes.device)
    cand = starts.long()[:, None] + lane[None, :]
    valid = cand < ends.long()[:, None]
    cand = torch.where(valid, cand, torch.zeros_like(cand))
    gathered = codes[cand]
    dense = CK.adc_score(gathered, lut)
    inf = torch.full_like(dense, INF)
    if got.shape != (g, pad) or not torch.equal(got, torch.where(valid,
                                                                 dense, inf)):
        raise AssertionError(f"adc_score_lists {name}: differs from the "
                             f"dense form on the padded gather")
    want = CK.adc_score_plain(gathered, lut.double())
    tol = 1e-5 * want.abs() + 1e-4
    err = (got.double() - want).abs()[valid]
    max_err = float(err.max()) if err.numel() else 0.0
    if bool((err > tol[valid]).any()) \
            or bool(((dense.double() - want).abs() > tol).any()):
        raise AssertionError(f"adc_score_lists {name}: max err {max_err} "
                             f"exceeds 1e-5*|want|+1e-4")
    del want, tol, err, dense, inf
    rows = int((ends.long() - starts.long()).clamp(min=0).sum())
    bound_ms, bound_by = adc_lists_bound(rows, g, pad, m,
                                         codes.element_size())
    row = {"shape": name, "G": g, "pad": pad, "M": m, "rows": rows,
           "codes": str(codes.dtype).replace("torch.", ""),
           "max_abs_err": max_err, "bound_ms": bound_ms,
           "bound_by": bound_by}
    if timed:
        row["ms"] = cuda_time_ms(
            lambda: CK.adc_score_lists(codes, starts, ends, lut, pad))
        row["plain_ms"] = cuda_time_ms(
            lambda: CK.adc_score_lists_plain(codes, starts, ends, lut, pad),
            warm=1, iters=3)
        row["padded_path_ms"] = cuda_time_ms(
            lambda: CK.adc_score(codes[cand], lut))
        row["gather_ms"] = cuda_time_ms(lambda: codes[cand])
        col = 256 * torch.arange(m, device=codes.device)
        lut_flat = lut.reshape(g, m * 256)
        row["library_ms"] = cuda_time_ms(lambda: lut_flat.gather(
            1, (codes[cand].long() + col).reshape(g, pad * m)).reshape(
                g, pad, m).sum(-1), warm=1, iters=5)
        free = ((torch.arange(codes.shape[0], device=codes.device)[:, None]
                 % 32) + 32 * (codes.long() % 8)).to(codes.dtype)
        row["conflict_free_ms"] = cuda_time_ms(
            lambda: CK.adc_score_lists(free, starts, ends, lut, pad))
        del free
        log(f"[kernel] adc_score_lists {name:18s} G={g} pad={pad} M={m} "
            f"rows={rows} {row['codes']} bit-identical to the dense form "
            f"err={max_err:.3e} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"padded_path_ms={row['padded_path_ms']:.4f} (gather "
            f"{row['gather_ms']:.4f}) gather+lut_gather_sum_ms="
            f"{row['library_ms']:.4f} conflict_free_ms="
            f"{row['conflict_free_ms']:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}, {bound_ms / row['ms']:.0%})")
    else:
        log(f"[kernel] adc_score_lists {name:18s} G={g} pad={pad} M={m} "
            f"rows={rows} {row['codes']} bit-identical to the dense form "
            f"err={max_err:.3e}")
    torch.cuda.empty_cache()
    return row


def adc_list_edges(torch, CK, g):
    """The list form at its edges: empty lists, lists of 1 and of 255-257
    and 511-513 rows (tiles' edges), one longer than a block's 2048
    lanes, a pad that is a multiple of nothing; M = 1, 8, 96, 97 (rows
    off 16 bytes), 300 and 304 (m-tiles, rows off and on 16 bytes);
    uint8 and int32 codes; and a pad shorter than the long list, which
    cuts it."""
    rows = []
    sizes = torch.tensor([0, 2500, 1, 255, 256, 257, 511, 512, 513, 0, 33])
    offs = torch.cat([torch.zeros(1, dtype=torch.int64), sizes.cumsum(0)])
    lists = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 0, 6])
    starts = offs[lists].to(torch.int32).cuda()
    ends = offs[lists + 1].to(torch.int32).cuda()
    for m in (1, 8, 96, 97, 300, 304):
        for dt in (torch.uint8, torch.int32):
            codes = torch.randint(0, 256, (int(offs[-1]), m), generator=g,
                                  device="cuda").to(dt)
            lut = torch.randn(len(lists), m, 256, generator=g, device="cuda")
            for pad in (2507, 1000) if m == 96 else (2507,):
                rows.append(check_adc_lists(
                    torch, CK, f"edge_m{m}_{str(dt)[6:]}_pad{pad}", codes,
                    starts, ends, lut, pad, timed=False))
    return rows


def phase_edges(torch, CK, seed: int):
    """Each kernel vs its plain version at edge shapes, on seeded random
    input -> (L2 rows, masked L2 rows, ADC rows)."""
    # the L2 tile's edges: one row, one query, d % 4 != 0 and d past a
    # depth tile (the 4-byte load path), b past 256 (a third column
    # tile, ragged), rows whose base is off 16 bytes (a storage offset of
    # 1 float at d = 768, a slice x[3:] at d = 65: the 4-byte path again)
    shapes = [("n1", 1, 256, 768, 0), ("b1", 4480, 1, 768, 0),
              ("d100", 4480, 256, 100, 0), ("n1000", 1000, 256, 768, 0),
              ("d65_b257", 5226, 257, 65, 0), ("d769", 1000, 256, 769, 0),
              ("b300", 4480, 300, 768, 0), ("off1_d768", 4480, 256, 768, 1),
              ("slice3_d65", 1000, 32, 65, 3 * 65)]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows, masked = [], []
    for name, n, b, d, off in shapes + [
            ("truth_chunk", TRUTH_CHUNK, 256, 768, 0)]:
        x = torch.randn(n * d + off, generator=g,
                        device="cuda")[off:].view(n, d)
        q = torch.randn(b, d, generator=g, device="cuda")
        if name != "truth_chunk":
            rows.append(check_kernel(torch, CK, name, x, q))
        bern = torch.rand(n, generator=g, device="cuda") < 0.7
        for mname, mask in (("p0.7", bern),
                            ("none", torch.zeros_like(bern)),
                            ("all", torch.ones_like(bern))):
            masked.append(check_masked(torch, CK, f"{name}_{mname}", x, q,
                                       mask))
    # P = 1, 100, 129, 4096; M = 1, 8, 96 and 300 (a 300 KB LUT, over a
    # block's 227 KB of shared memory); uint8 and int32 codes
    adc_shapes = [("p1_m96", 16, 1, 96, torch.uint8),
                  ("p1_m8", 16, 1, 8, torch.int32),
                  ("p100_m8", 16, 100, 8, torch.uint8),
                  ("p100_m96", 16, 100, 96, torch.int32),
                  ("p129_m1", 8, 129, 1, torch.uint8),
                  ("p129_m1", 8, 129, 1, torch.int32),
                  ("p129_m96", 64, 129, 96, torch.uint8),
                  ("p129_m300", 4, 129, 300, torch.int32),
                  ("p4096_m300", 4, 4096, 300, torch.uint8),
                  ("p4096_m96", 512, 4096, 96, torch.uint8),
                  ("p4096_m96", 64, 4096, 96, torch.int32)]
    adc = []
    for name, gs, p, m, dt in adc_shapes:
        codes = torch.randint(0, 256, (gs, p, m), generator=g,
                              device="cuda").to(dt)
        lut = torch.randn(gs, m, 256, generator=g, device="cuda")
        adc.append(check_adc(torch, CK, name, codes, lut))
    adc += adc_list_edges(torch, CK, g)
    torch.cuda.empty_cache()
    return rows, masked, adc


def kernel_launches(CK, label: str, names, required=()) -> dict:
    """Read the launches of each kernel in `names` since the last reset
    -> {name: {"launches": N, "by_shape": [[*shape, N], ...]}}; a kernel
    in `required` that was launched no time fails."""
    out = {}
    for name in names:
        shapes = CK.LAUNCHES.shapes(name)
        out[name] = {"launches": CK.LAUNCHES.get(name),
                     "by_shape": [[*k, v] for k, v in sorted(shapes.items())]}
        log(f"[{label}] {name} launches {out[name]['launches']} by shape "
            f"{ {str(k): v for k, v in sorted(shapes.items())} }")
    missing = [nm for nm in required if out[nm]["launches"] == 0]
    if missing:
        raise AssertionError(f"{label} never launched {missing}")
    return out


def path_launches(CK, label: str):
    """The L2 kernel's launches since the last reset -> (record,
    {(n, b, d): launches}); a path that launched it no time fails."""
    record = kernel_launches(CK, label, ("l2_distance_sq",),
                             required=("l2_distance_sq",))["l2_distance_sq"]
    return record, CK.LAUNCHES.shapes("l2_distance_sq")


def check_path_shapes(torch, CK, label: str, shapes: dict, x, queries):
    """The kernel at each (n, b, d) a path launched it with, on that
    path's own rows x[:n] and queries[:b]."""
    return [dict(check_kernel(torch, CK, f"{label}_b{b}",
                              x[:n].contiguous(), queries[:b].contiguous()),
                 path=label, path_launches=c)
            for (n, b, _), c in sorted(shapes.items())]


def index_bytes(idx) -> int:
    """Device bytes held by an index's tensors."""
    import torch
    return sum(t.numel() * t.element_size() for t in vars(idx).values()
               if isinstance(t, torch.Tensor))


def probed_rows(idx, q64: np.ndarray, nprobe: int):
    """The nprobe nearest lists of query q64 (f64, on the host) ->
    (lists, the lists' row positions in the index, the list of each)."""
    cents = idx.centroids.cpu().double().numpy()
    offs = idx.offsets.cpu().numpy().astype(np.int64)
    cd = ((cents - q64) ** 2).sum(1)
    lists = np.argsort(cd, kind="stable")[:nprobe]
    pos = np.concatenate([np.arange(offs[c], offs[c + 1]) for c in lists])
    owner = np.repeat(lists, offs[lists + 1] - offs[lists])
    return cd, pos, owner


def probed_truth(idx, data_np: np.ndarray, q_np: np.ndarray, k: int,
                 nprobe: int) -> np.ndarray:
    """Exact top-k among the rows of each query's nprobe nearest lists,
    in float64 on the host from the original f32 data: what the index
    would return if it stored the rows exactly."""
    ids = idx.ids.cpu().numpy().astype(np.int64)
    out = np.empty((len(q_np), k), np.int64)
    for i, q in enumerate(q_np.astype(np.float64)):
        _, pos, _ = probed_rows(idx, q, nprobe)
        cand = ids[pos]
        dd = ((data_np[cand].astype(np.float64) - q) ** 2).sum(1)
        out[i] = cand[np.argsort(dd, kind="stable")[:k]]
    return out


def probed_truth_stored(torch, idx, q_np: np.ndarray, k: int,
                        nprobe: int, with_scores: bool = False):
    """Exact top-k among the rows of each query's nprobe nearest lists,
    scored in float64 from what the index stores, with the search's own
    formula: ||c-q||^2 + ||r||^2 + 2 r.c - 2 r.q, r the stored bf16
    residual and q rounded to bf16 as the search's compute dtype rounds
    it, both widened.  The score stage may lose none of these.  With
    `with_scores`: also, per query, every probed row's id and score."""
    ids = idx.ids.cpu().numpy().astype(np.int64)
    rn = idx.r_norm2.cpu().double().numpy()
    rc = idx.r_dot_c.cpu().double().numpy()
    qb = torch.from_numpy(q_np).to(torch.bfloat16).double().numpy()
    out = np.empty((len(q_np), k), np.int64)
    scored = []
    for i, q in enumerate(q_np.astype(np.float64)):
        cd, pos, owner = probed_rows(idx, q, nprobe)
        # the search rounds r to its compute dtype (a no-op on bf16
        # storage, the rounding the score makes of f32 storage); r.q in
        # f64 where r lies, so the rows never cross to the host
        r = idx.vectors[torch.from_numpy(pos).to(idx.device)]
        r = r.to(torch.bfloat16).double()
        rq = (r @ torch.from_numpy(qb[i]).to(r.device)).cpu().numpy()
        score = cd[owner] + rn[pos] + 2.0 * rc[pos] - 2.0 * rq
        out[i] = ids[pos[np.argsort(score, kind="stable")[:k]]]
        scored.append((ids[pos], score))
    return (out, scored) if with_scores else out


def pq_probed_truth(torch, idx, q_np: np.ndarray, k: int,
                    nprobe: int, compute_dtype="bfloat16",
                    with_scores: bool = False):
    """Exact top-k ADC score among the rows of each query's nprobe
    nearest lists, in float64 on the host: the query residual and the
    codebooks rounded to the search's compute dtype (bf16, or None: f32)
    as the search rounds them for the LUT product, both widened;
    ||q_r||^2 and ||codebook||^2 from f32, as the search takes them.
    This checks the port's LUT, gather, ADC and top-k, not PQ's
    quantisation.  With `with_scores`: a list of (top-k row positions,
    every probed row position, their scores) per query."""
    cdt = (getattr(torch, compute_dtype) if compute_dtype
           else torch.float32)
    cents32 = idx.centroids.cpu().numpy()
    ids = idx.ids.cpu().numpy().astype(np.int64)
    codes = idx.codes.cpu().numpy().astype(np.int64)          # [n, M]
    cb32 = idx.codebooks.cpu()                                # [M, 256, ds]
    cbb = cb32.to(cdt).double().numpy()
    cb2 = (cb32.double().numpy() ** 2).sum(-1)                # [M, 256]
    m_sub, _, ds = cbb.shape
    out = np.empty((len(q_np), k), np.int64)
    scored = []
    for i, q in enumerate(q_np):
        cd, pos, owner = probed_rows(idx, q.astype(np.float64), nprobe)
        lists = np.unique(owner)
        qr = (q[None, :] - cents32[lists]).reshape(len(lists), m_sub, ds)
        qrb = torch.from_numpy(qr).to(cdt).double().numpy()
        qr2 = (qr.astype(np.float64) ** 2).sum(-1)            # [L, M]
        lut = (qr2[:, :, None] + cb2[None]
               - 2.0 * np.einsum("lmd,mjd->lmj", qrb, cbb))   # [L, M, 256]
        li = np.searchsorted(lists, owner)
        score = lut[li[:, None], np.arange(m_sub)[None, :],
                    codes[pos]].sum(1)
        out[i] = ids[pos[np.argsort(score, kind="stable")[:k]]]
        scored.append((ids[pos], score))
    return (out, scored) if with_scores else out


def profile_run(torch, fn, label: str, top: int = 8) -> dict:
    """One run of `fn` under torch.profiler: device time by kernel and
    the device's busy share of the wall time.  Only the kernels' own
    rows are summed: an operator's row carries its kernels' device time
    too, and counting both would count that time twice."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.self_device_time_total > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us,
           "h2d_copy_ms": sum(v for k, v in by_name.items()
                              if "HtoD" in k) / 1e3,
           "top_kernels_ms": [[k[:80], v / 1e3] for k, v in ranked]}
    log(f"[profile] {label}: wall {out['wall_ms']:.3f} ms, device busy "
        f"{out['device_busy_ms']:.3f} ms ({out['device_busy_share']:.1%})")
    for k, v in out["top_kernels_ms"]:
        log(f"[profile]   {v:9.3f} ms  {k}")
    return out


def phase_path(torch, CK, args):
    from matrixone_tpu_torch.utils import datagen
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.vectorindex import brute_force, ivf_flat
    from matrixone_tpu_torch.vectorindex.recall import recall_at_k
    from matrixone_tpu_torch.worker import WorkerCore

    n, d, nq = args.n, args.d, args.nq
    report = {}
    t0 = time.perf_counter()
    data, queries = datagen.make_clustered(n, d, nq, seed=args.seed,
                                           device="cuda")
    torch.cuda.synchronize()
    log(f"[path] data {n}x{d} + {nq} queries on the card "
        f"({time.perf_counter() - t0:.3f}s)")

    # exact truth: brute force through the fused kernel, chunk 65536
    CK.LAUNCHES.reset()
    t0 = time.perf_counter()
    padded, n_real = brute_force.pad_dataset(data, chunk_size=TRUTH_CHUNK)
    truth = torch.cat([brute_force.search(
        padded, queries[i:i + BATCH], k=K, n_valid=n_real,
        chunk_size=TRUTH_CHUNK)[1] for i in range(0, nq, BATCH)])
    truth = truth.cpu().numpy()
    report["truth_seconds"] = time.perf_counter() - t0
    report["truth"], shapes = path_launches(CK, "truth")
    log(f"[truth] brute-force truth {report['truth_seconds']:.3f}s")
    rows = check_path_shapes(torch, CK, "truth", shapes, padded, queries)
    del padded
    torch.cuda.empty_cache()

    # 3a: the benchmark configuration, build and 4 search runs counted
    def run_all():
        outs = [ivf_flat.search(index, queries[i:i + BATCH], k=K,
                                nprobe=NPROBE, query_chunk=QUERY_CHUNK,
                                compute_dtype=torch.bfloat16)[1]
                for i in range(0, nq, BATCH)]
        torch.cuda.synchronize()
        return outs

    torch.cuda.reset_peak_memory_stats()
    stages = ("kmeans", "assign", "pack")
    before = {s: M.vector_build_seconds.get(stage=s) for s in stages}
    CK.LAUNCHES.reset()
    t0 = time.perf_counter()
    index = ivf_flat.build(data, nlist=1024, n_iter=6, balance_weight=0.3,
                           kmeans_sample=min(n, 262144),
                           kmeans_minibatch=65536, balance_mode="split",
                           storage_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_stages = {s: M.vector_build_seconds.get(stage=s) - before[s]
                    for s in stages}
    log(f"[3a] build {build_s:.3f}s stages {build_stages} nlist "
        f"{index.nlist} max_cluster_size {index.max_cluster_size}")
    found = torch.cat(run_all()).cpu().numpy()
    rec = recall_at_k(found, truth)
    qps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_all()
        qps.append(nq / (time.perf_counter() - t0))
    report["bench_3a"], shapes = path_launches(CK, "3a")
    report["bench_3a"]["search_runs"] = 4
    rows += check_path_shapes(torch, CK, "3a_probe", shapes,
                              index.centroids, queries)
    # diagnostics, outside the count
    report["profile_3a_search"] = profile_run(
        torch, run_all, f"3a search, {nq} queries")
    prof = ivf_flat.search_profiled(index, queries[:BATCH], k=K,
                                    nprobe=NPROBE, query_chunk=QUERY_CHUNK)
    report["bench"] = {
        "index_bytes": index_bytes(index),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "build_seconds": build_s, "build_stages": build_stages,
        "nlist": index.nlist, "max_cluster_size": index.max_cluster_size,
        "recall_at_20": rec, "qps_runs": qps, "qps_best": max(qps),
        "stage_seconds_batch256": {s: prof[f"{s}_seconds"]
                                   for s in ("probe", "score", "merge")}}
    log(f"[3a] recall@20 {rec:.4f} qps {['%.1f' % v for v in qps]} "
        f"stages(256) {report['bench']['stage_seconds_batch256']} index "
        f"{report['bench']['index_bytes'] / 1e9:.3f} GB, peak "
        f"{report['bench']['peak_device_bytes'] / 1e9:.3f} GB")
    if rec < 0.80:
        raise AssertionError(f"3a recall@20 {rec} < 0.80")
    del index
    torch.cuda.empty_cache()

    # 3b: the served path, from load_index through the threaded searches
    data_np = data.cpu().numpy()
    q_np = queries.cpu().numpy()
    worker = WorkerCore(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    CK.LAUNCHES.reset()
    t0 = time.perf_counter()
    info = worker.load_index("bench", data_np, nlist=1024)
    load_s = time.perf_counter() - t0
    widx = worker.indexes["bench"]["index"]
    log(f"[3b] load_index {info} {load_s:.3f}s nlist {widx.nlist} "
        f"max_cluster_size {widx.max_cluster_size}")

    def sequential(name):
        t0 = time.perf_counter()
        out = np.concatenate([worker.search_index(
            name, q_np[i:i + BATCH], k=K, nprobe=NPROBE)[1]
            for i in range(0, nq, BATCH)])
        return out, nq / (time.perf_counter() - t0)

    worker.search_index("bench", q_np[:BATCH], k=K, nprobe=NPROBE)   # warm
    seq, seq_qps = sequential("bench")
    h0 = worker.health()
    per = 32
    reqs = list(range(0, nq, per))
    thr = np.zeros((nq, K), np.int64)
    errors = []

    def client(t):
        try:
            for lo in reqs[t::8]:
                thr[lo:lo + per] = worker.search_index(
                    "bench", q_np[lo:lo + per], k=K, nprobe=NPROBE)[1]
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    thr_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"threaded search failed: {errors[:1]}")
    h1 = worker.health()
    report["served_3b"], shapes = path_launches(CK, "3b")
    rows += check_path_shapes(torch, CK, "3b_probe", shapes,
                              widx.centroids, queries)
    rec_seq = recall_at_k(seq, truth)
    rec_thr = recall_at_k(thr, truth)
    rec_probed = recall_at_k(
        seq[:64], probed_truth_stored(torch, widx, q_np[:64], K, NPROBE))
    rec_probed_orig = recall_at_k(
        seq[:64], probed_truth(widx, data_np, q_np[:64], K, NPROBE))
    report["served"] = {
        "index_bytes": index_bytes(widx),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "load_seconds": load_s, "nlist": widx.nlist,
        "max_cluster_size": widx.max_cluster_size,
        "recall_at_20_sequential": rec_seq,
        "recall_at_20_threaded": rec_thr,
        "recall_probed_lists_stored_64q": rec_probed,
        "recall_probed_lists_original_64q": rec_probed_orig,
        "sequential_qps": seq_qps, "threaded_qps": nq / thr_s,
        "threaded_requests": h1["batch_requests"] - h0["batch_requests"],
        "threaded_dispatches": h1["batch_dispatches"]
        - h0["batch_dispatches"]}
    log(f"[3b] recall@20 seq {rec_seq:.4f} threaded {rec_thr:.4f} "
        f"probed-list recall (64q, f64) vs the stored index "
        f"{rec_probed:.4f}, vs the original rows {rec_probed_orig:.4f} "
        f"(no gate: bf16 storage) seq {seq_qps:.1f} qps threaded "
        f"{nq / thr_s:.1f} qps requests/dispatches "
        f"{report['served']['threaded_requests']}/"
        f"{report['served']['threaded_dispatches']} index "
        f"{report['served']['index_bytes'] / 1e9:.3f} GB, peak "
        f"{report['served']['peak_device_bytes'] / 1e9:.3f} GB")
    if rec_probed < 0.99:
        raise AssertionError(f"3b probed-list recall {rec_probed} < 0.99")
    if abs(rec_thr - rec_seq) > 0.005:
        raise AssertionError(f"3b threaded recall {rec_thr} vs {rec_seq}")
    report["3d_worker_modes"], modes_rows = phase_worker_modes(
        torch, CK, worker, widx, data, q_np, seq, truth, seq_qps)
    rows += modes_rows
    del worker, widx
    torch.cuda.empty_cache()

    # 3c: rerank_exact, bit-identical to a sequential f64 oracle
    ids8 = torch.from_numpy(seq[:8].astype(np.int32)).cuda()
    rd, ri = ivf_flat.rerank_exact(data, queries[:8], ids8)
    rd, ri = rd.cpu().numpy(), ri.cpu().numpy()
    for i in range(8):
        sq = (data_np[seq[i]].astype(np.float64)
              - q_np[i].astype(np.float64)) ** 2
        acc = np.zeros(len(sq))
        for j in range(sq.shape[1]):
            acc = acc + sq[:, j]
        exp = np.sqrt(acc)
        order = np.argsort(exp, kind="stable")
        if not (np.array_equal(rd[i], exp[order])
                and np.array_equal(ri[i], seq[i][order])):
            raise AssertionError(f"3c rerank_exact differs on query {i}")
    log("[3c] rerank_exact bit-identical to the f64 left-fold oracle "
        "on 8 queries")
    return report, rows, {"data": data, "queries": queries, "truth": truth}


def padded_path_search(torch, index, queries, k: int, nprobe: int,
                       query_chunk: int, compute_dtype):
    """The IVF-PQ search as it ran before the list form, for comparison:
    each chunk's candidate codes gathered into a padded [chunk, nprobe,
    pad, M] tensor, scored by the ADC kernel's dense form, masked to +inf
    past each list's end, then the search's own two-stage top-k."""
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.ops.topk import topk_smallest
    from matrixone_tpu_torch.vectorindex import ivf_flat, ivf_pq
    q, b, qc_eff = ivf_flat._prepare_queries(index, queries, query_chunk)
    probes = ivf_pq._probe(index, q, nprobe)
    pad, m = index.max_cluster_size, index.n_subspaces
    dists, ids = [], []
    for i in range(0, q.shape[0], qc_eff):
        qc, pc = q[i:i + qc_eff], probes[i:i + qc_eff]
        lut, cand, starts, ends = ivf_pq.adc_inputs(index, qc, pc,
                                                    compute_dtype)
        g = pc.shape[0] * nprobe
        dist = TK.adc_score(index.codes[cand].reshape(g, pad, m),
                            lut.reshape(g, m, 256)).reshape(pc.shape[0],
                                                            nprobe, pad)
        lane = torch.arange(pad, device=cand.device)
        valid = lane < (ends - starts)[:, :, None]
        dist = torch.where(valid, dist, torch.full_like(dist, INF))
        kk = min(k, pad)
        s1, p1 = topk_smallest(dist, kk)
        c1 = cand.gather(2, p1)
        s1f = s1.reshape(pc.shape[0], nprobe * kk)
        c1f = c1.reshape(pc.shape[0], nprobe * kk)
        top_s, top_pos = topk_smallest(s1f, min(k, nprobe * kk))
        dists.append(top_s)
        ids.append(index.ids[c1f.gather(1, top_pos)])
    return torch.cat(dists)[:b], torch.cat(ids)[:b]


def phase_pq(torch, CK, args, ctx: dict):
    """Phase 4: IVF-PQ at bench.py's configuration (MO_BENCH_INDEX=ivfpq)
    on phase 3's data, queries and truth.  The raw data is freed once
    the build and the re-rank pool that needs it are done."""
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.vectorindex import ivf_flat, ivf_pq
    from matrixone_tpu_torch.vectorindex.recall import recall_at_k

    data, queries, truth = ctx.pop("data"), ctx["queries"], ctx["truth"]
    n, d = data.shape
    nq = queries.shape[0]
    m_sub = ivf_pq.pick_subspaces(d)
    kernels = ("l2_distance_sq", "adc_score_lists")
    report = {}

    def run_all(k=K):
        outs = [ivf_pq.search(index, queries[i:i + BATCH], k=k,
                              nprobe=NPROBE, query_chunk=QUERY_CHUNK,
                              compute_dtype=torch.bfloat16)[1]
                for i in range(0, nq, BATCH)]
        torch.cuda.synchronize()
        return outs

    stages = ("kmeans", "assign", "pq")
    before = {s: M.vector_build_seconds.get(stage=s) for s in stages}
    torch.cuda.reset_peak_memory_stats()
    CK.LAUNCHES.reset()
    t0 = time.perf_counter()
    index = ivf_pq.build(data, nlist=1024, n_subspaces=m_sub, n_iter=10,
                         balance_weight=0.3,
                         kmeans_sample=min(n, 262144),
                         compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    report["build_launches"] = kernel_launches(CK, "4a build",
                                               kernels + ("adc_score",),
                                               required=("l2_distance_sq",))
    # the sub-k-means launched the L2 kernel at d = ds against 256
    # codewords: check it there on the path's rows and a codebook
    rows = [dict(check_kernel(torch, CK, f"4_build_n{nb}",
                              data[:nb, :db].contiguous(),
                              index.codebooks[0][:b].contiguous()),
                 path="4_build", path_launches=c)
            for (nb, b, db), c in sorted(
                CK.LAUNCHES.shapes("l2_distance_sq").items())]
    build_stages = {s: M.vector_build_seconds.get(stage=s) - before[s]
                    for s in stages}
    build_peak = torch.cuda.max_memory_allocated()
    log(f"[4] build {build_s:.3f}s stages {build_stages} nlist "
        f"{index.nlist} M {index.n_subspaces} max_cluster_size "
        f"{index.max_cluster_size} peak {build_peak / 1e9:.3f} GB")

    # 4c's re-rank: a k = 100 pool re-scored exactly from the raw data
    pool = torch.cat(run_all(k=100))
    _, rr = ivf_flat.rerank_exact(data, queries, pool)
    rec_rerank = recall_at_k(rr[:, :K].cpu().numpy(), truth)
    del data, pool, rr
    torch.cuda.empty_cache()

    # 4a: one search run of all queries, counted: the list form and the
    # L2 kernel must launch, the dense form (the padded gather) never
    CK.LAUNCHES.reset()
    found = torch.cat(run_all()).cpu().numpy()
    report["search_launches"] = kernel_launches(
        CK, "4a search", kernels + ("adc_score",), required=kernels)
    if report["search_launches"]["adc_score"]["launches"]:
        raise AssertionError("4a: the search ran the ADC kernel's dense "
                             "form on a padded gather")
    l2_shapes = CK.LAUNCHES.shapes("l2_distance_sq")
    adc_shapes = CK.LAUNCHES.shapes("adc_score_lists")
    rows += check_path_shapes(torch, CK, "4_probe", l2_shapes,
                              index.centroids, queries)
    # the list form at each shape the search launched it with, on the
    # search's own inputs (its first query chunk)
    adc_rows = []
    for (g, pad, m), c in sorted(adc_shapes.items()):
        qn = g // NPROBE                    # the chunk's queries
        pc = ivf_pq._probe(index, queries[:qn], NPROBE)
        lut, _, starts, ends = ivf_pq.adc_inputs(
            index, queries[:qn], pc, torch.bfloat16)
        adc_rows.append(dict(check_adc_lists(
            torch, CK, f"4_search_G{g}", index.codes,
            starts.reshape(g).contiguous(), ends.reshape(g).contiguous(),
            lut.reshape(g, m, 256).contiguous(), pad),
            path="4_search", path_launches=c))
        del lut
    torch.cuda.empty_cache()

    # the search's ids and distances against the path it replaced (the
    # padded gather and the dense form), all queries, side by side
    def run_padded():
        outs = [padded_path_search(torch, index, queries[i:i + BATCH], K,
                                   NPROBE, QUERY_CHUNK, torch.bfloat16)
                for i in range(0, nq, BATCH)]
        torch.cuda.synchronize()
        return outs

    def run_lists():
        outs = [ivf_pq.search(index, queries[i:i + BATCH], k=K,
                              nprobe=NPROBE, query_chunk=QUERY_CHUNK,
                              compute_dtype=torch.bfloat16)
                for i in range(0, nq, BATCH)]
        torch.cuda.synchronize()
        return outs

    old, new = run_padded(), run_lists()
    same_ids = all(torch.equal(a[1], b[1]) for a, b in zip(old, new))
    same_d = all(torch.equal(a[0], b[0]) for a, b in zip(old, new))
    log(f"[4a] search ids equal to the padded path's: {same_ids}; "
        f"distances bit-identical: {same_d} ({nq} queries)")
    if not (same_ids and same_d):
        raise AssertionError("4a: the list-form search differs from the "
                             "padded-gather path")
    del old, new
    side = {"padded": [], "lists": []}
    for _ in range(3):                  # in turns: padded, lists, ...
        for name, fn in (("padded", run_padded), ("lists", run_lists)):
            t0 = time.perf_counter()
            fn()
            side[name].append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    run_padded()
    padded_peak = torch.cuda.max_memory_allocated()
    report["padded_path"] = {
        "ids_equal": same_ids, "distances_equal": same_d,
        "seconds_runs": side, "search_peak_device_bytes": padded_peak,
        "profile": profile_run(torch, run_padded,
                               f"4 IVF-PQ search through the padded "
                               f"gather (the path replaced), {nq} queries")}
    log(f"[4a] {nq} queries, seconds in turns: padded "
        f"{['%.4f' % v for v in side['padded']]} lists "
        f"{['%.4f' % v for v in side['lists']]}; padded-path peak "
        f"{padded_peak / 1e9:.3f} GB")

    # 4b: the score stage against an f64 host oracle of the probed lists
    q_np = queries.cpu().numpy()
    oracle = pq_probed_truth(torch, index, q_np[:64], K, NPROBE)
    rec_adc = recall_at_k(found[:64], oracle)
    # 4c: recall against the exact truth, beside what an exact ADC of
    # the probed lists reaches on the same 64 queries (no gate: on this
    # data the reference design's PQ error exceeds the neighbours' gaps),
    # then the JAX package's own bar on its own test data
    rec = recall_at_k(found, truth)
    rec_oracle64 = recall_at_k(oracle, truth[:64])
    rec_found64 = recall_at_k(found[:64], truth[:64])
    report["reference_bar"] = pq_reference_bar(torch, CK)

    # 4d: warm QPS, traced run, memory
    torch.cuda.reset_peak_memory_stats()
    qps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_all()
        qps.append(nq / (time.perf_counter() - t0))
    search_peak = torch.cuda.max_memory_allocated()
    report["profile_4_search"] = profile_run(
        torch, run_all, f"4 IVF-PQ search, {nq} queries")
    report["pq"] = {
        "n": n, "d": d, "n_subspaces": m_sub, "nlist": index.nlist,
        "max_cluster_size": index.max_cluster_size,
        "index_bytes": index_bytes(index),
        "build_seconds": build_s, "build_stages": build_stages,
        "build_peak_device_bytes": build_peak,
        "search_peak_device_bytes": search_peak,
        "recall_probed_lists_adc_64q": rec_adc,
        "recall_at_20": rec, "recall_at_20_rerank_pool_100": rec_rerank,
        "recall_at_20_64q": rec_found64,
        "recall_at_20_64q_exact_adc_oracle": rec_oracle64,
        "qps_runs": qps, "qps_best": max(qps)}
    log(f"[4] probed-list ADC recall (64q, f64) {rec_adc:.4f} recall@20 "
        f"{rec:.4f} (64q: {rec_found64:.4f}; an exact f64 ADC of the "
        f"probed lists: {rec_oracle64:.4f}; no gate) re-ranked k=100 pool "
        f"{rec_rerank:.4f} qps "
        f"{['%.1f' % v for v in qps]} index "
        f"{report['pq']['index_bytes'] / 1e9:.3f} GB, search peak "
        f"{search_peak / 1e9:.3f} GB")
    if rec_adc < 0.99:
        raise AssertionError(f"4b probed-list ADC recall {rec_adc} < 0.99")
    return report, rows, adc_rows


def pq_reference_bar(torch, CK) -> dict:
    """4c: the JAX package's own IVF-PQ recall bars on its own test data
    and configuration (tests/test_vectorindex.py, test_ivf_pq_recall_
    and_memory: 20000 x 32, 50 centres N(0, 5^2), unit noise, nlist 32,
    M 8), on the card, with 256 queries where it has 32: raw ADC
    recall@10 >= 0.40, and >= 0.85 after `rerank_exact` of a k = 100
    pool."""
    from matrixone_tpu_torch.vectorindex import brute_force, ivf_flat, ivf_pq
    from matrixone_tpu_torch.vectorindex.recall import recall_at_k
    rng = np.random.default_rng(1234)
    centers = rng.standard_normal((50, 32)) * 5
    x = (centers[rng.integers(0, 50, 20000)]
         + rng.standard_normal((20000, 32))).astype(np.float32)
    q = (x[rng.integers(0, len(x), 256)]
         + 0.01 * rng.standard_normal((256, 32))).astype(np.float32)
    xt, qt = torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()
    padded, n_real = brute_force.pad_dataset(xt, chunk_size=4096)
    truth = brute_force.search(padded, qt, k=10, n_valid=n_real,
                               chunk_size=4096)[1].cpu().numpy()
    index = ivf_pq.build(xt, nlist=32, n_subspaces=8, n_iter=8, pq_iter=6,
                         kmeans_sample=None, compute_dtype=None)
    ids = ivf_pq.search(index, qt, k=10, nprobe=8, query_chunk=16)[1]
    pool = ivf_pq.search(index, qt, k=100, nprobe=8, query_chunk=16)[1]
    rr = ivf_flat.rerank_exact(xt, qt, pool)[1][:, :10]
    out = {"recall_at_10": recall_at_k(ids.cpu().numpy(), truth),
           "recall_at_10_rerank_pool_100": recall_at_k(rr.cpu().numpy(),
                                                       truth)}
    log(f"[4c] the JAX package's test data (20000 x 32, M 8): recall@10 "
        f"{out['recall_at_10']:.4f} (bar 0.40), re-ranked k=100 pool "
        f"{out['recall_at_10_rerank_pool_100']:.4f} (bar 0.85)")
    if out["recall_at_10"] < 0.40:
        raise AssertionError(f"4c recall@10 {out['recall_at_10']} < 0.40, "
                             f"the JAX package's raw-ADC bar")
    if out["recall_at_10_rerank_pool_100"] < 0.85:
        raise AssertionError(f"4c re-ranked recall@10 "
                             f"{out['recall_at_10_rerank_pool_100']} < 0.85, "
                             f"the JAX package's bar")
    return out


def search_bound(n: int, m: int):
    """(ms, 'bytes'|'operations'): the least time of one sorted search:
    the sorted array read once (8 n bytes), each query read and each
    position written once (12 m bytes); ceil(log2(n + 1)) 64-bit
    compares a query, each counted as two 32-bit operations at the f32
    CUDA-core rate."""
    t_ops = 2.0 * m * max(n, 1).bit_length() / H100_F32_FLOPS
    t_bytes = (8.0 * n + 12.0 * m) / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def segsum_bound(n: int, g: int):
    """(ms, 'bytes'|'operations'): the least time of one segment sum:
    each value, gid and mask byte read once (9 n), each output written
    once (4 G); n f32 adds."""
    t_ops = float(n) / H100_F32_FLOPS
    t_bytes = (9.0 * n + 4.0 * g) / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_sorted_search(torch, CK, name: str, srt, q,
                        timed: bool = True) -> dict:
    """The sorted-search kernel against its plain version, bit for bit
    (`torch.equal`), timed beside the plain version and
    `torch.searchsorted` on pre-flipped int64."""
    n, m = srt.shape[0], q.shape[0]
    got = CK.sorted_search(srt, q)
    torch.cuda.synchronize()
    want = CK.sorted_search_plain(srt, q)
    if got.shape != (m,) or got.dtype != torch.int32 \
            or not torch.equal(got, want):
        bad = int((got.long() - want.long()).abs().max()) if m else 0
        raise AssertionError(f"sorted_search {name} n={n} m={m}: differs "
                             f"from its plain version (max |diff| {bad})")
    stride, samples, levels = CK.sorted_search_plan(n)
    row = {"shape": name, "n": n, "m": m, "stride": stride,
           "samples": samples, "levels": levels, "max_abs_err": 0.0}
    if not timed:
        log(f"[kernel] sorted_search {name:22s} n={n} m={m} stride={stride} "
            f"levels={levels} bit-identical")
        return row
    ms = cuda_time_ms(lambda: CK.sorted_search(srt, q))
    plain_ms = cuda_time_ms(lambda: CK.sorted_search_plain(srt, q))
    from matrixone_tpu_torch.ops.hash import unsigned_order
    sf, qf = unsigned_order(srt), unsigned_order(q)
    lib_ms = cuda_time_ms(lambda: torch.searchsorted(sf, qf,
                                                     out_int32=True))
    bound_ms, bound_by = search_bound(n, m)
    row.update({"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
    log(f"[kernel] sorted_search {name:22s} n={n} m={m} stride={stride} "
        f"levels={levels} bit-identical ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"searchsorted_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}, {bound_ms / ms:.0%}) x_library={ms / lib_ms:.2f}")
    return row


def sorted_search_tree_edges(torch, CK, g) -> list:
    """The sample tree's edges, bit for bit: n just below, at and above
    k times the sample count S = 2^14 - 1 for k = 1, 2, 13 and 257 (where
    the stride steps); a run of equal keys that starts just before, at
    or after a sample and crosses several; keys at 0, 2^63 - 1, 2^63 and
    2^64 - 1; n = 2^22, the join's build budget; m of no particular
    size."""
    rows = []
    cap = (1 << CK.SORTED_SEARCH_LEVELS) - 1
    for n in sorted({k * cap + o for k in (1, 2, 13, 257)
                     for o in (-1, 0, 1)} | {1 << 22}):
        srt = torch.randint(-(1 << 63), (1 << 63) - 1, (n,),
                            generator=g, device="cuda")
        srt = srt[torch.argsort(CK.unsigned_order(srt), stable=True)]
        stride = CK.sorted_search_plan(n)[0]
        for off in (-1, 0, 1):                  # runs across samples
            at = (2 + 3 * (off + 1)) * stride + off
            if at >= 0 and at + 2 * stride < n:
                srt[at:at + 2 * stride + 1] = srt[at].item()
        srt[:2] = 0
        srt[-2:] = -1                           # UINT64_MAX
        srt[2:4] = torch.tensor([(1 << 63) - 1, -(1 << 63)], device="cuda")
        srt = srt[torch.argsort(CK.unsigned_order(srt),
                                stable=True)].contiguous()
        q = torch.cat([torch.tensor([0, 1, -1, (1 << 63) - 1, -(1 << 63)],
                                    device="cuda"),
                       srt[:100003], srt[:100003] + 1,
                       srt[:100003] - 1]).contiguous()
        rows.append(check_sorted_search(torch, CK, f"tree_n{n}", srt, q,
                                        timed=False))
    return rows


def segment_sum_agrees(torch, CK, values, gids, mask, g: int,
                       got) -> tuple:
    """`got`, a segment sum of `values` by `gids` under `mask` into g
    groups, against the plain version in f64: the same shape and dtype,
    NaN in the same groups, the same infinities, and elsewhere exact when
    the values are integer-valued and every group's sum of |v| stays
    below 2^24, else |err| <= 1e-4 |want| + 1e-3 (the reference's
    tolerance) -> (agrees, exact, max |err|)."""
    want = CK.segment_sum_plain(values.double(), gids, mask, g)
    nan = torch.isnan(want)
    finite = ~nan & torch.isfinite(want)
    err = (got.double() - want).abs()[finite]
    max_err = float(err.max()) if err.numel() else 0.0
    live = mask & torch.isfinite(values)
    exact = bool(torch.equal(values[live], values[live].round())) \
        and float(CK.segment_sum_plain(
            values.double().abs().nan_to_num(), gids, mask,
            g).max()) < (1 << 24)
    inf = torch.isinf(want)
    same = torch.equal(got[~nan].double(), want[~nan]) if exact else bool(
        (err <= 1e-4 * want[finite].abs() + 1e-3).all()) and torch.equal(
        got[inf].double(), want[inf])
    ok = tuple(got.shape) == (g,) and got.dtype == torch.float32 \
        and same and torch.equal(torch.isnan(got), nan)
    return ok, exact, max_err


def check_segment_sum(torch, CK, name: str, values, gids, mask,
                      g: int) -> dict:
    """The segment-sum kernel against its plain version
    (`segment_sum_agrees`); a second launch on the same inputs must give
    the same bits.  Timed beside the plain version in f32 and
    `index_add_` into G + 1 slots (the slot of masked and out-of-range
    rows precomputed)."""
    n = values.shape[0]
    walks = CK.LAUNCHES.shapes("segment_sum_walk")
    got = CK.segment_sum(values, gids, mask, g)
    head, = [h for (h,), c in CK.LAUNCHES.shapes("segment_sum_walk").items()
             if c != walks.get((h,), 0)]
    again = CK.segment_sum(values, gids, mask, g)
    torch.cuda.synchronize()
    ok, exact, max_err = segment_sum_agrees(torch, CK, values, gids, mask,
                                            g, got)
    if not ok:
        raise AssertionError(f"segment_sum {name} n={n} G={g}: max err "
                             f"{max_err} ({'exact' if exact else 'tol'})")
    if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"segment_sum {name} n={n} G={g}: two "
                             f"launches gave different bits")
    ms = cuda_time_ms(lambda: CK.segment_sum(values, gids, mask, g))
    plain_ms = cuda_time_ms(
        lambda: CK.segment_sum_plain(values, gids, mask, g))
    slot = torch.where(mask & (gids >= 0) & (gids < g), gids.long(), g)
    lib_ms = cuda_time_ms(lambda: torch.zeros(
        g + 1, device=values.device).index_add_(0, slot, values))
    bound_ms, bound_by = segsum_bound(n, g)
    row = {"shape": name, "n": n, "G": g, "exact": exact,
           "head": head,
           "same_bits": True, "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    log(f"[kernel] segment_sum {name:22s} n={n} G={g} head={row['head']} "
        f"{'exact' if exact else f'err={max_err:.3e}'} same bits "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} index_add_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}, {bound_ms / ms:.0%})")
    return row


def segsum_edge_inputs(torch, g, n: int = 1 << 20):
    """The segment sum's edge inputs beyond the uniform ones, integer-
    valued, as (name, values, gids, mask, G): Zipf-skewed gids (s = 1.2)
    over 4096 and 1000 groups; views at a common offset of 3 elements
    (the vector walk from its head row) and at offsets 1, 0, 1 (the
    scalar walk); unmasked gids of -1, G and 2^31 - 1; masked NaN and
    +-inf with one unmasked NaN."""
    v = torch.randint(0, 16, (n + 4,), generator=g,
                      device="cuda").to(torch.float32)
    m = torch.rand(n + 4, generator=g, device="cuda") < 0.8
    out = []
    for G in (4096, 1000):
        rank = torch.arange(1, G + 1, device="cuda", dtype=torch.float64)
        z = torch.multinomial(rank ** -1.2, n, replacement=True,
                              generator=g).to(torch.int32)
        out.append((f"zipf_G{G}", v[:n], z, m[:n], G))
    u = torch.randint(0, 1000, (n + 4,), generator=g, device="cuda",
                      dtype=torch.int32)
    out.append(("offset3", v[3:n + 3], u[3:n + 3], m[3:n + 3], 1000))
    out.append(("offset_mixed", v[1:n + 1], u[:n], m[1:n + 1], 1000))
    gg = u[:n].clone()
    gg[::7] = -1
    gg[1::11] = 1000
    gg[2::13] = (1 << 31) - 1
    out.append(("out_of_range", v[:n], gg, m[:n], 1000))
    vv, mm = v[:n].clone(), m[:n].clone()
    mm[::5] = False
    vv[::5] = float("nan")
    vv[1::10] = float("inf")
    vv[6::10] = float("-inf")
    mm[1::10] = mm[6::10] = False
    vv[8], mm[8], gg[8] = float("nan"), True, 7
    out.append(("nan_inf", vv, u[:n], mm, 1000))
    return out


def segsum_cold(torch, CK, row: dict, inputs, g: int) -> dict:
    """The segment sum timed over copies of one path input set, taken in
    turn: at least 8, together more than twice the H100's 50 MB L2, so
    each call reads its inputs from HBM -> {"ms_l2_cold", "l2_cold_sets",
    "bound_share", "bound_share_l2_cold"}."""
    set_bytes = sum(t.numel() * t.element_size() for t in inputs)
    k = max(8, -(-2 * H100_L2_BYTES // set_bytes))
    sets = [tuple(t.clone() for t in inputs) for _ in range(k)]
    turn = [0]

    def call():
        v, gids, m = sets[turn[0] % k]
        turn[0] += 1
        return CK.segment_sum(v, gids, m, g)
    cold = cuda_time_ms(call)
    out = {"ms_l2_cold": cold, "l2_cold_sets": k,
           "bound_share": row["bound_ms"] / row["ms"],
           "bound_share_l2_cold": row["bound_ms"] / cold}
    log(f"[kernel] segment_sum {row['shape']} L2-cold over {k} input sets "
        f"of {set_bytes / 1e6:.1f} MB: ms={cold:.4f} (bound share "
        f"{out['bound_share_l2_cold']:.0%}; L2-warm {row['ms']:.4f}, "
        f"{out['bound_share']:.0%})")
    del sets
    torch.cuda.empty_cache()
    return out


def device_us_per_call(torch, fn, calls: int = 10) -> tuple:
    """({device activity (kernel, memset, copy): microseconds per call}
    of `fn`, from torch.profiler over `calls` calls; the number of traces
    that came back empty before it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace of a few short launches has come back empty on the card
    # once, for a cause not known: trace again before failing, and
    # report every empty trace
    for empty in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / calls
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        log(f"[profile] a call runs {out}")
        if out:
            return out, empty
        log(f"[profile] trace {empty + 1} of {calls} calls came back empty")
    raise AssertionError("the profiler saw no device activity in 3 traces")


def phase_relational_edges(torch, CK, seed: int):
    """Phase 2 for the relational kernels: the sorted search bit for bit
    on sorted uint64 hashes with a duplicate run and UINT64_MAX (NULL)
    sentinels, queries drawn from them plus random ones plus 0, 1 and
    2^64 - 1; the segment sum on integer-valued and N(0,1) values with a
    0.8 Bernoulli mask (masked rows keep gids of live groups), then on
    skewed, unaligned, out-of-range and NaN/inf inputs, each launched
    twice for the same bits."""
    from matrixone_tpu_torch.ops.hash import unsigned_order
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    top = (1 << 63) - 1
    search = []
    for n in (0, 1, 2500, (1 << 20) + 3, 4_000_000):
        srt = torch.randint(-top - 1, top, (n,), generator=g, device="cuda")
        if n:
            srt[: n // 5] = srt[0]
            srt[-min(4, n):] = -1                  # UINT64_MAX
        srt = srt[torch.argsort(unsigned_order(srt), stable=True)]
        for m in (1, 1000, 1 << 20):
            q = torch.randint(-top - 1, top, (m,), generator=g,
                              device="cuda")
            if n:
                pick = torch.randint(0, n, (m,), generator=g, device="cuda")
                take = torch.rand(m, generator=g, device="cuda") < 0.7
                q = torch.where(take, srt[pick], q)
            q[: min(3, m)] = torch.tensor([0, 1, -1], device="cuda")[
                : min(3, m)]
            search.append(check_sorted_search(torch, CK, f"edge_n{n}_m{m}",
                                              srt, q.contiguous()))
    search += sorted_search_tree_edges(torch, CK, g)
    segsum = []
    for n in (1, 4000, 4096, 1 << 20, 6_000_000):
        mask = torch.rand(n, generator=g, device="cuda") < 0.8
        for gs in (1, 19, 1000, 4096):
            gids = torch.randint(0, gs, (n,), generator=g, device="cuda",
                                 dtype=torch.int32)
            ints = torch.randint(0, 16, (n,), generator=g,
                                 device="cuda").float()
            normal = torch.randn(n, generator=g, device="cuda")
            for kind, vals in (("int", ints), ("normal", normal)):
                segsum.append(check_segment_sum(
                    torch, CK, f"edge_{kind}_n{n}_G{gs}", vals, gids, mask,
                    gs))
    for name, vals, gids, mask, gs in segsum_edge_inputs(torch, g):
        segsum.append(check_segment_sum(torch, CK, f"edge_{name}", vals,
                                        gids, mask, gs))
    torch.cuda.empty_cache()
    return search, segsum


class PathInputs:
    """Records what one run of a path hands the sorted-search and
    segment-sum kernels, in one of three modes:

      shapes  the first inputs of each launch shape, keyed as `LAUNCHES`
              keys them (`search`, `segsum`);
      graphs  the tensors each call of the sorted-search seam reads and
              writes inside a graph capture (`seen`: sorted hashes, probe
              hashes, positions); after any replay they hold that
              replay's values, so the kernel inside the graph can be held
              against its plain version on its own inputs;
      every   every launch on the card with its output (`search_all`,
              `segsum_all`): a launch outside a graph capture as copies
              taken at the launch, a launch inside a captured graph once
              per replay of that graph, as copies of the graph's own
              tensors taken just after the replay (`vm/graphs.StepGraph`).

    It wraps the two seam functions (and in `every` a graph's capture and
    replay count) and calls the real ones, so the path's launches are
    unchanged."""

    def __init__(self, torch, TK, mode: str = "shapes"):
        self.torch, self.TK, self.mode = torch, TK, mode
        self.search, self.segsum = {}, {}
        self.search_all, self.segsum_all = [], []
        #: the graph each thread is capturing (host peers capture on
        #: their handler threads at once; a capture is serialized, but
        #: its push and pop here are not)
        self._capturing, self._in_graph = {}, {}

    @property
    def seen(self) -> list:
        """The sorted-search calls made inside graph captures."""
        return [t for recs in self._in_graph.values()
                for kind, t, _ in recs if kind == "search"]

    def drop_held(self) -> None:
        """Forget the launches held so far; the graphs captured in scope
        stay known, so their later replays are held."""
        self.search_all, self.segsum_all = [], []

    def _stack(self) -> list:
        return self._capturing.setdefault(threading.get_ident(), [None])

    def _keep(self, kind: str, tensors: tuple, extra: tuple) -> None:
        if self.torch.cuda.is_current_stream_capturing():
            self._in_graph.setdefault(self._stack()[-1], []).append(
                (kind, tensors, extra))
        elif self.mode == "every":
            held = self.search_all if kind == "search" else self.segsum_all
            held.append(tuple(t.clone() for t in tensors) + extra + (False,))

    def __enter__(self):
        torch, TK, mode = self.torch, self.TK, self.mode
        self._real = (TK.sorted_lookup, TK.grouped_scatter_add)
        real_lookup, real_scatter = self._real

        def lookup(sorted_hash, queries):
            key = (sorted_hash.shape[0], queries.shape[0])
            if mode == "shapes" and key not in self.search:
                self.search[key] = (sorted_hash.contiguous().clone(),
                                    queries.contiguous().clone())
            out = real_lookup(sorted_hash, queries)
            if mode != "shapes" and queries.is_cuda \
                    and (queries.shape[0] or mode == "graphs"):
                self._keep("search", (sorted_hash.contiguous(),
                                      queries.contiguous(), out), ())
            return out

        def scatter(values, gids, mask, max_groups, use_pallas=False):
            key = (values.shape[0], max_groups)
            kernel = use_pallas and values.dtype == torch.float32 \
                and max_groups <= 4096 and values.shape[0]
            if mode == "shapes" and kernel and key not in self.segsum:
                self.segsum[key] = (values.contiguous().clone(),
                                    gids.to(torch.int32).contiguous(),
                                    mask.contiguous().clone())
            out = real_scatter(values, gids, mask, max_groups,
                               use_pallas=use_pallas)
            if mode == "every" and kernel and values.is_cuda:
                self._keep("segsum", (values.contiguous(),
                                      gids.to(torch.int32).contiguous(),
                                      mask.contiguous(), out),
                           (max_groups,))
            return out

        TK.sorted_lookup, TK.grouped_scatter_add = lookup, scatter
        if mode == "every":
            from matrixone_tpu_torch.vm.graphs import StepGraph
            self._real_graph = (StepGraph._capture, StepGraph._count_replay)
            real_capture, real_count = self._real_graph
            spy = self

            def capture(graph, flat, spec):
                spy._stack().append(graph)
                try:
                    return real_capture(graph, flat, spec)
                finally:
                    spy._stack().pop()

            def count_replay(graph):
                real_count(graph)
                for kind, tensors, extra in spy._in_graph.get(graph, ()):
                    held = (spy.search_all if kind == "search"
                            else spy.segsum_all)
                    held.append(tuple(t.clone() for t in tensors) + extra
                                + (True,))

            StepGraph._capture, StepGraph._count_replay = (capture,
                                                           count_replay)
        return self

    def __exit__(self, *exc):
        self.TK.sorted_lookup, self.TK.grouped_scatter_add = self._real
        if self.mode == "every":
            from matrixone_tpu_torch.vm.graphs import StepGraph
            StepGraph._capture, StepGraph._count_replay = self._real_graph
        return False


def hold_launches(torch, CK, cap, label: str, launches: dict,
                  timed: bool = True) -> tuple:
    """Every launch `cap` (a `PathInputs` in `every`) held, each
    against its plain version on its own inputs: the sorted search bit
    for bit (as `check_sorted_search`), the segment sum as
    `segment_sum_agrees` and with the same bits again on a second launch.
    The launches held must be all of them: as many as `launches`
    (`kernel_launches` of the same run) counts.  The most launched shape
    of each kernel is also timed.  -> (search rows, segment-sum rows,
    held counts)."""
    for kernel, held in (("sorted_search", cap.search_all),
                         ("segment_sum", cap.segsum_all)):
        if len(held) != launches[kernel]["launches"]:
            raise AssertionError(
                f"{label}: {len(held)} {kernel} launches held of "
                f"{launches[kernel]['launches']} launched")
    exact = 0
    for values, gids, mask, out, g, _graph in cap.segsum_all:
        ok, is_exact, max_err = segment_sum_agrees(torch, CK, values, gids,
                                                   mask, g, out)
        if not ok:
            raise AssertionError(
                f"{label}: a segment sum at {(values.shape[0], g)} differs "
                f"from its plain version (max err {max_err}, "
                f"{'exact' if is_exact else 'tol'})")
        again = CK.segment_sum(values, gids, mask, g)
        if not torch.equal(again.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"{label}: a segment-sum launch at "
                                 f"{(values.shape[0], g)} gave other "
                                 f"bits on a second launch")
        exact += is_exact
    bad = [i for i, (s, q, out, _g) in enumerate(cap.search_all)
           if not torch.equal(out, CK.sorted_search_plain(s, q))]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} sorted searches "
                             f"differ from their plain version")
    search_rows, segsum_rows = [], []
    by_shape = {}
    for s, q, _out, graph in cap.search_all:
        by_shape.setdefault((s.shape[0], q.shape[0]), []).append(
            (s, q, graph))
    for (n, m), recs in sorted(by_shape.items()):
        s, q, graph = recs[-1]
        top = timed and len(recs) == max(len(r) for r in by_shape.values())
        search_rows.append(dict(check_sorted_search(
            torch, CK, f"{label}_n{n}_m{m}", s, q, timed=top), path=label,
            path_launches=len(recs), in_graph=graph))
    seg_shapes = {}
    for values, gids, mask, _out, g, _graph in cap.segsum_all:
        seg_shapes.setdefault((values.shape[0], g), []).append(
            (values, gids, mask))
    if seg_shapes and timed:
        (n, g), recs = max(seg_shapes.items(), key=lambda kv: len(kv[1]))
        segsum_rows.append(dict(check_segment_sum(
            torch, CK, f"{label}_n{n}_G{g}", *recs[-1], g),
            path=label, path_launches=len(recs)))
    held = {"sorted_search": len(cap.search_all),
            "segment_sum": len(cap.segsum_all),
            "segment_sum_bit_for_bit": exact,
            "segment_sum_within_tolerance": len(cap.segsum_all) - exact,
            "in_graph_replays": sum(1 for r in cap.search_all if r[-1])
            + sum(1 for r in cap.segsum_all if r[-1])}
    log(f"[{label}] held all {held['sorted_search']} sorted searches bit "
        f"for bit and all {held['segment_sum']} segment sums ({exact} "
        f"exact, {held['segment_sum_within_tolerance']} within rtol 1e-4 / "
        f"atol 1e-3), {held['in_graph_replays']} of them in graph "
        f"replays; each segment sum launched again for the same bits")
    return search_rows, segsum_rows, held


def table_host_bytes(table) -> int:
    return sum(a.nbytes for seg in table.segments
               for a in list(seg.arrays.values())
               + list(seg.validity.values()))


def run_sql(torch, session, sql: str):
    """-> (rows, result batch, seconds) of one run of `sql`."""
    t0 = time.perf_counter()
    res = session.execute(sql)
    rows = res.rows()
    torch.cuda.synchronize()
    return rows, res.batch, time.perf_counter() - t0


def agg_chunks() -> dict:
    """The grouped aggregate's chunk counts by path, so far."""
    from matrixone_tpu_torch.utils import metrics as M
    return {p: M.agg_chunks.get(path=p) for p in ("dense", "general")}


def sql_path(torch, CK, TK, label: str, session, sql: str, n_rows: int,
             check, kernel=None, top: int = 8):
    """One query on the card: the cold run (checked), the counted warm
    run with its kernel inputs captured (checked; `kernel`, if named,
    must launch; the aggregate's chunks by path counted with it), the
    best of 3 warm runs as rows/s of `n_rows`, and one profiled run."""
    rows, batch, cold_s = run_sql(torch, session, sql)
    check(rows, batch)
    CK.LAUNCHES.reset()
    chunks0 = agg_chunks()
    with PathInputs(torch, TK) as cap:
        rows, batch, _ = run_sql(torch, session, sql)
    chunks = {p: c - chunks0[p] for p, c in agg_chunks().items()}
    launches = kernel_launches(
        CK, label, ("sorted_search", "segment_sum", "segment_sum_walk",
                    "l2_distance_sq", "adc_score"),
        required=(kernel,) if kernel else ())
    check(rows, batch)
    warm = [run_sql(torch, session, sql)[2] for _ in range(3)]
    prof = profile_run(torch, lambda: session.execute(sql), label, top=top)
    out = {"cold_seconds": cold_s, "warm_seconds": warm,
           "rows_per_sec_best": n_rows / min(warm),
           "launches": launches, "agg_chunks": chunks, "profile": prof}
    log(f"[{label}] cold {cold_s:.3f}s warm {['%.3f' % w for w in warm]} "
        f"best {out['rows_per_sec_best']:.0f} rows/s")
    return out, cap


# --------------------------------------------- oracles shared by phases

def q3_rows_check(oracle, label: str):
    """Q3's rows against `q3_oracle`, in its integer domain."""
    epoch = __import__("datetime").date(1970, 1, 1)

    def check(rows, _batch):
        got = [(r[0], round(r[1] * 10000), (r[2] - epoch).days)
               for r in rows]
        if len(rows) != 10 or got != oracle:
            raise AssertionError(f"{label} Q3 rows differ from q3_oracle: "
                                 f"{got[:3]} vs {oracle[:3]}")
    return check


def group_by_check(v, errs: dict, label: str, groups: int = 1000):
    """5c's GROUP BY against numpy: sum(xi) exact, sum(xn) within rtol
    1e-4 / atol 1e-3 of the f64 sum (its max error goes into `errs`)."""
    grp = v["grp"]
    xi_exact = np.bincount(grp, weights=v["xi"].astype(np.int64),
                           minlength=groups)
    xn_f64 = np.bincount(grp, weights=v["xn"].astype(np.float64),
                         minlength=groups)

    def check(rows, _batch):
        if [r[0] for r in rows] != list(range(groups)):
            raise AssertionError(f"{label} GROUP BY: wrong groups")
        if [r[1] for r in rows] != xi_exact.tolist():
            raise AssertionError(f"{label} sum(xi) is not the exact "
                                 f"integer sum")
        got = np.asarray([r[2] for r in rows], np.float64)
        err = np.abs(got - xn_f64)
        errs["sum_xn_max_abs_err"] = float(err.max())
        if (err > 1e-4 * np.abs(xn_f64) + 1e-3).any():
            raise AssertionError(f"{label} sum(xn) max err {err.max()} past "
                                 f"rtol 1e-4 / atol 1e-3")
    return check


def q1_rows_check(lineitem, store: dict, label: str):
    """Q1 against `q1_oracle` exactly (`q1_exact`); `q1_check`'s own
    verdict goes into `store`."""
    from matrixone_tpu_torch.utils import tpch
    want = tpch.q1_oracle(lineitem)

    def check(rows, batch):
        bad = q1_exact(batch, want)
        if bad:
            raise AssertionError(f"{label} Q1 differs from q1_oracle: "
                                 f"{bad[:4]}")
        store["q1_check"] = tpch.q1_check(rows, want)
    return check


def q6_rows_check(lineitem, label: str):
    """Q6 against its integer oracle."""
    sel = ((lineitem["l_shipdate"] >= 8766) & (lineitem["l_shipdate"] < 9131)
           & (lineitem["l_discount"] >= 5) & (lineitem["l_discount"] <= 7)
           & (lineitem["l_quantity"] < 2400))
    rev = int((lineitem["l_extendedprice"][sel].astype(object)
               * lineitem["l_discount"][sel]).sum())

    def check(rows, _batch):
        if len(rows) != 1 or abs(rows[0][0] - rev / 10000) >= 1e-9:
            raise AssertionError(f"{label} Q6 {rows} differs from the "
                                 f"integer oracle {rev / 10000}")
    return check


def first_orders_by_year(orders):
    """8b's oracle: each customer's first orders (rank 1 by date)
    counted by year -> (rows, partitions, first orders)."""
    cust, odate = orders["o_custkey"], orders["o_orderdate"]
    order = np.lexsort((odate, cust))
    cs, ds = cust[order], odate[order]
    head = np.ones(len(cs), bool)
    head[1:] = cs[1:] != cs[:-1]
    first = np.maximum.accumulate(np.where(head, np.arange(len(cs)), 0))
    rank1 = ds[ds == ds[first]].astype("datetime64[D]")
    years, counts = np.unique(rank1.astype("datetime64[Y]").astype(np.int64)
                              + 1970, return_counts=True)
    return ([(int(y), int(c)) for y, c in zip(years, counts)],
            int(head.sum()), len(rank1))


def equal_rows_check(want, label: str):
    def check(rows, _batch):
        if rows != want:
            raise AssertionError(f"{label} {rows[:3]} != the oracle's "
                                 f"{want[:3]}")
    return check



def load_v_table(eng, n: int, seed: int) -> dict:
    """Create and load 5c's table v: id, grp = id % 1000, xi integer-
    valued in [0, 16) and xn N(0, 1), float32 -> its arrays."""
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.storage.engine import TableMeta
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    v = {"id": ids, "grp": ids % 1000,
         "xi": rng.integers(0, 16, n).astype(np.float32),
         "xn": rng.standard_normal(n).astype(np.float32)}
    eng.create_table(TableMeta("v", [("id", dt.INT64), ("grp", dt.INT64),
                                     ("xi", dt.FLOAT32), ("xn", dt.FLOAT32)],
                               ["id"]))
    eng.get_table("v").insert_numpy(v)
    return v


def phase_sql(torch, CK, args):
    """Phase 5: TPC-H Q3 and the float GROUP BY at scale factor 1."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.sql import plan as P
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.utils import tpch

    report = {}
    eng = Engine()
    t0 = time.perf_counter()
    lineitem = tpch.load_lineitem(eng, args.sf1_lineitem, seed=args.seed)
    q3data = tpch.load_tpch_q3(eng, args.sf1_lineitem // 4, seed=args.seed)
    load_q3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_v = args.sf1_lineitem
    v = load_v_table(eng, n_v, args.seed)
    load_v = time.perf_counter() - t0
    report["load"] = {
        "q3_tables_seconds": load_q3, "v_seconds": load_v,
        "rows": {t: eng.get_table(t).n_rows for t in eng.tables},
        "host_bytes": {t: table_host_bytes(eng.get_table(t))
                       for t in eng.tables}}
    log(f"[5a] loaded {report['load']['rows']} in {load_q3:.2f}s (Q3 "
        f"tables) + {load_v:.2f}s (v); host bytes "
        f"{report['load']['host_bytes']}")

    session = Session(catalog=eng, device="cuda")
    # phases 5-8 measure the per-operator path; phase 9 the fused one
    session.execute("set plan_fusion = 0")
    plan = P.explain(session.plan(tpch.Q3_SQL))
    log("[5b] the port's Q3 plan:\n" + plan)
    oracle = tpch.q3_oracle(lineitem, q3data)
    check_q3 = q3_rows_check(oracle, "5b")

    report["q3"], q3cap = sql_path(torch, CK, TK, "5b Q3", session,
                                   tpch.Q3_SQL, args.sf1_lineitem,
                                   check_q3, "sorted_search")
    report["q3"]["plan"] = plan
    log(f"[5b] Q3 rows exactly q3_oracle's; top row {oracle[0]}")

    gb_err = {}
    check_group_by = group_by_check(v, gb_err, "5c")

    report["group_by"], gbcap = sql_path(
        torch, CK, TK, "5c GROUP BY", session, GROUP_BY_SQL, n_v,
        check_group_by, "segment_sum")
    report["group_by"].update(gb_err)
    if {g for _, g in CK.LAUNCHES.shapes("segment_sum")} != {4096}:
        raise AssertionError("5c: the segment-sum kernel ran at "
                             f"{CK.LAUNCHES.shapes('segment_sum')}, not "
                             f"only at G = 4096")
    # the walk each launch of the counted run took, as the wrapper
    # counted it: head row 0-3 for the 16-byte walk, -1 for the scalar one
    heads = {h: c for h, c in report["group_by"]["launches"][
        "segment_sum_walk"]["by_shape"]}
    walk = {"launches": sum(heads.values()),
            "vector": sum(c for h, c in heads.items() if h >= 0),
            "heads": {str(h): c for h, c in sorted(heads.items())}}
    report["group_by"]["segment_sum_walk"] = walk
    log(f"[5c] segment sum: {walk['vector']} of {walk['launches']} "
        f"launches took the 16-byte walk (head rows {walk['heads']})")
    log(f"[5c] 1000 groups, sum(xi) exact, sum(xn) max err "
        f"{gb_err['sum_xn_max_abs_err']:.3e} of the f64 sum")

    # 5d: each kernel at each shape its path launched it with
    q3_counts = {tuple(r[:-1]): r[-1] for r in
                 report["q3"]["launches"]["sorted_search"]["by_shape"]}
    gb_counts = {tuple(r[:-1]): r[-1] for r in
                 report["group_by"]["launches"]["segment_sum"]["by_shape"]}
    if args.save_search_inputs:
        torch.save({(n, m): tuple(t.cpu() for t in q3cap.search[(n, m)])
                    for n, m in q3_counts}, args.save_search_inputs)
        log(f"[5d] Q3's sorted-search inputs saved to "
            f"{args.save_search_inputs}")
    search_rows = [dict(check_sorted_search(torch, CK, f"5b_q3_n{n}_m{m}",
                                            *q3cap.search[(n, m)]),
                        path="5b_q3", path_launches=c)
                   for (n, m), c in sorted(q3_counts.items())]
    if args.save_group_by_inputs:
        torch.save({(n, g): tuple(t.cpu() for t in gbcap.segsum[(n, g)])
                    for n, g in gb_counts}, args.save_group_by_inputs)
        log(f"[5d] 5c's segment-sum inputs saved to "
            f"{args.save_group_by_inputs}")
    segsum_rows = []
    for (n, g), c in sorted(gb_counts.items()):
        inputs = gbcap.segsum[(n, g)]
        row = dict(check_segment_sum(torch, CK, f"5c_n{n}_G{g}", *inputs,
                                     g), path="5c_group_by", path_launches=c)
        row.update(segsum_cold(torch, CK, row, inputs, g))
        activity, row["empty_traces"] = device_us_per_call(
            torch, lambda: CK.segment_sum(*inputs, g))
        row["device_kernels"] = sorted(activity)
        if any("segsum" not in k for k in row["device_kernels"]):
            raise AssertionError(f"5d: one segment-sum call ran "
                                 f"{row['device_kernels']}, not only the "
                                 f"kernel's own")
        segsum_rows.append(row)
    del q3cap, gbcap
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows, (session, lineitem, q3data, v)


Q1_SUMS = (("sum_qty", 2), ("sum_base_price", 2), ("sum_disc_price", 4),
           ("sum_charge", 6))
Q1_AVGS = (("avg_qty", 1e-9), ("avg_price", 1e-6), ("avg_disc", 1e-12))


def q1_exact(batch, oracle) -> list:
    """Q1's result batch against `q1_oracle`, on the values the engine
    holds: each sum as the scaled int64 of its DECIMAL, at the oracle's
    scale, and count_order, equal; the averages within `q1_check`'s own
    bounds.  `q1_check` reads the sums as Python floats, which hold an
    integer exactly only up to 2^53: at SF1, sum_charge x 10^6 is about
    2e16, so a float round trip can miss by up to 2 units where the
    engine is exact.  -> the differences found (none: equal)."""
    cols = [batch.columns[c] for c in batch.columns]
    keys = list(zip(cols[0].to_pylist(), cols[1].to_pylist()))
    bad = [] if len(keys) == len(oracle) else [("groups", len(keys))]
    for i, key in enumerate(keys):
        o = oracle.get(key)
        if o is None:
            bad.append((key, "not in the oracle"))
            continue
        for j, (name, scale) in enumerate(Q1_SUMS, start=2):
            if cols[j].dtype.scale != scale \
                    or int(cols[j].data[i]) != o[name]:
                bad.append((key, name, int(cols[j].data[i]), o[name]))
        for j, (name, tol) in enumerate(Q1_AVGS, start=6):
            if abs(float(cols[j].data[i]) - o[name]) > tol:
                bad.append((key, name, float(cols[j].data[i]), o[name]))
        if int(cols[9].data[i]) != o["count_order"]:
            bad.append((key, "count_order", int(cols[9].data[i])))
    return bad


#: 6a: the dense path's widest float layout: 256 slots (its group cap,
#: `MO_DENSE_GROUPS_MAX`) by 16 float lanes (256 x 16 = its 4096-field
#: cap)
DENSE_CAP_SLOTS, DENSE_CAP_LANES = 256, 16


def float_lane_sums(torch, n: int, G: int, L: int, seed: int) -> dict:
    """The dense path's f64 lane sums alone (`ops/agg._slot_sums`, the
    block sums over the rows sorted by slot) at n rows into G slots (+1
    spare) by L lanes, timed beside `index_add_` (the atomic sums the
    lanes used before, here the library call) on the same inputs: the
    same bits on 5 launches, and within 1e-12 of the summed magnitudes
    of `index_add_`'s sums."""
    from matrixone_tpu_torch.ops import agg as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, G + 1, (n,), generator=g, device="cuda")
    x = torch.randn((L, n), generator=g, device="cuda",
                    dtype=torch.float64) * 1e4
    xt = x.T.contiguous()

    def atomic(v=xt):
        return torch.zeros((G + 1, L), dtype=torch.float64,
                           device="cuda").index_add_(0, gid, v)[:G].T
    runs = [A._slot_sums(x, gid, G) for _ in range(5)]
    same_bits = all(torch.equal(r, runs[0]) for r in runs[1:])
    if not same_bits:
        raise AssertionError(f"6a lane sums G={G} L={L}: other bits on 5 "
                             f"launches")
    err = float(((runs[0] - atomic()).abs()
                 / atomic(xt.abs()).clamp_min(1e-300)).max())
    if err > 1e-12:
        raise AssertionError(f"6a lane sums G={G} L={L}: {err:.3e} of the "
                             f"summed magnitudes from index_add_'s sums")
    ms = cuda_time_ms(lambda: A._slot_sums(x, gid, G))
    lib_ms = cuda_time_ms(atomic)
    out = {"n": n, "slots": G, "lanes": L, "same_bits_5_launches": True,
           "max_err_of_magnitude_vs_index_add": err, "ms": ms,
           "index_add_ms": lib_ms, "queued": ms.queued and lib_ms.queued}
    log(f"[6a] f64 lane sums n={n} G={G} L={L}: sorted blocks {ms:.3f} ms, "
        f"index_add_ {lib_ms:.3f} ms, same bits on 5 launches, {err:.2e} "
        f"of the magnitudes from index_add_'s")
    del runs, x, xt
    return out


def dense_lanes_check(torch, n: int, seed: int) -> dict:
    """Q1's dense lane partials (`ops/agg.dense_lane_partials`: two keys
    of 3 and 2 codes with NULLs, 4 int64 and 3 float64 lanes, some
    masked) at n rows on the card against the CPU on the same inputs:
    int lanes and rows exact, float lanes within rtol 1e-12; then 5
    launches on the same inputs, whose float lanes (block sums over the
    rows sorted by slot) must come out with the same bits every time.
    Then the float lane sums alone at Q1's layout and at the dense
    path's widest, beside `index_add_`.  Plain torch, so no kernel
    count."""
    from matrixone_tpu_torch.ops import agg as A
    rng = np.random.default_rng(seed)
    codes = [torch.from_numpy(rng.integers(0, s, n).astype(np.int8))
             for s in (3, 2)]
    valids = [torch.from_numpy(rng.random(n) < 0.99) for _ in range(2)]
    row_mask = torch.from_numpy(rng.random(n) < 0.98)
    masks = [None, torch.from_numpy(rng.random(n) < 0.9)]
    ints = [torch.from_numpy(rng.integers(0, 10 ** 7, n)) for _ in range(4)]
    floats = [torch.from_numpy(rng.standard_normal(n) * 1e4)
              for _ in range(3)]
    args = (codes, valids, row_mask, ints, [None, masks[1], None, masks[1]],
            floats, [None, masks[1], masks[1]])
    kw = {"sizes": (3, 2), "with_null": True}

    def on(dev, a):
        if isinstance(a, list):
            return [on(dev, x) for x in a]
        return None if a is None else a.to(dev)
    host = A.dense_lane_partials(*args, **kw)
    card_args = on("cuda", list(args))
    runs = [tuple(t.cpu() for t in A.dense_lane_partials(*card_args, **kw))
            for _ in range(5)]
    got = runs[0]
    if not (torch.equal(got[0], host[0]) and torch.equal(got[2], host[2])):
        raise AssertionError("6a dense lanes: int lanes or rows differ "
                             "from the CPU's")
    rel = float(((got[1] - host[1]).abs()
                 / host[1].abs().clamp_min(1e-300)).max())
    if rel > 1e-12:
        raise AssertionError(f"6a dense lanes: float lanes {rel:.3e} from "
                             f"the CPU's, past rtol 1e-12")
    same_bits = all(torch.equal(r[1], got[1]) for r in runs[1:])
    if not same_bits:
        raise AssertionError("6a dense lanes: the float lanes gave other "
                             "bits on 5 launches")
    ms = cuda_time_ms(lambda: A.dense_lane_partials(*card_args, **kw))
    out = {"n": n, "float_max_rel_err_vs_cpu": rel,
           "float_same_bits_5_launches": same_bits,
           "int_exact": True, "ms": ms, "queued": ms.queued}
    log(f"[6a] dense lane partials n={n}: int exact, float max rel err "
        f"{rel:.3e} vs the CPU, same float bits on 5 launches: "
        f"{same_bits}; {ms:.3f} ms (summed by index_add_ atomics: 15.20 "
        f"ms)")
    del runs, card_args
    out["float_lane_sums"] = {
        "q1": float_lane_sums(torch, n, 12, 3, seed),
        "cap": float_lane_sums(torch, n, DENSE_CAP_SLOTS, DENSE_CAP_LANES,
                               seed)}
    return out


#: phase 6b's scale factor: lineitem 600K rows.  At SF1 the sqlite3
#: oracle loads about 10x longer, and Q16 and Q21 raise (DISTINCT's group
#: cap, the join's build budget; PERF.md section 4)
TPCH_SF = 0.1
#: sqlite3's answers to the 22 over 6b's tables before any refresh, by
#: query: 9c and 18c compare with them instead of asking sqlite3 again
SQLITE_SF01: dict = {}


def phase_tpch(torch, CK, args, sf1) -> tuple:
    """Phase 6: Q1 and Q6 on phase 5's SF1 lineitem, then the 22 TPC-H
    queries at scale factor `TPCH_SF` against sqlite3."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.utils import tpch, tpch_full

    session, lineitem = sf1[:2]
    n = args.sf1_lineitem
    report = {}
    q1_float = {}
    check_q1 = q1_rows_check(lineitem, q1_float, "6a")

    report["q1"], _ = sql_path(torch, CK, TK, "6a Q1", session,
                               tpch.Q1_SQL, n, check_q1)
    report["q1"]["q1_check"] = q1_float["q1_check"]
    log(f"[6a] Q1 equals q1_oracle exactly (scaled int64 sums, counts; "
        f"averages within q1_check's bounds); q1_check itself, which "
        f"reads the sums through floats: {q1_float['q1_check']}")
    chunks = report["q1"]["agg_chunks"]
    if chunks["dense"] == 0 or chunks["general"] != 0:
        raise AssertionError(f"6a Q1's aggregate did not take the dense "
                             f"path on every chunk: {chunks}")
    check_q6 = q6_rows_check(lineitem, "6a")
    report["q6"], _ = sql_path(torch, CK, TK, "6a Q6", session,
                               tpch.Q6_SQL, n, check_q6)
    for q in ("q1", "q6"):
        r = report[q]
        log(f"[6a] {q.upper()} at SF1: {r['rows_per_sec_best']:.0f} "
            f"lineitem rows/s (best of 3 warm), cold "
            f"{r['cold_seconds']:.3f}s, device busy "
            f"{r['profile']['device_busy_share']:.1%}, chunks "
            f"{r['agg_chunks']}")

    report["dense_lanes"] = dense_lanes_check(torch, n, args.seed)

    # 6b: the 22 queries at a reduced scale factor, against sqlite3
    eng = Engine()
    t0 = time.perf_counter()
    tables = tpch_full.load_tpch(eng, sf=TPCH_SF, seed=args.seed)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conn = tpch_full.to_sqlite(tables)
    sqlite_s = time.perf_counter() - t0
    rows_of = {t: eng.get_table(t).n_rows for t in eng.tables}
    report["tpch22"] = {"sf": TPCH_SF, "load_seconds": load_s,
                        "sqlite_load_seconds": sqlite_s, "rows": rows_of,
                        "queries": {}}
    log(f"[6b] TPC-H sf {TPCH_SF}: {rows_of}, loaded in "
        f"{load_s:.2f}s, sqlite3 oracle in {sqlite_s:.2f}s")
    sess = Session(catalog=eng, device="cuda")
    sess.execute("set plan_fusion = 0")
    captured = {}
    for q in sorted(tpch_full.QUERIES):
        sql = tpch_full.QUERIES[q]
        t0 = time.perf_counter()
        want = tpch_full.normalize_rows(
            conn.execute(tpch_full.to_sqlite_sql(sql)).fetchall())
        sqlite_q = time.perf_counter() - t0
        SQLITE_SF01[q] = want

        def check(rows, _batch, q=q, want=want):
            if not tpch_full.rows_match(tpch_full.normalize_rows(rows),
                                        want):
                raise AssertionError(f"6b Q{q}: rows differ from sqlite3")

        # the hold: the first (cold) run of the query and sqlite3's
        t0 = time.perf_counter()
        tpch_full.run_compare(sess, conn, q)
        compare_s = time.perf_counter() - t0
        r, cap = sql_path(torch, CK, TK, f"6b Q{q}", sess, sql,
                          rows_of["lineitem"], check, top=0)
        for key, val in cap.search.items():
            captured.setdefault(key, val)
        out = {"warm_seconds_best": min(r["warm_seconds"]),
               "run_compare_seconds": compare_s,
               "sqlite_seconds": sqlite_q, "result_rows": len(want),
               "sorted_search": r["launches"]["sorted_search"]["launches"],
               "sorted_search_by_shape":
                   r["launches"]["sorted_search"]["by_shape"],
               "segment_sum": r["launches"]["segment_sum"]["launches"],
               "agg_chunks": r["agg_chunks"],
               "device_busy_share": r["profile"]["device_busy_share"]}
        report["tpch22"]["queries"][q] = out
        log(f"[6b] Q{q:<2d} = sqlite3 ({len(want)} rows): warm "
            f"{out['warm_seconds_best']:.4f}s (run_compare "
            f"{out['run_compare_seconds']:.3f}s) sorted_search "
            f"{out['sorted_search']} segment_sum {out['segment_sum']} "
            f"busy {out['device_busy_share']:.1%} chunks "
            f"{out['agg_chunks']}")
    counts = {}
    for out in report["tpch22"]["queries"].values():
        for *shape, c in out["sorted_search_by_shape"]:
            counts[tuple(shape)] = counts.get(tuple(shape), 0) + c
    if not counts:
        raise AssertionError("6b: the 22 queries never launched the "
                             "sorted-search kernel")
    top_shape = max(counts, key=counts.get)
    search_rows = [dict(check_sorted_search(
        torch, CK, f"6b_n{n_}_m{m_}", *captured[(n_, m_)],
        timed=(n_, m_) == top_shape), path="6b_tpch22", path_launches=c)
        for (n_, m_), c in sorted(counts.items())]
    log(f"[6b] sorted search bit-identical at all {len(counts)} shapes "
        f"the 22 launched it with; timed at {top_shape}")
    del captured
    torch.cuda.empty_cache()
    return report, search_rows, (sess, conn, tables)


def run_statements(torch, session, statements) -> tuple:
    """-> (seconds, the last statement's `affected`, {"parse_seconds":
    the parser alone over the same text, "commit_seconds": the last
    statement's}) of a refresh run statement by statement through
    `Session.execute`."""
    from matrixone_tpu_torch.sql.parser import parse
    t0 = time.perf_counter()
    for sql in statements:
        parse(sql)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    affected = 0
    for sql in statements:
        t1 = time.perf_counter()
        affected = session.execute(sql).affected
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return t2 - t0, affected, {"parse_seconds": parse_s,
                               "commit_seconds": t2 - t1}


def refresh_22(torch, CK, TK, label: str, sess, conn) -> tuple:
    """The 22 queries, each held to sqlite3 by `run_compare` on one run
    whose sorted-search and segment-sum launches are counted by shape and
    whose kernel inputs are captured; then both kernels held against
    their plain versions at every shape the 22 launched them with, on
    those inputs (the search timed at its most launched shape) ->
    (per-query record, search rows, segment-sum rows)."""
    from matrixone_tpu_torch.utils import tpch_full
    path = label.replace(" ", "_").lower()
    out, search_in, segsum_in = {}, {}, {}
    for q in sorted(tpch_full.QUERIES):
        CK.LAUNCHES.reset()
        chunks0 = agg_chunks()
        t0 = time.perf_counter()
        with PathInputs(torch, TK) as cap:
            tpch_full.run_compare(sess, conn, q)
        seconds = time.perf_counter() - t0
        for key, val in cap.search.items():
            search_in.setdefault(key, val)
        for key, val in cap.segsum.items():
            segsum_in.setdefault(key, val)
        out[q] = {"run_compare_seconds": seconds,
                  "sorted_search": CK.LAUNCHES.get("sorted_search"),
                  "sorted_search_by_shape": [
                      [*k, v] for k, v in sorted(
                          CK.LAUNCHES.shapes("sorted_search").items())],
                  "segment_sum": CK.LAUNCHES.get("segment_sum"),
                  "segment_sum_by_shape": [
                      [*k, v] for k, v in sorted(
                          CK.LAUNCHES.shapes("segment_sum").items())],
                  "agg_chunks": {p: c - chunks0[p]
                                 for p, c in agg_chunks().items()}}
    joins = [q for q in out if q not in (1, 6)]
    missing = [q for q in joins if out[q]["sorted_search"] == 0]
    if missing:
        raise AssertionError(f"{label}: Q{missing} launched no sorted "
                             f"search")
    log(f"[{label}] the 22 = sqlite3; sorted-search launches "
        f"{ {q: r['sorted_search'] for q, r in out.items()} }; "
        f"run_compare {sum(r['run_compare_seconds'] for r in out.values()):.2f}s"
        f" in all")

    def by_shape(kernel):
        counts = {}
        for r in out.values():
            for *shape, c in r[f"{kernel}_by_shape"]:
                counts[tuple(shape)] = counts.get(tuple(shape), 0) + c
        return counts

    counts = by_shape("sorted_search")
    top = max(counts, key=counts.get)
    search_rows = [dict(check_sorted_search(
        torch, CK, f"{path}_n{n_}_m{m_}", *search_in[(n_, m_)],
        timed=(n_, m_) == top), path=path, path_launches=c)
        for (n_, m_), c in sorted(counts.items())]
    segsum_rows = [dict(check_segment_sum(
        torch, CK, f"{path}_n{n_}_G{g}", *segsum_in[(n_, g)], g),
        path=path, path_launches=c)
        for (n_, g), c in sorted(by_shape("segment_sum").items())]
    log(f"[{label}] sorted search bit-identical at all {len(counts)} "
        f"shapes the 22 launched it with, timed at {top}; segment sum "
        f"held at {len(segsum_rows)} shapes")
    del search_in, segsum_in
    return out, search_rows, segsum_rows


def phase_refresh_sf01(torch, CK, args, sf01) -> tuple:
    """Phase 7a: TPC-H's refresh functions on 6b's session and sqlite3
    connection, the 22 after each (both kernels held against their plain
    versions at every shape each run of the 22 launched them with), then
    a rollback, a duplicate key and the re-insert of a deleted key ->
    (report, search rows, segment-sum rows)."""
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage.engine import DuplicateKeyError
    from matrixone_tpu_torch.utils import tpch_full
    sess, conn, tables = sf01
    report = {}
    rf1 = tpch_full.rf1(tables, TPCH_SF, seed=args.seed + 1)
    rf1_s, _, _ = run_statements(torch, sess, rf1.statements)
    t0 = time.perf_counter()
    tpch_full.apply_sqlite(conn, rf1.statements)
    sqlite_rf1_s = time.perf_counter() - t0
    tables = tpch_full.apply_refresh(tables, rf1)
    rf1_rows = sum(len(next(iter(a.values()))) for a in rf1.inserts.values())
    report["rf1"] = {"seconds": rf1_s, "rows": rf1_rows,
                     "statements": len(rf1.statements),
                     "sqlite_seconds": sqlite_rf1_s}
    log(f"[7a] RF1 at sf {TPCH_SF}: {rf1_rows} rows in "
        f"{len(rf1.statements)} statements, {rf1_s:.3f}s "
        f"(sqlite3 {sqlite_rf1_s:.3f}s)")
    report["after_rf1"], search_rows, segsum_rows = refresh_22(
        torch, CK, TK, "7a after RF1", sess, conn)
    q1_chunks = report["after_rf1"][1]["agg_chunks"]
    log(f"[7a] Q1 after RF1: aggregate chunks {q1_chunks} over "
        f"{len(sess.catalog.get_table('lineitem').segments)} segments")
    rf2 = tpch_full.rf2(tables, TPCH_SF, seed=args.seed + 2)
    rf2_s, rf2_rows, _ = run_statements(torch, sess, rf2.statements)
    t0 = time.perf_counter()
    tpch_full.apply_sqlite(conn, rf2.statements)
    sqlite_rf2_s = time.perf_counter() - t0
    before_rf2 = tables
    tables = tpch_full.apply_refresh(tables, rf2)
    want = sum(len(before_rf2[t][c]) - len(tables[t][c]) for t, c in
               (("orders", "o_orderkey"), ("lineitem", "l_orderkey")))
    if rf2_rows != want:
        raise AssertionError(f"7a RF2 deleted {rf2_rows} rows, not {want}")
    report["rf2"] = {"seconds": rf2_s, "rows": rf2_rows,
                     "statements": len(rf2.statements),
                     "sqlite_seconds": sqlite_rf2_s}
    log(f"[7a] RF2: {rf2_rows} rows deleted in {len(rf2.statements)} "
        f"statements, {rf2_s:.3f}s (sqlite3 {sqlite_rf2_s:.3f}s)")
    report["after_rf2"], search2, segsum2 = refresh_22(
        torch, CK, TK, "7a after RF2", sess, conn)
    search_rows += search2
    segsum_rows += segsum2

    q1, q3 = tpch_full.QUERIES[1], tpch_full.QUERIES[3]
    held = (sess.execute(q1).rows(), sess.execute(q3).rows())
    # a second RF1 batch with fresh keys, rolled back
    again = tpch_full.rf1(tables, TPCH_SF, seed=args.seed + 3)
    for sql in again.statements[:-1]:
        sess.execute(sql)
    sess.execute("rollback")
    if (sess.execute(q1).rows(), sess.execute(q3).rows()) != held:
        raise AssertionError("7a: a rolled-back RF1 changed Q1 or Q3")
    # a live key inserted again: DuplicateKeyError at COMMIT, no change
    live = tpch_full.insert_orders(tables, tables["orders"]["o_orderkey"][:1])
    for sql in live.statements[:-1]:
        sess.execute(sql)
    try:
        sess.execute("commit")
    except DuplicateKeyError as e:
        dup = str(e)
    else:
        raise AssertionError("7a: re-inserting a live order committed")
    if (sess.execute(q1).rows(), sess.execute(q3).rows()) != held:
        raise AssertionError("7a: a refused commit changed Q1 or Q3")
    # an order RF2 deleted, inserted again with its lineitems
    back = tpch_full.insert_orders(before_rf2, rf2.delete_keys[:1])
    for sql in back.statements:
        sess.execute(sql)
    tpch_full.apply_sqlite(conn, back.statements)
    tpch_full.run_compare(sess, conn, 3)
    report["checks"] = {"rollback": "Q1, Q3 unchanged",
                        "duplicate_key": dup,
                        "reinsert": f"order {int(rf2.delete_keys[0])} "
                                    f"and its lineitems, Q3 = sqlite3"}
    log(f"[7a] rollback: Q1 and Q3 unchanged; duplicate key at COMMIT "
        f"({dup}), nothing changed; order {int(rf2.delete_keys[0])} "
        f"re-inserted after RF2, Q3 = sqlite3")
    conn.close()
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


#: phase 7b's self-join of v with its snapshot: both sides filtered to
#: 3,000,000 rows, below the join's build budget of 2^22 rows
SNAPSHOT_JOIN_SQL = (
    "select count(*), sum(cur.xn - old.xn) from v cur join v as of "
    "snapshot 's' old on cur.id = old.id where cur.grp < 500 and "
    "old.grp < 500")
UPDATE_SQL = "update v set xn = xn + 1 where grp = 7"


#: the lineitem columns Q1 scans
Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]


def scan_split(torch, session, views) -> dict:
    """What a refresh costs the scan, taken apart: for each view of
    `views` ({label: (snapshot ts, lineitem rows there)}), Q1 through
    `AS OF TIMESTAMP` (best of 3 warm seconds) and the engine's
    `iter_chunks` alone over Q1's columns (its chunks and the best of 2
    host seconds: the slicing, and the copies through keep masks where
    rows are dead) -> {label: record}.  Each view's row count is held
    to `count(*)` at its timestamp."""
    from matrixone_tpu_torch.utils import tpch
    table = session.catalog.get_table("lineitem")
    batch_rows = int(session.variables.get("batch_rows", 1 << 20))
    out = {}
    for label, (ts, n_rows) in views.items():
        at = f"from lineitem as of timestamp {ts}"
        got = session.execute(f"select count(*) {at}").rows()[0][0]
        if got != n_rows:
            raise AssertionError(f"7b {label}: {got} lineitem rows at ts "
                                 f"{ts}, not {n_rows}")
        sql = tpch.Q1_SQL.replace("from lineitem", at)
        run_sql(torch, session, sql)
        warm = [run_sql(torch, session, sql)[2] for _ in range(3)]
        scans = []
        for _ in range(2):
            t0 = time.perf_counter()
            chunks = sum(1 for _ in table.iter_chunks(
                Q1_COLUMNS, batch_rows, snapshot_ts=ts))
            scans.append(time.perf_counter() - t0)
        out[label] = {"rows": n_rows, "q1_warm_seconds_best": min(warm),
                      "iter_chunks_seconds_best": min(scans),
                      "chunks": chunks}
        log(f"[7b] Q1 {label} ({n_rows} rows, {chunks} chunks): warm "
            f"{min(warm):.4f}s, iter_chunks alone {min(scans):.4f}s")
    return out


def phase_refresh_sf1(torch, CK, args, sf1) -> tuple:
    """Phase 7b: RF1 and RF2 at scale factor 1 on phase 5's tables with a
    snapshot reader open across them; Q1, Q3 and Q6 against oracles of
    the refreshed arrays; an UPDATE under a named snapshot, the float
    GROUP BY after it, and v joined with its own snapshot."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.utils import tpch, tpch_full

    session, lineitem, q3data, v = sf1
    eng = session.catalog
    n = args.sf1_lineitem
    report = {}
    q3_pre = session.execute(tpch.Q3_SQL).rows()
    reader = Session(catalog=eng, device="cuda")
    reader.execute("set plan_fusion = 0")
    reader.execute("begin")
    tables = {"lineitem": lineitem, "orders": q3data["orders"]}
    rf1 = tpch_full.rf1(tables, 1.0, seed=args.seed + 4, q3data=q3data)
    ts_before = eng.committed_ts
    from matrixone_tpu_torch import native
    from matrixone_tpu_torch.utils import metrics as M
    k0, s0 = M.pk_check_seconds.get(), M.pk_bloom_suspects.get()
    rf1_s, _, rf1_parts = run_statements(torch, session, rf1.statements)
    rf1_parts.update(key_check_seconds=M.pk_check_seconds.get() - k0,
                     bloom_suspects=M.pk_bloom_suspects.get() - s0,
                     host_library=native.route())
    ts_rf1 = eng.committed_ts
    tables = tpch_full.apply_refresh(tables, rf1)
    rf1_rows = sum(len(next(iter(a.values()))) for a in rf1.inserts.values())
    rf2 = tpch_full.rf2(tables, 1.0, seed=args.seed + 5)
    rf2_s, rf2_rows, rf2_parts = run_statements(torch, session,
                                                rf2.statements)
    after = tpch_full.apply_refresh(tables, rf2)
    want = sum(len(tables[t][c]) - len(after[t][c]) for t, c in
               (("orders", "o_orderkey"), ("lineitem", "l_orderkey")))
    if rf2_rows != want:
        raise AssertionError(f"7b RF2 deleted {rf2_rows} rows, not {want}")
    lineitem2 = after["lineitem"]
    q3data2 = dict(q3data, orders=after["orders"])
    report["rf1"] = {"seconds": rf1_s, "rows": rf1_rows,
                     "rows_per_sec": rf1_rows / rf1_s,
                     "statements": len(rf1.statements), **rf1_parts}
    report["rf2"] = {"seconds": rf2_s, "rows": rf2_rows,
                     "rows_per_sec": rf2_rows / rf2_s,
                     "statements": len(rf2.statements), **rf2_parts}
    for rf in ("rf1", "rf2"):
        r = report[rf]
        log(f"[7b] {rf.upper()} at SF1: {r['rows']} rows in "
            f"{r['seconds']:.3f}s ({r['rows_per_sec']:.0f} rows/s); the "
            f"parser alone {r['parse_seconds']:.3f}s, the COMMIT "
            f"{r['commit_seconds']:.3f}s")
    r = report["rf1"]
    log(f"[7b] RF1's primary-key checks {r['key_check_seconds']:.3f}s with "
        f"the bloom filter ({r['host_library']} library), "
        f"{r['bloom_suspects']:.0f} suspects; without the filter: COMMIT "
        f"7.98s, key check 6.58s")

    q1_want = tpch.q1_oracle(lineitem2)

    def check_q1(_rows, batch):
        bad = q1_exact(batch, q1_want)
        if bad:
            raise AssertionError(f"7b Q1 differs from q1_oracle: {bad[:4]}")

    report["q1"], _ = sql_path(torch, CK, TK, "7b Q1", session,
                               tpch.Q1_SQL, n, check_q1)
    oracle = tpch.q3_oracle(lineitem2, q3data2)
    epoch = __import__("datetime").date(1970, 1, 1)

    def q3_key(rows):
        return [(r[0], round(r[1] * 10000), (r[2] - epoch).days)
                for r in rows]

    def check_q3(rows, _batch):
        if q3_key(rows) != oracle:
            raise AssertionError(f"7b Q3 rows differ from q3_oracle: "
                                 f"{q3_key(rows)[:3]} vs {oracle[:3]}")

    report["q3"], q3cap = sql_path(torch, CK, TK, "7b Q3", session,
                                   tpch.Q3_SQL, n, check_q3,
                                   "sorted_search")
    li = lineitem2
    sel = ((li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131)
           & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
           & (li["l_quantity"] < 2400))
    q6_rev = int((li["l_extendedprice"][sel].astype(object)
                  * li["l_discount"][sel]).sum())

    def check_q6(rows, _batch):
        if len(rows) != 1 or abs(rows[0][0] - q6_rev / 10000) >= 1e-9:
            raise AssertionError(f"7b Q6 {rows} differs from the integer "
                                 f"oracle {q6_rev / 10000}")

    report["q6"], _ = sql_path(torch, CK, TK, "7b Q6", session,
                               tpch.Q6_SQL, n, check_q6)
    report["scan_split"] = scan_split(torch, session, {
        "before the refresh": (ts_before, n),
        "after RF1 (its segments, no tombstones)":
            (ts_rf1, len(tables["lineitem"]["l_orderkey"])),
        "after RF2 (its tombstones too)":
            (eng.committed_ts, len(lineitem2["l_orderkey"]))})
    # the reader's view: Q3 (whose top 10 a refresh of 0.1% of the
    # orders may leave as it was) and the two tables' row counts (which
    # it changes), before and after its COMMIT
    q3_post = session.execute(tpch.Q3_SQL).rows()
    counts = ("select (select count(*) from lineitem), "
              "(select count(*) from orders)")
    pre = (q3_pre, [(len(lineitem["l_orderkey"]),
                     len(q3data["orders"]["o_orderkey"]))])
    post = (q3_post, [(len(lineitem2["l_orderkey"]),
                       len(q3data2["orders"]["o_orderkey"]))])
    if pre[1] == post[1]:
        raise AssertionError("7b: the refresh changed no row count")
    seen = (reader.execute(tpch.Q3_SQL).rows(),
            reader.execute(counts).rows())
    if seen != pre:
        raise AssertionError(f"7b: the snapshot reader saw the refresh: "
                             f"{seen[1]} rows, not {pre[1]}")
    reader.execute("commit")
    seen = (reader.execute(tpch.Q3_SQL).rows(),
            reader.execute(counts).rows())
    if seen != post or session.execute(counts).rows() != post[1]:
        raise AssertionError(f"7b: after COMMIT the reader sees {seen[1]} "
                             f"rows, not the refreshed {post[1]}")
    report["snapshot_reader"] = {"rows_before": pre[1][0],
                                 "rows_after": post[1][0],
                                 "q3_changed": q3_post != q3_pre}
    log(f"[7b] Q1, Q3, Q6 exact to the refreshed oracles; the snapshot "
        f"reader saw the pre-refresh Q3 and row counts {pre[1][0]} until "
        f"its COMMIT, then {post[1][0]} (Q3's top 10 changed: "
        f"{q3_post != q3_pre})")

    session.execute("create snapshot s")
    t0 = time.perf_counter()
    upd = session.execute(UPDATE_SQL).affected
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    grp = v["grp"]
    if upd != int((grp == 7).sum()):
        raise AssertionError(f"7b UPDATE changed {upd} rows")
    xn2 = v["xn"].copy()
    xn2[grp == 7] += np.float32(1)
    xi_exact = np.bincount(grp, weights=v["xi"].astype(np.int64),
                           minlength=1000)
    xn_f64 = np.bincount(grp, weights=xn2.astype(np.float64),
                         minlength=1000)
    gb_err = {}

    def check_group_by(rows, _batch):
        if [r[0] for r in rows] != list(range(1000)):
            raise AssertionError("7b GROUP BY: wrong groups")
        if [r[1] for r in rows] != xi_exact.tolist():
            raise AssertionError("7b sum(xi) is not the exact integer sum")
        err = np.abs(np.asarray([r[2] for r in rows], np.float64) - xn_f64)
        gb_err["sum_xn_max_abs_err"] = float(err.max())
        if (err > 1e-4 * np.abs(xn_f64) + 1e-3).any():
            raise AssertionError(f"7b sum(xn) max err {err.max()} past "
                                 f"rtol 1e-4 / atol 1e-3")

    report["update"] = {"seconds": upd_s, "rows": upd}
    log(f"[7b] UPDATE v: {upd} rows in {upd_s:.3f}s")
    report["group_by"], gbcap = sql_path(
        torch, CK, TK, "7b GROUP BY", session, GROUP_BY_SQL, n,
        check_group_by, "segment_sum")
    report["group_by"].update(gb_err)

    half = int((grp < 500).sum())

    def check_join(rows, _batch):
        cnt, diff = rows[0]
        if cnt != half or abs(diff - upd) > 1e-4 * upd + 1e-3:
            raise AssertionError(f"7b snapshot join: count {cnt}, sum "
                                 f"{diff}; want {half} and {upd}")
        report["snapshot_join_sum"] = diff

    report["snapshot_join"], joincap = sql_path(
        torch, CK, TK, "7b snapshot join", session, SNAPSHOT_JOIN_SQL,
        2 * n, check_join, "sorted_search")
    log(f"[7b] v joined with snapshot 's': {half} rows, sum of the "
        f"differences {report['snapshot_join_sum']!r} (want {upd})")

    search_rows = []
    for label, rec, cap in (("7b_q3", report["q3"], q3cap),
                            ("7b_snapshot_join", report["snapshot_join"],
                             joincap)):
        counts = {tuple(r[:-1]): r[-1] for r in
                  rec["launches"]["sorted_search"]["by_shape"]}
        top = max(counts, key=counts.get)
        search_rows += [dict(check_sorted_search(
            torch, CK, f"{label}_n{n_}_m{m_}", *cap.search[(n_, m_)],
            timed=(n_, m_) == top), path=label, path_launches=c)
            for (n_, m_), c in sorted(counts.items())]
    counts = {tuple(r[:-1]): r[-1] for r in
              report["group_by"]["launches"]["segment_sum"]["by_shape"]}
    segsum_rows = [dict(check_segment_sum(torch, CK, f"7b_n{n_}_G{g}",
                                          *gbcap.segsum[(n_, g)], g),
                        path="7b_group_by_after_update", path_launches=c)
                   for (n_, g), c in sorted(counts.items())]
    del q3cap, gbcap, joincap
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


GROUP_BY_SQL = ("select grp, sum(xi), sum(xn) from v group by grp "
                "order by grp")


#: phase 8a: TPC-DS q97's "only here, only there, both" over two sets of
#: orders: those with a returned line, those with a line shipped after
#: the cutoff.  Returned lines were all received by 1995-06-17; with
#: that date as the cutoff the orders with only returned lines would be
#: under 1% of the keys, with this one they are about 4%
FULL_OUTER_CUTOFF = "1996-06-01"
FULL_OUTER_SQL = f"""
select sum(case when b.k is null then 1 else 0 end) only_returned,
       sum(case when a.k is null then 1 else 0 end) only_late,
       sum(case when a.k is not null and b.k is not null then 1 else 0
           end) both_
from (select l_orderkey k from lineitem where l_returnflag = 'R'
      group by l_orderkey) a
full outer join
     (select l_orderkey k from lineitem
      where l_shipdate > date '{FULL_OUTER_CUTOFF}' group by l_orderkey) b
on a.k = b.k"""

#: 8b: each customer's first order, counted by year (about 150K
#: partitions, past the window's max_partitions of 65536)
FIRST_ORDER_SQL = """
select year(o_orderdate) y, count(*) from
  (select o_orderdate,
          rank() over (partition by o_custkey order by o_orderdate) rk
   from orders) q
where rk = 1 group by year(o_orderdate) order by y"""

#: 8b: a running sum and a 10-row moving average and maximum over all
#: of v, about 60 rows of it read back
FRAME_STRIDE = 100003
FRAMES_SQL = f"""
select id, s, a, m from
  (select id,
          sum(xi) over (partition by grp order by id) s,
          avg(xn) over (partition by grp order by id
                        rows between 9 preceding and current row) a,
          max(xn) over (partition by grp order by id
                        rows between 9 preceding and current row) m
   from v) q
where id % {FRAME_STRIDE} = 0 order by id"""

#: 8c: 5c's GROUP BY over the two halves of v put back together
UNION_GROUP_BY_SQL = """
select grp, sum(xi), sum(xn) from
  (select grp, xi, xn from v where id < 3000000
   union all
   select grp, xi, xn from v where id >= 3000000) u
group by grp order by grp"""
UNION_DISTINCT_SQL = ("select c_mktsegment s from customer union "
                      "select l_returnflag from lineitem order by s")

#: 8d: each statement binds its Sample node with this seed
SAMPLE_SEED = 8
SAMPLE_PERCENT_SQL = "select count(*) from lineitem sample 10 percent"
SAMPLE_ROWS_SQL = "select id from v sample 1000 rows"
TIME_BUCKET_SQL = ("select time_bucket(l_shipdate, 30) b, count(*), "
                   "sum(l_quantity) from lineitem group by "
                   "time_bucket(l_shipdate, 30) order by b")

#: 8e: a comma (cross) join and a join on a non-equi ON
CROSS_SQL = ("select count(*) from customer, orders where c_custkey <= 2000 "
             "and o_orderkey <= 4096")
NON_EQUI_SQL = ("select count(*) from customer join orders on c_custkey < "
                "o_custkey where c_custkey <= 2000 and o_orderkey <= 4096")


class SeededSession:
    """`session` with the binder's Sample seed counter set to `seed`
    before each statement, so every run of a query draws one sample."""

    def __init__(self, session, seed: int):
        self.session, self.seed = session, seed

    def _reset(self):
        from matrixone_tpu_torch.sql import binder
        binder._sample_seed = itertools.count(self.seed)

    def execute(self, sql: str):
        self._reset()
        return self.session.execute(sql)

    def plan(self, sql: str):
        self._reset()
        return self.session.plan(sql)


def sample_seeds(node) -> list:
    """The seeds of the Sample nodes of a plan."""
    out = [node.seed] if type(node).__name__ == "Sample" else []
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            out += sample_seeds(getattr(node, attr))
    for c in getattr(node, "children", None) or []:
        out += sample_seeds(c)
    return out


def sample_draws(table, column: str, batch_rows: int, seed: int):
    """A replay of SampleOp's draws over a scan of `table`: the chunks
    the scan reads, and for each one `random(bucket_length(n), float32)`
    from `default_rng(seed)` -> (column values, keys), the keys of each
    chunk's live rows only, in scan order."""
    from matrixone_tpu_torch.container.device import bucket_length
    rng = np.random.default_rng(seed)
    vals, keys = [], []
    for arrays, _valid, _dicts, n in table.iter_chunks([column],
                                                       batch_rows):
        vals.append(np.asarray(arrays[column][:n]))
        keys.append(rng.random(bucket_length(n), dtype=np.float32)[:n])
    return np.concatenate(vals), np.concatenate(keys)


def phase_executor_sf1(torch, CK, args, sf1) -> tuple:
    """Phase 8: the rest of the executor at scale factor 1 on phase 5's
    tables, read-only: FULL OUTER (8a), window functions (8b), UNION ALL
    and UNION (8c), SAMPLE and time_bucket (8d), cross and non-equi joins
    (8e), each as SQL text through `Session.execute` with its gate."""
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.sql import plan as P
    from matrixone_tpu_torch.utils import tpch

    session, lineitem, q3data, v = sf1
    eng = session.catalog
    orders = q3data["orders"]
    n_li, n_ord, n_v = (len(lineitem["l_orderkey"]),
                        len(orders["o_orderkey"]), len(v["id"]))
    n_cust = eng.get_table("customer").n_rows
    batch_rows = int(session.variables.get("batch_rows", 1 << 20))
    epoch = __import__("datetime").date(1970, 1, 1)
    report, caps = {}, {}

    def path(key, label, sess, sql, n_rows, check, kernel=None):
        report[key], caps[key] = sql_path(torch, CK, TK, label, sess, sql,
                                          n_rows, check, kernel)

    # 8a: FULL OUTER at full width against numpy set arithmetic
    returned = np.unique(lineitem["l_orderkey"][
        lineitem["l_returnflag"] == tpch.FLAG_CATS.index("R")])
    cutoff = (__import__("datetime").date.fromisoformat(FULL_OUTER_CUTOFF)
              - epoch).days
    late = np.unique(lineitem["l_orderkey"][lineitem["l_shipdate"] > cutoff])
    both = int(np.isin(returned, late).sum())
    want_8a = [(len(returned) - both, len(late) - both, both)]
    if min(want_8a[0]) < 0.01 * sum(want_8a[0]):
        raise AssertionError(f"8a: a class under 1% of the keys "
                             f"{want_8a}: pick another cutoff")

    def check_8a(rows, _batch):
        if rows != want_8a:
            raise AssertionError(f"8a FULL OUTER {rows} != numpy {want_8a}")

    path("8a_full_join", "8a FULL OUTER", session, FULL_OUTER_SQL, n_li,
         check_8a, "sorted_search")
    report["8a_full_join"]["sides"] = {"returned": len(returned),
                                    "late": len(late)}
    log(f"[8a] only returned {want_8a[0][0]}, only late {want_8a[0][1]}, "
        f"both {both}: numpy's (sides {len(returned)} and {len(late)} "
        f"keys)")

    # 8b: window functions at full width
    want_8b1, partitions, n_first = first_orders_by_year(orders)
    path("8b_window_rank", "8b rank", session, FIRST_ORDER_SQL, n_ord,
         equal_rows_check(want_8b1, "8b first orders by year"))
    report["8b_window_rank"]["partitions"] = partitions
    log(f"[8b] rank over {partitions} partitions: {n_first} first "
        f"orders by year, exact")

    ids = np.arange(0, n_v, FRAME_STRIDE)
    grp, xi, xn = v["grp"], v["xi"], v["xn"]
    want_8b2 = []
    for i in ids:
        members = np.nonzero(grp == grp[i])[0]       # ascending ids
        p = int(np.searchsorted(members, i))
        frame = members[max(0, p - 9):p + 1]
        want_8b2.append((int(i), float(xi[members[:p + 1]].astype(
            np.float64).sum()), float(xn[frame].astype(np.float64).mean()),
            float(xn[frame].max())))
    frame_err = {}

    def check_8b2(rows, _batch):
        if [r[0] for r in rows] != [w[0] for w in want_8b2]:
            raise AssertionError(f"8b frames: ids {[r[0] for r in rows][:5]}")
        for r, w in zip(rows, want_8b2):
            if r[1] != w[1] or r[3] != w[3]:
                raise AssertionError(f"8b frames id {r[0]}: running sum "
                                     f"{r[1]} / max {r[3]}, want {w[1]} / "
                                     f"{w[3]}")
        err = np.abs(np.array([r[2] for r in rows]) -
                     np.array([w[2] for w in want_8b2]))
        frame_err["avg_max_abs_err"] = float(err.max())
        if (err > 1e-4 * np.abs([w[2] for w in want_8b2]) + 1e-3).any():
            raise AssertionError(f"8b frames: moving average max err "
                                 f"{err.max()} past rtol 1e-4 / atol 1e-3")

    path("8b_window_frames", "8b frames", session, FRAMES_SQL, n_v, check_8b2)
    report["8b_window_frames"].update(frame_err, rows=len(want_8b2))
    log(f"[8b] {len(want_8b2)} rows: running sums and frame maxima exact, "
        f"moving averages within {frame_err['avg_max_abs_err']:.3e}")

    # 8c: UNION ALL under 5c's GROUP BY, and a UNION of two dictionaries
    xi_exact = np.bincount(grp, weights=xi.astype(np.int64), minlength=1000)
    xn_f64 = np.bincount(grp, weights=xn.astype(np.float64), minlength=1000)
    union_err = {}

    def check_8c(rows, _batch):
        if [r[0] for r in rows] != list(range(1000)):
            raise AssertionError("8c GROUP BY over UNION ALL: wrong groups")
        if [r[1] for r in rows] != xi_exact.tolist():
            raise AssertionError("8c sum(xi) is not the exact integer sum")
        err = np.abs(np.asarray([r[2] for r in rows], np.float64) - xn_f64)
        union_err["sum_xn_max_abs_err"] = float(err.max())
        if (err > 1e-4 * np.abs(xn_f64) + 1e-3).any():
            raise AssertionError(f"8c sum(xn) max err {err.max()} past "
                                 f"rtol 1e-4 / atol 1e-3")

    path("8c_union_group_by", "8c UNION ALL GROUP BY", session,
         UNION_GROUP_BY_SQL, n_v, check_8c, "segment_sum")
    report["8c_union_group_by"].update(union_err)
    if {g for _, g in CK.LAUNCHES.shapes("segment_sum")} != {4096}:
        raise AssertionError("8c: the segment-sum kernel ran at "
                             f"{CK.LAUNCHES.shapes('segment_sum')}, not "
                             f"only at G = 4096")
    want_union = [(s_,) for s_ in sorted(set(tpch.SEGMENTS)
                                         | set(tpch.FLAG_CATS))]

    def check_union(rows, _batch):
        if rows != want_union:
            raise AssertionError(f"8c UNION {rows} != {want_union}")

    path("8c_union_distinct", "8c UNION", session, UNION_DISTINCT_SQL,
         n_cust + n_li, check_union)
    log(f"[8c] UNION ALL GROUP BY: 1000 groups, sum(xi) exact, sum(xn) max "
        f"err {union_err['sum_xn_max_abs_err']:.3e}; UNION of "
        f"{len(tpch.SEGMENTS)} + {len(tpch.FLAG_CATS)} strings exact")

    # 8d: SAMPLE replayed from the plan's seed and the padded lengths
    seeded = SeededSession(session, SAMPLE_SEED)
    for sql in (SAMPLE_PERCENT_SQL, SAMPLE_ROWS_SQL):
        if sample_seeds(seeded.plan(sql)) != [SAMPLE_SEED]:
            raise AssertionError(f"8d: the plan of {sql!r} samples with "
                                 f"seeds {sample_seeds(seeded.plan(sql))}")
    _, keys = sample_draws(eng.get_table("lineitem"), "l_orderkey",
                           batch_rows, SAMPLE_SEED)
    want_pct = int((keys < 0.1).sum())
    sigma = (n_li * 0.1 * 0.9) ** 0.5
    if abs(want_pct - 0.1 * n_li) > 5 * sigma:
        raise AssertionError(f"8d: the replay drew {want_pct} rows, past "
                             f"5 sigma of {0.1 * n_li}")

    def check_pct(rows, _batch):
        if rows != [(want_pct,)]:
            raise AssertionError(f"8d SAMPLE 10 PERCENT {rows} != the "
                                 f"replay's {want_pct}")

    path("8d_sample_percent", "8d SAMPLE PERCENT", seeded, SAMPLE_PERCENT_SQL,
         n_li, check_pct)
    vids, vkeys = sample_draws(eng.get_table("v"), "id", batch_rows,
                               SAMPLE_SEED)
    want_ids = vids[np.argsort(vkeys, kind="stable")[:1000]].tolist()

    def check_rows(rows, _batch):
        got = [r[0] for r in rows]
        if len(set(got)) != 1000 or not all(0 <= i < n_v for i in got):
            raise AssertionError(f"8d SAMPLE 1000 ROWS: {len(set(got))} "
                                 f"distinct ids")
        if got != want_ids:
            raise AssertionError("8d SAMPLE 1000 ROWS: not the replay's "
                                 "rows")

    path("8d_sample_rows", "8d SAMPLE ROWS", seeded, SAMPLE_ROWS_SQL, n_v,
         check_rows)
    ship = lineitem["l_shipdate"].astype(np.int64)
    buckets, counts = np.unique(ship // 30 * 30, return_counts=True)
    qty = np.bincount(np.searchsorted(buckets, ship // 30 * 30),
                      weights=lineitem["l_quantity"], minlength=len(buckets))
    want_tb = [(int(b), int(c), int(q)) for b, c, q in zip(buckets, counts,
                                                           qty)]

    def check_tb(rows, _batch):
        got = [((r[0] - epoch).days if hasattr(r[0], "year") else r[0],
                r[1], round(r[2] * 100)) for r in rows]
        if got != want_tb:
            raise AssertionError(f"8d time_bucket {got[:3]} != numpy "
                                 f"{want_tb[:3]}")

    path("8d_time_bucket", "8d time_bucket", session, TIME_BUCKET_SQL, n_li,
         check_tb)
    log(f"[8d] SAMPLE 10 PERCENT drew {want_pct} rows, the replay's "
        f"({(want_pct - 0.1 * n_li) / sigma:+.2f} sigma); SAMPLE 1000 ROWS "
        f"the replay's ids in order; time_bucket: {len(want_tb)} buckets "
        f"exact")

    # 8e: cross and non-equi joins, small by nature
    oc = orders["o_custkey"][orders["o_orderkey"] <= 4096]
    want_cross = [(min(2000, n_cust) * len(oc),)]
    want_ne = [(int(np.clip(oc - 1, 0, min(2000, n_cust)).sum()),)]
    for key, label, sql, want in (("8e_cross", "8e cross", CROSS_SQL,
                                   want_cross),
                                  ("8e_non_equi", "8e non-equi",
                                   NON_EQUI_SQL, want_ne)):
        def check_e(rows, _batch, want=want, label=label):
            if rows != want:
                raise AssertionError(f"{label} {rows} != numpy {want}")
        path(key, label, session, sql, n_cust + n_ord, check_e)
        report[key]["plan"] = P.explain(session.plan(sql))
    log(f"[8e] cross {want_cross[0][0]} and non-equi {want_ne[0][0]} "
        f"pairs, exact")

    # both kernels at every shape phase 8 launched them with, on phase
    # 8's own inputs; each timed at its most launched shape
    search_rows, segsum_rows = [], []
    for key, rec in report.items():
        cap = caps[key]
        counts = {tuple(r[:-1]): r[-1] for r in
                  rec["launches"]["sorted_search"]["by_shape"]}
        top = max(counts, key=counts.get) if counts else None
        search_rows += [dict(check_sorted_search(
            torch, CK, f"{key}_n{n_}_m{m_}", *cap.search[(n_, m_)],
            timed=(n_, m_) == top), path=key, path_launches=c)
            for (n_, m_), c in sorted(counts.items())]
        counts = {tuple(r[:-1]): r[-1] for r in
                  rec["launches"]["segment_sum"]["by_shape"]}
        segsum_rows += [dict(check_segment_sum(
            torch, CK, f"{key}_n{n_}_G{g}", *cap.segsum[(n_, g)], g),
            path=key, path_launches=c)
            for (n_, g), c in sorted(counts.items())]
    del caps
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


# ------------------------------------------------ phase 9: fused fragments

#: 9b: ORDER BY .. LIMIT over lineitem (the fused top-k terminal)
TOPK_SQL = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
            "where l_shipdate > date '1995-03-15' order by l_extendedprice "
            "desc, l_orderkey, l_linenumber limit 10")
FUSION_MODES = ("fused", "eager", "fallback", "degraded")
#: 9a: an f32 sum under a varchar key: the fused dense grouped terminal
#: rounds its f32 input lane to bf16 on the card by default
F32_VARCHAR_SQL = ("select g, sum(x) sx, count(*) n from vf group by g "
                   "order by g")
#: the reference's documented tolerance of such a sum (ops/encodings.py:
#: bf16's 8 significant bits, same-signed elements)
BF16_RTOL = 0.004


def load_vf(eng, n: int, seed: int):
    """`vf`: n rows of a varchar key over 40 strings and an f32 x in
    [1, 2) that sits 0.003 above a bf16 step (1/128 apart there), so
    every element narrowed to bf16 rounds down and a narrowed sum is
    0.15-0.3% low.  -> (codes, x, the strings)."""
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.storage.engine import TableMeta
    rng = np.random.default_rng(seed + 9)
    cats = [f"g{i:02d}" for i in range(40)]
    codes = (np.arange(n) % len(cats)).astype(np.int32)
    x = (1 + rng.integers(0, 128, n) / 128 + 0.003).astype(np.float32)
    eng.create_table(TableMeta("vf", [("g", dt.varchar(8)),
                                      ("x", dt.FLOAT32)], []))
    eng.get_table("vf").insert_numpy({"x": x},
                                     strings={"g": (codes, cats)})
    return codes, x, cats


def f32_varchar_check(codes, x, cats, errs: dict, label: str,
                      narrowed: bool):
    """F32_VARCHAR_SQL against the f64 sums: groups and counts exact;
    narrowed, each sum within BF16_RTOL of the f64 sum and off it by
    more than 1e-4 (the lane was rounded); else within rtol 1e-4 / atol
    1e-3.  The largest relative error goes into `errs[label]`."""
    want = np.bincount(codes, weights=x.astype(np.float64),
                       minlength=len(cats))
    counts = np.bincount(codes, minlength=len(cats)).tolist()

    def check(rows, _batch):
        if [r[0] for r in rows] != cats or [r[2] for r in rows] != counts:
            raise AssertionError(f"{label}: wrong groups or counts")
        got = np.asarray([r[1] for r in rows], np.float64)
        rel = np.abs(got - want) / want
        errs[label] = float(rel.max())
        if narrowed and not (rel.max() <= BF16_RTOL and rel.min() > 1e-4):
            raise AssertionError(f"{label}: relative errors "
                                 f"{rel.min():.2e}-{rel.max():.2e}, not "
                                 f"the bf16 lane's (1e-4, {BF16_RTOL}]")
        if not narrowed and (np.abs(got - want)
                             > 1e-4 * want + 1e-3).any():
            raise AssertionError(f"{label}: sums past rtol 1e-4 / atol "
                                 f"1e-3 of the f64 sums")
    return check


def f32_varchar_path(torch, CK, eng, perop_session, fsess, n: int,
                     seed: int) -> dict:
    """9a's f32 sum under a varchar key: the per-operator rows against
    the f64 sums, the fused rows with the default MO_NARROW_ENCODINGS
    (bf16 lanes on the card) within the reference's bf16 tolerance, and
    with MO_NARROW_ENCODINGS=0 the per-operator rows."""
    codes, x, cats = load_vf(eng, n, seed)
    errs: dict = {}
    perop = perop_session.execute(F32_VARCHAR_SQL).rows()
    f32_varchar_check(codes, x, cats, errs, "9a_f32_varchar per-operator",
                      False)(perop, None)
    saved = os.environ.pop("MO_NARROW_ENCODINGS", None)
    try:
        out = fused_path(torch, CK, "9a_f32_varchar", fsess,
                         F32_VARCHAR_SQL, n,
                         f32_varchar_check(codes, x, cats, errs,
                                           "9a_f32_varchar", True), None)
        os.environ["MO_NARROW_ENCODINGS"] = "0"
        out["narrow_off"] = fused_path(
            torch, CK, "9a_f32_varchar narrow=0", fsess, F32_VARCHAR_SQL,
            n, f32_varchar_check(codes, x, cats, errs,
                                 "9a_f32_varchar narrow=0", False), perop)
    finally:
        os.environ.pop("MO_NARROW_ENCODINGS", None)
        if saved is not None:
            os.environ["MO_NARROW_ENCODINGS"] = saved
    for r in (out, out["narrow_off"]):
        if not r["warm"]["fused"] or r["warm"]["eager"]:
            raise AssertionError(f"9a_f32_varchar: not fused: {r['warm']}")
    out["max_rel_err"] = errs
    log(f"[9a_f32_varchar] largest relative error against the f64 sums: "
        f"{errs}")
    return out


def held_bytes_beside(entries_before: dict) -> tuple:
    """(bytes the cached graphs hold, of it the graphs a query run since
    `entries_before` = {id(graph): replays} captured or replayed)."""
    held = mine = 0
    for e in _fusion_cache_entries():
        for g in e["graphs"].values():
            held += g.held_bytes
            if entries_before.get(id(g)) != g.replays:
                mine += g.held_bytes
    return held, mine


def graph_replays() -> dict:
    return {id(g): g.replays for e in _fusion_cache_entries()
            for g in e["graphs"].values()}


def fusion_counts() -> dict:
    """The fused fragments' counters, so far."""
    from matrixone_tpu_torch.utils import metrics as M
    return {"captures": M.fusion_graphs.get(event="capture"),
            "replays": M.fusion_graphs.get(event="replay"),
            "batches": M.fusion_batches.get(),
            "capture_seconds": M.fusion_trace_seconds.get(),
            "cache_hits": M.fusion_compile.get(outcome="hit"),
            "cache_misses": M.fusion_compile.get(outcome="miss"),
            **{m: M.fusion_exec.get(mode=m) for m in FUSION_MODES}}


def counts_since(before: dict) -> dict:
    now = fusion_counts()
    return {k: now[k] - before[k] for k in now}


def rows_agree(got, want, rtol=1e-4, atol=1e-3) -> bool:
    """Row for row: floats within rtol / atol (two paths add floats in
    other orders), every other value equal."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for x, y in zip(g, w):
            if isinstance(x, float) and isinstance(y, float):
                if not abs(x - y) <= atol + rtol * abs(y):
                    return False
            elif x != y:
                return False
    return True


#: 9c: the 22's queries with a decorrelated subquery (EXISTS, NOT EXISTS
#: or a correlated scalar aggregate); their warm runs capture nothing
DECORRELATED_22 = (2, 4, 17, 20, 21, 22)
#: 9c: the fused warm seconds of the queries that captured anew on every
#: run while a process counter named their decorrelated columns
#: (PERF.md section 5, NVIDIA H100 80GB HBM3, 700.00 W)
COUNTER_NAMES_9C = {4: 0.1242, 17: 0.2521, 20: 0.0988, 21: 0.1765}


def fused_path(torch, CK, label: str, session, sql: str, n_rows: int,
               check, perop_rows, top: int = 8,
               warm_captures: bool = False) -> dict:
    """One query through the fused fragments: the cold run (captures the
    graphs; checked against the oracle and, row for row, the per-operator
    rows of this run, unless `perop_rows` is None), the counted warm run (kernel launches, graph replays, batches,
    peak device memory), the best of 3 warm runs as rows/s, and one
    profiled run.  With `warm_captures`, the warm run may capture (a
    decorrelated subquery's column names key its fragments anew on every
    run)."""
    c0 = fusion_counts()
    rows, batch, cold_s = run_sql(torch, session, sql)
    cold = counts_since(c0)
    check(rows, batch)
    if perop_rows is not None and not rows_agree(rows, perop_rows):
        raise AssertionError(f"{label}: fused rows differ from the "
                             f"per-operator rows: {rows[:3]} vs "
                             f"{perop_rows[:3]}")
    CK.LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = fusion_counts()
    rows, batch, _ = run_sql(torch, session, sql)
    warm = counts_since(c0)
    peak = torch.cuda.max_memory_allocated()
    launches = kernel_launches(CK, label, ("sorted_search", "segment_sum",
                                           "segment_sum_walk"))
    check(rows, batch)
    if perop_rows is not None and not rows_agree(rows, perop_rows):
        raise AssertionError(f"{label}: warm fused rows differ from the "
                             f"per-operator rows")
    if warm["captures"] and not warm_captures:
        raise AssertionError(f"{label}: the warm run captured graphs "
                             f"again: {warm}")
    warm_s = [run_sql(torch, session, sql)[2] for _ in range(3)]
    prof = profile_run(torch, lambda: session.execute(sql), label, top=top)
    out = {"cold_seconds": cold_s, "cold": cold, "warm": warm,
           "warm_seconds": warm_s, "rows_per_sec_best": n_rows / min(warm_s),
           "peak_device_bytes": peak, "launches": launches,
           "device_busy_share": prof["device_busy_share"], "profile": prof,
           "graphs_cached": len([g for e in _fusion_cache_entries()
                                 for g in e["graphs"].values()])}
    log(f"[{label}] cold {cold_s:.3f}s ({cold['captures']:.0f} captures, "
        f"{cold['capture_seconds']:.3f}s) warm {['%.4f' % w for w in warm_s]}"
        f" best {out['rows_per_sec_best']:.0f} rows/s; warm run: "
        f"{warm['batches']:.0f} batches, {warm['replays']:.0f} replays, "
        f"fused {warm['fused']:.0f} eager {warm['eager']:.0f} degraded "
        f"{warm['degraded']:.0f}; peak {peak / 2 ** 20:.0f} MiB")
    return out


def _fusion_cache_entries():
    from matrixone_tpu_torch.vm import fusion
    return fusion.CACHE._lru.snapshot()


def compare_paths(fused: dict, perop: dict) -> dict:
    """The fused path's warm numbers beside the per-operator path's,
    from this run."""
    f_best, p_best = min(fused["warm_seconds"]), min(perop["warm_seconds"])
    return {"fused_warm_best_s": f_best, "per_operator_warm_best_s": p_best,
            "speedup": p_best / f_best,
            "fused_busy_share": fused["device_busy_share"],
            "per_operator_busy_share":
                perop["profile"]["device_busy_share"]}


def phase_fusion(torch, CK, args, sf1, sf01, earlier) -> tuple:
    """Phase 9: the fused path (fusion on, default knobs) on phase 5's
    SF1 tables and 6b's SF 0.1 tables: each fragment's step one CUDA
    graph, replayed once per batch.  Runs before phase 7 writes."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.utils import tpch, tpch_full

    perop_session, lineitem, q3data, v = sf1
    eng = perop_session.catalog
    fsess = Session(catalog=eng, device="cuda")
    n_li, n_v = args.sf1_lineitem, len(v["id"])
    report = {"min_fused_rows": int(os.environ.get("MO_FUSION_MIN_ROWS",
                                                   "65536"))}

    # 9a: Q3 (probe fragments), Q1 (dense grouped), Q6 (scalar), 5c
    gb_err, q1_store = {}, {}
    paths = (("9a_q3", "q3", tpch.Q3_SQL, n_li,
              q3_rows_check(tpch.q3_oracle(lineitem, q3data), "9a")),
             ("9a_q1", "q1", tpch.Q1_SQL, n_li,
              q1_rows_check(lineitem, q1_store, "9a")),
             ("9a_q6", "q6", tpch.Q6_SQL, n_li, q6_rows_check(lineitem, "9a")),
             ("9a_group_by", "group_by", GROUP_BY_SQL, n_v,
              group_by_check(v, gb_err, "9a")))
    perop = {"q3": earlier["sql"]["q3"], "group_by":
             earlier["sql"]["group_by"], "q1": earlier["tpch"]["q1"],
             "q6": earlier["tpch"]["q6"]}
    spy = None
    for key, name, sql, n_rows, check in paths:
        want = perop_session.execute(sql).rows()
        if name == "q3":
            with PathInputs(torch, TK, "graphs") as spy:
                report[key] = fused_path(torch, CK, key, fsess, sql, n_rows,
                                         check, want)
        else:
            report[key] = fused_path(torch, CK, key, fsess, sql, n_rows,
                                     check, want)
        report[key]["vs_per_operator"] = compare_paths(report[key],
                                                       perop[name])
        warm = report[key]["warm"]
        if name == "group_by":
            if warm["fused"] or warm["batches"]:
                raise AssertionError(f"9a: 5c's GROUP BY (integer key) "
                                     f"fused: {warm}")
            continue
        if not warm["fused"] or warm["eager"]:
            raise AssertionError(f"{key}: not fused at SF1 with default "
                                 f"knobs: {warm}")
        if name == "q1" and warm["replays"] > warm["batches"]:
            raise AssertionError(f"9a Q1: {warm['replays']} replays for "
                                 f"{warm['batches']} batches")
    if not report["9a_q3"]["launches"]["sorted_search"]["launches"]:
        raise AssertionError("9a Q3 never launched the sorted search")
    report["9a_group_by"].update(gb_err)
    report["9a_f32_varchar"] = f32_varchar_path(torch, CK, eng,
                                                perop_session, fsess, n_v,
                                                args.seed)

    # 9d: the sorted search inside the captured probe graphs, against its
    # plain version on the inputs of the last replay, bit for bit
    search_rows = []
    if not spy.seen:
        raise AssertionError("9d: no sorted search was captured in a graph")
    q3_counts = {tuple(r[:-1]): r[-1] for r in report["9a_q3"]["launches"][
        "sorted_search"]["by_shape"]}
    checked = set()
    for srt, q, out in spy.seen:
        shape = (srt.shape[0], q.shape[0])
        want = CK.sorted_search_plain(srt, q)
        if not torch.equal(out, want):
            raise AssertionError(f"9d: the sorted search in the graph at "
                                 f"{shape} differs from its plain version")
        if shape in checked:
            continue
        checked.add(shape)
        row = check_sorted_search(torch, CK, f"9d_graph_n{shape[0]}_m"
                                  f"{shape[1]}", srt.clone(), q.clone(),
                                  timed=shape == max(q3_counts,
                                                     key=q3_counts.get))
        search_rows.append(dict(row, path="9a_q3_graph",
                                path_launches=q3_counts.get(shape, 0),
                                in_graph_bit_identical=True))
    report["9d_graph_search"] = {"shapes": sorted(checked),
                                 "captured_calls": len(spy.seen)}
    log(f"[9d] sorted search in {len(spy.seen)} captured probe graph(s) "
        f"bit-identical to its plain version at {sorted(checked)}")
    del spy

    # 9b: 8b's rank() window fragment and a top-k terminal over lineitem
    want_8b1, _, _ = first_orders_by_year(q3data["orders"])
    ship = lineitem["l_shipdate"] > (__import__("datetime").date(1995, 3, 15)
                                     - __import__("datetime").date(1970, 1,
                                                                   1)).days
    idx = np.nonzero(ship)[0]
    order = np.lexsort((lineitem["l_linenumber"][idx],
                        lineitem["l_orderkey"][idx],
                        -lineitem["l_extendedprice"][idx]))[:10]
    want_topk = [(int(lineitem["l_orderkey"][i]),
                  int(lineitem["l_linenumber"][i]),
                  int(lineitem["l_extendedprice"][i])) for i in idx[order]]

    def check_topk(rows, _batch):
        got = [(r[0], r[1], round(r[2] * 100)) for r in rows]
        if got != want_topk:
            raise AssertionError(f"9b top-k {got[:3]} != numpy "
                                 f"{want_topk[:3]}")

    for key, sql, n_rows, check, ref in (
            ("9b_window_rank", FIRST_ORDER_SQL, len(q3data["orders"][
                "o_orderkey"]), equal_rows_check(want_8b1, "9b rank"),
             earlier["executor"]["8b_window_rank"]),
            ("9b_topk", TOPK_SQL, n_li, check_topk, None)):
        want = perop_session.execute(sql).rows()
        report[key] = fused_path(torch, CK, key, fsess, sql, n_rows, check,
                                 want)
        if ref is not None:
            report[key]["vs_per_operator"] = compare_paths(report[key], ref)
        if not report[key]["warm"]["fused"]:
            raise AssertionError(f"{key}: not fused: {report[key]['warm']}")

    # 9c: the 22 at SF 0.1 on 6b's tables, fused, against sqlite3 and 6b
    perop_sess = sf01[0]
    fsess01 = Session(catalog=perop_sess.catalog, device="cuda")
    rows_of = {t: perop_sess.catalog.get_table(t).n_rows
               for t in perop_sess.catalog.tables}
    q22 = {}
    for q in sorted(tpch_full.QUERIES):
        sql = tpch_full.QUERIES[q]
        want = SQLITE_SF01[q]
        perop_rows = tpch_full.normalize_rows(perop_sess.execute(sql).rows())

        def check(rows, _batch, q=q, want=want, perop_rows=perop_rows):
            got = tpch_full.normalize_rows(rows)
            if not tpch_full.rows_match(got, want):
                raise AssertionError(f"9c Q{q}: rows differ from sqlite3")
            if not tpch_full.rows_match(got, perop_rows):
                raise AssertionError(f"9c Q{q}: rows differ from 6b's")

        # a decorrelated subquery binds the same names on every run, so
        # its warm run captures nothing either (ROADMAP.md, section C)
        r = fused_path(torch, CK, f"9c Q{q}", fsess01, sql,
                       rows_of["lineitem"], check, None, top=0,
                       warm_captures=q not in DECORRELATED_22)
        p6 = earlier["tpch"]["tpch22"]["queries"][q]
        q22[q] = {"warm_seconds_best": min(r["warm_seconds"]),
                  "counter_names_warm_seconds_best": COUNTER_NAMES_9C.get(q),
                  "per_operator_warm_seconds_best": p6["warm_seconds_best"],
                  "device_busy_share": r["device_busy_share"],
                  "per_operator_busy_share": p6["device_busy_share"],
                  "warm": r["warm"], "cold": r["cold"],
                  "peak_device_bytes": r["peak_device_bytes"],
                  "sorted_search": r["launches"]["sorted_search"]["launches"],
                  "per_operator_sorted_search": p6["sorted_search"]}
    report["9c_tpch22"] = {"sf": TPCH_SF, "queries": q22}
    for q in sorted(COUNTER_NAMES_9C):
        log(f"[9c] Q{q} warm captures {q22[q]['warm']['captures']:.0f}; "
            f"fused best {q22[q]['warm_seconds_best']:.4f}s against "
            f"{COUNTER_NAMES_9C[q]:.4f}s with counter names (per-operator "
            f"{q22[q]['per_operator_warm_seconds_best']:.4f}s)")
    fused_q = sum(1 for r in q22.values() if r["warm"]["fused"])
    log(f"[9c] 22 queries fused at sf {TPCH_SF} equal sqlite3 and 6b's "
        f"rows; {fused_q} of them ran fused fragments; warm best sums: "
        f"fused {sum(r['warm_seconds_best'] for r in q22.values()):.3f}s, "
        f"per-operator "
        f"{sum(r['per_operator_warm_seconds_best'] for r in q22.values()):.3f}s")
    from matrixone_tpu_torch.vm import fusion
    report["cache_after_22"] = dict(
        fusion.stats()["compile_cache"],
        allocated_bytes=torch.cuda.memory_allocated(),
        reserved_bytes=torch.cuda.memory_reserved())

    # 9e: 9a's SF1 queries again after the 22, the cache not cleared
    # (phase 7 then runs beside it): after each, what the cached graphs
    # hold apart from the query's own is within the cache's byte bound
    bound = fusion.CACHE.max_held_bytes(torch.device("cuda"))
    again = {}
    for key, name, sql, n_rows, check in paths[:3]:
        before = graph_replays()
        rows, batch, secs = run_sql(torch, fsess, sql)
        check(rows, batch)
        held, mine = held_bytes_beside(before)
        again[key] = {"seconds": secs, "held_bytes": held,
                      "query_held_bytes": mine,
                      "allocated_bytes": torch.cuda.memory_allocated(),
                      "reserved_bytes": torch.cuda.memory_reserved()}
        if held - mine > bound:
            raise AssertionError(f"9e {key}: the cached graphs hold "
                                 f"{held - mine} bytes beside the query's "
                                 f"{mine}, past the bound {bound}")
    report["9e_cache_bound"] = {
        "bound_bytes": bound, "paths": again,
        "cache": fusion.stats()["compile_cache"]}
    st = report["9e_cache_bound"]["cache"]
    log(f"[9e] bound {bound / 2 ** 30:.2f} GiB: after the 22 the cache "
        f"held {report['cache_after_22']['held_bytes'] / 2 ** 30:.2f} GiB "
        f"({report['cache_after_22']['entries']} entries); after 9a's "
        f"three again {st['held_bytes'] / 2 ** 30:.2f} GiB ({st['entries']}"
        f" entries), {st['evicted_graphs']} graphs evicted so far; "
        f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, "
        f"reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
    return report, search_rows


# -------------------------------------- phase 10: spills and storage

#: 10a: a join build budget past Q21's largest build at SF1 (no spill)
NO_SPILL_BUDGET = 1 << 24
#: warm runs of each phase-10 query after its counted run: cut from 3 to
#: 1 to keep the whole script well inside its limit (PERF.md section 4)
SPILL_WARM_RUNS = 1
#: 10b: 5c's float GROUP BY at G = 4096: v's values under 4096 groups
SPILL_GROUP_BY_SQL = ("select grp, sum(xi), sum(xn) from vg group by grp "
                      "order by grp")
SPILL_GROUPS = 4096
#: 10b: one group per order (1.5M groups at SF1) through 2^18 on the card
ORDERKEY_DEVICE_GROUPS = 1 << 18
ORDERKEY_GROUP_BY_SQL = ("select l_orderkey, count(*), sum(l_quantity) "
                         "from lineitem group by l_orderkey "
                         "order by l_orderkey")
#: 10c: orders split by year of o_orderdate; one year's count and sum
PARTITION_YEARS = tuple(range(1993, 1999))
PARTITION_SQL = ("select count(*), sum(o_totalprice) from {table} where "
                 "o_orderdate >= date '1995-01-01' and "
                 "o_orderdate < date '1996-01-01'")


def spill_counts() -> dict:
    """The spills' counters so far (`utils/metrics.py`)."""
    from matrixone_tpu_torch.utils import metrics as M
    out = {"join_spills": M.join_spills.get(),
           "agg_spills": M.agg_spills.get()}
    for kind in ("join", "agg"):
        out[f"{kind}_partitions"] = M.spill_partitions.get(kind=kind)
        out[f"{kind}_bytes"] = M.spill_bytes.get(kind=kind)
        for stage in ("partition", "write", "replay"):
            out[f"{kind}_{stage}_seconds"] = M.spill_seconds.get(
                kind=kind, stage=stage)
    return out


class AggBudget:
    """Within the block, every AggOp the executor builds takes these
    `__init__` keywords (`max_groups`, `max_device_groups`,
    `spill_partitions`), as tests/test_spill.py wraps the JAX
    package's, and `session`'s plan cache is off (a cached tree holds
    the AggOps built before the block)."""

    def __init__(self, session, **kw):
        self.session, self.kw = session, kw

    def __enter__(self):
        from matrixone_tpu_torch.serving import serving_for
        from matrixone_tpu_torch.vm import operators as O
        self._orig = orig = O.AggOp.__init__
        kw = self.kw

        def init(op, node, child, **given):
            orig(op, node, child, **{**given, **kw})
        O.AggOp.__init__ = init
        self._plan = serving_for(self.session.catalog).plan_cache
        self._plan_was, self._plan.enabled = self._plan.enabled, False
        return self

    def __exit__(self, *exc):
        from matrixone_tpu_torch.vm import operators as O
        O.AggOp.__init__ = self._orig
        self._plan.enabled = self._plan_was
        return False


def spill_path(torch, CK, TK, label: str, session, sql: str, check,
               spill: str, kernel=None) -> tuple:
    """One query that must (spill = "join_spills" / "agg_spills") or must
    not (spill = "") spill: the counted run, which is the first and
    captures (its spill counters, kernel launches by shape with their
    inputs captured, peak device memory), then the best of
    `SPILL_WARM_RUNS` warm runs; every run's rows checked.  -> (record,
    the captured kernel inputs, the rows)."""
    def spilled(c):
        return {k: v for k, v in c.items() if v} if spill else {}

    CK.LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = spill_counts()
    with PathInputs(torch, TK) as cap:
        rows, _batch, counted_s = run_sql(torch, session, sql)
    counted = {k: v - c0[k] for k, v in spill_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    check(rows)
    launches = kernel_launches(CK, label, ("sorted_search", "segment_sum",
                                           "segment_sum_walk"),
                               required=(kernel,) if kernel else ())
    if spill and not counted[spill]:
        raise AssertionError(f"{label}: the counted run did not spill")
    if not spill and counted["join_spills"] + counted["agg_spills"]:
        raise AssertionError(f"{label}: the counted run spilled: {counted}")
    warm = []
    for _ in range(SPILL_WARM_RUNS):
        rows, _batch, w = run_sql(torch, session, sql)
        check(rows)
        warm.append(w)
    out = {"counted_seconds": counted_s,
           "warm_seconds": warm, "warm_seconds_best": min(warm),
           "spill": spilled(counted), "peak_device_bytes": peak,
           "launches": launches}
    log(f"[{label}] counted {counted_s:.3f}s warm "
        f"{['%.3f' % w for w in warm]} peak {peak / 2 ** 20:.0f} MiB; "
        f"spill of the counted run {out['spill']}")
    return out, cap, rows


def check_spill_search(torch, CK, key: str, rec: dict, cap,
                       graph_seen=()) -> list:
    """The sorted search at every shape `rec`'s counted run launched it
    with, bit for bit: on the inputs the seam captured, and, for the
    launches a fused step's replays make without calling the seam, on
    the tensors the graphs read and wrote (`PathInputs` in `graphs`:
    the values of their last replay); timed at the most launched shape.
    A shape the run launched that neither covers raises."""
    counts = {tuple(r[:-1]): r[-1] for r in
              rec["launches"]["sorted_search"]["by_shape"]}
    top = max(counts, key=counts.get) if counts else None
    rows, in_graph = [], set()
    for srt, q, out in graph_seen:
        shape = (srt.shape[0], q.shape[0])
        if not torch.equal(out, CK.sorted_search_plain(srt, q)):
            raise AssertionError(f"{key}: the sorted search in a graph at "
                                 f"{shape} differs from its plain version")
        if shape in counts and shape not in cap.search \
                and shape not in in_graph:
            rows.append(dict(check_sorted_search(
                torch, CK, f"{key}_graph_n{shape[0]}_m{shape[1]}",
                srt.clone(), q.clone(), timed=shape == top), path=key,
                path_launches=counts[shape], in_graph_bit_identical=True))
        in_graph.add(shape)
    unchecked = {k: c for k, c in counts.items()
                 if k not in cap.search and k not in in_graph}
    if unchecked:
        raise AssertionError(f"{key}: sorted-search shapes launched with no "
                             f"input to hold against the plain version "
                             f"(shape: launches): {unchecked}")
    rows += [dict(check_sorted_search(
        torch, CK, f"{key}_n{n_}_m{m_}", *cap.search[(n_, m_)],
        timed=(n_, m_) == top), path=key, path_launches=c)
        for (n_, m_), c in sorted(counts.items()) if (n_, m_) in cap.search]
    return rows


def phase_spill_storage(torch, CK, args, sf1, keep=None) -> tuple:
    """Phase 10: the Grace spills of the join (10a, TPC-H Q21 at SF1) and
    of the grouped aggregate (10b), and a partitioned table (10c), on
    an engine of their own (freed after), read-only; the host library
    must be the compiled one.  `keep`, if given, receives the
    generator's customer and orders arrays for phase 15, and the engine
    with the generator's tables for phase 17."""
    import gc
    from matrixone_tpu_torch import native
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage.engine import Engine, TableMeta
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch_full

    report = {"host_library": native.route()}
    if report["host_library"] != "c":
        raise AssertionError("10: the host library did not build (g++); "
                             "the numpy fallbacks would serve the engine")
    eng = Engine()
    t0 = time.perf_counter()
    tables = tpch_full.load_tpch(eng, sf=1.0, seed=args.seed)
    report["load_seconds"] = time.perf_counter() - t0
    report["rows"] = {t: eng.get_table(t).n_rows for t in eng.tables}
    if keep is not None:
        keep.update({t: tables[t] for t in INGEST_TABLES})
        # phase 17 shards Q5, Q9 and Q18 over the same engine (no second
        # SF1 load)
        keep["tpch_sf1"] = (eng, tables)
    log(f"[10] loaded TPC-H at SF1 {report['rows']} in "
        f"{report['load_seconds']:.1f}s; host library: "
        f"{report['host_library']}")
    fsess = Session(catalog=eng, device="cuda")
    psess = Session(catalog=eng, device="cuda")
    psess.execute("set plan_fusion = 0")
    caps = {}
    # every graph the fused runs replay is captured in this phase, under
    # the spy, so each in-graph search can be held to its plain version
    from matrixone_tpu_torch.vm import fusion
    fusion.CACHE.clear()
    # 10a: Q21 spilled (the default budget) and not (a budget past its
    # largest build), fused and per-operator: the same rows
    with PathInputs(torch, TK, "graphs") as spy:
        sql = tpch_full.QUERIES[21]
        fsess.variables["join_build_budget"] = NO_SPILL_BUDGET
        want = fsess.execute(sql).rows()
        if not want:
            raise AssertionError("10a: Q21 at SF1 returned no row")

        def check_q21(rows):
            if rows != want:
                raise AssertionError(f"10a Q21: rows differ from the "
                                     f"unspilled run: {rows[:3]} vs "
                                     f"{want[:3]}")
        for mode, sess in (("fused", fsess), ("per_operator", psess)):
            sess.variables["join_build_budget"] = NO_SPILL_BUDGET
            key = f"10a_q21_{mode}"
            report[key], _cap, _ = spill_path(
                torch, CK, TK, f"10a Q21 {mode}", sess, sql, check_q21, "",
                "sorted_search")
            sess.variables.pop("join_build_budget")
            key = f"10a_q21_spill_{mode}"
            report[key], caps[key], _ = spill_path(
                torch, CK, TK, f"10a Q21 spilled {mode}", sess, sql,
                check_q21, "join_spills", "sorted_search")
    log(f"[10a] Q21 at SF1 ({len(want)} rows): spilled and unspilled, "
        f"fused and per-operator, the same rows")
    # the sorted search at every shape the spilled Q21 launched it with,
    # while the graphs' tensors hold the spilled run's last replay
    search_rows = []
    for key in ("10a_q21_spill_fused", "10a_q21_spill_per_operator"):
        search_rows += check_spill_search(
            torch, CK, key, report[key], caps[key],
            spy.seen if key.endswith("fused") else ())
    report["10a_graph_search"] = {
        "captured_calls": len(spy.seen),
        "shapes": sorted({(s.shape[0], q.shape[0]) for s, q, _ in spy.seen})}
    del spy

    # 10b: 5c's float GROUP BY at G = 4096 through a 1024-group budget in
    # 8 partitions, and one group per order through 2^18 groups
    _session5, _li5, _q3, v = sf1
    from matrixone_tpu_torch.container import dtypes as dt
    eng.create_table(TableMeta("vg", [("grp", dt.INT64),
                                      ("xi", dt.FLOAT32),
                                      ("xn", dt.FLOAT32)], []))
    vg = {"grp": v["id"] % SPILL_GROUPS, "xi": v["xi"], "xn": v["xn"]}
    eng.get_table("vg").insert_numpy(vg)
    errs = {}
    gb_check = group_by_check(vg, errs, "10b", SPILL_GROUPS)
    unspilled = {}
    for mode, sess in (("fused", fsess), ("per_operator", psess)):
        key = f"10b_group_by_{mode}"
        report[key], _cap, unspilled[mode] = spill_path(
            torch, CK, TK, f"10b GROUP BY {mode}", sess, SPILL_GROUP_BY_SQL,
            lambda rows: gb_check(rows, None), "", "segment_sum")

        def close_to_unspilled(rows, mode=mode):
            gb_check(rows, None)
            if not rows_agree(rows, unspilled[mode]):
                raise AssertionError(f"10b {mode}: spilled sums differ from "
                                     f"the unspilled run past rtol 1e-4 / "
                                     f"atol 1e-3")
        key = f"10b_group_by_spill_{mode}"
        with AggBudget(sess, max_groups=256, max_device_groups=1024,
                       spill_partitions=8):
            report[key], caps[key], _ = spill_path(
                torch, CK, TK, f"10b GROUP BY spilled {mode}", sess,
                SPILL_GROUP_BY_SQL, close_to_unspilled, "agg_spills",
                "segment_sum")
    report["10b_group_by_errors"] = errs
    for mode, sess in (("fused", fsess), ("per_operator", psess)):
        want_ok = sess.execute(ORDERKEY_GROUP_BY_SQL).rows()
        if len(want_ok) != report["rows"]["orders"]:
            raise AssertionError(f"10b: {len(want_ok)} order groups, not "
                                 f"{report['rows']['orders']}")

        def exact(rows, want_ok=want_ok):
            if rows != want_ok:
                raise AssertionError("10b: the spilled GROUP BY l_orderkey "
                                     "differs from the unspilled run")
        with AggBudget(sess, max_device_groups=ORDERKEY_DEVICE_GROUPS):
            report[f"10b_orderkey_spill_{mode}"], _cap, _ = spill_path(
                torch, CK, TK, f"10b GROUP BY l_orderkey spilled {mode}",
                sess, ORDERKEY_GROUP_BY_SQL, exact, "agg_spills")
    log(f"[10b] GROUP BY spilled: {SPILL_GROUPS} f32 groups within rtol "
        f"1e-4 / atol 1e-3 of the unspilled run and of f64; "
        f"{report['rows']['orders']} order groups through "
        f"{ORDERKEY_DEVICE_GROUPS} exact")

    # 10c: orders partitioned by year: a year's count and sum equal the
    # unpartitioned table's and numpy's, and the scan reads one segment
    from matrixone_tpu_torch.storage.partition import build_spec
    orders = tables["orders"]
    schema = tpch_full._SCHEMAS["orders"]
    spec = build_spec({"kind": "range", "column": "o_orderdate", "parts": [
        (f"y{y - 1}", f"{y}-01-01") for y in PARTITION_YEARS]
        + [("ymax", None)]}, schema)
    eng.create_table(TableMeta("orders_by_year", schema,
                               tpch_full._PKS["orders"], partition=spec))
    strings = {c: tpch_full._encode_strings(orders[c])
               for c, d in schema if d.is_varlen}
    t0 = time.perf_counter()
    eng.get_table("orders_by_year").insert_numpy(orders, strings=strings)
    insert_s = time.perf_counter() - t0
    epoch = __import__("datetime").date(1970, 1, 1)
    lo = (__import__("datetime").date(1995, 1, 1) - epoch).days
    hi = (__import__("datetime").date(1996, 1, 1) - epoch).days
    sel = (orders["o_orderdate"] >= lo) & (orders["o_orderdate"] < hi)
    want_c = (int(sel.sum()), int(orders["o_totalprice"][sel].sum()))
    rec = {"insert_seconds": insert_s, "segments": len(
        eng.get_table("orders_by_year").segments)}
    for table in ("orders", "orders_by_year"):
        q = PARTITION_SQL.format(table=table)
        r0 = {o: M.scan_segments.get(outcome=o) for o in ("read", "pruned")}
        rows, _batch, secs = run_sql(torch, fsess, q)
        seen = {o: M.scan_segments.get(outcome=o) - r0[o] for o in r0}
        got = (rows[0][0], round(rows[0][1] * 100))
        if got != want_c:
            raise AssertionError(f"10c {table}: {got} != numpy {want_c}")
        rec[table] = {"rows": rows, "seconds": secs, "segments": seen}
    if rec["orders_by_year"]["rows"] != rec["orders"]["rows"]:
        raise AssertionError("10c: the partitioned table's rows differ")
    if rec["orders_by_year"]["segments"] != {
            "read": 1, "pruned": rec["segments"] - 1}:
        raise AssertionError(f"10c: the scan read "
                             f"{rec['orders_by_year']['segments']} of "
                             f"{rec['segments']} segments, not one")
    report["10c_partitions"] = rec
    log(f"[10c] orders by year: {rec['segments']} segments, 1995's scan "
        f"read {rec['orders_by_year']['segments']}; count and sum equal "
        f"numpy's {want_c} and the unpartitioned table's")

    # the segment sum at every shape the spilled GROUP BYs launched it
    # with, on their own inputs
    segsum_rows = []
    for key in ("10b_group_by_spill_fused",
                "10b_group_by_spill_per_operator"):
        counts = {tuple(r[:-1]): r[-1] for r in
                  report[key]["launches"]["segment_sum"]["by_shape"]}
        segsum_rows += [dict(check_segment_sum(
            torch, CK, f"{key}_n{n_}_G{g}", *caps[key].segsum[(n_, g)], g),
            path=key, path_launches=c)
            for (n_, g), c in sorted(counts.items())]
    del caps, fsess, psess, eng, tables
    gc.collect()
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


# ------------------------------------------ phase 11: storage with objects

def cache_counts() -> dict:
    """The block cache's counters and the scan read-ahead's, so far."""
    from matrixone_tpu_torch.storage import blockcache
    from matrixone_tpu_torch.utils import metrics as M
    st = blockcache.CACHE.stats()
    return {"hits": st["hits"], "misses": st["misses"],
            "dev_hits": st["device_tier"]["hits"],
            "dev_misses": st["device_tier"]["misses"],
            "uploaded_bytes": st["uploaded_bytes"],
            "decode_seconds": st["decode_seconds"],
            "bytes_fetched": st["bytes_fetched"],
            "prefetch_chunks": M.scan_prefetch.get(outcome="ready")
            + M.scan_prefetch.get(outcome="waited"),
            "prefetch_wait_seconds": M.scan_prefetch_wait_seconds.get()}


def cache_since(before: dict) -> dict:
    now = cache_counts()
    return {k: now[k] - before[k] for k in now}


def object_path(torch, CK, TK, label: str, session, sql: str, n_rows: int,
                check, kernel=None, fused: bool = False) -> tuple:
    """One query over object-backed segments: the cold run from an empty
    block cache (the scan's read-ahead on: decode seconds, bytes
    fetched, chunks read ahead, graphs captured when `fused`), the
    counted warm run (kernel launches by shape with their inputs
    captured), 3 warm runs served by the device tier (hit rate >= 99%,
    0 bytes uploaded: raises otherwise) and one profiled run; every
    run's rows checked.  -> (record, captured inputs, rows)."""
    from matrixone_tpu_torch.storage import blockcache
    # the planner's table statistics read columns (through the host
    # tier) once per table version: plan first, so the cold run's scans
    # find the cache empty
    session.plan(sql)
    blockcache.CACHE.clear()
    c0, f0 = cache_counts(), fusion_counts()
    rows, batch, cold_s = run_sql(torch, session, sql)
    cold, cold_f = cache_since(c0), counts_since(f0)
    check(rows, batch)
    if cold["prefetch_chunks"] == 0:
        raise AssertionError(f"{label}: the cold scan read nothing ahead")
    if fused and not cold_f["captures"]:
        raise AssertionError(f"{label}: the cold fused run captured no "
                             f"graph")
    CK.LAUNCHES.reset()
    c0, f0 = cache_counts(), fusion_counts()
    with PathInputs(torch, TK) as cap:
        rows, batch, counted_s = run_sql(torch, session, sql)
    launches = kernel_launches(CK, label, ("sorted_search", "segment_sum",
                                           "segment_sum_walk"),
                               required=(kernel,) if kernel else ())
    check(rows, batch)
    warm = []
    for _ in range(3):
        r, b, w = run_sql(torch, session, sql)
        check(r, b)
        warm.append(w)
    wc, wf = cache_since(c0), counts_since(f0)
    looked = wc["dev_hits"] + wc["dev_misses"]
    hit_rate = wc["dev_hits"] / looked if looked else None
    if wc["uploaded_bytes"] or hit_rate is None or hit_rate < 0.99:
        raise AssertionError(f"{label}: the warm runs were not served by "
                             f"the device tier: {wc}")
    if fused and wf["captures"]:
        raise AssertionError(f"{label}: a warm run captured: {wf}")
    prof = profile_run(torch, lambda: session.execute(sql), label)
    out = {"cold_seconds": cold_s, "counted_seconds": counted_s,
           "warm_seconds": warm, "rows_per_sec_best": n_rows / min(warm),
           "cold_cache": cold, "warm_cache": wc,
           "warm_device_hit_rate": hit_rate, "launches": launches,
           "device_busy_share": prof["device_busy_share"],
           "h2d_copy_ms": prof["h2d_copy_ms"], "profile": prof}
    if fused:
        out.update(cold_fusion=cold_f, warm_fusion=wf)
    log(f"[{label}] cold {cold_s:.3f}s (decode {cold['decode_seconds']:.3f}"
        f"s, {cold['bytes_fetched'] / 2 ** 20:.0f} MiB fetched, "
        f"{cold['prefetch_chunks']:.0f} chunks read ahead) warm "
        f"{['%.4f' % w for w in warm]} best {out['rows_per_sec_best']:.0f} "
        f"rows/s; warm device-tier hit rate {hit_rate:.4f}, uploaded "
        f"{wc['uploaded_bytes']} B; busy {prof['device_busy_share']:.1%}, "
        f"host-to-device copies {prof['h2d_copy_ms']:.3f} ms")
    return out, cap, rows


def object_bytes(root: str) -> dict:
    """Bytes of the objects under `root` by table."""
    out = {}
    base = os.path.join(root, "objects")
    for table in sorted(os.listdir(base)) if os.path.isdir(base) else ():
        d = os.path.join(base, table)
        out[table] = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
    return out


def phase_objects(torch, CK, args) -> tuple:
    """Phase 11: phase 5's SF1 tables object-backed on a LocalFS engine
    (11a Q3, 11b Q1/Q6/GROUP BY), then restarts, the refresh functions
    and merges over them (11c)."""
    import gc
    import shutil
    import tempfile
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage import blockcache
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.storage.fileservice import LocalFS
    from matrixone_tpu_torch.utils import tpch, tpch_full

    n = args.sf1_lineitem
    root = tempfile.mkdtemp(prefix="mo_chip_objects_")
    saved_env = os.environ.get("MO_BLOCK_CACHE_MB")
    report = {}
    try:
        eng = Engine(LocalFS(root))
        t0 = time.perf_counter()
        lineitem = tpch.load_lineitem(eng, n, seed=args.seed)
        q3data = tpch.load_tpch_q3(eng, n // 4, seed=args.seed)
        v = load_v_table(eng, n, args.seed)
        load_s = time.perf_counter() - t0
        host = {t: table_host_bytes(eng.get_table(t)) for t in eng.tables}
        # the budgets sized to the working set, as bench.py sizes them
        os.environ["MO_BLOCK_CACHE_MB"] = str(
            max(256, (sum(host.values()) >> 20) + 256))
        t0 = time.perf_counter()
        eng.checkpoint(demote=True)
        ckpt_s = time.perf_counter() - t0
        lazy = [seg.is_lazy for t in eng.tables.values()
                for seg in t.segments]
        if not lazy or not all(lazy):
            raise AssertionError("11a: a segment is not object-backed after "
                                 "checkpoint(demote=True)")
        report["load"] = {
            "load_seconds": load_s, "checkpoint_seconds": ckpt_s,
            "host_bytes": host, "object_bytes": object_bytes(root),
            "block_cache_mb": int(os.environ["MO_BLOCK_CACHE_MB"]),
            "segments": len(lazy)}
        log(f"[11a] loaded (with the WAL) in {load_s:.2f}s, checkpointed "
            f"and demoted in {ckpt_s:.2f}s: object bytes "
            f"{report['load']['object_bytes']}, host bytes {host}; "
            f"block cache {os.environ['MO_BLOCK_CACHE_MB']} MiB a tier")

        fsess = Session(catalog=eng, device="cuda")
        psess = Session(catalog=eng, device="cuda")
        psess.execute("set plan_fusion = 0")
        oracle = tpch.q3_oracle(lineitem, q3data)
        check_q3 = q3_rows_check(oracle, "11a")
        caps = {}
        from matrixone_tpu_torch.vm import fusion
        fusion.CACHE.clear()
        with PathInputs(torch, TK, "graphs") as spy:
            report["11a_q3_fused"], caps["11a_q3_fused"], q3_rows = \
                object_path(torch, CK, TK, "11a Q3 fused", fsess,
                            tpch.Q3_SQL, n, check_q3, "sorted_search",
                            fused=True)
        report["11a_q3_per_operator"], caps["11a_q3_per_operator"], \
            p_rows = object_path(torch, CK, TK, "11a Q3 per-operator",
                                 psess, tpch.Q3_SQL, n, check_q3,
                                 "sorted_search")
        if p_rows != q3_rows:
            raise AssertionError("11a: fused and per-operator Q3 differ")
        report["11a_compare"] = compare_paths(report["11a_q3_fused"],
                                              report["11a_q3_per_operator"])

        # 11b: Q1 (dense on every chunk), Q6, 5c's GROUP BY
        q1_float = {}
        c0 = agg_chunks()
        report["11b_q1"], _cap, _ = object_path(
            torch, CK, TK, "11b Q1", psess, tpch.Q1_SQL, n,
            q1_rows_check(lineitem, q1_float, "11b"))
        chunks = {p: c - c0[p] for p, c in agg_chunks().items()}
        if chunks["dense"] == 0 or chunks["general"] != 0:
            raise AssertionError(f"11b Q1's aggregate did not take the "
                                 f"dense path on every chunk: {chunks}")
        report["11b_q1"]["agg_chunks"] = chunks
        report["11b_q6"], _cap, _ = object_path(
            torch, CK, TK, "11b Q6", psess, tpch.Q6_SQL, n,
            q6_rows_check(lineitem, "11b"))
        gb_err = {}
        report["11b_group_by"], caps["11b_group_by"], _ = object_path(
            torch, CK, TK, "11b GROUP BY", psess, GROUP_BY_SQL, n,
            group_by_check(v, gb_err, "11b"), "segment_sum")
        report["11b_group_by"].update(gb_err)

        # the kernels at every shape 11a and 11b launched them with
        search_rows = []
        for key in ("11a_q3_fused", "11a_q3_per_operator"):
            search_rows += check_spill_search(
                torch, CK, key, report[key], caps[key],
                spy.seen if key.endswith("fused") else ())
        report["11a_graph_search"] = {
            "captured_calls": len(spy.seen),
            "shapes": sorted({(a.shape[0], q.shape[0])
                              for a, q, _ in spy.seen})}
        del spy
        counts = {tuple(r[:-1]): r[-1] for r in report["11b_group_by"][
            "launches"]["segment_sum"]["by_shape"]}
        segsum_rows = [dict(check_segment_sum(
            torch, CK, f"11b_n{n_}_G{g}", *caps["11b_group_by"].segsum[
                (n_, g)], g), path="11b_group_by", path_launches=c)
            for (n_, g), c in sorted(counts.items())]
        del caps, fsess
        fusion.CACHE.clear()

        # phase 12 over the same object-backed tables, before 11c
        # refreshes them
        report["serving"], serving_search, serving_segsum = phase_serving(
            torch, CK, eng, lineitem, q3data, v, args.seed)
        search_rows += serving_search
        segsum_rows += serving_segsum
        log(f"[12] phase 12 took {report['serving']['seconds']:.1f}s")

        # 11c: restart, refresh, restart from the WAL tail, merge
        del psess, eng
        gc.collect()
        blockcache.CACHE.clear()
        t0 = time.perf_counter()
        eng = Engine.open(LocalFS(root))
        open_s = time.perf_counter() - t0
        sess = Session(catalog=eng, device="cuda")
        sess.execute("set plan_fusion = 0")
        rows, _b, cold_s = run_sql(torch, sess, tpch.Q3_SQL)
        if rows != q3_rows:
            raise AssertionError("11c: Q3 after Engine.open differs")
        report["11c_reopen"] = {"open_seconds": open_s,
                                "q3_cold_seconds": cold_s,
                                "recovery": eng.recovery_summary}
        tables = {"lineitem": lineitem, "orders": q3data["orders"]}
        rf1 = tpch_full.rf1(tables, 1.0, seed=args.seed + 4, q3data=q3data)
        rf1_s, _a, rf1_parts = run_statements(torch, sess, rf1.statements)
        tables = tpch_full.apply_refresh(tables, rf1)
        rf2 = tpch_full.rf2(tables, 1.0, seed=args.seed + 5)
        rf2_s, _a, rf2_parts = run_statements(torch, sess, rf2.statements)
        after = tpch_full.apply_refresh(tables, rf2)
        lineitem2 = after["lineitem"]
        q3data2 = dict(q3data, orders=after["orders"])
        del sess, eng
        gc.collect()
        blockcache.CACHE.clear()
        t0 = time.perf_counter()
        eng = Engine.open(LocalFS(root))
        replay_s = time.perf_counter() - t0
        sess = Session(catalog=eng, device="cuda")
        sess.execute("set plan_fusion = 0")
        report["11c_refresh"] = {
            "rf1_seconds": rf1_s, "rf2_seconds": rf2_s,
            "rf1": rf1_parts, "rf2": rf2_parts,
            "restart_seconds": replay_s,
            "recovery": eng.recovery_summary}
        if not eng.recovery_summary["frames_replayed"]:
            raise AssertionError("11c: the restart replayed no WAL frame")
        q1_want = tpch.q1_oracle(lineitem2)

        def check_q1(_rows, batch):
            bad = q1_exact(batch, q1_want)
            if bad:
                raise AssertionError(f"11c Q1 differs from q1_oracle: "
                                     f"{bad[:4]}")
        check_q3b = q3_rows_check(tpch.q3_oracle(lineitem2, q3data2),
                                  "11c after the refresh")
        for label, sql, check in (("q1", tpch.Q1_SQL, check_q1),
                                  ("q3", tpch.Q3_SQL, check_q3b)):
            rows, batch, _s = run_sql(torch, sess, sql)
            check(rows, batch)
            warm = []
            for _ in range(3):
                rows, batch, w = run_sql(torch, sess, sql)
                check(rows, batch)
                warm.append(w)
            report["11c_refresh"][f"{label}_warm_seconds"] = warm
        log(f"[11c] reopened in {open_s:.2f}s (Q3 equal); RF1 "
            f"{rf1_s:.2f}s, RF2 {rf2_s:.2f}s; restart from the WAL tail "
            f"{replay_s:.2f}s {eng.recovery_summary}; Q1 and Q3 exact to "
            f"the refreshed oracles, warm Q1 "
            f"{min(report['11c_refresh']['q1_warm_seconds']):.4f}s")
        ts_pre = eng.committed_ts
        as_of = tpch.Q1_SQL.replace(
            "from lineitem", f"from lineitem as of timestamp {ts_pre}")
        pre_rows = sess.execute(as_of).rows()
        segs = {t: len(eng.get_table(t).segments) for t in ("lineitem",
                                                             "orders")}
        t0 = time.perf_counter()
        kept = {t: eng.merge_table(t) for t in ("lineitem", "orders")}
        merge_s = time.perf_counter() - t0
        if kept != {"lineitem": len(lineitem2["l_orderkey"]),
                    "orders": len(q3data2["orders"]["o_orderkey"])}:
            raise AssertionError(f"11c: the merges kept {kept}")
        if sess.execute(as_of).rows() != pre_rows:
            raise AssertionError("11c: Q1 AS OF before the merge changed")
        rows, batch, _s = run_sql(torch, sess, tpch.Q1_SQL)
        check_q1(rows, batch)
        warm = []
        for _ in range(3):
            rows, batch, w = run_sql(torch, sess, tpch.Q1_SQL)
            check_q1(rows, batch)
            warm.append(w)
        rows, batch, _s = run_sql(torch, sess, tpch.Q3_SQL)
        check_q3b(rows, batch)
        report["11c_merge"] = {
            "segments_before": segs, "kept": kept, "seconds": merge_s,
            "q1_warm_seconds": warm,
            "object_bytes": object_bytes(root)}
        log(f"[11c] merged {segs} segments in {merge_s:.2f}s; Q1 after RF2 "
            f"and the merge warm {min(warm):.4f}s (before the merge "
            f"{min(report['11c_refresh']['q1_warm_seconds']):.4f}s); Q1 AS "
            f"OF before the merge unchanged; Q3 exact")
        del sess, eng
    finally:
        if saved_env is None:
            os.environ.pop("MO_BLOCK_CACHE_MB", None)
        else:
            os.environ["MO_BLOCK_CACHE_MB"] = saved_env
        blockcache.CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


#: 12a: the point query of bench.py's serving workload
SERVING_POINT_SQL = ("select count(*), sum(l_quantity) from lineitem"
                     " where l_orderkey = ?")
#: 12b: Q3 (its market segment a parameter) and 5c's GROUP BY (a lower
#: bound on id), three values a run
Q3_SEGMENTS = ("MACHINERY", "AUTOMOBILE", "BUILDING")
GROUP_BY_PARAM_SQL = ("select grp, sum(xi), sum(xn) from v where id >= ?"
                      " group by grp order by grp")


def q3_segment_oracle(lineitem, q3data, segment: str):
    """`q3_oracle` for another market segment: the customers of
    `segment` take BUILDING's code, every other customer none."""
    from matrixone_tpu_torch.utils import tpch
    seg = q3data["seg_codes"]
    codes = np.where(seg == tpch.SEGMENTS.index(segment),
                     tpch.SEGMENTS.index("BUILDING"), -1)
    return tpch.q3_oracle(lineitem, dict(q3data, seg_codes=codes))


def serving_passes(torch, session, lineitem, rounds: int = 5) -> dict:
    """12a: bench.py's `bench_serving` workload on the port: 8 point
    queries (`l_orderkey = ?`) and Q1 a pass, cold (both caches off),
    plan cache only, and warm (plan and result caches), as bench.py runs
    them; each pass's qps, the hit rates, and p50/p99 of the statements
    from `query_seconds`.  Every row equals the uncached run's (and the
    point queries a numpy oracle, Q1 `q1_oracle`); the plan-only hit
    rate must reach 0.9."""
    from matrixone_tpu_torch.serving import serving_for
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch
    sv = serving_for(session.catalog)
    keys = [1 + 8 * i for i in range(8)]
    okey, qty = lineitem["l_orderkey"], lineitem["l_quantity"]
    want_point = {k: (int((okey == k).sum()), int(qty[okey == k].sum()))
                  for k in keys}
    q1_check = q1_rows_check(lineitem, {}, "12a")
    uncached = {}

    def one_pass():
        """One pass, `session.execute` alone (as bench.py times it): its
        results, host batches, checked once the timer has stopped."""
        return ([session.execute(SERVING_POINT_SQL, [k]) for k in keys]
                + [session.execute(tpch.Q1_SQL)])

    def check(label, results):
        for k, res in zip(keys, results):
            rows = res.rows()
            (n, total), = rows
            if (n, round(total * 100)) != want_point[k]:
                raise AssertionError(f"12a {label}: l_orderkey = {k} gives "
                                     f"{rows}, the oracle {want_point[k]}")
            if uncached.setdefault(k, rows) != rows:
                raise AssertionError(f"12a {label}: l_orderkey = {k} rows "
                                     f"differ from the uncached run's")
        res = results[-1]
        rows = res.rows()
        q1_check(rows, res.batch)
        if uncached.setdefault("q1", rows) != rows:
            raise AssertionError(f"12a {label}: Q1 rows differ from the "
                                 f"uncached run's")

    def unmeasured(label):
        check(label, one_pass())
    per_pass = len(keys) + 1
    plan_was, mb_was = sv.plan_cache.enabled, sv.result_cache.max_bytes
    out = {}

    def measured(label):
        q0 = M.query_seconds.snapshot()
        t0 = time.perf_counter()
        passes = [one_pass() for _ in range(rounds)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        q1 = M.query_seconds.snapshot()
        for results in passes:
            check(label, results)
        return {"qps": rounds * per_pass / secs, "seconds": secs,
                "statements": rounds * per_pass,
                "p50_s": M.histogram_delta_quantile(q0, q1, 0.5),
                "p99_s": M.histogram_delta_quantile(q0, q1, 0.99)}
    try:
        sv.plan_cache.enabled = False
        sv.result_cache.max_bytes = 0
        sv.clear()
        unmeasured("cold")                     # the compile warm-up
        out["cold"] = measured("cold")
        sv.plan_cache.enabled = True
        sv.clear()
        unmeasured("plan")                     # notes the templates
        unmeasured("plan")                     # activates and stores
        h0 = M.plan_cache_ops.get(outcome="hit")
        m0 = M.plan_cache_ops.get(outcome="miss")
        t0 = M.plan_cache_ops.get(outcome="tree_hit")
        out["plan_only"] = measured("plan")
        ph = M.plan_cache_ops.get(outcome="hit") - h0
        pm = M.plan_cache_ops.get(outcome="miss") - m0
        out["plan_cache_hit_rate"] = ph / (ph + pm) if ph + pm else 0.0
        out["plan_only"]["tree_hits"] = \
            M.plan_cache_ops.get(outcome="tree_hit") - t0
        if out["plan_cache_hit_rate"] < 0.9:
            raise AssertionError(f"12a: plan-cache hit rate "
                                 f"{out['plan_cache_hit_rate']:.3f} < 0.9")
        sv.result_cache.max_bytes = 256 << 20
        unmeasured("warm")                     # populates the results
        h0 = M.result_cache_ops.get(outcome="hit")
        m0 = M.result_cache_ops.get(outcome="miss") + \
            M.result_cache_ops.get(outcome="stale")
        out["warm"] = measured("warm")
        rh = M.result_cache_ops.get(outcome="hit") - h0
        rm = M.result_cache_ops.get(outcome="miss") + \
            M.result_cache_ops.get(outcome="stale") - m0
        out["result_cache_hit_rate"] = rh / (rh + rm) if rh + rm else 0.0
    finally:
        sv.plan_cache.enabled = plan_was
        sv.result_cache.max_bytes = mb_was
        sv.clear()
    out["warm_over_cold"] = out["warm"]["qps"] / out["cold"]["qps"]
    log(f"[12a] serving: cold {out['cold']['qps']:.1f} qps (p50 "
        f"{out['cold']['p50_s']} s, p99 {out['cold']['p99_s']} s), plan "
        f"cache only {out['plan_only']['qps']:.1f} qps (hit rate "
        f"{out['plan_cache_hit_rate']:.3f}, tree hits "
        f"{out['plan_only']['tree_hits']:.0f}), plan + result "
        f"{out['warm']['qps']:.1f} qps (hit rate "
        f"{out['result_cache_hit_rate']:.3f}, p50 {out['warm']['p50_s']} s, "
        f"p99 {out['warm']['p99_s']} s); every row equal to the uncached "
        f"run's")
    return out


def tree_reuse_path(torch, CK, TK, label: str, session, sql: str, warm,
                    values, checks, kernel: str, fused: bool) -> tuple:
    """12b: one parameterized query through the plan cache's reused tree:
    a warm-up (notes the template), a counted run of each of the 3
    values (kernel launches by shape, inputs captured; the rows checked,
    the tree taken twice), 3 more runs of the last value (tree reuse:
    warm best with the plan cache on), then 3 with the plan cache off
    (a fresh compile each: warm best off).  -> (record, inputs, graph
    spy's records)."""
    from matrixone_tpu_torch.serving import serving_for
    from matrixone_tpu_torch.utils import metrics as M
    sv = serving_for(session.catalog)
    sv.plan_cache.clear()
    spy = PathInputs(torch, TK, "graphs") if fused else None
    if spy is not None:
        spy.__enter__()
    try:
        session.execute(sql, warm)
        CK.LAUNCHES.reset()
        t0 = M.plan_cache_ops.get(outcome="tree_hit")
        f0 = fusion_counts()
        with PathInputs(torch, TK) as cap:
            for v, check in zip(values, checks):
                rows, batch, _s = run_sql_params(torch, session, sql, v)
                check(rows, batch)
        launches = kernel_launches(CK, label, ("sorted_search",
                                               "segment_sum",
                                               "segment_sum_walk"),
                                   required=(kernel,))
        tree_hits = M.plan_cache_ops.get(outcome="tree_hit") - t0
        counted_f = counts_since(f0)
        if tree_hits != 2:
            raise AssertionError(f"{label}: the 3 runs took the cached "
                                 f"tree {tree_hits} times, not 2")
        on = []
        for _ in range(3):
            rows, batch, w = run_sql_params(torch, session, sql, values[-1])
            checks[-1](rows, batch)
            on.append(w)
        sv.plan_cache.enabled = False
        off = []
        try:
            for _ in range(3):
                rows, batch, w = run_sql_params(torch, session, sql,
                                                values[-1])
                checks[-1](rows, batch)
                off.append(w)
        finally:
            sv.plan_cache.enabled = True
    finally:
        if spy is not None:
            spy.__exit__(None, None, None)
    out = {"launches": launches, "tree_hits": tree_hits,
           "warm_seconds_plan_cache_on": on,
           "warm_seconds_plan_cache_off": off,
           "warm_best_on": min(on), "warm_best_off": min(off)}
    if fused:
        out["counted_fusion"] = counted_f
    log(f"[{label}] 3 values exact, tree taken {tree_hits:.0f} times; warm "
        f"best with the plan cache {min(on):.4f}s, without "
        f"{min(off):.4f}s")
    return out, cap, (spy.seen if spy is not None else [])


def run_sql_params(torch, session, sql: str, params):
    """-> (rows, result batch, seconds) of one run of `sql` with
    `params`."""
    t0 = time.perf_counter()
    res = session.execute(sql, params)
    rows = res.rows()
    torch.cuda.synchronize()
    return rows, res.batch, time.perf_counter() - t0


def traced_breakdown(torch, session, label: str, sql: str) -> dict:
    """12c: one traced warm run: milliseconds by span name (the host
    loop's layers), and the device's busy share from one profiler trace
    of the same run."""
    from matrixone_tpu_torch.utils import motrace
    tr = motrace.TRACER
    was = (tr.armed, tr.sample)
    tr.arm(sample=1.0)
    tr.clear()
    try:
        prof = profile_run(torch, lambda: session.execute(sql),
                           f"12c {label}", top=4)
        (tid,) = tr.trace_ids()
        spans = tr.spans_of(tid)
    finally:
        tr.armed, tr.sample = was
        tr.clear()
    by_name, counts = {}, {}
    for sp in spans:
        by_name[sp["name"]] = by_name.get(sp["name"], 0.0) \
            + sp["dur_us"] / 1e3
        counts[sp["name"]] = counts.get(sp["name"], 0) + 1
    out = {"span_ms": by_name, "span_counts": counts,
           "wall_ms": prof["wall_ms"],
           "device_busy_share": prof["device_busy_share"],
           "device_busy_ms": prof["device_busy_ms"]}
    log(f"[12c] {label}: wall {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_share']:.1%}; span ms "
        + ", ".join(f"{k} {v:.3f} (x{counts[k]})"
                    for k, v in sorted(by_name.items(),
                                       key=lambda kv: -kv[1])))
    return out


def phase_serving(torch, CK, eng, lineitem, q3data, v, seed: int) -> tuple:
    """Phase 12: the serving and operations surface over phase 11's
    object-backed SF1 tables.  -> (report, search rows, segment-sum
    rows)."""
    import gc
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage import blockcache
    from matrixone_tpu_torch.utils import tpch
    from matrixone_tpu_torch.utils.fault import INJECTOR
    from matrixone_tpu_torch.vm import fusion
    report = {}
    t_all = time.perf_counter()
    # 12a: bench.py's serving workload (the fused default session)
    sess = Session(catalog=eng, device="cuda")
    report["12a_serving"] = serving_passes(torch, sess, lineitem)

    # 12b: tree reuse, fused and per-operator, 3 values each
    q3_sql = tpch.Q3_SQL.replace("'BUILDING'", "?")
    q3_checks = [q3_rows_check(q3_segment_oracle(lineitem, q3data, seg),
                               f"12b Q3 {seg}") for seg in Q3_SEGMENTS]
    gb_err = {}
    gb_checks = []
    n = len(lineitem["l_orderkey"])
    group_by_from = (0, 1000, n // 3)
    for lo in group_by_from:
        keep = v["id"] >= lo
        gb_checks.append(group_by_check({c: a[keep] for c, a in v.items()},
                                        gb_err, f"12b GROUP BY id >= {lo}"))
    search_rows, segsum_rows = [], []
    for path in ("fused", "per_operator"):
        s = Session(catalog=eng, device="cuda")
        if path == "per_operator":
            s.execute("set plan_fusion = 0")
        key = f"12b_q3_{path}"
        rec, cap, seen = tree_reuse_path(
            torch, CK, TK, f"12b Q3 {path}", s, q3_sql, ["HOUSEHOLD"],
            [[seg] for seg in Q3_SEGMENTS], q3_checks, "sorted_search",
            path == "fused")
        report[key] = rec
        search_rows += check_spill_search(torch, CK, key, rec, cap, seen)
        key = f"12b_group_by_{path}"
        rec, cap, _seen = tree_reuse_path(
            torch, CK, TK, f"12b GROUP BY {path}", s, GROUP_BY_PARAM_SQL,
            [500], [[lo] for lo in group_by_from], gb_checks, "segment_sum",
            path == "fused")
        rec.update(gb_err)
        report[key] = rec
        counts = {tuple(r[:-1]): r[-1]
                  for r in rec["launches"]["segment_sum"]["by_shape"]}
        missing = [k for k in counts if k not in cap.segsum]
        if missing:
            raise AssertionError(f"{key}: segment-sum shapes launched with "
                                 f"no input captured: {missing}")
        segsum_rows += [dict(check_segment_sum(
            torch, CK, f"{key}_n{n_}_G{g}", *cap.segsum[(n_, g)], g),
            path=key, path_launches=c)
            for (n_, g), c in sorted(counts.items())]
        del s, cap
    # 12c: the host loop's breakdown, one traced warm run each
    for label, sql in (("q1", tpch.Q1_SQL), ("q3", tpch.Q3_SQL),
                       ("q6", tpch.Q6_SQL)):
        for _ in range(3):           # note, activate, then reuse the tree
            sess.execute(sql)
        report[f"12c_{label}"] = traced_breakdown(torch, sess, label, sql)
    # 12d: four threads on fused Q3, result cache off: the serial rows
    serial = {seg: sess.execute(q3_sql, [seg]).rows()
              for seg in Q3_SEGMENTS}
    errors, mismatches = [], []

    def worker(t):
        ws = Session(catalog=eng, device="cuda")
        try:
            for i in range(3):
                seg = Q3_SEGMENTS[(t + i) % len(Q3_SEGMENTS)]
                if ws.execute(q3_sql, [seg]).rows() != serial[seg]:
                    mismatches.append((t, seg))
        except Exception as e:         # noqa: BLE001 — raised below
            errors.append(repr(e))
        finally:
            ws.close()
    from matrixone_tpu_torch.utils import metrics as M
    e0 = M.fusion_exec.get(mode="eager")
    rounds = []
    for _ in range(2):       # the first meets each key anew: spares
        sp0 = M.fusion_graphs.get(event="spare")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        if errors or mismatches:
            raise AssertionError(f"12d: concurrent Q3 failed: {errors[:2]} "
                                 f"{mismatches[:4]}")
        rounds.append({"seconds": time.perf_counter() - t0,
                       "spare_graphs": M.fusion_graphs.get(event="spare")
                       - sp0})
    if M.fusion_exec.get(mode="eager") != e0:
        raise AssertionError("12d: a concurrent fragment ran eagerly")
    t0 = time.perf_counter()
    for t in range(4):
        for i in range(3):
            sess.execute(q3_sql, [Q3_SEGMENTS[(t + i) % len(Q3_SEGMENTS)]])
    torch.cuda.synchronize()
    report["12d_concurrent_q3"] = {
        "threads": 4, "runs_per_round": 12, "rounds": rounds,
        "serial_seconds": time.perf_counter() - t0}
    log(f"[12d] 4 threads x 3 fused Q3 runs equal the serial rows: "
        + "; ".join(f"{r['seconds']:.2f}s ({r['spare_graphs']:.0f} spare "
                    f"graphs captured)" for r in rounds)
        + f"; the same 12 runs serial "
          f"{report['12d_concurrent_q3']['serial_seconds']:.2f}s")
    # 12e: EXPLAIN ANALYZE of Q3; an object.read fault on a cold scan
    text = sess.execute("explain analyze " + tpch.Q3_SQL).text
    if "mode=fused" not in text or not text.startswith("TopKOp  rows=10"):
        raise AssertionError(f"12e: EXPLAIN ANALYZE of Q3:\n{text}")
    log("[12e] EXPLAIN ANALYZE Q3:\n" + text)
    psess = Session(catalog=eng, device="cuda")
    psess.execute("set plan_fusion = 0")
    psess.plan(tpch.Q1_SQL)
    blockcache.CACHE.clear()
    INJECTOR.add("object.read", "return", "fail", every=3)
    try:
        psess.execute(tpch.Q1_SQL)
    except IOError as e:
        if "object.read" not in str(e):
            raise
        fault = str(e)
    else:
        raise AssertionError("12e: the object.read fault did not surface")
    finally:
        INJECTOR.clear()
    q1_check = q1_rows_check(lineitem, {}, "12e")
    res = psess.execute(tpch.Q1_SQL)
    q1_check(res.rows(), res.batch)
    report["12e"] = {"explain_analyze": text.split("\n"),
                     "fault_error": fault}
    log(f"[12e] the object.read fault raised ({fault[:60]}), the next Q1 "
        f"is exact")
    del sess, psess
    fusion.CACHE.clear()
    gc.collect()
    report["seconds"] = time.perf_counter() - t_all
    return report, search_rows, segsum_rows


# ---------------------------------------------------------------- phase 13
#: 13a/13c's queries a pass, and how many of them the exact scan (the
#: same session's plan without the index, about 0.5 s a statement at
#: 1M x 768) answers for recall: cut to half to keep phase 13 near 150 s,
#: to a quarter for phase 17's time and to an eighth for phase 18's
#: (PERF.md section 4); and how many statements the traced run holds
VSQL_QUERIES = 64
VSQL_EXACT_QUERIES = 8
VSQL_TRACED = 4
VSQL_LISTS = 1024
#: sql/optimize.apply_indices' overfetch (x 3 again for IVF-PQ)
VSQL_OVERFETCH = 3
VSQL_DELTA_ROWS = 100


def vec_literal(v) -> str:
    """A vector literal whose text parses back to the same f32 values."""
    return "[" + ",".join(repr(float(x)) for x in v) + "]"


def knn_sql(table: str, q) -> str:
    return (f"select id, l2_distance(emb, '{vec_literal(q)}') d "
            f"from {table} order by d limit {K}")


def load_items(session, name: str, data_np: np.ndarray,
               first_id: int = 0) -> float:
    """Create `name` (id bigint primary key, emb vecf32(d)) if needed and
    load `data_np` through `insert_numpy`, ids from `first_id` -> the
    load's seconds."""
    if name not in session.catalog.tables:
        session.execute(f"create table {name} (id bigint primary key, "
                        f"emb vecf32({data_np.shape[1]}))")
    t0 = time.perf_counter()
    session.catalog.get_table(name).insert_numpy(
        {"id": np.arange(first_id, first_id + len(data_np),
                         dtype=np.int64), "emb": data_np})
    return time.perf_counter() - t0


class VectorTopKSpy:
    """Records the candidate ids each VectorTopK source of the path
    yields, in the search's order, without changing its batches."""

    def __init__(self, session):
        self.session = session
        self.ids = []

    def __enter__(self):
        from matrixone_tpu_torch.vm import vector_scan as VS
        self._vs, self._real = VS, VS.VectorTopKOp.execute
        spy, real = self, self._real

        def execute(op):
            for ex in real(op):
                b = spy.session._to_host(ex, op.node.schema)
                spy.ids.append(np.asarray(
                    b.columns[f"{op.node.table}.id"].to_pylist(), np.int64))
                yield ex
        VS.VectorTopKOp.execute = execute
        return self

    def __exit__(self, *exc):
        self._vs.VectorTopKOp.execute = self._real
        return False


class VectorInputs:
    """Records, for one run of a path, the inputs it hands the L2 kernel
    and the ADC kernel's list form: one capture per launch shape, keyed
    as `LAUNCHES` keys them.  It wraps the two seam functions and calls
    the real ones, so the path's launches are unchanged."""

    def __init__(self, torch, TK):
        self.torch, self.TK = torch, TK
        self.l2, self.adc = {}, {}

    def __enter__(self):
        torch, TK = self.torch, self.TK
        self._real = (TK.l2_distance_sq_exact, TK.adc_score_lists)
        real_l2, real_adc = self._real

        def l2(x, q):
            key = (x.shape[0], q.shape[0], x.shape[1])
            if key not in self.l2:
                self.l2[key] = (x.float().contiguous().clone(),
                                q.float().contiguous().clone())
            return real_l2(x, q)

        def adc(codes, starts, ends, lut, pad):
            key = (lut.shape[0], int(pad), codes.shape[1])
            if key not in self.adc:
                self.adc[key] = (codes,
                                 starts.to(torch.int32).contiguous().clone(),
                                 ends.to(torch.int32).contiguous().clone(),
                                 lut.float().contiguous().clone())
            return real_adc(codes, starts, ends, lut, pad)

        TK.l2_distance_sq_exact, TK.adc_score_lists = l2, adc
        return self

    def __exit__(self, *exc):
        self.TK.l2_distance_sq_exact, self.TK.adc_score_lists = self._real
        return False


def same_candidates(label: str, got: np.ndarray, scored, k: int,
                    q2: float) -> int:
    """The VectorTopK's candidates against the f64 oracle's top-k over
    the same probed lists (`scored`: every probed row's id and score):
    the same ids, but for rows whose oracle score lies within the L2
    kernel's error bound, 1e-5 (||q||^2 + s_k) + 1e-4, of the k-th score
    s_k (a tie the search's f32 arithmetic may break either way) -> the
    number of such swaps."""
    ids, score = scored
    k = min(k, len(ids))
    order = np.argsort(score, kind="stable")
    kth = score[order[k - 1]]
    tol = 1e-5 * (q2 + abs(kth)) + 1e-4
    want = set(ids[order[:k]].tolist())
    have = set(got.tolist())
    by_id = dict(zip(ids.tolist(), score.tolist()))
    diff = want ^ have
    if len(got) != k or any(abs(by_id.get(i, INF) - kth) > tol
                            for i in diff):
        raise AssertionError(
            f"{label}: the VectorTopK candidates differ from the oracle's "
            f"top {k} of the probed lists beyond ties ({len(diff)} ids, "
            f"{len(got)} candidates)")
    return len(diff) // 2


def rerank_check(label: str, rows, cand: np.ndarray, data_np: np.ndarray,
                 q: np.ndarray) -> None:
    """The statement's rows against an f64 re-rank of its candidates on
    the host: the k nearest by a left-fold f64 distance (3c's oracle,
    what the Project recomputes), ids and distances equal."""
    sq = (data_np[cand].astype(np.float64) - q.astype(np.float64)) ** 2
    acc = np.zeros(len(cand))
    for j in range(sq.shape[1]):
        acc = acc + sq[:, j]
    dist = np.sqrt(acc)
    order = np.argsort(dist, kind="stable")[:K]
    got_ids = np.array([r[0] for r in rows], np.int64)
    got_d = np.array([r[1] for r in rows], np.float64)
    if not (np.array_equal(got_ids, cand[order])
            and np.allclose(got_d, dist[order], rtol=1e-12, atol=0)):
        raise AssertionError(f"{label}: rows differ from the f64 re-rank "
                             f"of the candidates")


def knn_pass(torch, session, table: str, q_np: np.ndarray, spy=False):
    """One statement per query -> (rows per query, candidates per query
    or None, seconds of the pass)."""
    rows = []
    ctx = VectorTopKSpy(session) if spy else None
    t0 = time.perf_counter()
    if ctx is not None:
        ctx.__enter__()
    try:
        for q in q_np:
            rows.append(session.execute(knn_sql(table, q)).rows())
        torch.cuda.synchronize()
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return rows, (ctx.ids if ctx is not None else None), \
        time.perf_counter() - t0


def exact_knn(session, table: str, q) -> list:
    """The statement inside a transaction, where the planner takes the
    exact scan (sql/optimize.apply_indices' skip_tables)."""
    session.execute("begin")
    try:
        return session.execute(knn_sql(table, q)).rows()
    finally:
        session.execute("commit")


def vsql_recall(rows, truth) -> float:
    return float(np.mean([len({r[0] for r in a} & {r[0] for r in b}) / K
                          for a, b in zip(rows, truth)]))


def vsql_index_pass(torch, CK, TK, label: str, session, table: str, ix,
                    q_np: np.ndarray, data_np: np.ndarray, oracle,
                    required: tuple) -> tuple:
    """13a/13c: the plan holds VectorTopK and no Scan of the table; one
    counted pass (launches, inputs, candidates) and one timed pass of
    every query, and a profiled run of 8; each pass's rows equal the f64
    re-rank of that query's candidates, and the candidates the oracle's
    top over the probed lists."""
    plan = session.execute("explain " + knn_sql(table, q_np[0])).text
    if "VectorTopK" not in plan or "Scan" in plan:
        raise AssertionError(f"{label}: the plan is not an index scan:\n"
                             f"{plan}")
    CK.LAUNCHES.reset()
    with VectorInputs(torch, TK) as cap:
        rows, cands, _ = knn_pass(torch, session, table, q_np, spy=True)
    launches = kernel_launches(CK, label, ("l2_distance_sq",
                                           "adc_score_lists", "adc_score"),
                               required=required)
    if launches["adc_score"]["launches"]:
        raise AssertionError(f"{label}: the search ran the ADC kernel's "
                             f"dense form")
    timed, _, secs = knn_pass(torch, session, table, q_np)
    # the busy share from a trace of the first VSQL_TRACED statements:
    # tracing all 64 costs seconds of the profiler's own host work
    t0 = time.perf_counter()
    prof = profile_run(torch, lambda: knn_pass(torch, session, table,
                                               q_np[:VSQL_TRACED]),
                       f"{label}, {VSQL_TRACED} statements")
    prof_s = time.perf_counter() - t0
    k_cand = len(cands[0])
    t0 = time.perf_counter()
    _ids, scored = oracle(k_cand)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    swaps = 0
    for i, q in enumerate(q_np):
        swaps += same_candidates(f"{label} query {i}", cands[i], scored[i],
                                 k_cand, float((q.astype(np.float64) ** 2)
                                               .sum()))
        for r in (rows[i], timed[i]):
            rerank_check(f"{label} query {i}", r, cands[i], data_np, q)
    out = {"plan": plan, "launches": launches, "candidates": k_cand,
           "candidate_tie_swaps": swaps, "oracle_seconds": oracle_s,
           "profile_seconds": prof_s,
           "check_seconds": time.perf_counter() - t0,
           "ms_per_query": secs * 1e3 / len(q_np), "profile": prof,
           "index_bytes_cache": session.catalog.index_cache.stats()["used"],
           "nlist": ix.index_obj.nlist,
           "max_cluster_size": ix.index_obj.max_cluster_size}
    log(f"[{label}] {len(q_np)} statements: candidates {k_cand} equal to "
        f"the oracle's ({swaps} tie swaps), rows equal to the f64 re-rank "
        f"(twice); {out['ms_per_query']:.2f} ms a statement, busy "
        f"{prof['device_busy_share']:.1%} ({VSQL_TRACED} statements traced "
        f"in "
        f"{prof_s:.1f}s); the oracle {oracle_s:.1f}s, the checks "
        f"{out['check_seconds']:.1f}s")
    return out, rows, cands, cap


def vsql_kernel_rows(torch, CK, label: str, cap, launches: dict) -> tuple:
    """13d: each kernel at every shape `label` launched it with, on the
    path's own inputs -> (L2 rows, ADC list-form rows)."""
    l2 = [dict(check_kernel(torch, CK, f"{label}_{n}x{b}", x, q),
               path=label, path_launches=launches["l2_distance_sq"][
                   "by_shape_map"].get((n, b, d), 0))
          for (n, b, d), (x, q) in sorted(cap.l2.items())]
    adc = [dict(check_adc_lists(torch, CK, f"{label}_G{g}", codes, st, en,
                                lut, pad),
                path=label, path_launches=launches["adc_score_lists"][
                    "by_shape_map"].get((g, pad, m), 0))
           for (g, pad, m), (codes, st, en, lut) in sorted(cap.adc.items())]
    return l2, adc


def phase_vector_sql(torch, CK, args, dev: str = "cuda") -> tuple:
    """Phase 13: vector search through SQL at bench.py's configuration
    -> (report, L2 rows, ADC list-form rows)."""
    import gc

    from matrixone_tpu_torch import indexing
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.utils import datagen
    from matrixone_tpu_torch.vectorindex import ivf_pq
    from matrixone_tpu_torch.vectorindex.cache import index_nbytes

    n, d = args.n, args.d
    nq = VSQL_QUERIES
    report = {}
    t_phase = time.perf_counter()
    data, queries = datagen.make_clustered(n, d, nq, seed=args.seed,
                                           device=dev)
    data_np, q_np = data.cpu().numpy(), queries.cpu().numpy()
    # make_clustered's first draw: its centres
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    centres = torch.randn(min(2048, n // 4 or 1), d, generator=g,
                          device=dev).cpu().numpy()
    del data, queries
    sess = Session(device=dev)
    eng = sess.catalog
    load_s = load_items(sess, "items", data_np)
    t0 = time.perf_counter()
    sess.execute(f"create index iv using ivfflat on items (emb) "
                 f"lists = {VSQL_LISTS}")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix = eng.indexes["iv"]
    log(f"[13a] items {n}x{d} loaded in {load_s:.2f}s, create index "
        f"(ivfflat, lists {VSQL_LISTS}) {build_s:.2f}s, "
        f"{eng.index_cache.stats()['used'] / 1e9:.3f} GB on the card")

    # the exact scan (a transaction: the planner skips the index), on a
    # per-operator session: a fused step bakes each query's vector
    exact = Session(catalog=eng, device=dev)
    exact.execute("set plan_fusion = 0")
    ne = min(VSQL_EXACT_QUERIES, nq)
    t0 = time.perf_counter()
    truth = [exact_knn(exact, "items", q) for q in q_np[:ne]]
    exact_s = time.perf_counter() - t0

    def flat_oracle(k):
        return probed_truth_stored(torch, ix.index_obj, q_np, k, NPROBE,
                                   with_scores=True)

    rep, rows, _, cap_a = vsql_index_pass(torch, CK, TK, "13a_ivfflat_sql",
                                          sess, "items", ix, q_np, data_np,
                                          flat_oracle, ("l2_distance_sq",))
    rep.update(load_seconds=load_s, build_seconds=build_s,
               exact_scan_ms_per_query=exact_s * 1e3 / ne,
               exact_queries=ne,
               recall_at_20_vs_exact_scan=vsql_recall(rows[:ne], truth))
    # a warm statement captures nothing new
    before = fusion_counts()
    for _ in range(3):
        sess.execute(knn_sql("items", q_np[0]))
    rep["warm_fusion_counts"] = counts_since(before)
    if rep["warm_fusion_counts"]["captures"]:
        raise AssertionError("13a: a warm statement captured a graph")
    rep["seconds"] = time.perf_counter() - t_phase
    report["13a"] = rep
    log(f"[13a] recall@20 against the exact scan "
        f"{rep['recall_at_20_vs_exact_scan']:.4f} ({ne} queries; the exact "
        f"scan {rep['exact_scan_ms_per_query']:.1f} ms a statement)")
    report["13e"], sharded_l2 = phase_sharded_vector_sql(torch, CK, sess,
                                                         q_np, rows)
    ix.options.pop("_sharded", None)        # its repack's card memory
    torch.cuda.empty_cache()

    # 13b: upkeep on the card
    t_sub = time.perf_counter()
    b = {}
    rng = np.random.default_rng(args.seed)
    built = ix.index_obj
    c0 = centres[0]
    near0 = (c0 + 0.01 * rng.standard_normal((VSQL_DELTA_ROWS, d))).astype(
        np.float32)
    first = n
    t0 = time.perf_counter()
    sess.execute("insert into items values " + ", ".join(
        f"({first + i}, '{vec_literal(v)}')" for i, v in enumerate(near0)))
    b["insert_100_seconds"] = time.perf_counter() - t0
    new_ids = set(range(first, first + VSQL_DELTA_ROWS))
    CK.LAUNCHES.reset()
    with VectorInputs(torch, TK) as cap_b:
        t0 = time.perf_counter()
        got = sess.execute(knn_sql("items", c0)).rows()
        torch.cuda.synchronize()
        b["delta_query_seconds"] = time.perf_counter() - t0
    b["launches"] = kernel_launches(CK, "13b_delta", ("l2_distance_sq",),
                                    required=("l2_distance_sq",))
    if not ({r[0] for r in got} <= new_ids and ix.index_obj is built
            and len(ix.options["_delta_gids"]) == VSQL_DELTA_ROWS):
        raise AssertionError("13b: the inserted rows are not served from "
                             "the delta of the same index")
    # the 20 nearest of the inserted rows, ids and f64 distances
    rerank_check("13b delta", [(r[0] - first, r[1]) for r in got],
                 np.arange(VSQL_DELTA_ROWS), near0, c0)
    sess.execute(f"delete from items where id >= {first}")
    got = sess.execute(knn_sql("items", c0)).rows()
    if {r[0] for r in got} & new_ids or ix.index_obj is not built:
        raise AssertionError("13b: deleted rows served, or a rebuild")
    # past RECLUSTER_FRACTION of the indexed rows: a full recluster
    extra = int(indexing.RECLUSTER_FRACTION * n) + 1
    more = data_np[rng.integers(0, n, extra)] + 0.01 * rng.standard_normal(
        (extra, d)).astype(np.float32)
    b["insert_recluster_rows"] = extra
    b["insert_recluster_seconds"] = load_items(sess, "items", more,
                                               first + VSQL_DELTA_ROWS)
    del more
    t0 = time.perf_counter()
    sess.execute(knn_sql("items", c0))
    torch.cuda.synchronize()
    b["recluster_query_seconds"] = time.perf_counter() - t0
    if ix.index_obj is built or "_delta_gids" in ix.options:
        raise AssertionError("13b: an insert past RECLUSTER_FRACTION did "
                             "not recluster")
    del built
    # a delta folded in by fold_delta
    c1 = centres[1]
    near1 = (c1 + 0.01 * rng.standard_normal((VSQL_DELTA_ROWS, d))).astype(
        np.float32)
    first1 = first + VSQL_DELTA_ROWS + extra
    sess.execute("insert into items values " + ", ".join(
        f"({first1 + i}, '{vec_literal(v)}')" for i, v in enumerate(near1)))
    ids1 = set(range(first1, first1 + VSQL_DELTA_ROWS))
    got = sess.execute(knn_sql("items", c1)).rows()
    if not ({r[0] for r in got} <= ids1
            and len(ix.options["_delta_gids"]) == VSQL_DELTA_ROWS):
        raise AssertionError("13b: the second delta is not served")
    t0 = time.perf_counter()
    if not indexing.fold_delta(eng, ix, dev):
        raise AssertionError("13b: fold_delta folded nothing")
    torch.cuda.synchronize()
    b["fold_delta_seconds"] = time.perf_counter() - t0
    got = sess.execute(knn_sql("items", c1)).rows()
    if "_delta_gids" in ix.options or not {r[0] for r in got} <= ids1:
        raise AssertionError("13b: fold_delta lost the delta's rows")
    # eviction under a small budget frees the index's card memory
    idx_bytes = index_nbytes(ix.index_obj)
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    budget = eng.index_cache.budget
    eng.index_cache.budget = 1
    load_items(sess, "items_small", data_np[:1000])
    sess.execute("create index ivs using ivfflat on items_small (emb) "
                 "lists = 4")
    eng.index_cache.budget = budget
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    b.update(index_bytes=idx_bytes, memory_before_eviction=mem0,
             memory_after_eviction=mem1,
             evictions=eng.index_cache.stats()["evictions"])
    if ix.index_obj is not None or not ix.dirty \
            or mem0 - mem1 < 0.9 * idx_bytes:
        raise AssertionError(f"13b: eviction freed {mem0 - mem1} B of a "
                             f"{idx_bytes} B index")
    t0 = time.perf_counter()
    got = sess.execute(knn_sql("items", c1)).rows()
    torch.cuda.synchronize()
    b["rebuild_query_seconds"] = time.perf_counter() - t0
    if ix.index_obj is None or not {r[0] for r in got} <= ids1:
        raise AssertionError("13b: the evicted index was not rebuilt")
    b["seconds"] = time.perf_counter() - t_sub
    report["13b"] = b
    log(f"[13b] insert {VSQL_DELTA_ROWS} rows "
        f"{b['insert_100_seconds']:.2f}s, served from the delta of the "
        f"same index ({b['delta_query_seconds']:.2f}s with the refresh); "
        f"deleted: gone; {extra} rows: reclustered "
        f"({b['recluster_query_seconds']:.2f}s); fold_delta "
        f"{b['fold_delta_seconds']:.2f}s; eviction freed "
        f"{(mem0 - mem1) / 1e9:.3f} GB of a {idx_bytes / 1e9:.3f} GB "
        f"index, rebuilt on the next query "
        f"({b['rebuild_query_seconds']:.2f}s); 13b {b['seconds']:.1f}s")
    sess.execute("drop table items_small")
    sess.execute("drop table items")
    gc.collect()
    torch.cuda.empty_cache()

    # 13c: IVF-PQ on a second table of the same recipe (the same rows)
    t_sub = time.perf_counter()
    load_s = load_items(sess, "items_pq", data_np)
    m_sub = ivf_pq.pick_subspaces(d)
    t0 = time.perf_counter()
    sess.execute(f"create index ipq using ivfpq on items_pq (emb) "
                 f"lists = {VSQL_LISTS}")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pix = eng.indexes["ipq"]
    if pix.index_obj.n_subspaces != m_sub:
        raise AssertionError(f"13c: {pix.index_obj.n_subspaces} subspaces, "
                             f"_pick_subspaces gives {m_sub}")

    def pq_oracle(k):
        return pq_probed_truth(torch, pix.index_obj, q_np, k, NPROBE,
                               compute_dtype=None, with_scores=True)

    rep, rows, cands, cap_c = vsql_index_pass(
        torch, CK, TK, "13c_ivfpq_sql", sess, "items_pq", pix, q_np,
        data_np, pq_oracle, ("l2_distance_sq", "adc_score_lists"))
    raw = [[(int(i),) for i in c[:K]] for c in cands]
    rep.update(load_seconds=load_s, build_seconds=build_s,
               n_subspaces=m_sub,
               recall_at_20_raw_adc=vsql_recall(raw[:ne], truth),
               recall_at_20_after_rerank=vsql_recall(rows[:ne], truth),
               seconds=time.perf_counter() - t_sub)
    report["13c"] = rep
    log(f"[13c] IVF-PQ (M {m_sub}) create index {build_s:.2f}s; recall@20 "
        f"against the exact scan ({ne} queries, no gate): raw ADC "
        f"{rep['recall_at_20_raw_adc']:.4f}, after the overfetch's exact "
        f"re-rank {rep['recall_at_20_after_rerank']:.4f}; 13c "
        f"{rep['seconds']:.1f}s")

    # 13d: both kernels at every phase-13 shape, on the paths' own inputs
    l2_rows, adc_rows = [], []
    for label, cap, launches in (
            ("13a_ivfflat_sql", cap_a, report["13a"]["launches"]),
            ("13b_delta", cap_b, {"l2_distance_sq": b["launches"]
                                  ["l2_distance_sq"]}),
            ("13c_ivfpq_sql", cap_c, report["13c"]["launches"])):
        for rec in launches.values():
            rec["by_shape_map"] = {tuple(r[:-1]): r[-1]
                                   for r in rec["by_shape"]}
        l2, adc = vsql_kernel_rows(torch, CK, label, cap, launches)
        l2_rows += l2
        adc_rows += adc
        for rec in launches.values():
            del rec["by_shape_map"]
    sess.execute("drop table items_pq")
    l2_rows += sharded_l2
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[13] phase 13 took {report['seconds']:.1f}s")
    return report, l2_rows, adc_rows


# ------------------------------------------------------------- phase 14

SEARCH_QUERIES = 64
#: HNSW rows: phase 13's 1M halved until the single-threaded native
#: build fits 60 s on the card machine's host (12,500 rows took
#: 47.8-60.1 s on an H100 machine's host; 25,000 took longer than 60 s)
HNSW_ROWS = 12_500
HNSW_M, HNSW_EF_CONSTRUCTION = 16, 64
FT_DOCS = 100_000
FT_VOCAB = 30_000
FT_ZIPF = 1.1
FT_DOC_TOKENS = (40, 120)
FT_TERM_RANKS = (10, 5000)
FT_K = 10
FT_NEW_DOCS = 1000
FT_NEW_TERM = "newterm0"       # a digit: the vocabulary has none
LLM_ROWS = 100_000
LLM_TEXTS = 512
LLM_DIM = 32
#: every kernel counter; phase 14's path launches none of them
ALL_KERNELS = ("l2_distance_sq", "l2_distance_sq_masked", "adc_score",
               "adc_score_lists", "sorted_search", "segment_sum")


def ms_stats(seconds: list) -> dict:
    ms = np.asarray(seconds) * 1e3
    return {"ms_p50": float(np.percentile(ms, 50)),
            "ms_p99": float(np.percentile(ms, 99)),
            "ms_mean": float(ms.mean())}


def timed_statements(torch, session, sqls) -> tuple:
    """Each statement run and timed on its own -> (rows, seconds)."""
    rows, secs = [], []
    for sql in sqls:
        t0 = time.perf_counter()
        rows.append(session.execute(sql).rows())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return rows, secs


def exact_top_ids(torch, data, q_np: np.ndarray, k: int) -> list:
    """The exact f64 top k of every query over all rows, on the card."""
    x = data.double()
    out = []
    for q in q_np:
        d2 = ((x - torch.as_tensor(q, device=x.device).double()) ** 2).sum(1)
        out.append(torch.topk(d2, k, largest=False).indices.cpu().numpy())
    return out


def phase_hnsw_sql(torch, CK, args, dev: str) -> dict:
    """14a: an HNSW index through SQL on the host library's graph."""
    from matrixone_tpu_torch import native
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import datagen
    from matrixone_tpu_torch.vectorindex import hnsw

    if native.route() != "c":
        raise AssertionError("14a: the host library did not build: the "
                             "HNSW graph would take the numpy route")
    n, d, nq = HNSW_ROWS, args.d, SEARCH_QUERIES
    t_sub = time.perf_counter()
    data, queries = datagen.make_clustered(n, d, nq, seed=args.seed,
                                           device=dev)
    data_np, q_np = data.cpu().numpy(), queries.cpu().numpy()
    sess = Session(device=dev)
    load_s = load_items(sess, "hitems", data_np)
    t0 = time.perf_counter()
    sess.execute(f"create index hn using hnsw on hitems (emb) m = {HNSW_M} "
                 f"ef_construction = {HNSW_EF_CONSTRUCTION}")
    build_s = time.perf_counter() - t0
    ix = sess.catalog.indexes["hn"]
    if not isinstance(ix.index_obj, hnsw.NativeHnswIndex):
        raise AssertionError("14a: the index is not the native graph")
    plan = sess.execute("explain " + knn_sql("hitems", q_np[0])).text
    if "VectorTopK" not in plan or "Scan" in plan:
        raise AssertionError(f"14a: the plan is not an index scan:\n{plan}")
    sqls = [knn_sql("hitems", q) for q in q_np]
    CK.LAUNCHES.reset()
    with VectorTopKSpy(sess) as spy:
        rows, secs = timed_statements(torch, sess, sqls)
    launches = kernel_launches(CK, "14a_hnsw_sql", ALL_KERNELS)
    t0 = time.perf_counter()
    for i, q in enumerate(q_np):
        cand = spy.ids[i]
        k = len(cand)
        _d, walk = hnsw.search(ix.index_obj, q[None], k=k,
                               ef=max(64, 2 * k))
        if not np.array_equal(cand, walk[0][walk[0] >= 0]):
            raise AssertionError(f"14a query {i}: the VectorTopK "
                                 f"candidates are not the walk's")
        rerank_check(f"14a query {i}", rows[i], cand, data_np, q)
    check_s = time.perf_counter() - t0
    truth = exact_top_ids(torch, data, q_np, K)
    recall = float(np.mean([len({r[0] for r in got} & set(t.tolist())) / K
                            for got, t in zip(rows, truth)]))
    if recall < 0.80:
        raise AssertionError(f"14a: recall@20 {recall:.4f} < 0.80")
    before = fusion_counts()
    for _ in range(3):
        sess.execute(sqls[0])
    warm = counts_since(before)
    if warm["captures"]:
        raise AssertionError("14a: a warm statement captured a graph")
    prof = profile_run(torch, lambda: timed_statements(torch, sess,
                                                       sqls[:8]),
                       "14a, 8 statements")
    out = {"rows": n, "d": d, "M": HNSW_M,
           "ef_construction": HNSW_EF_CONSTRUCTION, "plan": plan,
           "load_seconds": load_s, "build_seconds": build_s,
           "candidates": len(spy.ids[0]), "launches": launches,
           "recall_at_20_vs_exact_f64": recall, "check_seconds": check_s,
           "warm_fusion_counts": warm, "profile": prof,
           "device_busy_share": prof["device_busy_share"],
           "index_bytes_on_card":
               sess.catalog.index_cache.stats()["used"],
           **ms_stats(secs)}
    out["seconds"] = time.perf_counter() - t_sub
    log(f"[14a] hnsw over {n}x{d}: create index {build_s:.2f}s (native, "
        f"M {HNSW_M}, ef_construction {HNSW_EF_CONSTRUCTION}); "
        f"{nq} statements p50 {out['ms_p50']:.2f} ms p99 "
        f"{out['ms_p99']:.2f} ms, busy {prof['device_busy_share']:.1%}; "
        f"candidates the walk's, rows the f64 re-rank; recall@20 "
        f"{recall:.4f}; 14a {out['seconds']:.1f}s")
    sess.execute("drop table hitems")
    return out


def ft_corpus(n_docs: int, seed: int) -> tuple:
    """n_docs documents of FT_DOC_TOKENS tokens drawn Zipf(FT_ZIPF) from
    a vocabulary of FT_VOCAB lowercase words made from `seed` -> (texts,
    words by rank)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = {}
    while len(words) < FT_VOCAB:
        w = "".join(rng.choice(letters, int(rng.integers(3, 11))))
        words.setdefault(w, None)
    words = list(words)
    p = 1.0 / np.arange(1, FT_VOCAB + 1) ** FT_ZIPF
    lens = rng.integers(FT_DOC_TOKENS[0], FT_DOC_TOKENS[1] + 1, n_docs)
    draws = rng.choice(FT_VOCAB, int(lens.sum()), p=p / p.sum())
    cuts = np.cumsum(lens)[:-1]
    vocab = np.asarray(words, dtype=object)
    texts = [" ".join(chunk) for chunk in np.split(vocab[draws], cuts)]
    return texts, words


def ft_queries(words: list, seed: int) -> list:
    rng = np.random.default_rng(seed + 14)
    lo, hi = FT_TERM_RANKS
    return [" ".join(words[r - 1] for r in
                     rng.integers(lo, hi + 1, int(rng.integers(1, 4))))
            for _ in range(SEARCH_QUERIES)]


def match_sql(query: str, k: int = FT_K) -> str:
    return (f"select id, match(body) against ('{query}') sc from docs "
            f"order by sc desc limit {k}")


def bm25_oracle(host: dict, query: str) -> np.ndarray:
    """f64 BM25 scores of every document over the index's own arrays
    (host copies), the terms summed in query order."""
    from matrixone_tpu_torch import fulltext as FT
    s = np.zeros(host["n_docs"])
    k1 = host["k1"]
    for t in FT.tokenize(query):
        tid = host["vocab"].get(t)
        if tid is None:
            continue
        a, b = host["term_offsets"][tid], host["term_offsets"][tid + 1]
        docs = host["doc_idx"][a:b]
        tf = host["tf"][a:b].astype(np.float64)
        s[docs] += float(host["idf"][tid]) * tf * (k1 + 1.0) / (
            tf + host["doc_norm"][docs].astype(np.float64))
    return s


def ft_host(index) -> dict:
    return {"doc_idx": index.doc_idx.cpu().numpy(),
            "tf": index.tf.cpu().numpy(),
            "term_offsets": index.term_offsets,
            "idf": index.idf.cpu().numpy(),
            "doc_norm": index.doc_norm.cpu().numpy(),
            "vocab": index.vocab, "n_docs": index.n_docs, "k1": index.k1}


def ft_rows_check(label: str, rows, scores: np.ndarray, gid_to_id,
                  k: int = FT_K, rtol: float = 1e-5) -> int:
    """A MATCH statement's rows against the oracle's top k (ties to the
    lower position): the same ids, but where the two rows' oracle scores
    lie within rtol of the oracle's score at that rank (a near-tie the
    card's f32 sums may break either way); every score within rtol of
    the oracle's -> the number of such swaps."""
    order = np.argsort(-scores, kind="stable")[:k]
    want_ids = gid_to_id(order)
    got_ids = np.array([r[0] for r in rows], np.int64)
    got_sc = np.array([r[1] for r in rows], np.float64)
    if len(rows) != min(k, len(scores)):
        raise AssertionError(f"{label}: {len(rows)} rows")
    by_id = dict(zip(gid_to_id(np.arange(len(scores))).tolist(),
                     scores.tolist()))
    swaps = 0
    for j, (g, w) in enumerate(zip(got_ids.tolist(), want_ids.tolist())):
        ref = scores[order[j]]
        if g != w:
            swaps += 1
            if not (abs(by_id[g] - ref) <= rtol * abs(ref)
                    and abs(by_id[w] - ref) <= rtol * abs(ref)):
                raise AssertionError(
                    f"{label}: rank {j} holds id {g}, the oracle {w}")
        if abs(got_sc[j] - by_id[g]) > rtol * abs(by_id[g]):
            raise AssertionError(f"{label}: id {g} scored {got_sc[j]}, "
                                 f"the oracle {by_id[g]}")
    return swaps


class StageTimer:
    """Sums the seconds spent in named module functions while in scope
    (the full-text build's stages)."""

    def __init__(self, targets):
        self.targets = targets          # [(owner, attribute name)]
        self.seconds = {}

    def __enter__(self):
        self._saved = []
        for owner, name in self.targets:
            real = getattr(owner, name)
            self._saved.append((owner, name, real))
            setattr(owner, name, self._wrap(name, real))
        return self

    def _wrap(self, name, real):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for owner, name, real in self._saved:
            setattr(owner, name, real)
        return False


def create_fulltext(torch, session, sql: str) -> dict:
    """CREATE INDEX ... USING fulltext, timed by stage: the host read of
    the texts, tokenizing, the CSR arrays, the upload."""
    import gc

    from matrixone_tpu_torch import fulltext as FT
    from matrixone_tpu_torch.storage import engine as E
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    with StageTimer([(E.MVCCTable, "read_texts"), (FT, "tokenize"),
                     (FT, "build_arrays"), (FT, "from_arrays")]) as st:
        t0 = time.perf_counter()
        session.execute(sql)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    sec = st.seconds
    return {"build_seconds": total, "read_texts_seconds": sec["read_texts"],
            "tokenize_seconds": sec["tokenize"],
            "csr_seconds": sec["build_arrays"] - sec["tokenize"],
            "upload_seconds": sec["from_arrays"],
            "device_bytes_allocated": torch.cuda.memory_allocated() - mem0}


def phase_fulltext_sql(torch, CK, args, dev: str) -> tuple:
    """14b and 14c: a FULLTEXT index through SQL, BM25 on the card, and
    its upkeep -> (14b report, 14c report)."""
    import gc

    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.vectorindex.cache import index_nbytes

    t_sub = time.perf_counter()
    n = FT_DOCS
    t0 = time.perf_counter()
    texts, words = ft_corpus(n, args.seed)
    corpus_s = time.perf_counter() - t0
    sess = Session(device=dev)
    eng = sess.catalog
    sess.execute("create table docs (id bigint primary key, body text)")
    t0 = time.perf_counter()
    eng.get_table("docs").insert_numpy(
        {"id": np.arange(n, dtype=np.int64)},
        strings={"body": (np.arange(n), texts)})
    load_s = time.perf_counter() - t0
    build = create_fulltext(torch, sess,
                            "create index ft using fulltext on docs (body)")
    ix = eng.indexes["ft"]
    index = ix.index_obj
    nbytes = index_nbytes(index)
    if index.doc_idx.device.type != dev or \
            not np.array_equal(ix.options["_row_gids"], np.arange(n)):
        raise AssertionError("14b: the postings are not on the card, or "
                             "the row ids are not the positions")
    host = ft_host(index)
    qs = ft_queries(words, args.seed)
    plan = sess.execute("explain " + match_sql(qs[0])).text
    if "FulltextTopK" not in plan or "Scan" in plan:
        raise AssertionError(f"14b: the plan is not a FulltextTopK:\n{plan}")
    CK.LAUNCHES.reset()
    rows, secs = timed_statements(torch, sess, [match_sql(q) for q in qs])
    launches = kernel_launches(CK, "14b_fulltext_sql", ALL_KERNELS)
    t0 = time.perf_counter()
    swaps = sum(ft_rows_check(f"14b query {i}", r, bm25_oracle(host, q),
                              lambda pos: pos)
                for i, (q, r) in enumerate(zip(qs, rows)))
    check_s = time.perf_counter() - t0
    prof = profile_run(torch, lambda: timed_statements(
        torch, sess, [match_sql(q) for q in qs[:8]]), "14b, 8 statements")
    b = {"docs": n, "vocabulary": len(index.vocab),
         "postings": int(host["term_offsets"][-1]), "plan": plan,
         "corpus_seconds": corpus_s, "load_seconds": load_s, **build,
         "index_bytes": nbytes, "launches": launches,
         "near_tie_swaps": swaps, "check_seconds": check_s,
         "profile": prof, "device_busy_share": prof["device_busy_share"],
         "queries": qs[:4], **ms_stats(secs)}
    b["seconds"] = time.perf_counter() - t_sub
    log(f"[14b] fulltext over {n} documents ({b['postings']} postings, "
        f"{b['vocabulary']} terms): create index {build['build_seconds']:.2f}s "
        f"(read {build['read_texts_seconds']:.2f}s, tokenize "
        f"{build['tokenize_seconds']:.2f}s, CSR {build['csr_seconds']:.2f}s, "
        f"upload {build['upload_seconds']:.3f}s), {nbytes / 1e6:.1f} MB on "
        f"the card; {len(qs)} statements p50 {b['ms_p50']:.2f} ms p99 "
        f"{b['ms_p99']:.2f} ms, busy {prof['device_busy_share']:.1%}; rows "
        f"the f64 oracle's ({swaps} near-tie swaps); 14b "
        f"{b['seconds']:.1f}s")

    # 14c: upkeep
    t_sub = time.perf_counter()
    c = {}
    rng = np.random.default_rng(args.seed + 15)
    new_texts = []
    for _ in range(FT_NEW_DOCS):
        toks = list(rng.choice(words[:2000], int(rng.integers(40, 121))))
        toks.insert(int(rng.integers(0, len(toks))), FT_NEW_TERM)
        new_texts.append(" ".join(toks))
    t0 = time.perf_counter()
    sess.execute("insert into docs values " + ", ".join(
        f"({n + i}, '{t}')" for i, t in enumerate(new_texts)))
    c["insert_seconds"] = time.perf_counter() - t0
    new_ids = set(range(n, n + FT_NEW_DOCS))
    CK.LAUNCHES.reset()
    t0 = time.perf_counter()
    got = sess.execute(match_sql(FT_NEW_TERM)).rows()
    torch.cuda.synchronize()
    c["rebuild_statement_seconds"] = time.perf_counter() - t0
    c["launches"] = kernel_launches(CK, "14c_fulltext_upkeep", ALL_KERNELS)
    rebuilt = ix.index_obj
    if rebuilt is index or not {r[0] for r in got} <= new_ids \
            or not all(r[1] > 0 for r in got):
        raise AssertionError("14c: the inserted documents were not found "
                             "by a rebuilt index")
    ft_rows_check("14c new term", got,
                  bm25_oracle(ft_host(rebuilt), FT_NEW_TERM),
                  lambda pos: np.asarray(ix.options["_row_gids"])[pos])
    del index, rebuilt
    # deleted, then evicted under a small budget: one rebuild serves both
    # checks (the next statement's), not one each
    sess.execute(f"delete from docs where id >= {n}")
    idx_bytes = index_nbytes(ix.index_obj)
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    budget = eng.index_cache.budget
    eng.index_cache.budget = 1
    sess.execute("create table small (id bigint, body text)")
    sess.execute("insert into small values (1, 'a b'), (2, 'b c')")
    sess.execute("create index fs using fulltext on small (body)")
    eng.index_cache.budget = budget
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    c.update(index_bytes=idx_bytes, memory_before_eviction=mem0,
             memory_after_eviction=mem1,
             evictions=eng.index_cache.stats()["evictions"])
    if ix.index_obj is not None or not ix.dirty \
            or mem0 - mem1 < 0.9 * idx_bytes:
        raise AssertionError(f"14c: eviction freed {mem0 - mem1} B of a "
                             f"{idx_bytes} B index")
    t0 = time.perf_counter()
    got = sess.execute(match_sql(qs[0])).rows()
    torch.cuda.synchronize()
    c["rebuild_after_eviction_seconds"] = time.perf_counter() - t0
    if ix.index_obj is None or [r[0] for r in got] != \
            [r[0] for r in rows[0]]:
        raise AssertionError("14c: the evicted index was not rebuilt to "
                             "the same answer")
    t0 = time.perf_counter()
    got = sess.execute(match_sql(FT_NEW_TERM)).rows()
    torch.cuda.synchronize()
    c["after_delete_statement_seconds"] = time.perf_counter() - t0
    if {r[0] for r in got} & new_ids or any(r[1] != 0 for r in got):
        raise AssertionError("14c: deleted documents are still found")
    c["seconds"] = time.perf_counter() - t_sub
    log(f"[14c] {FT_NEW_DOCS} documents with a new term inserted "
        f"({c['insert_seconds']:.2f}s) found by the lazy rebuild "
        f"({c['rebuild_statement_seconds']:.2f}s with the statement); "
        f"deleted, then evicted: freed {(mem0 - mem1) / 1e6:.1f} of "
        f"{idx_bytes / 1e6:.1f} MB, rebuilt by the next statement "
        f"({c['rebuild_after_eviction_seconds']:.2f}s), the deleted "
        f"gone ({c['after_delete_statement_seconds']:.2f}s); 14c "
        f"{c['seconds']:.1f}s")
    sess.execute("drop table small")
    sess.execute("drop table docs")
    return b, c


def stub_embedding(text: str, dim: int) -> list:
    """The loopback endpoint's vector for a text: f32 values drawn from
    the text's CRC."""
    import zlib
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    return rng.standard_normal(dim).astype(np.float32).tolist()


def embed_endpoint():
    """A loopback embedding endpoint served from a thread -> (server,
    url, calls)."""
    import http.server

    calls = []
    lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):     # noqa: N802
            pass

        def do_POST(self):             # noqa: N802
            req = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            with lock:
                calls.append(req["text"])
            body = json.dumps({"embedding": stub_embedding(
                req["text"], int(req["dim"]))}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/embed", calls


def phase_llm_embed(torch, CK, args, dev: str) -> dict:
    """14d: llm_embed over a dictionary column, one call per distinct
    text, the vectors gathered on the card."""
    from matrixone_tpu_torch.frontend import Session
    t_sub = time.perf_counter()
    srv, url, calls = embed_endpoint()
    try:
        texts = [f"embedding text {i:03d} " + "lorem " * (i % 9)
                 for i in range(LLM_TEXTS)]
        rng = np.random.default_rng(args.seed + 16)
        codes = rng.integers(0, LLM_TEXTS, LLM_ROWS)
        codes[:LLM_TEXTS] = np.arange(LLM_TEXTS)
        sess = Session(device=dev)
        sess.execute(f"set llm_endpoint = '{url}'")
        sess.execute(f"set llm_embed_dim = {LLM_DIM}")
        sess.execute("create table llm (id bigint primary key, "
                     "txt varchar(80))")
        sess.catalog.get_table("llm").insert_numpy(
            {"id": np.arange(LLM_ROWS, dtype=np.int64)},
            strings={"txt": (codes, texts)})
        CK.LAUNCHES.reset()
        t0 = time.perf_counter()
        rows = sess.execute("select id, llm_embed(txt) e from llm").rows()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernel_launches(CK, "14d_llm_embed", ALL_KERNELS)
        if len(calls) != LLM_TEXTS or sorted(calls) != sorted(texts):
            raise AssertionError(f"14d: {len(calls)} endpoint calls for "
                                 f"{LLM_TEXTS} distinct texts")
        want = np.asarray([stub_embedding(t, LLM_DIM) for t in texts],
                          np.float32)
        ids = np.array([r[0] for r in rows], np.int64)
        got = np.asarray([r[1] for r in rows], np.float32)
        if len(rows) != LLM_ROWS or not np.array_equal(got,
                                                       want[codes[ids]]):
            raise AssertionError("14d: a row's vector is not the "
                                 "endpoint's for its text")
        sess.execute("drop table llm")
    finally:
        srv.shutdown()
        srv.server_close()
    out = {"rows": LLM_ROWS, "distinct_texts": LLM_TEXTS, "dim": LLM_DIM,
           "endpoint_calls": len(calls), "statement_seconds": secs,
           "launches": launches, "seconds": time.perf_counter() - t_sub}
    log(f"[14d] llm_embed over {LLM_ROWS} rows of {LLM_TEXTS} texts: "
        f"{len(calls)} endpoint calls, every row the endpoint's vector; "
        f"the statement {secs:.2f}s; 14d {out['seconds']:.1f}s")
    return out


def phase_search_sql(torch, CK, args, dev: str = "cuda") -> dict:
    """Phase 14: HNSW, full text and llm_embed through SQL."""
    t_phase = time.perf_counter()
    report = {"14a": phase_hnsw_sql(torch, CK, args, dev)}
    report["14b"], report["14c"] = phase_fulltext_sql(torch, CK, args, dev)
    report["14d"] = phase_llm_embed(torch, CK, args, dev)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[14] phase 14 took {report['seconds']:.1f}s")
    return report


# ------------------------------------------------ phase 15: ingest

#: the join phase 15 runs over the loaded tables, and over the external
#: orders table in place of the loaded one
INGEST_JOIN_SQL = ("select c_mktsegment, count(*), sum(o_totalprice) "
                   "from customer, {orders} where c_custkey = o_custkey "
                   "group by c_mktsegment order by c_mktsegment")
INGEST_TABLES = ("customer", "orders")
INGEST_NOTE = "note.txt"
INGEST_NOTE_TEXT = "phase 15: a stage, LOAD DATA and an external table\n"


def _csv_fields(values, dtype) -> list:
    """One column's CSV fields: DECIMAL with its scale's places, DATE in
    ISO form, text quoted (RFC 4180) where it holds a comma or a quote."""
    from matrixone_tpu_torch.container.dtypes import TypeOid
    if dtype.is_varlen:
        return [('"' + v.replace('"', '""') + '"')
                if ("," in v or '"' in v) else v
                for v in map(str, values.tolist())]
    v = np.asarray(values).astype(np.int64)
    if dtype.oid == TypeOid.DECIMAL64:
        q = 10 ** dtype.scale
        a = np.abs(v)
        whole = np.char.add(np.where(v < 0, "-", ""), (a // q).astype(str))
        frac = np.char.zfill((a % q).astype(str), dtype.scale)
        return np.char.add(np.char.add(whole, "."), frac).tolist()
    if dtype.oid == TypeOid.DATE:
        return np.datetime_as_string(v.astype("datetime64[D]")).tolist()
    return v.astype(str).tolist()


def write_tpch_csv(path: str, name: str, arrays) -> int:
    """One table of `tpch_full`'s generator as a CSV file with a header,
    in its schema's column order; -> the file's bytes."""
    from matrixone_tpu_torch.utils import tpch_full
    schema = tpch_full._SCHEMAS[name]
    cols = [_csv_fields(arrays[c], d) for c, d in schema]
    text = ",".join(c for c, _ in schema) + "\n" + "\n".join(
        map(",".join, zip(*cols))) + "\n"
    blob = text.encode()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def _table_ddl(name: str, table: str) -> str:
    from matrixone_tpu_torch.utils import tpch_full
    cols = ", ".join(f"{c} {d}" for c, d in tpch_full._SCHEMAS[name])
    return (f"create table {table} ({cols}, primary key "
            f"({', '.join(tpch_full._PKS[name])}))")


def ingest_ddl(dirpath: str) -> list:
    """Phase 15's statements over CSV files in `dirpath`: the stage, the
    two tables, a LOAD DATA of each, and the external orders table."""
    from matrixone_tpu_torch.utils import tpch_full
    out = [f"create stage tpch url = 'file://{dirpath}'"]
    out += [_table_ddl(t, t) for t in INGEST_TABLES]
    out += [f"load data infile 'stage://tpch/{t}.csv' into table {t}"
            for t in INGEST_TABLES]
    cols = ", ".join(f"{c} {d}" for c, d in tpch_full._SCHEMAS["orders"])
    out.append(f"create external table orders_x ({cols}) location "
               f"'stage://tpch/orders.csv'")
    return out


def ingest_oracle(customer, orders) -> list:
    """INGEST_JOIN_SQL's rows from the generator's arrays: (segment,
    orders, o_totalprice in cents), by segment; custkeys are 1..n."""
    seg = np.asarray(customer["c_mktsegment"], dtype=object)[
        np.asarray(orders["o_custkey"], np.int64) - 1]
    names, inv = np.unique(seg.astype(str), return_inverse=True)
    counts = np.bincount(inv, minlength=len(names))
    cents = np.zeros(len(names), np.int64)
    np.add.at(cents, inv, np.asarray(orders["o_totalprice"], np.int64))
    return [(str(n), int(c), int(s)) for n, c, s in
            zip(names, counts, cents)]


def ingest_rows_check(want, label: str):
    """The join's rows exact to `ingest_oracle`: the sum as the result's
    scaled int64."""
    def check(rows, batch):
        cols = list(batch.columns)
        sums = np.asarray(batch.columns[cols[2]].data, np.int64)
        got = [(r[0], int(r[1]), int(s)) for r, s in zip(rows, sums)]
        if got != want:
            raise AssertionError(f"{label}: {got} != the oracle's {want}")
    return check


def readback_check(table, arrays, label: str) -> None:
    """Every column of `table`, read back through the engine's scan,
    equal to the generator's arrays: int64, DECIMAL's scaled int64, DATE
    days and strings."""
    names = [c for c, _ in table.meta.schema]
    got = {c: [] for c in names}
    for chunk, validity, dicts, _n in table.iter_chunks(names, 1 << 22):
        for c in names:
            if not validity[c].all():
                raise AssertionError(f"{label}: NULLs in {c}")
            a = np.asarray(chunk[c])
            got[c].append(np.asarray(dicts[c], dtype=object)[a]
                          if c in dicts else a)
    for c, d in table.meta.schema:
        g = np.concatenate(got[c])
        w = np.asarray(arrays[c])
        same = (np.array_equal(g.astype(str), w.astype(str))
                if d.is_varlen else
                np.array_equal(g.astype(np.int64), w.astype(np.int64)))
        if not same:
            raise AssertionError(f"{label}: column {c} differs from the "
                                 f"generator's array")


def ingest_query(torch, CK, TK, label: str, session, sql: str, check,
                 warm_runs: int = 3) -> tuple:
    """A query's cold run (graphs captured under the spy), a counted warm
    run (sorted-search launches by shape, inputs captured; it captures
    no graph), the best of `warm_runs` warm runs and one profiled run,
    every run checked.  -> (record, captured inputs, graph spy)."""
    with PathInputs(torch, TK, "graphs") as spy:
        rows, batch, cold_s = run_sql(torch, session, sql)
        check(rows, batch)
        CK.LAUNCHES.reset()
        f0 = fusion_counts()
        with PathInputs(torch, TK) as cap:
            rows, batch, counted_s = run_sql(torch, session, sql)
        warm = counts_since(f0)
        launches = kernel_launches(CK, label, ALL_KERNELS,
                                   required=("sorted_search",))
        check(rows, batch)
        if warm["captures"]:
            raise AssertionError(f"{label}: the warm run captured graphs: "
                                 f"{warm}")
        warm_s = []
        for _ in range(warm_runs):
            r, b, w = run_sql(torch, session, sql)
            check(r, b)
            warm_s.append(w)
    prof = profile_run(torch, lambda: session.execute(sql), label)
    out = {"cold_seconds": cold_s, "counted_seconds": counted_s,
           "warm_seconds": warm_s, "warm_best_seconds": min(warm_s),
           "warm_fusion": warm, "launches": launches,
           "device_busy_share": prof["device_busy_share"], "profile": prof}
    log(f"[{label}] cold {cold_s:.3f}s warm {['%.4f' % w for w in warm_s]}"
        f"; warm run {warm['replays']:.0f} replays, {warm['captures']:.0f} "
        f"captures; busy {prof['device_busy_share']:.1%}")
    return out, cap, spy


def phase_ingest(torch, CK, args, tables=None, dev: str = "cuda") -> tuple:
    """Phase 15: TPC-H's bulk load procedure for customer and orders at
    SF1 (`tables`: phase 10's arrays, else generated here) through CSV
    files, a stage and LOAD DATA into a durable LocalFS engine; the join
    on the card over the loaded and the external table; a reopen; a
    rolled-back load; `load_file`, the scrape text and the trace smoke.
    -> (report, sorted-search rows)."""
    import gc
    import shutil
    import tempfile

    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage import csvread
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.storage.external import ExternalError
    from matrixone_tpu_torch.storage.fileservice import LocalFS
    from matrixone_tpu_torch.tools import moscrape, motrace as trace_smoke
    from matrixone_tpu_torch.txn.client import TxnHandle
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch_full

    t_phase = time.perf_counter()
    if tables is None:
        gen = tpch_full.gen_tpch(sf=1.0, seed=args.seed)
        tables = {t: gen[t] for t in INGEST_TABLES}
        del gen
    root = tempfile.mkdtemp(prefix="mo_ingest_")
    files, data_dir = os.path.join(root, "files"), os.path.join(root, "data")
    os.makedirs(files)
    report = {}
    try:
        # 15a: the flat files
        t0 = time.perf_counter()
        nbytes = {t: write_tpch_csv(os.path.join(files, f"{t}.csv"), t,
                                    tables[t]) for t in INGEST_TABLES}
        with open(os.path.join(files, INGEST_NOTE), "w") as f:
            f.write(INGEST_NOTE_TEXT)
        n_rows = {t: len(tables[t][tpch_full._SCHEMAS[t][0][0]])
                  for t in INGEST_TABLES}
        report["15a_files"] = {"bytes": nbytes, "rows": n_rows,
                               "seconds": time.perf_counter() - t0}
        log(f"[15a] wrote {nbytes} B of CSV ({n_rows} rows) in "
            f"{report['15a_files']['seconds']:.1f}s")

        # 15b: the stage, the tables and a LOAD DATA of each
        eng = Engine(fs=LocalFS(data_dir))
        sess = Session(catalog=eng, device=dev)
        ddl = ingest_ddl(files)
        for st in ddl[:1 + len(INGEST_TABLES)]:
            sess.execute(st)
        loads = {}
        for t, sql in zip(INGEST_TABLES, ddl[1 + len(INGEST_TABLES):]):
            with StageTimer([(csvread, "read_csv"),
                             (TxnHandle, "commit")]) as st:
                t0 = time.perf_counter()
                res = sess.execute(sql)
                total = time.perf_counter() - t0
            if res.affected != n_rows[t]:
                raise AssertionError(f"15b {t}: LOAD DATA affected "
                                     f"{res.affected}, not {n_rows[t]}")
            readback_check(eng.get_table(t), tables[t], f"15b {t}")
            sec = st.seconds
            mb = nbytes[t] / 1e6
            loads[t] = {"seconds": total, "parse_seconds": sec["read_csv"],
                        "commit_seconds": sec["commit"],
                        "ingest_seconds": total - sec["read_csv"]
                        - sec["commit"],
                        "mb_per_s": mb / total,
                        "parse_mb_per_s": mb / sec["read_csv"],
                        "rows_per_s": n_rows[t] / total}
            log(f"[15b] load data {t}: {n_rows[t]} rows, {mb:.1f} MB in "
                f"{total:.2f}s (parse {sec['read_csv']:.2f}s, ingest "
                f"{loads[t]['ingest_seconds']:.2f}s, commit "
                f"{sec['commit']:.2f}s): {loads[t]['mb_per_s']:.1f} MB/s, "
                f"{loads[t]['rows_per_s']:.0f} rows/s; every column equal "
                f"to the generator's")
        report["15b_load"] = loads

        # 15c: the join on the card over the loaded tables
        want = ingest_oracle(tables["customer"], tables["orders"])
        sql = INGEST_JOIN_SQL.format(orders="orders")
        rec, cap, spy = ingest_query(
            torch, CK, TK, "15c join loaded", sess, sql,
            ingest_rows_check(want, "15c"))
        search_rows = check_spill_search(torch, CK, "15c_join_loaded", rec,
                                         cap, spy.seen)
        report["15c_join_loaded"] = rec

        # 15d: the same join over the external orders table
        sess.execute(ddl[-1])
        p0 = M.external_parses.get(table="orders_x")
        rec, cap, spy = ingest_query(
            torch, CK, TK, "15d join external", sess,
            INGEST_JOIN_SQL.format(orders="orders_x"),
            ingest_rows_check(want, "15d"))
        rec["parses"] = M.external_parses.get(table="orders_x") - p0
        p1 = M.external_parses.get(table="orders_x")
        warm2 = run_sql(torch, sess, INGEST_JOIN_SQL.format(
            orders="orders_x"))[2]
        if M.external_parses.get(table="orders_x") != p1 \
                or rec["parses"] != 1:
            raise AssertionError(f"15d: the external file was parsed "
                                 f"{rec['parses']} times over the cold and "
                                 f"warm runs, and again after them: the "
                                 f"decoded-chunk cache did not serve them")
        rec["cached_run_seconds"] = warm2
        try:
            sess.execute("insert into orders_x values (0, 1, 'O', 1.00, "
                         "'1995-01-01', '1-URGENT', 'Clerk#1', 0, 'x')")
            raise AssertionError("15d: an INSERT into the external table "
                                 "was accepted")
        except ExternalError:
            pass
        search_rows += check_spill_search(torch, CK, "15d_join_external",
                                          rec, cap, spy.seen)
        report["15d_join_external"] = rec
        log(f"[15d] external orders: cold {rec['cold_seconds']:.3f}s (one "
            f"parse), warm best {rec['warm_best_seconds']:.4f}s from the "
            f"decoded-chunk cache; the INSERT refused")

        # 15e: a reopen of the data directory
        total_cents = int(np.asarray(tables["orders"]["o_totalprice"],
                                     np.int64).sum())
        sess.close()
        del sess, eng
        gc.collect()
        t0 = time.perf_counter()
        eng = Engine.open(LocalFS(data_dir))
        reopen_s = time.perf_counter() - t0
        sess = Session(catalog=eng, device=dev)
        stages = sess.execute("show stages").rows()
        if stages != [("tpch", f"file://{files}")]:
            raise AssertionError(f"15e: show stages gave {stages}")
        res = sess.execute("select count(*), sum(o_totalprice) from orders")
        got = (res.rows()[0][0], int(np.asarray(
            res.batch.columns[list(res.batch.columns)[1]].data)[0]))
        if got != (n_rows["orders"], total_cents):
            raise AssertionError(f"15e: orders after the reopen {got} != "
                                 f"{(n_rows['orders'], total_cents)}")
        x = sess.execute("select count(*) from orders_x").rows()
        if x != [(n_rows["orders"],)]:
            raise AssertionError(f"15e: orders_x after the reopen: {x}")
        report["15e_reopen"] = {"seconds": reopen_s,
                                "recovery": eng.recovery_summary}
        log(f"[15e] Engine.open in {reopen_s:.2f}s "
            f"({eng.recovery_summary}): the stage, orders_x and orders' "
            f"count and sum as loaded")

        # 15f: a rolled-back LOAD
        sess.execute(_table_ddl("customer", "customer_copy"))
        sess.execute("begin")
        n = sess.execute("load data infile 'stage://tpch/customer.csv' "
                         "into table customer_copy").affected
        sess.execute("rollback")
        left = sess.execute("select count(*) from customer_copy").rows()
        if n != n_rows["customer"] or left != [(0,)]:
            raise AssertionError(f"15f: the rolled-back load left {left}")
        report["15f_rollback"] = {"loaded": n, "after_rollback": 0}

        # 15g: load_file, the scrape text and the trace smoke
        txt = sess.execute(f"select load_file('stage://tpch/{INGEST_NOTE}')"
                           ).rows()
        if txt != [(INGEST_NOTE_TEXT,)]:
            raise AssertionError(f"15g: load_file gave {txt}")
        scrape = moscrape.render_text()
        if "mo_query_duration_seconds" not in scrape:
            raise AssertionError("15g: the scrape text lacks "
                                 "mo_query_duration_seconds")
        smoke = trace_smoke.run_smoke(device=dev)
        if not smoke["ok"]:
            raise AssertionError(f"15g: the trace smoke failed: "
                                 f"{smoke['errors']}")
        report["15g_ops"] = {"scrape_bytes": len(scrape),
                             "trace_smoke": smoke}
        sess.close()
        del sess, eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[15] phase 15 took {report['seconds']:.1f}s")
    return report, search_rows


# ----------------------------------- phase 16: views, UDFs and the canary

MV_V_SQL = ("select grp, count(*) n, sum(xn) sx, min(xn) lo, max(xn) hi "
            "from v group by grp")
V_FRESH_SQL = ("select grp, count(*), sum(xn), min(xn), max(xn) from v "
               "group by grp order by grp")
MV_UPDATE_SQL = "update v set xn = xn + 1 where grp = 7"
MV_DELETE_SQL = "delete from v where grp = 9"
#: 16b: single-row commits into v (with the view) and into v_copy
#: (without one); every MV_CHECK_EVERY-th is followed by a view check
MV_SINGLE_COMMITS = 200
MV_CHECK_EVERY = 50
UDF_JIT_BODY = ("jnp.where(x > 0, 1.0 / (1.0 + jnp.exp(-x)), "
                "jnp.exp(x) / (1.0 + jnp.exp(x)))")
UDF_ROW_BODY = "if x > 0.0:\n    return x * 2.0\nreturn -x"
UDF_ROW_LIMIT = 20000


def udf_jit_oracle(x: np.ndarray) -> np.ndarray:
    """UDF_JIT_BODY run by numpy in f64 on the host."""
    x = x.astype(np.float64)
    with np.errstate(over="ignore"):
        return np.where(x > 0, 1.0 / (1.0 + np.exp(-x)),
                        np.exp(x) / (1.0 + np.exp(x)))


def load_phase16_tables(eng, lineitem, q3data, v,
                        v_tables=("v", "v_copy")) -> dict:
    """Phase 5's generator arrays into `eng`: lineitem, customer and
    orders with `utils/tpch`'s schemas, and v with 5c's under each name
    of `v_tables` (phase 16's v_copy: the same rows, no view) -> seconds
    per table."""
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.storage.engine import TableMeta
    from matrixone_tpu_torch.utils import tpch
    out = {}
    t0 = time.perf_counter()
    eng.create_table(TableMeta("lineitem", tpch.LINEITEM_SCHEMA,
                               ["l_orderkey", "l_linenumber"]))
    eng.get_table("lineitem").insert_numpy(
        lineitem, strings={
            "l_returnflag": (lineitem["l_returnflag"], tpch.FLAG_CATS),
            "l_linestatus": (lineitem["l_linestatus"], tpch.STATUS_CATS)})
    out["lineitem"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = q3data["seg_codes"]
    eng.create_table(TableMeta("customer", tpch.CUSTOMER_SCHEMA,
                               ["c_custkey"]))
    eng.get_table("customer").insert_numpy(
        {"c_custkey": np.arange(1, len(seg) + 1, dtype=np.int64)},
        strings={"c_mktsegment": (seg, tpch.SEGMENTS)})
    eng.create_table(TableMeta("orders", tpch.ORDERS_SCHEMA, ["o_orderkey"]))
    eng.get_table("orders").insert_numpy(q3data["orders"])
    out["customer_orders"] = time.perf_counter() - t0
    schema = [("id", dt.INT64), ("grp", dt.INT64), ("xi", dt.FLOAT32),
              ("xn", dt.FLOAT32)]
    for name in v_tables:
        t0 = time.perf_counter()
        eng.create_table(TableMeta(name, schema, ["id"]))
        eng.get_table(name).insert_numpy(v)
        out[name] = time.perf_counter() - t0
    return out


def q1_oracle_int64(a) -> dict:
    """`tpch.q1_oracle` computed in int64 arrays instead of Python ints
    (the same dict): at SF1 a row's charge is below 1.2e11 and a group's
    sum below 7e17, inside int64."""
    from matrixone_tpu_torch.utils import tpch
    sel = a["l_shipdate"] <= tpch._days(1998, 12, 1) - 90
    key = a["l_returnflag"][sel].astype(np.int64) * 2 \
        + a["l_linestatus"][sel]
    q, p, d, t = (a[c][sel].astype(np.int64) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = p * (100 - d)
    charge = disc_price * (100 + t)
    out = {}
    for k in np.unique(key):
        m = key == k
        n = int(m.sum())
        sq, sp, sd = int(q[m].sum()), int(p[m].sum()), int(d[m].sum())
        out[(tpch.FLAG_CATS[k // 2], tpch.STATUS_CATS[k % 2])] = {
            "sum_qty": sq, "sum_base_price": sp,
            "sum_disc_price": int(disc_price[m].sum()),
            "sum_charge": int(charge[m].sum()),
            "avg_qty": sq / n / 100, "avg_price": sp / n / 100,
            "avg_disc": sd / n / 100, "count_order": n}
    return out


def mv_v_oracle_check(session, xn_by_id, by_grp, label: str) -> dict:
    """mv_v against an f64 numpy oracle of v as it now stands (`xn_by_id`
    NaN for a deleted id; `by_grp`: the ids sorted by group and each
    group's first position): counts, min and max exact, the sums within
    rtol 1e-4 / atol 1e-3."""
    order, starts, grp_sorted = by_grp
    res = session.execute("select grp, n, sx, lo, hi from mv_v order by grp")
    c = [np.asarray(res.batch.columns[k].data) for k in res.batch.columns]
    x = xn_by_id[order]
    live = ~np.isnan(x)
    cnt_all = np.bincount(grp_sorted[live], minlength=len(starts))
    keys = np.nonzero(cnt_all)[0]
    cnt = cnt_all[keys]
    s64 = np.bincount(grp_sorted[live], weights=x[live].astype(np.float64),
                      minlength=len(starts))[keys]
    lo = np.fmin.reduceat(x, starts)[keys]       # NaN (deleted) ignored
    hi = np.fmax.reduceat(x, starts)[keys]
    err = np.abs(c[2] - s64) if len(c[2]) == len(s64) else np.inf
    ok = (np.array_equal(c[0], keys) and np.array_equal(c[1], cnt)
          and np.array_equal(c[3], lo.astype(c[3].dtype))
          and np.array_equal(c[4], hi.astype(c[4].dtype))
          and bool((err <= 1e-4 * np.abs(s64) + 1e-3).all()))
    if not ok:
        raise AssertionError(f"{label}: mv_v differs from the f64 numpy "
                             f"oracle of v")
    return {"groups": int(len(keys)), "sum_max_abs_err": float(np.max(err))}


def views_equal_fresh(session, li_oracle, label: str) -> None:
    """Every view equal to its defining SELECT run fresh in the same
    engine: mv_q1's sums and counts exactly (and to `q1_oracle`'s scaled
    int64, averages within q1_exact's bounds), mv_v's counts, min and max
    exactly and its sums within 5c's rtol 1e-4 / atol 1e-3."""
    from matrixone_tpu_torch.utils import tpch
    view = session.execute("select * from mv_q1 order by l_returnflag, "
                           "l_linestatus")
    bad = q1_exact(view.batch, li_oracle)
    fresh = session.execute(tpch.Q1_SQL)
    bad += q1_exact(fresh.batch, li_oracle)
    if bad or [r[:6] + r[9:] for r in view.rows()] != \
            [r[:6] + r[9:] for r in fresh.rows()]:
        raise AssertionError(f"{label}: mv_q1 differs from Q1 run fresh "
                             f"or from q1_oracle: {bad[:4]}")
    got = session.execute("select grp, n, sx, lo, hi from mv_v order by "
                          "grp").rows()
    want = session.execute(V_FRESH_SQL).rows()
    if [(r[0], r[1], r[3], r[4]) for r in got] != \
            [(r[0], r[1], r[3], r[4]) for r in want] \
            or not rows_agree([(r[2],) for r in got],
                              [(r[2],) for r in want]):
        raise AssertionError(f"{label}: mv_v differs from its SELECT run "
                             f"fresh")


def phase_views_udfs(torch, CK, args, arrays) -> tuple:
    """Phase 16: materialized views over TPC-H's refresh functions, UDFs
    over v, and the padding canary, in an in-memory engine of its own
    over phase 5's SF1 generator arrays, with default knobs.
    -> (report, sorted-search rows, segment-sum rows)."""
    import gc

    from matrixone_tpu_torch import mview as MV
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.udf import jnp as ujnp
    from matrixone_tpu_torch.udf.sandbox import compile_body
    from matrixone_tpu_torch.utils import metrics as M, qa, roofline
    from matrixone_tpu_torch.utils import tpch, tpch_full

    lineitem, q3data, v = arrays
    t_phase = time.perf_counter()
    report = {}
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()
    eng = Engine()
    report["16_load_seconds"] = load_phase16_tables(eng, lineitem, q3data, v)
    sess = Session(catalog=eng, device="cuda")
    search_rows, segsum_rows = [], []
    eager0 = M.fusion_dispatch.get(kind="eager")
    tp = part("load", t_phase)

    def apply_s(kind):
        return M.mview_apply_seconds.get(kind=kind)

    # 16a: the views' first computation
    li_oracle = q1_oracle_int64(lineitem)
    t0 = time.perf_counter()
    sess.execute("create materialized view mv_q1 as " + tpch.Q1_SQL)
    q1_init = time.perf_counter() - t0
    CK.LAUNCHES.reset()
    with PathInputs(torch, TK, "every") as cap16a:
        t0 = time.perf_counter()
        sess.execute("create materialized view mv_v as " + MV_V_SQL)
        torch.cuda.synchronize()
        v_init = time.perf_counter() - t0
    launches = kernel_launches(CK, "16a mv_v init", ALL_KERNELS,
                               required=("segment_sum",))
    modes = {r[0]: r[1] for r in
             sess.execute("show materialized views").rows()}
    if modes != {"mv_q1": "incremental", "mv_v": "incremental"}:
        raise AssertionError(f"16a: the views' modes {modes}")
    n_v = len(v["id"])
    xn_by_id = np.concatenate([v["xn"], np.full(MV_SINGLE_COMMITS, np.nan,
                                                 np.float32)])
    grp_by_id = np.concatenate([v["grp"],
                                (n_v + np.arange(MV_SINGLE_COMMITS)) % 1000])
    order = np.argsort(grp_by_id, kind="stable")
    grp_sorted = grp_by_id[order]
    by_grp = (order, np.searchsorted(grp_sorted, np.arange(1000)),
              grp_sorted)
    views_equal_fresh(sess, li_oracle, "16a")
    v_err = mv_v_oracle_check(sess, xn_by_id, by_grp, "16a")
    rows, seg, held = hold_launches(torch, CK, cap16a, "16a_mv_v_init",
                                    launches)
    del cap16a
    search_rows += rows
    segsum_rows += seg
    tp = part("16a", tp)
    report["16a_init"] = {"mv_q1_seconds": q1_init,
                          "mv_v_seconds": v_init, "launches": launches,
                          "held": held, "mv_v_vs_f64": v_err}
    log(f"[16a] mv_q1 (dense tier) initialized in {q1_init:.3f}s, exact "
        f"to q1_oracle; mv_v (general tier) in {v_init:.3f}s, "
        f"{held['segment_sum']} segment-sum launches; mv_v within 5c's "
        f"tolerance of f64 (max err {v_err['sum_max_abs_err']:.3e})")

    # 16b: RF1 and RF2, then the MIN/MAX recompute, then single rows
    li_events = {"n": 0}

    def count_lineitem(_ts, table, _kind, _payload):
        if table == "lineitem":
            li_events["n"] += 1
    eng.subscribe(count_lineitem)
    svc = eng._mview_service
    tables = {"lineitem": lineitem, "orders": q3data["orders"]}
    dense0, d0 = M.mview_apply.get(tier="dense"), dict(svc.dense)
    s0 = apply_s("delta")
    rf1 = tpch_full.rf1(tables, 1.0, seed=args.seed + 16, q3data=q3data)
    rf1_s, _, _ = run_statements(torch, sess, rf1.statements)
    tables = tpch_full.apply_refresh(tables, rf1)
    views_equal_fresh(sess, q1_oracle_int64(tables["lineitem"]), "16b RF1")
    rf2 = tpch_full.rf2(tables, 1.0, seed=args.seed + 17)
    rf2_s, _, _ = run_statements(torch, sess, rf2.statements)
    tables = tpch_full.apply_refresh(tables, rf2)
    li_oracle = q1_oracle_int64(tables["lineitem"])
    views_equal_fresh(sess, li_oracle, "16b RF2")
    dense_n = M.mview_apply.get(tier="dense") - dense0
    steps = {k: svc.dense[k] - d0[k] for k in d0}
    if dense_n != li_events["n"] or dense_n == 0:
        raise AssertionError(f"16b: mo_mview_apply{{tier=dense}} counted "
                             f"{dense_n}, the lineitem deltas "
                             f"{li_events['n']}")
    if steps["steps"] != dense_n or steps["graph_replays"] != dense_n \
            or steps["graph_captures"] > dense_n:
        raise AssertionError(f"16b: the dense deltas {dense_n} made the "
                             f"steps and graph use {steps}: not one replay "
                             f"a delta")
    dense_s = apply_s("delta") - s0
    log(f"[16b] RF1 {rf1_s:.3f}s, RF2 {rf2_s:.3f}s: {dense_n} lineitem "
        f"deltas, each one dense step and ONE graph replay "
        f"({steps['graph_captures']} captures, one a new padded shape); "
        f"dense apply {dense_s:.3f}s; both views equal their SELECTs")
    tp = part("16b_refresh", tp)
    rec0, s0 = M.mview_apply.get(tier="recompute"), apply_s("delta")
    CK.LAUNCHES.reset()
    with PathInputs(torch, TK, "every") as cap16b:
        t0 = time.perf_counter()
        sess.execute(MV_UPDATE_SQL)
        upd_s = time.perf_counter() - t0
        m7 = (grp_by_id == 7) & ~np.isnan(xn_by_id)
        xn_by_id[m7] = xn_by_id[m7] + np.float32(1)
        views_equal_fresh(sess, li_oracle, "16b UPDATE")
        t0 = time.perf_counter()
        sess.execute(MV_DELETE_SQL)
        del_s = time.perf_counter() - t0
        xn_by_id[grp_by_id == 9] = np.nan
        views_equal_fresh(sess, li_oracle, "16b DELETE")
    recompute_launches = kernel_launches(CK, "16b recompute", ALL_KERNELS,
                                         required=("segment_sum",))
    recomputes = M.mview_apply.get(tier="recompute") - rec0
    if recomputes != 2:
        raise AssertionError(f"16b: {recomputes} MIN/MAX recomputes, not 2")
    recompute_s = apply_s("delta") - s0
    v_err = mv_v_oracle_check(sess, xn_by_id, by_grp, "16b")
    tp = part("16b_update_delete", tp)
    rows, seg, held_b = hold_launches(torch, CK, cap16b, "16b_recompute",
                                      recompute_launches)
    del cap16b
    search_rows += rows
    segsum_rows += seg
    single = {}
    for table in ("v", "v_copy"):
        s0, g0 = apply_s("delta"), M.mview_apply.get(tier="general")
        secs = []
        for i in range(MV_SINGLE_COMMITS):
            rid = n_v + i
            x = np.float32((i % 50) * 0.25 - 6.0)
            t0 = time.perf_counter()
            sess.execute(f"insert into {table} values ({rid}, {rid % 1000}, "
                         f"{float(i % 16)}, {float(x)})")
            secs.append(time.perf_counter() - t0)
            if table == "v":
                xn_by_id[rid] = x
                if (i + 1) % MV_CHECK_EVERY == 0:
                    views_equal_fresh(sess, li_oracle,
                                      f"16b commit {i + 1}")
        single[table] = {**ms_stats(secs),
                         "general_apply_seconds": apply_s("delta") - s0,
                         "general_deltas":
                             M.mview_apply.get(tier="general") - g0}
    if single["v"]["general_deltas"] != MV_SINGLE_COMMITS \
            or single["v_copy"]["general_deltas"]:
        raise AssertionError(f"16b: general-tier deltas {single}")
    v_err_end = mv_v_oracle_check(sess, xn_by_id, by_grp, "16b end")
    tp = part("16b_single_rows", tp)
    eager = M.fusion_dispatch.get(kind="eager") - eager0
    if eager:
        raise AssertionError(f"16b: {eager} eager dispatches")
    report["16b_maintenance"] = {
        "rf1_seconds": rf1_s, "rf2_seconds": rf2_s,
        "dense_deltas": dense_n, "dense_graph": steps,
        "dense_apply_seconds": dense_s,
        "update_seconds": upd_s, "delete_seconds": del_s,
        "recompute_apply_seconds": recompute_s,
        "recompute_launches": recompute_launches, "held": held_b,
        "mv_v_vs_f64": v_err, "mv_v_vs_f64_end": v_err_end,
        "single_row_commits": single, "eager_dispatches": eager,
        "status": MV.stats(eng)}
    log(f"[16b] UPDATE {upd_s:.3f}s and DELETE {del_s:.3f}s (MIN/MAX "
        f"recompute, apply {recompute_s:.3f}s, "
        f"{held_b['segment_sum']} segment sums); single-row commit p50/p99 "
        f"with the view {single['v']['ms_p50']:.2f}/"
        f"{single['v']['ms_p99']:.2f} ms, without "
        f"{single['v_copy']['ms_p50']:.2f}/{single['v_copy']['ms_p99']:.2f}"
        f" ms; general apply {single['v']['general_apply_seconds']:.3f}s")

    # 16c: UDFs over v
    live = ~np.isnan(xn_by_id)
    sess.execute("create function vsig(x DOUBLE) returns DOUBLE language "
                 f"python as $$ {UDF_JIT_BODY} $$")
    sess.execute("create function vstep(x DOUBLE) returns DOUBLE language "
                 f"python as $$ {UDF_ROW_BODY} $$")
    sess.execute("create aggregate function p90(x DOUBLE) returns DOUBLE "
                 "language python as $$ jnp.percentile(x, 90.0) $$")
    udf = {}
    t16c = time.perf_counter()
    for name, sql, tier in (
            ("jit", "select id, vsig(xn) from v", "[jit]"),
            ("row", f"select id, vstep(xn) from v where id < "
                    f"{UDF_ROW_LIMIT}", "[row]")):
        fn = "vsig" if name == "jit" else "vstep"
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = sess.execute(sql)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        cols = [np.asarray(res.batch.columns[k].data)
                for k in res.batch.columns]
        ids, got = cols[0], cols[1]
        want_ids = np.nonzero(live)[0]
        if name == "row":
            want_ids = want_ids[want_ids < UDF_ROW_LIMIT]
        x = xn_by_id[ids]
        want = (udf_jit_oracle(x) if name == "jit" else
                np.where(x > 0, x.astype(np.float64) * 2.0,
                         -x.astype(np.float64)))
        rtol = 1e-9 if name == "jit" else 0.0
        if not np.array_equal(np.sort(ids), want_ids) \
                or not np.allclose(got, want, rtol=rtol, atol=0.0):
            raise AssertionError(f"16c: the {name} tier's rows differ from "
                                 f"numpy's f64")
        text = sess.execute("explain " + sql).text
        if f"UdfCall {fn} {tier}" not in text:
            raise AssertionError(f"16c: EXPLAIN does not show UdfCall {fn} "
                                 f"{tier}:\n{text}")
        log(f"[16c] {name} tier checked, {time.perf_counter() - t16c:.2f}s "
            f"into 16c")
        udf[name] = {"rows": int(len(ids)), "seconds": secs,
                     "rows_per_s": len(ids) / min(secs),
                     "max_rel_err": float(np.max(np.abs(got - want)
                                                 / np.maximum(np.abs(want),
                                                              1e-300)))}
    t0 = time.perf_counter()
    (p90,), = sess.execute("select p90(xn) from v").rows()
    agg_s = time.perf_counter() - t0
    want = float(np.percentile(xn_by_id[live].astype(np.float64), 90.0))
    if abs(p90 - want) > 1e-12 * abs(want):
        raise AssertionError(f"16c: p90 {p90} != numpy's {want}")
    udf["aggregate"] = {"rows": int(live.sum()), "seconds": agg_s,
                        "rows_per_s": int(live.sum()) / agg_s,
                        "value": p90, "numpy": want}
    log(f"[16c] the percentile checked, {time.perf_counter() - t16c:.2f}s "
        f"into 16c")
    # the jit tier's body alone on one 1M-row batch: achieved GB/s
    body = compile_body("vsig", UDF_JIT_BODY, ["x"])
    xb = torch.from_numpy(v["xn"][:1 << 20].astype(np.float64)).cuda()

    def call(t):
        with ujnp.on_device("cuda"):
            return body(ujnp.Array(t, traced=True))._t
    body_ms = cuda_time_ms(lambda: call(xb))
    cost = roofline.cost_of(call, xb)
    udf["jit_body_1m"] = {"ms": body_ms, **cost,
                          **roofline.mfu(cost["flops"], cost["bytes"], 1,
                                         body_ms / 1e3, device="cuda")}
    report["16c_udf"] = udf
    tp = part("16c", tp)
    log(f"[16c] UDFs: jit {udf['jit']['rows_per_s']:.0f} rows/s over "
        f"{udf['jit']['rows']} rows (max rel err "
        f"{udf['jit']['max_rel_err']:.2e} of numpy f64), row "
        f"{udf['row']['rows_per_s']:.0f} rows/s, percentile "
        f"{udf['aggregate']['rows_per_s']:.0f} rows/s equal to numpy's; "
        f"the jit body at 1M rows {body_ms:.4f} ms, "
        f"{udf['jit_body_1m'].get('achieved_gbps')} GB/s "
        f"(HBM {udf['jit_body_1m'].get('hbm_util')})")

    # 16d: the padding canary on Q1, Q3 and 5c's GROUP BY, fused
    q3want = tpch.q3_oracle(tables["lineitem"],
                            dict(q3data, orders=tables["orders"]))
    checks = {"q1": lambda rows, b: q1_exact(b, li_oracle),
              "q3": lambda rows, b: [] if [
                  (r[0], round(r[1] * 10000),
                   (r[2] - __import__("datetime").date(1970, 1, 1)).days)
                  for r in rows] == q3want else ["q3"],
              "group_by": lambda rows, b: []}
    canary = {}
    for name, sql in (("q1", tpch.Q1_SQL), ("q3", tpch.Q3_SQL),
                      ("group_by", GROUP_BY_SQL)):
        with PathInputs(torch, TK, "every") as cap:
            res = sess.execute(sql)
            want = res.rows()
            bad = checks[name](want, res.batch)
            if bad:
                raise AssertionError(f"16d {name}: unarmed rows wrong "
                                     f"{bad[:3]}")
            CK.LAUNCHES.reset()
            # the armed run's launches alone are held: each graph that
            # the unarmed run captured is held at each armed replay, on
            # that replay's (poisoned) inputs
            cap.drop_held()
            with qa.armed_scope(), qa.capture() as probe:
                got = sess.execute(sql).rows()
                torch.cuda.synchronize()
            launches = kernel_launches(CK, f"16d {name}", ALL_KERNELS)
        if repr(got) != repr(want) or probe.findings():
            raise AssertionError(f"16d {name}: armed rows differ or the "
                                 f"canary found {[f.format() for f in probe.findings()]}")
        rows, seg, held_d = hold_launches(torch, CK, cap, f"16d_{name}",
                                          launches)
        del cap
        search_rows += rows
        segsum_rows += seg
        canary[name] = {"launches": launches, "held": held_d,
                        "findings": 0}
    if not canary["q3"]["launches"]["sorted_search"]["launches"] \
            or not canary["group_by"]["launches"]["segment_sum"]["launches"]:
        raise AssertionError("16d: Q3 launched no sorted search or the "
                             "GROUP BY no segment sum")
    report["16d_canary"] = canary
    tp = part("16d", tp)
    log(f"[16d] canary armed: Q1, Q3, 5c's GROUP BY fused, rows "
        f"bit-identical to unarmed, no finding; "
        f"{canary['q3']['held']['sorted_search']} sorted searches "
        f"({canary['q3']['held']['in_graph_replays']} in graph replays) "
        f"and "
        f"{canary['group_by']['held']['segment_sum']} segment sums held on "
        f"their poisoned inputs")
    sess.close()
    eng.unsubscribe(count_lineitem)
    del sess, eng
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    report["part_seconds"] = parts
    log(f"[16] phase 16 took {report['seconds']:.1f}s "
        f"({ {k: round(v, 1) for k, v in parts.items()} })")
    return report, search_rows, segsum_rows


# ------------------------------------------ phase 17: sharded SQL

#: phase 17's mesh: 8 slots laid on the one card
#: (`parallel/mesh.simulated_slots`), as the CPU tests lay them
SHARD_SLOTS = 8
#: phase 17's scan batch: bench.py:484's n // 16, so every one of 8
#: shards owns chunks of the 6M-row tables
SHARD_BATCH_ROWS = 375_000
#: 17a: both join sides plain scans, the build 1.5M estimated rows (past
#: MO_SHUFFLE_BUILD_ROWS) over the probe's key range: exchange=shuffle
SHUFFLE_SQL = ("select o_orderpriority, count(*), sum(l_quantity) "
               "from lineitem join orders on l_orderkey = o_orderkey "
               "group by o_orderpriority order by o_orderpriority")
#: 17b: orders hash-partitioned on o_custkey into 8 shards, grouped by it
COPART_DDL = "partition by hash(o_custkey) shards 8"
COPART_SQL = ("select o_custkey, count(*), sum(o_totalprice) from "
              "orders_by_cust group by o_custkey order by o_custkey")
#: the merges the shard executor counts, by kind
MERGE_KINDS = ("dense", "general", "single", "empty", "scalar", "topk",
               "join")


def exchange_counts() -> dict:
    """The exchange counters so far (`utils/metrics.py`)."""
    from matrixone_tpu_torch.utils import metrics as M
    out = {k: M.exchange_partial_merge.get(kind=k) for k in MERGE_KINDS}
    out["shuffle_rows"] = M.exchange_shuffle_rows.get()
    out["broadcast_bytes"] = M.exchange_broadcast_bytes.get()
    return out


def exchanges_since(before: dict) -> dict:
    now = exchange_counts()
    return {k: now[k] - before[k] for k in now}


class OnShards:
    """`SET query_shards = n` (every input big enough) for the block."""

    def __init__(self, session, n: int):
        self.session, self.n = session, n

    def __enter__(self):
        self.session.execute(f"set query_shards = {self.n}")
        self.session.execute("set dist_min_rows = 0")
        return self

    def __exit__(self, *exc):
        self.session.execute("set query_shards = 0")
        return False


def warm_seconds(torch, session, sql: str, n: int, runs: int = 1) -> list:
    """Warm seconds of `runs` runs of `sql` at n shards (0: local)."""
    out = []
    for _ in range(runs):
        if n:
            with OnShards(session, n):
                out.append(run_sql(torch, session, sql)[2])
        else:
            out.append(run_sql(torch, session, sql)[2])
    return out


def shard_run(torch, CK, TK, label: str, session, sql: str, n: int,
              check, timed: bool = False) -> tuple:
    """`sql` at n shards: one counted run with its spans traced and
    every sorted-search and segment-sum launch captured (`PathInputs` in
    `every`, graph replays included), `check`ed; for each sharded
    fragment (a statement may hold two: Q18's IN subquery runs as one of
    its own) one `shard.exec` span, one merge and one `shard.partial`
    span per shard; every launch held against its plain
    version (`hold_launches`, the most launched shapes timed if `timed`).
    -> (record, sorted-search rows, segment-sum rows)."""
    from matrixone_tpu_torch.utils import motrace
    from matrixone_tpu_torch.vm import fusion
    tr = motrace.TRACER
    was = (tr.armed, tr.sample)
    tr.arm(sample=1.0)
    tr.clear()
    # every graph the counted run replays is captured under the spy (a
    # broadcast build's fragment is the local run's), so each in-graph
    # launch is held
    fusion.CACHE.clear()
    c0 = exchange_counts()
    CK.LAUNCHES.reset()
    try:
        with PathInputs(torch, TK, "every") as cap, OnShards(session, n):
            rows, _batch, secs = run_sql(torch, session, sql)
        spans = {}
        for tid in tr.trace_ids():
            for sp in tr.spans_of(tid):
                spans[sp["name"]] = spans.get(sp["name"], 0) + 1
    finally:
        tr.armed, tr.sample = was
        tr.clear()
    moved = exchanges_since(c0)
    launches = kernel_launches(CK, label, ("sorted_search", "segment_sum",
                                           "l2_distance_sq"))
    check(rows)
    merges = {k: moved[k] for k in MERGE_KINDS if moved[k]}
    execs = spans.get("shard.exec", 0)
    if not execs or sum(merges.values()) != execs \
            or spans.get("shard.partial") != n * execs:
        raise AssertionError(f"{label}: merges {merges}, spans {spans}: not "
                             f"one merge and {n} shard.partial spans a "
                             f"sharded fragment")
    search, segsum, held = hold_launches(torch, CK, cap, label, launches,
                                         timed=timed)
    del cap
    rec = {"counted_seconds": secs, "merge": merges,
           "shuffle_rows": moved["shuffle_rows"],
           "broadcast_bytes": moved["broadcast_bytes"],
           "span_counts": spans, "launches": launches, "held": held,
           "rows": len(rows)}
    log(f"[{label}] {n} shards: {len(rows)} rows, merge {merges}, "
        f"shuffled {moved['shuffle_rows']:.0f} rows, broadcast "
        f"{moved['broadcast_bytes'] / 1e6:.1f} MB, spans "
        f"shard.partial x{spans.get('shard.partial')}")
    return rec, search, segsum


def sharded_vs_local(torch, CK, TK, label: str, session, sql: str,
                     counts, check=None, timed: bool = False,
                     compare: str = "equal") -> tuple:
    """`sql` local (the reference rows, a warm run's seconds) and at each
    shard count of `counts` (`shard_run`, then a warm run): the rows equal
    the local rows (`compare` "equal"), as multisets ("multiset": ties
    under the ORDER BY may come in another order), or by `check`
    ("check") -> (record, sorted-search rows, segment-sum rows)."""
    local = session.execute(sql).rows()
    if check is not None:
        check(local)
    order = {}

    def same(rows):
        if compare == "check":
            check(rows)
            return
        order["same"] = rows == local
        if compare == "multiset":
            ok = sorted(rows, key=repr) == sorted(local, key=repr)
        else:
            ok = order["same"]
        if not ok:
            raise AssertionError(f"{label}: sharded rows differ from the "
                                 f"local rows: {rows[:3]} vs {local[:3]}")

    rec = {"local_warm_seconds": warm_seconds(torch, session, sql, 0),
           "local_rows": len(local)}
    search, segsum = [], []
    for n in counts:
        r, s_rows, g_rows = shard_run(torch, CK, TK, f"{label} x{n}",
                                      session, sql, n, same,
                                      timed=timed and n == max(counts))
        r["warm_seconds"] = warm_seconds(torch, session, sql, n)
        if compare == "multiset":
            r["same_order"] = order["same"]
        rec[f"x{n}"] = r
        search += s_rows
        segsum += g_rows
    log(f"[{label}] warm local {min(rec['local_warm_seconds']):.3f}s; "
        + ", ".join(f"x{n} {min(rec[f'x{n}']['warm_seconds']):.3f}s"
                    for n in counts))
    return rec, search, segsum


def explain_exchanges_of(session, sql: str, n: int) -> list:
    with OnShards(session, n):
        text = session.execute("explain " + sql).text
    return sorted({tok.split("=", 1)[1] for tok in text.split()
                   if tok.startswith("exchange=")})


def phase_sharded_sql(torch, CK, args, arrays, full) -> tuple:
    """Phase 17: sharded SQL on 8 slots of the one card at SF1, default
    knobs (fused) and `batch_rows` SHARD_BATCH_ROWS.  17a over phase 5's
    arrays in an engine of its own (Q3 at 2, 4, 8 shards, Q1 and 5c's
    GROUP BY at 8); the shuffle join, 17b (a hash-partitioned copy of
    orders) and 17c (Q5, Q9, Q18 at 8) over phase 10's TPC-H engine
    (`full`: (engine, generator arrays)).  -> (report, sorted-search
    rows, segment-sum rows)."""
    import gc

    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.parallel.mesh import simulated_slots
    from matrixone_tpu_torch.storage.engine import Engine, TableMeta
    from matrixone_tpu_torch.utils import tpch, tpch_full

    lineitem, q3data, v = arrays
    full_eng, full_tables = full
    t_phase = time.perf_counter()
    report = {}
    search_rows, segsum_rows = [], []
    eng = Engine()
    report["17_load_seconds"] = load_phase16_tables(eng, lineitem, q3data,
                                                    v, v_tables=("v",))
    sess = Session(catalog=eng, device="cuda")
    fsess = Session(catalog=full_eng, device="cuda")
    for s in (sess, fsess):
        s.execute(f"set batch_rows = {SHARD_BATCH_ROWS}")

    def add(key, out):
        rec, s_rows, g_rows = out
        report[key] = rec
        search_rows.extend(s_rows)
        segsum_rows.extend(g_rows)

    with simulated_slots(SHARD_SLOTS):
        # 17a: Q3 (broadcast builds), Q1 (the dense psum), 5c (f32)
        report["17a_q3_exchanges"] = explain_exchanges_of(
            sess, tpch.Q3_SQL, SHARD_SLOTS)
        q3_check = q3_rows_check(tpch.q3_oracle(lineitem, q3data), "17a")
        add("17a_q3", sharded_vs_local(
            torch, CK, TK, "17a Q3", sess, tpch.Q3_SQL, (2, 4, 8),
            check=lambda rows: q3_check(rows, None), timed=True))
        report["17a_q3"]["profile_x8"] = profile_run(
            torch, lambda: sharded_once(sess, tpch.Q3_SQL, SHARD_SLOTS),
            "17a Q3 x8")
        add("17a_q1", sharded_vs_local(torch, CK, TK, "17a Q1", sess,
                                       tpch.Q1_SQL, (SHARD_SLOTS,)))
        if "dense" not in report["17a_q1"][f"x{SHARD_SLOTS}"]["merge"]:
            raise AssertionError("17a Q1: the shards' partials did not "
                                 "merge by the dense psum")
        errs = {}
        gb_check = group_by_check(v, errs, "17a 5c")
        local_gb = sess.execute(GROUP_BY_SQL).rows()

        def gb_same(rows):
            gb_check(rows, None)
            if not rows_agree(rows, local_gb):
                raise AssertionError("17a 5c: the sharded sums differ from "
                                     "the local ones past rtol 1e-4 / "
                                     "atol 1e-3")
        add("17a_group_by", sharded_vs_local(
            torch, CK, TK, "17a 5c GROUP BY", sess, GROUP_BY_SQL,
            (SHARD_SLOTS,), check=gb_same, timed=True, compare="check"))
        report["17a_group_by"]["errors"] = errs
        # 17a: the shuffle join over phase 10's lineitem and orders
        ex = explain_exchanges_of(fsess, SHUFFLE_SQL, SHARD_SLOTS)
        if ex != ["shuffle"]:
            raise AssertionError(f"17a shuffle: the planner chose {ex}")
        add("17a_shuffle", sharded_vs_local(
            torch, CK, TK, "17a shuffle join", fsess, SHUFFLE_SQL,
            (SHARD_SLOTS,)))
        if not report["17a_shuffle"][f"x{SHARD_SLOTS}"]["shuffle_rows"]:
            raise AssertionError("17a shuffle: no row crossed the exchange")
        report["17a_shuffle"]["exchanges"] = ex
        # 17b: a copy of orders hash-partitioned on o_custkey, read
        # co-partitioned
        orders = full_tables["orders"]
        schema = tpch_full._SCHEMAS["orders"]
        t0 = time.perf_counter()
        fsess.execute("create table orders_by_cust ("
                      + ", ".join(f"{c} {d}" for c, d in schema)
                      + f") {COPART_DDL}")
        full_eng.get_table("orders_by_cust").insert_numpy(
            orders, strings={c: tpch_full._encode_strings(orders[c])
                             for c, d in schema if d.is_varlen})
        copart_load = time.perf_counter() - t0
        spec = full_eng.get_table("orders_by_cust").meta.partition
        if (spec.kind, spec.column, spec.n_parts) != ("hash", "o_custkey",
                                                      SHARD_SLOTS):
            raise AssertionError(f"17b: the DDL made {spec}")
        ex = explain_exchanges_of(fsess, COPART_SQL, SHARD_SLOTS)
        if ex != ["local"]:
            raise AssertionError(f"17b: the exchanges {ex}, not local")
        add("17b_copartitioned", sharded_vs_local(
            torch, CK, TK, "17b co-partitioned GROUP BY", fsess,
            COPART_SQL, (SHARD_SLOTS,)))
        if report["17b_copartitioned"][f"x{SHARD_SLOTS}"]["shuffle_rows"]:
            raise AssertionError("17b: rows crossed the exchange")
        report["17b_copartitioned"].update(
            load_seconds=copart_load, exchanges=ex,
            segments=len(full_eng.get_table("orders_by_cust").segments))
        full_eng.drop_table("orders_by_cust")
        # 17c: Q5, Q9, Q18 at 8 shards against the local rows
        for q in (5, 9, 18):
            sql = tpch_full.QUERIES[q]
            report[f"17c_q{q}_exchanges"] = explain_exchanges_of(
                fsess, sql, SHARD_SLOTS)
            add(f"17c_q{q}", sharded_vs_local(
                torch, CK, TK, f"17c Q{q}", fsess, sql, (SHARD_SLOTS,),
                compare="multiset"))
    held = {k: sum(r[f"x{n}"]["held"][k] for r in report.values()
                   if isinstance(r, dict) for n in (2, 4, 8)
                   if f"x{n}" in r)
            for k in ("sorted_search", "segment_sum", "in_graph_replays")}
    report["17_held"] = held
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[17] held {held['sorted_search']} sorted searches and "
        f"{held['segment_sum']} segment sums ({held['in_graph_replays']} in "
        f"graph replays); phase 17 {report['seconds']:.1f}s")
    del sess, fsess, eng
    gc.collect()
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


def sharded_once(session, sql: str, n: int):
    with OnShards(session, n):
        return session.execute(sql).rows()


# --------------------------------------------------- phase 18: host peers

#: 18a: fragment servers in this process over phase 10's SF1 engine
PEERS = 4
#: 18a: the peers' scan batch: lineitem's 6M rows in 23 chunks, 5-6 a
#: peer
PEER_BATCH_ROWS = 262_144
#: 18a: the JAX package's distributed TPC-H set
#: (`tests/test_distributed_scopes.py:151`) and the fragments each runs
#: on PEERS peers: one a peer for each distributed aggregate or top-k
#: (Q18's IN subquery is a second one); Q10's count is recorded
PEER_TPCH = (1, 3, 6, 10, 18)
PEER_FRAGS = {1: PEERS, 3: PEERS, 6: PEERS, 18: 2 * PEERS}
#: 18a: phase 17's lineitem-orders join with no aggregate above it, so
#: the host peers run it as a shuffle join (2 x PEERS scans, PEERS
#: joins); the filter keeps its result near 240,000 rows
PEER_SHUFFLE_SQL = ("select l_orderkey, l_quantity, o_orderpriority "
                    "from lineitem join orders on l_orderkey = o_orderkey "
                    "where l_quantity <= 2")
#: 18c: single-row commits through CN 1 timed to CN 2's logtail
LOGTAIL_COMMITS = 50


def peer_counts(servers) -> dict:
    """The host-peer counters so far: fragments run, fabric bytes, rows
    pushed, graph captures and spares (`utils/metrics.py`)."""
    from matrixone_tpu_torch.utils import metrics as M
    return {"frags_run": sum(f.frags_run for f in servers),
            "result_bytes": M.fragment_wire_bytes.get(kind="result"),
            "shuffle_bytes": M.fragment_wire_bytes.get(kind="shuffle"),
            "pushed_rows": M.fragment_pushed_rows.get(),
            "graph_captures": M.fusion_graphs.get(event="capture"),
            "graph_spares": M.fusion_graphs.get(event="spare")}


def q1_oracle_strings(li) -> dict:
    """`q1_oracle_int64` over `tpch_full`'s lineitem, whose flag and
    status are strings."""
    from matrixone_tpu_torch.utils import tpch_full
    sel = li["l_shipdate"] <= tpch_full._days(1998, 12, 1) - 90
    flag = np.asarray(li["l_returnflag"][sel], dtype="U1")
    status = np.asarray(li["l_linestatus"][sel], dtype="U1")
    q, p, d, t = (li[c][sel].astype(np.int64) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = p * (100 - d)
    charge = disc_price * (100 + t)
    out = {}
    for f in np.unique(flag):
        for st in np.unique(status):
            m = (flag == f) & (status == st)
            n = int(m.sum())
            if not n:
                continue
            sq, sp, sd = int(q[m].sum()), int(p[m].sum()), int(d[m].sum())
            out[(str(f), str(st))] = {
                "sum_qty": sq, "sum_base_price": sp,
                "sum_disc_price": int(disc_price[m].sum()),
                "sum_charge": int(charge[m].sum()),
                "avg_qty": sq / n / 100, "avg_price": sp / n / 100,
                "avg_disc": sd / n / 100, "count_order": n}
    return out


def peer_run(torch, CK, TK, label: str, local, dist, servers, sql: str,
             same, frags=None, timed: bool = False) -> tuple:
    """`sql` locally (its rows, a warm run's seconds) and on the host
    peers: one counted run with every sorted search and segment sum
    captured (`PathInputs` in `every`, graph replays included, on every
    peer's thread), its fragments, fabric bytes, rows pushed, graph
    captures and spares counted, its rows held to the local rows by
    `same(rows, local_rows, batch)`, each launch held against its plain
    version (`hold_launches`); then a warm run's seconds.  `frags`: the
    fragments it must run (None: recorded).  -> (record, sorted-search
    rows, segment-sum rows)."""
    from matrixone_tpu_torch.vm import fusion
    want = local.execute(sql).rows()
    local_s = run_sql(torch, local, sql)[2]
    fusion.CACHE.clear()
    c0 = peer_counts(servers)
    CK.LAUNCHES.reset()
    with PathInputs(torch, TK, "every") as cap:
        rows, batch, secs = run_sql(torch, dist, sql)
    launches = kernel_launches(CK, label, ("sorted_search", "segment_sum",
                                           "l2_distance_sq"))
    moved = {k: v - c0[k] for k, v in peer_counts(servers).items()}
    same(rows, want, batch)
    if frags is not None and moved["frags_run"] != frags:
        raise AssertionError(f"{label}: {moved['frags_run']} fragments "
                             f"ran on the peers, not {frags}")
    search, segsum, held = hold_launches(torch, CK, cap, label, launches,
                                         timed=timed)
    del cap
    warm = run_sql(torch, dist, sql)[2]
    rec = {"rows": len(rows), "local_warm_seconds": local_s,
           "counted_seconds": secs, "warm_seconds": warm, **moved,
           "launches": launches, "held": held}
    log(f"[{label}] {len(rows)} rows = local; {moved['frags_run']} "
        f"fragments, {moved['result_bytes'] / 1e6:.2f} MB back, "
        f"{moved['shuffle_bytes'] / 1e6:.2f} MB and "
        f"{moved['pushed_rows']:.0f} rows pushed, "
        f"{moved['graph_captures']:.0f} captures "
        f"({moved['graph_spares']:.0f} spares); warm local "
        f"{local_s:.3f}s, peers {warm:.3f}s")
    return rec, search, segsum


def phase_host_peers(torch, CK, args, v, full) -> tuple:
    """Phase 18a/18b: PEERS fragment servers in this process over phase
    10's SF1 engine (`full`: (engine, generator arrays)) with phase 5's
    v loaded beside it, default knobs (fused): the JAX package's
    distributed TPC-H set, 5c's f32 GROUP BY and the lineitem-orders
    shuffle join on the peers against the local runs; then one peer
    stopped.  -> (report, sorted-search rows, segment-sum rows)."""
    from matrixone_tpu_torch.cluster import FragmentServer
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.parallel import fragments as FR
    from matrixone_tpu_torch.storage.engine import TableMeta
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch_full

    eng, tables = full
    t_phase = time.perf_counter()
    report, search_rows, segsum_rows = {}, [], []
    t0 = time.perf_counter()
    eng.create_table(TableMeta("v", [("id", dt.INT64), ("grp", dt.INT64),
                                     ("xi", dt.FLOAT32),
                                     ("xn", dt.FLOAT32)], ["id"]))
    eng.get_table("v").insert_numpy(v)
    report["18_load_v_seconds"] = time.perf_counter() - t0
    servers = [FragmentServer(eng, device="cuda").start()
               for _ in range(PEERS)]
    try:
        eng.dist_peers = [f.addr for f in servers]
        local = Session(catalog=eng, device="cuda")
        local.execute("set dist = 0")
        dist = Session(catalog=eng, device="cuda")
        dist.execute("set dist_min_rows = 0")
        dist.execute(f"set dist_batch_rows = {PEER_BATCH_ROWS}")

        def add(key, out):
            rec, s_rows, g_rows = out
            report[key] = rec
            search_rows.extend(s_rows)
            segsum_rows.extend(g_rows)

        q1_want = q1_oracle_strings(tables["lineitem"])
        for q in PEER_TPCH:
            label = f"18a Q{q}"

            def same(rows, want, batch, q=q, label=label):
                if rows != want:
                    raise AssertionError(f"{label}: the peers' rows differ "
                                         f"from the local rows: "
                                         f"{rows[:2]} vs {want[:2]}")
                if q == 1:
                    bad = q1_exact(batch, q1_want)
                    if bad:
                        raise AssertionError(f"{label}: the decimals "
                                             f"differ from the int64 "
                                             f"oracle: {bad[:4]}")
            add(f"18a_q{q}", peer_run(
                torch, CK, TK, label, local, dist, servers,
                tpch_full.QUERIES[q], same, frags=PEER_FRAGS.get(q),
                timed=q == 3))
        if report["18a_q10"]["frags_run"] not in (0, PEERS):
            raise AssertionError("18a Q10: a fragment count of neither "
                                 "a local run nor one a peer")
        errs = {}
        gb_check = group_by_check(v, errs, "18a 5c")

        def gb_same(rows, want, _batch):
            gb_check(rows, None)
            if not rows_agree(rows, want):
                raise AssertionError("18a 5c: the peers' sums differ from "
                                     "the local ones past rtol 1e-4 / atol "
                                     "1e-3")
        add("18a_group_by", peer_run(torch, CK, TK, "18a 5c GROUP BY",
                                     local, dist, servers, GROUP_BY_SQL,
                                     gb_same, frags=PEERS, timed=True))
        report["18a_group_by"]["errors"] = errs

        def multiset(rows, want, _batch):
            if sorted(rows) != sorted(want):
                raise AssertionError("18a shuffle join: the peers' rows "
                                     "differ from the local rows as "
                                     "multisets")
        add("18a_shuffle_join", peer_run(
            torch, CK, TK, "18a shuffle join", local, dist, servers,
            PEER_SHUFFLE_SQL, multiset, frags=3 * PEERS, timed=True))
        if not report["18a_shuffle_join"]["pushed_rows"]:
            raise AssertionError("18a shuffle join: no row was pushed to "
                                 "another peer")
        # 18b: a stopped peer: the next statement runs locally, same rows
        sql = tpch_full.QUERIES[6]
        want = local.execute(sql).rows()
        stopped = servers[-1].stop()
        errs0 = M.rpc_errors.get(kind="transport", op="run_fragment")
        rows, _b, secs = run_sql(torch, dist, sql)
        if rows != want:
            raise AssertionError("18b: with a peer stopped the rows differ "
                                 "from the local rows")
        transport = M.rpc_errors.get(kind="transport",
                                     op="run_fragment") - errs0
        if not transport:
            raise AssertionError("18b: the stopped peer was never tried")
        # the shuffle join too: the live peers' pushes to the stopped
        # one fail inside them, and that degrades as well
        want = local.execute(PEER_SHUFFLE_SQL).rows()

        def fabric_errors():
            return sum(M.rpc_errors.get(kind=k, op=op)
                       for k in ("transport", "breaker")
                       for op in ("run_fragment", "shuffle_put"))
        errs0 = fabric_errors()
        j_rows, _b, j_secs = run_sql(torch, dist, PEER_SHUFFLE_SQL)
        if sorted(j_rows) != sorted(want):
            raise AssertionError("18b: with a peer stopped the shuffle "
                                 "join's rows differ from the local rows "
                                 "as multisets")
        j_errs = fabric_errors() - errs0
        if not j_errs:
            raise AssertionError("18b: the shuffle join never tried the "
                                 "stopped peer")
        if FR.shuffle_store_for(eng)._buckets:
            raise AssertionError("18b: a peer kept buckets of the failed "
                                 "shuffle")
        report["18b_stopped_peer"] = {
            "seconds": secs, "rows": len(rows),
            "transport_errors": transport, "left_threads": stopped,
            "shuffle_join_seconds": j_secs,
            "shuffle_join_rows": len(j_rows),
            "shuffle_join_fabric_errors": j_errs}
        log(f"[18b] one of {PEERS} peers stopped: Q6 ran locally in "
            f"{secs:.3f}s, the local rows ({transport:.0f} transport "
            f"error); the shuffle join ran locally in {j_secs:.3f}s, "
            f"the local rows ({j_errs:.0f} fabric errors)")
    finally:
        FR.pool_for(eng).close()
        for f in servers:
            f.stop()
        eng.dist_peers = []
        eng.drop_table("v")
    held = {k: sum(r["held"][k] for r in report.values()
                   if isinstance(r, dict) and "held" in r)
            for k in ("sorted_search", "segment_sum", "in_graph_replays")}
    report["18_held"] = held
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[18] held {held['sorted_search']} sorted searches and "
        f"{held['segment_sum']} segment sums launched on the peers "
        f"({held['in_graph_replays']} in graph replays); 18a-18b "
        f"{report['seconds']:.1f}s")
    return report, search_rows, segsum_rows


def phase_cn_tn(torch, CK, args, sf01) -> tuple:
    """Phase 18c: a TNService and two RemoteCatalog CNs in this process
    on a LocalFS directory, on the card: TPC-H at SF 0.1 loaded through
    CN 1 (the same tables as 6b's, `sf01`), the 22 on CN 2 against
    sqlite3's answers over them (`SQLITE_SF01`), RF1 and RF2 through CN
    1 against a copy of 6b's sqlite3 database, a view of Q1 the TN
    maintains read on CN 2, Q3 and Q18 on both CNs' fragment servers
    (every launch there held, as in 18a), the logtail's lag.  ->
    (report, sorted-search rows, segment-sum rows)."""
    import shutil
    import sqlite3
    import tempfile

    from matrixone_tpu_torch.cluster import (FragmentServer, RemoteCatalog,
                                             TNService)
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.utils import tpch_full

    t_phase = time.perf_counter()
    rep, search_rows, segsum_rows = {}, [], []
    root = tempfile.mkdtemp(prefix="chip_smoke_cntn_")
    tn = TNService(data_dir=root, device="cuda").start()
    cat1 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=root)
    cat2 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=root)
    peers = []
    try:
        s1 = Session(catalog=cat1, device="cuda")
        s2 = Session(catalog=cat2, device="cuda")
        s2.execute("set dist = 0")
        t0 = time.perf_counter()
        tables = tpch_full.load_tpch(cat1, sf=TPCH_SF, seed=args.seed)
        load_s = time.perf_counter() - t0
        n_rows = sum(len(next(iter(a.values()))) for a in tables.values())
        cat2.consumer.wait_ts(cat1.committed_ts)
        rep["load"] = {"rows": n_rows, "seconds": load_s,
                       "rows_per_second": n_rows / load_s}
        log(f"[18c] TPC-H at sf {TPCH_SF} loaded through CN 1 and the TN: "
            f"{n_rows} rows in {load_s:.2f}s "
            f"({n_rows / load_s:,.0f} rows/s); CN 2 caught up")
        _sess01, conn01, tables01 = sf01
        for name, arrays in tables.items():
            for col, a in arrays.items():
                if not np.array_equal(a, tables01[name][col]):
                    raise AssertionError(f"18c: {name}.{col} differs from "
                                         f"6b's table")
        t0 = time.perf_counter()
        for q in sorted(tpch_full.QUERIES):
            got = tpch_full.normalize_rows(
                s2.execute(tpch_full.QUERIES[q]).rows())
            if not tpch_full.rows_match(got, SQLITE_SF01[q]):
                raise AssertionError(f"18c Q{q}: CN 2's rows differ from "
                                     f"sqlite3's")
        rep["tpch22_cn2_seconds"] = time.perf_counter() - t0
        conn = sqlite3.connect(":memory:")
        conn01.backup(conn)         # 6b's database, before phase 7's RF1
        log(f"[18c] the 22 on CN 2 = sqlite3 in "
            f"{rep['tpch22_cn2_seconds']:.1f}s")
        # a view of Q1 through CN 1: the TN maintains it
        s1.execute("create materialized view mv_q1 as "
                   + tpch_full.QUERIES[1])
        rf1 = tpch_full.rf1(tables, TPCH_SF, seed=args.seed + 1)
        rf1_s, _, _ = run_statements(torch, s1, rf1.statements)
        tpch_full.apply_sqlite(conn, rf1.statements)
        cat2.consumer.wait_ts(cat1.committed_ts)
        view = s2.execute("select * from mv_q1 order by l_returnflag, "
                          "l_linestatus").rows()
        fresh = s2.execute(tpch_full.QUERIES[1]).rows()
        if [r[:6] + r[9:] for r in view] != [r[:6] + r[9:] for r in fresh]:
            raise AssertionError("18c: the view read on CN 2 differs from "
                                 "Q1 run fresh there after RF1")
        for q in (1, 3):
            tpch_full.run_compare(s2, conn, q)
        tables = tpch_full.apply_refresh(tables, rf1)
        rf2 = tpch_full.rf2(tables, TPCH_SF, seed=args.seed + 2)
        rf2_s, rf2_rows, _ = run_statements(torch, s1, rf2.statements)
        tpch_full.apply_sqlite(conn, rf2.statements)
        cat2.consumer.wait_ts(cat1.committed_ts)
        for q in (1, 3):
            tpch_full.run_compare(s2, conn, q)
        rep["refresh"] = {"rf1_seconds": rf1_s, "rf2_seconds": rf2_s,
                          "rf2_rows": rf2_rows}
        log(f"[18c] RF1 {rf1_s:.3f}s and RF2 {rf2_s:.3f}s through CN 1; "
            f"Q1 and Q3 on CN 2 = sqlite3 after each; mv_q1 on CN 2 "
            f"fresh after RF1")
        # both CNs' fragment servers as CN 2's peers, every launch on
        # them held as in 18a
        peers = [FragmentServer(c, device="cuda").start()
                 for c in (cat1, cat2)]
        cat2.dist_peers = [f.addr for f in peers]
        sd = Session(catalog=cat2, device="cuda")
        sd.execute("set dist_min_rows = 0")
        for q in (3, 18):
            label = f"18c Q{q}"

            def same(rows, want, _batch, label=label):
                if rows != want:
                    raise AssertionError(f"{label}: on the CNs' peers the "
                                         f"rows differ from CN 2's local "
                                         f"rows")
            rec, s_rows, g_rows = peer_run(torch, CK, TK, label, s2, sd,
                                           peers, tpch_full.QUERIES[q],
                                           same)
            if not rec["frags_run"]:
                raise AssertionError(f"{label}: no fragment ran on the "
                                     f"CNs' peers")
            rep[f"q{q}_peers"] = rec
            search_rows.extend(s_rows)
            segsum_rows.extend(g_rows)
        log(f"[18c] Q3 and Q18 on both CNs' fragment servers = CN 2's "
            f"local rows ({rep['q3_peers']['frags_run']:.0f} and "
            f"{rep['q18_peers']['frags_run']:.0f} fragments)")
        # the logtail's lag: a commit through CN 1 until CN 2 applied it
        s1.execute("create table lag (id bigint primary key, t double)")
        after_ack, total = [], []
        for i in range(LOGTAIL_COMMITS):
            t0 = time.perf_counter()
            s1.execute(f"insert into lag values ({i}, {t0})")
            t1 = time.perf_counter()
            cat2.consumer.wait_ts(cat1.committed_ts)
            t2 = time.perf_counter()
            after_ack.append(t2 - t1)
            total.append(t2 - t0)
        rep["logtail_lag_ms"] = {
            "commit_to_cn2_p50": 1e3 * float(np.percentile(total, 50)),
            "commit_to_cn2_p99": 1e3 * float(np.percentile(total, 99)),
            "after_cn1_ack_p50": 1e3 * float(np.percentile(after_ack, 50)),
            "after_cn1_ack_p99": 1e3 * float(np.percentile(after_ack, 99)),
            "commits": LOGTAIL_COMMITS}
        lag = rep["logtail_lag_ms"]
        log(f"[18c] logtail lag over {LOGTAIL_COMMITS} commits: commit to "
            f"CN 2 applied p50 {lag['commit_to_cn2_p50']:.2f} ms p99 "
            f"{lag['commit_to_cn2_p99']:.2f} ms; after CN 1's ack p50 "
            f"{lag['after_cn1_ack_p50']:.3f} ms p99 "
            f"{lag['after_cn1_ack_p99']:.3f} ms")
        conn.close()
    finally:
        pool = cat2.__dict__.get("_frag_pool")
        if pool is not None:
            pool.close()
        left = [t for f in peers for t in f.stop()]
        cat1.close()
        cat2.close()
        left += tn.stop()
        shutil.rmtree(root, ignore_errors=True)
    if left:
        raise AssertionError(f"18c: threads left alive: {left}")
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"[18c] {rep['seconds']:.1f}s")
    return rep, search_rows, segsum_rows


class L2Held:
    """Holds every launch of the L2 kernel in the scope against its plain
    version in f64 as it returns, with `check_kernel`'s tolerance
    (|err| <= 1e-5 (x2 + q2) + 1e-4), and keeps the first inputs of each
    launch shape for the timed rows.  The check runs between launches,
    so a pass under it is not timed."""

    def __init__(self, torch, CK, TK, label: str):
        self.torch, self.CK, self.TK, self.label = torch, CK, TK, label
        self.held, self.max_err, self.first = 0, 0.0, {}

    def __enter__(self):
        torch, CK, spy = self.torch, self.CK, self
        self._real = real = self.TK.l2_distance_sq_exact

        def l2(x, q):
            out = real(x, q)
            if x.is_cuda:
                x64, q64 = x.double(), q.double()
                q2_64 = (q64 * q64).sum(1)
                ref = CK.l2_distance_sq_plain(x64, q64, q2_64)
                err = (out.double() - ref).abs()
                tol = 1e-5 * ((x64 * x64).sum(1, keepdim=True)
                              + q2_64[None, :]) + 1e-4
                if bool((err > tol).any()):
                    raise AssertionError(f"{spy.label}: an L2 launch at "
                                         f"{tuple(x.shape)} x "
                                         f"{tuple(q.shape)} differs from "
                                         f"its plain version")
                spy.held += 1
                spy.max_err = max(spy.max_err, float(err.max()))
                key = (x.shape[0], q.shape[0], x.shape[1])
                if key not in spy.first:
                    spy.first[key] = (x.float().contiguous().clone(),
                                      q.float().contiguous().clone())
            return out
        self.TK.l2_distance_sq_exact = l2
        return self

    def __exit__(self, *exc):
        self.TK.l2_distance_sq_exact = self._real
        return False

    def rows(self, launches: dict, label: str) -> list:
        """The kernel at each shape held, timed (`check_kernel`)."""
        if self.held != launches["l2_distance_sq"]["launches"]:
            raise AssertionError(f"{label}: {self.held} L2 launches held "
                                 f"of {launches['l2_distance_sq']['launches']}")
        by_shape = launches["l2_distance_sq"]["by_shape"]
        counts = {tuple(r[:-1]): r[-1] for r in by_shape}
        return [dict(check_kernel(self.torch, self.CK, f"{label}_{n}x{b}",
                                  x, q), path=label,
                     path_launches=counts.get((n, b, d), 0))
                for (n, b, d), (x, q) in sorted(self.first.items())]


def phase_worker_modes(torch, CK, worker, widx, data, q_np, seq, truth,
                       single_qps: float) -> tuple:
    """3d: the worker's sharded and replicated modes over 3b's index at
    8 slots (`serve_index`: the built index, no second build): the
    sharded ids equal the single index's after the exact re-rank (the
    reference's post-rerank contract), both modes' recall@20 the single
    index's; every L2 launch held on a counted pass, QPS on a second.
    -> (record, L2 rows)."""
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.parallel.mesh import simulated_slots
    from matrixone_tpu_torch.vectorindex import ivf_flat
    from matrixone_tpu_torch.vectorindex.recall import recall_at_k
    nq = len(q_np)
    out, rows = {"single_qps": single_qps}, []
    with simulated_slots(SHARD_SLOTS):
        for mode in ("sharded", "replicated"):
            name = f"bench_{mode}"
            t0 = time.perf_counter()
            info = worker.serve_index(name, widx, mode=mode)
            serve_s = time.perf_counter() - t0
            CK.LAUNCHES.reset()
            with L2Held(torch, CK, TK, f"3d {mode}") as held:
                ids = np.concatenate([worker.search_index(
                    name, q_np[i:i + BATCH], k=K, nprobe=NPROBE)[1]
                    for i in range(0, nq, BATCH)])
            launches = kernel_launches(CK, f"3d {mode}",
                                       ("l2_distance_sq",),
                                       required=("l2_distance_sq",))
            rows += held.rows(launches, f"3d_{mode}")
            t0 = time.perf_counter()
            again = np.concatenate([worker.search_index(
                name, q_np[i:i + BATCH], k=K, nprobe=NPROBE)[1]
                for i in range(0, nq, BATCH)])
            qps = nq / (time.perf_counter() - t0)
            if not np.array_equal(again, ids):
                raise AssertionError(f"3d {mode}: two passes differ")
            dev = data.device
            q_t = torch.from_numpy(q_np).to(dev)
            _d1, r1 = ivf_flat.rerank_exact(
                data, q_t, torch.from_numpy(seq.astype(np.int32)).to(dev))
            _d2, r2 = ivf_flat.rerank_exact(
                data, q_t, torch.from_numpy(ids.astype(np.int32)).to(dev))
            if not torch.equal(r1, r2):
                bad = int((r1 != r2).any(dim=1).sum())
                raise AssertionError(f"3d {mode}: {bad} queries' ids after "
                                     f"the exact re-rank differ from the "
                                     f"single index's")
            rec = recall_at_k(ids, truth)
            rec_single = recall_at_k(seq, truth)
            if rec != rec_single:
                raise AssertionError(f"3d {mode}: recall@20 {rec} vs the "
                                     f"single index's {rec_single}")
            out[mode] = {"serve_seconds": serve_s, "info": info, "qps": qps,
                         "recall_at_20": rec, "launches": launches,
                         "held": held.held, "max_abs_err": held.max_err}
            log(f"[3d] {mode} over {SHARD_SLOTS} slots: recall@20 "
                f"{rec:.4f} (single {rec_single:.4f}), ids equal the "
                f"single index's after the re-rank, {qps:.1f} qps "
                f"(single {single_qps:.1f}); {held.held} L2 launches held")
            worker.indexes.pop(name)
    return out, rows


def phase_sharded_vector_sql(torch, CK, sess, q_np, want_rows) -> tuple:
    """13e: `SET ivf_shards = 8` over 13a's index at 8 slots (its repack
    cached on the index, no second build): the 64 statements' rows equal
    13a's at `ivf_shards = 0`, every L2 probe launch held on a counted
    pass, ms a statement on a second.  -> (record, L2 rows)."""
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.parallel.mesh import simulated_slots
    with simulated_slots(SHARD_SLOTS):
        sess.execute(f"set ivf_shards = {SHARD_SLOTS}")
        try:
            CK.LAUNCHES.reset()
            t0 = time.perf_counter()
            with L2Held(torch, CK, TK, "13e") as held:
                rows, _c, _s = knn_pass(torch, sess, "items", q_np)
            counted_s = time.perf_counter() - t0
            launches = kernel_launches(CK, "13e_ivf_shards",
                                       ("l2_distance_sq",),
                                       required=("l2_distance_sq",))
            l2_rows = held.rows(launches, "13e_ivf_shards")
            timed, _c, secs = knn_pass(torch, sess, "items", q_np)
        finally:
            sess.execute("set ivf_shards = 0")
    for i, (a, b, w) in enumerate(zip(rows, timed, want_rows)):
        if a != w or b != w:
            raise AssertionError(f"13e: statement {i}'s rows at "
                                 f"ivf_shards = {SHARD_SLOTS} differ from "
                                 f"ivf_shards = 0's")
    rec = {"counted_seconds": counted_s,
           "ms_per_query": secs * 1e3 / len(q_np), "launches": launches,
           "held": held.held, "max_abs_err": held.max_err}
    log(f"[13e] ivf_shards = {SHARD_SLOTS}: {len(q_np)} statements' rows "
        f"equal ivf_shards = 0's; {rec['ms_per_query']:.2f} ms a "
        f"statement; {held.held} L2 launches held")
    return rec, l2_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--sf1-lineitem", type=int, default=6_000_000,
                    help="lineitem rows of phase 5 (TPC-H SF1: 6M); "
                         "orders get a quarter, customer a fortieth")
    ap.add_argument("--save-search-inputs", metavar="PATH",
                    help="torch.save Q3's sorted-search inputs {(n, m): "
                         "(sorted, queries)} here, for "
                         "time_sorted_search.py")
    ap.add_argument("--save-group-by-inputs", metavar="PATH",
                    help="torch.save 5c's segment-sum inputs {(n, G): "
                         "(values, gids, mask)} here, for "
                         "time_segment_sum.py")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from matrixone_tpu_torch.ops import cuda_kernels as CK
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(smi)                       # name, power limit: beside every number
    t0 = time.perf_counter()
    CK.build()
    log(f"[env] built {', '.join(CK.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for a in CK.l2_kernel_attributes():
        log(f"[env] l2 tile kernel "
            f"{'deep (wgmma)' if a['deep'] else 'shallow (mma.sync)'} "
            f"{'16-byte' if a['vec16'] else '4-byte'} loads: "
            f"registers {a['registers']} static shared "
            f"{a['shared_bytes']} B local (spill) {a['local_bytes']} B")

    rows, masked_rows, adc_rows = phase_edges(torch, CK, args.seed)
    search_rows, segsum_rows = phase_relational_edges(torch, CK, args.seed)
    report, path_rows, ctx = phase_path(torch, CK, args)
    report["ivf_pq"], pq_rows, pq_adc_rows = phase_pq(torch, CK, args, ctx)
    report["sql"], search_path, segsum_path, sf1 = phase_sql(torch, CK,
                                                             args)
    report["tpch"], tpch_search, sf01 = phase_tpch(torch, CK, args, sf1)
    t0 = time.perf_counter()
    report["executor"], exec_search, exec_segsum = phase_executor_sf1(
        torch, CK, args, sf1)
    report["executor"]["seconds"] = time.perf_counter() - t0
    log(f"[8] phase 8 took {report['executor']['seconds']:.1f}s")
    t0 = time.perf_counter()
    report["fusion"], fusion_search = phase_fusion(torch, CK, args, sf1,
                                                   sf01, report)
    report["fusion"]["seconds"] = time.perf_counter() - t0
    log(f"[9] phase 9 took {report['fusion']['seconds']:.1f}s")
    t0 = time.perf_counter()
    ingest_tables = {}
    report["spill"], spill_search, spill_segsum = phase_spill_storage(
        torch, CK, args, sf1, keep=ingest_tables)
    report["spill"]["seconds"] = time.perf_counter() - t0
    log(f"[10] phase 10 took {report['spill']['seconds']:.1f}s")
    t0 = time.perf_counter()
    tpch_sf1 = ingest_tables.pop("tpch_sf1")
    report["sharded"], shard_search, shard_segsum = phase_sharded_sql(
        torch, CK, args, sf1[1:], tpch_sf1)
    log(f"[17] phase 17 took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report["host_peers"], peer_search, peer_segsum = phase_host_peers(
        torch, CK, args, sf1[3], tpch_sf1)
    del tpch_sf1
    report["host_peers"]["18c"], cn_search, cn_segsum = phase_cn_tn(
        torch, CK, args, sf01)
    peer_search += cn_search
    peer_segsum += cn_segsum
    report["host_peers"]["phase_seconds"] = time.perf_counter() - t0
    log(f"[18] phase 18 took {report['host_peers']['phase_seconds']:.1f}s")
    t0 = time.perf_counter()
    rf01_report, rf01_search, rf01_segsum = phase_refresh_sf01(
        torch, CK, args, sf01)
    report["refresh"] = {"sf01": rf01_report}
    del sf01
    report["refresh"]["sf1"], refresh_search, refresh_segsum = \
        phase_refresh_sf1(torch, CK, args, sf1)
    report["refresh"]["seconds"] = time.perf_counter() - t0
    log(f"[7] phase 7 took {report['refresh']['seconds']:.1f}s")
    sf1_arrays = sf1[1:]           # phase 16 loads them into its own engine
    del sf1
    t0 = time.perf_counter()
    report["objects"], obj_search, obj_segsum = phase_objects(torch, CK,
                                                              args)
    report["objects"]["seconds"] = time.perf_counter() - t0
    log(f"[11] phase 11 took {report['objects']['seconds']:.1f}s")
    report["vector_sql"], vsql_l2, vsql_adc = phase_vector_sql(torch, CK,
                                                               args)
    report["search_sql"] = phase_search_sql(torch, CK, args)
    report["ingest"], ingest_search = phase_ingest(torch, CK, args,
                                                   ingest_tables)
    del ingest_tables
    report["views_udfs"], mv_search, mv_segsum = phase_views_udfs(
        torch, CK, args, sf1_arrays)
    del sf1_arrays
    search_rows += (search_path + tpch_search + rf01_search + refresh_search
                    + exec_search + fusion_search + spill_search
                    + obj_search + ingest_search + mv_search + shard_search
                    + peer_search)
    segsum_rows += (segsum_path + rf01_segsum + refresh_segsum + exec_segsum
                    + spill_segsum + obj_segsum + mv_segsum + shard_segsum
                    + peer_segsum)
    rows += path_rows + pq_rows + vsql_l2
    adc_rows += pq_adc_rows + vsql_adc
    pq_build = report["ivf_pq"]["build_launches"]
    pq_search = report["ivf_pq"]["search_launches"]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # each kernel's main path speaks for it at its most launched shape:
    # the served IVF-Flat path for L2, the IVF-PQ search for ADC (its list
    # form, the only form the search launches); the
    # masked kernel is on no path and speaks at the truth chunk
    l2_row = max((r for r in path_rows if r["path"] == "3b_probe"),
                 key=lambda r: r["path_launches"])
    adc_row = max(pq_adc_rows, key=lambda r: r["path_launches"])
    masked_row = next(r for r in masked_rows
                      if r["shape"] == "truth_chunk_p0.7")
    # the relational kernels speak at their path's most launched shape
    search_row = max(search_path, key=lambda r: r["path_launches"])
    segsum_row = max(segsum_path, key=lambda r: r["path_launches"])
    sql_launches = {p: report["sql"][k]["launches"] for p, k in
                    (("5b_q3", "q3"), ("5c_group_by", "group_by"))}
    sql_launches.update({f"6a_{k}": report["tpch"][k]["launches"]
                         for k in ("q1", "q6")})
    tpch22 = report["tpch"]["tpch22"]["queries"]
    rf01, rf1 = report["refresh"]["sf01"], report["refresh"]["sf1"]
    refresh_launches = {
        kernel: {"7a_after_rf1": sum(r[kernel] for r in
                                     rf01["after_rf1"].values()),
                 "7a_after_rf2": sum(r[kernel] for r in
                                     rf01["after_rf2"].values()),
                 **{f"7b_{k}": rf1[k]["launches"][kernel]["launches"]
                    for k in ("q1", "q3", "q6", "group_by",
                              "snapshot_join")}}
        for kernel in ("sorted_search", "segment_sum")}
    executor_launches = {
        kernel: {p: rec["launches"][kernel]["launches"]
                 for p, rec in report["executor"].items()
                 if p != "seconds" and (rec["launches"][kernel]["launches"]
                                        or p in ("8a_full_join",
                                                 "8c_union_group_by"))}
        for kernel in ("sorted_search", "segment_sum")}
    fusion = report["fusion"]
    # under fusion the sorted search launches in graph replays: counted
    # as replays x launches per graph (vm/graphs.py)
    fusion_launches = {
        k: fusion[k]["launches"]["sorted_search"]["launches"]
        for k in ("9a_q3", "9a_q1", "9a_q6", "9b_window_rank", "9b_topk")}
    fusion_launches.update({
        f"9c_q{q}": r["sorted_search"]
        for q, r in fusion["9c_tpch22"]["queries"].items()})
    spill = report["spill"]
    spill_launches = {
        kernel: {k: rec["launches"][kernel]["launches"]
                 for k, rec in spill.items()
                 if k.startswith(prefix) and "launches" in rec}
        for kernel, prefix in (("sorted_search", "10a_"),
                               ("segment_sum", "10b_group_by"))}
    objects = report["objects"]
    object_launches = {
        kernel: {k: rec["launches"][kernel]["launches"]
                 for k, rec in objects.items()
                 if k.startswith(("11a_q3", "11b_")) and "launches" in rec}
        for kernel in ("sorted_search", "segment_sum")}
    serving_launches = {
        kernel: {k: rec["launches"][kernel]["launches"]
                 for k, rec in objects["serving"].items()
                 if k.startswith("12b_")}
        for kernel in ("sorted_search", "segment_sum")}
    vsql = report["vector_sql"]
    vsql_l2_launches = {
        "13a_ivfflat_sql": vsql["13a"]["launches"]["l2_distance_sq"],
        "13b_delta": vsql["13b"]["launches"]["l2_distance_sq"],
        "13c_ivfpq_sql": vsql["13c"]["launches"]["l2_distance_sq"]}
    # phase 13 (vector search through SQL): each kernel at its most
    # launched phase-13 shape
    vsql_timed = {
        "l2_distance_sq": max(vsql_l2, key=lambda r: r["path_launches"]),
        "adc_score": max(vsql_adc, key=lambda r: r["path_launches"])}
    vsql_timed = {k: {"shape": r["shape"], "path": r["path"],
                      "path_launches": r["path_launches"],
                      **{key: r[key] for key in timed}}
                  for k, r in vsql_timed.items()}
    # phases 14 (HNSW, full text, llm_embed: none of the five) and 15
    # (ingest: the sorted search) count every kernel
    counted = {sub: rec["launches"]
               for sub, rec in report["search_sql"].items()
               if isinstance(rec, dict) and "launches" in rec}
    counted.update({sub: report["ingest"][sub]["launches"]
                    for sub in ("15c_join_loaded", "15d_join_external")})

    def counted_launches(*names):
        return {sub: sum(launches[nm]["launches"] for nm in names)
                for sub, launches in counted.items()}

    # phase 15: the sorted search in the join over the loaded and the
    # external orders, timed at its most launched shape there
    ingest_row = max((r for r in ingest_search if "ms" in r),
                     key=lambda r: r["path_launches"])
    ingest_timed = {"shape": ingest_row["shape"], "path": ingest_row["path"],
                    "path_launches": ingest_row["path_launches"],
                    **{key: ingest_row[key] for key in timed}}
    # phase 16: views, UDFs and the canary; each kernel timed at its most
    # launched phase-16 shape
    mv = report["views_udfs"]
    mv_launches = {kernel: {
        "16a_mv_v_init": mv["16a_init"]["launches"][kernel]["launches"],
        "16b_recompute":
            mv["16b_maintenance"]["recompute_launches"][kernel]["launches"],
        **{f"16d_canary_{q}": mv["16d_canary"][q]["launches"][kernel][
            "launches"] for q in ("q1", "q3", "group_by")}}
        for kernel in ("sorted_search", "segment_sum")}
    # phase 17: each sharded statement's counted run, by shard count
    sharded = report["sharded"]
    shard_launches = {kernel: {
        f"{key}_x{n}": rec[f"x{n}"]["launches"][kernel]["launches"]
        for key, rec in sharded.items() if isinstance(rec, dict)
        for n in (2, 4, 8) if f"x{n}" in rec}
        for kernel in ("sorted_search", "segment_sum")}
    shard_timed = {}
    for kernel, rows_ in (("sorted_search", shard_search),
                          ("segment_sum", shard_segsum)):
        best = max((r for r in rows_ if "ms" in r),
                   key=lambda r: r["path_launches"], default=None)
        shard_timed[kernel] = None if best is None else {
            "shape": best["shape"], "path": best["path"],
            "path_launches": best["path_launches"],
            **{key: best[key] for key in timed}}
    # phase 18: each statement's counted run on the host peers (18a) and
    # on the CNs' fragment servers (18c)
    peers = report["host_peers"]
    peer_launches = {kernel: {
        **{key: rec["launches"][kernel]["launches"]
           for key, rec in peers.items()
           if isinstance(rec, dict) and "launches" in rec},
        **{f"18c_{key}": peers["18c"][key]["launches"][kernel]["launches"]
           for key in ("q3_peers", "q18_peers")}}
        for kernel in ("sorted_search", "segment_sum")}
    peer_timed = {}
    for kernel, rows_ in (("sorted_search", peer_search),
                          ("segment_sum", peer_segsum)):
        best = max((r for r in rows_ if "ms" in r),
                   key=lambda r: r["path_launches"], default=None)
        peer_timed[kernel] = None if best is None else {
            "shape": best["shape"], "path": best["path"],
            "path_launches": best["path_launches"],
            **{key: best[key] for key in timed}}
    mv_timed = {}
    for kernel, rows_ in (("sorted_search", mv_search),
                          ("segment_sum", mv_segsum)):
        best = max((r for r in rows_ if "ms" in r),
                   key=lambda r: r["path_launches"], default=None)
        mv_timed[kernel] = None if best is None else {
            "shape": best["shape"], "path": best["path"],
            "path_launches": best["path_launches"],
            **{key: best[key] for key in timed}}

    record = {"kernels": [{
        "name": "l2_distance_sq", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/l2_distance.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:79",
        "launches": report["served_3b"]["launches"],
        "launches_by_path": {
            "3b_served": report["served_3b"]["launches"],
            "3a_bench_build_and_4_search_runs":
                report["bench_3a"]["launches"],
            "truth": report["truth"]["launches"],
            "4_pq_build": pq_build["l2_distance_sq"]["launches"],
            "4_pq_search": pq_search["l2_distance_sq"]["launches"],
            **{p: v["launches"] for p, v in vsql_l2_launches.items()},
            **counted_launches("l2_distance_sq"),
            **{f"3d_{m}": report["3d_worker_modes"][m]["launches"][
                "l2_distance_sq"]["launches"]
               for m in ("sharded", "replicated")},
            "13e_ivf_shards": vsql["13e"]["launches"]["l2_distance_sq"][
                "launches"]},
        "phase13": vsql_timed["l2_distance_sq"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{key: l2_row[key] for key in timed},
        "shapes": rows}, {
        "name": "adc_score", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/adc_score.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:313",
        "launches": pq_search["adc_score_lists"]["launches"],
        "launches_by_form": {
            "lists": pq_search["adc_score_lists"]["launches"],
            "dense": pq_search["adc_score"]["launches"]},
        "launches_by_path": {
            "4_pq_search": pq_search["adc_score_lists"]["launches"],
            "4_pq_build": pq_build["adc_score_lists"]["launches"]
            + pq_build["adc_score"]["launches"],
            "13c_ivfpq_sql":
                vsql["13c"]["launches"]["adc_score_lists"]["launches"],
            **counted_launches("adc_score_lists", "adc_score")},
        "phase13": vsql_timed["adc_score"],
        "max_abs_err": max(r["max_abs_err"] for r in adc_rows),
        **{key: adc_row[key] for key in timed},
        "padded_path_ms": adc_row["padded_path_ms"],
        "conflict_free_ms": adc_row["conflict_free_ms"],
        "library_call": "the padded gather codes[cand], then "
                        "lut.gather(1, idx).sum(-1): three calls",
        "shapes": adc_rows}, {
        "name": "l2_distance_sq_masked", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/l2_distance.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:121",
        "launches": 0,
        "launches_by_path": counted_launches("l2_distance_sq_masked"),
        "on_path": "none: the JAX package wires it to nothing",
        "max_abs_err": max(r["max_abs_err"] for r in masked_rows),
        **{key: masked_row[key] for key in timed},
        "library_call": "torch.mm(x, q.T).masked_fill_(~mask, inf): "
                        "two calls",
        "shapes": masked_rows}, {
        "name": "sorted_search", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/sorted_search.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:250",
        "launches": sql_launches["5b_q3"]["sorted_search"]["launches"],
        "launches_by_path": {
            **{p: v["sorted_search"]["launches"]
               for p, v in sql_launches.items()},
            **{f"6b_q{q}": v["sorted_search"] for q, v in tpch22.items()},
            **refresh_launches["sorted_search"],
            **executor_launches["sorted_search"],
            **fusion_launches, **spill_launches["sorted_search"],
            **object_launches["sorted_search"],
            **serving_launches["sorted_search"],
            **counted_launches("sorted_search"),
            **mv_launches["sorted_search"],
            **shard_launches["sorted_search"],
            **peer_launches["sorted_search"]},
        "launches_under_fusion": fusion_launches["9a_q3"],
        "phase15": ingest_timed,
        "phase16": mv_timed["sorted_search"],
        "phase17": shard_timed["sorted_search"],
        "phase18": peer_timed["sorted_search"],
        "max_abs_err": max(r["max_abs_err"] for r in search_rows),
        **{key: search_row[key] for key in timed},
        "library_call": "torch.searchsorted on pre-flipped int64",
        "shapes": search_rows}, {
        "name": "segment_sum", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/segment_sum.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:177",
        "launches": sql_launches["5c_group_by"]["segment_sum"]["launches"],
        "launches_by_path": {
            **{p: v["segment_sum"]["launches"]
               for p, v in sql_launches.items()},
            **{f"6b_q{q}": v["segment_sum"] for q, v in tpch22.items()},
            **refresh_launches["segment_sum"],
            **executor_launches["segment_sum"],
            **spill_launches["segment_sum"],
            **object_launches["segment_sum"],
            **serving_launches["segment_sum"],
            **counted_launches("segment_sum"),
            **mv_launches["segment_sum"],
            **shard_launches["segment_sum"],
            **peer_launches["segment_sum"]},
        "phase16": mv_timed["segment_sum"],
        "phase17": shard_timed["segment_sum"],
        "phase18": peer_timed["segment_sum"],
        "max_abs_err": max(r["max_abs_err"] for r in segsum_rows),
        **{key: segsum_row[key] for key in timed},
        **{key: segsum_row[key] for key in (
            "ms_l2_cold", "l2_cold_sets", "bound_share",
            "bound_share_l2_cold", "device_kernels", "empty_traces")},
        "segment_sum_walk": report["sql"]["group_by"]["segment_sum_walk"],
        "library_call": "index_add_ into G + 1 slots",
        "shapes": segsum_rows}]}
    # flag every row whose times include the host's gaps
    for kernel in record["kernels"]:
        for r in kernel["shapes"]:
            r["queued"] = all_queued(r)
        kernel["queued"] = all_queued(kernel)
    log(json.dumps({"path": report}))
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
