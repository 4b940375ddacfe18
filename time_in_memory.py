"""Time one checkout's in-memory SF1 path on the card: load, queries, refresh.

    python3 time_in_memory.py --tree A --out a.json
    python3 time_in_memory.py --tree B --out b.json

`--tree` is a checkout of the repository (this one by default).  Its own
`chip_smoke.py` phases run against its own `matrixone_tpu_torch`, whose
kernels are built into its own `build/`: phase 5 (load TPC-H SF1's Q3
tables and the table v into `Engine()`, then Q3 and the float GROUP
BY), 6a (Q1 and Q6) and 7b (RF1 and RF2 at SF1, then Q1, Q3 and Q6 on
the refreshed tables), each query held to its oracle as chip_smoke.py
holds it.  Prints the card's name and power limit, then one JSON line:
load seconds, each query's warm seconds (best of 3), RF1's and RF2's
seconds, the bytes the engine's file service holds after phase 5 (its
write-ahead log, where the engine keeps one) and the process's peak
resident memory.  Run two checkouts in turns (A, B, B, A) in one call
and compare within it.  Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time


def fs_bytes(eng) -> int:
    """Bytes held by the engine's file service, 0 where it has none."""
    fs = getattr(eng, "fs", None)
    if fs is None:
        return 0
    return sum(len(fs.read(p)) for p in fs.list(""))


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=here,
                    help="the checkout whose in-memory path is timed")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--sf1-lineitem", type=int, default=6_000_000)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_in_memory: CUDA is not available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tree", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from matrixone_tpu_torch.ops import cuda_kernels as CK
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.utils import tpch
    if not os.path.abspath(CK.__file__).startswith(tree + os.sep):
        print(f"time_in_memory: imported {CK.__file__}, not from {tree}",
              file=sys.stderr)
        return 2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    CK.build()
    ns = argparse.Namespace(seed=args.seed, sf1_lineitem=args.sf1_lineitem,
                            save_search_inputs=None,
                            save_group_by_inputs=None)
    t0 = time.perf_counter()
    rep5, _, _, sf1 = cs.phase_sql(torch, CK, ns)
    phase5_s = time.perf_counter() - t0
    session, lineitem = sf1[:2]
    held = fs_bytes(session.catalog)
    n = args.sf1_lineitem
    rep6 = {}
    rep6["q1"], _ = cs.sql_path(torch, CK, TK, "6a Q1", session,
                                tpch.Q1_SQL, n,
                                cs.q1_rows_check(lineitem, {}, "6a"))
    rep6["q6"], _ = cs.sql_path(torch, CK, TK, "6a Q6", session,
                                tpch.Q6_SQL, n,
                                cs.q6_rows_check(lineitem, "6a"))
    t0 = time.perf_counter()
    rep7, _, _ = cs.phase_refresh_sf1(torch, CK, ns, sf1)
    phase7_s = time.perf_counter() - t0

    def best(r):
        return min(r["warm_seconds"])

    out = {"tree": tree,
           "load_seconds": rep5["load"]["q3_tables_seconds"]
           + rep5["load"]["v_seconds"],
           "phase5_seconds": phase5_s, "phase7b_seconds": phase7_s,
           "5b_q3": best(rep5["q3"]), "5c_group_by": best(rep5["group_by"]),
           "6a_q1": best(rep6["q1"]), "6a_q6": best(rep6["q6"]),
           "7b_rf1_seconds": rep7["rf1"]["seconds"],
           "7b_rf1_commit_seconds": rep7["rf1"]["commit_seconds"],
           "7b_rf2_seconds": rep7["rf2"]["seconds"],
           "7b_rf2_commit_seconds": rep7["rf2"]["commit_seconds"],
           "7b_q1": best(rep7["q1"]), "7b_q3": best(rep7["q3"]),
           "7b_q6": best(rep7["q6"]),
           "fs_bytes_after_phase5": held,
           "peak_rss_bytes": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
