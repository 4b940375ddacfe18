"""Time one checkout's `topk_smallest` and an IVF-Flat search over it, on the card.

    python3 time_topk.py --tree A
    python3 time_topk.py --tree B

`--tree` is a checkout of the repository (this one by default).  Its
`ops/topk.topk_smallest` is timed with this checkout's
`chip_smoke.cuda_time_ms` at each shape the vector paths of
chip_smoke.py hand it (phase 3a's probe, per-list and merged top k,
3b's per-list top k, the kmeans assignment, the brute-force truth's
merge, a phase-13 statement's probe and lists), on uniform scores from
`--seed`, and its positions are held to a stable sort of the same
scores drawn from 8 values (ties at the cut).  Then the checkout builds
an IVF-Flat index in 3a's configuration over `--n` rows of
`datagen.make_clustered` and searches 1024 queries in batches of 256,
as 3a does: build seconds and the best of 3 runs' queries a second.
Run two checkouts in turns (A, B, B, A) in one call and compare within
it.  Prints the card's name and power limit, then one JSON line a shape
and one for the search.  Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

# (name, score shape, k): the shapes chip_smoke.py's vector paths give
# topk_smallest (K 20, NPROBE 8, BATCH 256, QUERY_CHUNK 64)
SHAPES = [
    ("3a_probe", (256, 5222), 8),
    ("3a_per_list", (64, 8, 256), 20),
    ("3a_merge", (64, 160), 20),
    ("3b_per_list", (64, 8, 3968), 20),
    ("kmeans_assign", (131072, 1024), 4),
    ("truth_merge", (256, 65556), 20),
    ("13_probe", (1, 1024), 8),
    ("13_per_list", (1, 8, 3968), 30),
]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=here,
                    help="the checkout whose top k is timed")
    ap.add_argument("--n", type=int, default=262144,
                    help="rows of the IVF-Flat index (3a: 1,000,000)")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_topk: CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(here, "chip_smoke.py"))
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from matrixone_tpu_torch.ops import cuda_kernels as CK
    from matrixone_tpu_torch.ops.topk import topk_smallest
    from matrixone_tpu_torch.utils import datagen
    from matrixone_tpu_torch.vectorindex import ivf_flat
    if not os.path.abspath(CK.__file__).startswith(tree + os.sep):
        print(f"time_topk: imported {CK.__file__}, not from {tree}",
              file=sys.stderr)
        return 2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    CK.build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, shape, k in SHAPES:
        s = torch.rand(shape, generator=gen, device="cuda")
        ms = timer.cuda_time_ms(lambda: topk_smallest(s, k))
        tied = torch.floor(s * 8)
        _v, pos = topk_smallest(tied, k)
        want = torch.sort(tied.cpu(), dim=-1, stable=True).indices[..., :k]
        print(json.dumps({
            "tree": tree, "shape": name, "scores": list(shape), "k": k,
            "ms": ms, "ms_queued": ms.queued,
            "ties_as_stable_sort": bool(torch.equal(pos.cpu(), want))}),
            flush=True)

    data, queries = datagen.make_clustered(args.n, 768, 1024,
                                           seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(data, nlist=1024, n_iter=6, balance_weight=0.3,
                           kmeans_sample=min(args.n, 262144),
                           kmeans_minibatch=65536, balance_mode="split",
                           storage_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def run_all():
        outs = [ivf_flat.search(index, queries[i:i + 256], k=20, nprobe=8,
                                query_chunk=64,
                                compute_dtype=torch.bfloat16)[1]
                for i in range(0, 1024, 256)]
        torch.cuda.synchronize()
        return outs

    run_all()
    qps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_all()
        qps.append(1024 / (time.perf_counter() - t0))
    print(json.dumps({"tree": tree, "search": "3a_config", "n": args.n,
                      "nlist": index.nlist, "build_seconds": build_s,
                      "qps_runs": qps, "qps_best": max(qps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
