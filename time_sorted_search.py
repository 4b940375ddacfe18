"""Time one checkout's sorted-search kernel on Q3's own inputs, on the card.

    python3 chip_smoke.py --save-search-inputs build/q3_search.pt
    python3 time_sorted_search.py --inputs build/q3_search.pt --tree A
    python3 time_sorted_search.py --inputs build/q3_search.pt --tree B

`--tree` is a checkout of the repository (this one by default): its
`matrixone_tpu_torch` kernels are built into its own `build/` and its
`sorted_search` is checked bit for bit against its plain version, then
timed beside `torch.searchsorted` on pre-flipped int64, at each shape
chip_smoke.py's Q3 run handed the kernel.  Every tree is timed with this
checkout's `chip_smoke.cuda_time_ms`, so two checkouts' kernels are timed
alike; run them in turns (A, B, B, A) in one call and compare within it.
Prints the card's name and power limit, then one JSON line a shape.
Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True,
                    help="chip_smoke.py --save-search-inputs' file")
    ap.add_argument("--tree", default=here,
                    help="the checkout whose kernel is timed")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_sorted_search: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's timer, whatever checkout's kernel is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(here, "chip_smoke.py"))
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from matrixone_tpu_torch.ops import cuda_kernels as CK
    if not os.path.abspath(CK.__file__).startswith(tree + os.sep):
        print(f"time_sorted_search: imported {CK.__file__}, not from "
              f"{tree}", file=sys.stderr)
        return 2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    CK.build()
    inputs = torch.load(args.inputs)
    for (n, m), (srt, q) in sorted(inputs.items()):
        srt, q = srt.cuda().contiguous(), q.cuda().contiguous()
        got = CK.sorted_search(srt, q)
        same = bool(torch.equal(got, CK.sorted_search_plain(srt, q)))
        ms = timer.cuda_time_ms(lambda: CK.sorted_search(srt, q))
        sf, qf = CK.unsigned_order(srt), CK.unsigned_order(q)
        lib_ms = timer.cuda_time_ms(
            lambda: torch.searchsorted(sf, qf, out_int32=True))
        print(json.dumps({
            "tree": tree, "n": n, "m": m, "bit_identical": same,
            "ms": ms, "ms_queued": ms.queued, "searchsorted_ms": lib_ms,
            "searchsorted_queued": lib_ms.queued,
            "x_searchsorted": ms / lib_ms}), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
