"""Time one checkout's segment-sum kernel on 5c's own inputs and at the
edge shapes, on the card.

    python3 chip_smoke.py --save-group-by-inputs build/gb.pt
    python3 time_segment_sum.py --inputs build/gb.pt --tree A
    python3 time_segment_sum.py --inputs build/gb.pt --tree B
    python3 time_segment_sum.py --inputs build/gb.pt --parts

`--tree` is a checkout of the repository (this one by default): its
`matrixone_tpu_torch` kernels are built into its own `build/`, and its
`segment_sum` is checked against its plain version in f64, launched five
times for the same bits, and timed beside `index_add_` into G + 1 slots:
at each shape chip_smoke.py's 5c run handed the kernel (also over copies
of that input set larger than the L2 together, and with the device time
of its kernels per call from torch.profiler, the rest of a call being the
gaps between launches), then at chip_smoke.py's edge shapes (N(0,1)
values, n in {1, 4000, 4096, 2^20, 6M}, G in {1, 19, 1000, 4096}) and
edge inputs (skewed, unaligned, out-of-range, NaN/inf), then at the
shapes the GROUP BY executor sends between them (G = 4096 at n from 16385
to 2^19, and at 2^20 rows with 1, 3 and 19 live groups: a low-cardinality
key).  Every tree is timed with this checkout's `chip_smoke.cuda_time_ms`
on the same seeded inputs, so two checkouts' kernels are timed alike; run
them in turns (A, B, B, A) in one call and compare within it.

With `--parts`, it instead times the parts of this checkout's kernel at
each of 5c's shapes and at n = 65536, G = 4096: copies of
`csrc/segment_sum.cu` with one part taken out (the zeroing of the
partials; the row walk; the second pass; the grid barrier and the
second pass; everything but the launch) are built beside the unchanged
one with a plain C entry point and timed on the same inputs, each
launched with the walk the binding chose (their sums are wrong but for
the unchanged copy's).

Prints the card's name and power limit, then one JSON line a shape.
Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

# copies of the kernel with one part taken out: (name, [(text, with)])
PARTS = (
    ("whole", ()),
    ("no_zeroing", (("    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);\n",
                     "    ;\n"),)),
    ("no_row_walk", (("  for (; base < hi; base += step) {",
                      "  for (; false;) {"),
                     ("  if (QUADS && (by_groups",
                      "  if (false && (by_groups"))),
    ("no_barrier_pass2", (("  if (by_groups || gridDim.x == 1) return;",
                           "  return;"),)),
    ("no_pass2", (("  cooperative_groups::this_grid().sync();",
                   "  cooperative_groups::this_grid().sync();\n  return;"),)),
    ("launch_only", (("  float* smem = reinterpret_cast<float*>(smem4);",
                      "  return;\n  float* smem = "
                      "reinterpret_cast<float*>(smem4);"),)),
)
ENTRY = """
extern "C" long long parts_workspace(long long n, long long G, long long h) {
  return mo_segment_sum_workspace(n, G, h);
}
extern "C" int parts_launch(const float* v, const int* g, const bool* m,
                            long long n, long long G, long long h, float* s,
                            float* out, void* stream) {
  return (int)mo_segment_sum_launch(v, (const int32_t*)g, m, n, G, h, s,
                                    out, (cudaStream_t)stream);
}
"""


def build_parts(tree: str) -> dict:
    """{part: ctypes library} of the tree's kernel with each part of
    `PARTS` taken out, all built at once."""
    from torch.utils.cpp_extension import CUDA_HOME
    src = open(os.path.join(tree, "matrixone_tpu_torch", "csrc",
                            "segment_sum.cu")).read()
    out = os.path.join(tree, "build", "torch_kernels", "segsum_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in PARTS:
        body = src
        for text, new in edits:
            if body.count(text) != 1:
                raise SystemExit(f"time_segment_sum: part {name}: "
                                 f"{text.strip()!r} is not in the kernel "
                                 f"once")
            body = body.replace(text, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(body + ENTRY)
        procs[name] = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), "-O3",
             "-gencode=arch=compute_90a,code=sm_90a", "-shared",
             "-Xcompiler", "-fPIC", "-cudart", "shared", "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"time_segment_sum: part {name} did not "
                             f"build:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        libs[name].parts_workspace.restype = ctypes.c_longlong
    return libs


def time_parts(torch, CK, timer, libs, name, v, g, m, G) -> dict:
    """{part: device ms a call} of each copy in `libs` on one input set,
    launched with the walk the binding chose for it."""
    walks = CK.LAUNCHES.shapes("segment_sum_walk")
    want = CK.segment_sum(v, g, m, G)
    (head,), = [k for k, c in CK.LAUNCHES.shapes("segment_sum_walk").items()
                if c != walks.get(k, 0)]
    n = v.shape[0]
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    rec = {"shape": name, "n": n, "G": G, "head": head}
    for part, lib in libs.items():
        ws = lib.parts_workspace(ll(n), ll(G), ll(head))

        def call():
            out = torch.empty(G, device="cuda")
            scratch = torch.empty(max(ws, 1), device="cuda")
            err = lib.parts_launch(
                vp(v.data_ptr()), vp(g.data_ptr()), vp(m.data_ptr()), ll(n),
                ll(G), ll(head), vp(scratch.data_ptr()),
                vp(out.data_ptr()),
                vp(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"part {part}: CUDA error {err}")
            return out
        got = call()
        if part == "whole" and not torch.equal(got.view(torch.int32),
                                               want.view(torch.int32)):
            raise AssertionError(f"{name}: the whole copy's sums differ "
                                 f"from the kernel's")
        rec[part] = timer.cuda_time_ms(call)
    return rec


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True,
                    help="chip_smoke.py --save-group-by-inputs' file")
    ap.add_argument("--tree", default=here,
                    help="the checkout whose kernel is timed")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--parts", action="store_true",
                    help="time the kernel's parts instead")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_segment_sum: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's timer and edge inputs, whatever checkout's kernel
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(here, "chip_smoke.py"))
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from matrixone_tpu_torch.ops import cuda_kernels as CK
    if not os.path.abspath(CK.__file__).startswith(tree + os.sep):
        print(f"time_segment_sum: imported {CK.__file__}, not from {tree}",
              file=sys.stderr)
        return 2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    CK.build()

    def measure(name, v, g, m, G, path=False) -> bool:
        got = CK.segment_sum(v, g, m, G)
        same = all(torch.equal(CK.segment_sum(v, g, m, G).view(torch.int32),
                               got.view(torch.int32)) for _ in range(4))
        want = CK.segment_sum_plain(v.double(), g, m, G)
        nan = torch.isnan(want)
        fin = torch.isfinite(want)
        err = (got.double() - want).abs()[fin]
        right = torch.equal(torch.isnan(got), nan) and bool(
            (err <= 1e-4 * want[fin].abs() + 1e-3).all())
        ms = timer.cuda_time_ms(lambda: CK.segment_sum(v, g, m, G))
        slot = torch.where(m & (g >= 0) & (g < G), g.long(), G)
        lib_ms = timer.cuda_time_ms(lambda: torch.zeros(
            G + 1, device="cuda").index_add_(0, slot, v))
        bound_ms, _ = timer.segsum_bound(v.shape[0], G)
        rec = {"tree": tree, "shape": name, "n": v.shape[0], "G": G,
               "right": right, "same_bits_5": same,
               "max_abs_err": float(err.max()) if err.numel() else 0.0,
               "ms": ms, "ms_queued": ms.queued, "index_add_ms": lib_ms,
               "bound_ms": bound_ms, "bound_share": bound_ms / ms}
        if path:
            row = {"shape": name, "ms": ms, "bound_ms": bound_ms}
            rec.update(timer.segsum_cold(torch, CK, row, (v, g, m), G))
            rec["device_us_per_call"] = timer.device_us_per_call(
                torch, lambda: CK.segment_sum(v, g, m, G), calls=20)
        print(json.dumps(rec), flush=True)
        return right

    ok = True
    inputs = torch.load(args.inputs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    if args.parts:
        libs = build_parts(tree)
        sets = [(f"5c_n{n}_G{G}", v.cuda(), g.cuda(), m.cuda(), G)
                for (n, G), (v, g, m) in sorted(inputs.items())]
        n = 65536
        sets.append((f"mid_n{n}_G4096", torch.randn(
            n, generator=gen, device="cuda"), torch.randint(
            0, 4096, (n,), generator=gen, device="cuda",
            dtype=torch.int32), torch.rand(
            n, generator=gen, device="cuda") < 0.8, 4096))
        for rec in (time_parts(torch, CK, timer, libs, *s) for s in sets):
            print(json.dumps(rec), flush=True)
        return 0
    for (n, G), (v, g, m) in sorted(inputs.items()):
        ok &= measure(f"5c_n{n}_G{G}", v.cuda(), g.cuda(), m.cuda(), G,
                      path=True)
    for n in (1, 4000, 4096, 1 << 20, 6_000_000):
        m = torch.rand(n, generator=gen, device="cuda") < 0.8
        v = torch.randn(n, generator=gen, device="cuda")
        for G in (1, 19, 1000, 4096):
            g = torch.randint(0, G, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
            ok &= measure(f"edge_n{n}_G{G}", v, g, m, G)
    for name, v, g, m, G in timer.segsum_edge_inputs(torch, gen):
        ok &= measure(f"edge_{name}", v, g, m, G)
    # what the executor sends between the edges: G = 4096 (its
    # max_groups) over a batch or tail of 16385 to 2^19 rows, and a
    # low-cardinality key (1, 3 or 19 live groups) over 2^20 rows
    for n in (16385, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19):
        m = torch.rand(n, generator=gen, device="cuda") < 0.8
        v = torch.randn(n, generator=gen, device="cuda")
        g = torch.randint(0, 4096, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        ok &= measure(f"mid_n{n}_G4096", v, g, m, 4096)
    n = 1 << 20
    m = torch.rand(n, generator=gen, device="cuda") < 0.8
    v = torch.randn(n, generator=gen, device="cuda")
    for live in (1, 3, 19):
        pick = torch.randperm(4096, generator=gen, device="cuda")[:live]
        g = pick.to(torch.int32)[torch.randint(
            0, live, (n,), generator=gen, device="cuda")]
        ok &= measure(f"hot_n{n}_G4096_live{live}", v, g, m, 4096)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
