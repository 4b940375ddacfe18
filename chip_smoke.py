#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`matrixone_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 1M x 768, 1024 queries

Phases, each of which raises on failure:

 1. environment: torch/CUDA versions, the card's name and power limit,
    and the build of every CUDA kernel from `matrixone_tpu_torch/csrc/`;
 2. every kernel against its plain PyTorch version (in float64) at edge
    shapes (the L2 kernel, its masked form, the ADC kernel), then, in
    phases 3 and 4, at every shape each path launched it with, on that
    path's own inputs; each timed with CUDA events beside the plain
    version, one library call and the bound;
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
 4. IVF-PQ at `bench.py`'s IVF-PQ configuration, on the same data,
    queries and truth: the build and one search run of all queries each
    counted (the search must launch the ADC and L2 kernels); probed-list
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
       them with, on the inputs those paths handed them.
   Phase 2 also holds the two relational kernels against their plain
   versions at edge shapes (bit for bit for the search).

The second-to-last line of output is the kernels' JSON record and the
last is {"ok": true, "device": {...}}.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12

K = 20
NPROBE = 8
BATCH = 256
QUERY_CHUNK = 64
TRUTH_CHUNK = 65536
INF = float("inf")


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, warm: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def l2_bound(n: int, b: int, d: int, extra_bytes: int = 0):
    """(ms, 'bytes'|'operations'): the least time of one fused L2 call
    (`extra_bytes`: a mask's)."""
    t_ops = 2.0 * n * b * d / H100_F32_FLOPS
    t_bytes = (4.0 * (n * d + b * d + n * b) + extra_bytes) \
        / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    ms = cuda_time_ms(lambda: CK.l2_distance_sq(x, q, q2))
    plain_ms = cuda_time_ms(lambda: CK.l2_distance_sq_plain(x, q, q2))
    lib_ms = cuda_time_ms(lambda: torch.mm(x, q.T))
    bound_ms, bound_by = l2_bound(n, b, d)
    row = {"shape": name, "n": n, "b": b, "d": d,
           "max_abs_err": float(err.max()), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] l2_distance_sq {name:14s} n={n} b={b} d={d} "
        f"err={row['max_abs_err']:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} cublas_mm_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
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
    ms = cuda_time_ms(lambda: CK.l2_distance_sq_masked(x, q, q2, mask))
    plain_ms = cuda_time_ms(
        lambda: CK.l2_distance_sq_masked_plain(x, q, q2, mask))
    drop = ~mask[:, None]
    lib_ms = cuda_time_ms(lambda: torch.mm(x, q.T).masked_fill_(drop, INF))
    bound_ms, bound_by = l2_bound(n, b, d, extra_bytes=n)
    row = {"shape": name, "n": n, "b": b, "d": d,
           "kept": int(mask.sum()), "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] l2_distance_sq_masked {name:18s} n={n} b={b} d={d} "
        f"kept={row['kept']} err={max_err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} cublas_mm+masked_fill_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
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


def phase_edges(torch, CK, seed: int):
    """Each kernel vs its plain version at edge shapes, on seeded random
    input -> (L2 rows, masked L2 rows, ADC rows)."""
    shapes = [("n1", 1, 256, 768), ("b1", 4480, 1, 768),
              ("d100", 4480, 256, 100), ("n1000", 1000, 256, 768)]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows, masked = [], []
    for name, n, b, d in shapes + [("truth_chunk", TRUTH_CHUNK, 256, 768)]:
        x = torch.randn(n, d, generator=g, device="cuda")
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
                        nprobe: int) -> np.ndarray:
    """Exact top-k among the rows of each query's nprobe nearest lists,
    scored in float64 from what the index stores, with the search's own
    formula: ||c-q||^2 + ||r||^2 + 2 r.c - 2 r.q, r the stored bf16
    residual and q rounded to bf16 as the search's compute dtype rounds
    it, both widened.  The score stage may lose none of these."""
    ids = idx.ids.cpu().numpy().astype(np.int64)
    rn = idx.r_norm2.cpu().double().numpy()
    rc = idx.r_dot_c.cpu().double().numpy()
    qb = torch.from_numpy(q_np).to(torch.bfloat16).double().numpy()
    out = np.empty((len(q_np), k), np.int64)
    for i, q in enumerate(q_np.astype(np.float64)):
        cd, pos, owner = probed_rows(idx, q, nprobe)
        r = idx.vectors[torch.from_numpy(pos).to(idx.device)]
        r = r.double().cpu().numpy()
        score = cd[owner] + rn[pos] + 2.0 * rc[pos] - 2.0 * (r @ qb[i])
        out[i] = ids[pos[np.argsort(score, kind="stable")[:k]]]
    return out


def pq_probed_truth(torch, idx, q_np: np.ndarray, k: int,
                    nprobe: int) -> np.ndarray:
    """Exact top-k ADC score among the rows of each query's nprobe
    nearest lists, in float64 on the host: the query residual and the
    codebooks rounded to bf16 as the search rounds them for the LUT
    product, both widened; ||q_r||^2 and ||codebook||^2 from f32, as
    the search takes them.  This checks the port's LUT, gather, ADC and
    top-k, not PQ's quantisation."""
    cents32 = idx.centroids.cpu().numpy()
    ids = idx.ids.cpu().numpy().astype(np.int64)
    codes = idx.codes.cpu().numpy().astype(np.int64)          # [n, M]
    cb32 = idx.codebooks.cpu()                                # [M, 256, ds]
    cbb = cb32.to(torch.bfloat16).double().numpy()
    cb2 = (cb32.double().numpy() ** 2).sum(-1)                # [M, 256]
    m_sub, _, ds = cbb.shape
    out = np.empty((len(q_np), k), np.int64)
    for i, q in enumerate(q_np):
        cd, pos, owner = probed_rows(idx, q.astype(np.float64), nprobe)
        lists = np.unique(owner)
        qr = (q[None, :] - cents32[lists]).reshape(len(lists), m_sub, ds)
        qrb = torch.from_numpy(qr).to(torch.bfloat16).double().numpy()
        qr2 = (qr.astype(np.float64) ** 2).sum(-1)            # [L, M]
        lut = (qr2[:, :, None] + cb2[None]
               - 2.0 * np.einsum("lmd,mjd->lmj", qrb, cbb))   # [L, M, 256]
        li = np.searchsorted(lists, owner)
        score = lut[li[:, None], np.arange(m_sub)[None, :],
                    codes[pos]].sum(1)
        out[i] = ids[pos[np.argsort(score, kind="stable")[:k]]]
    return out


def profile_run(torch, fn, label: str) -> dict:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us,
           "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}
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
    kernels = ("l2_distance_sq", "adc_score")
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
    report["build_launches"] = kernel_launches(CK, "4a build", kernels,
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

    # 4a: one search run of all queries, counted
    CK.LAUNCHES.reset()
    found = torch.cat(run_all()).cpu().numpy()
    report["search_launches"] = kernel_launches(
        CK, "4a search", kernels, required=kernels)
    l2_shapes = CK.LAUNCHES.shapes("l2_distance_sq")
    adc_shapes = CK.LAUNCHES.shapes("adc_score")
    rows += check_path_shapes(torch, CK, "4_probe", l2_shapes,
                              index.centroids, queries)
    adc_rows = []
    for (g, p, m), c in sorted(adc_shapes.items()):
        qn = g // NPROBE                    # the chunk's queries
        pc = ivf_pq._probe(index, queries[:qn], NPROBE)
        lut, _, _, codes = ivf_pq.adc_inputs(index, queries[:qn], pc,
                                             torch.bfloat16)
        adc_rows.append(dict(check_adc(
            torch, CK, f"4_search_G{g}", codes.reshape(g, p, m),
            lut.reshape(g, m, 256).contiguous()),
            path="4_search", path_launches=c))
        del lut, codes
    torch.cuda.empty_cache()

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


def check_sorted_search(torch, CK, name: str, srt, q) -> dict:
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
    ms = cuda_time_ms(lambda: CK.sorted_search(srt, q))
    plain_ms = cuda_time_ms(lambda: CK.sorted_search_plain(srt, q))
    from matrixone_tpu_torch.ops.hash import unsigned_order
    sf, qf = unsigned_order(srt), unsigned_order(q)
    lib_ms = cuda_time_ms(lambda: torch.searchsorted(sf, qf,
                                                     out_int32=True))
    bound_ms, bound_by = search_bound(n, m)
    row = {"shape": name, "n": n, "m": m, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] sorted_search {name:22s} n={n} m={m} bit-identical "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} searchsorted_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def check_segment_sum(torch, CK, name: str, values, gids, mask,
                      g: int) -> dict:
    """The segment-sum kernel against its plain version in f64: exact
    when the values are integer-valued and every group sum stays below
    2^24, else |err| <= 1e-4 |want| + 1e-3 (the reference's tolerance);
    timed beside the plain version in f32 and `index_add_` into G + 1
    slots (the masked rows' slot precomputed)."""
    n = values.shape[0]
    got = CK.segment_sum(values, gids, mask, g)
    torch.cuda.synchronize()
    want = CK.segment_sum_plain(values.double(), gids, mask, g)
    err = (got.double() - want).abs()
    max_err = float(err.max()) if g else 0.0
    exact = bool(torch.equal(values, values.round())) \
        and float(CK.segment_sum_plain(values.double().abs(), gids, mask,
                                       g).max()) < (1 << 24)
    ok = (torch.equal(got.double(), want) if exact
          else bool((err <= 1e-4 * want.abs() + 1e-3).all()))
    if got.shape != (g,) or got.dtype != torch.float32 or not ok:
        raise AssertionError(f"segment_sum {name} n={n} G={g}: max err "
                             f"{max_err} ({'exact' if exact else 'tol'})")
    ms = cuda_time_ms(lambda: CK.segment_sum(values, gids, mask, g))
    plain_ms = cuda_time_ms(
        lambda: CK.segment_sum_plain(values, gids, mask, g))
    slot = torch.where(mask, gids.long(), g)
    lib_ms = cuda_time_ms(lambda: torch.zeros(
        g + 1, device=values.device).index_add_(0, slot, values))
    bound_ms, bound_by = segsum_bound(n, g)
    row = {"shape": name, "n": n, "G": g, "exact": exact,
           "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] segment_sum {name:22s} n={n} G={g} "
        f"{'exact' if exact else f'err={max_err:.3e}'} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} index_add_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def phase_relational_edges(torch, CK, seed: int):
    """Phase 2 for the relational kernels: the sorted search bit for bit
    on sorted uint64 hashes with a duplicate run and UINT64_MAX (NULL)
    sentinels, queries drawn from them plus random ones plus 0, 1 and
    2^64 - 1; the segment sum on integer-valued and N(0,1) values with a
    0.8 Bernoulli mask (masked rows keep gids of live groups)."""
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
    torch.cuda.empty_cache()
    return search, segsum


class PathInputs:
    """Records, for one run of a path, the inputs the path hands the
    sorted-search and segment-sum kernels: one capture per launch shape,
    keyed as `LAUNCHES` keys them.  It wraps the two seam functions and
    calls the real ones, so the path's launches are unchanged."""

    def __init__(self, torch, TK):
        self.torch, self.TK = torch, TK
        self.search, self.segsum = {}, {}

    def __enter__(self):
        torch, TK = self.torch, self.TK
        self._real = (TK.sorted_lookup, TK.grouped_scatter_add)
        real_lookup, real_scatter = self._real

        def lookup(sorted_hash, queries):
            key = (sorted_hash.shape[0], queries.shape[0])
            if key not in self.search:
                self.search[key] = (sorted_hash.contiguous().clone(),
                                    queries.contiguous().clone())
            return real_lookup(sorted_hash, queries)

        def scatter(values, gids, mask, max_groups, use_pallas=False):
            key = (values.shape[0], max_groups)
            if use_pallas and values.dtype == torch.float32 \
                    and max_groups <= 4096 and values.shape[0] \
                    and key not in self.segsum:
                self.segsum[key] = (values.contiguous().clone(),
                                    gids.to(torch.int32).contiguous(),
                                    mask.contiguous().clone())
            return real_scatter(values, gids, mask, max_groups,
                                use_pallas=use_pallas)

        TK.sorted_lookup, TK.grouped_scatter_add = lookup, scatter
        return self

    def __exit__(self, *exc):
        self.TK.sorted_lookup, self.TK.grouped_scatter_add = self._real
        return False


def table_host_bytes(table) -> int:
    return sum(a.nbytes for seg in table.segments
               for a in list(seg.arrays.values())
               + list(seg.validity.values()))


def run_sql(torch, session, sql: str):
    t0 = time.perf_counter()
    rows = session.execute(sql).rows()
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def sql_path(torch, CK, TK, label: str, session, sql: str, n_rows: int,
             check, kernel: str):
    """One query on the card: the cold run (checked), the counted warm
    run with its kernel inputs captured (checked; `kernel` must launch),
    the best of 3 warm runs as rows/s of `n_rows`, and one profiled run."""
    rows, cold_s = run_sql(torch, session, sql)
    check(rows)
    CK.LAUNCHES.reset()
    with PathInputs(torch, TK) as cap:
        rows, _ = run_sql(torch, session, sql)
    launches = kernel_launches(
        CK, label, ("sorted_search", "segment_sum", "l2_distance_sq",
                    "adc_score"), required=(kernel,))
    check(rows)
    warm = [run_sql(torch, session, sql)[1] for _ in range(3)]
    prof = profile_run(torch, lambda: session.execute(sql), label)
    out = {"cold_seconds": cold_s, "warm_seconds": warm,
           "rows_per_sec_best": n_rows / min(warm),
           "launches": launches, "profile": prof}
    log(f"[{label}] cold {cold_s:.3f}s warm {['%.3f' % w for w in warm]} "
        f"best {out['rows_per_sec_best']:.0f} rows/s")
    return out, cap


def phase_sql(torch, CK, args):
    """Phase 5: TPC-H Q3 and the float GROUP BY at scale factor 1."""
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.ops import kernels as TK
    from matrixone_tpu_torch.sql import plan as P
    from matrixone_tpu_torch.storage.engine import Engine, TableMeta
    from matrixone_tpu_torch.utils import tpch

    report = {}
    eng = Engine()
    t0 = time.perf_counter()
    lineitem = tpch.load_lineitem(eng, args.sf1_lineitem, seed=args.seed)
    q3data = tpch.load_tpch_q3(eng, args.sf1_lineitem // 4, seed=args.seed)
    load_q3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_v = args.sf1_lineitem
    rng = np.random.default_rng(args.seed)
    ids = np.arange(n_v, dtype=np.int64)
    v = {"id": ids, "grp": ids % 1000,
         "xi": rng.integers(0, 16, n_v).astype(np.float32),
         "xn": rng.standard_normal(n_v).astype(np.float32)}
    eng.create_table(TableMeta("v", [("id", dt.INT64), ("grp", dt.INT64),
                                     ("xi", dt.FLOAT32), ("xn", dt.FLOAT32)],
                               ["id"]))
    eng.get_table("v").insert_numpy(v)
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
    plan = P.explain(session.plan(tpch.Q3_SQL))
    log("[5b] the port's Q3 plan:\n" + plan)
    oracle = tpch.q3_oracle(lineitem, q3data)
    epoch = __import__("datetime").date(1970, 1, 1)

    def check_q3(rows):
        got = [(r[0], round(r[1] * 10000), (r[2] - epoch).days)
               for r in rows]
        if len(rows) != 10 or got != oracle:
            raise AssertionError(f"5b Q3 rows differ from q3_oracle: "
                                 f"{got[:3]} vs {oracle[:3]}")

    report["q3"], q3cap = sql_path(torch, CK, TK, "5b Q3", session,
                                   tpch.Q3_SQL, args.sf1_lineitem,
                                   check_q3, "sorted_search")
    report["q3"]["plan"] = plan
    log(f"[5b] Q3 rows exactly q3_oracle's; top row {oracle[0]}")

    grp = v["grp"]
    xi_exact = np.bincount(grp, weights=v["xi"].astype(np.int64),
                           minlength=1000)
    xn_f64 = np.bincount(grp, weights=v["xn"].astype(np.float64),
                         minlength=1000)
    gb_err = {}

    def check_group_by(rows):
        if [r[0] for r in rows] != list(range(1000)):
            raise AssertionError("5c GROUP BY: wrong groups")
        if [r[1] for r in rows] != xi_exact.tolist():
            raise AssertionError("5c sum(xi) is not the exact integer sum")
        got = np.asarray([r[2] for r in rows], np.float64)
        err = np.abs(got - xn_f64)
        gb_err["sum_xn_max_abs_err"] = float(err.max())
        if (err > 1e-4 * np.abs(xn_f64) + 1e-3).any():
            raise AssertionError(f"5c sum(xn) max err {err.max()} past "
                                 f"rtol 1e-4 / atol 1e-3")

    report["group_by"], gbcap = sql_path(
        torch, CK, TK, "5c GROUP BY", session, GROUP_BY_SQL, n_v,
        check_group_by, "segment_sum")
    report["group_by"].update(gb_err)
    if {g for _, g in CK.LAUNCHES.shapes("segment_sum")} != {4096}:
        raise AssertionError("5c: the segment-sum kernel ran at "
                             f"{CK.LAUNCHES.shapes('segment_sum')}, not "
                             f"only at G = 4096")
    log(f"[5c] 1000 groups, sum(xi) exact, sum(xn) max err "
        f"{gb_err['sum_xn_max_abs_err']:.3e} of the f64 sum")

    # 5d: each kernel at each shape its path launched it with
    q3_counts = {tuple(r[:-1]): r[-1] for r in
                 report["q3"]["launches"]["sorted_search"]["by_shape"]}
    gb_counts = {tuple(r[:-1]): r[-1] for r in
                 report["group_by"]["launches"]["segment_sum"]["by_shape"]}
    search_rows = [dict(check_sorted_search(torch, CK, f"5b_q3_n{n}_m{m}",
                                            *q3cap.search[(n, m)]),
                        path="5b_q3", path_launches=c)
                   for (n, m), c in sorted(q3_counts.items())]
    segsum_rows = [dict(check_segment_sum(torch, CK, f"5c_n{n}_G{g}",
                                          *gbcap.segsum[(n, g)], g),
                        path="5c_group_by", path_launches=c)
                   for (n, g), c in sorted(gb_counts.items())]
    del q3cap, gbcap
    torch.cuda.empty_cache()
    return report, search_rows, segsum_rows


GROUP_BY_SQL = ("select grp, sum(xi), sum(xn) from v group by grp "
                "order by grp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--sf1-lineitem", type=int, default=6_000_000,
                    help="lineitem rows of phase 5 (TPC-H SF1: 6M); "
                         "orders get a quarter, customer a fortieth")
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

    rows, masked_rows, adc_rows = phase_edges(torch, CK, args.seed)
    search_rows, segsum_rows = phase_relational_edges(torch, CK, args.seed)
    report, path_rows, ctx = phase_path(torch, CK, args)
    report["ivf_pq"], pq_rows, pq_adc_rows = phase_pq(torch, CK, args, ctx)
    report["sql"], search_path, segsum_path = phase_sql(torch, CK, args)
    search_rows += search_path
    segsum_rows += segsum_path
    rows += path_rows + pq_rows
    adc_rows += pq_adc_rows
    pq_build = report["ivf_pq"]["build_launches"]
    pq_search = report["ivf_pq"]["search_launches"]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # each kernel's main path speaks for it at its most launched shape:
    # the served IVF-Flat path for L2, the IVF-PQ search for ADC; the
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
            "4_pq_search": pq_search["l2_distance_sq"]["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{key: l2_row[key] for key in timed},
        "shapes": rows}, {
        "name": "adc_score", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/adc_score.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:313",
        "launches": pq_search["adc_score"]["launches"],
        "launches_by_path": {
            "4_pq_search": pq_search["adc_score"]["launches"],
            "4_pq_build": pq_build["adc_score"]["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in adc_rows),
        **{key: adc_row[key] for key in timed},
        "library_call": "lut.gather(1, idx).sum(-1): two calls",
        "shapes": adc_rows}, {
        "name": "l2_distance_sq_masked", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/l2_distance.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:121",
        "launches": 0, "launches_by_path": {},
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
        "launches_by_path": {p: v["sorted_search"]["launches"]
                             for p, v in sql_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in search_rows),
        **{key: search_row[key] for key in timed},
        "library_call": "torch.searchsorted on pre-flipped int64",
        "shapes": search_rows}, {
        "name": "segment_sum", "route": "cuda",
        "source": "matrixone_tpu_torch/csrc/segment_sum.cu",
        "replaces": "matrixone_tpu/ops/pallas_kernels.py:177",
        "launches": sql_launches["5c_group_by"]["segment_sum"]["launches"],
        "launches_by_path": {p: v["segment_sum"]["launches"]
                             for p, v in sql_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in segsum_rows),
        **{key: segsum_row[key] for key in timed},
        "library_call": "index_add_ into G + 1 slots",
        "shapes": segsum_rows}]}
    log(json.dumps({"path": report}))
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
