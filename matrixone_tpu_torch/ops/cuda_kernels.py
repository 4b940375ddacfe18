"""The port's hand-written CUDA kernels: loader, wrappers, plain versions.

Counterpart of `matrixone_tpu/ops/pallas_kernels.py`.  Each kernel has

  * its CUDA C++ source under `matrixone_tpu_torch/csrc/`;
  * a wrapper here that checks its inputs, launches it on the current
    stream and counts the launch in `LAUNCHES`;
  * its plain PyTorch version beside it, the function the kernel
    computes written with ordinary tensor ops.  The CPU path and the
    tests run the plain version; on the card it is only the yardstick
    the kernel is compared with.

The sources are compiled on first use with
`torch.utils.cpp_extension.load` into `build/torch_kernels/` under the
repository root, all in one call.  Only `csrc/binding.cpp` includes
PyTorch's headers.  Nothing is built when this module is imported.

Kernels (the TPU kernel each replaces in brackets):
  * `l2_distance_sq`         [`l2_distance_sq_pallas`, pallas_kernels.py:79]
  * `l2_distance_sq_masked`  [`l2_distance_sq_masked_pallas`, :121], the
    same tile as `l2_distance_sq` (csrc/l2_distance.cu) with a row mask
  * `adc_score`              [`adc_score_pallas`, :313], and its list
    form `adc_score_lists`, which reads the codes from the inverted
    lists where they lie (the same kernel body)
  * `sorted_search`          [`sorted_search_pallas`, :250]
  * `segment_sum`            [`segment_sum_pallas`, :177]
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from matrixone_tpu_torch.ops.hash import unsigned_order

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
SOURCES = ("binding.cpp", "l2_distance.cu", "adc_score.cu",
           "sorted_search.cu", "segment_sum.cu")
CUDA_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


class LaunchCounts:
    """Launches of each kernel since the last `reset`, in all and by
    shape: a wrapper adds one where it launches its kernel and nowhere
    else, so a run can show that its path went through the kernels, and
    at which shapes.  The segment sum also counts the walk each launch
    took under "segment_sum_walk".  A wrapper called while a CUDA graph
    is captured launches nothing then: vm/graphs.py records those adds
    on the capturing thread (`recording`) and adds them at each replay
    of the graph."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._shapes = {}
        self._tls = threading.local()

    def add(self, name: str, shape: tuple = (), n: int = 1) -> None:
        rec = getattr(self._tls, "rec", None)
        if rec is not None:          # this thread is capturing a graph
            rec[(name, shape)] = rec.get((name, shape), 0) + n
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            by_shape = self._shapes.setdefault(name, {})
            by_shape[shape] = by_shape.get(shape, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Collect the adds this thread makes in the scope into the
        yielded dict {(name, shape): launches} instead of the counts:
        what a CUDA graph's capture records (vm/graphs.py), kept apart
        from the launches other threads make meanwhile."""
        prev = getattr(self._tls, "rec", None)
        rec: dict = {}
        self._tls.rec = rec
        try:
            yield rec
        finally:
            self._tls.rec = prev

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def shapes(self, name: str) -> dict:
        """{shape: launches} of `name` since the last reset."""
        with self._lock:
            return dict(self._shapes.get(name, {}))

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._shapes.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounts()

_build_lock = threading.Lock()
_built = {"ops": None}


def build():
    """Compile and load every kernel source (once per process) and
    return the `torch.ops.mo_torch` namespace.  Raises if the build
    fails: there is no fallback to the plain versions."""
    with _build_lock:
        if _built["ops"] is not None:
            return _built["ops"]
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        from torch.utils.cpp_extension import load
        os.makedirs(BUILD_DIR, exist_ok=True)
        load(name="mo_torch_kernels",
             sources=[os.path.join(_CSRC, s) for s in SOURCES],
             build_directory=BUILD_DIR,
             extra_cflags=["-O3"],
             extra_cuda_cflags=CUDA_CFLAGS,
             is_python_module=False)
        _built["ops"] = torch.ops.mo_torch
        return _built["ops"]


# ------------------------------------------------ pairwise L2 (fused)
def l2_distance_sq_plain(x: torch.Tensor, q: torch.Tensor,
                         q2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: max(||x||^2 + q2 - 2 x.q, 0) [n, b]
    for x [n, d], q [b, d], q2 [b], in the dtype of the inputs."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    return torch.clamp_min(x2 + q2[None, :] - 2.0 * (x @ q.T), 0.0)


def _check_l2_inputs(name: str, x, q, q2) -> None:
    if not (x.is_cuda and q.is_cuda and q2.is_cuda):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if not (x.dtype == q.dtype == q2.dtype == torch.float32):
        raise TypeError(f"{name} takes float32 x, q and q2")
    if x.dim() != 2 or q.dim() != 2 or q2.dim() != 1 \
            or x.shape[1] != q.shape[1] or q2.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} "
                         f"q {tuple(q.shape)} q2 {tuple(q2.shape)}")
    if not (x.is_contiguous() and q.is_contiguous() and q2.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def l2_distance_sq(x: torch.Tensor, q: torch.Tensor,
                   q2: torch.Tensor) -> torch.Tensor:
    """Launch the fused L2 kernel (csrc/l2_distance.cu) on CUDA f32
    tensors x [n, d], q [b, d], q2 [b] -> [n, b] f32."""
    _check_l2_inputs("l2_distance_sq", x, q, q2)
    out = build().l2_distance_sq(x, q, q2)
    if out.numel():
        LAUNCHES.add("l2_distance_sq",
                     (x.shape[0], q.shape[0], x.shape[1]))
    return out


def l2_kernel_attributes() -> list:
    """What the compiler made of each L2 tile kernel: one dict per
    kernel with its variant (deep: the `wgmma` tile for d > 32, else the
    `mma.sync` tile; vec16: 16-byte loads, else 4-byte), registers,
    static shared bytes, local (spill) bytes and max threads."""
    keys = ("deep", "vec16", "registers", "shared_bytes", "local_bytes",
            "max_threads")
    return [dict(zip(keys, row))
            for row in build().l2_kernel_attributes().tolist()]


# ---------------------------------------- pairwise L2 with a row mask
def l2_distance_sq_masked_plain(x: torch.Tensor, q: torch.Tensor,
                                q2: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the masked kernel: `l2_distance_sq_plain` with
    the rows where mask [n] is false set to +inf."""
    dist = l2_distance_sq_plain(x, q, q2)
    return dist.masked_fill(~mask[:, None], float("inf"))


def l2_distance_sq_masked(x: torch.Tensor, q: torch.Tensor,
                          q2: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Launch the L2 kernel with its row mask (csrc/l2_distance.cu) on
    CUDA f32 x [n, d], q [b, d], q2 [b] and bool mask [n] -> [n, b] f32,
    +inf on masked rows."""
    _check_l2_inputs("l2_distance_sq_masked", x, q, q2)
    if not mask.is_cuda:
        raise ValueError("l2_distance_sq_masked launches on CUDA tensors "
                         "only")
    if mask.dtype != torch.bool:
        raise TypeError("l2_distance_sq_masked takes a bool mask")
    if mask.shape != (x.shape[0],) or not mask.is_contiguous():
        raise ValueError(f"l2_distance_sq_masked: mask must be a "
                         f"contiguous [{x.shape[0]}], got "
                         f"{tuple(mask.shape)}")
    out = build().l2_distance_sq_masked(x, q, q2, mask)
    if out.numel():
        LAUNCHES.add("l2_distance_sq_masked",
                     (x.shape[0], q.shape[0], x.shape[1]))
    return out


# ------------------------------------------------- IVF-PQ ADC scoring
def adc_score_plain(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain version of the ADC kernel's dense form: scores [G, P] with
    scores[g, p] = sum_m lut[g, m, codes[g, p, m]], for codes [G, P, M]
    (any integer type) and lut [G, M, 256], in the lut's dtype."""
    g, p, m = codes.shape
    flat = (codes.to(torch.int64)
            + 256 * torch.arange(m, device=codes.device)).reshape(g, p * m)
    return lut.reshape(g, m * 256).gather(1, flat).reshape(g, p, m).sum(-1)


def _check_adc_inputs(name: str, codes, lut) -> None:
    if not (codes.is_cuda and lut.is_cuda):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if codes.dtype not in (torch.uint8, torch.int32) \
            or lut.dtype != torch.float32:
        raise TypeError(f"{name} takes uint8 or int32 codes and a float32 "
                        f"lut")
    if lut.dim() != 3 or lut.shape[1] < 1 or lut.shape[2] != 256:
        raise ValueError(f"{name}: bad lut shape {tuple(lut.shape)}")
    if not (codes.is_contiguous() and lut.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if codes.dtype == torch.int32 and codes.numel() and bool(
            ((codes < 0) | (codes > 255)).any()):
        raise ValueError(f"{name}: int32 codes must lie in [0, 256)")


def adc_score(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Launch the ADC kernel's dense form (csrc/adc_score.cu) on CUDA
    codes [G, P, M] uint8 or int32 and f32 lut [G, M, 256] -> [G, P]
    f32.  Any P and M >= 1; int32 codes must lie in [0, 256)."""
    _check_adc_inputs("adc_score", codes, lut)
    if codes.dim() != 3 \
            or tuple(lut.shape) != (codes.shape[0], codes.shape[2], 256):
        raise ValueError(f"adc_score: bad shapes codes "
                         f"{tuple(codes.shape)} lut {tuple(lut.shape)}")
    out = build().adc_score(codes, lut)
    if out.numel():
        LAUNCHES.add("adc_score", tuple(codes.shape))
    return out


def adc_score_lists_plain(codes: torch.Tensor, starts: torch.Tensor,
                          ends: torch.Tensor, lut: torch.Tensor,
                          pad: int) -> torch.Tensor:
    """Plain version of the ADC kernel's list form: scores [G, pad] with
    lane p < ends[g] - starts[g] of group g scoring row starts[g] + p of
    codes [n, M] against lut[g], and every other lane +inf: the dense
    form on the padded candidate gather, masked."""
    lane = torch.arange(pad, dtype=torch.int64, device=codes.device)
    cand = starts.to(torch.int64)[:, None] + lane[None, :]     # [G, pad]
    valid = cand < ends.to(torch.int64)[:, None]
    cand = torch.where(valid, cand, torch.zeros_like(cand))
    if codes.shape[0]:
        dist = adc_score_plain(codes[cand], lut)
    else:                                 # no rows: every lane is a pad
        dist = torch.zeros(valid.shape, dtype=lut.dtype, device=lut.device)
    return torch.where(valid, dist, torch.full_like(dist, float("inf")))


def adc_score_lists(codes: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, lut: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """Launch the ADC kernel's list form (csrc/adc_score.cu) on CUDA
    codes [n, M] uint8 or int32, int32 starts [G] and ends [G] (rows
    starts[g] .. ends[g] - 1 of codes; 0 <= starts <= ends <= n) and f32
    lut [G, M, 256] -> [G, pad] f32, +inf past each list's length.  The
    kernel reads the rows where they lie; lists longer than pad are cut
    to pad."""
    _check_adc_inputs("adc_score_lists", codes, lut)
    g = lut.shape[0]
    if codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"adc_score_lists: bad shapes codes "
                         f"{tuple(codes.shape)} lut {tuple(lut.shape)}")
    if not (starts.is_cuda and ends.is_cuda):
        raise ValueError("adc_score_lists launches on CUDA tensors only")
    if starts.dtype != torch.int32 or ends.dtype != torch.int32:
        raise TypeError("adc_score_lists takes int32 starts and ends")
    if starts.shape != (g,) or ends.shape != (g,) \
            or not (starts.is_contiguous() and ends.is_contiguous()):
        raise ValueError(f"adc_score_lists: starts and ends must be "
                         f"contiguous [{g}], got {tuple(starts.shape)} "
                         f"{tuple(ends.shape)}")
    if pad < 0:
        raise ValueError(f"adc_score_lists: pad must be >= 0, got {pad}")
    out = build().adc_score_lists(codes, starts, ends, lut, int(pad))
    if out.numel():
        LAUNCHES.add("adc_score_lists", (g, int(pad), codes.shape[1]))
    return out


# ------------------------------------------- hash-join probe sorted search
#: levels of the sample tree the sorted search stages in a block's shared
#: memory: 2^14 slots of 8 bytes, 128 KB, up to 16383 samples
SORTED_SEARCH_LEVELS = 14


def sorted_search_plan(n: int):
    """(stride, samples, levels) of the sorted-search kernel for n sorted
    keys: every stride-th key, samples = ceil(n / stride) of them, is
    staged as a perfect binary tree of `levels` levels (2^levels - 1 >=
    samples slots, the rest UINT64_MAX) in shared memory; when n fits,
    all of them (stride 1)."""
    cap = (1 << SORTED_SEARCH_LEVELS) - 1
    stride = 1 if n <= cap else -(-n // cap)
    samples = -(-n // stride)
    return stride, samples, samples.bit_length()


def sorted_search_plain(sorted_vals: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the sorted-search kernel: searchsorted-left
    positions [m] int32 of queries [m] in sorted_vals [n], both int64
    bit patterns of uint64 hashes compared in UNSIGNED order (the sign
    bit flipped on both sides makes signed order equal unsigned order)."""
    return torch.searchsorted(unsigned_order(sorted_vals),
                              unsigned_order(queries), side="left",
                              out_int32=True)


def sorted_search(sorted_vals: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """Launch the sorted-search kernel (csrc/sorted_search.cu) on CUDA
    int64 sorted_vals [n] (ascending as uint64) and queries [m] -> [m]
    int32 positions.  Any n < 2^31 and m; m = 0 launches nothing."""
    if not (sorted_vals.is_cuda and queries.is_cuda):
        raise ValueError("sorted_search launches on CUDA tensors only")
    if sorted_vals.dtype != torch.int64 or queries.dtype != torch.int64:
        raise TypeError("sorted_search takes int64 (uint64 bit pattern) "
                        "sorted values and queries")
    if sorted_vals.dim() != 1 or queries.dim() != 1:
        raise ValueError(f"sorted_search: bad shapes sorted "
                         f"{tuple(sorted_vals.shape)} queries "
                         f"{tuple(queries.shape)}")
    if not (sorted_vals.is_contiguous() and queries.is_contiguous()):
        raise ValueError("sorted_search takes contiguous tensors")
    stride, samples, levels = sorted_search_plan(sorted_vals.shape[0])
    out = build().sorted_search(sorted_vals, queries, stride, samples,
                                levels)
    if out.numel():
        LAUNCHES.add("sorted_search",
                     (sorted_vals.shape[0], queries.shape[0]))
    return out


# --------------------------------------------- GROUP BY float segment sum
SEGMENT_SUM_MAX_GROUPS = 4096


def segment_sum_plain(values: torch.Tensor, gids: torch.Tensor,
                      mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of the segment-sum kernel: out[g] = sum of values
    over the rows with mask and gid g, for g < num_segments, in the
    values' dtype.  Masked rows and gids outside [0, num_segments) go to
    one extra slot that is dropped."""
    g = gids.to(torch.int64)
    slot = torch.where(mask & (g >= 0) & (g < num_segments), g,
                       num_segments)
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, slot, values)
    return out[:num_segments]


def segment_sum(values: torch.Tensor, gids: torch.Tensor,
                mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Launch the segment-sum kernel (csrc/segment_sum.cu) on CUDA f32
    values [n], int32 gids [n] and bool mask [n] -> [num_segments] f32,
    for 1 <= num_segments <= 4096: the same bits on every launch on one
    card.  n = 0 launches nothing.  Besides its launch, it counts the walk
    the binding chose under "segment_sum_walk", keyed by its head row:
    0-3 for the 16-byte walk, -1 for the scalar one (views misaligned by
    different amounts)."""
    if not (values.is_cuda and gids.is_cuda and mask.is_cuda):
        raise ValueError("segment_sum launches on CUDA tensors only")
    if values.dtype != torch.float32 or gids.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise TypeError("segment_sum takes float32 values, int32 gids and "
                        "a bool mask")
    n = values.shape[0]
    if values.dim() != 1 or gids.shape != (n,) or mask.shape != (n,):
        raise ValueError(f"segment_sum: bad shapes values "
                         f"{tuple(values.shape)} gids {tuple(gids.shape)} "
                         f"mask {tuple(mask.shape)}")
    if not 1 <= num_segments <= SEGMENT_SUM_MAX_GROUPS:
        raise ValueError(f"segment_sum takes 1 <= num_segments <= "
                         f"{SEGMENT_SUM_MAX_GROUPS}, got {num_segments}")
    if not (values.is_contiguous() and gids.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("segment_sum takes contiguous tensors")
    out, head = build().segment_sum(values, gids, mask, int(num_segments))
    if n:
        LAUNCHES.add("segment_sum", (n, int(num_segments)))
        LAUNCHES.add("segment_sum_walk", (head,))
    return out
