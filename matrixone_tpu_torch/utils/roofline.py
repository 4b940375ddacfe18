"""Roofline and MFU instrumentation (the port of
`matrixone_tpu/utils/roofline.py`).

For a function over tensors this module counts the work of one call
(`cost_of`: FLOPs from `torch.utils.flop_counter.FlopCounterMode`, bytes
as the inputs' plus the outputs', each read or written once) and, with a
measured time, the achieved FLOP/s and bytes/s and their ratios to the
card's peaks (`mfu`).

The peaks are one NVIDIA H100 SXM's at its 700 W limit (NVIDIA's data
sheet; the `H100_*` constants, which chip_smoke.py reads from here), given
only when the device is that card; `MO_PEAK_TFLOPS` / `MO_PEAK_GBPS`
override them for any device.  Elsewhere (the CPU) there is no peak: the
utilizations are None and the achieved numbers still trend.  MFU is
achieved FLOP/s over the card's dense bf16 tensor-core peak, as the
reference's is over its chip's bf16 peak, so an f32 function's MFU reads
low by design.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

#: published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
#: dense rates)
H100_BF16_FLOPS = 989e12        # bf16/fp16 on the tensor cores
H100_TF32_FLOPS = 495e12        # TF32 on the tensor cores
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
H100_L2_BYTES = 50 * 2 ** 20


def _is_h100(device=None) -> bool:
    if not torch.cuda.is_available():
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return False
    return "H100" in torch.cuda.get_device_name(dev)


def peak_flops(device=None) -> Optional[float]:
    env = os.environ.get("MO_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    return H100_BF16_FLOPS if _is_h100(device) else None


def peak_bytes_per_s(device=None) -> Optional[float]:
    env = os.environ.get("MO_PEAK_GBPS")
    if env:
        return float(env) * 1e9
    return H100_HBM_BYTES_S if _is_h100(device) else None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def cost_of(fn: Callable, *args, **kwargs) -> dict:
    """The work of one call: {'flops': N, 'bytes': N}.  FLOPs are what
    `FlopCounterMode` counts (matrix products and convolutions; an
    elementwise function counts 0), bytes each input tensor read once and
    each output written once."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(_tensors(args)) + list(_tensors(kwargs))
                 + list(_tensors(out)))
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(nbytes)}


def mfu(flops_per_call: float, bytes_per_call: float,
        calls: float, seconds: float, device=None) -> dict:
    """Achieved rates and utilization against the card's peaks for a
    measured run."""
    if seconds <= 0:
        return {}
    fl = flops_per_call * calls / seconds
    by = bytes_per_call * calls / seconds
    pf, pb = peak_flops(device), peak_bytes_per_s(device)
    out = {
        "achieved_tflops": round(fl / 1e12, 4),
        "achieved_gbps": round(by / 1e9, 2),
        "mfu": round(fl / pf, 4) if pf else None,
        "hbm_util": round(by / pb, 4) if pb else None,
    }
    # arithmetic intensity and the roofline's verdict on what bounds it
    if bytes_per_call > 0 and pf and pb:
        ai = flops_per_call / bytes_per_call
        out["arith_intensity"] = round(ai, 2)
        out["bound"] = "compute" if ai > pf / pb else "memory"
    return out


def report(fn: Callable, args: tuple, calls: float, seconds: float,
           device=None, **kwargs) -> dict:
    """cost_of + mfu in one call, safe in a benchmark's epilogue: any
    failure of the analysis gives {} rather than raising."""
    try:
        c = cost_of(fn, *args, **kwargs)
        return {**c, **mfu(c["flops"], c["bytes"], calls, seconds,
                           device=device)}
    except Exception:                        # noqa: BLE001 — diagnostics
        return {}
