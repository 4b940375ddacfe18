"""The port's roofline instrumentation (utils/roofline.py) on the cases
of tests/test_roofline.py: the cost of a matrix product, the MFU fields
under overridden peaks, and a report that never raises.  On the CPU the
card's peaks are absent (None); the environment overrides them."""

import pytest
import torch

from matrixone_tpu_torch.utils import roofline


def test_cost_of_matmul():
    a = torch.ones((256, 128), dtype=torch.float32)
    b = torch.ones((128, 64), dtype=torch.float32)
    c = roofline.cost_of(lambda x, y: x @ y, a, b)
    # FlopCounterMode counts 2*M*N*K exactly; bytes: both inputs read
    # once and the output written once
    assert c["flops"] == 2 * 256 * 128 * 64
    assert c["bytes"] == 4 * (256 * 128 + 128 * 64 + 256 * 64)


def test_mfu_fields(monkeypatch):
    monkeypatch.delenv("MO_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("MO_PEAK_GBPS", raising=False)
    if not torch.cuda.is_available():
        # the H100's peaks are given only on that card
        assert roofline.peak_flops() is None
        assert roofline.mfu(1e12, 1e9, 10, 1.0)["mfu"] is None
    monkeypatch.setenv("MO_PEAK_TFLOPS", "100")
    monkeypatch.setenv("MO_PEAK_GBPS", "800")
    out = roofline.mfu(flops_per_call=1e12, bytes_per_call=1e9,
                       calls=10, seconds=1.0)
    assert out["achieved_tflops"] == 10.0
    assert out["mfu"] == 0.1
    assert out["achieved_gbps"] == 10.0
    assert out["hbm_util"] == 0.0125
    assert out["bound"] == "compute"   # AI=1000 > 100e12/800e9=125
    assert roofline.mfu(1.0, 1.0, 1, 0.0) == {}


def test_report_never_raises():
    out = roofline.report(lambda x: torch.sort(x).values,
                          (torch.ones(64),), calls=1, seconds=0.5)
    assert isinstance(out, dict) and out["bytes"] == 2 * 64 * 4

    def broken(x):
        raise RuntimeError("no cost model for this")
    assert roofline.report(broken, (torch.ones(4),), calls=1,
                           seconds=0.5) == {}
    with pytest.raises(RuntimeError):
        roofline.cost_of(broken, torch.ones(4))
