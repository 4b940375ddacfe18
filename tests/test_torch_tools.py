"""The port's operator tools: the scrape endpoint
(`matrixone_tpu_torch/tools/moscrape.py`) and the trace smoke gate
(`tools/motrace.py`), as tests/test_motrace.py holds the JAX package's
(`test_moscrape_http_endpoint`, `test_trace_smoke_gate`)."""

import subprocess
import sys
import urllib.request

from matrixone_tpu_torch.frontend import Session
from matrixone_tpu_torch.tools import moscrape, motrace as smoke
from matrixone_tpu_torch.utils import metrics as M, motrace


def test_moscrape_http_endpoint():
    s = Session(device="cpu")
    s.execute("create table ms (a bigint)")
    s.close()
    httpd = moscrape.serve(port=0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "# TYPE mo_query_duration_seconds histogram" in body
        assert "# TYPE mo_scan_rows_total counter" in body
        assert body.splitlines()[0] == M.REGISTRY.render().splitlines()[0]
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
            raise AssertionError("a path other than /metrics answered")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_moscrape_once_prints_one_scrape():
    out = subprocess.run(
        [sys.executable, "-m", "matrixone_tpu_torch.tools.moscrape",
         "--once", "--demo", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert "# TYPE mo_query_duration_seconds histogram" in out
    assert 'mo_scan_rows_total{table="scrape_demo"} 2' in out


def test_trace_smoke_gate():
    """The smoke runs green on the port's session and restores the
    tracer's state."""
    was = motrace.TRACER.armed
    rep = smoke.run_smoke(device="cpu")
    assert rep["ok"], rep["errors"]
    assert rep["spans"] >= 3 and rep["chrome_events"] >= 4
    assert rep["traces"] >= 3
    assert motrace.TRACER.armed == was
    assert smoke.main(["--device", "cpu"]) == 0
