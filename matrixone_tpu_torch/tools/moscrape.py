"""`python -m matrixone_tpu_torch.tools.moscrape`: the metrics scrape
plane.

The port's copy of the JAX package's `tools/moscrape.py`.  It serves
the process-global `mo_*` registry (`utils/metrics.py`
`REGISTRY.render()`) in Prometheus text exposition format over HTTP
(`GET /metrics`); the same text is available in-band through `select
mo_ctl('metrics','dump')`.

Modes:
  * `--once`: print one scrape to stdout and exit;
  * `--port N`: serve `/metrics` until interrupted (0 = ephemeral; the
    bound port prints as `PORT <n>`);
  * `--demo`: run a tiny embedded workload first so a fresh process
    scrapes non-empty families (on `--device`, CUDA by default).

Embeddable: `serve(port)` returns the live HTTPServer for any service
that wants a sidecar scrape endpoint.
"""

from __future__ import annotations

import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def render_text() -> str:
    from matrixone_tpu_torch.utils import metrics
    return metrics.REGISTRY.render()


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path.rstrip("/") in ("", "/metrics"):
            body = render_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        return


def serve(port: int = 0, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the scrape endpoint on a daemon thread; the caller owns
    shutdown() and server_close()."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="mo-scrape")
    t.start()
    return httpd


def _demo_workload(device=None) -> None:
    """Drive a few metric families so a fresh process scrapes
    something real."""
    from matrixone_tpu_torch.frontend import Session
    s = Session(device=device)
    try:
        s.execute("create table scrape_demo (a bigint, b double)")
        s.execute("insert into scrape_demo values (1, 1.5), (2, 2.5)")
        s.execute("select a, sum(b) from scrape_demo group by a")
    finally:
        s.close()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m matrixone_tpu_torch.tools.moscrape")
    ap.add_argument("--port", type=int, default=0,
                    help="serve GET /metrics on this port (0 = "
                         "ephemeral, printed as PORT <n>)")
    ap.add_argument("--once", action="store_true",
                    help="print one scrape to stdout and exit")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny embedded workload first")
    ap.add_argument("--device", default=None,
                    help="the demo workload's device (default: cuda)")
    args = ap.parse_args(argv)
    if args.demo:
        _demo_workload(args.device)
    if args.once:
        sys.stdout.write(render_text())
        return 0
    httpd = serve(port=args.port)
    print(f"PORT {httpd.server_address[1]}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
