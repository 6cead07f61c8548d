"""Scrape endpoint over a live telemetry stream: ``python -m dopt_torch.obs.serve``.

Promotes the ``PrometheusSink`` text snapshot into a real HTTP scrape
surface for long soak runs: a stdlib ``http.server`` that tails a
growing metrics JSONL file (byte-offset watermark — each request
processes only the bytes appended since the last one) and serves

* ``GET /metrics``  — Prometheus text exposition: latest round
  metrics and gauges (``engine_kind``-labelled), fault counters, and
  ``dopt_alerts_total`` from the attached ``HealthMonitor``;
* ``GET /healthz``  — the monitor's live ``HealthReport`` verdict as
  JSON; HTTP 200 while the verdict is healthy/warn/empty, 503 once a
  critical rule fired (the shape load balancers and soak harnesses
  poll).

Stdlib-only (no torch): point it at a metrics file copied off a GPU
host or written live by a local run::

    python -m dopt_torch.run --preset baseline1 --rounds 1000 \
        --metrics-out metrics.jsonl &
    python -m dopt_torch.obs.serve metrics.jsonl --port 8000
    curl localhost:8000/metrics
    curl localhost:8000/healthz
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

from dopt_torch.obs.monitor import HealthMonitor, JsonlTail
from dopt_torch.obs.rules import Rule
from dopt_torch.obs.sinks import PrometheusSink

# Backoff hint every dopt HTTP surface sends on 503: the endpoint is
# critical or still attaching, not gone — poll again, don't hammer.
RETRY_AFTER_S = 5


def http_reply(handler: BaseHTTPRequestHandler, code: int, body: bytes,
               ctype: str, *, retry_after_s: int = RETRY_AFTER_S) -> None:
    """The ONE reply path of every dopt scrape/admin handler
    (dopt_torch.obs.serve, dopt_torch.obs.aggregate, dopt_torch.serve.admin): status,
    Content-Type/-Length, and the ``Retry-After`` header on every 503
    — a header tweak lands on all three surfaces at once."""
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    if code == 503:
        handler.send_header("Retry-After", str(retry_after_s))
    handler.end_headers()
    handler.wfile.write(body)


class MetricsServer:
    """Tail a metrics JSONL file and serve /metrics + /healthz.

    ``port=0`` binds an ephemeral port (read it back from ``.port``
    after ``start()``) — the smoke-test mode.  Each request refreshes
    the tail under a lock, so concurrent scrapes see a consistent
    snapshot and the file is read incrementally, never re-parsed."""

    def __init__(self, metrics_path: str | Path, *,
                 host: str = "127.0.0.1", port: int = 0,
                 rules: list[Rule] | None = None,
                 workers: int | None = None):
        self.metrics_path = Path(metrics_path)
        self.monitor = HealthMonitor(rules, workers=workers)
        self.prom = PrometheusSink()
        self._tail = JsonlTail(self.metrics_path)
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def refresh(self) -> None:
        """Process the bytes appended since the previous refresh."""
        with self._lock:
            for ev in self._tail.poll():
                self.prom.emit(ev)
                for alert in self.monitor.observe(ev):
                    self.prom.emit(alert)

    def render_metrics(self) -> str:
        self.refresh()
        return self.prom.render()

    def render_health(self) -> tuple[int, str]:
        self.refresh()
        report = self.monitor.report()
        body = report.to_dict()
        body["metrics_path"] = str(self.metrics_path)
        # The monitor's own staleness: wall seconds since the newest
        # event in the stream.  A healthy-but-idle producer and a
        # stalled one report the same verdict; the lag tells them
        # apart (null before the first event).
        body["last_event_ts"] = self.monitor.last_event_ts
        body["lag_seconds"] = self.monitor.lag_seconds()
        return (200 if report.ok else 503), json.dumps(body, indent=2)

    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    body = server.render_metrics().encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    code, text = server.render_health()
                    self._reply(code, text.encode(), "application/json")
                elif path == "/":
                    self._reply(200, b"dopt_torch.obs.serve: /metrics /healthz\n",
                                "text/plain")
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                http_reply(self, code, body, ctype)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass  # scrapes every few seconds would flood stderr

        return Handler

    def start(self) -> "MetricsServer":
        """Serve in a daemon thread (the smoke-test / embedded mode)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("metrics", metavar="METRICS_JSONL",
                    help="telemetry stream to tail (may not exist yet — "
                         "the tail waits for it)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="bind port; 0 binds an EPHEMERAL port — the "
                         "chosen one is announced on stdout (one JSON "
                         "line) and in --state-file, so soak harnesses "
                         "and embedding daemons never fixed-port race")
    ap.add_argument("--workers", type=int, default=None,
                    help="fleet-size denominator override for rules "
                         "(normally recovered from the stream's run "
                         "header)")
    ap.add_argument("--state-file", default=None, metavar="PATH",
                    help="write {host, port, pid, metrics} here "
                         "(atomically) once bound; removed on clean "
                         "shutdown")
    args = ap.parse_args(argv)

    server = MetricsServer(args.metrics, host=args.host, port=args.port,
                           workers=args.workers)
    # The bound port goes to STDOUT as one JSON line (stderr keeps the
    # human banner): `PORT=$(... | head -1 | jq .port)` just works,
    # including under --port 0.
    print(json.dumps({"host": args.host, "port": server.port,
                      "metrics": str(args.metrics), "pid": os.getpid()}),
          flush=True)
    if args.state_file:
        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(args.state_file, json.dumps(
            {"host": args.host, "port": server.port, "pid": os.getpid(),
             "metrics": str(args.metrics)}, indent=2))
    print(f"serving {args.metrics} on http://{args.host}:{server.port} "
          f"(/metrics, /healthz)", file=sys.stderr)

    def _term(signum, frame):
        # Graceful SIGTERM: unwind through the KeyboardInterrupt path
        # so the finally block closes the socket and removes the state
        # file — embedding daemons and soak harnesses can stop the
        # endpoint without leaking the port.
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if args.state_file:
            try:
                os.unlink(args.state_file)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
