"""Admin + observability HTTP endpoint for the resident trainer — the
port's copy of dopt's ``dopt.serve.admin``.

One stdlib ``ThreadingHTTPServer`` per daemon (leader process), bound
``port=0``-ephemeral by default (the chosen port lands in the status
file and ``GET /admin/status``):

* ``GET  /metrics``          Prometheus exposition from the IN-PROCESS
                             sink (no file tailing: the
                             ``dopt_torch.obs.serve`` endpoint inside
                             the daemon);
* ``GET  /healthz``          the in-process ``HealthMonitor``'s live
                             verdict; 200 healthy/warn, 503 critical;
* ``GET  /admin/status``     daemon snapshot (round, paused, cadence,
                             restarts, pending command ids);
* ``GET  /admin/config``     the effective whitelisted config;
* ``GET  /admin/membership`` present/away workers + the directive log;
* ``POST /admin/config``     ``{"key": "optim.lr", "value": 0.05,
                             "at_round": 12?}`` — queue a whitelisted
                             config change;
* ``POST /admin/membership`` ``{"worker": 3, "action": "leave"}``;
* ``POST /admin/checkpoint`` checkpoint at the next boundary;
* ``POST /admin/drain``      ``{"restart": true?}`` — drain the run
                             (optionally asking for a re-exec);
* ``POST /admin/pause`` / ``POST /admin/resume``  — admission control;
* ``POST /admin/profile``    ``{"rounds": K}`` — arm an on-demand
                             ``torch.profiler`` capture for the next
                             K rounds; the daemon writes a Chrome-trace
                             artifact (device trace merged with the
                             host spans) under ``<state>/profile/``.
                             GET returns the capture status +
                             artifact paths.  Pure observability: NOT
                             a queued command, never ledgered, and
                             pinned to leave History / fault ledger /
                             canonical stream bit-identical;
* every 503 carries a ``Retry-After`` header and a JSON body, and
  ``/healthz`` includes the monitor's own ``lag_seconds`` (wall since
  the newest event) so a stalled producer is distinguishable from a
  healthy idle one.

Command POSTs append to the command queue and return 202 with the
command id; commands take effect at the next eligible round boundary
and are ledgered there — the endpoint never mutates training state
directly, so everything it does is replayable from the applied ledger.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from dopt_torch.serve.control import make_command

_POST_COMMANDS = {
    "/admin/config": "config",
    "/admin/membership": "membership",
    "/admin/checkpoint": "checkpoint",
    "/admin/drain": "drain",
    "/admin/pause": "pause",
    "/admin/resume": "resume",
}

_HELP = (b"dopt serve admin: GET /metrics /healthz /admin/status "
         b"/admin/config /admin/membership /admin/profile; POST "
         b"/admin/config /admin/membership /admin/checkpoint "
         b"/admin/drain /admin/pause /admin/resume /admin/profile\n")


class AdminServer:
    """The daemon's HTTP surface; lifecycle owned by ``ServeDaemon``."""

    def __init__(self, daemon, *, host: str = "127.0.0.1", port: int = 0):
        self.daemon = daemon
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "AdminServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- request handling ---------------------------------------------
    def _get(self, path: str) -> tuple[int, bytes, str]:
        d = self.daemon
        if path == "/":
            return 200, _HELP, "text/plain"
        if path == "/metrics":
            if d.prom is None:
                return (503, b'{"error": "telemetry not attached"}\n',
                        "application/json")
            return (200, d.prom.render().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path == "/healthz":
            if d.monitor is None:
                return 503, b'{"error": "monitor not attached"}\n', \
                    "application/json"
            report = self._report()
            body = report.to_dict()
            body["serve"] = d.snapshot()
            # The monitor's own staleness (wall seconds since the
            # newest event): a stalled producer and a healthy idle one
            # report the same verdict — the lag tells them apart.
            body["last_event_ts"] = d.monitor.last_event_ts
            body["lag_seconds"] = d.monitor.lag_seconds()
            return (200 if report.ok else 503,
                    json.dumps(body, indent=2).encode(), "application/json")
        if path == "/admin/status":
            return (200, json.dumps(d.snapshot(), indent=2).encode(),
                    "application/json")
        if path == "/admin/config":
            return (200, json.dumps(d.config_snapshot(), indent=2).encode(),
                    "application/json")
        if path == "/admin/membership":
            return (200, json.dumps(d.membership_snapshot(),
                                    indent=2).encode(), "application/json")
        if path == "/admin/profile":
            return (200, json.dumps(d.profile_status(),
                                    indent=2).encode(), "application/json")
        return 404, b"not found\n", "text/plain"

    def _report(self):
        # The monitor is fed from the training thread; a dict resize
        # mid-copy is survivable by retrying (GIL makes each op atomic,
        # just not the aggregate).
        for _ in range(3):
            try:
                return self.daemon.monitor.report()
            except RuntimeError:
                continue
        return self.daemon.monitor.report()

    def _post(self, path: str, body: dict[str, Any]) -> tuple[int, bytes]:
        if path == "/admin/profile":
            # NOT a queued command: profiling is observability, must
            # never enter the applied ledger (a profiled run replays
            # identically to an unprofiled one).
            try:
                status = self.daemon.request_profile(
                    body.get("rounds", 1))
            except (TypeError, ValueError) as e:
                return 400, json.dumps({"error": str(e)}).encode() + b"\n"
            return 202, json.dumps(
                {"armed": True, **status}).encode() + b"\n"
        cmd_kind = _POST_COMMANDS.get(path)
        if cmd_kind is None:
            return 404, b'{"error": "not found"}\n'
        try:
            cmd = make_command(
                cmd_kind,
                id=body.get("id"),
                at_round=body.get("at_round"),
                key=body.get("key"),
                value=body.get("value"),
                worker=body.get("worker"),
                action=body.get("action"),
                restart=body.get("restart"),
            )
            cmd = self.daemon.submit(cmd)
        except ValueError as e:
            return 400, json.dumps({"error": str(e)}).encode() + b"\n"
        return 202, json.dumps(
            {"queued": cmd.get("id"),
             "applies": ("at the first boundary >= round "
                         f"{cmd['at_round']}" if "at_round" in cmd
                         else "at the next round boundary")}).encode() + b"\n"

    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                code, body, ctype = server._get(path)
                self._reply(code, body, ctype)

            def do_POST(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply(400, json.dumps(
                        {"error": f"bad JSON body: {e}"}).encode() + b"\n",
                        "application/json")
                    return
                code, out = server._post(path, body)
                self._reply(code, out, "application/json")

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                from dopt_torch.obs.serve import http_reply

                http_reply(self, code, body, ctype)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass   # scrapes would flood the daemon's stderr

        return Handler
