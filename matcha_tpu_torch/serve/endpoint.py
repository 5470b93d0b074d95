"""The health/serving endpoint: fleet status over stdlib HTTP.

Port of ``matcha_tpu/serve/endpoint.py``.  Three routes, all JSON, all
read-only:

* ``/healthz`` — the **same verdict** ``obs_torch.py watch --once`` exits
  with (``obs.health.fleet_verdict``; parity pinned by test): HTTP 200
  when the fleet is healthy (exit code 0), 503 when any host is flagged
  (1) or no heartbeat evidence exists yet (2).  Load balancers and
  process supervisors gate on this.
* ``/status`` — the controller's supervision state (trainer alive,
  lifetimes, restart budget) plus the fleet-status digest.
* ``/promoted`` — the current promotion manifest, **verified** on every
  read (``serve.promote.verify_promoted``): a tampered artifact returns
  503 with the reason, never the manifest.

Multi-tenant by construction: the server holds a ``{name: Controller}``
map, so two supervised runs sharing one machine share one endpoint —
``?run=<name>`` selects; with a single run the parameter is optional.

Stdlib ``ThreadingHTTPServer`` on a daemon thread: zero dependencies,
and the handlers only stat and read files — they never touch the
trainer's device work (the trainer is another process).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["ServeEndpoint"]


class ServeEndpoint:
    """HTTP facade over one or more controllers.

    ``runs`` maps run name → an object with ``.status() -> dict``,
    ``.run_dir`` and ``.serving_dir`` attributes (a
    ``serve.controller.Controller``, or anything quacking like one —
    the tests drive it with a stub).
    """

    def __init__(self, runs: Dict[str, object], host: str = "127.0.0.1",
                 port: int = 0):
        if not runs:
            raise ValueError("ServeEndpoint needs at least one run")
        self.runs = dict(runs)
        endpoint = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: the journal is the log
                pass

            def do_GET(self):
                endpoint._handle(self)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ServeEndpoint":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve-endpoint",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -------------------------------------------------------------- routing
    def _select(self, query) -> Optional[object]:
        names = query.get("run")
        if names:
            return self.runs.get(names[0])
        if len(self.runs) == 1:
            return next(iter(self.runs.values()))
        return None  # ambiguous: multi-tenant needs ?run=

    def _handle(self, handler) -> None:
        parsed = urlparse(handler.path)
        query = parse_qs(parsed.query)
        run = self._select(query)
        if parsed.path not in ("/healthz", "/status", "/promoted"):
            self._reply(handler, 404, {"error": f"no route {parsed.path}",
                                       "routes": ["/healthz", "/status",
                                                  "/promoted"]})
            return
        if run is None:
            self._reply(handler, 404, {
                "error": "unknown or unspecified run (multi-tenant "
                         "endpoints need ?run=<name>)",
                "runs": sorted(self.runs)})
            return
        if parsed.path == "/healthz":
            self._healthz(handler, run)
        elif parsed.path == "/status":
            self._status(handler, run)
        else:
            self._promoted(handler, run)

    def _healthz(self, handler, run) -> None:
        from ..obs import fleet_verdict

        rc, status = fleet_verdict(run.run_dir)
        body = {"ok": rc == 0, "verdict": rc}
        if status is not None:
            body["flagged"] = bool(status.get("flagged"))
            body["anomalies"] = status.get("anomalies", [])
            body["hosts"] = sorted(status.get("hosts", {}))
        else:
            body["reason"] = f"no heartbeat evidence under {run.run_dir}"
        self._reply(handler, 200 if rc == 0 else 503, body)

    def _status(self, handler, run) -> None:
        body = dict(run.status())
        from ..obs import fleet_verdict

        rc, status = fleet_verdict(run.run_dir)
        body["fleet_verdict"] = rc
        if status is not None:
            body["fleet"] = {
                "hosts": sorted(status.get("hosts", {})),
                "flagged": bool(status.get("flagged")),
                "anomalies": len(status.get("anomalies", [])),
            }
        self._reply(handler, 200, body)

    def _promoted(self, handler, run) -> None:
        from .promote import PromotionTampered, verify_promoted

        try:
            manifest = verify_promoted(run.serving_dir)
        except PromotionTampered as e:
            self._reply(handler, 503, {"error": str(e), "verified": False})
            return
        self._reply(handler, 200, {"verified": True, "manifest": manifest})

    @staticmethod
    def _reply(handler, code: int, body: dict) -> None:
        payload = json.dumps(body, sort_keys=True).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)
