"""Live HTTP surface of a running search, job service or fleet
coordinator: ``/metrics``, ``/healthz``, ``/progress`` (also served as
``/status``), ``/subscribers``, ``/jobs``, ``/fleet``, ``/metrics/history``
and ``/alerts``.

The port of the JAX package's server, on the standard library's
``ThreadingHTTPServer`` in a daemon thread; a scrape takes the registry's
locks and nothing else from the chunk loop:

* ``/metrics`` — the live Prometheus text of the process registry, with
  the names manifest's HELP text;
* ``/healthz`` — the :class:`~.health.HealthEngine` verdict and active
  reasons as JSON; HTTP **503 on CRITICAL**, so ``curl -f`` can act on it;
* ``/progress`` and ``/status`` — chunks done and total, ETA, hits,
  certified and quarantined chunks and the live canary summary;
* ``GET /subscribers`` and ``POST /subscribe`` — the alert broker's
  webhook list, and a webhook registered while the run goes on;
* with a :class:`~..beams.service.SurveyService` wired (``service=``),
  the job API: ``POST /jobs`` (201 and ``{"job_id"}``, 400 and
  ``{"error"}`` on a bad spec), ``GET /jobs`` and ``/jobs/<id>``,
  ``POST /jobs/<id>/cancel``;
* with a :class:`~..fleet.coordinator.FleetCoordinator` wired
  (``fleet=``), the fleet's wire protocol, ``POST /fleet/{register,
  lease,complete,release}`` (a ``ValueError`` is a 400 with ``{"error",
  "code"}``), and its read surface, ``GET /fleet/{workers,leases,
  progress,capacity,history}`` and the fleet-aggregated
  ``GET /fleet/metrics``;
* ``GET /metrics/history[?last=N]`` with a
  :class:`~.timeseries.TimeSeriesSampler` wired (``timeseries=``), and
  ``GET /alerts`` with an :class:`~.slo.SLOEngine` (``slo=``).

A route whose object is not wired answers 404.  :func:`start_obs_server`
starts the surface (``port=0`` binds an ephemeral port), the handle's
``close()`` stops it.  A bind failure propagates (an operator who asked
for the surface must not fly blind); a request never raises into the
search.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging_utils import logger
from . import metrics as _metrics

__all__ = ["ObsServer", "start_obs_server"]


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        logger.debug("obs.server: " + fmt, *args)

    def _send(self, status, body, content_type):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    def do_HEAD(self):  # noqa: N802 — http.server API
        self.do_GET()

    def do_GET(self):  # noqa: N802 — http.server API
        srv = self.server.obs  # type: ignore[attr-defined]
        try:
            path, _, query = self.path.partition("?")
            path = path.rstrip("/") or "/"
            if path == "/metrics":
                self._send(200, srv.registry.prometheus_text(
                    manifest_help=True),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics/history":
                self._get_history(srv, query)
            elif path == "/alerts":
                if srv.slo is None:
                    self._send(404, "no SLO engine wired (start the server "
                               "with slo=SLOEngine(...))\n", "text/plain")
                else:
                    self._send(200, json.dumps(srv.slo.alerts_doc(),
                                               indent=1), "application/json")
            elif path == "/healthz":
                doc = srv.health_snapshot()
                status = 503 if doc["status"] == "CRITICAL" else 200
                self._send(status, json.dumps(doc, indent=1),
                           "application/json")
            elif path in ("/progress", "/status"):
                self._send(200, json.dumps(srv.progress_snapshot(),
                                           indent=1), "application/json")
            elif path == "/jobs" or path.startswith("/jobs/"):
                self._get_jobs(srv, path)
            elif path.startswith("/fleet"):
                self._get_fleet(srv, path)
            elif path == "/subscribers":
                if srv.push is None:
                    self._send(404, "no alert broker wired\n", "text/plain")
                else:
                    self._send(200, json.dumps(
                        {"subscribers": srv.push.subscribers_doc(),
                         "stats": srv.push.stats()}, indent=1),
                        "application/json")
            elif path == "/":
                self._send(200, "pulsarutils_tpu_torch live search "
                           "surface: /metrics /metrics/history /alerts "
                           "/healthz /progress /status /jobs /fleet "
                           "/subscribers\n", "text/plain")
            else:
                self._send(404, "not found\n", "text/plain")
        except Exception as exc:  # noqa: BLE001 — never kills the search
            try:
                self._send(500, f"internal error: {exc!r}\n", "text/plain")
            except Exception:  # noqa: BLE001
                pass

    def _get_history(self, srv, query):
        """GET /metrics/history[?last=N]: the time-series ring (the
        endpoint the fleet coordinator's sweep scrapes a worker for)."""
        if srv.timeseries is None:
            self._send(404, "no time-series sampler wired (start the "
                       "server with timeseries=TimeSeriesSampler(...))\n",
                       "text/plain")
            return
        last = None
        for part in query.split("&"):
            key, _, value = part.partition("=")
            if key == "last" and value.isdigit():
                last = int(value)
        self._send(200, json.dumps(srv.timeseries.history_doc(last=last)),
                   "application/json")

    def _get_fleet(self, srv, path):
        """GET /fleet/{workers,leases,progress,capacity,history,metrics}:
        the coordinator's read surface.  ``/fleet/metrics`` is every
        worker's last reported registry snapshot with a ``worker`` label;
        the coordinator's own registry stays on ``/metrics``."""
        if srv.fleet is None:
            self._send(404, "no fleet coordinator wired (start the "
                       "server with fleet=FleetCoordinator(...))\n",
                       "text/plain")
            return
        if path == "/fleet/metrics":
            self._send(200, srv.fleet.fleet_metrics_text(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return
        docs = {"/fleet/workers": srv.fleet.workers_doc,
                "/fleet/leases": srv.fleet.leases_doc,
                "/fleet/progress": srv.fleet.progress_doc,
                "/fleet/capacity": srv.fleet.capacity_doc,
                "/fleet/history": srv.fleet.fleet_history_doc}
        fn = docs.get(path)
        if fn is None:
            self._send(404, "not found\n", "text/plain")
        else:
            self._send(200, json.dumps(fn(), indent=1), "application/json")

    def _post_fleet(self, srv, path):
        """POST /fleet/{register,lease,complete,release}: the fleet wire
        protocol (:mod:`..fleet.protocol`).  A ``ValueError`` is a 400
        with the message, and the :class:`~..fleet.protocol.ProtocolError`
        code when it carries one (``unknown_worker``)."""
        if srv.fleet is None:
            self._send(404, "no fleet coordinator wired\n", "text/plain")
            return
        handlers = {"/fleet/register": srv.fleet.register,
                    "/fleet/lease": srv.fleet.lease,
                    "/fleet/complete": srv.fleet.complete,
                    "/fleet/release": srv.fleet.release}
        fn = handlers.get(path)
        if fn is None:
            self._send(404, "not found\n", "text/plain")
            return
        try:
            doc = fn(self._read_body())
        except ValueError as exc:
            body = {"error": str(exc)}
            code = getattr(exc, "code", None)
            if code is not None:
                body["code"] = str(code)
            self._send(400, json.dumps(body), "application/json")
            return
        self._send(200, json.dumps(doc), "application/json")

    def _get_jobs(self, srv, path):
        """GET /jobs (every job's document, newest first) and
        /jobs/<id> (one)."""
        if srv.service is None:
            self._send(404, "no job service wired (start the server "
                       "with service=SurveyService(...))\n", "text/plain")
            return
        if path == "/jobs":
            self._send(200, json.dumps({"jobs": srv.service.jobs()},
                                       indent=1), "application/json")
            return
        doc = srv.service.get(path[len("/jobs/"):])
        if doc is None:
            self._send(404, "unknown job\n", "text/plain")
        else:
            self._send(200, json.dumps(doc, indent=1), "application/json")

    def _read_body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n).decode() or "{}")

    def do_POST(self):  # noqa: N802 — http.server API
        """``POST /subscribe`` with ``{"url", "name", "min_snr",
        "min_dm", "max_dm"}``: 201 and the subscriber's doc, 400 on a bad
        spec.  With a job service: ``POST /jobs`` with ``{"fname",
        "dmmin", "dmmax", ...}`` (201 and ``{"job_id"}``, 400 and
        ``{"error"}``) and ``POST /jobs/<id>/cancel`` (the job's
        document).  With a fleet coordinator: the four messages under
        ``/fleet/``."""
        srv = self.server.obs  # type: ignore[attr-defined]
        try:
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path.startswith("/fleet"):
                self._post_fleet(srv, path)
                return
            if path == "/subscribe":
                if srv.push is None:
                    self._send(404, "not found\n", "text/plain")
                    return
                try:
                    doc = srv.push.subscribe(self._read_body())
                except ValueError as exc:
                    self._send(400, json.dumps({"error": str(exc)}),
                               "application/json")
                    return
                self._send(201, json.dumps(doc), "application/json")
                return
            if srv.service is None:
                self._send(404, "no job service wired\n", "text/plain")
                return
            if path == "/jobs":
                try:
                    job_id = srv.service.submit(self._read_body())
                except ValueError as exc:
                    self._send(400, json.dumps({"error": str(exc)}),
                               "application/json")
                    return
                self._send(201, json.dumps({"job_id": job_id}),
                           "application/json")
            elif path.startswith("/jobs/") and path.endswith("/cancel"):
                doc = srv.service.cancel(path[len("/jobs/"):-len("/cancel")])
                if doc is None:
                    self._send(404, "unknown job\n", "text/plain")
                else:
                    self._send(200, json.dumps(doc, indent=1),
                               "application/json")
            else:
                self._send(404, "not found\n", "text/plain")
        except Exception as exc:  # noqa: BLE001 — never kills the search
            try:
                self._send(500, f"internal error: {exc!r}\n", "text/plain")
            except Exception:  # noqa: BLE001
                pass


class ObsServer:
    """The live surface around a running search.

    ``health`` is a :class:`~.health.HealthEngine` (or ``None``: then
    ``/healthz`` answers ``OK`` with a note); ``progress_fn`` a zero-arg
    callable returning the ``/progress`` dict; ``push`` an
    :class:`~.push.AlertBroker` (or ``None``); ``service`` a
    :class:`~..beams.service.SurveyService`, ``fleet`` a
    :class:`~..fleet.coordinator.FleetCoordinator`, ``timeseries`` a
    :class:`~.timeseries.TimeSeriesSampler`, ``slo`` an
    :class:`~.slo.SLOEngine` (each ``None``: its routes answer 404);
    ``registry`` the :class:`~.metrics.MetricsRegistry` ``/metrics``
    serves (``None``: the process registry).
    """

    def __init__(self, port=0, health=None, progress_fn=None,
                 registry=None, host="127.0.0.1", service=None,
                 fleet=None, timeseries=None, slo=None, push=None):
        self.health = health
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.push = push
        self.service = service
        self.fleet = fleet
        self.timeseries = timeseries
        self.slo = slo
        self.progress_fn = progress_fn
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http",
            daemon=True)
        self._thread.start()
        logger.info("live search surface on http://%s:%d "
                    "(/metrics /healthz /progress)", host, self.port)

    def health_snapshot(self):
        if self.health is None:
            return {"status": "OK", "reasons": [],
                    "note": "no health engine wired"}
        return self.health.snapshot()

    def progress_snapshot(self):
        doc = {}
        if self.progress_fn is not None:
            try:
                doc = dict(self.progress_fn())
            except Exception as exc:  # noqa: BLE001
                doc = {"error": repr(exc)}
        doc.setdefault("status", self.health.verdict
                       if self.health is not None else "OK")
        return doc

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_obs_server(port, health=None, progress_fn=None, registry=None,
                     host="127.0.0.1", service=None, fleet=None,
                     timeseries=None, slo=None, push=None):
    """Start the live surface; returns the :class:`ObsServer` (its
    ``port`` is the bound port: pass ``port=0`` for an ephemeral one).
    ``host`` is the bind address: the loopback default keeps the surface
    on the machine; ``"0.0.0.0"`` opens it to remote workers and scrapes.
    ``service`` (a :class:`~..beams.service.SurveyService`) adds the job
    API under ``/jobs``; ``fleet`` (a
    :class:`~..fleet.coordinator.FleetCoordinator`) the fleet protocol
    and read routes under ``/fleet/``; ``timeseries`` serves
    ``/metrics/history`` and ``slo`` serves ``/alerts``; ``registry``
    (``None``: the process registry) is what ``/metrics`` serves.  The
    positional order is the JAX package's."""
    return ObsServer(port=port, health=health, progress_fn=progress_fn,
                     registry=registry, host=host, service=service,
                     fleet=fleet, timeseries=timeseries, slo=slo,
                     push=push)
