"""Background-thread Prometheus scrape endpoint.

PyTorch counterpart of ``mxnet_tpu/observability/serve.py`` (host code:
the same classes, names and output).

``observability.serve_metrics(port)`` starts a daemon-thread HTTP
server exposing the existing text exposition:

- ``GET /metrics``  -> ``dump_prometheus()`` (text/plain; version 0.0.4)
- ``GET /metrics/cluster`` -> the federated job-scope exposition
  (every rank's series under ``rank="r"`` + aggregates; see
  ``observability/federation.py``)
- ``GET /healthz``  -> ``ok`` (liveness — answers even mid-step, since
  the server thread never touches the device)

Anything else is 404. The env hookup is ``MXTPU_METRICS_PORT=<port>``:
the first ``Context`` creation starts the server (same deferred wiring
as ``MXTPU_COMPILE_CACHE``). ``stop_metrics_server()`` shuts it down
idempotently; starting while already serving returns the live port
(re-binding a second port would double-scrape the same process).
"""

from __future__ import annotations

import logging
import threading

from ..base import getenv

_logger = logging.getLogger("mxnet_tpu_torch.observability")

_SERVER = {"httpd": None, "thread": None, "port": None}
_LOCK = threading.Lock()

#: machine-checked lock protocol (mxtpu-lint thread-guard): the server
#: singleton mutates only under _LOCK — concurrent serve/stop otherwise
#: leaks an orphan httpd thread bound to the port
_GUARDED_BY = {"_SERVER": "_LOCK"}


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?")[0] == "/metrics":
                from . import dump_prometheus

                try:
                    body = dump_prometheus().encode()
                except Exception as e:  # scrape must not kill the server
                    self.send_error(500, f"exposition failed: {e}")
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?")[0] == "/metrics/cluster":
                from .federation import dump_prometheus_cluster

                try:
                    body = dump_prometheus_cluster().encode()
                except Exception as e:  # scrape must not kill the server
                    self.send_error(500, f"cluster exposition failed: {e}")
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?")[0] == "/healthz":
                body = b"ok\n"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):  # scrapes are not app logs
            _logger.debug("metrics server: " + fmt, *args)

    return Handler


def serve_metrics(port=None, host="0.0.0.0") -> int:
    """Start the scrape endpoint on ``port`` (0 = ephemeral) in a
    daemon thread; returns the bound port. Idempotent: if already
    serving, returns the live port without rebinding."""
    from http.server import ThreadingHTTPServer

    with _LOCK:
        if _SERVER["httpd"] is not None:
            return _SERVER["port"]
        if port is None:
            port = int(getenv("MXTPU_METRICS_PORT", 0, dtype=int))
        httpd = ThreadingHTTPServer((host, int(port)), _make_handler())
        httpd.daemon_threads = True
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="mxtpu-metrics", daemon=True)
        thread.start()
        _SERVER.update(httpd=httpd, thread=thread,
                       port=httpd.server_address[1])
        _logger.info("metrics endpoint serving on %s:%d (/metrics, "
                     "/healthz)", host, _SERVER["port"])
        return _SERVER["port"]


def metrics_port():
    """The live scrape port, or None when not serving."""
    return _SERVER["port"]


def stop_metrics_server():
    """Shut the endpoint down. Idempotent — safe to call twice, or
    having never started."""
    with _LOCK:
        httpd, thread = _SERVER["httpd"], _SERVER["thread"]
        _SERVER.update(httpd=None, thread=None, port=None)
    if httpd is None:
        return
    httpd.shutdown()
    httpd.server_close()
    if thread is not None:
        thread.join(timeout=5)


def maybe_serve():
    """Start from ``MXTPU_METRICS_PORT`` when set (first-Context
    wiring); no-op otherwise."""
    port = getenv("MXTPU_METRICS_PORT", None)
    if port is None:
        return None
    try:
        return serve_metrics(int(port))
    except (OSError, ValueError) as e:
        # a typo'd port or an unbindable one must degrade to a warning,
        # never crash the first Context creation it is wired from
        _logger.warning("MXTPU_METRICS_PORT=%s: cannot serve (%s); "
                        "metrics endpoint disabled", port, e)
        return None
