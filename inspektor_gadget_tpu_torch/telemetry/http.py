"""Prometheus exposition over a tiny stdlib HTTP endpoint.

The agent opts in with --metrics-addr (off by default — the reference's
otel-metrics-listen-address contract): GET /metrics renders the process
registry in text format 0.0.4, GET /healthz answers a JSON liveness
document (status/uptime/scrape count — what a probe or a human curl
wants to know: is it up, since when, is anyone scraping it).
ThreadingHTTPServer on a daemon thread; scrapes never touch the gRPC
workers.

The port's copy of ``inspektor_gadget_tpu/telemetry/http.py``, over the
port's own `REGISTRY`. Address ``127.0.0.1:0`` binds a free port (read
it back from `MetricsServer.port`).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import REGISTRY, Registry


def parse_addr(addr: str) -> tuple[str, int]:
    """'host:port', '[v6]:port', ':port', or bare 'port' → (host, port)."""
    host, sep, port = addr.rpartition(":")
    if not sep:
        host, port = "", addr
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # bracketed IPv6 literal
    try:
        return host or "0.0.0.0", int(port)
    except ValueError:
        raise ValueError(f"bad metrics address {addr!r}: "
                         "expected host:port or :port") from None


class MetricsServer:
    def __init__(self, addr: str, registry: Registry | None = None):
        self.host, self.port = parse_addr(addr)
        self.registry = registry if registry is not None else REGISTRY
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._started_at = 0.0
        self.scrapes = 0  # /metrics GETs served since start()

    def start(self) -> "MetricsServer":
        registry = self.registry
        server = self
        self._started_at = time.monotonic()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                if self.path.split("?", 1)[0] == "/metrics":
                    server.scrapes += 1
                    body = registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?", 1)[0] == "/healthz":
                    body = (json.dumps({
                        "status": "ok",
                        "uptime": round(
                            time.monotonic() - server._started_at, 3),
                        "scrapes": server.scrapes,
                    }) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        class Server(ThreadingHTTPServer):
            # stdlib default is AF_INET-only; honor IPv6 literals
            address_family = (socket.AF_INET6 if ":" in self.host
                              else socket.AF_INET)

        self._server = Server((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
