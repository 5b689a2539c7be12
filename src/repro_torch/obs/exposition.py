"""Metrics exposition over HTTP (the port's own copy of
``repro/obs/exposition.py``): ``/metrics`` (Prometheus text) and
``/metrics.json`` (the registry snapshot).

A tiny stdlib server on a daemon thread — no dependency, good enough for
a scrape endpoint (Prometheus polls at seconds granularity; rendering
the registry is microseconds). ``launch/serve.py --metrics-port`` starts
one; anything else (notebooks, benchmarks) can too.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set by server factory

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802  (http.server API)
        if self.path.split("?")[0] in ("/metrics", "/"):
            body = self.registry.render_prometheus().encode()
            self._send(200, body, PROM_CONTENT_TYPE)
        elif self.path.split("?")[0] == "/metrics.json":
            body = json.dumps(self.registry.snapshot(), indent=1,
                              sort_keys=True).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found; try /metrics or /metrics.json",
                       "text/plain")

    def log_message(self, *a):  # silence per-request stderr noise
        pass


class MetricsServer:
    """Threaded scrape endpoint bound to ``(host, port)``; ``port=0``
    picks a free port (read it back from ``.port`` — tests do)."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0"):
        handler = type("BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exposition",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def validate_prometheus_text(text: str) -> int:
    """Parse-check a Prometheus text exposition: every non-comment line
    must be ``name[{labels}] value``, every series must follow a # TYPE
    for its family, histogram families must carry _bucket/_sum/_count.
    Returns the number of samples (CI smoke + tests call this)."""
    import re
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([^ ]+)$")
    typed: dict[str, str] = {}
    n_samples = 0
    hist_parts: dict[str, set] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram"), line
            typed[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        assert m, f"unparseable sample line: {line!r}"
        name, _, value = m.groups()
        assert value in ("+Inf", "-Inf", "NaN") or not any(
            c == " " for c in value)
        float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed \
                    and typed[name[: -len(suffix)]] == "histogram":
                base = name[: -len(suffix)]
                hist_parts.setdefault(base, set()).add(suffix)
        assert base in typed, f"sample {name!r} precedes its # TYPE"
        n_samples += 1
    for base, kind in typed.items():
        if kind == "histogram":
            assert hist_parts.get(base) == {"_bucket", "_sum", "_count"}, (
                f"histogram {base} missing series: "
                f"{hist_parts.get(base)}")
    return n_samples
