"""Metric exposition: Prometheus text format, stdlib HTTP endpoint, and
the unified append-only JSONL sink.

No third-party dependencies — the exposition is text-format 0.0.4
rendered from :class:`~repro_torch.obs.registry.MetricsRegistry`, served by a
daemon-threaded ``http.server`` so a scrape never blocks the tick loop
(the GIL handoff happens during device execution / host numpy work).
"""
from __future__ import annotations

import http.server
import json
import math
import os
import threading
from typing import Optional

from .registry import Counter, Gauge, Histogram, MetricsRegistry


def _fmt(v: float) -> str:
    """Prometheus sample value: integers bare, +Inf/NaN spelled out."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for n, v in zip(names, values))
    return "{" + inner + "}"


def render_prometheus(reg: MetricsRegistry) -> str:
    """Text-format 0.0.4 exposition; families sorted by name, cells by
    label values, so the output is deterministic (golden-file tested)."""
    lines = []
    for m in reg.metrics():
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key in sorted(m._cells):
                cell = m._cells[key]
                cum = 0
                for le, n in zip(m.buckets, cell["counts"]):
                    cum += int(n)
                    lab = _labels(m.labelnames + ("le",), key + (_fmt(le),))
                    lines.append(f"{m.name}_bucket{lab} {cum}")
                lab = _labels(m.labelnames + ("le",), key + ("+Inf",))
                lines.append(f"{m.name}_bucket{lab} {cell['n']}")
                lab = _labels(m.labelnames, key)
                lines.append(f"{m.name}_sum{lab} {_fmt(cell['sum'])}")
                lines.append(f"{m.name}_count{lab} {cell['n']}")
        elif isinstance(m, (Counter, Gauge)):
            for key in sorted(m._cells):
                lab = _labels(m.labelnames, key)
                lines.append(f"{m.name}{lab} {_fmt(m._cells[key])}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """``/metrics`` on a daemon thread.  ``port=0`` binds an ephemeral
    port (read it back from :attr:`port` — what the tests and the example
    scrape).  ``close()`` shuts the listener down; the service calls it
    from :meth:`FlaasService.close`."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = render_prometheus(outer.registry).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-scrape stderr noise
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="flaas-metrics",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class JsonlSink:
    """Append-only JSON-lines sink with a persistent handle.

    Replaces a per-chunk ``open(path, "a")`` dance: records are
    flushed as written (a reader tailing the file sees every completed
    chunk) and ``close()`` fsyncs, so an orderly shutdown cannot lose the
    tail of the last chunk.  Pre-existing files are appended to, never
    truncated — restarts and checkpoint-restores keep one continuous
    stream."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f: Optional[open] = open(self.path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        # deferred import: repro_torch.service.server imports this module, so a
        # module-level import of repro_torch.service here would be circular
        from ..service.telemetry import json_safe
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._f.write(json.dumps(json_safe(record), allow_nan=False) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
