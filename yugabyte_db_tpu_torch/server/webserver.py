"""Embedded HTTP server: /metrics (Prometheus), /varz, /healthz, /memz,
JSON endpoints, and HTML dashboards.

Reference analog: src/yb/server/webserver.cc + the path handlers
(default-path-handlers.cc, master/tserver-path-handlers.cc, assets in
www/): every daemon exposes its metrics registry, flag table, memory
stats, and per-daemon dashboards over HTTP.

The port's copy of the JAX package's ``server/webserver.py``, whole.
``/healthz`` reads the port's breakers (``storage.breaker.health_report``)
and ``/memz`` its residency cache (``HbmCache.stats()``); the
compressed-plane accounting (``plane_stats_snapshot``) is not fed in the
port yet (ROADMAP.md §1 item 16), and ``/memz`` leaves it out through the
JAX page's own ``ImportError`` tolerance.
"""

from __future__ import annotations

import html as _html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.metrics import MetricRegistry

_STYLE = """<style>
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
table{border-collapse:collapse;margin:1em 0}
th,td{border:1px solid #ccc;padding:4px 10px;text-align:left;
      font-size:14px}
th{background:#f0f3f7}
h1{font-size:20px} a{color:#2459a8}
nav a{margin-right:1em}
</style>"""


def _healthz() -> dict:
    """"ok" when every circuit breaker in the process is closed;
    otherwise "degraded" plus one entry per quarantined path (e.g. a
    TPU engine serving from the host while its device path recovers) —
    the JSON twin of the ``yb_engine_degraded`` gauge."""
    try:
        from yugabyte_db_tpu_torch.storage.breaker import health_report

        return health_report()
    except ImportError:
        return {"status": "ok"}


def _memz() -> dict:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"max_rss_kb": ru.ru_maxrss, "user_time_s": ru.ru_utime,
           "system_time_s": ru.ru_stime}
    try:
        from yugabyte_db_tpu_torch.utils.memtracker import root_tracker

        out["trackers"] = root_tracker().dump()
    except ImportError:
        pass
    try:
        from yugabyte_db_tpu_torch.storage.residency import hbm_cache

        # budget / resident / pinned / pool breakdown for the HBM
        # residency cache (the device-subtree numbers above are the
        # MemTracker view of the same bytes).
        out["hbm_cache"] = hbm_cache().stats()
    except ImportError:
        pass
    try:
        from yugabyte_db_tpu_torch.utils.metrics import plane_stats_snapshot

        # Compressed-plane accounting (--tpu_plane_encoding): per-tablet
        # stored vs logical plane bytes, broken down by encoding kind —
        # the host-side twin of hbm_cache's by_encoding residency split.
        out["plane_encoding"] = plane_stats_snapshot()
    except ImportError:
        pass
    return out


class Webserver:
    def __init__(self, registry: MetricRegistry, daemon_name: str = ""):
        self.registry = registry
        self.daemon_name = daemon_name
        self._handlers = {}
        self._dashboards: list[tuple[str, str]] = []  # (path, title)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.add_json_handler("/healthz", _healthz)
        self.add_json_handler("/varz", lambda: {
            f.name: {"value": f.value, "default": f.default,
                     "help": f.help, "tags": sorted(f.tags)}
            for f in FLAGS.all()})
        self.add_json_handler("/memz", _memz)
        from yugabyte_db_tpu_torch.utils.trace import TRACE_EVENTS, dump_stacks

        self.add_json_handler("/tracing.json", TRACE_EVENTS.dump)
        self.add_handler("/stacks", dump_stacks)
        self.add_handler("/", self._home, content_type="text/html")

    def add_handler(self, path: str, fn, content_type="text/plain"):
        """fn() -> str served at ``path``."""
        self._handlers[path] = (fn, content_type)

    def add_json_handler(self, path: str, fn):
        self.add_handler(path, lambda: json.dumps(fn(), indent=1,
                                                  default=str),
                         content_type="application/json")

    def add_dashboard(self, path: str, title: str, fn):
        """Register an HTML table dashboard at ``path`` rendering
        fn() -> list[dict] (the JSON shape the API endpoints serve);
        reference: the master/tserver path-handler dashboards."""
        self._dashboards.append((path, title))
        self.add_handler(path, lambda: self._render_table(title, fn()),
                         content_type="text/html")

    def _nav(self) -> str:
        links = [("/", "home"), ("/metrics", "metrics"),
                 ("/varz", "varz"), ("/memz", "memz")]
        links += [(p, t) for p, t in self._dashboards]
        extra = [(p, p.strip("/")) for p in self._handlers
                 if p not in {x[0] for x in links} and p != "/"]
        return "<nav>" + "".join(
            f'<a href="{p}">{_html.escape(t)}</a>'
            for p, t in links + sorted(extra)) + "</nav>"

    def _home(self) -> str:
        return (f"<html><head><title>{_html.escape(self.daemon_name)}"
                f"</title>{_STYLE}</head><body>"
                f"<h1>{_html.escape(self.daemon_name)}</h1>"
                f"{self._nav()}</body></html>")

    def _render_table(self, title: str, rows: list[dict]) -> str:
        cols: list[str] = []
        for r in rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        body = "".join(
            "<tr>" + "".join(
                f"<td>{_html.escape(str(r.get(c, '')))}</td>"
                for c in cols) + "</tr>"
            for r in rows)
        head = "".join(f"<th>{_html.escape(c)}</th>" for c in cols)
        return (f"<html><head><title>{_html.escape(title)}</title>{_STYLE}"
                f"</head><body><h1>{_html.escape(title)} — "
                f"{_html.escape(self.daemon_name)}</h1>{self._nav()}"
                f"<table><tr>{head}</tr>{body}</table>"
                f"<p>{len(rows)} row(s)</p></body></html>")

    def start(self, host: str = "127.0.0.1",
              port: int = 0) -> tuple[str, int]:
        ws = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = ws.registry.prometheus_text()
                    # Cross-cutting process-wide series (swallowed
                    # errors, serving-path batch histograms) render on
                    # every daemon's scrape — they have no daemon
                    # registry of their own.
                    from yugabyte_db_tpu_torch.utils.metrics import \
                        process_registry

                    if process_registry() is not ws.registry:
                        body += process_registry().prometheus_text()
                    ctype = "text/plain; version=0.0.4"
                elif path in ws._handlers:
                    fn, ctype = ws._handlers[path]
                    try:
                        body = fn()
                    except Exception as e:  # noqa: BLE001
                        self.send_error(500, str(e))
                        return
                else:
                    self.send_error(404)
                    return
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"webserver-{self.daemon_name}", daemon=True)
        self._thread.start()
        return self._httpd.server_address[:2]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
