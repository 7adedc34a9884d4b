"""Zero-dependency stats endpoint + live cluster dashboard, copied from
``repro.cluster.dashboard``.

A stdlib :mod:`http.server` attached to the Router — the repo's first
outward-facing port, deliberately paving the HTTP-front-door roadmap
item.  Four read-only GET routes:

* ``/metrics``          — Prometheus text exposition of the merged
  cluster snapshot (``tracing.prometheus_text``);
* ``/timeseries.json``  — the windowed view of the
  :class:`~repro_torch.cluster.timeseries.TimeSeriesStore` (rates, windowed
  percentiles, EWMAs; bounded payload, no raw rings);
* ``/slo.json``         — burn-rate alert states and error budgets
  (:meth:`~repro_torch.cluster.slo.SLOEngine.status`);
* ``/dash``             — a self-contained HTML page with inline-SVG
  sparklines per stage/kind, server-side rendered on each request (meta
  refresh; no JavaScript frameworks, no external assets).

Trust boundary: the server binds ``127.0.0.1`` by default, serves GET
only, renders JSON/text/HTML it generated itself, and nothing in this
module touches ``pickle`` — exposing it beyond localhost is an explicit
operator decision (``host=``), not a default.

There is also a terminal renderer (:func:`render_watch`) for
``serve.py --watch`` — the same numbers without the browser.
"""
from __future__ import annotations

import html
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.timeseries import TimeSeriesStore
from repro_torch.cluster.tracing import prometheus_text

__all__ = ["StatsServer", "render_dash", "render_watch"]


# ----------------------------------------------------------------------
# Formatting helpers

def _fmt_s(v: Optional[float]) -> str:
    """Human seconds: 12µs / 3.4ms / 1.2s."""
    if v is None or not math.isfinite(v):
        return "–"
    if v <= 0:
        return "0"
    if v < 1e-3:
        return f"{v * 1e6:.0f}µs"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _fmt_rate(v: Optional[float]) -> str:
    if v is None or not math.isfinite(v):
        return "–"
    if v >= 100:
        return f"{v:.0f}/s"
    return f"{v:.1f}/s"


# ----------------------------------------------------------------------
# Inline-SVG sparkline (server-side rendered, no scripts)

def _spark_svg(points: Sequence[Tuple[float, float]],
               width: int = 220, height: int = 48,
               color: str = "var(--series-1)",
               fmt=lambda v: f"{v:.3g}",
               title: str = "") -> str:
    """One sparkline: 2px round-capped line over a 10%-opacity area wash,
    an end-dot (r=4) with a 2px surface ring, and native ``<title>``
    hover targets per point.  Values render in ink tokens beside the
    mark, never in the series color."""
    pts = [(t, v) for t, v in points if math.isfinite(v)]
    if len(pts) < 2:
        return (f'<svg class="spark" width="{width}" height="{height}" '
                f'role="img"><text x="4" y="{height - 6}" '
                f'class="muted">no data yet</text></svg>')
    t0, t1 = pts[0][0], pts[-1][0]
    vmax = max(v for _, v in pts)
    vmin = min(0.0, min(v for _, v in pts))
    span_t = (t1 - t0) or 1.0
    span_v = (vmax - vmin) or 1.0
    pad_top, pad_bot = 6, 6
    usable = height - pad_top - pad_bot

    def xy(t: float, v: float) -> Tuple[float, float]:
        x = (t - t0) / span_t * (width - 12) + 2
        y = height - pad_bot - (v - vmin) / span_v * usable
        return round(x, 1), round(y, 1)

    coords = [xy(t, v) for t, v in pts]
    line = " ".join(f"{x},{y}" for x, y in coords)
    base_y = height - pad_bot
    area = (f"2,{base_y} " + line + f" {coords[-1][0]},{base_y}")
    ex, ey = coords[-1]
    hovers = "".join(
        f'<circle cx="{x}" cy="{y}" r="7" fill="transparent">'
        f"<title>{html.escape(fmt(v))}</title></circle>"
        for (x, y), (_, v) in zip(coords, pts))
    label = html.escape(title) or "sparkline"
    return (
        f'<svg class="spark" width="{width}" height="{height}" role="img" '
        f'aria-label="{label}">'
        f'<line x1="2" y1="{base_y}" x2="{width - 2}" y2="{base_y}" '
        f'class="axis"/>'
        f'<polygon points="{area}" fill="{color}" fill-opacity="0.1"/>'
        f'<polyline points="{line}" fill="none" stroke="{color}" '
        f'stroke-width="2" stroke-linecap="round" '
        f'stroke-linejoin="round"/>'
        f'<circle cx="{ex}" cy="{ey}" r="6" fill="var(--surface-1)"/>'
        f'<circle cx="{ex}" cy="{ey}" r="4" fill="{color}"/>'
        f"{hovers}</svg>")


_STYLE = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 16px 20px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--text-primary);
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --muted: #898781; --grid: #e1e0d9; --baseline: #c3c2b7;
  --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6; --series-2: #eb6834;
  --status-good: #0ca30c; --status-critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  body {
    --surface-1: #1a1a19; --page: #0d0d0d;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --muted: #898781; --grid: #2c2c2a; --baseline: #383835;
    --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #d95926;
  }
}
h1 { font-size: 18px; font-weight: 600; margin: 0 0 2px; }
.sub { color: var(--text-secondary); font-size: 12px; margin: 0 0 16px; }
.muted { fill: var(--muted); color: var(--muted); font-size: 11px; }
.axis { stroke: var(--baseline); stroke-width: 1; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 16px; }
.tile {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 10px 14px; min-width: 130px;
}
.tile .label { font-size: 12px; color: var(--text-secondary); }
.tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
.tile .hint { font-size: 11px; color: var(--muted); margin-top: 2px; }
.grid { display: grid; gap: 12px;
        grid-template-columns: repeat(auto-fill, minmax(250px, 1fr)); }
.card {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 10px 12px;
}
.card .name { font-size: 12px; color: var(--text-secondary);
              margin-bottom: 2px; overflow-wrap: anywhere; }
.card .now { font-size: 16px; font-weight: 600; }
.card .now small { font-weight: 400; color: var(--muted); font-size: 11px; }
.slo-row { display: flex; gap: 8px; align-items: baseline;
           font-size: 13px; padding: 3px 0; }
.slo-state { font-weight: 600; font-size: 12px; }
.slo-state.firing { color: var(--status-critical); }
.slo-state.ok { color: var(--status-good); }
section h2 { font-size: 13px; font-weight: 600; margin: 18px 0 8px;
             color: var(--text-secondary);
             text-transform: uppercase; letter-spacing: 0.04em; }
table.tbl { border-collapse: collapse; font-size: 12px;
            background: var(--surface-1); border: 1px solid var(--border);
            border-radius: 8px; }
table.tbl th, table.tbl td {
  text-align: right; padding: 4px 10px;
  border-bottom: 1px solid var(--grid);
  font-variant-numeric: tabular-nums;
}
table.tbl th { color: var(--text-secondary); font-weight: 600; }
table.tbl td:first-child, table.tbl th:first-child { text-align: left; }
.legend { display: flex; gap: 14px; font-size: 11px;
          color: var(--text-secondary); margin: 4px 0 2px; }
.key { display: inline-block; width: 14px; height: 2px;
       vertical-align: middle; margin-right: 4px; }
"""


def render_dash(store: TimeSeriesStore,
                slo_status: Optional[Dict[str, Any]] = None,
                snapshot: Optional[Dict[str, float]] = None,
                window_s: float = 10.0,
                refresh_s: int = 2,
                max_cards: int = 24) -> str:
    """The ``/dash`` page: stat tiles, SLO alert states, and a card grid
    of sparklines (windowed p99 per latency stem — stage/kind cards from
    the span-tree attribution — plus counter rates), with a plain table
    carrying every number the sparklines summarize."""
    snap = snapshot or {}
    now = None
    tiles: List[str] = []

    def tile(label: str, value: str, hint: str = "") -> None:
        tiles.append(
            f'<div class="tile"><div class="label">{html.escape(label)}'
            f'</div><div class="value">{html.escape(value)}</div>'
            + (f'<div class="hint">{html.escape(hint)}</div>' if hint
               else "") + "</div>")

    arrival = store.last("timeseries.arrival_rate_hz")
    service = store.last("timeseries.service_rate_hz")
    tile("Arrival rate", _fmt_rate(arrival), "EWMA of submits")
    tile("Service rate", _fmt_rate(service), "EWMA of completions")
    replicas = store.last("router.replicas") or snap.get("router.replicas")
    tile("Replicas", f"{replicas:.0f}" if replicas is not None else "–")
    p99 = store.window_percentile("router.latency_s", 99, window_s)
    tile(f"p99 latency ({window_s:g}s)", _fmt_s(p99) if p99 else "–",
         "windowed, bucket-exact")
    depth = store.last("router.queue_depth")
    tile("Queue depth", f"{depth:.0f}" if depth is not None else "–")

    # SLO alert rows: state is icon+label text in status colors, never
    # color alone
    slo_html = ""
    if slo_status and slo_status.get("objectives"):
        rows = []
        for obj in slo_status["objectives"]:
            for sub, alert in sorted(obj.get("alerts", {}).items()):
                state = alert["state"]
                burns = alert["burns"][0] if alert["burns"] else {}
                rows.append(
                    '<div class="slo-row">'
                    f'<span class="slo-state {state}">'
                    f'{"▲ FIRING" if state == "firing" else "● ok"}</span>'
                    f'<span>{html.escape(obj["kind"])} · {sub}</span>'
                    f'<span class="muted">burn fast '
                    f'{burns.get("fast", 0.0):.2f} / slow '
                    f'{burns.get("slow", 0.0):.2f} (thr '
                    f'{burns.get("threshold", 0.0):g}) · budget left '
                    f'{alert.get("budget_remaining", 1.0) * 100.0:.0f}%'
                    "</span></div>")
        slo_html = ("<section><h2>SLO burn-rate alerts</h2>"
                    + "".join(rows) + "</section>")

    # sparkline cards: histogram stems (windowed p99), router.latency_s
    # and stage.* first, then counters by rate
    cards: List[str] = []
    table_rows: List[str] = []
    stems = store.histogram_stems()
    order = ([s for s in stems if s == "router.latency_s"]
             + sorted(s for s in stems if s.startswith("stage."))
             + sorted(s for s in stems
                      if s != "router.latency_s"
                      and not s.startswith("stage.")))
    for stem in order[:max_cards]:
        series = store.percentile_series(stem, 99, window_s,
                                         max_points=48)
        cur = store.window_percentile(stem, 99, window_s)
        n = store.window_count(stem, window_s)
        cards.append(
            f'<div class="card"><div class="name">{html.escape(stem)}'
            f' · p99</div><div class="now">{_fmt_s(cur)}'
            f' <small>{n:.0f} obs/{window_s:g}s</small></div>'
            + _spark_svg(series, fmt=_fmt_s, title=f"{stem} p99")
            + "</div>")
        table_rows.append(
            f"<tr><td>{html.escape(stem)}</td>"
            f"<td>{_fmt_s(store.window_percentile(stem, 50, window_s))}"
            f"</td><td>{_fmt_s(cur)}</td><td>{n:.0f}</td>"
            f"<td>{_fmt_s(store.last(stem + '.p99'))}</td></tr>")

    counter_cards: List[str] = []
    for key in ("router.submitted", "router.finish.total",
                "router.finish.deadline", "engine.tokens"):
        if store.last(key) is None:
            continue
        series = store.rate_series(key, window_s, max_points=48)
        counter_cards.append(
            f'<div class="card"><div class="name">{html.escape(key)}'
            f' · rate</div>'
            f'<div class="now">{_fmt_rate(store.rate(key, window_s))}'
            "</div>"
            + _spark_svg(series, fmt=_fmt_rate, title=f"{key} rate")
            + "</div>")

    rate_legend = (
        '<div class="legend">'
        '<span><span class="key" style="background:var(--series-1)">'
        "</span>arrival</span>"
        '<span><span class="key" style="background:var(--series-2)">'
        "</span>service</span></div>")
    arr_series = store.points("timeseries.arrival_rate_hz")[-48:]
    svc_series = store.points("timeseries.service_rate_hz")[-48:]
    rates_card = (
        '<div class="card"><div class="name">arrival vs service rate'
        "</div>" + rate_legend
        + _spark_svg(arr_series, fmt=_fmt_rate, title="arrival rate")
        + _spark_svg(svc_series, color="var(--series-2)", fmt=_fmt_rate,
                     title="service rate")
        + "</div>")

    mem = (f"{store.n_points}/{store.max_points} points · "
           f"{len(store.keys())}/{store.max_stems} keys · "
           f"{store.dropped_keys} dropped")
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh_s}">
<title>cluster dashboard</title><style>{_STYLE}</style></head>
<body>
<h1>cluster dashboard</h1>
<p class="sub">windowed over trailing {window_s:g}s · refreshes every
{refresh_s}s · store {html.escape(mem)}</p>
<div class="tiles">{''.join(tiles)}</div>
{slo_html}
<section><h2>latency p99 by stage / kind</h2>
<div class="grid">{''.join(cards)}</div></section>
<section><h2>throughput</h2>
<div class="grid">{rates_card}{''.join(counter_cards)}</div></section>
<section><h2>table view</h2>
<table class="tbl"><tr><th>stem</th><th>p50 ({window_s:g}s)</th>
<th>p99 ({window_s:g}s)</th><th>obs</th><th>lifetime p99</th></tr>
{''.join(table_rows)}</table></section>
</body></html>
"""


def render_watch(store: TimeSeriesStore,
                 slo_status: Optional[Dict[str, Any]] = None,
                 window_s: float = 10.0, width: int = 78) -> str:
    """Terminal one-screen rendering of the same numbers (serve.py
    ``--watch``): rates, windowed percentiles, SLO alert states."""
    bar = "─" * width
    lines = [bar]
    arrival = store.last("timeseries.arrival_rate_hz") or 0.0
    service = store.last("timeseries.service_rate_hz") or 0.0
    replicas = store.last("router.replicas") or 0.0
    depth = store.last("router.queue_depth") or 0.0
    lines.append(f" arrival {_fmt_rate(arrival):>9}   service "
                 f"{_fmt_rate(service):>9}   replicas {replicas:>3.0f}   "
                 f"queue {depth:>5.0f}")
    if slo_status:
        for obj in slo_status.get("objectives", []):
            for sub, alert in sorted(obj.get("alerts", {}).items()):
                burns = alert["burns"][0] if alert["burns"] else {}
                state = ("FIRING" if alert["state"] == "firing"
                         else "ok    ")
                lines.append(
                    f" slo {obj['kind']}/{sub:<12} {state} "
                    f"burn {burns.get('fast', 0.0):6.2f}/"
                    f"{burns.get('slow', 0.0):6.2f} "
                    f"budget {alert.get('budget_remaining', 1.0) * 100:5.0f}%")
    lines.append(bar)
    lines.append(f" {'stem':<38}{'p50':>9}{'p99':>9}{'obs':>7}{'rate':>10}")
    for stem in store.histogram_stems()[:20]:
        n = store.window_count(stem, window_s)
        lines.append(
            f" {stem[:38]:<38}"
            f"{_fmt_s(store.window_percentile(stem, 50, window_s)):>9}"
            f"{_fmt_s(store.window_percentile(stem, 99, window_s)):>9}"
            f"{n:>7.0f}{_fmt_rate(n / window_s):>10}")
    lines.append(bar)
    return "\n".join(lines)


# ----------------------------------------------------------------------
# The HTTP server

class StatsServer:
    """Serve the stats routes from a daemon thread.

    ``port=0`` binds an ephemeral port (read it back from ``.port``);
    ``host`` defaults to loopback — never expose this beyond localhost
    without meaning to.
    """

    def __init__(self, snapshot_fn, store: TimeSeriesStore,
                 slo: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 window_s: float = 10.0):
        self.snapshot_fn = snapshot_fn
        self.store = store
        self.slo = slo
        self.window_s = window_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet: telemetry, not access
                pass                          # logs

            def do_GET(self):                 # noqa: N802 (stdlib name)
                try:
                    body, ctype = outer._route(self.path)
                except Exception as e:        # noqa: BLE001
                    self.send_error(500, str(e))
                    return
                if body is None:
                    self.send_error(404, "unknown route")
                    return
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # route -> (body, content-type); None = 404
    def _route(self, path: str):
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return prometheus_text(self.snapshot_fn()), \
                "text/plain; version=0.0.4; charset=utf-8"
        if path == "/timeseries.json":
            return json.dumps(self.store.to_json(
                windows=(self.window_s, 6 * self.window_s))), \
                "application/json"
        if path == "/slo.json":
            status = self.slo.status() if self.slo is not None else {
                "objectives": [], "ticks": 0, "pressure": 0.0}
            return json.dumps(status), "application/json"
        if path in ("/", "/dash"):
            status = self.slo.status() if self.slo is not None else None
            return render_dash(self.store, slo_status=status,
                               snapshot=None,
                               window_s=self.window_s), \
                "text/html; charset=utf-8"
        return None, ""

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "StatsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="stats-server",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
