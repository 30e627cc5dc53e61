"""Prometheus text-format exposition of the obs metrics registry.

A copy of the JAX package's ``obs/promexp.py``.  Renders ``obs.metrics.snapshot()`` in Prometheus
exposition format 0.0.4: counters as ``_total`` series, gauges bare,
histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` and
``_count``.  Dotted registry names map to metric names by sanitization
(``kernel.dispatches.fused`` -> ``nemo_kernel_dispatches_fused``).  The
CLI's ``--metrics-out FILE`` writes it once after a run;
``start_http_server`` serves it, and ``/healthz``, for the sidecar's
``--metrics-port``; the fleet router serves its federated page
(obs/federation.py) and ``/autoscale`` through the same server.

``parse_prometheus_text`` is the matching parser the tests and the smoke
round-trip the text through.
"""

from __future__ import annotations

import json
import re
import threading

from .metrics import HIST_BUCKETS
from .metrics import metrics as _global_metrics

__all__ = [
    "parse_prometheus_text",
    "render_prometheus",
    "sanitize_name",
    "start_http_server",
]

NAMESPACE = "nemo"

_INVALID = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    """Registry name -> valid Prometheus metric name: every character
    outside [a-zA-Z0-9_] becomes '_', with the shared namespace prefix
    (which also guarantees the first character is a letter)."""
    return f"{NAMESPACE}_{_INVALID.sub('_', name)}"


def _fmt(v: float) -> str:
    """Sample-value formatting: integers without the trailing .0 (counters
    and bucket counts read naturally), floats via repr (round-trip exact)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshot: dict | None = None) -> str:
    """Render one registry snapshot (default: the process-global registry)
    as Prometheus exposition text.  Names are emitted sorted so scrapes of
    an idle registry are byte-stable; a sanitize collision keeps the first
    name and skips the rest (two distinct registry names must not emit one
    metric with two TYPE lines — the registry naming convention makes
    collisions practically impossible, but the renderer must stay valid
    even if one appears)."""
    snap = _global_metrics.snapshot() if snapshot is None else snapshot
    lines: list[str] = []
    seen: set[str] = set()

    def claim(name: str) -> bool:
        if name in seen:
            return False
        seen.add(name)
        return True

    for raw, v in sorted(snap.get("counters", {}).items()):
        name = sanitize_name(raw) + "_total"
        if not claim(name):
            continue
        lines.append(f"# HELP {name} nemo counter {raw}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(v)}")
    for raw, v in sorted(snap.get("gauges", {}).items()):
        name = sanitize_name(raw)
        if not claim(name):
            continue
        lines.append(f"# HELP {name} nemo gauge {raw}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(v)}")
    for raw, h in sorted(snap.get("histograms", {}).items()):
        name = sanitize_name(raw)
        if not claim(name):
            continue
        lines.append(f"# HELP {name} nemo histogram {raw}")
        lines.append(f"# TYPE {name} histogram")
        count = int(h.get("count", 0))
        # The snapshot trims the bucket list after the first all-inclusive
        # bound (a telemetry.json size optimization); the exposition must
        # emit the FULL fixed ladder every scrape — otherwise new _bucket
        # series would be born mid-stream when a slower observation lands,
        # and Prometheus rate()/histogram_quantile() over windows spanning
        # the appearance mis-reads the jump.  Past the trimmed prefix every
        # bucket holds all observations, ending at +Inf == _count.
        by_le = {le: int(c) for le, c in h.get("buckets", [])}
        ladder = tuple(h.get("ladder") or HIST_BUCKETS)
        cum = 0
        for le in ladder:
            # The pairs are a ladder prefix, so carrying the last value
            # forward is exact: a trimmed tail means every later bucket
            # already holds all observations.
            cum = by_le.get(le, cum)
            lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{name}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{name}_count {count}")
    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)


def parse_prometheus_text(text: str) -> dict:
    """Strict-enough exposition parser for round-trip tests and smokes:
    returns {metric_family: {"type": str|None, "samples": [(name, labels
    dict, float value)]}} and raises ValueError on any line that is neither
    a comment nor a well-formed sample.  Sample names attach to the family
    they extend (`_bucket`/`_sum`/`_count` fold into their histogram)."""
    families: dict[str, dict] = {}
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a valid sample: {line!r}")
        name = m.group("name")
        labels: dict[str, str] = {}
        if m.group("labels"):
            for pair in m.group("labels").split(","):
                k, _, v = pair.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"line {lineno}: unquoted label value: {line!r}")
                labels[k.strip()] = v[1:-1]
        value = float(m.group("value").replace("+Inf", "inf"))
        family = name
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                family = name[: -len(suffix)]
                break
        if name in types:
            family = name
        fam = families.setdefault(family, {"type": types.get(family), "samples": []})
        fam["type"] = types.get(family, fam["type"])
        fam["samples"].append((name, labels, value))
    # Counters carry their TYPE under the suffixed name in this renderer.
    for tname, t in types.items():
        if tname in families and families[tname]["type"] is None:
            families[tname]["type"] = t
    return families


def start_http_server(port: int, health=None, render=None, routes: dict | None = None):
    """The metrics endpoint on a daemon thread; returns (the
    ThreadingHTTPServer, its bound port).  ``/metrics``: the process-global
    registry as Prometheus text, or ``render()``'s text when given (the
    router's federated page).  ``/healthz``: the JSON of ``health()`` (the
    sidecar passes its Health state), else ``{"status": "SERVING"}``;
    status 503 unless it says SERVING.  Each ``routes`` path: the JSON of
    its zero-argument callable (the router's ``/autoscale``).  ``port=0``
    binds an ephemeral port; the caller owns ``shutdown()``."""
    import http.server

    from . import log as obs_log

    log = obs_log.get_logger("nemo.metrics")
    extra = dict(routes or {})

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            path = self.path.split("?", 1)[0]
            status = 200
            if path == "/metrics":
                try:
                    text = render_prometheus() if render is None else render()
                except Exception as ex:  # a scrape fails; the server goes on
                    log.warning("metrics.render_failed", error=repr(ex))
                    self.send_error(500)
                    return
                body, ctype = text.encode("utf-8"), "text/plain; version=0.0.4; charset=utf-8"
            elif path in extra:
                try:
                    doc = extra[path]()
                except Exception as ex:  # reported as the route's answer
                    doc = {"error": repr(ex)}
                body, ctype = json.dumps(doc).encode("utf-8"), "application/json"
            elif path == "/healthz":
                doc = {"status": "SERVING"}
                if health is not None:
                    try:
                        doc = health()
                    except Exception as ex:  # reported as the probe's answer
                        doc = {"status": "NOT_SERVING", "error": repr(ex)}
                body, ctype = json.dumps(doc).encode("utf-8"), "application/json"
                if doc.get("status") != "SERVING":
                    status = 503
            else:
                self.send_error(404)
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # stdlib's stderr lines -> obs log
            log.debug("metrics.http", detail=fmt % args)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    bound = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True, name="nemo-metrics-http").start()
    log.info("metrics.listening", port=bound)
    return httpd, bound
