"""Structured observability of the port: span tracing, a metrics registry,
structured logging and a flight recorder.

A copy of the JAX package's ``obs/`` with the same exports, the same span
and series names and the same knobs, trimmed to what the port uses:

* **Span tracing** (``obs.trace``): nested, thread-aware ``span(name,
  **attrs)`` context managers recording Chrome-trace-event JSON that
  Perfetto loads.  Enabled by ``NEMO_TRACE`` or the CLI's ``--trace
  out.json``; when disabled, ``span()`` returns a shared null context
  manager.
* **Metrics** (``obs.metrics``): counters, gauges and histograms with a
  ``snapshot()`` dict; ``telemetry.json`` carries it, ``obs.promexp``
  renders it as Prometheus text (the CLI's ``--metrics-out``).
* **Structured logging** (``obs.log``): leveled JSON-lines records on
  stderr carrying the active tracer's trace id.
* **Flight recorder** (``obs.flight``): a bounded ring of recent spans,
  log records and metric deltas, dumped as a Perfetto-loadable bundle when
  a trigger fires (a failed watch cycle).

Stdlib only, so every layer can import it unconditionally.
``obs.promexp`` is imported by its consumers.
"""

from __future__ import annotations

from . import flight, log
from .metrics import HIST_BUCKETS, Metrics, metrics
from .trace import (
    Tracer,
    add_span,
    configure_from_env,
    enabled,
    export,
    finish,
    span,
    start_trace,
    trace_id,
    tracer,
)

__all__ = [
    "HIST_BUCKETS",
    "Metrics",
    "Tracer",
    "add_span",
    "configure_from_env",
    "enabled",
    "export",
    "finish",
    "flight",
    "log",
    "metrics",
    "span",
    "start_trace",
    "trace_id",
    "tracer",
]
