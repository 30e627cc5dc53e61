"""Structured JSON-lines logging, trace-correlated.

A copy of the JAX package's ``obs/log.py``.  One record per line,
machine-parseable, carrying the active span tracer's trace id, so a
warning joins the same story as the Perfetto trace of its run.

Record shape (stable keys first, call-site fields after)::

    {"ts": "2026-08-03T12:00:00.123Z", "level": "warning",
     "logger": "nemo.backend", "event": "kernel.slow_dispatch",
     "pid": 1234, "trace_id": "ab12...", ...fields}

Sinks and knobs (all resolved per emit, so tests that set env mid-run just
work):

* records go to **stderr** as JSON lines;
* ``NEMO_LOG_FILE=<path>`` additionally appends every record to that file;
* ``NEMO_LOG_LEVEL=debug|info|warning|error`` filters (default ``info``).

Stdlib only, so every layer can depend on it unconditionally.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

__all__ = ["Logger", "get_logger", "level_enabled", "slow_dispatch_ms"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_lock = threading.Lock()

# Armed flight recorder (obs/flight.py): every emitted record also lands in
# its bounded ring, so a postmortem bundle carries the recent log tail.  Set
# by flight.arm() and disarm(); log.py never imports flight.
_FLIGHT = None


def set_flight_recorder(rec) -> None:
    global _FLIGHT
    _FLIGHT = rec


def _threshold() -> int:
    return LEVELS.get(os.environ.get("NEMO_LOG_LEVEL", "").strip().lower(), LEVELS["info"])


def level_enabled(level: str) -> bool:
    return LEVELS.get(level, 0) >= _threshold()


def slow_dispatch_ms() -> float:
    """The slow-dispatch watchdog threshold (milliseconds): a kernel
    dispatch slower than this is logged as a warning with its verb, bucket
    shape and upload bytes (backend/torch_backend.py).  0 disables.  The
    default, 30 s, is the JAX package's."""
    try:
        return float(os.environ.get("NEMO_SLOW_DISPATCH_MS", "30000"))
    except ValueError:
        return 30000.0


def _iso_ts() -> str:
    t = time.time()
    frac = int((t - int(t)) * 1000)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{frac:03d}Z"


def _emit(level: str, logger: str, event: str, fields: dict) -> None:
    if LEVELS[level] < _threshold():
        return
    rec: dict = {
        "ts": _iso_ts(),
        "level": level,
        "logger": logger,
        "event": event,
        "pid": os.getpid(),
    }
    if "trace_id" not in fields:
        # Correlate with the active span tracer (None when untraced); an
        # explicit trace_id field wins.
        from . import trace as _trace

        tid = _trace.trace_id()
        if tid is not None:
            rec["trace_id"] = tid
    rec.update(fields)
    if rec.get("trace_id") is None:
        rec.pop("trace_id", None)  # an untraced call site passed None explicitly
    fr = _FLIGHT
    if fr is not None:
        fr.record_log(rec)
    line = json.dumps(rec, default=str)
    with _lock:
        print(line, file=sys.stderr, flush=True)  # the log sink itself
        # NEMO_LOG_FILE is re-read per emit (tests set it mid-run) and
        # opened per record: emits are rare, O_APPEND keeps concurrent
        # writers whole-line atomic, and no handle outlives the record.
        path = os.environ.get("NEMO_LOG_FILE", "").strip()
        if path:
            try:
                with open(path, "a", encoding="utf-8") as fh:
                    fh.write(line + "\n")
            except OSError:
                pass  # a dead log file must never fail the work being logged


class Logger:
    """A named emitter.  Methods accept an event name (stable,
    dot-namespaced: the grep key) plus arbitrary JSON-able fields."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def debug(self, event: str, **fields) -> None:
        _emit("debug", self.name, event, fields)

    def info(self, event: str, **fields) -> None:
        _emit("info", self.name, event, fields)

    def warning(self, event: str, **fields) -> None:
        _emit("warning", self.name, event, fields)

    def error(self, event: str, **fields) -> None:
        _emit("error", self.name, event, fields)


def get_logger(name: str) -> Logger:
    return Logger(name)
