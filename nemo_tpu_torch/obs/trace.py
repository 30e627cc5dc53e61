"""Span tracer: nested, thread-aware spans -> Chrome-trace-event JSON.

A copy of the JAX package's ``obs/trace.py``.  The sidecar
(service/server.py) hands a traced client the spans one request recorded
(``mark``/``spans_since``, or ``drain_spans`` on a pathless collector
tracer), and the client merges them into its own trace (``adopt``).

Format: the Chrome Trace Event "JSON Object Format": a top-level object
with a ``traceEvents`` array of complete ("ph": "X") events plus process
and thread name metadata ("ph": "M") events.  Perfetto's UI and
trace_processor load it directly.

Clock: event timestamps are microseconds of CLOCK_MONOTONIC
(``time.perf_counter_ns() // 1000``); the exporter normalizes to this
process's earliest event and re-bases an adopted clock domain from
another machine.

Disabled-mode cost: ``span()`` reads two module globals, asks the
profiler hook (when installed) whether a capture is running, and returns a
shared null context manager: no allocation, no string work.

Profiler labels: while a ``torch.profiler`` capture is running, every span
(and every ``utils/timing.py`` phase, as ``phase:<name>``) also opens a
label of its own name on the profiler's timeline, so a capture names the
program's innermost open span at each instant.  This module stays stdlib
only: ``nemo_tpu_torch/device.py``, which imports torch, installs the
check and the label (``set_profiler_hook``).  With no capture running no
label is entered.

Thread safety: spans are appended under a lock; thread ids are attributed
via ``threading.get_ident`` with the thread's name exported as Perfetto
thread-name metadata, so a worker thread's spans land on its own row.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "Tracer",
    "add_span",
    "configure_from_env",
    "enabled",
    "export",
    "finish",
    "profiler_label",
    "set_profiler_hook",
    "span",
    "start_trace",
    "trace_id",
    "tracer",
]


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class Tracer:
    """Collects completed spans; exports Chrome trace events."""

    def __init__(self, path: str | None = None, trace_id: str | None = None) -> None:
        import uuid  # deferred: only a live tracer needs it

        self.path = path
        #: One id for the run, carried by every log record emitted while
        #: this tracer is active.
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._thread_names: dict[tuple[int, int], str] = {}
        self._process_names: dict[int, str] = {self.pid: _process_name_default()}

    def add_span(
        self,
        name: str,
        start_us: int,
        dur_us: int,
        args: dict | None = None,
        pid: int | None = None,
        tid: int | None = None,
        thread_name: str | None = None,
    ) -> None:
        """Record one completed span.  pid/tid default to the calling
        process/thread."""
        if pid is None:
            pid = self.pid
        if tid is None:
            tid = threading.get_ident()
            if thread_name is None:
                thread_name = threading.current_thread().name
        ev = {"name": name, "ph": "X", "ts": start_us, "dur": dur_us, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
            if thread_name is not None:
                self._thread_names.setdefault((pid, tid), thread_name)

    def set_process_name(self, pid: int, name: str) -> None:
        with self._lock:
            self._process_names[pid] = name

    def adopt(self, spans: list[dict], process_name: str | None = None) -> None:
        """Merge spans serialized by another process (the ``drain_spans``
        wire shape: name/ts/dur/pid/tid[/args][/thread_name]), each tagged
        ``span_origin``.  Spans claiming this process's pid are skipped: an
        in-process sidecar hands back spans this tracer already holds."""
        origin = process_name or "remote"
        for s in spans:
            pid = int(s["pid"])
            if pid == self.pid:
                continue
            self.add_span(s["name"], int(s["ts"]), int(s["dur"]), args={**(s.get("args") or {}), "span_origin": origin},
                          pid=pid, tid=int(s.get("tid", 0)), thread_name=s.get("thread_name"))
            if process_name is not None:
                self.set_process_name(pid, process_name)

    @staticmethod
    def _serialize(events: list[dict], names: dict[tuple[int, int], str]) -> list[dict]:
        out = []
        for ev in events:
            s = dict(ev)
            s.pop("ph", None)
            tn = names.get((ev["pid"], ev["tid"]))
            if tn:
                s["thread_name"] = tn
            out.append(s)
        return out

    def drain_spans(self) -> list[dict]:
        """Every recorded span in the cross-process wire shape ``adopt``
        reads, clearing the buffer."""
        with self._lock:
            events, self._events = self._events, []
            names = dict(self._thread_names)
        return self._serialize(events, names)

    def mark(self) -> int:
        """The span count now: ``spans_since(mark)`` serializes what was
        recorded after it (one request's spans)."""
        with self._lock:
            return len(self._events)

    def spans_since(self, mark: int) -> list[dict]:
        """The spans recorded after ``mark``, without clearing (a tracer
        that writes its own file keeps them)."""
        with self._lock:
            events = list(self._events[mark:])
            names = dict(self._thread_names)
        return self._serialize(events, names)

    #: An adopted clock domain whose origin is further than this (1 hour,
    #: in us) from this process's is another machine's CLOCK_MONOTONIC and
    #: is re-based; a same-machine adoption shares the clock.
    _FOREIGN_CLOCK_US = 3_600_000_000

    def export(self, path: str | None = None) -> str:
        """Write the trace file; returns the path written.  Times are
        relative to this process's earliest span; an adopted clock domain
        (``span_origin``) from another machine is re-based to its own
        earliest span."""
        path = path or self.path
        if not path:
            raise ValueError("no trace output path configured")
        with self._lock:
            events = list(self._events)
            thread_names = dict(self._thread_names)
            process_names = dict(self._process_names)

        def _origin(e: dict) -> str | None:
            return (e.get("args") or {}).get("span_origin")

        local_ts = [e["ts"] for e in events if _origin(e) is None]
        base = min(local_ts, default=min((e["ts"] for e in events), default=0))
        domain_min: dict[str, int] = {}
        for e in events:
            o = _origin(e)
            if o is not None:
                domain_min[o] = min(domain_min.get(o, e["ts"]), e["ts"])
        shift = {o: m - base for o, m in domain_min.items() if abs(m - base) > self._FOREIGN_CLOCK_US}
        out = []
        for pid, name in sorted(process_names.items()):
            out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(thread_names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}})
        for e in events:
            e = dict(e)
            e["ts"] -= base + shift.get(_origin(e), 0)
            out.append(e)
        doc = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id, "tool": "nemo-tpu obs"},
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return path


def _process_name_default() -> str:
    import sys

    argv0 = os.path.basename(sys.argv[0]) if sys.argv and sys.argv[0] else "python"
    return f"{argv0} (pid {os.getpid()})"


class _NullSpan:
    """Shared no-op context manager: the entire disabled-mode cost."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """Live span context manager (only ever built when tracing is on, a
    flight recorder is armed or a profiler capture is running).  With no
    recorder (a capture alone) it is the profiler label only."""

    __slots__ = ("_tracer", "_name", "_args", "_start", "_label")

    def __init__(self, tracer: Tracer | None, name: str, args: dict, label=None) -> None:
        self._tracer = tracer
        self._name = name
        self._args = args
        self._label = label

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span, merged into the span's
        args at exit."""
        self._args.update(attrs)

    def __enter__(self):
        if self._label is not None:
            self._label.__enter__()
        self._start = _now_us()
        return self

    def __exit__(self, *exc):
        dur = _now_us() - self._start
        args = self._args or None
        if self._tracer is not None:
            self._tracer.add_span(self._name, self._start, dur, args)
        f = _FLIGHT
        if f is not None and f is not self._tracer:
            f.add_span(self._name, self._start, dur, args)
        if self._label is not None:
            self._label.__exit__(*exc)
        return False


# Module-level tracer state: None = disabled (the common case).
_TRACER: Tracer | None = None

# Armed flight recorder (obs/flight.py), duck-typed to Tracer.add_span:
# with no tracer active, spans record into its bounded ring instead of
# vanishing; with one active it sees them too.  Set by flight.arm() and
# disarm(); trace.py never imports flight, keeping the import graph acyclic.
_FLIGHT = None


def set_flight_recorder(rec) -> None:
    global _FLIGHT
    _FLIGHT = rec


# The profiler hook, (active, label): ``active()`` says whether a profiler
# capture is running, ``label(name)`` is a context manager that puts
# ``name`` on its timeline.  None until nemo_tpu_torch/device.py installs it.
_PROFILER = None


def set_profiler_hook(active, label) -> None:
    """Install the profiler check and label."""
    global _PROFILER
    _PROFILER = (active, label)


def profiler_label(name: str):
    """A label ``name`` on a running profiler capture's timeline, else the
    shared null context manager."""
    p = _PROFILER
    if p is not None and p[0]():
        return p[1](name)
    return _NULL


def enabled() -> bool:
    return _TRACER is not None


def tracer() -> Tracer | None:
    """The active tracer, or None when tracing is disabled."""
    return _TRACER


def trace_id() -> str | None:
    t = _TRACER
    return t.trace_id if t is not None else None


def span(name: str, **attrs):
    """Context manager bracketing one unit of work.  Nested uses on one
    thread render as a nested flame in Perfetto.  Near-free when tracing is
    disabled and no profiler capture is running."""
    t = _TRACER
    rec = t if t is not None else _FLIGHT
    p = _PROFILER
    if p is not None and p[0]():
        return _Span(rec, name, attrs, p[1](name))
    if rec is None:
        return _NULL
    return _Span(rec, name, attrs)


def add_span(name: str, start_us: int, dur_us: int, args: dict | None = None) -> None:
    """Record an already-measured interval (a phase timer's own
    measurement, so the span and the timing are the SAME numbers)."""
    t = _TRACER
    if t is not None:
        t.add_span(name, start_us, dur_us, args)
    f = _FLIGHT
    if f is not None and f is not t:
        f.add_span(name, start_us, dur_us, args)


def start_trace(path: str | None, trace_id_: str | None = None) -> Tracer:
    """Enable tracing for this process; spans land in ``path`` at finish()."""
    global _TRACER
    _TRACER = Tracer(path, trace_id_)
    return _TRACER


def finish() -> str | None:
    """Export and disable; returns the written path (None if disabled or
    pathless)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is None or not t.path:
        return None
    return t.export()


def export(path: str | None = None) -> str | None:
    """Export without disabling (mid-run snapshots)."""
    t = _TRACER
    if t is None:
        return None
    return t.export(path)


def configure_from_env() -> Tracer | None:
    """Enable tracing when NEMO_TRACE names an output file; the trace is
    written at interpreter exit (atexit) unless finish() ran earlier."""
    path = os.environ.get("NEMO_TRACE", "").strip()
    if not path or _TRACER is not None:
        return _TRACER
    t = start_trace(path)
    import atexit

    atexit.register(finish)
    return t
