"""Flight recorder: postmortem capture without a trace having been on.

A copy of the JAX package's ``obs/flight.py``.  A bounded ring of
recent activity that costs almost nothing while nothing is wrong, dumped
as a self-contained bundle the moment an anomaly trigger fires.

What the ring holds:

* **spans**: every ``obs.span(...)`` completion, whether or not a tracer
  is active, stored as bare tuples and rendered to Chrome trace events
  only at dump time;
* **log records**: every record ``obs.log`` emits (post level-filter);
* **metric deltas**: each bundle carries ``Metrics.delta`` between the
  registry now and the recorder's base snapshot (taken at arm, refreshed
  per dump).

Triggers (``trigger(reason, **ctx)``): a failed watch cycle
(watch/watcher.py), the scheduler's breaker trip and its dispatch-deadline
escalation (parallel/sched.py: ``breaker_trip``, ``dispatch_watchdog``),
a burst of admission sheds (serve/admission.py via ``note_shed``:
``shed_burst``), a fleet replica stealing a dead leader's lease
(store/rcache.py: ``lease_steal``).  Each reason has a cooldown
(``NEMO_FLIGHT_COOLDOWN_S``, default 30 s), so a failure storm produces ONE
bundle.  ``trigger`` does nothing while the recorder is unarmed, and the
port arms it only through ``configure_from_env`` or ``arm``, as the JAX
package's long-lived entry points do.

Bundles are ``flightrec-<reason>-<pid>-<seq>.json`` under
``NEMO_FLIGHT_DIR`` (default ``~/.cache/nemo_tpu_torch/flightrec``, beside
the port's other cache roots) in Chrome trace-event format; the log
records, metric delta and trigger context ride in ``otherData``.

Knobs (warn-and-default, parsed lazily so this module stays stdlib-only):

    NEMO_FLIGHT=off            configure_from_env arms nothing
    NEMO_FLIGHT_DIR=PATH       bundle directory
    NEMO_FLIGHT_SPANS=2048     span ring capacity
    NEMO_FLIGHT_LOGS=512       log-record ring capacity
    NEMO_FLIGHT_COOLDOWN_S=30  per-reason dump cooldown
    NEMO_FLIGHT_SHED_BURST=5   sheds within the window that count as a burst
    NEMO_FLIGHT_SHED_WINDOW_S=10   the shed burst window
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

from . import metrics as _metrics_mod
from . import trace as _trace
from .metrics import metrics as _metrics

__all__ = [
    "FlightRecorder",
    "arm",
    "configure_from_env",
    "disarm",
    "note_shed",
    "recorder",
    "trigger",
]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _default_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "nemo_tpu_torch", "flightrec")


class FlightRecorder:
    """Bounded rings + trigger/dump.  ``add_span`` has Tracer.add_span's
    signature, so trace.py's ``_Span`` records into it directly when no
    tracer is active."""

    def __init__(
        self,
        out_dir: str | None = None,
        max_spans: int | None = None,
        max_logs: int | None = None,
        cooldown_s: float | None = None,
        shed_burst: int | None = None,
        shed_window_s: float | None = None,
    ) -> None:
        self.out_dir = out_dir or os.environ.get("NEMO_FLIGHT_DIR", "").strip() or _default_dir()
        self.pid = os.getpid()
        cap_s = max_spans if max_spans is not None else _env_int("NEMO_FLIGHT_SPANS", 2048)
        cap_l = max_logs if max_logs is not None else _env_int("NEMO_FLIGHT_LOGS", 512)
        self.max_spans = max(1, cap_s)
        self.max_logs = max(1, cap_l)
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None else _env_float("NEMO_FLIGHT_COOLDOWN_S", 30.0)
        )
        # deque.append with maxlen is atomic under the GIL: the span hot
        # path takes no lock; only trigger() locks, to copy consistently.
        self._spans: collections.deque = collections.deque(maxlen=self.max_spans)
        self._logs: collections.deque = collections.deque(maxlen=self.max_logs)
        self.shed_burst = shed_burst if shed_burst is not None else _env_int("NEMO_FLIGHT_SHED_BURST", 5)
        self.shed_window_s = (
            shed_window_s if shed_window_s is not None else _env_float("NEMO_FLIGHT_SHED_WINDOW_S", 10.0)
        )
        self._sheds: collections.deque = collections.deque(maxlen=max(1, self.shed_burst))
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._seq = 0
        self._base_snap = _metrics.snapshot()

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
        if tid is None:
            tid = threading.get_ident()
        self._spans.append((name, start_us, dur_us, args, pid or self.pid, tid))

    def record_log(self, rec: dict) -> None:
        self._logs.append(rec)

    def note_shed(self, reason: str = "", tenant: str = "") -> None:
        """The shed-burst detector: a trigger fires when ``shed_burst``
        sheds land within ``shed_window_s`` (one shed is load shedding at
        work; a burst is an incident)."""
        now = time.monotonic()
        self._sheds.append(now)
        if len(self._sheds) >= self.shed_burst and now - self._sheds[0] <= self.shed_window_s:
            self.trigger("shed_burst", shed_reason=reason, tenant=tenant, sheds=len(self._sheds))

    def trigger(self, reason: str, **ctx) -> str | None:
        """Dump a bundle for ``reason`` unless its cooldown is still
        running.  Returns the bundle path, or None when suppressed or
        failed.  Never raises: a postmortem capture must not become a
        second incident."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.cooldown_s:
                _metrics.inc("flight.suppressed")
                return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
            spans = list(self._spans)
            logs = list(self._logs)
            snap = _metrics.snapshot()
            base, self._base_snap = self._base_snap, snap
        from . import log as _log  # deferred: dump path only

        try:
            path = self._write_bundle(reason, ctx, spans, logs, snap, base, seq)
        except Exception as ex:
            _log.get_logger("nemo.flight").warning("flight.dump_failed", reason=reason, error=repr(ex))
            return None
        _metrics.inc("flight.dumps")
        _metrics.inc(f"flight.dumps.{reason}")
        _log.get_logger("nemo.flight").warning(
            "flight.dumped", reason=reason, path=path, spans=len(spans), logs=len(logs)
        )
        return path

    def _write_bundle(self, reason, ctx, spans, logs, snap, base, seq) -> str:
        thread_names = {t.ident: t.name for t in threading.enumerate() if t.ident}
        events: list[dict] = []
        base_ts = min((s[1] for s in spans), default=0)
        seen_threads: set[tuple[int, int]] = set()
        for name, start_us, dur_us, args, pid, tid in spans:
            ev = {"name": name, "ph": "X", "ts": start_us - base_ts, "dur": dur_us, "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
            seen_threads.add((pid, tid))
        meta: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
             "args": {"name": f"nemo-flightrec (pid {self.pid})"}}
        ]
        for pid, tid in sorted(seen_threads):
            tn = thread_names.get(tid)
            if tn:
                meta.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": tn}})
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "nemo-tpu flight recorder",
                "reason": reason,
                "context": {k: v for k, v in ctx.items() if v is not None},
                "trace_id": _trace.trace_id(),
                "pid": self.pid,
                "wall_ts": time.time(),
                "logs": logs,
                "metrics_delta": _metrics_mod.Metrics.delta(snap, base),
            },
        }
        # The routing constants live at the anomaly; a sys.modules gate, never
        # an import: a process that never touched the profile has nothing to say.
        pp = sys.modules.get("nemo_tpu_torch.platform.profile")
        if pp is not None:
            doc["otherData"]["platform_profile"] = pp.telemetry_section()
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flightrec-{safe}-{self.pid}-{seq:03d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        os.replace(tmp, path)
        return path


# Module-level armed recorder: None = disarmed (no capture, no ring cost).
_RECORDER: FlightRecorder | None = None


def recorder() -> FlightRecorder | None:
    return _RECORDER


def arm(out_dir: str | None = None, **kw) -> FlightRecorder:
    """Install a recorder and wire the span and log taps.  Re-arming
    replaces the previous recorder."""
    global _RECORDER
    rec = FlightRecorder(out_dir, **kw)
    _RECORDER = rec
    _trace.set_flight_recorder(rec)
    from . import log as _log

    _log.set_flight_recorder(rec)
    return rec


def disarm() -> None:
    global _RECORDER
    _RECORDER = None
    _trace.set_flight_recorder(None)
    from . import log as _log

    _log.set_flight_recorder(None)


def trigger(reason: str, **ctx) -> str | None:
    """Fire a trigger on the armed recorder; a cheap no-op when disarmed,
    so call sites need not know whether a recorder is armed."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.trigger(reason, **ctx)


def note_shed(reason: str = "", tenant: str = "") -> None:
    """One admission shed, fed to the armed recorder's burst detector."""
    rec = _RECORDER
    if rec is not None:
        rec.note_shed(reason, tenant)


def configure_from_env() -> FlightRecorder | None:
    """Arm unless NEMO_FLIGHT=off/0/false/no."""
    if os.environ.get("NEMO_FLIGHT", "").strip().lower() in ("0", "off", "false", "no"):
        return None
    if _RECORDER is not None:
        return _RECORDER
    return arm()
