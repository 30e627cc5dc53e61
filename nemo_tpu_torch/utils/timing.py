"""Per-phase wall timing of the report pipeline, span-backed: a copy of the
JAX package's ``utils/timing.py``.

Each phase measures ONE interval and feeds the same numbers to both the
``timings`` dict (name -> accumulated seconds) and, when tracing is on, a
``phase:<name>`` span in the trace file, so the two cannot disagree.  While
a ``torch.profiler`` capture is running, the phase is also a
``phase:<name>`` label on its timeline (``obs.trace.profiler_label``).
A phase may nest in another (``ingest.engine`` in ``ingest``): each has its
own entry.
"""

from __future__ import annotations

import contextlib
import threading
import time

from nemo_tpu_torch.obs import trace as _trace


class PhaseTimer:
    """name -> accumulated wall seconds of every ``phase(name)`` block.
    ``sync``, when given, is called at the end of each phase before the
    clock is read (on the card, a synchronize of the caller's current
    stream), so that a phase's wall, and its span, cover the device work
    it queued.  It waits for that stream only: the streamed map's staging
    copies run on a side stream and are not waited for here.  Phases may
    run on several threads at once (the query's lanes under the
    scheduler)."""

    def __init__(self, sync=None) -> None:
        self._timings: dict[str, float] = {}
        self._sync = sync
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        with _trace.profiler_label(f"phase:{name}"):
            start_ns = time.perf_counter_ns()
            try:
                yield
                if self._sync is not None:
                    self._sync()
            finally:
                dur_ns = time.perf_counter_ns() - start_ns
                # One measurement, two consumers: the span's microseconds and
                # the dict's float seconds derive from the SAME interval.
                _trace.add_span(f"phase:{name}", start_ns // 1000, dur_ns // 1000)
                with self._lock:
                    self._timings[name] = self._timings.get(name, 0.0) + dur_ns / 1e9

    def as_dict(self) -> dict[str, float]:
        with self._lock:
            return dict(self._timings)
