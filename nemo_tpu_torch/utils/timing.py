"""Per-phase wall timing of the report pipeline (the JAX package's
``utils/timing.py`` without its trace spans)."""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    """name -> accumulated wall seconds of every ``phase(name)`` block.
    ``sync``, when given, is called at the end of each phase before the
    clock is read (on the card, a synchronize of the caller's current
    stream), so that a phase's wall covers the device work it queued.  It
    waits for that stream only: the streamed map's staging copies run on a
    side stream and are not waited for here."""

    def __init__(self, sync=None) -> None:
        self._timings: dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def phase(self, name: str):
        start_ns = time.perf_counter_ns()
        try:
            yield
            if self._sync is not None:
                self._sync()
        finally:
            dur_ns = time.perf_counter_ns() - start_ns
            self._timings[name] = self._timings.get(name, 0.0) + dur_ns / 1e9

    def as_dict(self) -> dict[str, float]:
        return dict(self._timings)
