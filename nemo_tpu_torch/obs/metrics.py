"""Metrics registry: counters / gauges / histograms with a snapshot() dict.

A copy of the JAX package's ``obs/metrics.py``.  One process-wide registry
(``obs.metrics``) holds the run statistics every layer of the port records:
kernel dispatches and upload bytes (backend/torch_backend.py), routes,
store and result-cache traffic, figure dedup (report/render.py), the
query engine's lanes and the watch loop's updates.  ``telemetry.json``
carries its ``snapshot()``; ``obs.promexp`` renders it in Prometheus text
(the CLI's ``--metrics-out``).

Naming convention: dotted lowercase, layer-first (``kernel.dispatches``,
``render.figures``); a breakdown rides the name
(``kernel.dispatches.fused``), so a snapshot stays a flat JSON-able dict.
Because a breakdown rides the name, the registry is CAPPED: past
``max_series`` distinct names (``NEMO_METRICS_MAX_SERIES``, default 4096)
new series are dropped and counted in ``metrics.dropped_series``;
existing series keep updating.

Histograms keep count/sum/min/max (mean derives) plus cumulative bucket
counts over a fixed 1-2.5-5 geometric ladder spanning 1e-4..5e9, which
the Prometheus exposition renders as ``_bucket{le=...}`` series.  A
histogram may opt into its own ladder with ``set_buckets(name, bounds)``
before its first observation; such a snapshot carries an extra
``"ladder"`` key.
"""

from __future__ import annotations

import bisect
import os
import threading

__all__ = ["HIST_BUCKETS", "Metrics", "metrics"]

#: Histogram bucket upper bounds (cumulative, Prometheus ``le`` semantics):
#: a 1-2.5-5 ladder per decade, 1e-4 .. 5e9.  One shared ladder for every
#: histogram keeps the exposition conformant and the snapshot shape stable;
#: observations above the top bound land only in the implicit +Inf bucket.
HIST_BUCKETS: tuple[float, ...] = tuple(
    m * 10.0**e for e in range(-4, 10) for m in (1.0, 2.5, 5.0)
)


def _max_series_default() -> int:
    try:
        return int(os.environ.get("NEMO_METRICS_MAX_SERIES", "4096"))
    except ValueError:
        return 4096


class Metrics:
    """Thread-safe registry.  All mutators are cheap (one lock, dict ops);
    none allocate on the hot path beyond first sight of a name."""

    def __init__(self, max_series: int | None = None) -> None:
        self._lock = threading.Lock()
        self._max_series = _max_series_default() if max_series is None else int(max_series)
        self._dropped = 0
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        # name -> [count, sum, min, max, per-bucket counts, ladder tuple]
        self._hists: dict[str, list] = {}
        # name -> custom ladder, registered via set_buckets() pre-observation
        self._ladders: dict[str, tuple[float, ...]] = {}

    def _admit(self) -> bool:
        """Bounded-registry gate, called under the lock for a name NOT yet
        in its store: admit while the total series count is under the cap,
        else count the drop.  Existing series always keep updating — the
        cap bounds growth, it never loses established signals."""
        if (
            len(self._counters) + len(self._gauges) + len(self._hists)
            < self._max_series
        ):
            return True
        self._dropped += 1
        return False

    def set_buckets(self, name: str, bounds) -> None:
        """Register a per-metric histogram bucket ladder (Prometheus ``le``
        upper bounds).  Must run before `name`'s first observation — once a
        histogram exists its ladder is frozen (rebinning live cumulative
        counts is lossy), so a late registration is a silent no-op and the
        series keeps the ladder it was born with.  Idempotent; bounds are
        sorted and deduplicated."""
        ladder = tuple(sorted({float(b) for b in bounds}))
        if not ladder:
            return
        with self._lock:
            if name in self._hists:
                return
            self._ladders[name] = ladder

    # ------------------------------------------------------------- mutators

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            if name in self._counters:
                self._counters[name] += value
            elif self._admit():
                self._counters[name] = value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            if name in self._gauges or self._admit():
                self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if not self._admit():
                    return
                ladder = self._ladders.get(name, HIST_BUCKETS)
                h = self._hists[name] = [0, 0.0, value, value, [0] * len(ladder), ladder]
            h[0] += 1
            h[1] += value
            if value < h[2]:
                h[2] = value
            if value > h[3]:
                h[3] = value
            ladder = h[5]
            i = bisect.bisect_left(ladder, value)
            if i < len(ladder):
                h[4][i] += 1

    # ------------------------------------------------------------ snapshots

    @staticmethod
    def _cumulative(buckets: list[int], count: int, ladder=HIST_BUCKETS) -> list:
        """Per-bucket counts -> cumulative [le, count] pairs, trimmed after
        the first bucket that already holds every observation (the tail
        adds no information and would bloat telemetry.json ~40 pairs per
        histogram); the exposition layer re-extends with +Inf."""
        out = []
        cum = 0
        for le, c in zip(ladder, buckets):
            cum += c
            out.append([le, cum])
            if cum >= count:
                break
        return out

    def snapshot(self) -> dict:
        """Point-in-time copy: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, mean, buckets}}} where
        buckets is cumulative [le, count] pairs (Prometheus semantics).
        Plain JSON-able types only (telemetry.json ships
        it verbatim)."""
        with self._lock:
            counters = dict(self._counters)
            if self._dropped:
                counters["metrics.dropped_series"] = self._dropped
            gauges = dict(self._gauges)
            hists = {
                k: (v[0], v[1], v[2], v[3], list(v[4]), v[5])
                for k, v in self._hists.items()
            }
        out_hists = {}
        for k, (c, s, lo, hi, b, ladder) in hists.items():
            doc = {
                "count": int(c),
                "sum": s,
                "min": lo,
                "max": hi,
                "mean": s / c if c else 0.0,
                "buckets": self._cumulative(b, c, ladder),
            }
            if ladder is not HIST_BUCKETS:
                # Non-default ladders must travel with the data so the
                # exposition emits the right full ladder; default-ladder
                # snapshots keep their pre-existing shape byte-for-byte.
                doc["ladder"] = list(ladder)
            out_hists[k] = doc
        return {"counters": counters, "gauges": gauges, "histograms": out_hists}

    @staticmethod
    def delta(after: dict, before: dict) -> dict:
        """Counter-wise `after - before` of two snapshot() dicts — what ONE
        measured pass contributed to the process-cumulative registry.
        Gauges keep `after`'s value (a gauge is a level, not a flow);
        histograms difference count/sum (mean derives) and keep `after`'s
        min/max, which are lifetime extremes — flagged by key name."""
        out: dict = {"counters": {}, "gauges": dict(after.get("gauges", {})), "histograms": {}}
        b = before.get("counters", {})
        for k, v in after.get("counters", {}).items():
            d = v - b.get(k, 0)
            if d:
                out["counters"][k] = d
        bh = before.get("histograms", {})
        for k, h in after.get("histograms", {}).items():
            p = bh.get(k, {"count": 0, "sum": 0.0})
            dc = h["count"] - p["count"]
            if dc:
                ds = h["sum"] - p["sum"]
                out["histograms"][k] = {
                    "count": dc,
                    "sum": ds,
                    "mean": ds / dc,
                    "lifetime_min": h["min"],
                    "lifetime_max": h["max"],
                }
        return out

    def reset(self) -> None:
        """Drop everything (tests that want a clean zero)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._dropped = 0


#: The process-wide registry every layer records into.
metrics = Metrics()
