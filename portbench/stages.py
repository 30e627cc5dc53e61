"""Readers of the program's own instruments, for the per-layer metrics of
its stages: the C++ ingest engine's counters (each report's telemetry.json
``ingest_engine``), the report's nested phases and the query engine's
phases (each document's ``stats["timings"]``).  A program without them
gives None, never an error."""

from __future__ import annotations

import json
import os

from portbench.yardstick import phase_ms_per_krun


def nested_phase_ms_per_krun(records: list[dict], phase: str) -> float | None:
    """Milliseconds of one nested report phase per 1,000 runs, over the
    window's reports that timed it."""
    timed = [r for r in records if phase in r["timings"]]
    return phase_ms_per_krun(timed, (phase,)) if timed else None


def engine_ms_per_krun(records: list[dict], counter: str) -> float | None:
    """Milliseconds of one of the engine's time counters (``read_s`` or
    ``parse_s``), summed over the window's reports, per 1,000 runs; read
    from each report's telemetry.json, which the check deletes after the
    metrics are read."""
    runs, s = 0, 0.0
    for r in records:
        with open(os.path.join(r["dir"], "telemetry.json"), encoding="utf-8") as f:
            engine = json.load(f).get("ingest_engine")
        if engine is not None:
            runs += r["runs"]
            s += engine[counter]
    return s * 1e3 / (runs / 1e3) if runs else None


def stage_mean_ms(records: list[dict], stages: tuple[str, ...], ran_only: bool = False) -> float | None:
    """Milliseconds of the named query stages, summed within a query and
    averaged over the window's queries that timed their stages; with
    ``ran_only``, over those that ran one of them only."""
    walls = []
    for r in records:
        timings = r["doc"].get("stats", {}).get("timings")
        if timings is None or (ran_only and not any(s in timings for s in stages)):
            continue
        walls.append(sum(timings.get(s, 0.0) for s in stages) * 1e3)
    return sum(walls) / len(walls) if walls else None
