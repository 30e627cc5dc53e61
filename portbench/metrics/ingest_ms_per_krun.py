"""ingest_ms_per_krun: the ``ingest`` phase of every report in the window
(its telemetry.json ``timings``), per 1,000 runs."""

from portbench.yardstick import phase_ms_per_krun

PHASES = ("ingest",)


def read(ctx):
    return phase_ms_per_krun(ctx.records, PHASES) if ctx.loop == "report" else None
