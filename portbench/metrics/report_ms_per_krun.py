"""report_ms_per_krun: the report verbs (the hazard figures, the DOT pulls)
and the writer (``report``: debugging.json, repairs.json, the figures),
per 1,000 runs."""

from portbench.yardstick import phase_ms_per_krun

PHASES = ("hazard", "pull_prov", "report")


def read(ctx):
    return phase_ms_per_krun(ctx.records, PHASES) if ctx.loop == "report" else None
