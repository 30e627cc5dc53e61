"""pack_ms_per_krun: the ``init`` phase (the backend packs the corpus), per
1,000 runs."""

from portbench.yardstick import phase_ms_per_krun

PHASES = ("init",)


def read(ctx):
    return phase_ms_per_krun(ctx.records, PHASES) if ctx.loop == "report" else None
