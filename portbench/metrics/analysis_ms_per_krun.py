"""analysis_ms_per_krun: the map's analysis phases and the reduce, per
1,000 runs.  The report verbs' phases (hazard, pull_prov) are
report_ms_per_krun's."""

from portbench.yardstick import phase_ms_per_krun

PHASES = ("load_raw_provenance", "simplify", "prototypes", "diff_prov", "corrections", "extensions",
          "synthesis", "reduce")


def read(ctx):
    return phase_ms_per_krun(ctx.records, PHASES) if ctx.loop == "report" else None
