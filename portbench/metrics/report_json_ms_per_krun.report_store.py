"""report_json_ms_per_krun.report_store: the writer's phase
``report.json`` over the window of reports served from the corpus
store, per 1,000 runs of the reports that timed it."""

from portbench.stages import nested_phase_ms_per_krun


def read(ctx):
    return nested_phase_ms_per_krun(ctx.records, "report.json") if ctx.loop == "report_store" else None
