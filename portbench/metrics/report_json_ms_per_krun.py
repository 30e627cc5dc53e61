"""report_json_ms_per_krun: the writer's phase ``report.json``
(debugging.json, repairs.json, quarantine.json), per 1,000 runs of the
reports that timed it."""

from portbench.stages import nested_phase_ms_per_krun


def read(ctx):
    return nested_phase_ms_per_krun(ctx.records, "report.json") if ctx.loop == "report" else None
