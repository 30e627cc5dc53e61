"""pack_ms_per_krun.report_store: pack_ms_per_krun's phases over the
window of reports served from the corpus store, per 1,000 runs."""

from portbench.harness import _metric
from portbench.yardstick import phase_ms_per_krun


def read(ctx):
    if ctx.loop != "report_store":
        return None
    return phase_ms_per_krun(ctx.records, _metric("pack_ms_per_krun").PHASES)
