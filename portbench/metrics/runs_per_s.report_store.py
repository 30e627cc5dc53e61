"""runs_per_s.report_store: as runs_per_s, over the window of reports
served from the corpus store (traced, so under the profiler)."""

from portbench.yardstick import rate


def read(ctx):
    return rate(ctx.work("runs"), ctx.window_s) if ctx.loop == "report_store" else None
