"""device_idle_share.report_store: as device_idle_share.report, over the
window of reports served from the corpus store."""

from portbench.yardstick import idle_share


def read(ctx):
    return idle_share(ctx.trace, ctx.window_s) if ctx.loop == "report_store" else None
