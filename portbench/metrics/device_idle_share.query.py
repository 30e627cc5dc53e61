"""device_idle_share.query: as device_idle_share.report, over the query
window."""

from portbench.yardstick import idle_share


def read(ctx):
    return idle_share(ctx.trace, ctx.window_s) if ctx.loop == "query" else None
