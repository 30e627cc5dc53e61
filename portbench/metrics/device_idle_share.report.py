"""device_idle_share.report: per cent of the report window in which no
operation ran on the card (1 minus the union of the capture's device-busy
intervals over the window's wall)."""

from portbench.yardstick import idle_share


def read(ctx):
    return idle_share(ctx.trace, ctx.window_s) if ctx.loop == "report" else None
