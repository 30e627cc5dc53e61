"""k1_roofline_share.report: per cent, the summed least time of every K1
(closure) launch in the report window over K1's summed device time in the
same capture."""

from portbench.yardstick import roofline_share


def read(ctx):
    return roofline_share(ctx.trace, "k1") if ctx.loop == "report" else None
