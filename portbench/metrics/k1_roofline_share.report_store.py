"""k1_roofline_share.report_store: as k1_roofline_share.report, over the
window of reports served from the corpus store."""

from portbench.yardstick import roofline_share


def read(ctx):
    return roofline_share(ctx.trace, "k1") if ctx.loop == "report_store" else None
