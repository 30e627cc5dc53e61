"""queries_per_s: every query the window completed, over the window's wall,
whole queries only, as runs_per_s."""

from portbench.yardstick import rate


def read(ctx):
    if ctx.loop != "query":
        return None
    return rate(ctx.work("queries"), ctx.window_s)
