"""runs_per_s: the Molly runs of every report the window completed, over
the window's wall.  The window starts whole reports until its seconds have
passed and ends when the last one finishes: none is cut, none dropped."""

from portbench.yardstick import rate


def read(ctx):
    if ctx.loop != "report":
        return None
    return rate(ctx.work("runs"), ctx.window_s)
