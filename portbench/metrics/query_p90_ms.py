"""query_p90_ms: the 90th percentile of every query's wall in the window,
in milliseconds (at least ten samples beyond it need 100 queries)."""

from portbench.yardstick import percentile


def read(ctx):
    walls = [r["wall_s"] * 1e3 for r in ctx.records if "queries" in r]
    return percentile(walls, 90) if len(walls) >= 100 else None
