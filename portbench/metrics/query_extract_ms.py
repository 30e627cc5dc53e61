"""query_extract_ms: a query's stage ``query.extract`` (per-run values, merge
and finalize), in milliseconds, the mean over the window's queries."""

from portbench.stages import stage_mean_ms

STAGES = ("query.extract",)


def read(ctx):
    return stage_mean_ms(ctx.records, STAGES) if ctx.loop == "query" else None
