"""query_prep_ms: a query's stages ``query.plan`` and ``query.prep`` (the plan,
the lane crossover, the vocabulary, name checks, graph views, bind and
bucketize), in milliseconds, the mean over the window's queries."""

from portbench.stages import stage_mean_ms

STAGES = ("query.plan", "query.prep")


def read(ctx):
    return stage_mean_ms(ctx.records, STAGES) if ctx.loop == "query" else None
