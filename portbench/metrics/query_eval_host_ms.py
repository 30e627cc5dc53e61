"""query_eval_host_ms: a query's stage ``query.eval_host`` (its buckets'
execute on the host lane), in milliseconds, the mean over the window's
queries that ran it."""

from portbench.stages import stage_mean_ms

STAGES = ("query.eval_host",)


def read(ctx):
    return stage_mean_ms(ctx.records, STAGES, ran_only=True) if ctx.loop == "query" else None
