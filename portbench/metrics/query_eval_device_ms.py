"""query_eval_device_ms: a query's stage ``query.eval_device`` (its buckets'
execute on the sparse_device lane: time plane, uploads, waves and the copy
back), in milliseconds, the mean over the window's queries that ran it."""

from portbench.stages import stage_mean_ms

STAGES = ("query.eval_device",)


def read(ctx):
    return stage_mean_ms(ctx.records, STAGES, ran_only=True) if ctx.loop == "query" else None
