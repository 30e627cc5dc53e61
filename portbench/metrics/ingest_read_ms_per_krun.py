"""ingest_read_ms_per_krun: the C++ ingest engine's file reads (open, read and
UTF-8 check of runs.json and every provenance file: the counter
``ingest_engine.read_s`` of each report's telemetry.json), per 1,000 runs."""

from portbench.stages import engine_ms_per_krun


def read(ctx):
    return engine_ms_per_krun(ctx.records, "read_s") if ctx.loop == "report" else None
