"""ingest_parse_ms_per_krun: the rest of the C++ ingest engine's wall (JSON
parse, provenance transform, packing: the counter ``ingest_engine.parse_s``
of each report's telemetry.json), per 1,000 runs."""

from portbench.stages import engine_ms_per_krun


def read(ctx):
    return engine_ms_per_krun(ctx.records, "parse_s") if ctx.loop == "report" else None
