"""ingest_unpack_ms_per_krun: the phase ``ingest.unpack``, from the engine's
return to the loader's end (copy-out, vocabularies, the runs.json parse in
Python, the per-run objects), per 1,000 runs of the reports that timed it."""

from portbench.stages import nested_phase_ms_per_krun


def read(ctx):
    return nested_phase_ms_per_krun(ctx.records, "ingest.unpack") if ctx.loop == "report" else None
