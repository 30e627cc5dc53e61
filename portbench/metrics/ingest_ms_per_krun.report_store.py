"""ingest_ms_per_krun.report_store: the phase ``ingest`` over the window
of reports served from the corpus store, per 1,000 runs: the store's load
(classify the source, map and CRC-verify its shards, build the corpus)."""

from portbench.harness import _metric
from portbench.yardstick import phase_ms_per_krun


def read(ctx):
    if ctx.loop != "report_store":
        return None
    return phase_ms_per_krun(ctx.records, _metric("ingest_ms_per_krun").PHASES)
