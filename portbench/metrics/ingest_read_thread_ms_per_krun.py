"""ingest_read_thread_ms_per_krun: the C++ ingest engine's file reads summed
over its pool's workers (the counter ``ingest_engine.read_thread_s`` of each
report's telemetry.json), per 1,000 runs.  Over the files read it is one
read's latency under the pool; beside ``ingest_read_ms_per_krun``, the
wall's share of the reads, it shows how far the workers overlap them.  A
program whose engine has no pool writes no such counter: None."""

import json
import os


def read(ctx):
    if ctx.loop != "report":
        return None
    runs, s = 0, 0.0
    for r in ctx.records:
        with open(os.path.join(r["dir"], "telemetry.json"), encoding="utf-8") as f:
            read_thread_s = (json.load(f).get("ingest_engine") or {}).get("read_thread_s")
        if read_thread_s is not None:
            runs += r["runs"]
            s += read_thread_s
    return s * 1e3 / (runs / 1e3) if runs else None
