"""The report loop served from the corpus store: whole debugging reports of
the configuration's corpora, as the report loop makes them, with a corpus
store of the run's own in place of the corpora's parse.  Each report loads
its corpus from the store (classify, map, CRC verify, build), then packs,
maps and reduces, and writes, so the store's load, the analysis and the
writer are in the window, and the engine's reads and parse are not.

Traffic parameters (traffic/<mix>.json): ``figures``, ``result_cache``
and ``svg_cache``, as the report loop's.  The store is made empty at
set-up under the run's work directory and goes with it.  The warm pass
reports every corpus twice: once to fill its store and once served by it,
so that the window's first store loads are not its first.  The check holds
every window report to having been served by the store (its
telemetry.json ``ingest`` is ``store_hit``): a report that fell back to the
parse is a mismatch."""

from __future__ import annotations

import json
import os

from portbench.loops import report

#: The telemetry.json ``ingest`` of a report that the store served.
STORE_HIT = "store_hit"


def ingest_mismatch(report_dir: str) -> str | None:
    """Which ingest served the report, where it was not the store."""
    try:
        with open(os.path.join(report_dir, "telemetry.json"), encoding="utf-8") as f:
            got = json.load(f).get("ingest")
    except (OSError, ValueError) as ex:
        return f"telemetry.json: {type(ex).__name__}"
    return None if got == STORE_HIT else f"telemetry.json ingest {got!r}, want {STORE_HIT!r}"


class Loop(report.Loop):
    def setup(self) -> None:
        store = os.path.join(self.ctx.workdir, "corpus-store")
        os.makedirs(store)
        self.traffic = dict(self.traffic, corpus_cache=store)
        super().setup()

    def warm(self) -> None:
        """Every corpus reported twice, untimed: the first fills its store,
        the second is served by it."""
        super().warm()
        super().warm()

    def check(self, records: list[dict]) -> dict:
        """The report loop's check, after each window report's ingest is
        held to the store (the report loop's check deletes the reports)."""
        stored = []
        for rec in records:
            bad = ingest_mismatch(rec["dir"])
            if bad:
                stored.append(f"{os.path.basename(rec['dir'])}: {bad}")
        verdict = super().check(records)
        verdict["mismatched_documents"] = stored + verdict["mismatched_documents"]
        return verdict
