"""The benchmark's readers of the port's stage instruments
(``portbench/metrics/``: the C++ ingest engine's counters in each report's
telemetry.json, ``read_thread_s`` among them, which an engine without a
pool does not write, the nested phases ``ingest.unpack``, ``report.json`` and
``report.figures``, and the query stages of ``stats["timings"]``), on
constructed runs: the right value from a run that has them, None from the
other loop and from a program without them."""

import json
from types import SimpleNamespace

import pytest

from portbench.harness import _metric

RUNS = (1700, 300)
ENGINE = ({"read_s": 0.5, "parse_s": 1.25, "read_thread_s": 2.0, "workers": 8, "files": 3401, "bytes": 9},
          {"read_s": 0.25, "parse_s": 0.5, "read_thread_s": 1.5, "workers": 8})
TIMINGS = ({"ingest": 2.0, "ingest.unpack": 0.25, "report": 0.5, "report.json": 0.125, "report.figures": 0.25},
           {"ingest": 1.0, "ingest.unpack": 0.125, "report": 0.25, "report.json": 0.0625, "report.figures": 0.125})
STAGES = ({"query.plan": 0.001, "query.prep": 0.002, "query.eval_host": 0.010, "query.extract": 0.003},
          {"query.plan": 0.001, "query.prep": 0.004, "query.eval_device": 0.020, "query.extract": 0.001},
          {"query.plan": 0.002, "query.prep": 0.003, "query.eval_host": 0.030, "query.extract": 0.002})
KRUNS = sum(RUNS) / 1e3

#: metric -> (loop, its value from the constructed window)
WANT = {
    "ingest_read_ms_per_krun": ("report", 750 / KRUNS),
    "ingest_parse_ms_per_krun": ("report", 1750 / KRUNS),
    "ingest_read_thread_ms_per_krun": ("report", 3500 / KRUNS),
    "ingest_unpack_ms_per_krun": ("report", 375 / KRUNS),
    "report_json_ms_per_krun": ("report", 187.5 / KRUNS),
    "report_figures_ms_per_krun": ("report", 375 / KRUNS),
    "query_prep_ms": ("query", (3 + 5 + 5) / 3),
    "query_eval_host_ms": ("query", (10 + 30) / 2),
    "query_eval_device_ms": ("query", 20),
    "query_extract_ms": ("query", (3 + 1 + 2) / 3),
}


def _report_ctx(tmp_path, loop: str, instrumented: bool) -> SimpleNamespace:
    records = []
    for k, (runs, engine, timings) in enumerate(zip(RUNS, ENGINE, TIMINGS)):
        d = tmp_path / f"{loop}-{instrumented}-{k}"
        d.mkdir()
        tel = {"timings": timings if instrumented else {"ingest": timings["ingest"], "report": timings["report"]}}
        if instrumented:
            tel["ingest_engine"] = engine
        (d / "telemetry.json").write_text(json.dumps(tel))
        records.append({"corpus": f"c{k}", "dir": str(d), "runs": runs, "timings": tel["timings"]})
    return SimpleNamespace(loop=loop, records=records)


def _query_ctx(loop: str, instrumented: bool) -> SimpleNamespace:
    records = []
    for timings in STAGES:
        stats = {"cache": "off", "segments_mapped": 1}
        if instrumented:
            stats["timings"] = timings
        records.append({"corpus": "c", "text": "q", "doc": {"n_runs": 1, "stats": stats}, "queries": 1})
    return SimpleNamespace(loop=loop, records=records)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_stage_and_nothing_elsewhere(tmp_path, name):
    loop, want = WANT[name]
    read = _metric(name).read
    ctx = _report_ctx(tmp_path, "report", True) if loop == "report" else _query_ctx("query", True)
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    other = _query_ctx("query", True) if loop == "report" else _report_ctx(tmp_path, "report", True)
    assert read(other) is None
    bare = _report_ctx(tmp_path, "report", False) if loop == "report" else _query_ctx("query", False)
    assert read(bare) is None


def test_read_thread_reader_skips_an_engine_without_a_pool(tmp_path):
    """An engine without a pool writes ``ingest_engine`` without
    ``read_thread_s``: None where no report has it, and only the runs of
    the reports that have it where some do."""
    read = _metric("ingest_read_thread_ms_per_krun").read
    ctx = _report_ctx(tmp_path, "report", True)
    for k, rec in enumerate(ctx.records):
        tel_path = tmp_path / rec["dir"] / "telemetry.json"
        tel = json.loads(tel_path.read_text())
        tel["ingest_engine"] = {key: v for key, v in tel["ingest_engine"].items() if key not in ("read_thread_s", "workers")}
        tel_path.write_text(json.dumps(tel))
        if k == 0:
            assert read(ctx) == pytest.approx(1500 / (RUNS[1] / 1e3), rel=1e-12)
    assert read(ctx) is None
