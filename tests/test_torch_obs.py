"""The port's observability subsystem (``nemo_tpu_torch/obs``) on the CPU.

The counterparts of the JAX package's tests/test_obs.py, tests/test_promexp.py
and the flight-recorder cases of tests/test_obs_fleet.py that need no
sidecar or router:

* tracing off: ``span()`` is one shared null context (by identity, not by a
  wall-clock bound); on: nested spans, thread rows, a Chrome-trace file;
* a traced CPU report: the trace holds every ``phase:*`` of
  telemetry.json's timings with durations equal to them, the kernel and
  route spans nested in the phases, and telemetry.json's new sections
  (``metrics``, ``trace_id``, ``kernel_cost``, ``memory``) while the
  report tree stays byte-equal to an untraced one;
* ``PhaseTimer``: one interval feeds the timing and the span, the sync
  inside it;
* counters, gauges, histograms, the series cap and ``delta``;
* JSON log records carrying the active trace id; the slow-dispatch
  watchdog and the cost table;
* the profiler hook: spans and phases are ``record_function`` labels under
  a ``torch.profiler`` capture only, a report's and a query's among them;
* the flight recorder: one bundle for a watch cycle made to fail, none
  more within the cooldown;
* ``render_prometheus`` byte-equal to the JAX package's for the same
  snapshot, and ``parse_prometheus_text`` round-tripping it;
* the CLI: ``--trace``, ``--metrics-out -``, ``--timings``, ``--profile``,
  a failed run's partial trace, ``main()`` twice, ``NEMO_TRACE``.

Every test that starts a trace finishes it in a ``finally``, and metric
checks read deltas, never absolute values: the registry and the tracer are
process globals.
"""

import json
import os
import re
import threading
import time

import pytest
import torch

from nemo_tpu.obs import promexp as jax_promexp
from nemo_tpu_torch import cli, obs
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend import torch_backend
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
from nemo_tpu_torch.obs import flight, promexp
from nemo_tpu_torch.obs import log as obs_log
from nemo_tpu_torch.obs import trace as obs_trace
from nemo_tpu_torch.utils.timing import PhaseTimer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced(tmp_path):
    """Tracing into a tmp file for one test, always disabled after."""
    path = str(tmp_path / "trace.json")
    tracer = obs_trace.start_trace(path)
    try:
        yield tracer, path
    finally:
        obs_trace.finish()


@pytest.fixture
def armed(tmp_path):
    """A flight recorder armed into a tmp dir for one test, always
    disarmed after."""
    rec = flight.arm(str(tmp_path / "flightrec"), cooldown_s=0.0)
    try:
        yield rec
    finally:
        flight.disarm()


def _events(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    assert isinstance(doc["traceEvents"], list)
    return doc["traceEvents"]


def _spans(path: str) -> list[dict]:
    return [e for e in _events(path) if e["ph"] == "X"]


def _log_records(path) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _bundles(rec) -> list[str]:
    if not os.path.isdir(rec.out_dir):
        return []
    return sorted(os.path.join(rec.out_dir, f) for f in os.listdir(rec.out_dir)
                  if f.startswith("flightrec-") and f.endswith(".json"))


def _counted(fn):
    before = obs.metrics.snapshot()
    out = fn()
    return out, obs.Metrics.delta(obs.metrics.snapshot(), before)


# ------------------------------------------------------------------ tracer


def test_disabled_span_is_shared_null_context():
    assert not obs.enabled() and obs.trace_id() is None
    a = obs.span("x")
    b = obs.span("y", attr=1)
    assert a is b is obs_trace._NULL
    with a as sp:
        assert sp is None


def test_enabled_span_is_live_and_takes_attrs(traced):
    tracer, path = traced
    assert obs.enabled() and obs.trace_id() == tracer.trace_id
    sp = obs.span("live", a=1)
    assert sp is not obs_trace._NULL
    with sp as live:
        live.set(b=2)
    assert obs_trace.finish() == path
    (ev,) = [e for e in _spans(path) if e["name"] == "live"]
    assert ev["args"] == {"a": 1, "b": 2}
    assert not obs.enabled()


def test_span_nesting_and_thread_attribution(traced):
    tracer, path = traced
    with obs.span("outer", layer="test"):
        with obs.span("inner"):
            time.sleep(0.002)

    def other_thread():
        with obs.span("threaded"):
            time.sleep(0.001)

    th = threading.Thread(target=other_thread, name="obs-test-worker")
    th.start()
    th.join()
    assert obs_trace.finish() == path
    events = _events(path)
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    outer, inner, threaded = spans["outer"], spans["inner"], spans["threaded"]
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"layer": "test"}
    assert threaded["tid"] != outer["tid"]
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names[(threaded["pid"], threaded["tid"])] == "obs-test-worker"
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in events)


def test_export_without_disabling_and_finish_when_off(traced, tmp_path):
    tracer, path = traced
    with obs.span("a"):
        pass
    mid = obs.export(str(tmp_path / "mid.json"))
    assert [e["name"] for e in _spans(mid)] == ["a"] and obs.enabled()
    assert obs_trace.finish() == path
    assert obs_trace.finish() is None and obs.export() is None


def test_add_span_records_a_measured_interval(traced):
    tracer, path = traced
    obs.add_span("measured", 1000, 250, {"k": 1})
    obs_trace.finish()
    (ev,) = _spans(path)
    assert (ev["name"], ev["dur"], ev["args"]) == ("measured", 250, {"k": 1})


# --------------------------------------------------------------- PhaseTimer


def test_timings_derive_from_spans(traced):
    tracer, path = traced
    t = PhaseTimer()
    with t.phase("ingest"):
        time.sleep(0.002)
    with t.phase("simplify"):
        time.sleep(0.001)
    with t.phase("simplify"):
        time.sleep(0.001)
    timings = t.as_dict()
    assert set(timings) == {"ingest", "simplify"}
    obs_trace.finish()
    by_name: dict[str, list[int]] = {}
    for e in _spans(path):
        by_name.setdefault(e["name"], []).append(e["dur"])
    assert len(by_name["phase:ingest"]) == 1 and len(by_name["phase:simplify"]) == 2
    for name, secs in timings.items():
        spans = by_name[f"phase:{name}"]
        assert abs(secs * 1e6 - sum(spans)) <= len(spans), (name, secs, spans)


def test_phase_timer_sync_is_inside_the_interval(traced):
    """The sync at the end of a phase (a stream synchronize on the card)
    is inside the measured interval: the timing and the span both cover
    it."""
    tracer, path = traced
    calls = []

    def sync():
        calls.append(1)
        time.sleep(0.02)

    t = PhaseTimer(sync=sync)
    with t.phase("dispatch"):
        pass
    obs_trace.finish()
    (ev,) = [e for e in _spans(path) if e["name"] == "phase:dispatch"]
    assert calls == [1]
    assert t.as_dict()["dispatch"] >= 0.02 and ev["dur"] >= 20000
    assert abs(t.as_dict()["dispatch"] * 1e6 - ev["dur"]) <= 1


def test_phase_timer_untraced_still_times():
    assert not obs.enabled()
    t = PhaseTimer()
    with t.phase("x"):
        time.sleep(0.001)
    assert t.as_dict()["x"] >= 0.001


def test_phase_timer_times_a_failing_phase(traced):
    tracer, path = traced
    t = PhaseTimer(sync=lambda: pytest.fail("no sync after a failure"))
    with pytest.raises(RuntimeError):
        with t.phase("boom"):
            raise RuntimeError("x")
    obs_trace.finish()
    assert "boom" in t.as_dict()
    assert [e["name"] for e in _spans(path)] == ["phase:boom"]


# --------------------------------------------------------- a traced report


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    return write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), str(tmp_path_factory.mktemp("obs_corpus")))


def _report(corpus, out, **backend_kw):
    backend = TorchBackend(device="cpu", **backend_kw)
    return run_debug(corpus, out, backend, figures="all", corpus_cache="off", result_cache="off"), backend


@pytest.mark.parametrize("lanes", ["default", "dense"])
def test_trace_of_a_cpu_report(small_corpus, tmp_path, lanes):
    """The trace of a CPU report loads as Chrome-trace JSON and holds every
    ``phase:*`` of telemetry.json's timings with durations equal to them;
    the kernel spans (dense lane) or the host lane's ``kernel:fused``
    (default routes) nest in the phases, beside ``analysis:route`` and
    ``analysis:pack``.  The tree is byte-equal to an untraced report."""
    kw = {"analysis_impl": "dense"} if lanes == "dense" else {}
    plain, _ = _report(small_corpus, str(tmp_path / "plain"), **kw)
    path = str(tmp_path / "trace.json")
    tracer = obs_trace.start_trace(path)
    try:
        res, backend = _report(small_corpus, str(tmp_path / "traced"), **kw)
    finally:
        assert obs_trace.finish() == path
    assert report_tree_bytes(res.report_dir) == report_tree_bytes(plain.report_dir)
    spans = _spans(path)
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        tel = json.load(fh)
    by_phase: dict[str, list[int]] = {}
    for e in spans:
        if e["name"].startswith("phase:"):
            by_phase.setdefault(e["name"][len("phase:"):], []).append(e["dur"])
    assert set(by_phase) == set(tel["timings"]) == set(res.timings)
    for name, secs in res.timings.items():
        assert abs(secs * 1e6 - sum(by_phase[name])) <= len(by_phase[name]), name
    names = {e["name"] for e in spans}
    assert {"analysis:route", "analysis:pack", "analysis:reduce", "render:drain"} <= names
    kernels = [e for e in spans if e["name"].startswith("kernel:")]
    phases = [e for e in spans if e["name"].startswith("phase:")]
    assert kernels and all(
        any(p["tid"] == k["tid"] and p["ts"] <= k["ts"] and k["ts"] + k["dur"] <= p["ts"] + p["dur"]
            for p in phases)
        for k in kernels
    )
    if lanes == "dense":
        for verb, n in backend.executor.dispatches.items():
            assert sum(e["name"] == f"kernel:{verb}" for e in spans) == n
        fused = [e for e in kernels if e["name"] == "kernel:fused"]
        assert all(e["args"]["upload_bytes"] > 0 and e["args"]["rows"] > 0 for e in fused)
    assert tel["trace_id"] == tracer.trace_id
    assert tel["metrics"]["counters"] and "memory" in tel
    assert tel["memory"]["host_peak_rss_bytes"] > 0 and "device_peak_bytes" not in tel["memory"]
    assert report_tree_bytes(res.report_dir) == report_tree_bytes(plain.report_dir)


def test_untraced_telemetry_has_the_new_sections(small_corpus, tmp_path, monkeypatch):
    # The cost table lives for the process: a table of this test's own, so
    # records an earlier test left (other verbs) do not enter the equality.
    monkeypatch.setattr(torch_backend, "_KERNEL_COSTS", {})
    res, backend = _report(small_corpus, str(tmp_path / "R"), analysis_impl="dense")
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        tel = json.load(fh)
    assert {"timings", "figure_stats", "ingest", "result_cache", "metrics", "trace_id", "kernel_cost",
            "memory", "ingest_engine"} <= set(tel)
    assert tel["trace_id"] is None
    # The engine's counters: sums over files, so beside the phases, not in them.
    assert set(tel["ingest_engine"]) == {"read_s", "parse_s", "read_thread_s", "workers", "files", "bytes"}
    assert tel["ingest_engine"]["files"] == 2 * len(res.molly.runs) + 1
    assert {"ingest.engine", "ingest.unpack", "report.assets", "report.json", "report.figures"} <= set(tel["timings"])
    for rec in tel["kernel_cost"]:
        assert set(rec) == {"verb", "shapes", "statics", "first_dispatch_s", "dispatches", "pad_rows"}
        assert rec["first_dispatch_s"] >= 0 and rec["dispatches"] >= 1
    assert {r["verb"] for r in tel["kernel_cost"]} == set(backend.executor.dispatches)


# --------------------------------------------------------- backend counters


def test_dispatch_counters_equal_the_executor(small_corpus, tmp_path):
    for kw in ({}, {"analysis_impl": "dense"}, {"analysis_impl": "sparse_device"}):
        (res, backend), d = _counted(lambda: _report(small_corpus, str(tmp_path / str(len(kw))), **kw))
        ex = backend.executor
        c = d["counters"]
        got = {k[len("kernel.dispatches."):]: v for k, v in c.items() if k.startswith("kernel.dispatches.")}
        assert got == {**ex.dispatches, **ex.host_runs}
        routes: dict[str, int] = {}
        for r in backend.analysis_routes:
            key = f"analysis.route.{r['verb']}.{r['route']}"
            routes[key] = routes.get(key, 0) + 1
        assert {k: v for k, v in c.items() if k.startswith("analysis.route.")} == routes
        batched = sum(n for v, n in ex.dispatches.items() if v in ("fused", "sparse_fused"))
        assert d["histograms"].get("kernel.batch_rows", {"count": 0})["count"] == batched
        if ex.dispatches:
            assert c["kernel.upload_bytes"] > 0
        assert c["delta.runs_mapped"] == len(res.molly.runs)


def test_slow_dispatch_watchdog_and_cost_table(small_corpus, tmp_path, monkeypatch):
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    monkeypatch.setenv("NEMO_SLOW_DISPATCH_MS", "1e-9")
    monkeypatch.setattr(torch_backend, "_KERNEL_COSTS", {})
    (res, backend), d = _counted(lambda: _report(small_corpus, str(tmp_path / "R"), analysis_impl="dense"))
    n = sum(backend.executor.dispatches.values())
    assert n and d["counters"]["watchdog.slow_kernel"] == n
    recs = [r for r in _log_records(log) if r["event"] == "kernel.slow_dispatch"]
    assert len(recs) == n and {r["verb"] for r in recs} == set(backend.executor.dispatches)
    assert all(r["level"] == "warning" and r["logger"] == "nemo.backend" and "compiled" not in r
               and r["upload_bytes"] > 0 for r in recs)
    costs = torch_backend.kernel_cost_snapshot()
    assert costs == sorted(costs, key=lambda r: (-r["dispatches"], r["verb"], r["shapes"]))
    assert re.fullmatch(r"(\w+\[[\d,]*\]\w+ ?)+", costs[0]["shapes"])
    monkeypatch.setenv("NEMO_SLOW_DISPATCH_MS", "0")
    _, d = _counted(lambda: _report(small_corpus, str(tmp_path / "R2"), analysis_impl="dense"))
    assert "watchdog.slow_kernel" not in d["counters"]


def test_memory_watermarks_on_the_cpu():
    _, d = _counted(torch_backend.sample_memory_watermarks)
    wm = torch_backend.sample_memory_watermarks()
    assert set(wm) == {"host_peak_rss_bytes"} and wm["host_peak_rss_bytes"] > 0
    assert d["gauges"]["mem.host_peak_rss_bytes"] > 0


def _counted_labels(monkeypatch) -> list[str]:
    """The names of every profiler label entered from now on: the hook that
    nemo_tpu_torch/device.py installs, wrapped in a count."""
    active, label = obs_trace._PROFILER
    entered: list[str] = []

    def counted(name):
        entered.append(name)
        return label(name)

    monkeypatch.setattr(obs_trace, "_PROFILER", (active, counted))
    return entered


def test_device_annotation_only_under_a_capture(monkeypatch):
    """device.py's hook: the profiler check ``_profiler_enabled`` and
    ``record_function``.  With no capture running a span is the shared null
    context and neither it nor a phase enters a label; under one both put
    their names on the capture."""
    assert obs_trace._PROFILER == (torch._C._autograd._profiler_enabled, torch.profiler.record_function)
    entered = _counted_labels(monkeypatch)
    assert not obs.enabled() and obs.span("kernel:fused") is obs_trace._NULL
    with obs.span("kernel:fused"), PhaseTimer().phase("ingest"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("kernel:fused") as sp:
            sp.set(rows=4)
            torch.ones(4).sum()
        with PhaseTimer().phase("ingest"):
            pass
    assert entered == ["kernel:fused", "phase:ingest"]
    assert {"kernel:fused", "phase:ingest"} <= {e.key for e in prof.key_averages()}


def test_a_report_and_a_query_label_a_capture_with_the_programs_spans(small_corpus, tmp_path, monkeypatch):
    """Under a CPU capture a report and a query carry a ``user_annotation``
    for every phase they timed (the nested ``ingest.engine``,
    ``report.json``, ``query.eval_host`` among them) and for the kernel
    dispatches (``kernel:<verb>``); without a capture the same work enters
    no label."""
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus
    from nemo_tpu_torch.query.lang import parse_query

    entered = _counted_labels(monkeypatch)
    q = parse_query("from pre match goal[holds=true] -> @rule tables")

    def work(tag):
        res, _ = _report(small_corpus, str(tmp_path / tag))
        doc = execute_query(q, ingest_corpus(small_corpus, "off"), device="cpu", use_cache=False,
                            query_host_work=10**15)
        return res, doc

    work("plain")
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res, doc = work("profiled")
    path = str(tmp_path / "capture.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as fh:
        labels = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("cat") == "user_annotation"}
    phases = {f"phase:{p}" for p in [*res.timings, *doc["stats"]["timings"]]}
    assert {"phase:ingest.engine", "phase:ingest.unpack", "phase:report.json", "phase:report.figures",
            "phase:query.plan", "phase:query.prep", "phase:query.eval_host", "phase:query.extract"} <= phases
    assert phases <= labels and any(n.startswith("kernel:") for n in labels)
    assert labels <= set(entered)


# ----------------------------------------------------------------- metrics


def test_metrics_counters_gauges_histograms():
    m = obs.Metrics()
    m.inc("a")
    m.inc("a", 2)
    m.gauge("g", 7.5)
    for v in (1.0, 3.0, 2.0):
        m.observe("h", v)
    snap = m.snapshot()
    assert snap["counters"] == {"a": 3} and snap["gauges"] == {"g": 7.5}
    h = snap["histograms"]["h"]
    buckets = h.pop("buckets")
    assert h == {"count": 3, "sum": 6.0, "min": 1.0, "max": 3.0, "mean": 2.0}
    counts = [c for _, c in buckets]
    assert buckets == sorted(buckets) and counts == sorted(counts) and counts[-1] == 3
    by_le = dict((le, c) for le, c in buckets)
    assert by_le[1.0] == 1 and by_le[2.5] == 2
    json.dumps(snap)


def test_metrics_cardinality_cap():
    m = obs.Metrics(max_series=3)
    m.inc("keep.a")
    m.gauge("keep.g", 1.0)
    m.observe("keep.h", 2.0)
    for i in range(50):
        m.inc(f"adversarial.{i}")
        m.gauge(f"adversarial.g{i}", i)
        m.observe(f"adversarial.h{i}", i)
    m.inc("keep.a", 9)
    m.observe("keep.h", 4.0)
    snap = m.snapshot()
    assert snap["counters"]["keep.a"] == 10
    assert snap["counters"]["metrics.dropped_series"] == 150
    assert set(snap["gauges"]) == {"keep.g"} and set(snap["histograms"]) == {"keep.h"}
    assert snap["histograms"]["keep.h"]["count"] == 2


def test_metrics_cap_from_the_environment(monkeypatch):
    monkeypatch.setenv("NEMO_METRICS_MAX_SERIES", "2")
    m = obs.Metrics()
    for i in range(4):
        m.inc(f"s{i}")
    assert m.snapshot()["counters"] == {"s0": 1, "s1": 1, "metrics.dropped_series": 2}
    monkeypatch.setenv("NEMO_METRICS_MAX_SERIES", "junk")
    assert obs.Metrics()._max_series == 4096


def test_metrics_delta_and_reset():
    m = obs.Metrics()
    m.inc("c", 5)
    m.observe("h", 2.0)
    m.gauge("g", 1.0)
    before = m.snapshot()
    m.inc("c", 3)
    m.inc("new")
    m.observe("h", 4.0)
    m.gauge("g", 9.0)
    d = obs.Metrics.delta(m.snapshot(), before)
    assert d["counters"] == {"c": 3, "new": 1}
    assert d["gauges"] == {"g": 9.0}
    assert d["histograms"]["h"] == {"count": 1, "sum": 4.0, "mean": 4.0, "lifetime_min": 2.0,
                                    "lifetime_max": 4.0}
    m.reset()
    assert m.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_set_buckets_custom_ladder():
    m = obs.Metrics()
    m.set_buckets("ms", [0.005, 0.001, 0.01])
    m.observe("ms", 0.004)
    m.set_buckets("ms", [1.0])  # frozen after the first observation
    m.observe("plain", 0.004)
    snap = m.snapshot()
    assert snap["histograms"]["ms"]["ladder"] == [0.001, 0.005, 0.01]
    assert "ladder" not in snap["histograms"]["plain"]


# --------------------------------------------------------------------- log


def test_structured_log_json_lines_and_levels(tmp_path, monkeypatch):
    path = str(tmp_path / "log.jsonl")
    monkeypatch.setenv("NEMO_LOG_FILE", path)
    monkeypatch.setenv("NEMO_LOG_LEVEL", "info")
    lg = obs_log.get_logger("nemo.test")
    lg.debug("filtered.out", x=1)
    lg.warning("kept.event", detail="hello", n=3)
    (rec,) = _log_records(path)
    assert (rec["level"], rec["logger"], rec["event"], rec["n"], rec["pid"]) == (
        "warning", "nemo.test", "kept.event", 3, os.getpid())
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}Z", rec["ts"])
    assert "trace_id" not in rec
    monkeypatch.setenv("NEMO_LOG_LEVEL", "debug")
    assert obs_log.level_enabled("debug")
    lg.debug("now.kept")
    assert [r["event"] for r in _log_records(path)] == ["kept.event", "now.kept"]


def test_structured_log_carries_active_trace_id(tmp_path, monkeypatch, traced):
    tracer, _ = traced
    path = str(tmp_path / "log.jsonl")
    monkeypatch.setenv("NEMO_LOG_FILE", path)
    obs_log.get_logger("nemo.test").warning("traced.event")
    obs_log.get_logger("nemo.test").warning("explicit.event", trace_id="deadbeef")
    recs = _log_records(path)
    assert recs[0]["trace_id"] == tracer.trace_id and recs[1]["trace_id"] == "deadbeef"


def test_log_records_go_to_stderr(capsys):
    obs_log.get_logger("nemo.test").error("to.stderr", k=1)
    err = capsys.readouterr().err.strip().splitlines()
    assert json.loads(err[-1])["event"] == "to.stderr"


def test_slow_dispatch_threshold(monkeypatch):
    monkeypatch.delenv("NEMO_SLOW_DISPATCH_MS", raising=False)
    assert obs_log.slow_dispatch_ms() == 30000.0
    monkeypatch.setenv("NEMO_SLOW_DISPATCH_MS", "junk")
    assert obs_log.slow_dispatch_ms() == 30000.0
    monkeypatch.setenv("NEMO_SLOW_DISPATCH_MS", "5")
    assert obs_log.slow_dispatch_ms() == 5.0


def test_env_knob_warning_is_a_structured_record(tmp_path, monkeypatch):
    from nemo_tpu_torch.utils.env import env_int

    path = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(path))
    monkeypatch.setenv("NEMO_TEST_KNOB", "seven")
    assert env_int("NEMO_TEST_KNOB", 3) == 3
    (rec,) = _log_records(path)
    assert (rec["event"], rec["name"], rec["value"], rec["using"]) == ("env.bad_value", "NEMO_TEST_KNOB", "seven", 3)


# ------------------------------------------------------------------ flight


def test_flight_unarmed_trigger_is_a_no_op():
    assert flight.recorder() is None
    assert flight.trigger("watch_cycle_failed", corpus="x") is None


def test_flight_bundle_for_a_failed_watch_cycle_then_cooldown(small_corpus, tmp_path):
    """A watch cycle made to fail twice, then succeed: one bundle
    (reason ``watch_cycle_failed``, Perfetto-loadable, with the ring's
    spans and log records), the second failure suppressed by the
    cooldown, and the update published after."""
    import shutil

    from nemo_tpu_torch.watch import WatchConfig, Watcher

    live = str(tmp_path / "live" / "pb_synth")
    shutil.copytree(small_corpus, live)
    calls = []

    def make_backend():
        calls.append(1)
        if len(calls) <= 2:
            raise RuntimeError(f"backend construction failed ({len(calls)})")
        return TorchBackend(device="cpu")

    rec = flight.arm(str(tmp_path / "fr"), cooldown_s=3600.0)
    try:
        with obs.span("before:failure"):
            pass
        cfg = WatchConfig(poll_s=0.01, debounce_s=0.01, max_updates=1, figures="none",
                          run_debug_kwargs={"corpus_cache": "off", "result_cache": "off"})
        w = Watcher(live, str(tmp_path / "res"), make_backend, cfg)
        q = w.subscribe()
        n, d = _counted(w.run)
    finally:
        flight.disarm()
    assert n == 1 and len(calls) == 3
    events = []
    while not q.empty():
        events.append(q.get())
    assert [e["event"] for e in events] == ["watch_error", "watch_error", "report_update"]
    (bundle,) = _bundles(rec)
    with open(bundle, encoding="utf-8") as fh:
        doc = json.load(fh)
    other = doc["otherData"]
    assert other["reason"] == "watch_cycle_failed" and other["context"]["corpus"] == os.path.abspath(live)
    assert "backend construction failed (1)" in other["context"]["error"]
    assert "before:failure" in {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert any(r["event"] == "watch.cycle_failed" for r in other["logs"])
    assert other["metrics_delta"]["counters"]["watch.cycle_failed"] == 1
    c = d["counters"]
    assert (c["watch.cycle_failed"], c["flight.dumps.watch_cycle_failed"], c["flight.suppressed"]) == (2, 1, 1)
    assert (c["watch.updates"], c["watch.new_runs"]) == (1, 8)


def test_flight_ring_is_bounded(tmp_path):
    rec = flight.arm(str(tmp_path / "fr"), max_spans=8, max_logs=4, cooldown_s=0.0)
    try:
        for i in range(50):
            rec.add_span(f"s{i}", i * 10, 5)
            rec.record_log({"event": f"e{i}"})
        with open(rec.trigger("watch_cycle_failed"), encoding="utf-8") as fh:
            doc = json.load(fh)
    finally:
        flight.disarm()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == [f"s{i}" for i in range(42, 50)]
    assert [r["event"] for r in doc["otherData"]["logs"]] == [f"e{i}" for i in range(46, 50)]


def test_flight_bundle_carries_metric_delta(armed):
    obs.metrics.inc("obs_test.window_counter", 7)
    with open(armed.trigger("watch_cycle_failed"), encoding="utf-8") as fh:
        assert json.load(fh)["otherData"]["metrics_delta"]["counters"]["obs_test.window_counter"] == 7
    obs.metrics.inc("obs_test.window_counter", 2)
    with open(armed.trigger("watch_cycle_failed"), encoding="utf-8") as fh:
        assert json.load(fh)["otherData"]["metrics_delta"]["counters"]["obs_test.window_counter"] == 2


def test_flight_spans_land_without_tracer_and_alongside_one(armed, tmp_path):
    assert not obs.enabled()
    with obs.span("flightonly:a", k=1):
        pass
    assert any(s[0] == "flightonly:a" for s in armed._spans)
    path = str(tmp_path / "t.json")
    obs_trace.start_trace(path)
    try:
        with obs.span("both:b"):
            pass
    finally:
        obs_trace.finish()
    assert any(s[0] == "both:b" for s in armed._spans)
    assert "both:b" in {e["name"] for e in _spans(path)}


def test_flight_configure_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_FLIGHT", "off")
    assert flight.configure_from_env() is None and flight.recorder() is None
    monkeypatch.setenv("NEMO_FLIGHT", "on")
    monkeypatch.setenv("NEMO_FLIGHT_DIR", str(tmp_path / "fd"))
    monkeypatch.setenv("NEMO_FLIGHT_SPANS", "5")
    try:
        rec = flight.configure_from_env()
        assert flight.recorder() is rec and flight.configure_from_env() is rec
        assert (rec.out_dir, rec.max_spans, rec.max_logs, rec.cooldown_s) == (str(tmp_path / "fd"), 5, 512, 30.0)
    finally:
        flight.disarm()
    monkeypatch.delenv("NEMO_FLIGHT_DIR")
    assert flight.FlightRecorder().out_dir == os.path.join(
        os.path.expanduser("~"), ".cache", "nemo_tpu_torch", "flightrec")


# ---------------------------------------------------------------- promexp


def _filled_registry() -> obs.Metrics:
    m = obs.Metrics()
    m.inc("kernel.dispatches.fused", 7)
    m.inc("kernel.upload_bytes", 12345.0)
    m.inc("render.render_s", 0.125)
    m.gauge("mem.host_peak_rss_bytes", 1.5e9)
    m.gauge("watch.runs_total", 0)
    for v in (0.002, 0.004, 0.05, 3.0, 3.0, 250.0):
        m.observe("watch.update_latency_s", v)
    m.observe("kernel.batch_rows", 2048)
    m.set_buckets("stream.stage_s", [0.001, 0.01, 0.1])
    m.observe("stream.stage_s", 0.02)
    return m


def _snapshots() -> list:
    m = obs.Metrics()
    m.inc("x.y")
    m.inc("x-y")  # sanitizes to the same name as x.y
    cap = obs.Metrics(max_series=1)
    cap.inc("a")
    cap.inc("b")
    return [_filled_registry().snapshot(), obs.Metrics().snapshot(), m.snapshot(), cap.snapshot(), {}]


@pytest.mark.parametrize("k", range(5))
def test_render_prometheus_byte_equal_to_jax(k):
    snap = _snapshots()[k]
    text = promexp.render_prometheus(snap)
    assert text == jax_promexp.render_prometheus(snap)
    assert promexp.parse_prometheus_text(text) == jax_promexp.parse_prometheus_text(text)


def test_render_prometheus_of_a_report_snapshot_byte_equal_to_jax(small_corpus, tmp_path):
    _report(small_corpus, str(tmp_path / "R"), analysis_impl="dense")
    snap = obs.metrics.snapshot()
    assert snap["histograms"]["kernel.batch_rows"]["count"] > 0
    assert promexp.render_prometheus(snap) == jax_promexp.render_prometheus(snap)


def test_prometheus_round_trip():
    snap = _filled_registry().snapshot()
    fams = promexp.parse_prometheus_text(promexp.render_prometheus(snap))
    (sample,) = fams["nemo_kernel_dispatches_fused_total"]["samples"]
    assert sample == ("nemo_kernel_dispatches_fused_total", {}, 7.0)
    assert fams["nemo_kernel_dispatches_fused_total"]["type"] == "counter"
    assert fams["nemo_mem_host_peak_rss_bytes"]["type"] == "gauge"
    for name, raw in (("kernel.dispatches.fused", "counters"), ("mem.host_peak_rss_bytes", "gauges")):
        fam = promexp.sanitize_name(name) + ("_total" if raw == "counters" else "")
        assert fams[fam]["samples"][0][2] == snap[raw][name]
    hist = fams["nemo_watch_update_latency_s"]
    buckets = [(lab["le"], v) for n, lab, v in hist["samples"] if n.endswith("_bucket")]
    assert len(buckets) == len(obs.HIST_BUCKETS) + 1 and buckets[-1] == ("+Inf", 6.0)
    assert [v for _, v in buckets] == sorted(v for _, v in buckets)
    custom = [lab["le"] for n, lab, _ in fams["nemo_stream_stage_s"]["samples"] if n.endswith("_bucket")]
    assert custom == ["0.001", "0.01", "0.1", "+Inf"]


def test_parse_prometheus_rejects_malformed_text():
    with pytest.raises(ValueError):
        promexp.parse_prometheus_text("nemo_x 1\nthis is not a sample\n")
    with pytest.raises(ValueError):
        promexp.parse_prometheus_text('nemo_x{le=5} 1\n')


def test_name_sanitization():
    assert promexp.sanitize_name("a.b-c d/e") == "nemo_a_b_c_d_e"
    text = promexp.render_prometheus(_snapshots()[2])
    assert text.count("# TYPE nemo_x_y_total counter") == 1


# --------------------------------------------------------------------- CLI


def _cli(args, capsys):
    rc = cli.main(args)
    return rc, capsys.readouterr()


def test_cli_trace_metrics_timings_profile(small_corpus, tmp_path, capsys):
    trace, prof = tmp_path / "t.json", tmp_path / "P"
    (rc, out), d = _counted(lambda: _cli(
        ["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / "R"),
         "--analysis-impl", "dense", "--figures", "none", "--corpus-cache", "off", "--result-cache", "off",
         "--trace", str(trace), "--metrics-out", "-", "--timings", "--profile", str(prof)], capsys))
    assert rc == 0 and not obs.enabled()
    names = {e["name"] for e in _spans(str(trace))}
    assert {"phase:ingest", "phase:load_raw_provenance", "phase:report", "kernel:fused", "kernel:diff"} <= names
    assert f"obs trace written to {trace} (open at ui.perfetto.dev)" in out.out
    for phase in ("ingest", "load_raw_provenance", "report"):
        assert re.search(rf"^\s+{phase}\s+\d+\.\d ms$", out.out, re.M), phase
    text = out.out[out.out.index("# HELP"):]
    fams = promexp.parse_prometheus_text(text)
    assert fams["nemo_kernel_dispatches_fused_total"]["samples"][0][2] >= d["counters"]["kernel.dispatches.fused"]
    (pt,) = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(prof / pt, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    labels = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"kernel:fused", "kernel:diff", "phase:load_raw_provenance", "phase:diff_prov"} <= labels


def test_cli_metrics_out_file(small_corpus, tmp_path, capsys):
    path = tmp_path / "m.prom"
    rc, out = _cli(["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / "R"),
                    "--figures", "none", "--metrics-out", str(path)], capsys)
    assert rc == 0 and f"metrics written to {path} (Prometheus text format)" in out.out
    fams = promexp.parse_prometheus_text(path.read_text())
    assert "nemo_delta_runs_mapped_total" in fams and "nemo_kernel_dispatches_sparse_fused_total" in fams


def test_cli_profile_bypasses_the_result_cache(small_corpus, tmp_path, capsys):
    args = ["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / "R"), "--figures",
            "none", "--corpus-cache", str(tmp_path / "cc"), "--result-cache", str(tmp_path / "rc")]
    assert _cli(args, capsys)[0] == 0
    rc, out = _cli(args + ["--profile", str(tmp_path / "P")], capsys)
    assert rc == 0 and "result cache off" in out.out
    rc, out = _cli(args, capsys)
    assert rc == 0 and "result cache report_hit" in out.out


def test_cli_failed_run_writes_its_partial_trace(small_corpus, tmp_path, capsys, monkeypatch):
    def failing_run_debug(*a, **k):
        with obs.span("phase:partial"):
            pass
        raise RuntimeError("the run failed")

    monkeypatch.setattr(cli, "run_debug", failing_run_debug)
    trace = tmp_path / "t.json"
    with pytest.raises(RuntimeError, match="the run failed"):
        cli.main(["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / "R"),
                  "--trace", str(trace)])
    assert not obs.enabled()
    assert "phase:partial" in {e["name"] for e in _spans(str(trace))}
    assert f"obs trace (partial, run failed) written to {trace}" in capsys.readouterr().err


def test_cli_main_twice_leaves_no_live_tracer(small_corpus, tmp_path, capsys):
    ids = []
    for k in range(2):
        trace = tmp_path / f"t{k}.json"
        rc, _ = _cli(["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / f"R{k}"),
                      "--figures", "none", "--trace", str(trace)], capsys)
        assert rc == 0 and not obs.enabled()
        with open(trace, encoding="utf-8") as fh:
            ids.append(json.load(fh)["otherData"]["trace_id"])
        assert {e["name"] for e in _spans(str(trace))} >= {"phase:ingest", "phase:report"}
    assert ids[0] != ids[1]


def test_cli_nemo_trace_env(small_corpus, tmp_path, capsys, monkeypatch):
    trace = tmp_path / "env.json"
    monkeypatch.setenv("NEMO_TRACE", str(trace))
    rc, out = _cli(["-faultInjOut", small_corpus, "--device", "cpu", "--results-dir", str(tmp_path / "R"),
                    "--figures", "none"], capsys)
    assert rc == 0 and not obs.enabled() and os.environ["NEMO_TRACE"] == str(trace)
    assert "phase:report" in {e["name"] for e in _spans(str(trace))}


def test_cli_watch_finishes_its_trace(small_corpus, tmp_path, capsys):
    trace = tmp_path / "w.json"
    rc, out = _cli(["-faultInjOut", str(tmp_path / "live" / "pb_synth"), "--device", "cpu", "--watch",
                    "--watch-max-updates", "1", "--watch-poll-s", "0.05", "--watch-debounce-s", "0.05",
                    "--replay", small_corpus, "--replay-generations", "1", "--figures", "none",
                    "--results-dir", str(tmp_path / "R"), "--corpus-cache", "off", "--result-cache", "off",
                    "--trace", str(trace)], capsys)
    assert rc == 0 and not obs.enabled()
    assert "watch update 1:" in out.out and f"obs trace written to {trace}" in out.out
    names = {e["name"] for e in _spans(str(trace))}
    assert {"watch:cycle", "phase:report"} <= names


def test_cli_profile_refuses_out(small_corpus, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", small_corpus, "--device", "cpu", "--out", str(tmp_path / "a.json"),
                  "--profile", str(tmp_path / "P")])


def test_failed_checkpoint_is_counted_and_the_report_stays_whole(tmp_path, monkeypatch):
    """A checkpoint whose publish raises is counted ``rcache.checkpoint_failed``
    and logged ``delta.checkpoint_failed``; its segment's figures render in
    the report phase and its partial is published at the end of the run, so
    the report equals a from-scratch one.  The other segments checkpoint."""
    from nemo_tpu_torch.models.synth import grow_corpus_dir
    from nemo_tpu_torch.store.rcache import ResultCache

    full = write_corpus(SynthSpec(n_runs=10, seed=5), str(tmp_path / "full"))
    cd = str(tmp_path / "grow" / "pb_synth")
    cc = str(tmp_path / "cc")
    for n in (4, 7, 10):  # three store segments
        grow_corpus_dir(full, cd, n)
        run_debug(cd, str(tmp_path / f"S{n}"), TorchBackend(device="cpu"), figures="all", corpus_cache=cc,
                  result_cache="off")
    real, calls = ResultCache.put_partial, []

    def flaky(self, key, partial, figures_dir):
        calls.append(key)
        if len(calls) == 1:
            raise OSError("disk full")
        return real(self, key, partial, figures_dir)

    monkeypatch.setattr(ResultCache, "put_partial", flaky)
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    res, d = _counted(lambda: run_debug(cd, str(tmp_path / "R"), TorchBackend(device="cpu"), figures="all",
                                        corpus_cache=cc, result_cache=str(tmp_path / "rc")))
    c = d["counters"]
    assert (c["rcache.checkpoint_failed"], c["delta.partial_checkpoints"], c["delta.segments_mapped"]) == (1, 2, 3)
    assert c["rcache.partial_put"] == 3 and len(calls) == 4
    assert any(r["event"] == "delta.checkpoint_failed" for r in _log_records(log))
    scratch = run_debug(cd, str(tmp_path / "X"), TorchBackend(device="cpu"), figures="all", corpus_cache="off",
                        result_cache="off")
    assert report_tree_bytes(res.report_dir) == report_tree_bytes(scratch.report_dir)
